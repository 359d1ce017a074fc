"""``dedisp_s`` (s): the stage timer of dedispersion (the upload, the unpack on the card, the dedisperse kernel and, where the trials do not fit, their copy to host RAM), mean over the window's observations."""


def read(ctx):
    return ctx.mean_timer("dedispersion")
