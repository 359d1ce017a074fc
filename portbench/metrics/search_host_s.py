"""``search_host_s`` (s): the stage timer of the host's per-DM distil (the native library's harmonic and acceleration distils, the candidates built), mean over the window's observations."""


def read(ctx):
    return ctx.mean_timer("search_host")
