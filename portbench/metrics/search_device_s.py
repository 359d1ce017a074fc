"""``search_device_s`` (s): the stage timer of the search on the card (the DM blocks' whitening, the rows' resample, FFT, interbin and harmonic peaks, and the wave fetch that reads them back), mean over the window's observations."""


def read(ctx):
    return ctx.mean_timer("search_device")
