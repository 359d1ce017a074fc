"""``whitening_s`` (s): the card's stream seconds of the program's
``Whitening`` spans (each DM block's pad, rfft, running median, specchain,
statistics and irfft, ``pipeline/search.py``), summed over an
observation's blocks, mean over the window's observations."""

from .upload_s import window_mean


def read(ctx):
    return window_mean(ctx, lambda t: t.device_s("Whitening"))
