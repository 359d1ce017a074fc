"""``fetch_wait_s`` (s): the host wall seconds of the program's ``Fetch``
spans (the wave fetch's transfers: the host blocked on the card, then the
copy, ``pipeline/search.py``), summed over an observation, mean over the
window's observations."""

from .upload_s import window_mean


def read(ctx):
    return window_mean(ctx, lambda t: t.wall_s("Fetch"))
