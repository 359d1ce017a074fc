"""``distil_native_s`` (s): the host wall seconds of the program's
``Distil-Native`` span (the per-DM distil's two native sort-and-distil
calls, ``pipeline/search.py:_distill_segmented``), mean over the window's
observations."""

from .upload_s import window_mean


def read(ctx):
    return window_mean(ctx, lambda t: t.wall_s("Distil-Native"))
