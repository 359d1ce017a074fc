"""``shard_feed_s`` (s): the host wall seconds of the program's
``Shard-Feed`` spans (the one host thread's work for one card in a round:
that card's trial rows, whitening and row tables, and each of its row
batches' dispatch, ``pipeline/search.py``, ``parallel/sharded_search.py``),
blocking waits included, summed over cards and rounds, mean over the
window's observations."""

from .upload_s import window_mean


def read(ctx):
    return window_mean(ctx, lambda t: t.wall_s("Shard-Feed"))
