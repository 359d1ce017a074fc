"""``shard_copy_s`` (s): the stream seconds of the program's ``Shard-Copy``
spans (each copy of the filterbank to a card other than its own before
the sharded dedispersion, ``parallel/sharded_dedisperse.py``), read on
the source card's stream, where each copy runs, and summed over the
copies, mean over the window's observations. Nothing where no card
received a copy."""

from .upload_s import window_mean


def read(ctx):
    return window_mean(ctx, lambda t: t.device_s("Shard-Copy"))
