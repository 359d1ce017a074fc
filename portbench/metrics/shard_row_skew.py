"""``shard_row_skew`` (%): how far the busiest shard's rows lie above the
shards' mean: 100 x (the largest of the program's counters
``shard.rows.<i>``, the rows dispatched to shard i,
``parallel/sharded_search.py``, over their mean, less 1), mean over the
window's observations. Nothing where fewer than two shards were fed."""

from .upload_s import window_mean

PREFIX = "shard.rows."


def _skew(table):
    rows = [n for k, n in table.counters().items() if k.startswith(PREFIX)]
    if len(rows) < 2:
        return None
    return 100.0 * (max(rows) * len(rows) / sum(rows) - 1.0)


def read(ctx):
    return window_mean(ctx, _skew)
