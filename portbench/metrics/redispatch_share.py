"""``redispatch_share`` (%): the share of the rows sent to the
acceleration chain that were sent again because their batch's clusters
overflowed their slots: 100 x the program's counters ``rows.redispatched``
over ``rows.dispatched`` (``pipeline/search.py``), mean over the window's
observations."""

from .upload_s import window_mean


def _share(table):
    sent = table.count("rows.dispatched")
    return 100.0 * table.count("rows.redispatched") / sent if sent else None


def read(ctx):
    return window_mean(ctx, _share)
