"""``device_idle`` (%): the share of the traced window in which no kernel
or copy ran, the mean over each card of the cell: one less the sum of
each card's union of intervals over the window times the cards
(``trace.py``'s card-seconds)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
