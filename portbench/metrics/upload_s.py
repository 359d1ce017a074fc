"""``upload_s`` (s): the card's stream seconds of the program's ``Upload``
span (the filterbank's host copy, its upload and its unpack on the card,
``pipeline/search.py``), mean over the window's observations.

The seven span readers (``upload_s``, ``whitening_s``, ``fetch_wait_s``,
``redispatch_share``, ``distil_*_s``) share :func:`window_mean`: each
window observation's ``PeasoupSearch.run`` leaves one span table
(``peasoup_tpu_torch.utils.trace.run_tables``), so the window's are the
last ``len(ctx.timers)``; a program without tables, or with fewer than
the window's observations, gives nothing."""


def window_mean(ctx, value):
    """The mean of ``value(table)`` over the window's span tables, or None
    where the run was not traced, the tables are missing or a table lacks
    the value."""
    if ctx.trace is None or not ctx.timers:
        return None
    try:
        from peasoup_tpu_torch.utils.trace import run_tables
    except ImportError:
        return None
    tables = run_tables()
    if len(tables) < len(ctx.timers):
        return None
    vals = [value(t) for t in tables[-len(ctx.timers):]]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def read(ctx):
    return window_mean(ctx, lambda t: t.device_s("Upload"))
