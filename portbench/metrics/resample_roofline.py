"""``resample_roofline`` (%): the share of its roofline that the resample kernel
reaches in the window: the least time its launches could take on the card
(roofline/resample.py's count of each launch shape against peaks.py) over its
device time in the trace."""


def read(ctx):
    return ctx.roofline_share("resample")
