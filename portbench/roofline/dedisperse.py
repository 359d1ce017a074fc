"""csrc/dedisperse.cu, launch shape (input samples, channels, DM trials,
output samples): every kept channel's sample added once into each trial's
output sample, then the sum scaled into u8 once. The kernel adds integers
in packed lanes over the kept channels only; the count is one add a
(trial, output sample, kept channel), as the work needs, and no multiply.
The kept channels are the configuration's kill mask's (all where it has
none). Bytes: the kept channels of the u8 filterbank read once, the delay
table (i32, a kept channel a trial) and the u8 trials written once."""

from ..cell import killmask

SYMBOLS = ("dedisperse_kernel",)


def count(shape: tuple, config: dict | None = None) -> tuple[float, float]:
    t_in, nchans, ndm, out_n = shape
    keep = killmask(config) if config else None
    kept = nchans if keep is None else int(keep.sum())
    ops = ndm * out_n * kept + ndm * out_n
    nbytes = t_in * kept + ndm * kept * 4 + ndm * out_n
    return float(ops), float(nbytes)
