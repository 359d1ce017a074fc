"""csrc/harmpeaks.cu (mask and walk), launch shape (rows, padded bins,
harmonic levels, cluster slots): the harmonic sums of every bin (2^h - 1
adds to reach level h, each level reusing the last), each level scaled and
compared with the threshold: 2^H - 1 + 2 (H + 1) operations a bin, H the
levels. The bins are counted from the padded width less the pad's
largest (4,095), a lower bound of the true bins. Bytes: the spectrum read
once, each row's cluster slots (index and S/N) and two counts a level
written once."""

SYMBOLS = ("harm_mask", "harm_walk")

SPEC_ALIGN = 4096


def count(shape: tuple, config: dict | None = None) -> tuple[float, float]:
    rows, npad, nharms, max_peaks = shape
    nbins = npad - SPEC_ALIGN + 1
    nlev = nharms + 1
    ops = rows * nbins * ((1 << nharms) - 1 + 2 * nlev)
    nbytes = rows * nbins * 4 + rows * nlev * (max_peaks * 8 + 8)
    return float(ops), float(nbytes)
