"""csrc/interbin.cu, launch shape (rows, half length m, padded bins): the
packed half-length DFT untwisted into the m + 1 real-FFT bins (sixteen
operations), interbinned (eleven) and normalised (two): 29 operations a
bin. Bytes: the complex half-length spectrum (8 bytes a bin) read once,
the padded row written once, each row's mean and deviation and the
untwist phasors (8 bytes a bin) read once."""

SYMBOLS = ("interbin_kernel",)


def count(shape: tuple, config: dict | None = None) -> tuple[float, float]:
    rows, m, npad = shape
    nbins = m + 1
    return 29.0 * rows * nbins, float(rows * (m * 8 + npad * 4 + 8) + nbins * 8)
