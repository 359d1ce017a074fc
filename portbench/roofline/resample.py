"""csrc/resample.cu, launch shape (rows, DM trials in the block, samples):
each output sample's source index rint(af * i * (i - N)) + i (a subtract,
two multiplies, a rounding and an add: four operations counted) and its
gather. Bytes: each row written once, its factor and DM index read, and
at least one DM trial's series read once (the rows' distinct trials are
not in the shape, so the count is a lower bound)."""

SYMBOLS = ("resample_rows_kernel",)


def count(shape: tuple, config: dict | None = None) -> tuple[float, float]:
    rows, _d, n = shape
    return 4.0 * rows * n, float(rows * n * 4 + n * 4 + rows * 8)
