"""csrc/specchain.cu, launch shape (DM trials, bins): each bin of the raw
spectrum divided by its running median (two divides), the birdies
selected, and the interbinned amplitude (eleven operations: two squares
and a sum, two differences, their squares and sum, a half, a max and a
square root): fourteen operations counted a bin. Bytes: the real and
imaginary parts and the median read once, the birdie mask (u8) once, the
whitened parts and the amplitude written once."""

SYMBOLS = ("specchain_kernel",)


def count(shape: tuple, config: dict | None = None) -> tuple[float, float]:
    rows, nbins = shape
    return 14.0 * rows * nbins, float(rows * nbins * 24 + nbins)
