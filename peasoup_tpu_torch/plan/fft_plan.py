"""FFT transform-size planning (reference: utils.hpp:12-18, pipeline_multi.cu:326-331)."""

from __future__ import annotations


def prev_power_of_two(val: int) -> int:
    """Largest n = 2^k with 2n >= val (reference quirk: utils.hpp:12-18).

    Note this is NOT "largest power of two <= val": for val = 2^k the
    reference returns 2^(k-1)... actually n doubles while n*2 < val, so
    for exact powers of two it returns val/2. Preserved verbatim.
    """
    n = 1
    while n * 2 < val:
        n *= 2
    return n


def choose_fft_size(nsamps: int, requested: int = 0) -> int:
    """--fft_size semantics: 0 means prev_power_of_two(nsamps)."""
    return requested if requested else prev_power_of_two(nsamps)
