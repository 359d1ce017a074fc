"""Each kernel's count against a hand count at a small shape."""

import pytest

from portbench import roofline


def test_dedisperse_counts_one_add_a_channel_sample_and_no_multiply():
    # 10 input samples, 4 channels, 3 DM trials, 8 output samples
    ops, nbytes = roofline.load("dedisperse").count((10, 4, 3, 8))
    assert ops == 3 * 8 * 4 + 3 * 8  # adds, then one scale an output sample
    assert nbytes == 10 * 4 + 3 * 4 * 4 + 3 * 8


def test_dedisperse_counts_only_the_kept_channels():
    # 2 of the 4 channels killed
    config = {"header": {"nchans": 4}, "killed": [[0, 2]]}
    ops, nbytes = roofline.load("dedisperse").count((10, 4, 3, 8), config)
    assert ops == 3 * 8 * 2 + 3 * 8
    assert nbytes == 10 * 2 + 3 * 2 * 4 + 3 * 8


def test_resample():
    assert roofline.load("resample").count((5, 2, 64)) == (4 * 5 * 64, 5 * 64 * 4 + 64 * 4 + 5 * 8)


def test_specchain():
    assert roofline.load("specchain").count((3, 100)) == (14 * 300, 3 * 100 * 24 + 100)


def test_interbin():
    # m = 8 half-length bins -> 9 real bins, padded to 16
    assert roofline.load("interbin").count((2, 8, 16)) == (29 * 2 * 9, 2 * (8 * 8 + 16 * 4 + 8) + 9 * 8)


def test_harmpeaks():
    # 4,096 + 5 padded bins hold at least 6 true bins; 4 levels above the spectrum
    ops, nbytes = roofline.load("harmpeaks").count((2, 4101, 4, 128))
    assert ops == 2 * 6 * (15 + 10)
    assert nbytes == 2 * 6 * 4 + 2 * 5 * (128 * 8 + 8)


@pytest.mark.parametrize("kernel", roofline.kernels())
def test_every_count_names_its_symbols_and_counts_positive(kernel):
    mod = roofline.load(kernel)
    assert mod.SYMBOLS and all(isinstance(s, str) for s in mod.SYMBOLS)


def test_the_bound_takes_the_larger_of_the_two_times():
    peak = (1e12, 1e11)  # FLOP/s, bytes/s
    t, by = roofline.bound_seconds("dedisperse", {(10, 4, 3, 8): 2}, peak)
    ops, nbytes = roofline.load("dedisperse").count((10, 4, 3, 8))
    assert by == "bytes" and t == pytest.approx(2 * nbytes / 1e11)
    t, by = roofline.bound_seconds("dedisperse", {(10, 4, 3, 8): 2}, (1e6, 1e12))
    assert by == "operations" and t == pytest.approx(2 * ops / 1e6)
