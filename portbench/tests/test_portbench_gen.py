"""The generator repeats from its seed."""

import numpy as np
import torch

from portbench.gen import birdies, channel_delays, draw_pulsars, make_samples

from .conftest import TINY_CONFIG, TINY_TRAFFIC


def test_the_same_seed_gives_the_same_bytes_and_pulsars():
    a, pa = make_samples(TINY_CONFIG, TINY_TRAFFIC, 2**31 + 11, torch.device("cpu"))
    b, pb = make_samples(TINY_CONFIG, TINY_TRAFFIC, 2**31 + 11, torch.device("cpu"))
    assert np.array_equal(a, b)
    assert pa == pb
    c, pc = make_samples(TINY_CONFIG, TINY_TRAFFIC, 2**31 + 12, torch.device("cpu"))
    assert not np.array_equal(a, c)
    assert pa != pc


def test_bytes_are_packed_two_bit_samples_of_the_header():
    h = TINY_CONFIG["header"]
    raw, _ = make_samples(TINY_CONFIG, TINY_TRAFFIC, 5, torch.device("cpu"))
    assert raw.dtype == np.uint8 and raw.size == h["nsamps"] * h["nchans"] // 4
    levels = np.stack([(raw >> (2 * k)) & 3 for k in range(4)], axis=1).ravel()
    counts = np.bincount(levels, minlength=4) / levels.size
    # the 2-bit quantiser's Gaussian level shares: ~16%, 34%, 34%, 16%
    assert np.allclose(counts, [0.163, 0.337, 0.337, 0.163], atol=0.02)


def test_eight_bit_samples_sit_about_128():
    cfg = dict(TINY_CONFIG, header=dict(TINY_CONFIG["header"], nbits=8),
               quantiser={"sigma_levels": 32.0})
    noise = dict(TINY_TRAFFIC, pulsars=[], mains=dict(TINY_TRAFFIC["mains"], amplitude=0.0))
    data, _ = make_samples(cfg, noise, 5, torch.device("cpu"))
    assert data.size == cfg["header"]["nsamps"] * cfg["header"]["nchans"]
    assert abs(float(data.mean()) - 128.0) < 1.0
    assert abs(float(data.std()) - 32.0) < 1.0


def test_pulsars_are_the_mixs_at_phases_drawn_from_the_seed():
    a, b = draw_pulsars(TINY_TRAFFIC, 1), draw_pulsars(TINY_TRAFFIC, 2**33 + 7)
    for p, q, slot in zip(a, b, TINY_TRAFFIC["pulsars"]):
        assert (p.period_s, p.dm, p.duty, p.snr, p.accel) == (
            slot["period_s"], slot["dm"], slot["duty"], slot["snr"], slot["accel"])
        assert (q.period_s, q.dm, q.accel) == (p.period_s, p.dm, p.accel)
        assert 0 <= p.phase < 1 and p.phase != q.phase


def test_birdies_are_the_mains_harmonics_injected():
    assert birdies(TINY_CONFIG, TINY_TRAFFIC) == [(50.0, 0.5), (100.0, 0.5)]


def test_delays_grow_toward_the_bottom_of_the_band():
    d = channel_delays(TINY_CONFIG["header"], 30.0)
    assert d[0] == 0 and np.all(np.diff(d) >= 0) and d[-1] > 0
