"""The port's coincidencer and delay finder (peasoup_tpu_torch.ops.
coincidence, parallel.coincidence, ops.correlate and their CLIs) against
the JAX package's on the CPU, same inputs (the recipes of
tests/test_cli.py and tests/test_aux.py).

Equality classes: the coincidence mask is a count of threshold crossings,
held bit for bit. baseline_beam goes through FFTs, whose rounding differs
between torch's and XLA's CPU FFTs, so it is held to the tolerance the
port holds whiten_fseries to (tests/test_torch_fold.py): relative 1e-4,
absolute 1e-5 of the largest value. The CLIs' mask and birdie files are
compared line for line: none of these inputs' values lies close enough
to the threshold for that rounding to move a crossing. The delay finder's
lags and window positions are held exactly, its peak power to 1e-4."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from peasoup_tpu_torch.ops.coincidence import coincidence_mask
from peasoup_tpu_torch.ops.correlate import baseline_pairs, find_delays
from peasoup_tpu_torch.parallel.coincidence import baseline_beam
from test_pipeline import make_synthetic_fil

JC = importlib.import_module("peasoup_tpu.ops.coincidence")
JP = importlib.import_module("peasoup_tpu.parallel.coincidence")
JR = importlib.import_module("peasoup_tpu.ops.correlate")


@pytest.mark.parametrize("thresh,beam_thresh", [(0.5, 2), (1.5, 3), (4.0, 4)])
def test_coincidence_mask_bitwise(thresh, beam_thresh):
    beams = np.random.default_rng(0).normal(size=(6, 5000)).astype(np.float32) * 2
    want = np.asarray(JC.coincidence_mask(jnp.asarray(beams), thresh, beam_thresh))
    got = coincidence_mask(torch.from_numpy(beams), thresh, beam_thresh)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [8192, 6001])  # a power of two, and the full odd length
def test_baseline_beam_matches_jax(size):
    tim = np.random.default_rng(size).integers(0, 200, size=size).astype(np.uint8)
    want = JP.baseline_beam(jnp.asarray(tim), size=size, pos5=3, pos25=30)
    got = baseline_beam(torch.from_numpy(tim), size=size, pos5=3, pos25=30)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max())


@pytest.fixture(scope="module")
def beams(tmp_path_factory):
    # five beams of 64 channels: the burst in four, the tone in all, the
    # pulsar in beam 0
    tmp = tmp_path_factory.mktemp("coin")
    return chip_smoke.coincidence_beams(str(tmp), nbeams=5, burst_beams=4,
                                        nsamps=30_000, nchans=64, burst=(9_000, 8))


def _run_both(beams, tmp_path, extra=()):
    from peasoup_tpu.cli.coincidencer import main as jax_main
    from peasoup_tpu_torch.cli.coincidencer import main

    out = {}
    for name, fn, dev in (("port", main, ["--device", "cpu"]), ("jax", jax_main, [])):
        mask, birdies = tmp_path / f"{name}.mask", tmp_path / f"{name}.birdies"
        assert fn([*beams, "--o", str(mask), "--o2", str(birdies), *extra, *dev]) == 0
        out[name] = (mask.read_text(), birdies.read_text())
    return out


def test_coincidencer_cli_matches_jax(beams, tmp_path):
    out = _run_both(beams, tmp_path, ["--thresh", "4", "--beam_thresh", "3"])
    assert out["port"] == out["jax"]
    lines = out["port"][0].splitlines()
    assert lines[0] == "#0 1"
    mask = np.array([int(x) for x in lines[1:]])
    assert mask.size == 30_000  # the full length, not a power of two
    assert (mask[9_000:9_008] == 0).all()  # the burst is flagged
    flagged = np.flatnonzero(mask == 0)
    assert ((flagged >= 8_900) & (flagged < 9_300)).all()
    # the tone's fundamental is a birdie
    birdies = np.loadtxt(out["port"][1].splitlines(), ndmin=2)
    f = chip_smoke.COIN_TONE_HZ
    assert (np.abs(birdies[:, 0] - f) <= birdies[:, 1] / 2 + 0.5).any()


def test_coincidencer_pure_noise(tmp_path):
    # tests/test_cli.py's recipe: four noise beams, almost nothing flagged
    paths = []
    for b in range(4):
        d = tmp_path / f"b{b}"
        d.mkdir()
        paths.append(str(make_synthetic_fil(d, nsamps=1 << 13, amp=0.0, seed=100 + b)[0]))
    out = _run_both(paths, tmp_path, ["--thresh", "4", "--beam_thresh", "3"])
    assert out["port"] == out["jax"]
    mask = np.array([int(x) for x in out["port"][0].splitlines()[1:]])
    assert mask.size == 1 << 13 and mask.mean() > 0.9


def test_birdies_from_mask():
    from peasoup_tpu.cli.coincidencer import birdies_from_mask as jax_birdies
    from peasoup_tpu_torch.cli.coincidencer import birdies_from_mask

    mask = np.array([1, 1, 0, 0, 0, 1, 0, 1, 0])
    assert birdies_from_mask(mask, 2.0) == jax_birdies(mask, 2.0)
    assert birdies_from_mask(mask, 2.0)[0] == (5.0, 6.0)


# --- the delay finder ------------------------------------------------------


def test_baseline_pairs():
    for n in (1, 2, 4, 7):
        np.testing.assert_array_equal(baseline_pairs(n), JR.baseline_pairs(n))
    assert baseline_pairs(4).tolist() == [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]


@pytest.mark.parametrize("complex_input", [False, True])
def test_find_delays_matches_jax(complex_input):
    rng = np.random.default_rng(42)
    n = 1024
    base = rng.normal(size=n).astype(np.float32)
    if complex_input:
        base = (base + 1j * rng.normal(size=n)).astype(np.complex64)
    lags = (0, 7, -11, 300)
    beams = np.stack([np.roll(base, k) for k in lags])
    want = JR.find_delays(beams, max_delay=32)
    got = find_delays(beams, max_delay=32, device="cpu")
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.distance.numpy(), np.asarray(want.distance))
    np.testing.assert_array_equal(got.lag.numpy(), np.asarray(want.lag))
    np.testing.assert_allclose(got.power.numpy(), np.asarray(want.power), rtol=1e-4)
    found = {tuple(p): int(v) for p, v in zip(got.pairs.tolist(), got.lag)}
    assert found[(0, 1)] == 7 and found[(0, 2)] == -11 and found[(1, 2)] == -18


def test_find_delays_window_and_validation():
    x = np.zeros(256, dtype=np.float32)
    x[10] = 1.0
    res = find_delays(np.stack([x, np.roll(x, -3)]), max_delay=8, device="cpu")
    assert int(res.distance[0]) == 2 * 8 - 3 and int(res.lag[0]) == -3
    z = np.ones((2, 128), np.complex64)
    with pytest.raises(ValueError):
        find_delays(z, max_delay=100, device="cpu")
    with pytest.raises(ValueError):
        find_delays(z[0], max_delay=4, device="cpu")


def test_accmap_cli_matches_jax(tmp_path, capsys):
    from peasoup_tpu.cli.accmap import main as jax_main
    from peasoup_tpu_torch.cli.accmap import main
    from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader, write_filterbank

    rng = np.random.default_rng(0)
    n, nchans = 4096, 4
    base = rng.normal(100, 5, size=n + 64)
    files = []
    for k, off in enumerate((0, 17, 40)):
        data = np.clip(base[off : off + n, None] + rng.normal(0, 0.5, size=(n, nchans)),
                       0, 255).astype(np.uint8)
        hdr = SigprocHeader(
            source_name=f"b{k}", data_type=1, nchans=nchans, nbits=8, nifs=1,
            tsamp=0.001, tstart=50000.0, fch1=1500.0, foff=-1.0,
        )
        path = str(tmp_path / f"beam{k}.fil")
        write_filterbank(path, Filterbank(header=hdr, data=data))
        files.append(path)
    assert main(files + ["-d", "64", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jax_main(files + ["-d", "64"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if "Distance" in ln]
    assert len(got) == len(want) == 3

    def fields(line):
        head, power = line.rsplit("power ", 1)
        return head, float(power.rstrip(")"))

    for g, w in zip(got, want):
        (gh, gp), (wh, wp) = fields(g), fields(w)
        assert gh == wh
        assert abs(gp - wp) <= 1e-2 * wp  # printed to 3 significant digits
    assert "(lag -17 samples" in got[0]
