"""The port's single-pulse ops (peasoup_tpu_torch.ops.singlepulse) and host
clustering (pipeline/single_pulse.py) against the JAX package's on the same
numpy-seeded inputs.

The boxcar sweeps are held bitwise: both plain versions against the JAX
twins and against the Pallas kernels in interpret mode, fed the JAX
package's own prefix sums (torch's cumsum adds in another order than
XLA's). Normalisation and the search block's S/N are held to 1e-5
absolute: the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops import singlepulse as jsp
from peasoup_tpu.ops.pallas.boxcar import boxcar_best_pallas
from peasoup_tpu.ops.pallas.spchain import boxcar_dec_best_pallas
from peasoup_tpu.pipeline import single_pulse as jpipe
from peasoup_tpu_torch.ops import singlepulse as sp
from peasoup_tpu_torch.pipeline import single_pulse as pipe

# sums in another order than XLA's move normalised samples and S/N by a
# few f32 ulps of values of order 10
TOL = 1e-5


def _trials(nsamps, seed=0, rows=3):
    """Noise trials with a narrow bright pulse in row 0, a broad faint one
    in row 1 and a flat stretch in row 2."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, nsamps)).astype(np.float32)
    x[0, nsamps // 2 : nsamps // 2 + 12] += 20.0
    x[1, nsamps // 4 : nsamps // 4 + 200] += 1.5
    x[2, 10:300] = 0.0
    return x


@pytest.mark.parametrize("nsamps", [1, 1000, 1024, 5000, 8192, 8193, 20000, 1 << 15])
def test_plan_pad_matches_jax(nsamps):
    assert sp.plan_pad(nsamps) == jsp.plan_pad(nsamps)


@pytest.mark.parametrize("n_widths,max_width", [(1, 0), (6, 0), (12, 0), (12, 100), (14, 4096)])
def test_width_bank_matches_jax(n_widths, max_width):
    widths = sp.default_widths(n_widths, max_width)
    assert widths == jsp.default_widths(n_widths, max_width)
    np.testing.assert_array_equal(sp.width_scales(widths), jsp.width_scales(widths))
    assert sp.width_scales(widths).dtype == np.float32
    assert sp.width_extent(widths) == jsp.width_extent(widths)


@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_normalise_matches_jax(kind):
    x = _trials(20000, seed=1)
    if kind == "u8":
        x = np.clip(np.rint(x * 6 + 60), 0, 255).astype(np.uint8)
    got = sp.normalise_trials(torch.from_numpy(x)).numpy()
    want = np.asarray(jsp.normalise_trials(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_prefix_sum_matches_jax():
    norm = np.asarray(jsp.normalise_trials(jnp.asarray(_trials(5000, seed=2))))
    widths = sp.default_widths(8)
    tpad, wext = sp.plan_pad(5000)[0], sp.width_extent(widths)
    got = sp.prefix_sum_padded(torch.from_numpy(norm.copy()), tpad, wext).numpy()
    want = np.asarray(jsp.prefix_sum_padded(jnp.asarray(norm), tpad, wext))
    assert got.shape == want.shape == (3, tpad + wext)
    # cumulative sums of ~5000 unit-variance values: a few ulps of ~100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert not got[:, 5001:].any() and not got[:, 0].any()


def _jax_csum(nsamps, n_widths, seed):
    """The JAX package's normalised prefix sums and the sweep's geometry."""
    widths = jsp.default_widths(n_widths)
    tpad, span = jsp.plan_pad(nsamps)
    wext = jsp.width_extent(widths)
    norm = jsp.normalise_trials(jnp.asarray(_trials(nsamps, seed)))
    csum = jsp.prefix_sum_padded(norm, tpad, wext)
    return csum, widths, jsp.width_scales(widths), tpad, span


# nsamps: tails short of tpad (5000 of 5120, 20000 of 24576) and one
# filling it exactly (16384)
@pytest.mark.parametrize("nsamps,n_widths", [(5000, 8), (16384, 6), (20000, 11)])
def test_boxcar_best_bitwise(nsamps, n_widths):
    csum, widths, scales, tpad, span = _jax_csum(nsamps, n_widths, 3)
    got = sp.boxcar_best(torch.from_numpy(np.array(csum)), widths, scales, nsamps, tpad)
    twin = jsp.boxcar_best_twin(csum, widths, scales, nsamps, tpad)
    kern = boxcar_best_pallas(csum, widths, scales, nsamps, tpad, span=span,
                              interpret=True)
    for want in (twin, kern):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.isneginf(got[0][:, nsamps:].numpy()).all()


@pytest.mark.parametrize("dec", [8, 32, 64])
@pytest.mark.parametrize("nsamps,n_widths", [(5000, 8), (20000, 11)])
def test_boxcar_dec_best_bitwise(nsamps, n_widths, dec):
    csum, widths, scales, tpad, span = _jax_csum(nsamps, n_widths, 4)
    got = sp.boxcar_dec_best(torch.from_numpy(np.array(csum)), widths, scales,
                             nsamps, tpad, dec)
    twin = jsp.boxcar_dec_best_twin(csum, widths, scales, nsamps, tpad, dec)
    kern = boxcar_dec_best_pallas(csum, widths, scales, nsamps, tpad, dec, span=span,
                                  interpret=True)
    for want in (twin, kern):
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the dec-fold of the unfused sweep is the fused one
    best, bw = sp.boxcar_best(torch.from_numpy(np.array(csum)), widths, scales,
                              nsamps, tpad)
    for f, g in zip(sp.dec_fold(best, bw, dec), got):
        assert torch.equal(f, g)


@pytest.mark.parametrize("dec", [48, 96, 2048, 3072])
def test_odd_decimations_run(dec):
    # a decimation spchain does not take (not a power of two <= 1024) but
    # that divides tpad (20000 -> 24576 = 2^13 x 3): the JAX twin's result,
    # bit for bit, through the sweep and the torch dec-fold
    nsamps = 20000
    csum, widths, scales, tpad, _ = _jax_csum(nsamps, 8, 5)
    assert not sp.spchain_takes(dec) and tpad % dec == 0
    got = sp.boxcar_dec_best(torch.from_numpy(np.array(csum)), widths, scales, nsamps,
                             tpad, dec)
    want = jsp.boxcar_dec_best_twin(csum, widths, scales, nsamps, tpad, dec)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [sp.spchain_takes(d) for d in (1, 2, 32, 1024, 2048, 48, 0)] == [
        True, True, True, True, False, False, False]


@pytest.mark.parametrize("dec", [0, 24, 2048])
def test_bad_decimation_is_refused(dec):
    # a decimation must divide the padded trial length (5,120 here), as in
    # the JAX package; any that does is taken (test_odd_decimations_run)
    widths = sp.default_widths(4)
    csum = torch.zeros((1, 5120 + sp.width_extent(widths)))
    with pytest.raises(ValueError, match="decimate"):
        sp.boxcar_dec_best(csum, widths, sp.width_scales(widths), 5000, 5120, dec)


def test_narrow_prefix_rows_are_refused():
    widths = sp.default_widths(4)
    with pytest.raises(ValueError, match="widths up to 8"):
        sp.boxcar_best(torch.zeros((1, 2048 + 8)), widths, sp.width_scales(widths),
                       2000, 2048)


@pytest.mark.parametrize(
    "rc,error,words",
    [(-1, ValueError, "shared-memory ring"), (-2, ValueError, "multiple of 512"),
     (1, RuntimeError, "CUDA error 1")],
)
def test_spchain_entry_refusals_are_worded(monkeypatch, rc, error, words):
    # the spchain entry alone decides its ring and layout; kernels.launch
    # words its refusals and counts no launch
    from types import SimpleNamespace

    from peasoup_tpu_torch import kernels

    monkeypatch.setattr(kernels, "_load", lambda name: SimpleNamespace(boxcar_dec_best=lambda *a: rc))
    before = kernels.launches["spchain"]
    with pytest.raises(error, match=words):
        kernels.launch("spchain", shape=(1, 2048, 1024, 1, 32))
    assert kernels.launches["spchain"] == before


@pytest.mark.parametrize(
    "rc,error,words",
    [(-1, ValueError, "shared-memory ring"), (-2, ValueError, "multiple of 512"),
     (1, RuntimeError, "CUDA error 1")],
)
def test_boxcar_entry_refusals_are_worded(monkeypatch, rc, error, words):
    # the boxcar entry alone decides its ring and layout, as spchain's
    from types import SimpleNamespace

    from peasoup_tpu_torch import kernels

    monkeypatch.setattr(kernels, "_load", lambda name: SimpleNamespace(boxcar_best=lambda *a: rc))
    before = kernels.launches["boxcar"]
    with pytest.raises(error, match=words):
        kernels.launch("boxcar", shape=(1, 2048, 1024, 1))
    assert kernels.launches["boxcar"] == before


@pytest.mark.parametrize("widths", [sp.default_widths(12), (1, 3, 5, 7, 12)])
def test_boxcar_bank_goes_by_value(monkeypatch, widths):
    # on the card's path the wrapper hands the C entry the bank in host
    # memory (the entry passes it to the kernel by value) and allocates
    # the two outputs and nothing else: no device tensor, no copy
    import ctypes
    from types import SimpleNamespace

    from peasoup_tpu_torch import kernels

    seen = {}

    def entry(csum, w_ptr, s_ptr, n, rows, row_len, tpad, nvalid, best, bw, stream):
        seen["bank"] = (np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(w_ptr)).copy(),
                        np.ctypeslib.as_array((ctypes.c_float * n).from_address(s_ptr)).copy())
        seen["sizes"] = (rows, row_len, tpad, nvalid)
        return 0

    made = []
    empty = torch.empty

    def counted_empty(*a, **k):
        made.append((a, k.get("dtype")))
        return empty(*a, **k)

    def refused(*a, **k):
        raise AssertionError("the wrapper made a tensor for the bank")

    monkeypatch.setattr(kernels, "_load", lambda name: SimpleNamespace(boxcar_best=entry))
    monkeypatch.setattr(sp, "on_cpu", lambda *t: False)
    monkeypatch.setattr(sp, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch, "empty", counted_empty)
    for name in ("tensor", "as_tensor", "from_numpy", "zeros", "full"):
        monkeypatch.setattr(torch, name, refused)
    tpad, wext = 8192, sp.width_extent(widths)
    scales = sp.width_scales(widths)
    csum = empty((3, tpad + wext), dtype=torch.float32)
    before = kernels.launches["boxcar"]
    best, bw = sp.boxcar_best(csum, widths, scales, 8000, tpad)
    assert kernels.launches["boxcar"] == before + 1
    assert made == [(((3, tpad),), torch.float32), (((3, tpad),), torch.int32)]
    assert best.shape == bw.shape == (3, tpad)
    np.testing.assert_array_equal(seen["bank"][0], np.asarray(widths, np.int32))
    np.testing.assert_array_equal(seen["bank"][1].view(np.int32), scales.view(np.int32))
    assert seen["sizes"] == (3, tpad + wext, tpad, 8000)


def test_boxcar_probe_variants_apply():
    # boxcar_probe.py builds each variant by defining macros: each must be
    # one boxcar.cu tests (an unknown one would quietly build the kernel
    # itself), and the port's own build defines none of them
    import sys
    from pathlib import Path

    from peasoup_tpu_torch import kernels

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import boxcar_probe

    text = kernels.source("boxcar").read_text()
    assert boxcar_probe.VARIANTS["kernel"] == []
    macros = [m for ms in boxcar_probe.VARIANTS.values() for m in ms]
    assert len(macros) == len(set(macros)) == len(boxcar_probe.VARIANTS) - 1
    for m in macros:
        assert f"#if defined({m})" in text, m
        assert not any(m in flag for flag in kernels.NVCC_FLAGS), m


@pytest.mark.parametrize("max_events", [1, 3, 64])
def test_search_block_matches_jax(max_events):
    # rows 0 and 1 hold several events each, so small max_events overflow
    x = _trials(20000, seed=5, rows=4)
    x[3, 3000:3004] += 9.0
    widths = sp.default_widths(11)
    got = [a.numpy() for a in sp.single_pulse_search_block(
        torch.from_numpy(x), widths, 6.0, max_events, 32)]
    fn = jsp.make_single_pulse_search_fn(widths, 6.0, max_events, 32, 0)
    want = [np.asarray(a) for a in fn(jnp.asarray(x))]
    for name, g, w in zip(("samples", "width_idx", "snrs", "counts"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=TOL)
    assert (got[3] > 0).sum() >= 3
    if max_events == 1:
        assert (got[3] > max_events).any()  # overflow reached


def test_matched_filter_snr_matches_jax():
    for args in ((9.0, 8, 1.0), (64, 16, 6.5), (2.45, 128, 1.0)):
        assert sp.matched_filter_snr(*args) == jsp.matched_filter_snr(*args)


def _events(seed, n=400):
    """Seeded events: a few pulses seen across DM trials and widths, and
    scattered noise events."""
    rng = np.random.default_rng(seed)
    rows = []
    for t0 in rng.integers(0, 200_000, size=6):
        d0 = int(rng.integers(2, 40))
        for _ in range(n // 10):
            rows.append((d0 + int(rng.integers(-3, 4)), int(t0 + rng.integers(-80, 80)),
                         int(rng.integers(0, 8)), float(rng.uniform(6, 30))))
    for _ in range(n - len(rows)):
        rows.append((int(rng.integers(0, 50)), int(rng.integers(0, 200_000)),
                     int(rng.integers(0, 8)), float(rng.uniform(6, 8))))
    return rows


@pytest.mark.parametrize("seed,time_link,dm_link,dec", [(0, 1.0, 2, 32), (1, 0.5, 1, 8),
                                                        (2, 2.0, 3, 0)])
def test_clustering_matches_jax(seed, time_link, dm_link, dec):
    widths = tuple(1 << k for k in range(8))
    rows = _events(seed)
    ev = np.asarray(rows, dtype=pipe._EVENT_DTYPE)
    kw = dict(time_link=time_link, dm_link=dm_link, dec=dec)
    got = pipe.cluster_events_fof(ev, widths, **kw)
    want = jpipe.cluster_events_fof(np.asarray(rows, dtype=jpipe._EVENT_DTYPE), widths, **kw)
    assert 6 <= len(got) < len(ev)
    assert [m.tolist() for m in got] == [m.tolist() for m in want]
    dm_list = np.linspace(0, 100, 60).astype(np.float32)
    cands = pipe.candidates_from_clusters(ev, got, widths, dm_list, 0.000256)
    ref = jpipe.candidates_from_clusters(ev, want, widths, dm_list, 0.000256)
    assert [vars(c) for c in cands] == [vars(c) for c in ref]


def test_clustering_of_no_events():
    ev = np.asarray([], dtype=pipe._EVENT_DTYPE)
    assert pipe.cluster_events_fof(ev, (1, 2)) == []
