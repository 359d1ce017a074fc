"""The port's acceleration search end to end on the CPU
(peasoup_tpu_torch.pipeline.search.PeasoupSearch with device="cpu", and
its CLI) against the JAX package's PeasoupSearch on the same 8-bit
synthetic filterbank.

Recall standard (ROADMAP.md): the same candidate count and, rank by
rank, the same dm_idx, acc and nh, the frequency bit for bit, and S/N
within a relative 1e-3. The two packages' CPU FFTs round differently,
which moves S/N in the sixth digit; no candidate of this input lies close enough to the threshold for that
to change the candidate set, so every candidate is compared.
"""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import peasoup_tpu.native
from peasoup_tpu.io import read_filterbank as jax_read_filterbank
from peasoup_tpu.pipeline import PeasoupSearch as JaxSearch
from peasoup_tpu.pipeline import SearchConfig as JaxConfig
from peasoup_tpu_torch.cli.peasoup import main as cli_main
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from test_pipeline import make_synthetic_fil

KW = dict(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_fil(tmp_path_factory.mktemp("torch_search"))


@pytest.fixture(scope="module")
def jax_result(synthetic):
    # the JAX package's pure-Python host path, which the port carries:
    # its native C++ distiller orders S/N ties between accel trials with
    # bitwise-equal spectra differently, so another representative of
    # such a tie can head a candidate
    path, _, _ = synthetic
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(peasoup_tpu.native, "_load", lambda: None)
        return JaxSearch(JaxConfig(**KW)).run(jax_read_filterbank(path))


@pytest.fixture(scope="module")
def port_result(synthetic):
    path, _, _ = synthetic
    return PeasoupSearch(SearchConfig(**KW), device="cpu").run(read_filterbank(path))


def _identity(c):
    return (c.dm_idx, c.acc, c.nh, np.float32(c.freq))


def test_candidates_match_jax(jax_result, port_result):
    want, got = jax_result.candidates, port_result.candidates
    assert len(want) > 10
    assert len(got) == len(want)
    for rank, (a, b) in enumerate(zip(want, got)):
        assert _identity(b) == _identity(a), f"rank {rank}: {b} vs {a}"
        assert abs(b.snr - a.snr) <= 1e-3 * abs(a.snr), f"rank {rank}"
    np.testing.assert_array_equal(port_result.dm_list, jax_result.dm_list)
    np.testing.assert_array_equal(port_result.acc_list_dm0, jax_result.acc_list_dm0)
    assert port_result.n_accel_trials == jax_result.n_accel_trials
    assert (port_result.nsamps, port_result.size) == (jax_result.nsamps, jax_result.size)


def test_recovers_the_pulsar(synthetic, port_result):
    _, period, _ = synthetic
    top = port_result.candidates[0]
    assert abs(1.0 / top.freq - period) / period < 2e-3
    assert top.snr > 20.0


@pytest.mark.parametrize(
    "overrides",
    [
        dict(dedupe_accel=False),  # every accel trial dispatched
        dict(max_peaks=1),  # every row batch escalates its cluster slots
    ],
)
def test_dispatch_options_give_the_same_candidates(synthetic, port_result, overrides):
    path, _, _ = synthetic
    res = PeasoupSearch(SearchConfig(**KW, **overrides), device="cpu").run(
        read_filterbank(path)
    )
    assert [(_identity(c), c.snr) for c in res.candidates] == [
        (_identity(c), c.snr) for c in port_result.candidates
    ]


def test_small_blocks_give_the_same_candidates(synthetic, port_result):
    # many DM blocks and row batches; the CPU FFT of a smaller batch may
    # round differently, so S/N is held to 1e-5 relative
    path, _, _ = synthetic
    cfg = SearchConfig(**KW, hbm_bytes=1 << 22, dm_block=3)
    res = PeasoupSearch(cfg, device="cpu").run(read_filterbank(path))
    assert [_identity(c) for c in res.candidates] == [
        _identity(c) for c in port_result.candidates
    ]
    for a, b in zip(port_result.candidates, res.candidates):
        assert abs(b.snr - a.snr) <= 1e-5 * a.snr


def test_cli_writes_both_files(synthetic, tmp_path, port_result):
    path, period, _ = synthetic
    out = tmp_path / "out"
    argv = [
        "-i", str(path), "-o", str(out), "--dm_start", "0", "--dm_end", "40",
        "--acc_start", "-2", "--acc_end", "2", "-m", "6", "--device", "cpu",
    ]
    assert cli_main(argv) == 0
    assert os.path.getsize(out / "candidates.peasoup") > 0
    root = ET.parse(out / "overview.xml").getroot()
    cands = root.findall("candidates/candidate")
    assert len(cands) == len(port_result.candidates)
    assert abs(float(cands[0].find("period").text) - period) / period < 2e-3
    assert root.find("cuda_device_parameters/platform").text == "cpu"
    assert float(root.find("execution_times/searching").text) > 0


@pytest.mark.parametrize(
    "overrides,item",
    [
        (dict(subbands=4), "A.3"),
        (dict(checkpoint_file="ck.json"), "A.8"),
        (dict(tune=True), "A.16"),
        (dict(shard_devices=2), "A.15"),
    ],
)
def test_unported_options_are_refused(overrides, item):
    with pytest.raises(NotImplementedError, match=item):
        PeasoupSearch(SearchConfig(**overrides), device="cpu")


# --- an accelerated pulsar, searched with folding -------------------------
#
# tests/test_accel_recovery.py's recipe, shrunk: the pulse phase follows the
# inverse of the resample map, so the matching accel trial resamples it
# back to an exactly periodic series. At 2^15 samples of 1 ms the injected
# acceleration drifts the pulse by 9.8 samples at mid-series, 2.5 pulse
# widths, and the widest trial's resample span is 19 samples.
ACC_NCHANS, ACC_TSAMP, ACC_FCH1, ACC_FOFF = 16, 0.001, 1500.0, -20.0
ACC_SIZE = 1 << 15
P_INJ, DM_INJ, ACC_INJ = 0.05003, 20.0, 22000.0
ACC_KW = dict(
    dm_end=40.0, acc_start=-40000.0, acc_end=40000.0, acc_pulse_width=2000.0,
    npdmp=5, limit=50,
)


@pytest.fixture(scope="module")
def acc_fil(tmp_path_factory):
    from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader, write_filterbank
    from peasoup_tpu_torch.ops.resample import accel_factor
    from peasoup_tpu_torch.plan.dm_plan import DMPlan

    rng = np.random.default_rng(11)
    plan = DMPlan.create(
        ACC_SIZE + 64, ACC_NCHANS, ACC_TSAMP, ACC_FCH1, ACC_FOFF, 0.0, ACC_KW["dm_end"]
    )
    # 64 samples past the FFT size survive dedispersion, so the search
    # and the folder both transform ACC_SIZE samples
    nsamps = ACC_SIZE + 64 + plan.max_delay
    af = float(accel_factor(np.array([ACC_INJ]), ACC_TSAMP)[0])
    j = np.arange(nsamps, dtype=np.float64)
    ginv = j - af * j * (j - ACC_SIZE)
    pulse = (((ginv * ACC_TSAMP / P_INJ) % 1.0) < 0.08) * 12.0
    delays = np.rint(
        (np.float32(DM_INJ) * np.abs(plan.delays)).astype(np.float32)
    ).astype(int)
    data = rng.normal(100, 8, size=(nsamps, ACC_NCHANS))
    for c in range(ACC_NCHANS):
        src = np.clip(j - delays[c], 0, nsamps - 1).astype(int)
        data[:, c] += pulse[src]
    hdr = SigprocHeader(
        source_name="acc_pulsar", data_type=1, nchans=ACC_NCHANS, nbits=8,
        nifs=1, tsamp=ACC_TSAMP, tstart=50000.0, fch1=ACC_FCH1, foff=ACC_FOFF,
    )
    path = tmp_path_factory.mktemp("torch_acc") / "acc_pulsar.fil"
    write_filterbank(
        path, Filterbank(header=hdr, data=np.clip(data, 0, 255).astype(np.uint8))
    )
    return path


@pytest.fixture(scope="module")
def acc_results(acc_fil):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(peasoup_tpu.native, "_load", lambda: None)
        want = JaxSearch(JaxConfig(**ACC_KW)).run(jax_read_filterbank(acc_fil))
    got = PeasoupSearch(SearchConfig(**ACC_KW), device="cpu").run(read_filterbank(acc_fil))
    return want, got


def _assert_folded_recall(want, got):
    """The recall standard, and the fold fields: the optimised period
    equal (it moves in whole phase-bin shifts), the folded S/N within a
    relative 1e-3 (the dereddening and optimiser FFTs round differently)
    and the folds within 1e-3 of their peak."""
    assert len(got.candidates) == len(want.candidates)
    for rank, (a, b) in enumerate(zip(want.candidates, got.candidates)):
        assert _identity(b) == _identity(a), f"rank {rank}: {b} vs {a}"
        assert abs(b.snr - a.snr) <= 1e-3 * abs(a.snr), f"rank {rank}"
        assert b.opt_period == a.opt_period, f"rank {rank}"
        assert abs(b.folded_snr - a.folded_snr) <= 1e-3 * abs(a.folded_snr), f"rank {rank}"
        assert (a.fold is None) == (b.fold is None), f"rank {rank}"
        if a.fold is not None:
            np.testing.assert_allclose(
                b.fold, a.fold, rtol=0, atol=1e-3 * np.abs(a.fold).max()
            )


def test_folded_candidates_match_jax(acc_results):
    want, got = acc_results
    assert len(want.candidates) > 10
    assert got.size == want.size == ACC_SIZE
    _assert_folded_recall(want, got)
    assert sum(c.fold is not None for c in got.candidates) == ACC_KW["npdmp"]
    assert got.timers["folding"] > 0


def test_recovers_the_injected_acceleration(acc_fil, acc_results):
    from peasoup_tpu_torch.plan.accel_plan import AccelerationPlan

    _, got = acc_results
    best = max(got.candidates, key=lambda c: c.snr)
    assert abs(1.0 / best.freq - P_INJ) / P_INJ < 1e-4
    assert abs(best.dm - DM_INJ) < 5.0
    step = AccelerationPlan(
        acc_lo=ACC_KW["acc_start"], acc_hi=ACC_KW["acc_end"], tol=1.10,
        pulse_width=ACC_KW["acc_pulse_width"], nsamps=ACC_SIZE, tsamp=ACC_TSAMP,
        cfreq=ACC_FCH1 + (ACC_NCHANS / 2) * ACC_FOFF, bw=ACC_FOFF,
    ).step(best.dm)
    assert best.acc != 0.0  # a non-zero trial won
    assert abs(best.acc - ACC_INJ) <= 1.5 * step, (best.acc, step)
    assert best.folded_snr > 15.0
    assert abs(best.opt_period - P_INJ) / P_INJ < 2e-3
    # the acc = 0 trials see the pulse smeared
    zero = [c for c in got.candidates if c.acc == 0.0]
    assert all(c.snr < 0.8 * best.snr for c in zero)


def _read_candidates_file(path):
    """(fold or None, pods) per candidate of a candidates.peasoup file."""
    from peasoup_tpu_torch.core.candidates import CANDIDATE_POD_DTYPE

    buf, pos, out = path.read_bytes(), 0, []
    while pos < len(buf):
        fold = None
        if buf[pos : pos + 4] == b"FOLD":
            nbins, nints = np.frombuffer(buf, "<i4", 2, pos + 4)
            pos += 12
            fold = np.frombuffer(buf, "<f4", nbins * nints, pos).reshape(nints, nbins)
            pos += 4 * nbins * nints
        (ndets,) = np.frombuffer(buf, "<i4", 1, pos)
        pos += 4
        pods = np.frombuffer(buf, CANDIDATE_POD_DTYPE, ndets, pos)
        pos += pods.nbytes
        out.append((fold, pods))
    return out


def test_cli_writes_folds_like_jax(acc_fil, acc_results, tmp_path):
    from peasoup_tpu.io.output import CandidateFileWriter as JaxWriter

    want, _ = acc_results
    out = tmp_path / "out"
    flags = [f"--{k}={v}" for k, v in ACC_KW.items()]
    assert cli_main(["-i", str(acc_fil), "-o", str(out), "--device", "cpu", *flags]) == 0
    JaxWriter(str(tmp_path)).write_binary(want.candidates, "jax.peasoup")
    got = _read_candidates_file(out / "candidates.peasoup")
    ref = _read_candidates_file(tmp_path / "jax.peasoup")
    assert len(got) == len(ref) == len(want.candidates)
    assert sum(f is not None for f, _ in got) == ACC_KW["npdmp"]
    for (gf, gp), (rf, rp) in zip(got, ref):
        assert (gf is None) == (rf is None)
        if rf is not None:
            assert gf.shape == rf.shape == (16, 64)
            np.testing.assert_allclose(gf, rf, rtol=0, atol=1e-3 * np.abs(rf).max())
        for key in ("dm", "dm_idx", "acc", "nh", "freq"):
            np.testing.assert_array_equal(gp[key], rp[key])
        np.testing.assert_allclose(gp["snr"], rp["snr"], rtol=1e-3)
    root = ET.parse(out / "overview.xml").getroot()
    top = root.find("candidates/candidate")
    # the XML carries 16 significant digits
    assert float(top.find("opt_period").text) == pytest.approx(
        want.candidates[0].opt_period, rel=1e-15
    )
    assert float(top.find("folded_snr").text) == pytest.approx(
        want.candidates[0].folded_snr, rel=1e-3
    )
    assert float(root.find("execution_times/folding").text) > 0


# --- chip_smoke.py's binary grid at full length, at the pulsar's DM -------
#
# 2^21 + 8192 samples of 64 channels: about 5 GB and 45 s on the CPU for
# both duties, hence the slow marker. Run it with
#   JAX_PLATFORMS=cpu python -m pytest tests/test_torch_search.py -m slow -s


@pytest.mark.slow
@pytest.mark.parametrize("duty,folds_above_15", [(0.10, False), (0.03, True)])
def test_binary_grid_pulse_duty(tmp_path, duty, folds_above_15):
    """Both packages search the binary grid's filterbank at the pulsar's
    DM over the grid's accel range and agree, folds included; the
    pulsar's fundamental tops at a non-zero accel trial either way, but
    folds above S/N 15 (the smoke test's bar) only for the narrow pulse."""
    import chip_smoke

    path = tmp_path / "binary.fil"
    chip_smoke.binary_grid_fil(str(path), duty=duty)
    kw = dict(dm_start=10.0, dm_end=10.0, acc_start=-150.0, acc_end=150.0, npdmp=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(peasoup_tpu.native, "_load", lambda: None)
        want = JaxSearch(JaxConfig(**kw)).run(jax_read_filterbank(path))
    got = PeasoupSearch(SearchConfig(**kw), device="cpu").run(read_filterbank(path))
    _assert_folded_recall(want, got)
    for c in got.candidates[:3]:
        print(f"duty {duty}: P {1.0 / c.freq!r} s, acc {c.acc!r}, nh {c.nh}, "
              f"snr {c.snr!r}, folded_snr {c.folded_snr!r}, opt_period {c.opt_period!r}")
    top = got.candidates[0]
    assert abs(1.0 / top.freq - chip_smoke.BIN_PERIOD) / chip_smoke.BIN_PERIOD < 2e-3
    assert top.acc != 0.0
    assert (top.folded_snr > 15.0) == folds_above_15


@pytest.mark.parametrize("nbits", [2, 8])
def test_filterbank_files_cross_read(tmp_path, nbits):
    from peasoup_tpu.io import Filterbank as JaxFilterbank
    from peasoup_tpu.io import SigprocHeader as JaxHeader
    from peasoup_tpu.io import write_filterbank as jax_write_filterbank
    from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader, write_filterbank

    rng = np.random.default_rng(nbits)
    data = rng.integers(0, 1 << nbits, size=(1000, 16)).astype(np.uint8)
    hdr = dict(
        source_name="X", tsamp=6.4e-5, tstart=51000.5, fch1=1500.0, foff=-4.6875,
        nchans=16, nbits=nbits, nifs=1, data_type=1,
    )
    jax_write_filterbank(tmp_path / "j.fil", JaxFilterbank(header=JaxHeader(**hdr), data=data))
    write_filterbank(tmp_path / "t.fil", Filterbank(header=SigprocHeader(**hdr), data=data))
    assert (tmp_path / "j.fil").read_bytes() == (tmp_path / "t.fil").read_bytes()
    got = read_filterbank(tmp_path / "j.fil")
    want = jax_read_filterbank(tmp_path / "t.fil")
    np.testing.assert_array_equal(got.data, want.data)
    assert got.header.to_dict() == want.header.to_dict()
    assert (got.nsamps, got.cfreq) == (want.nsamps, want.cfreq)


def test_search_helpers_match_jax():
    from peasoup_tpu.pipeline import search as jax_search
    from peasoup_tpu_torch.pipeline import search as port_search

    rng = np.random.default_rng(5)
    nlev, nd = 3, 4
    cc = rng.integers(0, 4, size=(nlev, nd)).astype(np.int32)
    vi = rng.integers(0, 1000, size=int(cc.sum())).astype(np.int32)
    vs = rng.random(int(cc.sum())).astype(np.float32)
    emap = np.asarray([0, 0, 1, 2, 2, 3, 1])
    for name, args in (
        ("_expand_accel_results", (vi, vs, cc, emap, 16)),
        ("_densify_ragged", (vi, vs, cc)),
    ):
        got = getattr(port_search, name)(*args)
        want = getattr(jax_search, name)(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for n in (1, 4, 5, 16, 17, 45):
        assert port_search._accel_pad(n, 16) == jax_search._accel_pad(n, 16)
    # accel dedupe: an identity grid and one wide enough to split classes
    for accs, size in (([-2.0, 0.0, 2.0], 1 << 15), (np.linspace(-300, 300, 9), 1 << 17)):
        lists = [np.asarray(accs, np.float32)] * 2
        got = port_search._dedupe_identity_accels(lists, 0.000256, size)
        want = jax_search._dedupe_identity_accels(lists, 0.000256, size)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(g, w)
