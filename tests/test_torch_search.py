"""The port's acceleration search end to end on the CPU
(peasoup_tpu_torch.pipeline.search.PeasoupSearch with device="cpu", and
its CLI) against the JAX package's PeasoupSearch on the same 8-bit
synthetic filterbank.

Recall standard (ROADMAP.md): the same candidate count and, rank by
rank, the same dm_idx, acc and nh, the frequency bit for bit, and S/N
within a relative 1e-3. The two packages' CPU FFTs round differently,
which moves S/N in the sixth digit; no candidate of this input lies close enough to the threshold for that
to change the candidate set, so every candidate is compared.

Each comparison runs on both host paths (``HOSTS``): "native", both
packages' defaults, whose native libraries replay the reference's
std::sort (unstable), so exact S/N ties between accel trials with
bitwise-equal spectra crown the same member in both (the two libraries
are built by the same g++, so libstdc++'s arrangement of ties is the
same); and "python", the JAX package with its native library turned off
against the port under ``PEASOUP_NO_NATIVE=1``, both sorting stably.
"""

import os
from contextlib import contextmanager
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import peasoup_tpu.native
from peasoup_tpu.io import read_filterbank as jax_read_filterbank
from peasoup_tpu.pipeline import PeasoupSearch as JaxSearch
from peasoup_tpu.pipeline import SearchConfig as JaxConfig
from peasoup_tpu_torch.campaign.buckets import bucket_for_header
from peasoup_tpu_torch.cli.peasoup import main as cli_main
from peasoup_tpu_torch.perf import tuning
from peasoup_tpu_torch.plan.dedisp_plan import DedispPlan
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from test_pipeline import make_synthetic_fil

KW = dict(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0)
HOSTS = ["native", "python"]


@contextmanager
def host_path(host):
    """Both packages on one host path: their defaults ("native"), or the
    JAX package with its native library off and the port under
    PEASOUP_NO_NATIVE=1 ("python")."""
    with pytest.MonkeyPatch.context() as mp:
        if host == "python":
            mp.setattr(peasoup_tpu.native, "_load", lambda: None)
            mp.setenv("PEASOUP_NO_NATIVE", "1")
        yield


def _runs(path, jax_kw, port_kw):
    """(JAX result, port result) on ``path`` for each host path, each
    searched once, when a test first asks for it."""
    memo = {}

    def get(host):
        if host not in memo:
            with host_path(host):
                memo[host] = (
                    JaxSearch(JaxConfig(**jax_kw)).run(jax_read_filterbank(path)),
                    PeasoupSearch(SearchConfig(**port_kw), device="cpu").run(
                        read_filterbank(path)
                    ),
                )
        return memo[host]

    return get


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_fil(tmp_path_factory.mktemp("torch_search"))


@pytest.fixture(scope="module")
def synthetic_runs(synthetic):
    return _runs(synthetic[0], KW, KW)


@pytest.fixture(scope="module")
def port_result(synthetic_runs):
    return synthetic_runs("native")[1]


def _identity(c):
    return (c.dm_idx, c.acc, c.nh, np.float32(c.freq))


@pytest.mark.parametrize("host", HOSTS)
def test_candidates_match_jax(synthetic_runs, host):
    jax_result, port_result = synthetic_runs(host)
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


def test_exact_ties_crown_the_jax_default_member(synthetic_runs):
    # the accel trials of this input (-2, 0, +2 m/s^2) resample bitwise
    # alike, so their clusters tie exactly in S/N; the port's default
    # crowns the member the JAX package's default crowns, where the
    # stable sort of the Python path crowns the first trial in its list
    jax_native, port_native = synthetic_runs("native")
    _, port_python = synthetic_runs("python")
    assert [_identity(c) for c in port_native.candidates] == [
        _identity(c) for c in jax_native.candidates
    ]
    swapped = 0
    for a, b in zip(port_native.candidates, port_python.candidates):
        if _identity(a) != _identity(b):
            # a tie's other member: everything but the accel trial alike
            assert (a.dm_idx, a.nh, a.freq, a.snr) == (b.dm_idx, b.nh, b.freq, b.snr)
            swapped += 1
    assert swapped > 0


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


@pytest.mark.parametrize("case", ["cold", "warm"])
def test_tune_now_runs(synthetic, port_result, tmp_path, case):
    # ROADMAP A.10's first item, ported: tune, refused before, resolves the
    # bucket's plan from the tuning cache, measured on the CPU on a cold
    # bucket and read back with no measurement on a warm one. The tuned
    # DM block changes the CPU FFT's batch, so the identities are the
    # untuned run's, S/N within 1e-5 relative (as
    # test_small_blocks_give_the_same_candidates holds it)
    path, _, _ = synthetic
    cfg = SearchConfig(**KW, tune=True, tuning_cache=str(tmp_path / "tuning.json"))
    fil = read_filterbank(path)
    if case == "warm":
        PeasoupSearch(cfg, device="cpu").run(fil)
    n0 = tuning.measurement_count()
    search = PeasoupSearch(cfg, device="cpu")
    res = search.run(fil)
    plan = search.dedisp_plan
    if case == "cold":
        assert tuning.measurement_count() > n0
        assert plan.source == "tuned" and plan.trials
    else:
        assert tuning.measurement_count() == n0
        assert plan.source == "cache"
    assert plan.engine == "exact"  # 16 channels: below the subband floor
    assert search.knobs.dm_block == plan.dm_block > 0
    assert [_identity(c) for c in res.candidates] == [
        _identity(c) for c in port_result.candidates
    ]
    for a, b in zip(port_result.candidates, res.candidates):
        assert abs(b.snr - a.snr) <= 1e-5 * a.snr


def test_tune_shared_subband_plan_matches_jax(synthetic, tmp_path):
    # both packages read one cache file pre-filled with the same subband
    # plan (DM-scaled budgets from a 0.3 S/N loss), each under its own
    # device fingerprint; each rebuilds the budgets on the observation's
    # DM list and dedisperses in two stages. Recall standard: frequency,
    # DM and nh exact, S/N within 1e-3 relative
    from peasoup_tpu.perf import tuning as jax_tuning

    path, _, _ = synthetic
    bucket = bucket_for_header(read_filterbank(path).header)
    plan = DedispPlan(engine="subband", subbands=4, subband_smear=1.0, n_groups=1,
                      smear_dm_scaled=True, smear_loss_budget=0.3, source="tuned")
    cache = str(tmp_path / "tuning.json")
    doc = tuning._empty_cache()
    for fp in (jax_tuning.device_fingerprint(), tuning.device_fingerprint("cpu")):
        tuning.cache_store(doc, fp, tuning.bucket_key(bucket, "search"), plan.to_doc())
    tuning.save_cache(cache, doc)
    jax_res = JaxSearch(JaxConfig(**KW, tune=True, tuning_cache=cache)).run(
        jax_read_filterbank(path))
    search = PeasoupSearch(SearchConfig(**KW, tune=True, tuning_cache=cache), device="cpu")
    res = search.run(read_filterbank(path))
    assert search.dedisp_plan.source == "cache" and search.knobs.subbands == 4
    assert search.knobs.budgets is not None and search.knobs.budgets.max() > 1.0
    want, got = jax_res.candidates, res.candidates
    assert len(got) == len(want) > 10
    for rank, (a, b) in enumerate(zip(want, got)):
        assert (b.dm, b.nh, np.float32(b.freq)) == (a.dm, a.nh, np.float32(a.freq)), rank
        assert abs(b.snr - a.snr) <= 1e-3 * abs(a.snr), rank


@pytest.mark.parametrize("nshards", [2, 3, 8])
def test_shard_devices_now_run(synthetic, port_result, nshards):
    # ROADMAP A.9, ported: shard_devices, refused before, shards the DM
    # trials over that many shards of the CPU. Each shard dedisperses and
    # searches its own 1/n of the trials, so the blocks are shorter and
    # the CPU FFT of a shorter batch may round differently: the
    # identities are the unsharded run's, S/N within 1e-5 relative (as
    # test_small_blocks_give_the_same_candidates holds it)
    path, _, _ = synthetic
    search = PeasoupSearch(SearchConfig(**KW, shard_devices=nshards), device="cpu")
    assert len(search.devices) == nshards
    res = search.run(read_filterbank(path))
    assert [_identity(c) for c in res.candidates] == [
        _identity(c) for c in port_result.candidates
    ]
    for a, b in zip(port_result.candidates, res.candidates):
        assert abs(b.snr - a.snr) <= 1e-5 * a.snr


@pytest.mark.parametrize(
    "overrides",
    [
        dict(subbands=4, subband_smear=0.0),  # ROADMAP A.3, ported
        dict(checkpoint_file="ck.npz"),  # ROADMAP A.4, ported
    ],
)
def test_ported_options_now_run(synthetic, port_result, tmp_path, overrides):
    # options the port refused before they were ported now run, and give
    # the default run's candidates (exact subbands are the direct sum). The
    # default run is made here, beside the option's run, so the two share
    # one process state; port_result, made after the JAX package's search
    # in another test's fixture, gave other S/N bits once under xdist, for
    # a cause not found (ROADMAP §C), so only its identities are compared.
    path, _, _ = synthetic
    if "checkpoint_file" in overrides:
        overrides = dict(checkpoint_file=str(tmp_path / overrides["checkpoint_file"]))
    fil = read_filterbank(path)
    base = PeasoupSearch(SearchConfig(**KW), device="cpu").run(fil)
    res = PeasoupSearch(SearchConfig(**KW, **overrides), device="cpu").run(fil)
    assert [(_identity(c), c.snr) for c in res.candidates] == [
        (_identity(c), c.snr) for c in base.candidates
    ]
    assert [_identity(c) for c in res.candidates] == [
        _identity(c) for c in port_result.candidates
    ]
    if "checkpoint_file" in overrides:
        assert os.path.getsize(overrides["checkpoint_file"]) > 0


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
def acc_runs(acc_fil):
    return _runs(acc_fil, ACC_KW, ACC_KW)


@pytest.fixture(scope="module")
def acc_results(acc_runs):
    return acc_runs("native")


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


@pytest.mark.parametrize("host", HOSTS)
def test_folded_candidates_match_jax(acc_runs, host):
    want, got = acc_runs(host)
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
    want, got = _runs(path, kw, kw)("native")
    _assert_folded_recall(want, got)
    for c in got.candidates[:3]:
        print(f"duty {duty}: P {1.0 / c.freq!r} s, acc {c.acc!r}, nh {c.nh}, "
              f"snr {c.snr!r}, folded_snr {c.folded_snr!r}, opt_period {c.opt_period!r}")
    top = got.candidates[0]
    assert abs(1.0 / top.freq - chip_smoke.BIN_PERIOD) / chip_smoke.BIN_PERIOD < 2e-3
    assert top.acc != 0.0
    assert (top.folded_snr > 15.0) == folds_above_15


# --- the tutorial grid: the JAX package's primary configuration ----------
#
# chip_smoke.py's synthesized tutorial.fil geometry (64 channels x 187,520
# 2-bit samples at 320 us, a 2^17-point FFT, a P = 250 ms pulsar at DM 30)
# with bench.py's accel flags, cut to the three DM trials around the
# pulsar's (27, 30.29, 33.58) x the 44-trial +-5 m/s^2 list, every trial
# dispatched. Here the JAX package routes its spectrum through the fused
# DFT kernel and the port through dftspec's plain version.
TUT_KW = dict(
    dm_start=27.0, dm_end=33.0, acc_start=-5.0, acc_end=5.0,
    acc_pulse_width=0.064, dedupe_accel=False,
)


@pytest.fixture(scope="module")
def tutorial_fil(tmp_path_factory):
    import chip_smoke

    path = tmp_path_factory.mktemp("torch_tutorial") / "tutorial.fil"
    chip_smoke.tutorial_grid_fil(str(path))
    return path


@pytest.fixture(scope="module")
def tutorial_runs(tutorial_fil):
    return _runs(tutorial_fil, TUT_KW, TUT_KW)


@pytest.fixture(scope="module")
def tutorial_results(tutorial_runs):
    return tutorial_runs("native")


@pytest.mark.parametrize("host", HOSTS)
def test_tutorial_grid_matches_jax(tutorial_runs, host):
    want, got = tutorial_runs(host)
    assert got.size == want.size == 1 << 17
    assert len(got.dm_list) == 3 and got.n_accel_trials == 132
    assert len(want.candidates) > 10
    assert len(got.candidates) == len(want.candidates)
    for rank, (a, b) in enumerate(zip(want.candidates, got.candidates)):
        assert _identity(b) == _identity(a), f"rank {rank}: {b} vs {a}"
        assert abs(b.snr - a.snr) <= 1e-3 * abs(a.snr), f"rank {rank}"
    top = got.candidates[0]
    assert abs(1.0 / top.freq - 0.25) / 0.25 < 2e-3


@pytest.mark.parametrize(
    "env,routes",
    [
        ({}, (True, True)),
        ({"PEASOUP_MEGA_HARM": "0"}, (True, False)),
        ({"PEASOUP_FUSED_DFT": "0"}, (False, True)),
        ({"PEASOUP_FUSED_FFT": "0"}, (False, True)),
    ],
)
def test_tutorial_routes_give_identical_candidates(
    tutorial_fil, tutorial_results, monkeypatch, env, routes
):
    # on the CPU both spectrum routes are torch.fft + the plain epilogue and
    # both peaks routes the take-order sums + the plain walk, so every route
    # gives the default run's candidates exactly
    from peasoup_tpu_torch.parallel import sharded_search

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = set()
    real = sharded_search.search_rows

    def spy(*args, fused_dft, mega_harm, **kw):
        seen.add((fused_dft, mega_harm))
        return real(*args, fused_dft=fused_dft, mega_harm=mega_harm, **kw)

    monkeypatch.setattr(sharded_search, "search_rows", spy)
    res = PeasoupSearch(SearchConfig(**TUT_KW), device="cpu").run(
        read_filterbank(tutorial_fil)
    )
    assert seen == {routes}
    _, want = tutorial_results
    assert [(_identity(c), c.snr) for c in res.candidates] == [
        (_identity(c), c.snr) for c in want.candidates
    ]


def _jax_routes(size, af_max, env):
    """The JAX package's route on a TPU whose probes pass: the Pallas
    resample where the span is past the select's 8 and a block exists, the
    packed select otherwise (while the span is at most 64); the fused DFT
    needs the packed planes, the fused interbin step and its geometry gate
    (its pipeline/search.py:855-945 and pipeline/accel_search.py:170,
    419-441)."""
    from peasoup_tpu.ops.fft import _MIN_N
    from peasoup_tpu.ops.pallas.dftspec import dftspec_supported
    from peasoup_tpu.ops.pallas.peaks import PEAKS_BLOCK
    from peasoup_tpu.ops.pallas.resample import choose_block
    from peasoup_tpu.ops.resample import select_span

    smax = select_span(af_max, size)
    pallas_block = 0 if 0 < smax <= 8 else choose_block(af_max, size)
    packed = pallas_block == 0 and smax > 0
    fused_interbin = (
        env.get("PEASOUP_FUSED_FFT", "1") != "0"
        and size >= _MIN_N and not size & (size - 1)
        and (size // 2) % PEAKS_BLOCK == 0
    )
    npad = -(-(size // 2 + 1) // PEAKS_BLOCK) * PEAKS_BLOCK
    fused_dft = (
        packed and fused_interbin and dftspec_supported(size, npad)
        and env.get("PEASOUP_FUSED_DFT", "1") != "0"
    )
    return fused_dft, env.get("PEASOUP_MEGA_HARM", "1") != "0"


@pytest.mark.parametrize(
    "env",
    [{}, {"PEASOUP_FUSED_DFT": "0"}, {"PEASOUP_FUSED_FFT": "0"},
     {"PEASOUP_MEGA_HARM": "0"}],
)
@pytest.mark.parametrize(
    "size,tsamp,acc,fused",
    [
        (1 << 17, 320e-6, 5.0, True),  # the tutorial grid: span 2
        (1 << 21, 64e-6, 0.5, False),  # the big grid: m = 2^20 past the gate
        (1 << 21, 64e-6, 150.0, False),  # the binary grid
        (1 << 17, 320e-6, 0.0, True),  # no acceleration: span 1
        (1 << 17, 320e-6, 3000.0, True),  # span 8, the select's limit
        (1 << 17, 320e-6, 10000.0, False),  # span 24: the Pallas resample
        (1 << 17, 320e-6, 40000.0, False),  # span 93, past the select
    ],
)
def test_routes_match_jax(monkeypatch, size, tsamp, acc, fused, env):
    from peasoup_tpu_torch.ops.resample import accel_factor
    from peasoup_tpu_torch.pipeline.search import choose_routes

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    af_max = float(np.abs(accel_factor(np.array([acc]), tsamp)).max())
    got = choose_routes(size, af_max)
    want = _jax_routes(size, af_max, env)
    assert (got["fused_dft"], got["mega_harm"]) == want
    switched_off = "0" in (env.get("PEASOUP_FUSED_DFT"), env.get("PEASOUP_FUSED_FFT"))
    assert want[0] == (fused and not switched_off)


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
