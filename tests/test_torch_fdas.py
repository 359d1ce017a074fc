"""The port's Fourier-domain acceleration search
(peasoup_tpu_torch.fdas, ops.fdas, pipeline.fdas and cli.fdas) against the
JAX package's on the CPU, the same numpy inputs from a seed
(tests/test_fdas.py's recipes: 8 channels, a 2^15-point FFT).

Equality classes:
- the template bank and its geometry: bitwise (the port copies the numpy);
- zap_birdies, find_peaks_device(max_peaks) and the cluster walk: bitwise,
  overflow included;
- correlate_bank: torch's FFTs round unlike XLA's, so within 2e-6 of each
  template row's largest output (a few f32 roundings of the transforms);
- a tile's peaks from the JAX package's own whitened spectra: indices and
  counts exact, S/N within 1e-5 relative (the statistics' sums run in
  row_sum's order, not XLA's);
- a search end to end, at the recall standard: freq, DM, z, w and nh
  exact, S/N within 1e-3 relative and the same ranks, over the top
  candidate and those with S/N >= 12, clear of the threshold (9) where
  FFT rounding could flip one.

On the CPU torch's FFTs round with the batch height, so block invariance is
held between runs of equal blocks (ROADMAP §C.2); on the card chip_smoke.py
holds template batches of 5 and 8 against the auto batch.
"""

import os
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_fdas as T
from peasoup_tpu.fdas import templates as JT
from peasoup_tpu.io.sigproc import read_filterbank as jax_read_filterbank
from peasoup_tpu.ops import fdas as JF
from peasoup_tpu.ops.peaks import cluster_peaks_device as jax_cluster
from peasoup_tpu.ops.peaks import find_peaks_device as jax_find_peaks
from peasoup_tpu.ops.rednoise import whiten_fseries as jax_whiten
from peasoup_tpu.ops.zap import zap_birdies as jax_zap
from peasoup_tpu.pipeline.fdas import FdasConfig as JaxConfig
from peasoup_tpu.pipeline.fdas import FdasSearch as JaxSearch
from peasoup_tpu_torch.fdas import templates as PT
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.ops import fdas as PF
from peasoup_tpu_torch.ops.peaks import cluster_peaks_device, find_peaks_device
from peasoup_tpu_torch.ops.zap import zap_birdies
from peasoup_tpu_torch.pipeline.fdas import FdasConfig, FdasSearch

SNR_RTOL = 1e-3  # the recall standard
STRONG = 12.0
BASE = dict(dm_start=50.0, dm_end=70.0, zmax=32.0, zstep=2.0, nharmonics=2, limit=20)
RECIPES = {
    "z0": (dict(accel=0.0), {}),
    "midz": (dict(accel=T._a_for_z(-24.0)), {}),
    "jerk": (dict(z=-12.0, w=-20.0), dict(zmax=16.0, wmax=20.0, wstep=20.0)),
}


@pytest.fixture(scope="module")
def fils(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fdas")
    return {k: T._make_fil(str(d / f"{k}.fil"), **inj) for k, (inj, _) in RECIPES.items()}


@pytest.fixture(scope="module")
def runs(fils):
    """(JAX result, port result) of each recipe, each searched once when a
    test first asks for it."""
    memo = {}

    def get(key):
        if key not in memo:
            kw = dict(BASE, **RECIPES[key][1])
            memo[key] = (
                JaxSearch(JaxConfig(**kw)).run(jax_read_filterbank(fils[key])),
                FdasSearch(FdasConfig(**kw), device="cpu").run(read_filterbank(fils[key])),
            )
        return memo[key]

    return get


def _row(c):
    return (c.freq, c.dm, c.dm_idx, c.z, c.w, c.nh)


def _assert_recall(want, got):
    """The recall standard over the top candidate and every one clear of
    the threshold."""
    w = [want[0]] + [c for c in want[1:] if c.snr >= STRONG]
    g = [got[0]] + [c for c in got[1:] if c.snr >= STRONG]
    assert len(w) == len(g)
    for rank, (a, b) in enumerate(zip(w, g)):
        assert _row(b) == _row(a), rank
        assert (b.acc, b.fdot, b.fddot) == (a.acc, a.fdot, a.fddot), rank
        assert abs(b.snr - a.snr) <= SNR_RTOL * a.snr, rank


# --- templates ---------------------------------------------------------------


@pytest.mark.parametrize("zmax,wmax,zstep,wstep", [
    (16.0, 0.0, 2.0, 20.0), (64.0, 0.0, 2.0, 20.0), (16.0, 20.0, 2.0, 20.0),
    (33.0, 45.0, 3.0, 15.0), (0.0, 0.0, 2.0, 20.0),
])
def test_template_bank_is_bitwise_the_jax_packages(zmax, wmax, zstep, wstep):
    want = JT.build_template_bank(zmax, wmax, zstep, wstep)
    got = PT.build_template_bank(zmax, wmax, zstep, wstep)
    assert (got.half, got.width, got.ntemplates) == (want.half, want.width, want.ntemplates)
    for name in ("zs", "ws", "templates"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
    assert PT.bank_geometry(zmax, wmax, zstep, wstep) == JT.bank_geometry(
        zmax, wmax, zstep, wstep)
    assert PT.effective_zmax(zmax, wmax) == JT.effective_zmax(zmax, wmax)
    assert PT.template_half_width(zmax, wmax) == JT.template_half_width(zmax, wmax)


@pytest.mark.parametrize("width", [1, 33, 97, 257, 300, 1025])
def test_segment_geometry_matches_jax(width):
    assert PT.auto_segment(width) == JT.auto_segment(width)


# --- zap and peaks -----------------------------------------------------------


def test_zap_birdies_bitwise():
    rng = np.random.default_rng(1)
    f = (rng.standard_normal((3, 4097)) + 1j * rng.standard_normal((3, 4097))).astype(
        np.complex64)
    mask = rng.random(4097) < 0.05
    want = np.asarray(jax_zap(jnp.asarray(f), jnp.asarray(mask)))
    got = zap_birdies(torch.from_numpy(f), torch.from_numpy(mask)).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("max_peaks", [1, 8, 64, 5000])
def test_find_peaks_max_peaks_bitwise_with_overflow(max_peaks):
    # rows below, at and past max_peaks crossings, windows that cut them,
    # and a spectrum shorter than max_peaks
    rng = np.random.default_rng(max_peaks)
    spec = rng.normal(0.0, 2.0, size=(6, 4099)).astype(np.float32)
    spec[1, ::7] = 12.0
    spec[2] = -1.0
    lo = np.array([0, 3, 0, 100, 2000, 4000], np.int32)
    hi = np.array([4099, 4099, 4099, 3000, 2100, 4099], np.int32)
    wi, ws, wc = (np.asarray(a) for a in jax_find_peaks(
        jnp.asarray(spec), jnp.float32(3.5), jnp.asarray(lo), jnp.asarray(hi),
        max_peaks=max_peaks))
    gi, gs, gc = find_peaks_device(
        torch.from_numpy(spec), 3.5, torch.from_numpy(lo).long(), torch.from_numpy(hi).long(),
        max_peaks=max_peaks)
    assert gi.shape == (6, max_peaks)
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert gs.numpy().tobytes() == ws.tobytes()
    np.testing.assert_array_equal(gc.numpy(), wc)
    if max_peaks < 5000:
        assert (wc > max_peaks).any()  # an overflow, its count uncapped
    # the cluster walk of the kept crossings
    ci, cs, cc = (np.asarray(a) for a in jax_cluster(jnp.asarray(wi), jnp.asarray(ws),
                                                     jnp.int32(4099)))
    gci, gcs, gcc = cluster_peaks_device(gi, gs, gc, nbins=4099)
    np.testing.assert_array_equal(gci.numpy(), ci)
    assert gcs.numpy().tobytes() == cs.tobytes()
    np.testing.assert_array_equal(gcc.numpy(), cc)


# --- the correlation and a tile's peaks --------------------------------------


@pytest.mark.parametrize("zmax,nbins", [(16.0, 2049), (32.0, 16385)])
def test_correlate_bank_matches_jax(zmax, nbins):
    rng = np.random.default_rng(3)
    fser = (rng.standard_normal((2, nbins)) + 1j * rng.standard_normal((2, nbins))).astype(
        np.complex64)
    bank = JT.build_template_bank(zmax)
    seg = JT.auto_segment(bank.width)
    want = np.stack([np.asarray(JF.correlate_bank(jnp.asarray(f), jnp.asarray(bank.templates),
                                                  segment=seg)) for f in fser])
    got = PF.correlate_bank(torch.from_numpy(fser), torch.from_numpy(bank.templates),
                            segment=seg).numpy()
    assert got.shape == want.shape == (2, bank.ntemplates, nbins)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 2e-6 * scale).all()


def test_correlate_bank_matches_direct_evaluation():
    rng = np.random.default_rng(3)
    nbins, width = 700, 33
    half = (width - 1) // 2
    fser = (rng.standard_normal(nbins) + 1j * rng.standard_normal(nbins)).astype(np.complex64)
    tmpl = (rng.standard_normal((4, width)) + 1j * rng.standard_normal((4, width))).astype(
        np.complex64)
    got = PF.correlate_bank(torch.from_numpy(fser), torch.from_numpy(tmpl), segment=1024)
    fpad = np.pad(fser, (half, half))
    direct = np.stack([[np.sum(fpad[r:r + width] * np.conj(tmpl[t])) for r in range(nbins)]
                       for t in range(4)])
    np.testing.assert_allclose(got.numpy(), direct, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="too short"):
        PF.correlate_bank(torch.from_numpy(fser), torch.from_numpy(tmpl), segment=32)


def test_tile_peaks_from_the_jax_spectra(fils):
    # the JAX package's whitened, zapped spectra of three DM trials of the
    # "midz" input fed to the port's stage: the JAX package's peaks
    from peasoup_tpu.ops.dedisperse import dedisperse, fil_to_device, output_scale
    from peasoup_tpu.pipeline.search import _level_windows
    from peasoup_tpu.plan.dm_plan import DMPlan

    fil = jax_read_filterbank(fils["midz"])
    plan = DMPlan.create(fil.nsamps, fil.nchans, fil.tsamp, fil.fch1, fil.foff, 50.0, 70.0)
    tims = np.asarray(dedisperse(fil_to_device(fil), plan.delay_samples(), plan.killmask,
                                 plan.out_nsamps, scale=output_scale(8, fil.nchans)))
    size = T.FFTN
    bank = JT.build_template_bank(32.0)
    seg = JT.auto_segment(bank.width)
    nbins = size // 2 + 1
    zap = np.zeros(nbins, bool)
    zap[3000:3010] = True
    windows = np.asarray(_level_windows(size, 2, 0.1, 1100.0, fil.tsamp))
    bw = float(np.float32(1.0 / float(np.float32(size) * np.float32(fil.tsamp))))
    geo = dict(size=size, nsamps_valid=min(plan.out_nsamps, size), pos5=int(0.05 / bw),
               pos25=int(0.5 / bw))
    kw = dict(threshold=5.0, segment=seg, nharms=2, max_peaks=4)
    fsers, want = [], []
    for tim in tims:
        x = JF._pad_trial(jnp.asarray(tim), size=size, nsamps_valid=geo["nsamps_valid"])
        fsers.append(np.asarray(jax_zap(jax_whiten(x, pos5=geo["pos5"], pos25=geo["pos25"]),
                                        jnp.asarray(zap))))
        want.append([np.asarray(a) for a in JF.fdas_trial_core(
            jnp.asarray(tim), jnp.asarray(bank.templates), jnp.asarray(zap),
            jnp.asarray(windows), **geo, **kw)])
    got = PF.fdas_spectrum_peaks(torch.from_numpy(np.stack(fsers)),
                                 torch.from_numpy(bank.templates), windows, **kw)
    for d in range(len(tims)):
        wi, ws, wc, wcc = want[d]
        np.testing.assert_array_equal(got.idxs[d].numpy(), wi)
        np.testing.assert_array_equal(got.counts[d].numpy(), wc)
        np.testing.assert_array_equal(got.ccounts[d].numpy(), wcc)
        np.testing.assert_allclose(got.snrs[d].numpy(), ws, rtol=1e-5)
    assert int(got.ccounts.sum()) > 10
    assert (got.counts > 4).any()  # rows overflow the slots


# --- the search --------------------------------------------------------------


@pytest.mark.parametrize("key", list(RECIPES))
def test_search_matches_jax(runs, key):
    want, got = runs(key)
    _assert_recall(want.candidates, got.candidates)
    np.testing.assert_array_equal(got.dm_list, want.dm_list)
    np.testing.assert_array_equal(got.zs, want.zs)
    np.testing.assert_array_equal(got.ws, want.ws)
    assert (got.n_templates, got.n_trials, got.size, got.nsamps) == (
        want.n_templates, want.n_trials, want.size, want.nsamps)


@pytest.mark.parametrize("key,z,w", [("midz", -24.0, 0.0), ("jerk", -12.0, -20.0)])
def test_search_recovers_the_injection(runs, key, z, w):
    _, got = runs(key)
    top = got.candidates[0]
    T._assert_period(top)
    assert (top.z, top.w) == (z, w)
    assert top.snr > 9.5


def test_z0_row_is_the_plain_spectrum(runs, fils):
    # the z = 0 template is an exact delta; the JAX package gets the plain
    # search's S/N bit for bit through XLA's FFTs (tests/test_fdas.py), the
    # port through torch's to 1e-6 relative (an FFT round trip of a delta)
    from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig

    _, got = runs("z0")
    ftop = got.candidates[0]
    assert (ftop.z, ftop.w, ftop.fdot, ftop.acc) == (0.0, 0.0, 0.0, 0.0)
    tres = PeasoupSearch(SearchConfig(
        dm_start=50.0, dm_end=70.0, acc_start=-30.0, acc_end=30.0,
        acc_pulse_width=834.0, nharmonics=2, limit=20,
    ), device="cpu").run(read_filterbank(fils["z0"]))
    ttop = tres.candidates[0]
    assert (ftop.freq, ftop.dm, ftop.nh) == (ttop.freq, ttop.dm, ttop.nh)
    assert abs(ftop.snr - ttop.snr) <= 1e-6 * ttop.snr


def test_equal_blocks_give_the_same_candidates(runs, fils, monkeypatch):
    # one DM trial a tile everywhere: the whole run, the run split into two
    # DM slices finalized together, and a run whose first tile runs out of
    # memory (the ladder halves its template batch) against one that starts
    # at that batch
    from peasoup_tpu_torch.pipeline import fdas as pipe

    fil = read_filterbank(fils["midz"])
    cfg = FdasConfig(**BASE, dm_block=1, template_block=8)

    def fields(cands):
        return [(_row(c), c.snr, c.acc) for c in cands]

    whole = FdasSearch(cfg, device="cpu").run(fil)
    s = FdasSearch(cfg, device="cpu")
    parts = [s.run(fil, dm_slice=sl, finalize=False) for sl in ((0, 1), (1, 3))]
    merged = pipe.PartialFdasResult(
        cands=parts[0].cands + parts[1].cands, dm_offset=0,
        dm_list=np.concatenate([p.dm_list for p in parts]), zs=parts[0].zs,
        ws=parts[0].ws, timers=dict(parts[1].timers), nsamps=parts[0].nsamps,
        size=parts[0].size, n_templates=parts[0].n_templates,
        n_trials=sum(p.n_trials for p in parts), t_total_start=parts[0].t_total_start,
    )
    assert fields(s.finalize(fil, merged).candidates) == fields(whole.candidates)

    real = pipe.fdas_block_core
    calls = {"n": 0}

    def oom_once(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("injected")
        return real(*a, **kw)

    monkeypatch.setattr(pipe, "fdas_block_core", oom_once)
    ladder = FdasSearch(FdasConfig(**BASE, dm_block=1, template_block=16),
                        device="cpu")
    res = ladder.run(fil)
    assert ladder.blocks == (1, 8)
    assert fields(res.candidates) == fields(whole.candidates)


def test_checkpoint_resumes(fils, tmp_path):
    fil = read_filterbank(fils["midz"])
    cfg = FdasConfig(**BASE, dm_block=1, checkpoint_file=str(tmp_path / "f.ckpt"))
    first = FdasSearch(cfg, device="cpu")
    a = first.run(fil)
    assert first.n_searched == 3 and os.path.getsize(tmp_path / "f.ckpt") > 0
    again = FdasSearch(cfg, device="cpu")
    b = again.run(fil)
    assert again.n_searched == 0
    assert [(_row(c), c.snr) for c in b.candidates] == [(_row(c), c.snr) for c in a.candidates]


def test_config_defaults_match_jax():
    assert vars(FdasConfig()) == vars(JaxConfig())


def test_small_recipe_is_the_jax_tests(fils, tmp_path):
    # chip_smoke.py's card-against-CPU input is tests/test_fdas.py's "midz"
    path = tmp_path / "small.fil"
    chip_smoke.fdas_small_fil(str(path))
    assert path.read_bytes() == open(fils["midz"], "rb").read()


# --- the CLI -----------------------------------------------------------------

FLAGS = ["--dm_start", "50", "--dm_end", "70", "--zmax", "32", "-n", "2", "--limit", "20"]


def test_cli_files_match_jax(fils, tmp_path):
    from peasoup_tpu.cli.fdas import main as jax_main
    from peasoup_tpu.core.candidates import CANDIDATE_POD_DTYPE
    from peasoup_tpu_torch.cli.fdas import main

    path = fils["midz"]
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    assert main(["-i", path, "-o", str(port), "--device", "cpu", *FLAGS]) == 0
    assert jax_main(["-i", path, "-o", str(jax_out), *FLAGS]) == 0
    # candidates.fdas: every column but S/N as written
    rows = [[ln.split() for ln in open(d / "candidates.fdas")] for d in (jax_out, port)]
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) > 1
    for a, b in zip(*rows):
        assert a[:-1] == b[:-1]
        if not a[0].startswith("#"):
            assert abs(float(b[-1]) - float(a[-1])) <= SNR_RTOL * float(a[-1])
    # candidates.peasoup: the same records but S/N
    blobs = [(d / "candidates.peasoup").read_bytes() for d in (jax_out, port)]
    assert len(blobs[0]) == len(blobs[1]) > 0
    recs = [np.frombuffer(b[4 : 4 + 24 * (len(b) // 28)], dtype=CANDIDATE_POD_DTYPE)
            for b in blobs]
    for name in ("dm", "dm_idx", "acc", "nh", "freq"):
        np.testing.assert_array_equal(recs[1][name][:1], recs[0][name][:1])
    # overview.xml: the <fdas_search> section, DM trials and candidates
    want, got = (ET.parse(d / "overview.xml").getroot() for d in (jax_out, port))
    sec = [[(e.tag, e.text) for e in r.find("fdas_search/search_parameters")
            if e.tag != "outdir"] for r in (want, got)]
    assert sec[0] == sec[1]
    for tag in ("fdot_trials", "fddot_trials"):
        assert [t.text for t in got.find(f"fdas_search/{tag}")] == [
            t.text for t in want.find(f"fdas_search/{tag}")]
    assert [t.text for t in got.find("dedispersion_trials")] == [
        t.text for t in want.find("dedispersion_trials")]
    wc, gc = want.findall("candidates/candidate"), got.findall("candidates/candidate")
    assert len(wc) == len(gc) > 0
    for a, b in zip(wc, gc):
        for tag in ("period", "dm", "acc", "nh", "fdot", "fddot", "z", "w", "nassoc"):
            assert b.find(tag).text == a.find(tag).text, tag
        assert abs(float(b.find("snr").text) - float(a.find("snr").text)) <= (
            SNR_RTOL * float(a.find("snr").text))
    assert got.find("cuda_device_parameters/platform").text == "cpu"
    assert {"plan", "dedispersion", "search_device", "search_host", "searching",
            "distilling", "scoring", "reading", "writing", "total"} <= {
        e.tag for e in got.find("execution_times")}


@pytest.mark.parametrize("argv,env,item", [
    (["--metrics-json", "m.json"], {}, "A.10"),
    (["--status-json", "s.json"], {}, "A.10"),
])
def test_cli_refuses_unported_flags(monkeypatch, tmp_path, argv, env, item):
    from peasoup_tpu_torch.cli.fdas import main

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=item):
        main(["-i", str(tmp_path / "x.fil"), "--device", "cpu", *argv])


@pytest.mark.parametrize("env", [
    {"JAX_COORDINATOR_ADDRESS": "localhost:1234"},
    {"JAX_COORDINATOR_ADDRESS": "localhost:1234", "JAX_NUM_PROCESSES": "1",
     "JAX_PROCESS_ID": "0"},
])
def test_cli_multiprocess_variables_now_run(fils, monkeypatch, tmp_path, env):
    # ROADMAP A.9, ported: the JAX package's multi-process variables, which
    # the CLI refused before, now select the multi-process driver; naming
    # one process (or a coordinator alone, as the JAX runtime reads it)
    # runs the single-process search, whose candidates the CLI writes
    from peasoup_tpu_torch.cli.fdas import main

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "out"
    assert main(["-i", fils["midz"], "-o", str(out), "--device", "cpu", *FLAGS]) == 0
    got = ET.parse(out / "overview.xml").getroot().findall("candidates/candidate")
    ref = FdasSearch(FdasConfig(**BASE), device="cpu").run(read_filterbank(fils["midz"]))
    assert len(got) == len(ref.candidates) > 0
    for e, c in zip(got, ref.candidates):
        assert float(e.find("dm").text) == pytest.approx(c.dm, rel=1e-6)
        assert float(e.find("period").text) == pytest.approx(1.0 / c.freq, rel=1e-6)
        assert float(e.find("snr").text) == pytest.approx(c.snr, rel=1e-6)
