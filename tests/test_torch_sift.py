"""The port's survey sift (peasoup_tpu_torch.sift and ops.survey_fold)
against the JAX package's, on the CPU, on the JAX tests' cases
(tests/test_sift.py) and the same numpy-seeded inputs.

Tolerances:
- crossmatch, dedup, the multi-beam veto and repeat association are host
  code and exact;
- the re-dedispersed trials are u8 and bitwise the JAX package's;
- survey_fold_batch: the phase-bin map and the resample index are exact,
  the fold's segment sums run in another order than XLA's, so folds agree
  to 1e-5 relative (tests/test_torch_fold.py's fold tolerance);
- the port's SurveyFolder is bitwise the port's own MultiFolder on the
  same candidate, in any batch width and after the out-of-memory halving
  (the invariant the JAX package pins for its own pair);
- end to end, the catalogue's labels, tiers, known sources, harmonics,
  n_obs, members and job ids, the known matches and the repeat sources
  are exact; folded S/N agrees to 1e-3 relative (the dereddening FFTs
  round differently, tests/test_torch_fold.py), and scores to 2e-3
  absolute with the same score tiers (tests/test_torch_rank.py).
"""

import json
import shutil
import sqlite3
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.campaign.db import CandidateDB as JDB
from peasoup_tpu.ops.survey_fold import survey_fold_batch as jax_survey_fold
from peasoup_tpu.sift import crossmatch as jcm
from peasoup_tpu.sift import dedup as jdd
from peasoup_tpu.sift import repeats as jrp
from peasoup_tpu.sift.report import build_report as jax_build_report
from peasoup_tpu.sift.service import SiftConfig as JaxSiftConfig
from peasoup_tpu.sift.service import SiftRun as JaxSiftRun
from peasoup_tpu_torch.campaign.db import CandidateDB
from peasoup_tpu_torch.core.candidates import Candidate
from peasoup_tpu_torch.ops.fold import fold_bins_np
from peasoup_tpu_torch.ops.resample import (
    resample_accel_quadratic, resample_accel_quadratic_rows,
)
from peasoup_tpu_torch.ops.survey_fold import survey_fold_batch
from peasoup_tpu_torch.pipeline.folder import MultiFolder, fold_geometry
from peasoup_tpu_torch.sift import crossmatch as tcm
from peasoup_tpu_torch.sift import dedup as tdd
from peasoup_tpu_torch.sift import fold as tfold
from peasoup_tpu_torch.sift import repeats as trp
from peasoup_tpu_torch.sift.fold import FoldCandidate, FoldObservation, SurveyFolder
from peasoup_tpu_torch.sift.report import build_report, render_html, validate_report
from peasoup_tpu_torch.sift.service import SiftConfig, SiftRun
from test_sift import P0, make_trials, seed_campaign

import chip_smoke

TSAMP = 0.000256
FOLD_RTOL = 1e-5
SNR_RTOL = 1e-3
SCORE_ATOL = 2e-3


# --------------------------------------------------------------------------
# crossmatch, dedup, veto, repeats: host code, exact
# --------------------------------------------------------------------------

def test_catalogue_is_the_jax_packages():
    with open(tcm.DEFAULT_CATALOGUE, "rb") as a, open(jcm.DEFAULT_CATALOGUE, "rb") as b:
        assert a.read() == b.read()
    assert tcm.load_catalogue() == jcm.load_catalogue()
    assert tcm.CATALOGUE_SCHEMA == jcm.CATALOGUE_SCHEMA


def _ratios():
    rng = np.random.default_rng(5)
    ladder = [1.0, 0.5, 1 / 3, 2.0, 1.5, 0.123 / P0, 1.001, 1.01, 0.75, 16.0]
    return ladder + list(rng.uniform(0.05, 20.0, 40))


def test_crossmatch_exact():
    cat = jcm.load_catalogue()
    for r in _ratios():
        for tol in (2e-3, 1e-2):
            assert tcm.harmonic_identify(r * P0, P0, tol=tol) == jcm.harmonic_identify(
                r * P0, P0, tol=tol)
    rng = np.random.default_rng(6)
    for p, dm in [(P0, 26.8), (P0, 200.0), (P0 / 4, 26.0)] + [
        (float(rng.choice([q["period_s"] for q in cat]) * rng.choice([0.5, 1, 2, 1 / 3])
               * (1 + rng.normal(0, 1e-3))), float(rng.uniform(0, 300)))
        for _ in range(60)
    ]:
        assert tcm.match_candidate(p, dm, cat) == jcm.match_candidate(p, dm, cat)


def test_catalogue_validation_like_the_jax_package(tmp_path):
    bad = tmp_path / "cat.json"
    for doc, match in (
        ({"schema": "nope", "pulsars": []}, "known_pulsars"),
        ({"schema": "peasoup_tpu.known_pulsars",
          "pulsars": [{"name": "X", "period_s": -1, "dm": 0}]}, "bad catalogue entry"),
    ):
        bad.write_text(json.dumps(doc))
        for mod in (jcm, tcm):
            with pytest.raises(ValueError, match=match):
                mod.load_catalogue(str(bad))


def _periodicity_rows(n, seed):
    rng = np.random.default_rng(seed)
    base = rng.choice([P0, 0.0314, 0.25, 0.00503], size=n)
    rows = []
    for i in range(n):
        p = float(base[i] * rng.choice([1.0, 0.5, 2.0, 1 / 3, 1.5]) * (1 + rng.normal(0, 5e-4)))
        rows.append({
            "id": i, "job_id": f"job{int(rng.integers(0, 4))}", "period": p,
            "dm": float(rng.choice([10.0, 26.8, 30.0, 80.0]) + rng.normal(0, 0.8)),
            "snr": float(rng.uniform(6, 20)), "beam": int(rng.integers(1, 8)),
            "src_raj": float(rng.choice([0.0, 400.0, 120000.0])),
            "src_dej": float(rng.choice([0.0, 3000.0])),
        })
    return rows


def test_sky_position_helpers_exact():
    for args in ((123000.0, -453000.0), (0.0, 0.0), (235959.9, 895959.9)):
        assert tdd.packed_position_deg(*args) == jdd.packed_position_deg(*args)
    for args in ((5.0, 5.0, 5.0, 5.0), (0, 0, 180, 0), (10, 20, 10, 21)):
        assert tdd.sky_separation_deg(*args) == jdd.sky_separation_deg(*args)


@pytest.mark.parametrize("pos_tol", [0.0, 3.0])
def test_dedup_exact(pos_tol):
    rows = _periodicity_rows(60, seed=7)
    rows += [  # the JAX tests' cases
        {"id": 101, "job_id": "a", "period": P0, "dm": 26.7, "snr": 12.0},
        {"id": 102, "job_id": "b", "period": P0 / 2, "dm": 26.9, "snr": 9.0},
        {"id": 103, "job_id": "c", "period": 0.1234, "dm": 80.0, "snr": 8.0},
    ]
    kw = dict(pos_tol_deg=pos_tol)
    got, want = tdd.dedup_candidates(rows, **kw), jdd.dedup_candidates(rows, **kw)
    assert got == want and len(got) < len(rows)


def test_multibeam_veto_exact():
    rfi = [{"id": i, "period": 0.02, "dm": 15.0, "snr": 9.0, "beam": i + 1}
           for i in range(5)]
    psr = [{"id": 99, "period": P0, "dm": 26.7, "snr": 12.0, "beam": 3}]
    cases = [
        (rfi + psr, {}), (rfi[:2] + psr, {}),
        ([dict(r, beam=None) for r in rfi] + psr, {}),
        (_periodicity_rows(80, seed=8), {"beam_thresh": 3}),
        (_periodicity_rows(80, seed=8), {"beam_thresh": 4, "snr_thresh": 9.0}),
    ]
    for cands, kw in cases:
        assert tdd.multibeam_veto(cands, **kw, device="cpu") == jdd.multibeam_veto(
            cands, **kw)
    assert tdd.multibeam_veto(rfi + psr, device="cpu") == {0, 1, 2, 3, 4}


def test_repeats_exact():
    rng = np.random.default_rng(0)
    for p, turns in ((0.7321, [0, 3, 7, 18, 40]), (0.5, [0, 2, 3, 7])):
        toas = np.asarray(turns, dtype=np.float64) * p + rng.normal(0, 0.002, len(turns))
        assert trp.infer_period(toas) == jrp.infer_period(toas)
    toas = np.asarray([0.0, 1.0, 2.0 + np.pi / 10.0])
    assert trp.infer_period(toas) is None and jrp.infer_period(toas) is None
    rows = []
    for i in range(40):
        rows.append({
            "id": i, "job_id": f"j{i % 3}", "dm": float(rng.choice([40.0, 40.3, 90.0])),
            "snr": float(rng.uniform(6, 12)), "obs_tstart": 55000.0 + (i % 3) * 0.01,
            "time_s": float(0.05 + 0.5 * rng.integers(0, 60)),
            "src_raj": float(rng.choice([0.0, 120000.0])), "src_dej": 0.0,
        })
    for kw in ({}, {"min_pulses": 4}, {"pos_tol_deg": 3.0}, {"dm_tol": 0.1}):
        got, want = trp.repeat_sources(rows, **kw), jrp.repeat_sources(rows, **kw)
        assert got == want
    assert any(s["period_s"] is not None for s in trp.repeat_sources(rows))


# --------------------------------------------------------------------------
# the survey fold
# --------------------------------------------------------------------------

def test_resample_rows_is_the_folders_resample():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(5, 4096)).astype(np.float32))
    afs = torch.from_numpy(rng.uniform(-3e-6, 3e-6, 5).astype(np.float32))
    got = resample_accel_quadratic_rows(x, afs)
    for r in range(5):
        assert torch.equal(got[r], resample_accel_quadratic(x[r], afs[r:r + 1])[0])


def test_survey_fold_batch_matches_jax():
    rng = np.random.default_rng(2)
    b, n, nbins, nints = 6, 4096, 64, 16
    xd = rng.normal(size=(b, n)).astype(np.float32)
    afs = rng.uniform(-2e-6, 2e-6, b).astype(np.float32)
    bins = np.stack([fold_bins_np(n, TSAMP, float(p), nbins, nints)
                     for p in rng.uniform(0.004, 0.05, b)])
    got = survey_fold_batch(torch.from_numpy(xd), torch.from_numpy(afs),
                            torch.from_numpy(bins), nbins=nbins, nints=nints).numpy()
    want = np.asarray(jax_survey_fold(jnp.asarray(xd), jnp.asarray(afs), jnp.asarray(bins),
                                      nbins=nbins, nints=nints))
    assert got.shape == want.shape == (b, nints, nbins)
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL,
                               atol=FOLD_RTOL * np.abs(want).max())


def _cands(ndm, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        p = float(rng.uniform(0.004, 0.05))
        out.append(Candidate(dm=float(i), dm_idx=int(rng.integers(0, ndm)),
                             acc=float(rng.uniform(-20, 20)), snr=9.0, freq=1.0 / p))
    return out


def _survey_obs(job_id, trials, nsamps, cands):
    return FoldObservation(
        job_id=job_id, trials=trials, trials_nsamps=nsamps, tsamp=TSAMP,
        cands=[FoldCandidate(key=i, period=1.0 / c.freq, acc=c.acc, dm_row=c.dm_idx)
               for i, c in enumerate(cands)],
    )


def _multifolder(trials, cands):
    mf = MultiFolder(torch.from_numpy(trials), TSAMP)
    return {o["cand_idx"]: o for o in mf.fold_outcomes(list(cands), len(cands))}


def _assert_same(got: dict, want: dict) -> None:
    assert got["opt_sn"] == want["opt_sn"]
    assert got["opt_period"] == want["opt_period"]
    assert np.array_equal(got["opt_fold"], want["opt_fold"])


@pytest.mark.parametrize("batch", [1, 4, 7])
def test_survey_folder_bitwise_multifolder(batch):
    """Two observations either side of a power-of-two boundary (2048 and
    4096) in one pass, each candidate bitwise its own MultiFolder's, in
    any batch width."""
    obs, want = [], {}
    for j, nsamps in enumerate((4000, 4160)):
        assert fold_geometry(nsamps, TSAMP)[0] == (2048, 4096)[j]
        trials = make_trials(3, nsamps, seed=j)
        cands = _cands(3, seed=10 + j)
        want[f"job{j}"] = _multifolder(trials, cands)
        obs.append(_survey_obs(f"job{j}", trials, nsamps, cands))
    folder = SurveyFolder(batch=batch)
    got = folder.fold_outcomes(obs)
    assert len(got) == 12
    assert [b["size"] for b in folder.buckets] == [2048, 4096]
    for o in got:
        _assert_same(o, want[o["job_id"]][o["key"]])


def test_survey_folder_halves_on_out_of_memory(monkeypatch):
    trials = make_trials(4, 4000, seed=3)
    obs = [_survey_obs("jobA", trials, 4000, _cands(4, seed=4))]
    want = {o["key"]: o for o in SurveyFolder(batch=4).fold_outcomes(obs)}
    calls = []

    def oom_once(*args, **kw):
        calls.append(args[0].shape[0])
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return survey_fold_batch(*args, **kw)

    monkeypatch.setattr(tfold, "survey_fold_batch", oom_once)
    folder = SurveyFolder(batch=4)
    got = folder.fold_outcomes(obs)
    assert calls[:2] == [4, 2] and folder.buckets[0]["batch"] == 2
    assert len(got) == len(want) == 6
    for o in got:
        _assert_same(o, want[o["key"]])


def test_survey_folder_raises_at_batch_one(monkeypatch):
    obs = [_survey_obs("jobA", make_trials(2, 4000, seed=5), 4000, _cands(2, seed=6))]

    def oom(*args, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(tfold, "survey_fold_batch", oom)
    with pytest.raises(torch.OutOfMemoryError):
        SurveyFolder(batch=2).fold_outcomes(obs)


def test_period_gates_match_multifolder():
    trials = make_trials(2, 4000, seed=12)
    cands = [Candidate(dm_idx=0, acc=0.0, snr=9.0, freq=1.0 / 20.0),
             Candidate(dm_idx=0, acc=0.0, snr=9.0, freq=1.0 / 5e-4)]
    assert SurveyFolder(batch=2).fold_outcomes(
        [_survey_obs("jobA", trials, 4000, cands)]) == []


# --------------------------------------------------------------------------
# the sift service end to end
# --------------------------------------------------------------------------

PSR_P = chip_smoke.SIFT_PSR_P


def pulsar_campaign(tmp_path):
    """chip_smoke.py's pulsar campaign (phase 24): two 16,384-sample
    observations of a P = 50 ms pulsar at DM 20."""
    return Path(chip_smoke.sift_pulsar_campaign(str(tmp_path)))


def test_chip_smoke_seed_campaign_is_the_jax_tests(tmp_path):
    """Phase 24's seed campaign, written by the port, is
    tests/test_sift.py:seed_campaign's: the same filterbank bytes and the
    same rows, the input paths aside."""
    for rfi in (False, True):
        (tmp_path / f"j{rfi}").mkdir()
        a = seed_campaign(tmp_path / f"j{rfi}", with_rfi=rfi)
        b = Path(chip_smoke.sift_seed_campaign(str(tmp_path / f"t{rfi}"), with_rfi=rfi))
        fils = sorted(p.name for p in a.glob("*.fil"))
        assert fils == sorted(p.name for p in b.glob("*.fil")) and len(fils) == (6 if rfi else 2)
        for name in fils:
            assert (a / name).read_bytes() == (b / name).read_bytes()
        rows = []
        for camp in (a, b):
            with CandidateDB(str(camp / "candidates.sqlite")) as db:
                rows.append(([dict(o, input=None) for o in db.observations()],
                             db.all_candidates("periodicity") + db.all_candidates("single_pulse")))
        for r in rows[0][1] + rows[1][1]:
            r["obs_input"] = None
        assert rows[0] == rows[1]


def _sifted(camp):
    with JDB(str(camp / "candidates.sqlite")) as db:
        cat = db.sift_catalogue()
        for c in cat:
            c["fold"] = json.loads(c.pop("fold_json") or "null")
        run = dict(db.latest_sift_run())
        run["config"] = json.loads(run["config"])
        return cat, db.sift_known_matches(), db.sift_sp_sources(), run


_EXACT = ("kind", "label", "tier", "dm", "snr", "known_source", "harmonic", "n_obs",
          "members", "job_ids", "score_tier", "model_fp")


def _compare_sifts(got, want) -> int:
    """The catalogues, known matches and repeat sources of two sift runs:
    exact, but for folded S/N, optimised period and scores (tolerances in
    the module docstring). Returns the rows folded."""
    (gcat, gknown, gsp, grun), (wcat, wknown, wsp, wrun) = got, want
    assert len(gcat) == len(wcat)
    for g, w in zip(gcat, wcat):
        assert {k: g[k] for k in _EXACT} == {k: w[k] for k in _EXACT}
        for k in ("folded_snr", "period", "opt_period"):
            if w[k] is None:
                assert g[k] is None, k
            else:
                assert g[k] == pytest.approx(w[k], rel=SNR_RTOL, abs=1e-6), k
        if w["score"] is None:
            assert g["score"] is None
        else:
            assert abs(g["score"] - w["score"]) <= SCORE_ATOL
        assert (g["fold"] is None) == (w["fold"] is None)
        if w["fold"] is not None:
            # the stamps are stored rounded to 3 decimals
            for k in ("prof", "subints", "dm_curve"):
                if k in w["fold"]:
                    a, b = np.asarray(g["fold"][k]), np.asarray(w["fold"][k])
                    np.testing.assert_allclose(
                        a, b, rtol=SNR_RTOL, atol=SNR_RTOL * np.abs(b).max() + 2e-3)
    for k in ("id", "run_id"):
        for m in gknown + wknown:
            m.pop(k)
    assert gknown == wknown
    for s in gsp + wsp:
        s.pop("id"), s.pop("run_id")
    assert gsp == wsp
    for k in ("n_folded", "n_catalogue", "n_known", "n_rfi", "n_sp_sources"):
        assert grun[k] == wrun[k], k
    assert dict(grun["config"], workdir=None) == dict(wrun["config"], workdir=None)
    return sum(1 for c in gcat if c["fold"] is not None)


@pytest.mark.parametrize("case", ["seed", "seed_rfi_nofold", "pulsar"])
def test_sift_run_matches_jax(tmp_path, case):
    """The JAX package's SiftRun and the port's on copies of one
    database: the same sifted product (module docstring)."""
    if case == "pulsar":
        camp = pulsar_campaign(tmp_path)
        kw = dict(fold_batch=4)
    else:
        camp = seed_campaign(tmp_path, with_rfi=case == "seed_rfi_nofold")
        kw = dict(fold_batch=8, sp_min_pulses=4, fold=case == "seed")
    jcamp = tmp_path / "jaxcamp"
    shutil.copytree(camp, jcamp)
    want_sum = JaxSiftRun(JaxSiftConfig(workdir=str(jcamp), **kw)).run()
    run = SiftRun(SiftConfig(workdir=str(camp), **kw), device="cpu")
    got_sum = run.run()
    for k in ("observations", "periodicity", "single_pulse", "watermark_rowid",
              "n_folded", "n_catalogue", "n_known", "n_rfi", "n_sp_sources"):
        assert got_sum[k] == want_sum[k], k
    folded = _compare_sifts(_sifted(camp), _sifted(jcamp))
    assert set(run.timers) == (
        {"sift_crossmatch", "sift_dedup", "sift_scoring", "sift_repeats"}
        | ({"sift_folding"} if kw.get("fold", True) else set()))
    if case == "pulsar":
        cat = _sifted(camp)[0]
        assert folded >= 2
        top = next(c for c in cat if c["n_obs"] == 2)
        assert abs(top["period"] - PSR_P) / PSR_P < 2e-3 and top["folded_snr"] > 10
        assert len(top["fold"]["dm_curve"]) == 5
    if case == "seed_rfi_nofold":
        rfi = [c for c in _sifted(camp)[0] if c["label"] == "rfi"]
        assert len(rfi) == 1 and rfi[0]["members"] == 6


def test_build_fold_inputs_trials_are_the_jax_packages(tmp_path):
    """The re-dedispersed trials fed to the deredden: u8, bit for bit."""
    camp = pulsar_campaign(tmp_path)
    with CandidateDB(str(camp / "candidates.sqlite")) as db:
        obs, cands = db.observations(), db.all_candidates("periodicity")
    got = SiftRun(SiftConfig(workdir=str(camp)), device="cpu").build_fold_inputs(obs, cands)
    want = JaxSiftRun(JaxSiftConfig(workdir=str(camp))).build_fold_inputs(obs, cands)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.trials.dtype == torch.uint8 and w.trials.dtype == np.uint8
        np.testing.assert_array_equal(g.trials.numpy(), w.trials)
        assert (g.job_id, g.trials_nsamps, g.tsamp) == (w.job_id, w.trials_nsamps, w.tsamp)
        assert [vars(c) for c in g.cands] == [vars(c) for c in w.cands]


def test_sift_fold_is_multifolder_bitwise_e2e(tmp_path):
    """The service's batched fold over re-dedispersed database candidates
    is bitwise MultiFolder's on the same trials (tests/test_sift.py's
    invariant, on the port's pair)."""
    camp = pulsar_campaign(tmp_path)
    run = SiftRun(SiftConfig(workdir=str(camp), fold_batch=4), device="cpu")
    with CandidateDB(str(camp / "candidates.sqlite")) as db:
        inputs = run.build_fold_inputs(db.observations(), db.all_candidates("periodicity"))
    for fi in inputs:  # MultiFolder takes 1/freq: compare on that period
        for c in fi.cands:
            c.period = 1.0 / (1.0 / c.period)
    got = {o["key"]: o for o in SurveyFolder(batch=4).fold_outcomes(inputs)}
    n = 0
    for fi in inputs:
        cands = [Candidate(dm_idx=c.dm_row, acc=c.acc, snr=9.0, freq=1.0 / c.period)
                 for c in fi.cands]
        want = MultiFolder(fi.trials, fi.tsamp).fold_outcomes(cands, len(cands))
        for w in want:
            _assert_same(got[fi.cands[w["cand_idx"]].key], w)
            n += 1
    assert n == 5


def test_missing_input_skips_and_missing_db_raises(tmp_path, caplog):
    camp = seed_campaign(tmp_path)
    (camp / "obs1.fil").unlink()
    run = SiftRun(SiftConfig(workdir=str(camp), fold_batch=8, sp_min_pulses=4),
                  device="cpu")
    with caplog.at_level("WARNING", logger="peasoup_tpu_torch.sift.service"):
        summary = run.run()
    assert summary["n_folded"] == 1 and summary["n_known"] == 1
    assert [r.getMessage().split(":")[0] for r in caplog.records] == ["skipping job1"]
    with pytest.raises(FileNotFoundError, match="campaign database"):
        SiftRun(SiftConfig(workdir=str(tmp_path / "none")), device="cpu").run()


def test_tenant_slice(tmp_path):
    camp = seed_campaign(tmp_path)
    conn = sqlite3.connect(str(camp / "candidates.sqlite"))
    conn.execute("UPDATE observations SET tenant = 'alice' WHERE job_id = 'job0'")
    conn.commit()
    conn.close()
    summary = SiftRun(SiftConfig(workdir=str(camp), fold=False, tenant="alice"),
                      device="cpu").run()
    assert summary["observations"] == 1
    with CandidateDB(str(camp / "candidates.sqlite")) as db:
        assert all(json.loads(c["job_ids"]) == ["job0"] for c in db.sift_catalogue())


def test_report_and_clis(tmp_path, capsys):
    """`cli.sift run` and `report`, then `cli.rank score`, on the CPU: the
    report is schema-valid, is the JAX package's report of the same
    database, and rank score rewrites the scores the sift stored."""
    from peasoup_tpu.cli.rank import main as jax_rank_main
    from peasoup_tpu_torch.cli.rank import main as rank_main
    from peasoup_tpu_torch.cli.sift import main as sift_main

    camp = pulsar_campaign(tmp_path)
    assert sift_main(["run", "-w", str(camp), "--fold-batch", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 known" in out and "sift_folding" in out and "fold buckets" in out
    before = _sifted(camp)[0]
    assert sift_main(["report", "-w", str(camp), "--print-summary"]) == 0
    assert "t1=" in capsys.readouterr().out
    doc = json.loads((camp / "sift" / "report.json").read_text())
    validate_report(doc)
    with CandidateDB(str(camp / "candidates.sqlite")) as db:
        mine = build_report(db, None)
    with JDB(str(camp / "candidates.sqlite")) as db:
        theirs = jax_build_report(db, None)
    page = render_html(mine)
    for d in (doc, mine, theirs):
        d.pop("generated_unix")
    assert mine == theirs == doc
    assert '<script type="application/json" id="sift-report">' in page
    assert "http://" not in page and "https://" not in page and "s-tier" in page
    jcamp = tmp_path / "jaxcamp"
    shutil.copytree(camp, jcamp)
    assert rank_main(["score", "-w", str(camp), "--device", "cpu"]) == 0
    assert jax_rank_main(["score", "-w", str(jcamp)]) == 0
    after, theirs = _sifted(camp)[0], _sifted(jcamp)[0]
    # rescored from the stamps as stored (rounded to 3 decimals): the
    # sift's own scores to 1e-4, the same tiers and model
    assert any(c["score"] is not None for c in after)
    for c, b, j in zip(after, before, theirs):
        assert (c["score_tier"], c["model_fp"]) == (b["score_tier"], b["model_fp"]) == (
            j["score_tier"], j["model_fp"])
        if c["score"] is not None:
            assert abs(c["score"] - b["score"]) <= 1e-4
            assert abs(c["score"] - j["score"]) <= SCORE_ATOL
    (camp / "campaign_status.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="A.10"):
        sift_main(["report", "-w", str(camp)])
    with pytest.raises(NotImplementedError, match="A.10"):
        sift_main(["run", "-w", str(camp), "--device", "cpu", "--status-json", "s.json"])
    assert sift_main(["run", "-w", str(camp), "--device", "cpu", "--config",
                      '{"bogus": 1}']) == 2
