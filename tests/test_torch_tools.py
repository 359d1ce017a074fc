"""The port's user-facing tools against the JAX package's on the CPU, on
the same inputs: the DM-time bowtie (text equal), the candidate sheet, the
manifest report, diff, timeline and merge (over both packages' manifests
and the port's own shards of a two-process run), as_text and the golden
recall, the divergence oracle (bitwise) and the port's stages against it
(the standard of tests/test_divergence.py: the same S/N > 9 membership on
every harmonic level, |dS/N| < 5e-3), and the tie replay (the same
crowns) with the search's ``PEASOUP_TIE_CAPTURE`` seam (the JAX keys and
dtypes)."""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PEASOUP_FLAGS = ["--dm_end", "40", "--acc_start", "-2", "--acc_end", "2", "-m", "6",
                 "--npdmp", "2"]
SP_FLAGS = ["--dm_end", "60", "-m", "7", "--n_widths", "8"]


def _keep_jax_log():
    """The JAX CLIs install their log handler on the stderr of the moment:
    returns a function that puts the JAX logger back as it was."""
    from peasoup_tpu.obs import log as jax_log

    logger = jax_log.get_logger()
    handler, handlers, level = jax_log._handler, list(logger.handlers), logger.level

    def restore():
        jax_log._handler = handler
        logger.handlers[:] = handlers
        logger.setLevel(level)

    return restore


def _stdout_of(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' `peasoup` on the same input (folds included), the
    port's `spsearch`, and the port's `spsearch` split over two processes
    (gloo on localhost): the outputs and manifests the tools read."""
    import chip_smoke

    from peasoup_tpu.cli.peasoup import main as jax_peasoup
    from peasoup_tpu.cli.spsearch import main as jax_spsearch
    from peasoup_tpu_torch.cli.peasoup import main as peasoup
    from peasoup_tpu_torch.cli.spsearch import main as spsearch

    d = tmp_path_factory.mktemp("tools")
    fake, sp = str(d / "fake.fil"), str(d / "sp.fil")
    chip_smoke.small_fil(fake)
    chip_smoke.sp_small_fil(sp)
    out = {k: str(d / k) for k in ("port", "jax", "sp", "jax_sp", "procs")}
    port = chip_smoke.free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "peasoup_tpu_torch.cli.spsearch", "-i", sp, "-o",
             f"{out['procs']}.rank{r}", *SP_FLAGS, "--device", "cpu"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                     JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r), OMP_NUM_THREADS="2"),
        )
        for r in range(2)
    ]
    restore = _keep_jax_log()
    try:
        with redirect_stdout(io.StringIO()):
            assert peasoup(["-i", fake, "-o", out["port"], *PEASOUP_FLAGS,
                            "--device", "cpu"]) == 0
            assert jax_peasoup(["-i", fake, "-o", out["jax"], *PEASOUP_FLAGS]) == 0
            assert spsearch(["-i", sp, "-o", out["sp"], *SP_FLAGS, "--device", "cpu"]) == 0
            assert jax_spsearch(["-i", sp, "-o", out["jax_sp"], *SP_FLAGS]) == 0
    finally:
        restore()
    for p in procs:
        text = p.communicate(timeout=120)[0]
        assert p.returncode == 0, text
    out["shards"] = [os.path.join(f"{out['procs']}.rank{r}", f"telemetry.proc{r}.json")
                     for r in range(2)]
    out["fake"], out["sp_fil"] = fake, sp
    return out


# --- the bowtie ----------------------------------------------------------

@pytest.mark.parametrize("case", ["widths", "no_widths", "empty", "min_snr", "one_event"])
def test_render_bowtie_svg_is_the_jax_text(case):
    from peasoup_tpu.tools.plotting import render_bowtie_svg as jax_render
    from peasoup_tpu_torch.tools.plotting import render_bowtie_svg

    rng = np.random.default_rng(3)
    n = {"empty": 0, "one_event": 1}.get(case, 40)
    args = (rng.uniform(0, 8, n), rng.uniform(0, 100, n), rng.uniform(5, 30, n))
    kw = {"title": "a <b> & c"}
    if case != "no_widths":
        kw["widths"] = rng.integers(1, 64, n)
    if case == "min_snr":
        kw["min_snr"] = 15.0
    got = render_bowtie_svg(*args, **kw)
    assert got == jax_render(*args, **kw)
    assert got.startswith("<svg") and got.endswith("</svg>")


def test_bowtie_from_singlepulse_is_the_jax_text(runs):
    from peasoup_tpu.tools.parsers import read_singlepulse as jax_read
    from peasoup_tpu.tools.plotting import bowtie_from_singlepulse as jax_bowtie
    from peasoup_tpu_torch.tools.parsers import read_singlepulse
    from peasoup_tpu_torch.tools.plotting import bowtie_from_singlepulse

    path = os.path.join(runs["sp"], "candidates.singlepulse")
    got, want = read_singlepulse(path), jax_read(path)
    assert got.dtype == want.dtype and len(got) > 0
    np.testing.assert_array_equal(got, want)
    assert bowtie_from_singlepulse(path) == jax_bowtie(path)
    assert bowtie_from_singlepulse(path, min_snr=8.0) == jax_bowtie(path, min_snr=8.0)


def test_bowtie_from_db_is_the_jax_text(runs, tmp_path):
    from peasoup_tpu.tools.plotting import bowtie_from_db as jax_bowtie
    from peasoup_tpu_torch.campaign.db import DB_FILENAME, CandidateDB
    from peasoup_tpu_torch.tools.plotting import bowtie_from_db, bowtie_main

    db_path = str(tmp_path / DB_FILENAME)
    with CandidateDB(db_path) as db:
        db.ingest_job("sp-a", runs["sp"], runs["sp_fil"], tenant="alpha")
        db.ingest_job("sp-b", runs["jax_sp"], runs["sp_fil"])
    for kw in ({}, {"job_id": "sp-a"}, {"tenant": "alpha"}, {"min_snr": 9.0},
               {"job_id": "none"}):
        got = bowtie_from_db(db_path, **kw)
        assert got == jax_bowtie(db_path, **kw), kw
    out = str(tmp_path / "b.svg")
    with redirect_stdout(io.StringIO()):
        assert bowtie_main([db_path, "-o", out, "--job", "sp-a"]) == 0
    with open(out) as f:
        assert f.read() == jax_bowtie(db_path, job_id="sp-a")


# --- the candidate sheet and the parsers -----------------------------------

def test_candidate_file_parser_reads_the_jax_records(runs):
    from peasoup_tpu.tools.parsers import CandidateFileParser as JaxParser
    from peasoup_tpu_torch.tools.parsers import CandidateFileParser, OverviewFile

    ov = OverviewFile(os.path.join(runs["port"], "overview.xml"))
    path = os.path.join(runs["port"], "candidates.peasoup")
    assert len(ov.candidates) > 0
    folds = 0
    with CandidateFileParser(path) as ours, JaxParser(path) as theirs:
        for off in ov.candidates["byte_offset"]:
            a, b = ours.read_candidate(int(off)), theirs.read_candidate(int(off))
            assert (a["nbins"], a["nints"]) == (b["nbins"], b["nints"])
            np.testing.assert_array_equal(a["hits"], b["hits"])
            if b["fold"] is None:
                assert a["fold"] is None
            else:
                folds += 1
                np.testing.assert_array_equal(a["fold"], b["fold"])
    assert folds == 2


def test_candidate_sheet_renders(runs, tmp_path):
    pytest.importorskip("matplotlib")
    from peasoup_tpu_torch.tools.plotting import main

    out = str(tmp_path / "cand.png")
    with redirect_stdout(io.StringIO()):
        assert main([os.path.join(runs["port"], "overview.xml"),
                     os.path.join(runs["port"], "candidates.peasoup"), "0",
                     "-o", out]) == 0
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_candidate_sheet_names_matplotlib_where_it_is_missing(runs, monkeypatch):
    from peasoup_tpu_torch.tools.parsers import CandidateFileParser, OverviewFile
    from peasoup_tpu_torch.tools.plotting import CandidatePlotter

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ov = OverviewFile(os.path.join(runs["port"], "overview.xml"))
    with CandidateFileParser(os.path.join(runs["port"], "candidates.peasoup")) as cp:
        with pytest.raises(ImportError, match="matplotlib"):
            CandidatePlotter(ov, cp).plot(0, "unused.png")


# --- the manifest report -----------------------------------------------------

def _manifests(runs) -> dict:
    from peasoup_tpu_torch.obs.telemetry import load_manifest

    return {
        "port": load_manifest(os.path.join(runs["port"], "telemetry.json")),
        "jax": load_manifest(os.path.join(runs["jax"], "telemetry.json")),
        "sp": load_manifest(os.path.join(runs["sp"], "telemetry.json")),
        **{f"shard{r}": load_manifest(p) for r, p in enumerate(runs["shards"])},
    }


def _as_jax_reads(text: str, man: dict) -> str:
    """The JAX renderer names the platform ``jax <version>`` and reads no
    torch version from a port manifest; the port's names the framework the
    manifest records. Every other line is the same."""
    plat = man.get("platform") or {}
    if "torch" in plat and "jax" not in plat:
        return text.replace(f"platform: torch {plat['torch']} ", "platform: jax ? ")
    return text


@pytest.mark.parametrize("name", ["port", "jax", "sp", "shard0", "shard1"])
def test_render_and_timeline_are_the_jax_text(runs, name):
    from peasoup_tpu.tools.report import render as jax_render
    from peasoup_tpu.tools.report import render_timeline as jax_timeline
    from peasoup_tpu_torch.tools.report import render, render_timeline

    man = _manifests(runs)[name]
    for kw in ({}, {"max_events": 2}):
        got = render(man, **kw)
        assert _as_jax_reads(got, man) == jax_render(man, **kw)
    assert render_timeline(man) == jax_timeline(man)
    assert render_timeline(man, width=20) == jax_timeline(man, width=20)
    if name != "jax":
        assert f"platform: torch {torch.__version__} " in render(man)


@pytest.mark.parametrize("pair", [("port", "jax"), ("jax", "port"), ("shard0", "shard1")])
def test_diff_is_the_jax_text(runs, pair):
    from peasoup_tpu.tools.report import diff as jax_diff
    from peasoup_tpu_torch.tools.report import diff

    mans = _manifests(runs)
    a, b = mans[pair[0]], mans[pair[1]]
    assert diff(a, b) == jax_diff(a, b)


def test_merge_of_the_ports_shards_is_the_jax_merge(runs, tmp_path):
    from peasoup_tpu.tools.report import main as jax_main
    from peasoup_tpu.tools.report import merge_manifests as jax_merge
    from peasoup_tpu_torch.obs.schema import validate_manifest
    from peasoup_tpu_torch.tools.report import main, merge_manifests

    mans = _manifests(runs)
    shards = [mans["shard0"], mans["shard1"]]
    assert [m["process_index"] for m in shards] == [0, 1]
    merged = merge_manifests(shards)
    assert merged == jax_merge(shards)
    assert merged == merge_manifests(shards[::-1])
    assert merged["merged"] and merged["n_hosts"] == 2
    validate_manifest(merged)
    outs = {}
    for label, fn in (("port", main), ("jax", jax_main)):
        path = str(tmp_path / f"{label}.json")
        rc, text = _stdout_of(fn, ["--merge", *runs["shards"], "-o", path])
        assert rc == 0
        with open(path) as f:
            outs[label] = (text, json.load(f))
    assert outs["port"][1] == outs["jax"][1]
    assert outs["port"][0] == _as_jax_reads(outs["port"][0], merged) == outs["jax"][0]


def test_report_cli_modes(runs):
    from peasoup_tpu.tools.report import main as jax_main
    from peasoup_tpu_torch.tools.report import main

    one = os.path.join(runs["jax"], "telemetry.json")
    two = os.path.join(runs["port"], "telemetry.json")
    for argv in ([one], [one, two], ["--timeline", one], ["--events", "1", one]):
        assert _stdout_of(main, argv) == _stdout_of(jax_main, argv), argv


# --- as_text and recall ---------------------------------------------------------

@pytest.mark.parametrize("which", ["port", "jax"])
def test_as_text_is_the_jax_text(runs, which):
    from peasoup_tpu.tools.as_text import main as jax_main
    from peasoup_tpu_torch.tools.as_text import main

    path = os.path.join(runs[which], "overview.xml")
    got = _stdout_of(main, [path])
    assert got == _stdout_of(jax_main, [path])
    assert got[0] == 0 and len(got[1].splitlines()) > 2


@pytest.mark.parametrize("ours,golden,kw", [
    ("port", "jax", {}),
    ("jax", "port", {}),
    ("port", "port", {"freq_tol": 1e-6, "dm_tol": 1e-6}),
    ("port", "jax", {"freq_tol": 1e-8, "snr_rtol": 1e-9}),
])
def test_match_golden_reports_are_the_jax_reports(runs, ours, golden, kw):
    from peasoup_tpu.tools.recall import match_golden as jax_match
    from peasoup_tpu_torch.tools.parsers import OverviewFile
    from peasoup_tpu_torch.tools.recall import RecallReport, match_golden

    a = os.path.join(runs[ours], "overview.xml")
    b = os.path.join(runs[golden], "overview.xml")
    got, want = match_golden(a, b, **kw), jax_match(a, b, **kw)
    assert isinstance(got, RecallReport)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    # an OverviewFile and a record array are read as the path is
    ov = OverviewFile(a)
    for src in (ov, ov.candidates):
        assert dataclasses.asdict(match_golden(src, b, **kw)) == dataclasses.asdict(got)
    if ours == golden:
        assert got.recall == 1.0


# --- the divergence oracle and the port's stages ---------------------------------

def test_oracle_functions_are_the_jax_functions():
    from peasoup_tpu.tools import divergence as jd
    from peasoup_tpu_torch.tools import divergence as td

    rng = np.random.default_rng(11)
    table = td.oracle_delay_table(1510.0, -0.39, 64, 0.00032)
    np.testing.assert_array_equal(table, jd.oracle_delay_table(1510.0, -0.39, 64, 0.00032))
    dms = np.array([0.0, 19.76, 239.37])
    np.testing.assert_array_equal(td.oracle_delay_samples(dms, table),
                                  jd.oracle_delay_samples(dms, table))
    assert td.oracle_max_delay(250.0, table) == jd.oracle_max_delay(250.0, table)
    data = rng.integers(0, 4, size=(4096, 64)).astype(np.uint8)
    delays = td.oracle_delay_samples(dms, table)[1]
    kill = rng.random(64) > 0.1
    for km in (None, kill):
        np.testing.assert_array_equal(td.oracle_dedisperse(data, delays, 3000, km),
                                      jd.oracle_dedisperse(data, delays, 3000, km))
    x = rng.normal(size=4096)
    amp = np.abs(np.fft.rfft(x))
    for n in (1, 2, 3, 4, 7, 130):
        np.testing.assert_array_equal(td.oracle_median_scrunch5(amp[:n]),
                                      jd.oracle_median_scrunch5(amp[:n]))
    np.testing.assert_array_equal(td.oracle_linear_stretch(amp[:50], 333),
                                  jd.oracle_linear_stretch(amp[:50], 333))
    np.testing.assert_array_equal(td.oracle_running_median(amp, 20, 200),
                                  jd.oracle_running_median(amp, 20, 200))
    np.testing.assert_array_equal(td.oracle_whiten(x, 20, 200), jd.oracle_whiten(x, 20, 200))
    f = np.fft.rfft(x)
    np.testing.assert_array_equal(td.oracle_interbin(f), jd.oracle_interbin(f))
    assert td.oracle_stats(amp) == jd.oracle_stats(amp)
    np.testing.assert_array_equal(td.oracle_resample(x, 5.0, 6.4e-5),
                                  jd.oracle_resample(x, 5.0, 6.4e-5))
    for a, b in zip(td.oracle_harm_levels(amp), jd.oracle_harm_levels(amp)):
        np.testing.assert_array_equal(a, b)
    assert td.oracle_cluster_max(amp, 100) == jd.oracle_cluster_max(amp, 100)
    ot = td.oracle_search_trial(x, 4096, 6.4e-5, [-5.0, 0.0], 20, 200)
    oj = jd.oracle_search_trial(x, 4096, 6.4e-5, [-5.0, 0.0], 20, 200)
    for a in (-5.0, 0.0):
        for lt, lj in zip(ot["acc"][a]["levels"], oj["acc"][a]["levels"]):
            np.testing.assert_array_equal(lt, lj)
    assert (ot["mean"], ot["std"]) == (oj["mean"], oj["std"])


@pytest.fixture(scope="module")
def tut_fil(tmp_path_factory):
    import chip_smoke

    path = str(tmp_path_factory.mktemp("tut") / "tut.fil")
    chip_smoke.tutorial_grid_fil(path)
    return path


def test_compare_trial_meets_the_oracle_standard(tut_fil, capsys):
    """The tutorial grid's pulsar trial (DM 30) at -5, 0 and 5 m/s^2:
    every harmonic level has the oracle's S/N > 9 membership and |dS/N| <
    5e-3; the stage rows are finite and the CLI prints them."""
    from peasoup_tpu_torch.tools.divergence import (
        STANDARD_ABS, compare_trial, level_standard, main,
    )

    accs = [-5.0, 0.0, 5.0]
    rows, oracle, meta = compare_trial(tut_fil, 30.0, accs, device="cpu")
    assert meta["size"] == 1 << 17
    assert len(rows) == 6 + 6 * len(accs)
    assert all(np.isfinite(err) for _, err in rows)
    std = level_standard(oracle, meta)
    assert len(std) == 5 * len(accs)
    for name, dsnr, same in std:
        assert same and dsnr < STANDARD_ABS, (name, dsnr)
    # the pulsar is there: the oracle's level 4 crosses the threshold
    assert (oracle["acc"][0.0]["levels"][4] > 9.0).any()
    assert main(["--fil", tut_fil, "--dm", "30", "--acc", "0", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resample[0.0]" in out and "DIFFERS" not in out and "outside" not in out


def test_compare_trial_refuses_a_missing_card(tut_fil):
    from peasoup_tpu_torch.tools.divergence import compare_trial

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        compare_trial(tut_fil, 30.0, [0.0])


# --- the tie replay and its capture seam -------------------------------------------

def _capture(snrs, freqs, dm_of_seg, seg_counts, accs):
    """tests/test_tie_mc.py's minimal capture: one accel trial per DM,
    every row at harmonic level 0 and accel index 0."""
    n = len(snrs)
    return {
        "freqs": np.asarray(freqs, np.float64),
        "snr": np.asarray(snrs, np.float64),
        "lvl": np.zeros(n, np.int32),
        "a": np.zeros(n, np.int32),
        "seg_counts": np.asarray(seg_counts, np.int64),
        "dm_of_seg": np.asarray(dm_of_seg, np.int64),
        "acc_tab": np.asarray(accs, np.float64).reshape(-1, 1),
        "dm_list": np.linspace(0.0, 10.0, len(accs)),
        "harm_tol": np.float64(1e-4),
        "harm_max": np.int64(16),
        "harm_frac": np.bool_(False),
        "acc_tobs_over_c": np.float64(1e-7),
        "acc_tol": np.float64(1e-4),
        "freq_tol": np.float64(1e-4),
        "max_harm": np.int64(16),
    }


CAPTURES = {
    "absorb": (_capture([12.0, 20.0, 9.5], [100.0, 100.0, 37.0], [0, 1], [2, 1],
                        [1.0, -2.0]), [100.0, 37.0]),
    "across_dm": (_capture([12.0, 20.0], [100.0, 100.0], [0, 1], [1, 1], [1.0, -2.0]),
                  [100.0]),
    "ties": (_capture([15.0, 15.0, 15.0, 8.0], [50.0, 50.0, 100.0, 25.0], [0, 1],
                      [2, 2], [3.0, -1.0]), [50.0, 100.0, 25.0]),
}


def _crowns(mod, cap, snr, golden):
    return mod.crowns_for_golden(mod.replay(cap, snr), np.asarray(golden))


@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_replay_crowns_the_jax_members(name):
    from peasoup_tpu.tools import tie_mc as jax_tie
    from peasoup_tpu_torch.tools import tie_mc

    cap, golden = CAPTURES[name]
    rng = np.random.default_rng(5)
    for snr in (cap["snr"], cap["snr"] + rng.uniform(-1, 1, cap["snr"].shape)):
        assert _crowns(tie_mc, cap, snr, golden) == _crowns(jax_tie, cap, snr, golden)
    got = tie_mc.mc_crown_stability(cap, np.asarray(golden), n_draws=8, delta=0.5)
    assert got == jax_tie.mc_crown_stability(cap, np.asarray(golden), n_draws=8,
                                             delta=0.5)


def test_search_writes_the_jax_capture(runs, tmp_path, monkeypatch):
    """A port search under PEASOUP_TIE_CAPTURE writes the JAX package's
    keys, dtypes and rows; both packages' replays of it give the search's
    own candidates."""
    from peasoup_tpu.io import read_filterbank as jax_read
    from peasoup_tpu.pipeline.search import PeasoupSearch as JaxSearch
    from peasoup_tpu.pipeline.search import SearchConfig as JaxConfig
    from peasoup_tpu.tools import tie_mc as jax_tie
    from peasoup_tpu_torch.io.sigproc import read_filterbank
    from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
    from peasoup_tpu_torch.tools import tie_mc

    kw = dict(dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0)
    caps = {}
    for label, run in (
        ("port", lambda: PeasoupSearch(SearchConfig(**kw), device="cpu")
         .run(read_filterbank(runs["fake"]))),
        ("jax", lambda: JaxSearch(JaxConfig(**kw)).run(jax_read(runs["fake"]))),
    ):
        path = str(tmp_path / f"{label}.npz")
        monkeypatch.setenv("PEASOUP_TIE_CAPTURE", path)
        result = run()
        caps[label] = tie_mc.load_capture(path)
        if label == "port":
            port_cands = result.candidates
    got, want = caps["port"], caps["jax"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
    for k in ("seg_counts", "dm_of_seg", "acc_tab", "dm_list", "harm_tol", "harm_max",
              "harm_frac", "acc_tol", "freq_tol", "max_harm"):
        np.testing.assert_array_equal(got[k], want[k])
    # the same rows, each segment's in its own order
    for k in ("freqs", "lvl", "a"):
        assert sorted(got[k].tolist()) == sorted(want[k].tolist()), k
    freqs = np.asarray([c.freq for c in port_cands[:5]])
    for mod in (tie_mc, jax_tie):
        cands = mod.replay(got, got["snr"])
        assert sorted((c.freq, c.snr, c.acc, c.nh) for c in cands) == sorted(
            (c.freq, c.snr, c.acc, c.nh) for c in port_cands)
    assert _crowns(tie_mc, got, got["snr"], freqs) == _crowns(jax_tie, got, got["snr"],
                                                               freqs)
