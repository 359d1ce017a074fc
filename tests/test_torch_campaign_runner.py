"""The port's campaign runner (peasoup_tpu_torch.campaign.runner) against the
JAX package's, end to end on the CPU: one campaign of a ``search``, a
``spsearch``, an ``ffa`` and a ``fdas`` job (the JAX tests' small
filterbanks, made from seeds) run by each package's ``CampaignRunner``.

Recall standard (tests/test_torch_search.py): the same candidate count and,
rank by rank, the same identities (DM, acceleration, harmonics and
frequency; a single pulse's DM trial, sample, width and footprint; an FFA
row's period, DM and width; an FDAS row's z and w) and S/N within a
relative 1e-3; the database rows alike. Each package reads the other's
campaign directory. Then: a gang job of two worker processes (one torch
thread each, ROADMAP §C.3) gives the single-process job's bytes; one
``PEASOUP_FAULTS`` spec over the campaign's seams (queue.claim,
clock.skew, worker.kill, preempt.revoke) fires alike in both packages;
the port's CLI has every subcommand and flag of the JAX one plus
``--device``; the sift report folds in the rollup as the JAX report
does; and a campaign asked for the card where there is none raises.
"""

import json
import os
import sqlite3
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest
import torch

import chip_smoke
from peasoup_tpu.campaign import queue as jqueue
from peasoup_tpu.campaign import runner as jrunner
from peasoup_tpu.resilience import faults as jfaults
from peasoup_tpu_torch.campaign import queue as tqueue
from peasoup_tpu_torch.campaign import runner as trunner
from peasoup_tpu_torch.resilience import faults as tfaults
from test_pipeline import make_synthetic_fil
from test_torch_campaign_queue import make_obs, make_periodic_obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-3
CONFIGS = {
    "search": dict(dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0),
    "spsearch": dict(dm_end=20.0, min_snr=7.0, n_widths=6),
    "ffa": dict(dm_end=5.0, p_start=1.0, p_end=6.0, min_dc=0.01, min_snr=8.0),
    "fdas": dict(chip_smoke.FDAS_SMALL_CONFIG),
}


@pytest.fixture(autouse=True)
def clean_faults():
    for f in (jfaults, tfaults):
        f.configure(None)
    yield
    for f in (jfaults, tfaults):
        f.configure(None)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("camp_inputs")
    fdas = str(d / "fdas.fil")
    chip_smoke.fdas_small_fil(fdas)
    return {
        "search": str(make_synthetic_fil(d)[0]),
        "spsearch": make_obs(str(d / "sp.fil"), seed=3),
        "ffa": make_periodic_obs(str(d / "ffa.fil")),
        "fdas": fdas,
    }


def _entries(inputs):
    return [{"input": inputs[p], "pipeline": p, "config": CONFIGS[p]} for p in CONFIGS]


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory, inputs):
    """{package: campaign root}, each drained by its own runner, one torch
    thread (both packages' CPU FFTs round with the batch height when
    threaded, ROADMAP §C.3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    roots = {}
    try:
        for name, rmod, qmod in (("jax", jrunner, jqueue), ("port", trunner, tqueue)):
            root = str(tmp_path_factory.mktemp(f"camp_{name}"))
            rmod.save_campaign_config(root, rmod.CampaignConfig(
                pipeline="search", warmup=False, backoff_base_s=0.05))
            rmod.enqueue_entries(qmod.JobQueue(root), _entries(inputs), "search")
            kw = {"device": "cpu"} if name == "port" else {}
            tally = rmod.CampaignRunner(root, worker_id="w1", **kw).run(poll_s=0.05)
            assert tally["done"] == 4, (name, tally)
            roots[name] = root
    finally:
        torch.set_num_threads(threads)
    return roots


def _job_dir(root, pipeline, inputs):
    return os.path.join(root, "jobs", jqueue.job_id_for(inputs[pipeline]))


def _xml_rows(path):
    root = ET.parse(path).getroot()
    return [{f.tag: f.text for f in e} for e in root.findall("candidates/candidate")]


def _table(path):
    with open(path) as f:
        return [ln.split() for ln in f if not ln.startswith("#")]


def _close(a, b):
    return abs(float(a) - float(b)) <= RTOL * abs(float(b))


def _same_rows(rows_j, rows_t, snr_keys):
    assert len(rows_j) == len(rows_t) > 0
    for rj, rt in zip(rows_j, rows_t):
        assert set(rj) == set(rt)
        for k in rj:
            if k in snr_keys:
                assert _close(rt[k], rj[k]), (k, rj, rt)
            else:
                assert rt[k] == rj[k], (k, rj, rt)


@pytest.mark.parametrize("pipeline", list(CONFIGS))
def test_same_candidates_per_job(campaigns, inputs, pipeline):
    jdir, tdir = (_job_dir(campaigns[k], pipeline, inputs) for k in ("jax", "port"))
    if pipeline in ("search", "fdas", "ffa"):
        # overview.xml: identities exact, S/N (and the fold's) within 1e-3
        _same_rows(_xml_rows(os.path.join(jdir, "overview.xml")),
                   _xml_rows(os.path.join(tdir, "overview.xml")),
                   {"snr", "folded_snr", "ddm_snr_ratio", "byte_offset"})
    text = {"spsearch": ("candidates.singlepulse", 1), "ffa": ("candidates.ffa", 2),
            "fdas": ("candidates.fdas", 8)}.get(pipeline)
    if text:
        name, snr_col = text
        rows_j, rows_t = (_table(os.path.join(d, name)) for d in (jdir, tdir))
        assert len(rows_j) == len(rows_t) > 0
        for rj, rt in zip(rows_j, rows_t):
            assert rj[:snr_col] + rj[snr_col + 1:] == rt[:snr_col] + rt[snr_col + 1:]
            assert _close(rt[snr_col], rj[snr_col])


def _db_rows(root):
    con = sqlite3.connect(os.path.join(root, "candidates.sqlite"))
    con.row_factory = sqlite3.Row
    try:
        return [dict(r) for r in con.execute("SELECT * FROM candidates ORDER BY id")]
    finally:
        con.close()


def test_same_database_rows(campaigns):
    rows = [_db_rows(campaigns[k]) for k in ("jax", "port")]
    assert len(rows[0]) == len(rows[1]) > 0
    kinds = set()
    for rj, rt in zip(*rows):
        kinds.add(rt["kind"])
        for k in rj:
            if k in ("snr", "folded_snr"):
                assert (rj[k] is None and rt[k] is None) or _close(rt[k], rj[k]), (k, rj, rt)
            else:
                assert rt[k] == rj[k], (k, rj, rt)
    assert kinds == {"periodicity", "single_pulse"}


def test_done_records_and_rollup_read_across(campaigns):
    from peasoup_tpu.campaign.rollup import build_status as jax_status
    from peasoup_tpu_torch.campaign.rollup import build_status
    from test_torch_survey_health import _strip_clocks

    for root in campaigns.values():
        docs = [f(root) for f in (jax_status, build_status)]
        assert _strip_clocks(docs[0]) == _strip_clocks(docs[1])
        assert docs[1]["queue"]["done"] == 4 and docs[1]["queue"]["quarantined"] == 0
    done = {d["pipeline"]: d for d in tqueue.JobQueue(campaigns["port"]).done_records()}
    assert set(done) == set(CONFIGS)
    # no kernel library is built on the CPU; no launch either
    assert all(d["jit_programs_compiled"] == 0 for d in done.values())
    assert not any("kernel_launches" in d for d in done.values())


def test_kernel_libraries_built_is_the_compile_count():
    from peasoup_tpu_torch.obs.telemetry import RunTelemetry

    tel = RunTelemetry()
    assert trunner.jit_programs_compiled(tel) == 0
    tel.incr("kernels.library_builds", 3)
    assert trunner.jit_programs_compiled(tel) == 3


def _campaign_cli(args, cwd=ROOT):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "peasoup_tpu_torch.cli.campaign", *args, "--device", "cpu"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_gang_of_two_processes_is_the_single_process_bytes(tmp_path, inputs):
    man = tmp_path / "obs.txt"
    man.write_text(json.dumps({"input": inputs["search"], "config": CONFIGS["search"]}) + "\n")
    gang, single = str(tmp_path / "gang"), str(tmp_path / "single")
    procs = [_campaign_cli(["run", "-w", gang, "--manifest", str(man), "--pipeline", "search",
                            "--nprocs", "2", "--group", "pod", "--worker-id", f"g{i}",
                            "--no-warmup", "--poll", "0.1"]) for i in range(2)]
    procs.append(_campaign_cli(["run", "-w", single, "--manifest", str(man), "--pipeline",
                                "search", "--no-warmup", "--poll", "0.1"]))
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode == 0, out[-3000:]
    [rec] = tqueue.JobQueue(gang).done_records()
    assert rec["gang"]["nprocs"] == 2 and rec["gang"]["members"] == ["g0", "g1"]
    jid = rec["job_id"]
    got, ref = (open(os.path.join(r, "jobs", jid, "candidates.peasoup"), "rb").read()
                for r in (gang, single))
    assert got == ref and len(got) > 0
    # the member wrote its telemetry shard; the exchange was consumed
    assert os.path.exists(os.path.join(gang, "jobs", jid, "telemetry.proc1.json"))
    assert not [n for n in os.listdir(os.path.join(gang, "jobs", jid))
                if n.startswith("gang-")]


# ------------------------------------------------------------------------
# the campaign's fault seams, in both packages
# ------------------------------------------------------------------------

PACKAGES = {"jax": (jqueue, jrunner, jfaults), "port": (tqueue, trunner, tfaults)}


def _claim_seam(tmp_path, pkg):
    qmod, _, fmod = PACKAGES[pkg]
    fmod.configure("queue.claim:n=2,seed=4")
    q = qmod.JobQueue(str(tmp_path / pkg), lease_s=30.0)
    for i in range(3):
        q.add_job(qmod.Job(job_id=f"j{i}", input=f"/x{i}.fil"))
    claimed = []
    while True:
        c = q.claim_next("w")
        if c is None:
            break
        claimed.append(c.job.job_id)
        q.complete(c)
    return claimed, fmod.active_plan().to_doc()


def _skew_seam(tmp_path, pkg):
    qmod, _, fmod = PACKAGES[pkg]
    q = qmod.JobQueue(str(tmp_path / pkg), lease_s=30.0)
    q.add_job(qmod.Job(job_id="j0", input="/x0.fil"))
    assert q.claim_next("w") is not None
    fmod.configure("clock.skew:skew=120:n=1")
    reaped = q.reap_stale()
    return reaped, q.get_job("j0").attempts, q.state("j0")


def _kill_seam(tmp_path, pkg):
    qmod, rmod, fmod = PACKAGES[pkg]
    root = str(tmp_path / pkg)
    rmod.save_campaign_config(root, rmod.CampaignConfig(warmup=False, lease_s=5.0))
    q = qmod.JobQueue(root, lease_s=5.0)
    q.add_job(qmod.Job(job_id="j0", input="/nonexistent/x.fil"))
    fmod.configure("worker.kill:at=j0")
    kw = {"device": "cpu"} if pkg == "port" else {}
    try:
        rmod.run_worker(root, worker_id="victim", poll_s=0.05, **kw)
        raised = None
    except BaseException as exc:  # WorkerKilled, like a SIGKILL
        raised = type(exc).__name__
    registry = sorted(os.listdir(os.path.join(root, "queue", "workers")))
    return raised, q.state("j0"), [n for n in registry if n.endswith(".json")]


def _revoke_seam(tmp_path, pkg):
    qmod, rmod, fmod = PACKAGES[pkg]
    from peasoup_tpu.resilience import RevokeToken as JToken
    from peasoup_tpu_torch.resilience import RevokeToken as TToken

    q = qmod.JobQueue(str(tmp_path / pkg), lease_s=30.0)
    q.add_job(qmod.Job(job_id="j0", input="/x0.fil"))
    claim = q.claim_next("w")
    token = (JToken if pkg == "jax" else TToken)()
    renewer = rmod._LeaseRenewer(q, claim, token=token)
    assert q.request_preempt("j0", requester="test", grace_s=60.0)
    fmod.configure("preempt.revoke:n=1")
    seen = []
    for _ in range(3):
        renewer._observe_revoke()
        seen.append(token.is_set())
    return seen, token.kind


@pytest.mark.parametrize("seam", ["queue.claim", "clock.skew", "worker.kill",
                                  "preempt.revoke"])
def test_fault_seams_fire_alike(tmp_path, seam):
    run = {"queue.claim": _claim_seam, "clock.skew": _skew_seam,
           "worker.kill": _kill_seam, "preempt.revoke": _revoke_seam}[seam]
    got = []
    for pkg in ("jax", "port"):
        got.append(run(tmp_path, pkg))
        PACKAGES[pkg][2].configure(None)
    assert got[0] == got[1]
    expect = {"clock.skew": lambda g: g[0] == ["j0"] and g[1] == 1,
              "worker.kill": lambda g: g[0] == "WorkerKilled" and g[1] == "running",
              "preempt.revoke": lambda g: g[0] == [False, True, True],
              "queue.claim": lambda g: g[0] == ["j0", "j1", "j2"]}[seam]
    assert expect(got[1]), got[1]


# ------------------------------------------------------------------------
# the CLI, the sift report, the card
# ------------------------------------------------------------------------

def _subcommands(parser):
    import argparse

    [sub] = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return {name: {o for a in p._actions for o in a.option_strings}
            for name, p in sub.choices.items()}


def test_cli_has_every_subcommand_and_flag_plus_device():
    from peasoup_tpu.cli.campaign import build_parser as jax_parser
    from peasoup_tpu_torch.cli.campaign import build_parser

    jax, port = _subcommands(jax_parser()), _subcommands(build_parser())
    assert set(port) == set(jax)
    for name in jax:
        assert port[name] >= jax[name], name
        extra = port[name] - jax[name]
        assert extra == ({"--device"} if name in ("run", "autoscale") else set()), name


def test_sift_report_takes_the_rollup_as_the_jax_report(campaigns, tmp_path):
    import shutil

    from peasoup_tpu.cli.sift import main as jax_sift
    from peasoup_tpu_torch.campaign.rollup import write_status
    from peasoup_tpu_torch.cli.sift import main as sift

    root = str(tmp_path / "camp")
    shutil.copytree(campaigns["port"], root)
    write_status(root)
    assert sift(["run", "-w", root, "--no-fold", "--device", "cpu"]) == 0
    sections = []
    for main in (jax_sift, sift):
        assert main(["report", "-w", root]) == 0
        with open(os.path.join(root, "sift", "report.json")) as f:
            sections.append(json.load(f)["campaign"])
    assert sections[0] == sections[1]
    assert sections[1]["schema"] == "peasoup_tpu.campaign_status"
    assert sections[1]["queue"]["done"] == 4


def test_campaign_asked_for_the_card_without_one_raises(monkeypatch, tmp_path):
    from peasoup_tpu_torch.cli.campaign import main

    root = str(tmp_path / "camp")
    trunner.save_campaign_config(root, trunner.CampaignConfig(warmup=False))
    tqueue.JobQueue(root).add_job(tqueue.Job(job_id="j0", input="/x0.fil"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: trunner.CampaignRunner(root),
                 lambda: trunner.run_worker(root),
                 lambda: main(["run", "-w", root])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    # nothing was claimed and no worker joined the fleet
    assert tqueue.JobQueue(root).state("j0") == "pending"
    assert not os.path.exists(os.path.join(root, "queue", "workers")) or not [
        n for n in os.listdir(os.path.join(root, "queue", "workers")) if n.endswith(".json")]


def test_warmer_thread_works_on_the_jobs_device(monkeypatch):
    # the bucket warmup runs on the job's device from its own thread, and
    # the JAX package's "aot" mode maps to the port's registry warmup
    from peasoup_tpu_torch.perf import warmup

    seen = []

    def fake(bucket, mode, device="cuda"):
        seen.append((mode, str(device)))
        return {"bucket": list(bucket), "mode": mode, "seconds": 0.5,
                "kernels_built": ["dedisperse"], "error": None}

    monkeypatch.setattr(warmup, "warm_bucket", fake)
    for mode in ("dryrun", "aot"):
        w = trunner._BucketWarmer((8, 8, 4096), "spsearch", {}, mode, device="cpu")
        w.start()
        stats = w.result(timeout=30)
        assert stats["mode"] == mode and stats["programs_compiled"] == 1
    assert seen == [("dryrun", "cpu"), ("registry", "cpu")]
