"""The port's chaos soak (peasoup_tpu_torch.tools.chaos, its jobs and stream
on the CPU) as the JAX package's tests/test_chaos.py and
tests/test_fleet.py's TestFleetRoles and TestFleetSoakEndToEnd hold the JAX
tool, then against the JAX tool on the same schedules and seeds: the same
fleet roles, byte-identical observations, the same injection log (site,
ordinal and context), queue tally, kills and report keys, both surviving;
the candidates to tests/test_torch_spsearch.py's standard: every field
exact but S/N (within 1e-5 relative) and the sample fields, which may
move within one dec block (32 samples) where boxcars of the integer
dedispersed trials tie and the two packages break the tie differently
(ROADMAP §C, "Facts")."""

import json
import os
import re

import numpy as np
import pytest

from peasoup_tpu_torch.resilience import faults
from peasoup_tpu_torch.resilience.stats import STATS
from peasoup_tpu_torch.tools import chaos

SCHEDULE = "fil.read:p=0.25:n=4,db.ingest:at=1,worker.kill:at=obs0"
SNR_RTOL = 1e-5
SP_FIELDS = ("dm", "dm_idx", "width", "width_idx", "members", "dm_idx_lo",
             "dm_idx_hi", "width_lo", "width_hi")
SAMPLE_FIELDS = ("sample", "sample_lo", "sample_hi")
DEC = 32  # the soak's single-pulse config's decimation (the default)
TSAMP = 0.000256  # make_observations' sample time


@pytest.fixture(autouse=True)
def _clean_faults():
    from peasoup_tpu.resilience import faults as jax_faults
    from peasoup_tpu.resilience.stats import STATS as JAX_STATS

    for f, s in ((faults, STATS), (jax_faults, JAX_STATS)):
        f.configure(None)
        s.reset()
    yield
    for f, s in ((faults, STATS), (jax_faults, JAX_STATS)):
        f.configure(None)
        s.reset()


class TestCampaignSoak:
    def test_compound_schedule_survives(self, tmp_path):
        """The acceptance schedule: flaky reads + one sqlite lock +
        one worker kill over a 3-obs campaign. Every invariant must
        hold: exactly-once, bitwise-equal candidates, clean tree,
        valid telemetry, bounded + attributed recovery."""
        sec = chaos.run_campaign_soak(
            str(tmp_path), SCHEDULE, seed=7, n_obs=3, lease_s=0.8, device="cpu",
        )
        assert sec["violations"] == []
        assert sec["queue"]["done"] == 3
        assert sec["queue"]["quarantined"] == 0
        assert sec["chaos"]["workers_killed"] == 1
        inj = {r["site"] for r in sec["injections"]["injected"]}
        assert "worker.kill" in inj
        # attribution: each fired transient site shows recovery marks
        stats = sec["stats"]
        for site in inj & {"fil.read", "db.ingest"}:
            assert stats["retries"].get(site) or stats["recoveries"].get(site), (
                site, stats)
        # the kill's recovery is the reaper: the killed job re-ran
        from peasoup_tpu_torch.campaign.queue import JobQueue

        done = JobQueue(os.path.join(tmp_path, "chaos")).done_records()
        assert any(int(d.get("attempts", 1)) > 1 for d in done)
        # rollup carries the aggregated per-job resilience deltas
        from peasoup_tpu_torch.campaign.rollup import load_campaign_status

        st = load_campaign_status(os.path.join(tmp_path, "chaos", "campaign_status.json"))
        assert "resilience" in st
        # the port's report: each job's attempts, launches (none on the
        # CPU) and kernel libraries built
        assert sorted(sec["jobs"]) == sorted(d["job_id"] for d in done)
        assert sum(j["attempts"] > 1 for j in sec["jobs"].values()) >= 1
        assert all(j["kernel_launches"] == {} for j in sec["jobs"].values())
        assert sec["kernel_libraries_built"] == 0 and sec["device"] == "cpu"

    def test_rejects_non_transient_schedule(self, tmp_path):
        with pytest.raises(ValueError, match="unknown fault site"):
            chaos.run_campaign_soak(str(tmp_path), "bogus.site:n=1", 1, device="cpu")


class TestStreamSoak:
    def test_replay_faults_reproduce_triggers(self, tmp_path):
        sec = chaos.run_stream_soak(
            str(tmp_path), "fil.read:at=replay:n=2", seed=7, device="cpu"
        )
        assert sec["violations"] == []
        assert sec["n_triggers"] >= 1
        assert sec["stats"]["faults_injected"]["fil.read"] == 2
        assert sec["stats"]["recoveries"].get("fil.read", 0) >= 1
        assert sec["chaos"]["kernel_launches"] == {}

    def test_rejects_non_stream_sites(self, tmp_path):
        with pytest.raises(ValueError, match="fil.read only"):
            chaos.run_stream_soak(str(tmp_path), "worker.kill", 1, device="cpu")


class TestCLI:
    def test_main_writes_report_and_exits_zero(self, tmp_path, capsys):
        rc = chaos.main(["--mode", "stream", "-o", str(tmp_path), "--seed", "7",
                         "--device", "cpu"])
        assert rc == 0
        with open(tmp_path / "chaos_report.json") as f:
            report = json.load(f)
        assert report["schema"] == chaos.REPORT_SCHEMA
        assert report["ok"] is True
        assert report["stream"]["violations"] == []
        out = capsys.readouterr().out
        assert "SURVIVED" in out

    def test_no_card_is_an_internal_error(self, tmp_path, capsys):
        """`--device cuda` (the default) with no card exits 2, having
        run nothing: no fallback to the CPU."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        assert chaos.main(["--mode", "campaign", "-o", str(tmp_path)]) == 2
        with open(tmp_path / "chaos_report.json") as f:
            report = json.load(f)
        assert report["ok"] is False and "cuda" in report["error"]
        assert not os.path.exists(tmp_path / "ref")
        assert "internal error" in capsys.readouterr().err


# --------------------------------------------------------------------------
# fleet soak schedule (tests/test_fleet.py TestFleetRoles)
# --------------------------------------------------------------------------

class TestFleetRoles:
    def test_roles_deterministic_and_complete(self):
        from peasoup_tpu_torch.tools.chaos import _fleet_roles

        a = _fleet_roles(11, 4)
        b = _fleet_roles(11, 4)
        c = _fleet_roles(12, 4)
        assert a == b
        assert a != c
        assert sum(r["kill"] for r in a) == 1
        assert sum(bool(r["max_jobs"]) for r in a) == 1
        assert sum(r["late"] for r in a) == 1
        # a victim is never also the late joiner, and at least one
        # plain drainer remains
        for r in a:
            assert not (r["kill"] and r["late"])
        assert any(not r["kill"] and not r["max_jobs"] and not r["late"] for r in a)
        # exactly one worker carries the flaky-read schedule, one
        # carries the skew, and both embed the seed
        flaky = [r for r in a if "fil.read" in r["faults"]]
        skewed = [r for r in a if "clock.skew" in r["faults"]]
        assert len(flaky) == 1 and len(skewed) == 1
        assert all("seed=11" in r["faults"] for r in flaky + skewed)
        assert not flaky[0]["kill"] and not skewed[0]["kill"]
        # default roles carry no gang group
        assert all(not r["group"] for r in a)

    def test_roles_gang_group_assignment(self):
        """With gangs scheduled, exactly two workers share pod0 —
        the flaky drainer and the late joiner — and neither is a kill
        victim or a single-job leaver (the gang must stay able to
        assemble)."""
        from peasoup_tpu_torch.tools.chaos import _fleet_roles

        roles = _fleet_roles(11, 4, gangs=1)
        pod = [r for r in roles if r["group"] == "pod0"]
        assert len(pod) == 2
        assert not any(r["kill"] or r["max_jobs"] for r in pod)
        assert any(r["late"] for r in pod)  # assembly-over-time drill
        assert _fleet_roles(11, 4, gangs=1) == roles  # deterministic

    def test_roles_reject_fleet_without_a_drainer(self):
        from peasoup_tpu_torch.tools.chaos import _fleet_roles

        with pytest.raises(ValueError, match="drainer"):
            _fleet_roles(1, 2, kills=1, late_joiners=1)

    def test_fleet_soak_rejects_too_few_jobs(self, tmp_path):
        from peasoup_tpu_torch.tools.chaos import run_fleet_soak

        with pytest.raises(ValueError, match="one job per worker"):
            run_fleet_soak(str(tmp_path), None, 1, n_workers=4, n_obs=2, device="cpu")


@pytest.mark.parametrize("seed", [1, 7, 11, 23])
@pytest.mark.parametrize("n,kw", [
    (4, {}),
    (4, {"gangs": 1}),
    (6, {"kills": 2, "leavers": 2, "gangs": 1}),
    (5, {"late_joiners": 2, "skew_s": 3.0}),
    (3, {"leavers": 0, "faults_spec": ""}),
])
def test_fleet_roles_are_the_jax_roles(seed, n, kw):
    from peasoup_tpu.tools.chaos import _fleet_roles as jax_roles

    assert chaos._fleet_roles(seed, n, **kw) == jax_roles(seed, n, **kw)


def test_constants_are_the_jax_tools():
    from peasoup_tpu.tools import chaos as jax_chaos

    for name in ("REPORT_SCHEMA", "REPORT_VERSION", "DEFAULT_CAMPAIGN_FAULTS",
                 "DEFAULT_STREAM_FAULTS", "DEFAULT_FLEET_WORKER_FAULTS",
                 "TRANSIENT_SITES", "RECOVERY_TABLES", "SITES_IN_LOGS"):
        assert getattr(chaos, name) == getattr(jax_chaos, name), name


@pytest.mark.parametrize("n_obs,nsamps,nchans", [(3, 1 << 12, 8), (2, 1 << 13, 16)])
def test_make_observations_writes_the_jax_files(tmp_path, n_obs, nsamps, nchans):
    from peasoup_tpu.tools.chaos import make_observations as jax_make

    ours = chaos.make_observations(str(tmp_path / "port"), n_obs, nsamps, nchans)
    theirs = jax_make(str(tmp_path / "jax"), n_obs, nsamps, nchans)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()


# --------------------------------------------------------------------------
# what the fleet soak found in the port's worker
# --------------------------------------------------------------------------

def test_a_leaving_worker_answers_a_pending_profile_request(tmp_path):
    """A profile request that lands after the worker's last poll is
    answered before it leaves (its capture's outcome in its metrics
    stream), not cleared unanswered by the leave."""
    from peasoup_tpu_torch.campaign.registry import WorkerRegistry
    from peasoup_tpu_torch.campaign.runner import (
        CampaignConfig, run_worker, save_campaign_config,
    )

    root = str(tmp_path)
    save_campaign_config(root, CampaignConfig(warmup=False))
    reg = WorkerRegistry(root)
    reg.request_profile("w", seconds=0.1, requester="test")
    run_worker(root, worker_id="w", max_jobs=0, poll_s=0.01, device="cpu")
    assert reg.profile_requested("w") is None
    with open(reg.metrics_path("w")) as f:
        assert '"profile_captures_total"' in f.read()


def test_workers_started_together_read_one_config(tmp_path):
    """Workers attaching to a new campaign at once: the first config
    published wins whole, and none reads it half written."""
    import threading

    from peasoup_tpu_torch.campaign.runner import (
        CampaignConfig, load_campaign_config, save_campaign_config,
    )

    root = str(tmp_path / "camp")
    got, errors = [], []

    def attach(i):
        try:
            got.append(save_campaign_config(
                root, CampaignConfig(pipeline=("search", "spsearch")[i % 2])).pipeline)
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=attach, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert set(got) == {load_campaign_config(root).pipeline}
    assert os.listdir(root) == ["campaign.json"]


# --------------------------------------------------------------------------
# both packages' soaks on one schedule and seed
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    """Both tools' `--mode both` on the default schedules, seed 7."""
    from peasoup_tpu.obs import log as jax_log
    from peasoup_tpu.tools import chaos as jax_chaos

    logger = jax_log.get_logger()
    handler, handlers, level = jax_log._handler, list(logger.handlers), logger.level
    out = {}
    try:
        for label, main, extra in (("port", chaos.main, ["--device", "cpu"]),
                                   ("jax", jax_chaos.main, [])):
            w = str(tmp_path_factory.mktemp(f"soak_{label}"))
            rc = main(["--mode", "both", "--seed", "7", "-o", w, *extra])
            with open(os.path.join(w, "chaos_report.json")) as f:
                out[label] = (rc, w, json.load(f))
    finally:
        jax_log._handler = handler
        logger.handlers[:] = handlers
        logger.setLevel(level)
    return out


def _obs_name(job_id: str) -> str:
    """A job id less its hash of the input's path (job_id_for), which
    differs between two soaks' workdirs."""
    return re.sub(r"^(obs\d+)-[0-9a-f]{8}$", r"\1", job_id)


def _injections(report: dict, section: str, workdir: str) -> list:
    return [(r["site"], r["ordinal"],
             _obs_name(str(r["context"]).replace(workdir, "<w>")))
            for r in report[section]["injections"]["injected"]]


def test_soaks_survive_alike(soaks):
    (rc, w, got), (jrc, jw, want) = soaks["port"], soaks["jax"]
    assert rc == jrc == 0
    assert got["ok"] and want["ok"]
    assert got["violations"] == want["violations"] == []
    for section in ("campaign", "stream"):
        assert got[section]["violations"] == want[section]["violations"] == []
        assert _injections(got, section, w) == _injections(want, section, jw)
        assert got[section]["injections"]["spec"] == want[section]["injections"]["spec"]
    assert got["campaign"]["queue"] == want["campaign"]["queue"]
    assert got["campaign"]["chaos"]["workers_killed"] == want["campaign"]["chaos"][
        "workers_killed"] == 1
    assert got["campaign"]["chaos"]["tally"] == want["campaign"]["chaos"]["tally"]
    assert got["stream"]["n_triggers"] == want["stream"]["n_triggers"]
    assert got["stream"]["stats"]["faults_injected"] == want["stream"]["stats"][
        "faults_injected"]
    # the JAX report's keys, the port's additions beside them
    added = {"": {"device"}, "campaign": {"device", "jobs", "kernel_libraries_built"},
             "stream": {"device"}}
    assert set(got) == set(want) | added[""]
    for section in ("campaign", "stream"):
        assert set(got[section]) == set(want[section]) | added[section]


@pytest.mark.parametrize("which", ["ref", "chaos"])
def test_soak_candidates_are_the_jax_candidates(soaks, which):
    """Each job's candidates, fault-free and under the schedule: the JAX
    package's, every field exact but S/N (1e-5 relative) and the sample
    fields (within one dec block)."""
    from peasoup_tpu.tools.parsers import read_singlepulse

    (_, w, _), (_, jw, _) = soaks["port"], soaks["jax"]
    jobs, jax_jobs = (sorted(os.listdir(os.path.join(d, which, "jobs")), key=_obs_name)
                      for d in (w, jw))
    assert [_obs_name(j) for j in jobs] == [_obs_name(j) for j in jax_jobs]
    assert len(jobs) == 3
    for j, jj in zip(jobs, jax_jobs):
        got = read_singlepulse(os.path.join(w, which, "jobs", j, "candidates.singlepulse"))
        want = read_singlepulse(os.path.join(jw, which, "jobs", jj,
                                             "candidates.singlepulse"))
        assert len(got) == len(want) > 0, j
        for name in SP_FIELDS:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{j} {name}")
        np.testing.assert_allclose(got["snr"], want["snr"], rtol=SNR_RTOL, atol=0)
        for name in SAMPLE_FIELDS:
            assert (np.abs(got[name] - want[name]) < DEC).all(), (j, name)
        assert (np.abs(got["time_s"] - want["time_s"]) < DEC * TSAMP).all(), j


# --------------------------------------------------------------------------
# the real thing: worker processes under kill + churn + skew
# --------------------------------------------------------------------------

@pytest.mark.slow
class TestFleetSoakEndToEnd:
    def test_fleet_soak_survives(self, tmp_path):
        from peasoup_tpu_torch.tools.chaos import run_fleet_soak

        sec = run_fleet_soak(
            str(tmp_path), None, seed=11, n_workers=4, n_obs=6, lease_s=1.0,
            device="cpu",
        )
        assert sec["violations"] == []
        # 6 base obs + 1 urgent (the preemption drill's priority job)
        assert sec["queue"]["done"] == 7
        assert sec["kills"] and sec["late_joins"]
        assert sec["recovery"]["worker.kill"]["reaped_retries"] >= 1
        assert sec["recovery"]["fil.read"]["injected"] == 2
        assert sec["preemption"]["jobs_resumed"] >= 1
        assert sec["preemption"]["latency_s"]
        assert sec["gang"]["done"] == 1
        assert sec["autoscale"]["ups"] >= 1

    def test_fleet_soak_long(self, tmp_path):
        """The long variant: a bigger fleet over many more observations,
        with every drill scaled up."""
        from peasoup_tpu_torch.tools.chaos import run_fleet_soak

        sec = run_fleet_soak(
            str(tmp_path), None, seed=23, n_workers=6, n_obs=24,
            nsamps=1 << 13, lease_s=2.0, kills=2, leavers=2,
            late_joiners=1, timeout_s=7200.0, device="cpu",
        )
        assert sec["violations"] == []
        assert sec["queue"]["done"] == 25  # 24 base + 1 urgent
        assert sec["preemption"]["jobs_resumed"] >= 1
        assert sec["gang"]["done"] == 1
        assert sec["autoscale"]["ups"] >= 1
