"""The port's elastic fleet (the JAX package's tests/test_fleet.py, class by
class, on the port's modules, its workers on the CPU): the worker
registry (join/beat/leave/reap),
priority-class claiming, clean voluntary release, priority PREEMPTION
(checkpointed revoke/resume with zero attempts consumed, release
fairness, grace-deadline escalation, mid-preemption death),
gang-scheduled multi-host jobs (leader-only all-or-nothing claims, the
file-backed exchange, transient gang failure), the autoscale
controller's bounds, elastic-membership scenarios (late joiners
preferring warm buckets; a SIGKILLed worker's registry entry reaped
and its job re-queued exactly once — with a REAL subprocess) and the
rollup's fleet section. Then against the JAX package: the same synthetic
rollup trace gives the same autoscale decisions, and the controller
spawns the port's campaign CLI on its device.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from peasoup_tpu_torch.campaign.queue import Job, JobQueue, job_id_for
from peasoup_tpu_torch.campaign.registry import WorkerRegistry
from peasoup_tpu_torch.resilience import faults
from peasoup_tpu_torch.resilience.stats import STATS


def _write_obs(
    path, seed=5, nsamps=1 << 12, nchans=8, dm_end=20.0,
):
    """One small synthetic observation with a dispersed pulse."""
    from peasoup_tpu_torch.io.sigproc import (
        Filterbank,
        SigprocHeader,
        write_filterbank,
    )
    from peasoup_tpu_torch.plan.dm_plan import DMPlan

    tsamp, fch1, foff = 0.000256, 1400.0, -16.0
    plan = DMPlan.create(
        nsamps=nsamps, nchans=nchans, tsamp=tsamp, fch1=fch1, foff=foff,
        dm_start=0.0, dm_end=dm_end, pulse_width=64.0, tol=1.10,
    )
    delays = plan.delay_samples()[plan.ndm // 2]
    rng = np.random.default_rng(seed)
    data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
    for c in range(nchans):
        data[1500 + delays[c] : 1504 + delays[c], c] += 14.0
    hdr = SigprocHeader(
        source_name="FLEET", tsamp=tsamp, tstart=55000.0, fch1=fch1,
        foff=foff, nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    write_filterbank(
        path,
        Filterbank(
            header=hdr,
            data=np.clip(np.rint(data), 0, 255).astype(np.uint8),
        ),
    )
    return path


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure(None)
    STATS.reset()
    yield
    faults.configure(None)
    STATS.reset()


# --------------------------------------------------------------------------
# worker registry
# --------------------------------------------------------------------------

class TestWorkerRegistry:
    def test_register_beat_live_deregister(self, tmp_path):
        reg = WorkerRegistry(str(tmp_path), lease_s=30.0)
        reg.register("w1")
        reg.register("w2")
        live = reg.live()
        assert sorted(e["worker_id"] for e in live) == ["w1", "w2"]
        assert all(e["pid"] == os.getpid() for e in live)
        reg.beat("w1", jobs_done=3, current_job="jobX")
        [w1] = [e for e in reg.live() if e["worker_id"] == "w1"]
        assert w1["jobs_done"] == 3 and w1["current_job"] == "jobX"
        reg.deregister("w1")
        assert [e["worker_id"] for e in reg.live()] == ["w2"]
        reg.deregister("w2")
        reg.deregister("w2")  # idempotent
        assert reg.entries() == []

    def test_expired_entry_not_live_and_reaped(self, tmp_path):
        reg = WorkerRegistry(str(tmp_path), lease_s=0.05)
        reg.register("dead")
        time.sleep(0.1)
        assert reg.live() == []
        assert reg.entries()  # still on disk until reaped
        assert reg.reap() == ["dead"]
        assert reg.entries() == []
        assert reg.reap() == []  # second reap: nothing left

    def test_beat_recreates_a_reaped_entry(self, tmp_path):
        """A worker that beats IS alive, whatever a skewed reaper
        concluded — the beat re-registers."""
        reg = WorkerRegistry(str(tmp_path), lease_s=30.0)
        reg.register("w1")
        os.unlink(reg._path("w1"))  # reaped from under it
        reg.beat("w1", jobs_done=1)
        [e] = reg.live()
        assert e["worker_id"] == "w1"

    def test_takeover_of_stale_same_id(self, tmp_path):
        reg = WorkerRegistry(str(tmp_path), lease_s=0.05)
        reg.register("w1", jobs_done=7)
        time.sleep(0.1)
        doc = reg.register("w1")  # restart reusing the id
        assert doc["jobs_done"] == 0
        [e] = reg.live()
        assert e["worker_id"] == "w1"


# --------------------------------------------------------------------------
# priority classes + clean release
# --------------------------------------------------------------------------

class TestPriorityClaiming:
    def test_priority_outranks_fifo(self, tmp_path):
        q = JobQueue(str(tmp_path))
        q.add_job(Job(job_id="a-first", input="a.fil", priority=0))
        q.add_job(Job(job_id="b-urgent", input="b.fil", priority=5))
        claim = q.claim_next("w1")
        assert claim.job.job_id == "b-urgent"

    def test_priority_outranks_bucket_affinity(self, tmp_path):
        """The documented ranking: priority > prefer-bucket >
        warm-bucket > FIFO. An urgent job in a COLD bucket must beat a
        plain job in the worker's own warm streak bucket."""
        q = JobQueue(str(tmp_path))
        warm = (8, 8, 4096)
        cold = (16, 8, 8192)
        q.add_job(Job(job_id="a-streak", input="a.fil", bucket=warm))
        q.add_job(
            Job(job_id="b-urgent", input="b.fil", bucket=cold, priority=1)
        )
        claim = q.claim_next(
            "w1", prefer_bucket=warm, warm_buckets={warm}
        )
        assert claim.job.job_id == "b-urgent"
        # equal priority: the streak bucket wins again
        q.complete(claim)
        q.add_job(
            Job(job_id="c-urgent2", input="c.fil", bucket=cold, priority=0)
        )
        claim2 = q.claim_next(
            "w1", prefer_bucket=warm, warm_buckets={warm}
        )
        assert claim2.job.job_id == "a-streak"

    def test_priority_round_trips_job_record(self, tmp_path):
        q = JobQueue(str(tmp_path))
        q.add_job(Job(job_id="p", input="p.fil", priority=3))
        assert q.get_job("p").priority == 3

    def test_clean_release_consumes_zero_attempts(self, tmp_path):
        """Satellite: a worker leaving cleanly hands its claim back
        with ZERO attempts consumed; the job is immediately claimable
        by anyone."""
        q = JobQueue(str(tmp_path))
        q.add_job(Job(job_id="j", input="x.fil"))
        claim = q.claim_next("leaver")
        assert claim is not None
        q.release(claim)
        assert q.state("j") == "pending"
        assert q.get_job("j").attempts == 0
        claim2 = q.claim_next("successor")
        assert claim2 is not None and claim2.worker_id == "successor"
        q.complete(claim2)
        [done] = q.done_records()
        assert done["attempts"] == 1  # the successor's only


# --------------------------------------------------------------------------
# priority preemption: checkpointed revoke / resume
# --------------------------------------------------------------------------

class TestPreemption:
    def test_request_observe_release_zero_attempts(self, tmp_path):
        q = JobQueue(str(tmp_path))
        q.add_job(Job(job_id="j", input="x.fil"))
        assert not q.request_preempt("j")  # no claim yet
        claim = q.claim_next("victim")
        assert q.request_preempt("j", requester="urgent", grace_s=30.0)
        req = q.preempt_request("j")
        assert req["victim_worker"] == "victim"
        latency = q.release_preempted(claim)
        assert latency >= 0.0
        assert q.preempt_request("j") is None  # request consumed
        job = q.get_job("j")
        assert job.attempts == 0  # the revoke consumed ZERO attempts
        assert job.preemptions == 1
        assert len(job.preempt_latency_s) == 1

    def test_released_job_keeps_original_queue_position(self, tmp_path):
        """Satellite regression: a preempted high-arrival-order (older)
        job must be re-claimed before younger same-priority jobs — the
        release hands back its original position, it does not sort as
        fresh. 'z-old' sorts LAST lexically, so only arrival order can
        put it first."""
        q = JobQueue(str(tmp_path))
        q.add_job(Job(job_id="z-old", input="a.fil", created_unix=100.0))
        q.add_job(
            Job(job_id="a-young", input="b.fil", created_unix=200.0)
        )
        q.add_job(
            Job(job_id="b-young", input="c.fil", created_unix=300.0)
        )
        claim = q.claim_next("w1")
        assert claim.job.job_id == "z-old"  # arrival order claims first
        q.request_preempt("z-old")
        q.release_preempted(claim)
        reclaim = q.claim_next("w2")
        assert reclaim.job.job_id == "z-old"  # position preserved
        # a voluntary (clean) release preserves position too
        q.release(reclaim)
        again = q.claim_next("w3")
        assert again.job.job_id == "z-old"

    def test_grace_deadline_escalates_to_reap(self, tmp_path):
        """A victim that renews its lease but never answers the revoke
        is reaped at the grace deadline: one attempt consumed, the
        preempt request cleared — never a hung revoke."""
        q = JobQueue(str(tmp_path), lease_s=60.0)
        q.add_job(Job(job_id="j", input="x.fil"))
        claim = q.claim_next("wedged")
        q.request_preempt("j", grace_s=0.01)
        time.sleep(0.05)
        q.renew(claim)  # alive enough to renew, unresponsive to revoke
        assert q.reap_stale() == ["j"]
        assert q.reap_stale() == []  # exactly once
        job = q.get_job("j")
        assert job.attempts == 1
        assert q.preempt_request("j") is None
        assert STATS.snapshot()["preemptions"].get("reaped") == 1

    def test_self_preemption_victim_selection(self, tmp_path):
        """The decentralised trigger: the lease renewer of the
        LOWEST-priority running claim self-revokes when a pending job
        outranks it and no idle worker is live."""
        from peasoup_tpu_torch.campaign.runner import _LeaseRenewer
        from peasoup_tpu_torch.resilience import RevokeToken

        root = str(tmp_path)
        q = JobQueue(root)
        reg = WorkerRegistry(root)
        q.add_job(Job(job_id="a-low", input="a.fil", priority=0))
        q.add_job(Job(job_id="b-mid", input="b.fil", priority=1))
        low = q.try_claim("a-low", "w-low")
        mid = q.try_claim("b-mid", "w-mid")
        reg.register("w-low")
        reg.beat("w-low", current_job="a-low")
        reg.register("w-mid")
        reg.beat("w-mid", current_job="b-mid")
        q.add_job(Job(job_id="c-urgent", input="c.fil", priority=5))
        # the mid-priority holder is NOT the victim
        tok_mid = RevokeToken()
        _LeaseRenewer(
            q, mid, registry=reg, token=tok_mid, self_preempt=True
        )._observe_revoke()
        assert not tok_mid.is_set()
        assert q.preempt_request("b-mid") is None
        # the lowest-priority holder is
        tok_low = RevokeToken()
        _LeaseRenewer(
            q, low, registry=reg, token=tok_low, self_preempt=True
        )._observe_revoke()
        assert tok_low.is_set() and tok_low.kind == "preempt"
        assert q.preempt_request("a-low") is not None

    def test_self_preemption_defers_to_idle_worker(self, tmp_path):
        """No self-revoke while a live IDLE worker could just claim the
        urgent job."""
        from peasoup_tpu_torch.campaign.runner import _LeaseRenewer
        from peasoup_tpu_torch.resilience import RevokeToken

        root = str(tmp_path)
        q = JobQueue(root)
        reg = WorkerRegistry(root)
        q.add_job(Job(job_id="a-low", input="a.fil", priority=0))
        low = q.try_claim("a-low", "w-low")
        reg.register("w-low")
        reg.beat("w-low", current_job="a-low")
        reg.register("w-idle")  # current_job None
        q.add_job(Job(job_id="c-urgent", input="c.fil", priority=5))
        tok = RevokeToken()
        _LeaseRenewer(
            q, low, registry=reg, token=tok, self_preempt=True
        )._observe_revoke()
        assert not tok.is_set()

    def test_preempt_revoke_fault_suppresses_observation(self, tmp_path):
        """The preempt.revoke chaos seam: an injected delivery failure
        makes the renewer MISS the request for that beat; the next
        beat observes it."""
        from peasoup_tpu_torch.campaign.runner import _LeaseRenewer
        from peasoup_tpu_torch.resilience import RevokeToken

        q = JobQueue(str(tmp_path))
        q.add_job(Job(job_id="j", input="x.fil"))
        claim = q.claim_next("victim")
        q.request_preempt("j")
        faults.configure("preempt.revoke:n=1")
        tok = RevokeToken()
        renewer = _LeaseRenewer(q, claim, token=tok)
        renewer._observe_revoke()
        assert not tok.is_set()  # delivery injected away
        assert STATS.snapshot()["faults_injected"].get(
            "preempt.revoke"
        ) == 1
        renewer._observe_revoke()
        assert tok.is_set()  # the next beat lands

    def test_end_to_end_preempt_checkpoint_resume(self, tmp_path):
        """The tentpole acceptance: a running job is revoked, the
        victim checkpoints at a DM-block boundary and releases with
        zero attempts consumed, the job resumes from the checkpoint,
        and its candidates are BITWISE-equal to an uninterrupted run
        — with the revoke latency in the done record."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            bucket_for_input,
            run_worker,
            save_campaign_config,
        )

        root = str(tmp_path)
        path = _write_obs(
            os.path.join(root, "obs.fil"), dm_end=150.0
        )
        cfg = dict(
            dm_end=150.0, dm_tol=1.03, min_snr=7.0, n_widths=6,
            dm_block=2,  # many chunks: plenty of revoke boundaries
        )
        save_campaign_config(
            root,
            CampaignConfig(
                pipeline="spsearch", config=cfg, lease_s=0.6,
                backoff_base_s=0.05, warmup=False,
            ),
        )
        q = JobQueue(root, lease_s=0.6, backoff_base_s=0.05)
        jid = job_id_for(path)
        q.add_job(
            Job(
                job_id=jid, input=path, pipeline="spsearch",
                bucket=bucket_for_input(path),
            )
        )
        out = {}

        def work():
            out["tally"] = run_worker(root, device="cpu", worker_id="w1", poll_s=0.05)

        t = threading.Thread(target=work)
        t.start()
        claim_path = os.path.join(root, "queue", "claims", f"{jid}.json")
        deadline = time.monotonic() + 60
        while not os.path.exists(claim_path):
            assert time.monotonic() < deadline, "claim never appeared"
            time.sleep(0.01)
        q.request_preempt(jid, requester="test", grace_s=120.0)
        t.join(timeout=240)
        assert not t.is_alive(), "worker did not drain"
        assert out["tally"]["released"] == 1, out["tally"]
        [done] = q.done_records()
        assert done["attempts"] == 1  # zero consumed by the revoke
        assert done["preemptions"] == 1
        assert done["preempt_latency_s"] and (
            done["preempt_latency_s"][0] >= 0.0
        )
        man = json.load(
            open(os.path.join(root, "jobs", jid, "telemetry.json"))
        )
        kinds = {e["kind"] for e in man.get("events", [])}
        assert kinds & {"sp_checkpoint_resume", "sp_resume_fast_path"}
        # bitwise equality vs an uninterrupted run of the same obs
        from peasoup_tpu_torch.io.output import write_singlepulse
        from peasoup_tpu_torch.io.sigproc import read_filterbank
        from peasoup_tpu_torch.pipeline.single_pulse import (
            SinglePulseConfig,
            SinglePulseSearch,
        )

        ref_dir = os.path.join(root, "ref")
        os.makedirs(ref_dir)
        res = SinglePulseSearch(
            SinglePulseConfig(outdir=ref_dir, **cfg), device="cpu"
        ).run(read_filterbank(path))
        write_singlepulse(os.path.join(ref_dir, "ref.sp"), res.candidates)
        got = open(
            os.path.join(root, "jobs", jid, "candidates.singlepulse"),
            "rb",
        ).read()
        ref = open(os.path.join(ref_dir, "ref.sp"), "rb").read()
        assert got == ref
        # no revoke residue; rollup carries the attribution
        assert not os.listdir(os.path.join(root, "queue", "claims"))
        from peasoup_tpu_torch.campaign.rollup import build_status

        st = build_status(root, q)
        assert st["preemptions"]["jobs"] == 1
        assert st["preemptions"]["latency_s"]["mean"] >= 0.0

    def test_reap_mid_preemption_resume_consumes_checkpoint(
        self, tmp_path
    ):
        """Satellite: a victim that observed the revoke and WROTE its
        checkpoint but died before releasing (claim left behind). The
        reaper requeues exactly once, and the resumed run consumes
        the victim's checkpoint — candidates bitwise-equal."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            bucket_for_input,
            run_worker,
            save_campaign_config,
        )
        from peasoup_tpu_torch.io.sigproc import read_filterbank
        from peasoup_tpu_torch.pipeline.single_pulse import (
            SinglePulseConfig,
            SinglePulseSearch,
        )
        from peasoup_tpu_torch.resilience import (
            RevokeToken,
            SearchPreempted,
            activate_token,
        )

        root = str(tmp_path)
        path = _write_obs(os.path.join(root, "obs.fil"))
        cfg = dict(dm_end=20.0, min_snr=7.0, n_widths=6, dm_block=2)
        save_campaign_config(
            root,
            CampaignConfig(
                pipeline="spsearch", config=cfg, lease_s=0.4,
                backoff_base_s=0.05, warmup=False,
            ),
        )
        q = JobQueue(root, lease_s=0.4, backoff_base_s=0.05)
        jid = job_id_for(path)
        q.add_job(
            Job(
                job_id=jid, input=path, pipeline="spsearch",
                bucket=bucket_for_input(path),
            )
        )
        claim = q.claim_next("victim")
        q.request_preempt(jid, grace_s=120.0)
        # the victim's run: revoke pre-set, so the driver checkpoints
        # the first chunk and raises — then the victim "dies" without
        # releasing (no release_preempted call)
        job_dir = os.path.join(root, "jobs", jid)
        os.makedirs(job_dir, exist_ok=True)
        fil = read_filterbank(path)
        token = RevokeToken()
        token.revoke(kind="preempt", reason="test")
        vic_cfg = SinglePulseConfig(
            outdir=job_dir,
            checkpoint_file=os.path.join(job_dir, "search.ckpt.npz"),
            **cfg,
        )
        with activate_token(token), pytest.raises(SearchPreempted):
            SinglePulseSearch(vic_cfg, device="cpu").run(fil)
        assert os.path.exists(vic_cfg.checkpoint_file)
        # lease expires -> exactly one requeue
        time.sleep(0.45)
        assert q.reap_stale() == [jid]
        assert q.reap_stale() == []
        assert q.get_job(jid).attempts == 1
        assert q.preempt_request(jid) is None  # cleared by the reap
        # the resumed run consumes the victim's checkpoint
        tally = run_worker(root, device="cpu", worker_id="rescuer", poll_s=0.05)
        assert tally["done"] == 1
        [done] = q.done_records()
        assert done["attempts"] == 2  # the reap's one consumed attempt
        man = json.load(
            open(os.path.join(job_dir, "telemetry.json"))
        )
        kinds = {e["kind"] for e in man.get("events", [])}
        assert kinds & {"sp_checkpoint_resume", "sp_resume_fast_path"}
        ref_dir = os.path.join(root, "ref")
        os.makedirs(ref_dir)
        from peasoup_tpu_torch.io.output import write_singlepulse

        res = SinglePulseSearch(
            SinglePulseConfig(outdir=ref_dir, **cfg), device="cpu"
        ).run(fil)
        write_singlepulse(os.path.join(ref_dir, "ref.sp"), res.candidates)
        got = open(
            os.path.join(job_dir, "candidates.singlepulse"), "rb"
        ).read()
        assert got == open(
            os.path.join(ref_dir, "ref.sp"), "rb"
        ).read()


# --------------------------------------------------------------------------
# gang-scheduled multi-host jobs
# --------------------------------------------------------------------------

class TestGangScheduling:
    def test_gang_claim_requires_full_group_no_starvation(self, tmp_path):
        """All-or-nothing with no head-of-line blocking: an
        unassemblable gang job is skipped — ordinary work still
        claims — and non-leaders never initiate gang claims."""
        q = JobQueue(str(tmp_path))
        q.add_job(
            Job(
                job_id="a-gang", input="g.fil", nprocs=2,
                created_unix=1.0,
            )
        )
        q.add_job(
            Job(job_id="b-normal", input="n.fil", created_unix=2.0)
        )
        # group of one: the gang job cannot assemble; the normal job
        # must still be claimed (the starvation pin)
        claim = q.claim_next("w1", group="pod", group_members=["w1"])
        assert claim.job.job_id == "b-normal"
        assert claim.gang is None
        q.release(claim)
        # ungrouped worker: same
        claim = q.claim_next("w1")
        assert claim.job.job_id == "b-normal"
        q.release(claim)
        # non-leader of an assembled group: never initiates the gang
        claim = q.claim_next(
            "w2", group="pod", group_members=["w1", "w2"]
        )
        assert claim.job.job_id == "b-normal"
        q.release(claim)
        # the leader of a full group gang-claims with the member set
        claim = q.claim_next(
            "w1", group="pod", group_members=["w1", "w2"]
        )
        assert claim.job.job_id == "a-gang"
        assert claim.gang["members"] == ["w1", "w2"]
        assert claim.gang["nprocs"] == 2
        # the member discovers its invitation; the leader does not
        inv = q.gang_invitation("w2")
        assert inv and inv["job_id"] == "a-gang"
        assert q.gang_invitation("w1") is None

    def test_gang_comm_timeout_is_transient(self, tmp_path):
        from peasoup_tpu_torch.parallel.multihost import GangComm
        from peasoup_tpu_torch.resilience import TransientIOError, is_transient

        comm = GangComm(
            str(tmp_path / "gang"), nprocs=2, rank=0,
            timeout_s=0.2, poll_s=0.01,
        )
        with pytest.raises(TransientIOError) as ei:
            comm.allgather(b"hello", context="test:join")
        assert is_transient(ei.value)

    def test_gang_comm_exchange_and_abort(self, tmp_path):
        from peasoup_tpu_torch.parallel.multihost import GangComm
        from peasoup_tpu_torch.resilience import TransientIOError

        d = str(tmp_path / "gang")
        a = GangComm(d, nprocs=2, rank=0, timeout_s=5.0, poll_s=0.01)
        b = GangComm(d, nprocs=2, rank=1, timeout_s=5.0, poll_s=0.01)
        out = {}

        def member():
            out["b"] = b.allgather(b"from-b", context="x")

        t = threading.Thread(target=member)
        t.start()
        got = a.allgather(b"from-a", context="x")
        t.join(timeout=5)
        assert got == [b"from-a", b"from-b"]
        assert out["b"] == got
        # an abort marker fails the next barrier fast on every member
        b.abort("member dying")
        with pytest.raises(TransientIOError, match="abort"):
            a.allgather(b"next", context="y")

    def test_gang_end_to_end_bitwise_equal(self, tmp_path):
        """Two grouped workers run one nprocs=2 job through the
        multi-host driver over the file exchange; the done record
        carries the gang provenance and the candidates are
        bitwise-equal to a single-process run."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            bucket_for_input,
            run_worker,
            save_campaign_config,
        )

        root = str(tmp_path)
        path = _write_obs(os.path.join(root, "obs.fil"), seed=7)
        cfg = dict(dm_end=20.0, min_snr=7.0, n_widths=6)
        save_campaign_config(
            root,
            CampaignConfig(
                pipeline="spsearch", config=cfg, lease_s=2.0,
                backoff_base_s=0.05, warmup=False,
                gang_assemble_s=30.0, gang_timeout_s=60.0,
            ),
        )
        q = JobQueue(root, lease_s=2.0, backoff_base_s=0.05)
        jid = job_id_for(path)
        q.add_job(
            Job(
                job_id=jid, input=path, pipeline="spsearch",
                bucket=bucket_for_input(path), nprocs=2,
            )
        )
        outs = {}

        def work(wid):
            outs[wid] = run_worker(root, device="cpu", worker_id=wid, poll_s=0.05, group="pod0"
            )

        ts = [
            threading.Thread(target=work, args=(w,))
            for w in ("gw-a", "gw-b")
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=240)
        assert all(not t.is_alive() for t in ts)
        [done] = q.done_records()
        assert done["gang"]["nprocs"] == 2
        assert sorted(done["gang"]["members"]) == ["gw-a", "gw-b"]
        from peasoup_tpu_torch.io.output import write_singlepulse
        from peasoup_tpu_torch.io.sigproc import read_filterbank
        from peasoup_tpu_torch.pipeline.single_pulse import (
            SinglePulseConfig,
            SinglePulseSearch,
        )

        ref_dir = os.path.join(root, "ref")
        os.makedirs(ref_dir)
        res = SinglePulseSearch(
            SinglePulseConfig(outdir=ref_dir, **cfg), device="cpu"
        ).run(read_filterbank(path))
        write_singlepulse(os.path.join(ref_dir, "ref.sp"), res.candidates)
        got = open(
            os.path.join(root, "jobs", jid, "candidates.singlepulse"),
            "rb",
        ).read()
        assert got == open(
            os.path.join(ref_dir, "ref.sp"), "rb"
        ).read()
        # the exchange directory is consumed by the protocol
        import glob as _glob

        assert not _glob.glob(
            os.path.join(root, "jobs", jid, "gang-*")
        )
        # rollup counts the gang completion
        from peasoup_tpu_torch.campaign.rollup import build_status

        assert build_status(root, q)["gang_jobs"] == 1

    def test_unassembled_gang_releases_cleanly(self, tmp_path):
        """A leader whose group never joins releases the claim with
        ZERO attempts consumed (assembly timeout, not failure)."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            CampaignRunner,
            bucket_for_input,
            save_campaign_config,
        )

        root = str(tmp_path)
        path = _write_obs(os.path.join(root, "obs.fil"))
        save_campaign_config(
            root,
            CampaignConfig(
                pipeline="spsearch",
                config=dict(dm_end=20.0, n_widths=6),
                warmup=False, gang_assemble_s=0.3,
            ),
        )
        q = JobQueue(root)
        jid = job_id_for(path)
        q.add_job(
            Job(
                job_id=jid, input=path, pipeline="spsearch",
                bucket=bucket_for_input(path), nprocs=2,
            )
        )
        runner = CampaignRunner(root, device="cpu", worker_id="gl", group="pod")
        runner.registry.register("gl", group="pod")
        # a second member is LIVE in the registry (so the leader
        # claims) but never actually joins the exchange
        runner.registry.register("zz-ghost", group="pod")
        claim = q.claim_next(
            "gl", group="pod", group_members=["gl", "zz-ghost"]
        )
        assert claim is not None and claim.gang
        assert runner.process_claim(claim) == "released"
        job = q.get_job(jid)
        assert job.attempts == 0
        assert q.state(jid) == "pending"

    def test_gang_member_death_fails_transiently_one_attempt(
        self, tmp_path
    ):
        """A member that joins and then dies mid-run: the leader's
        next barrier times out TRANSIENT and the job requeues as one
        consumed attempt."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            CampaignRunner,
            bucket_for_input,
            save_campaign_config,
        )
        from peasoup_tpu_torch.parallel.multihost import GangComm

        root = str(tmp_path)
        path = _write_obs(os.path.join(root, "obs.fil"))
        save_campaign_config(
            root,
            CampaignConfig(
                pipeline="spsearch",
                config=dict(dm_end=20.0, n_widths=6),
                warmup=False, gang_assemble_s=5.0, gang_timeout_s=1.0,
            ),
        )
        q = JobQueue(root)
        jid = job_id_for(path)
        q.add_job(
            Job(
                job_id=jid, input=path, pipeline="spsearch",
                bucket=bucket_for_input(path), nprocs=2,
            )
        )
        runner = CampaignRunner(root, device="cpu", worker_id="gl", group="pod")
        runner.registry.register("gl", group="pod")
        runner.registry.register("zz-dying", group="pod")
        claim = q.claim_next(
            "gl", group="pod", group_members=["gl", "zz-dying"]
        )
        assert claim is not None and claim.gang

        # the dying member: joins the assembly barrier, then vanishes
        def half_member():
            comm = GangComm(
                os.path.join(
                    root, "jobs", jid, f"gang-{claim.gang['epoch']}"
                ),
                nprocs=2,
                rank=claim.gang["members"].index("zz-dying"),
                timeout_s=10.0, poll_s=0.01,
            )
            comm.allgather(b"dying", context=f"gang-join:{jid}")
            # ... and never shows up again

        t = threading.Thread(target=half_member)
        t.start()
        state = runner.process_claim(claim)
        t.join(timeout=10)
        assert state == "backoff"  # transient: retry, not quarantine
        assert q.get_job(jid).attempts == 1


# --------------------------------------------------------------------------
# autoscale controller
# --------------------------------------------------------------------------

def _status(
    pending=0, backoff=0, stale=0, running=0, done=False,
    live=0, idle=0, throughput=None,
):
    """A synthetic campaign_status.json rollup for decide()."""
    workers = []
    for i in range(live):
        workers.append(
            {
                "worker_id": f"w{i}",
                "current_job": None if i < idle else f"job{i}",
            }
        )
    return {
        "queue": {
            "pending": pending, "backoff": backoff, "stale": stale,
            "running": running,
        },
        "fleet": {"live": workers},
        "done": done,
        "throughput_jobs_per_s": throughput,
    }


class TestAutoscaleController:
    def _controller(self, tmp_path, **policy):
        from peasoup_tpu_torch.campaign.autoscale import (
            AutoscaleController,
            AutoscalePolicy,
        )

        spawned, retired = [], []
        c = AutoscaleController(
            str(tmp_path),
            AutoscalePolicy(**policy),
            spawn=spawned.append,
            retire=retired.append,
        )
        return c, spawned, retired

    def test_never_exceeds_max_workers(self, tmp_path):
        c, _, _ = self._controller(
            tmp_path, min_workers=1, max_workers=3, cooldown_s=0.0,
            backlog_per_worker=1.0,
        )
        # huge backlog, fleet already at max: no up decision
        st = _status(pending=100, running=3, live=3)
        assert c.decide(st, now=1000.0) is None
        # below max: scales up one at a time
        st = _status(pending=100, running=2, live=2)
        d = c.decide(st, now=1000.0)
        assert d["action"] == "up"

    def test_never_retires_below_min(self, tmp_path):
        c, _, _ = self._controller(
            tmp_path, min_workers=2, max_workers=4, cooldown_s=0.0,
        )
        # empty queue, idle workers, but at the floor: no retirement
        st = _status(live=2, idle=2)
        assert c.decide(st, now=1000.0) is None
        st = _status(live=3, idle=3)
        d = c.decide(st, now=1000.0)
        assert d["action"] == "down"

    def test_cooldown_honoured(self, tmp_path):
        c, _, _ = self._controller(
            tmp_path, min_workers=1, max_workers=4, cooldown_s=30.0,
            backlog_per_worker=1.0,
        )
        c.last_action_unix = 1000.0
        st = _status(pending=50, live=1)
        assert c.decide(st, now=1010.0) is None  # in cooldown
        d = c.decide(st, now=1031.0)
        assert d and d["action"] == "up"

    def test_floor_restore_exempt_from_cooldown(self, tmp_path):
        c, _, _ = self._controller(
            tmp_path, min_workers=2, max_workers=4, cooldown_s=1e9,
        )
        c.last_action_unix = 1000.0
        st = _status(pending=1, live=1)  # below the floor
        d = c.decide(st, now=1001.0)
        assert d and d["action"] == "up"

    def test_drained_campaign_never_scales(self, tmp_path):
        c, _, _ = self._controller(
            tmp_path, min_workers=1, max_workers=4, cooldown_s=0.0,
        )
        assert c.decide(_status(done=True, live=0), now=1000.0) is None

    def test_bounds_over_synthetic_trace(self, tmp_path):
        """Drive decide() through a whole campaign arc — ramp, steady,
        drain — applying each decision to the synthetic fleet; the
        bounds hold at every step."""
        c, _, _ = self._controller(
            tmp_path, min_workers=1, max_workers=3, cooldown_s=10.0,
            backlog_per_worker=1.0,
        )
        live, t = 1, 0.0
        trace = []
        for step in range(60):
            t += 5.0
            backlog = max(0, 40 - step)
            st = _status(
                pending=backlog, running=min(live, backlog),
                live=live, idle=max(0, live - backlog),
            )
            d = c.decide(st, now=t)
            if d is not None:
                c.last_action_unix = t  # decide() is pure: apply here
                live += 1 if d["action"] == "up" else -1
                trace.append((t, d["action"], live))
            assert 1 <= live <= 3, trace
        assert any(a == "up" for _, a, _ in trace)
        assert any(a == "down" for _, a, _ in trace)

    def test_step_logs_decisions_into_rollup(self, tmp_path, monkeypatch):
        """step() acts and persists the decision log; the campaign
        rollup embeds it."""
        import peasoup_tpu_torch.campaign.autoscale as autoscale_mod

        c, spawned, _ = self._controller(
            tmp_path, min_workers=1, max_workers=4, cooldown_s=0.0,
            backlog_per_worker=1.0,
        )
        monkeypatch.setattr(
            autoscale_mod, "build_status",
            lambda root: _status(pending=10, live=1),
        )
        d = c.step(now=2000.0)
        assert d["action"] == "up" and spawned == [d["worker_id"]]
        from peasoup_tpu_torch.campaign.rollup import build_status

        st = build_status(str(tmp_path))
        assert st["autoscale"]["decisions"][0]["action"] == "up"
        assert st["autoscale"]["spawned_total"] == 1

    def test_inverted_bounds_rejected(self, tmp_path):
        from peasoup_tpu_torch.campaign.autoscale import (
            AutoscaleController,
            AutoscalePolicy,
        )

        with pytest.raises(ValueError, match="inverted"):
            AutoscaleController(
                str(tmp_path),
                AutoscalePolicy(min_workers=5, max_workers=2),
            )

    def test_retire_marker_honoured_between_jobs(self, tmp_path):
        """Scale-down: a worker observing its retire marker leaves the
        fleet cleanly — deregistered, marker consumed."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            run_worker,
            save_campaign_config,
        )

        root = str(tmp_path)
        save_campaign_config(
            root, CampaignConfig(warmup=False)
        )
        q = JobQueue(root)
        # one job stuck in backoff far in the future: the worker idles
        q.add_job(
            Job(
                job_id="j", input="x.fil",
                next_eligible_unix=time.time() + 3600,
            )
        )
        reg = WorkerRegistry(root)
        out = {}

        def work():
            out["tally"] = run_worker(root, device="cpu", worker_id="r1", poll_s=0.05
            )

        t = threading.Thread(target=work)
        t.start()
        deadline = time.monotonic() + 20
        while not reg.live() and time.monotonic() < deadline:
            time.sleep(0.01)
        reg.request_retire("r1", requester="test")
        t.join(timeout=30)
        assert not t.is_alive(), "worker ignored the retire request"
        assert reg.entries() == []  # deregistered
        assert reg.retire_requested("r1") is None  # marker consumed


# --------------------------------------------------------------------------
# elastic membership scenarios
# --------------------------------------------------------------------------

class TestElasticMembership:
    def test_late_joiner_prefers_warm_bucket(self, tmp_path):
        """Satellite: a worker joining mid-campaign claims warm-bucket
        jobs first — the done records other workers left behind carry
        the warm hint, and the joiner's claim ranking uses it."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            CampaignRunner,
            save_campaign_config,
        )

        root = str(tmp_path)
        save_campaign_config(root, CampaignConfig(warmup=False))
        q = JobQueue(root)
        warm = (8, 8, 4096)
        cold = (16, 8, 8192)
        # FIFO would pick the cold job (earlier id); the warm hint
        # from a finished peer's done record must override
        q.add_job(Job(job_id="a-cold", input="a.fil", bucket=cold))
        q.add_job(Job(job_id="b-warm", input="b.fil", bucket=warm))
        q.add_job(Job(job_id="c-done", input="c.fil", bucket=warm))
        peer = q.try_claim("c-done", "old-worker")
        q.complete(peer, bucket=list(warm), warmup_s=1.25)

        joiner = CampaignRunner(root, device="cpu", worker_id="late-joiner")
        assert tuple(warm) in joiner._warm_bucket_hint()
        claim = q.claim_next(
            "late-joiner", warm_buckets=joiner._warm_bucket_hint()
        )
        assert claim.job.job_id == "b-warm"

    def test_sigkilled_worker_reaped_and_requeued_exactly_once(
        self, tmp_path
    ):
        """Satellite: a REAL subprocess registers, claims a job, and
        is SIGKILLed holding it. The lease expires, the claim reap
        consumes exactly one attempt, and the registry reap removes
        the corpse's membership entry."""
        root = str(tmp_path)
        q = JobQueue(root, lease_s=0.5)
        q.add_job(Job(job_id="j", input="x.fil"))
        script = (
            "import sys, time\n"
            "from peasoup_tpu_torch.campaign.queue import JobQueue\n"
            "from peasoup_tpu_torch.campaign.registry import WorkerRegistry\n"
            "root = sys.argv[1]\n"
            "q = JobQueue(root, lease_s=0.5)\n"
            "WorkerRegistry(root, lease_s=0.5).register('victim')\n"
            "claim = q.claim_next('victim')\n"
            "assert claim is not None\n"
            "print('CLAIMED', flush=True)\n"
            "time.sleep(60)\n"
        )
        proc = subprocess.Popen(
            [sys.executable, "-c", script, root],
            stdout=subprocess.PIPE,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        try:
            line = proc.stdout.readline().decode()
            assert "CLAIMED" in line, line
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert q.state("j") in ("running", "stale")  # corpse holds it
        time.sleep(0.6)  # lease expires
        assert q.reap_stale() == ["j"]
        assert q.reap_stale() == []  # exactly once
        job = q.get_job("j")
        assert job.attempts == 1
        assert q.state("j") in ("pending", "backoff")
        reg = WorkerRegistry(root, lease_s=0.5)
        assert reg.reap() == ["victim"]
        assert reg.entries() == []

    def test_worker_kill_leaves_registry_entry_for_peers(self, tmp_path):
        """The in-process SIGKILL model (WorkerKilled) must leave the
        membership entry behind like a real kill — peers reap it."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            run_worker,
            save_campaign_config,
        )
        from peasoup_tpu_torch.resilience import WorkerKilled

        root = str(tmp_path)
        save_campaign_config(
            root, CampaignConfig(warmup=False, lease_s=0.2)
        )
        q = JobQueue(root, lease_s=0.2)
        q.add_job(Job(job_id="j", input="/nonexistent/x.fil"))
        faults.configure("worker.kill:at=1")
        with pytest.raises(WorkerKilled):
            run_worker(root, device="cpu", worker_id="victim", poll_s=0.05)
        faults.configure(None)
        reg = WorkerRegistry(root, lease_s=0.2)
        assert [e["worker_id"] for e in reg.entries()] == ["victim"]
        time.sleep(0.25)
        assert reg.reap() == ["victim"]


# --------------------------------------------------------------------------
# fleet soak schedule + rollup fleet section
# --------------------------------------------------------------------------

class TestRollupFleetSection:
    def test_fleet_membership_and_throughput_in_rollup(self, tmp_path):
        from peasoup_tpu_torch.campaign.rollup import build_status

        root = str(tmp_path)
        q = JobQueue(root)
        reg = WorkerRegistry(root, lease_s=30.0)
        reg.register("w1")
        reg.beat("w1", jobs_done=2, current_job="j2")
        for i, t in enumerate((100.0, 200.0)):
            q.add_job(Job(job_id=f"j{i}", input=f"{i}.fil"))
            c = q.try_claim(f"j{i}", "w1")
            q.complete(c)
            # pin finished_unix for a deterministic rate
            path = q._p("done", f"j{i}")
            with open(path) as f:
                doc = json.load(f)
            doc["finished_unix"] = t
            doc["worker_id"] = "w1"
            with open(path, "w") as f:
                json.dump(doc, f)
        st = build_status(root, q)
        [live] = st["fleet"]["live"]
        assert live["worker_id"] == "w1"
        assert live["jobs_done"] == 2 and live["current_job"] == "j2"
        w1 = st["fleet"]["workers"]["w1"]
        assert w1["done"] == 2
        assert w1["jobs_per_h"] == 36.0  # 1 interval over 100 s
        assert st["degraded_jobs"] == 0
        assert st["corrupt_artifact_files"] == 0

    def test_degraded_and_corrupt_tallies(self, tmp_path):
        from peasoup_tpu_torch.campaign.rollup import build_status

        root = str(tmp_path)
        q = JobQueue(root)
        q.add_job(Job(job_id="j", input="x.fil"))
        c = q.try_claim("j", "w1")
        q.complete(c, degraded=True)
        (tmp_path / "jobs").mkdir()
        (tmp_path / "jobs" / "a.ckpt.corrupt").write_text("torn")
        st = build_status(root, q)
        assert st["degraded_jobs"] == 1
        assert st["corrupt_artifact_files"] == 1


# --------------------------------------------------------------------------
# the real thing (slow): 4 worker processes, kill + churn + skew
# --------------------------------------------------------------------------


class TestAutoscaleAgainstJax:
    """One controller trace, two packages: the same rollups, policy and
    clock give the same decisions, and the port's spawns run the port's
    CLI on the controller's device."""

    TRACE = [
        (1000.0, dict(pending=40, live=0)),
        (1001.0, dict(pending=40, running=1, live=1)),
        (1010.0, dict(pending=30, running=2, live=2, throughput=0.5)),
        (1040.0, dict(pending=20, running=2, live=2, throughput=0.5)),
        (1071.0, dict(pending=8, running=3, live=3, throughput=1.0)),
        (1102.0, dict(pending=0, running=1, live=3, idle=2, throughput=1.0)),
        (1133.0, dict(pending=0, running=0, live=2, idle=2)),
        (1164.0, dict(pending=0, running=0, live=1, idle=1)),
        (1200.0, dict(done=True, live=1, idle=1)),
    ]

    def _decisions(self, mod, root):
        spawned, retired = [], []
        c = mod.AutoscaleController(
            root, mod.AutoscalePolicy(min_workers=1, max_workers=3, cooldown_s=30.0,
                                      backlog_per_worker=4.0),
            spawn=spawned.append, retire=retired.append)
        out = []
        for now, kw in self.TRACE:
            d = c.decide(_status(**kw), now=now)
            if d is not None:
                c.last_action_unix = now
            out.append(None if d is None else (d["action"], d.get("reason")))
        return out

    def test_same_trace_same_decisions(self, tmp_path):
        from peasoup_tpu.campaign import autoscale as jauto
        from peasoup_tpu_torch.campaign import autoscale as tauto

        got = [self._decisions(m, str(tmp_path / name))
               for name, m in (("jax", jauto), ("port", tauto))]
        assert got[0] == got[1]
        assert any(d and d[0] == "up" for d in got[1])
        assert any(d and d[0] == "down" for d in got[1])

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_spawn_runs_the_port_cli_on_the_device(self, tmp_path, device):
        from peasoup_tpu_torch.campaign.autoscale import (
            AutoscaleController,
            spawn_command,
        )

        cmd = spawn_command(str(tmp_path), "autoscale-1", ["--no-warmup"], device)
        assert cmd[1:] == ["-m", "peasoup_tpu_torch.cli.campaign", "run", "-w",
                           str(tmp_path), "--worker-id", "autoscale-1", "--device",
                           device, "--no-warmup"]
        c = AutoscaleController(str(tmp_path), device=device)
        assert c.device == device
