"""The port's campaign queue, buckets, manifest, rollup and prune (the JAX
package's tests/test_campaign.py, class by class, on the port's modules;
its workers run on the CPU): queue semantics under racing workers,
stale-claim reaping, retry/backoff/quarantine, shape buckets, the rollup,
and the end-to-end run (2 concurrent workers over a 4-observation
manifest with one corrupt file, kernel-library reuse asserted from the
done records). Then what the port adds: ``JobQueue.complete`` publishes
its done record before it drops the claim, so no second worker claims the
job in between (the JAX order lets one: ``TestCompleteRace``), and a
queue that either package enqueued is claimed and completed by the other.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from peasoup_tpu_torch.campaign.queue import Job, JobQueue, job_id_for
from peasoup_tpu_torch.campaign.rollup import build_status, write_status
from peasoup_tpu_torch.campaign.runner import (
    CampaignConfig,
    CampaignRunner,
    bucket_for_input,
    bucket_nsamps,
    enqueue_entries,
    pad_to_nsamps,
    parse_manifest,
    save_campaign_config,
)
from peasoup_tpu_torch.io.sigproc import (
    Filterbank,
    SigprocHeader,
    read_filterbank,
    write_filterbank,
)
from peasoup_tpu_torch.plan.dm_plan import DMPlan


def make_obs(
    path, nsamps=4096, nchans=8, seed=0, tsamp=0.000256, fch1=1400.0,
    foff=-16.0, dm_end=20.0, amp=14.0,
):
    """Tiny observation with one dispersed pulse at the middle trial."""
    plan = DMPlan.create(
        nsamps=nsamps, nchans=nchans, tsamp=tsamp, fch1=fch1, foff=foff,
        dm_start=0.0, dm_end=dm_end, pulse_width=64.0, tol=1.10,
    )
    delays = plan.delay_samples()[plan.ndm // 2]
    rng = np.random.default_rng(seed)
    data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
    for c in range(nchans):
        data[1500 + delays[c] : 1504 + delays[c], c] += amp
    hdr = SigprocHeader(
        source_name=f"OBS{seed}", tsamp=tsamp, tstart=55000.0 + seed,
        fch1=fch1, foff=foff, nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    write_filterbank(
        path,
        Filterbank(
            header=hdr,
            data=np.clip(np.rint(data), 0, 255).astype(np.uint8),
        ),
    )
    return path


def make_corrupt_obs(path, donor):
    """Valid-looking start, truncated INSIDE the sigproc header — the
    reader raises 'unterminated sigproc header' deterministically."""
    with open(donor, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:40])
    return path


def enqueue_n(queue, n, bucket=(8, 8, 4096)):
    for i in range(n):
        queue.add_job(
            Job(job_id=f"job{i:02d}", input=f"/nonexistent/{i}.fil",
                bucket=bucket)
        )


# --------------------------------------------------------------------------
# queue semantics
# --------------------------------------------------------------------------

class TestQueueSemantics:
    def test_enqueue_idempotent(self, tmp_path):
        q = JobQueue(str(tmp_path))
        job = Job(job_id="a", input="x.fil")
        assert q.add_job(job) is True
        assert q.add_job(job) is False
        assert q.job_ids() == ["a"]

    def test_two_workers_race_exactly_once(self, tmp_path):
        """Two workers hammering one queue process each job exactly
        once, 20 rounds of 20 jobs: the O_EXCL claim is the only winner
        selection, and completion leaves no window for a second claim
        (the JAX package's queue fails this race now and then)."""
        shared = {"w1": 0, "w2": 0}
        for rnd in range(20):
            root = str(tmp_path / f"r{rnd}")
            q1 = JobQueue(root, lease_s=30.0)
            q2 = JobQueue(root, lease_s=30.0)
            enqueue_n(q1, 20)
            processed: dict[str, list] = {"w1": [], "w2": []}

            def worker(q, name):
                while True:
                    claim = q.claim_next(name)
                    if claim is None:
                        if q.drained():
                            return
                        time.sleep(0.005)
                        continue
                    processed[name].append(claim.job.job_id)
                    q.complete(claim)

            t1 = threading.Thread(target=worker, args=(q1, "w1"))
            t2 = threading.Thread(target=worker, args=(q2, "w2"))
            t1.start(); t2.start()
            t1.join(timeout=30); t2.join(timeout=30)
            everything = processed["w1"] + processed["w2"]
            assert sorted(everything) == sorted(set(everything)), rnd  # no dupes
            assert len(everything) == 20, rnd  # no losses
            assert q1.counts()["done"] == 20
            for name in shared:
                shared[name] += len(processed[name])
        # the work was actually shared (both won claims)
        assert shared["w1"] and shared["w2"]

    def test_stale_claim_reaped_after_sigkill(self, tmp_path):
        """A SIGKILLed worker never releases — its
        lease expires and any other worker re-queues the job (one
        failed attempt consumed)."""
        q = JobQueue(str(tmp_path), lease_s=0.1, max_attempts=5)
        enqueue_n(q, 1)
        claim = q.try_claim("job00", "doomed-worker")
        assert claim is not None
        # the doomed worker is SIGKILLed here: no release, no renewal
        assert q.state("job00") == "running"
        time.sleep(0.15)
        assert q.state("job00") == "stale"
        reaped = q.reap_stale()
        assert reaped == ["job00"]
        job = q.get_job("job00")
        assert job.attempts == 1
        assert "lease expired" in job.last_error
        assert "doomed-worker" in job.last_error
        # re-queued: another worker claims it once the backoff elapses
        time.sleep(q.backoff_base_s * 1.1)
        c2 = q.claim_next("rescuer")
        assert c2 is not None and c2.job.job_id == "job00"

    def test_renewed_claim_survives_reaper(self, tmp_path):
        q = JobQueue(str(tmp_path), lease_s=0.1)
        enqueue_n(q, 1)
        claim = q.try_claim("job00", "alive")
        time.sleep(0.12)
        q.renew(claim)  # live worker: lease fresh again
        assert q.reap_stale() == []
        assert q.state("job00") == "running"

    def test_backoff_then_quarantine_then_retry(self, tmp_path):
        """N failures land in quarantine; `retry`
        re-queues with a reset budget."""
        q = JobQueue(
            str(tmp_path), lease_s=30.0, max_attempts=3,
            backoff_base_s=0.05,
        )
        enqueue_n(q, 1)
        for attempt in range(1, 4):
            deadline = time.time() + 5
            claim = None
            while claim is None and time.time() < deadline:
                claim = q.claim_next("w")
                if claim is None:
                    time.sleep(0.01)  # exponential backoff in effect
            assert claim is not None, f"attempt {attempt} never eligible"
            state = q.fail(claim, f"boom {attempt}")
            assert state == ("quarantined" if attempt == 3 else "backoff")
        assert q.state("job00") == "quarantined"
        assert q.claim_next("w") is None  # never claimed again
        rows = q.quarantined()
        assert len(rows) == 1 and rows[0]["attempts"] == 3
        assert "boom 3" in rows[0]["last_error"]

        assert q.retry("job00") is True
        assert q.state("job00") == "pending"
        assert q.get_job("job00").attempts == 0
        assert q.claim_next("w") is not None
        # retry of a non-quarantined job is a no-op
        assert q.retry("job00") is False

    def test_backoff_is_exponential(self, tmp_path):
        q = JobQueue(
            str(tmp_path), lease_s=30.0, max_attempts=10,
            backoff_base_s=2.0,
        )
        enqueue_n(q, 1)
        delays = []
        for _ in range(3):
            jid = "job00"
            job = q.get_job(jid)
            job.next_eligible_unix = 0.0  # force eligibility
            q._record_failure(jid, "x")
            delays.append(q.get_job(jid).next_eligible_unix - time.time())
        assert delays[0] == pytest.approx(2.0, abs=0.5)
        assert delays[1] == pytest.approx(4.0, abs=0.5)
        assert delays[2] == pytest.approx(8.0, abs=0.5)

    def test_claim_next_prefers_previous_bucket(self, tmp_path):
        q = JobQueue(str(tmp_path))
        q.add_job(Job(job_id="a1", input="a1.fil", bucket=(8, 8, 1024)))
        q.add_job(Job(job_id="b1", input="b1.fil", bucket=(8, 8, 2048)))
        q.add_job(Job(job_id="a2", input="a2.fil", bucket=(8, 8, 1024)))
        c = q.claim_next("w", prefer_bucket=(8, 8, 2048))
        assert c.job.job_id == "b1"
        # with b-bucket drained, the remainder comes grouped by bucket
        c2 = q.claim_next("w", prefer_bucket=(8, 8, 2048))
        assert c2.job.bucket == (8, 8, 1024)


# --------------------------------------------------------------------------
# buckets + padding
# --------------------------------------------------------------------------

class TestBuckets:
    def test_ladder_rungs(self):
        assert bucket_nsamps(4096) == 4096
        assert bucket_nsamps(4097) == 6144  # 3 * 2048
        assert bucket_nsamps(6145) == 8192
        assert bucket_nsamps(3900) == 4096
        assert bucket_nsamps(3072) == 3072
        # worst-case padding on the default ladder (rungs at 1x and
        # 1.5x per octave) stays under 50%
        for n in range(1000, 20000, 7):
            assert n <= bucket_nsamps(n) < n * 1.5

    def test_explicit_ladder(self):
        assert bucket_nsamps(1000, [512, 2048]) == 2048
        # beyond the explicit ladder: default rungs take over
        assert bucket_nsamps(5000, [512, 2048]) == 6144

    def test_pad_to_nsamps_median_fill(self, tmp_path):
        path = make_obs(str(tmp_path / "o.fil"), nsamps=4000)
        fil = read_filterbank(path)
        padded, orig = pad_to_nsamps(fil, 4096)
        assert orig == 4000
        assert padded.nsamps == 4096
        assert padded.header.nsamples == 4096
        med = np.median(fil.data, axis=0)
        assert np.array_equal(
            padded.data[4000:],
            np.broadcast_to(
                np.rint(med).astype(np.uint8), (96, fil.nchans)
            ),
        )
        # already at (or beyond) target: untouched
        same, orig2 = pad_to_nsamps(fil, 4000)
        assert same is fil and orig2 == 4000

    def test_bucket_for_input(self, tmp_path):
        p1 = make_obs(str(tmp_path / "a.fil"), nsamps=4000)
        p2 = make_obs(str(tmp_path / "b.fil"), nsamps=3900, seed=1)
        p3 = make_obs(str(tmp_path / "c.fil"), nsamps=8192, seed=2)
        b1, b2, b3 = (bucket_for_input(p) for p in (p1, p2, p3))
        assert b1 == b2  # both pad to 4096: one compiled program set
        assert b1 != b3
        corrupt = make_corrupt_obs(str(tmp_path / "x.fil"), p1)
        assert bucket_for_input(corrupt) is None


# --------------------------------------------------------------------------
# manifest parsing
# --------------------------------------------------------------------------

class TestManifest:
    def test_paths_json_lines_comments(self, tmp_path):
        man = tmp_path / "obs.txt"
        man.write_text(
            "# survey night 1\n"
            "rel.fil\n"
            "/abs/path.fil\n"
            "\n"
            '{"input": "j.fil", "config": {"min_snr": 8.5}}\n'
        )
        entries = parse_manifest(str(man))
        assert entries[0]["input"] == str(tmp_path / "rel.fil")
        assert entries[1]["input"] == "/abs/path.fil"
        assert entries[2]["input"] == str(tmp_path / "j.fil")
        assert entries[2]["config"] == {"min_snr": 8.5}

    def test_enqueue_entries_idempotent_and_validating(self, tmp_path):
        q = JobQueue(str(tmp_path))
        entries = [{"input": str(tmp_path / "a.fil")}]
        assert enqueue_entries(q, entries, "spsearch") == 1
        assert enqueue_entries(q, entries, "spsearch") == 0
        with pytest.raises(ValueError, match="unknown pipeline"):
            enqueue_entries(
                q, [{"input": "b.fil", "pipeline": "nope"}], "spsearch"
            )

    def test_job_id_stable_and_distinct(self):
        assert job_id_for("/a/obs.fil") == job_id_for("/a/obs.fil")
        assert job_id_for("/a/obs.fil") != job_id_for("/b/obs.fil")


# --------------------------------------------------------------------------
# rollup
# --------------------------------------------------------------------------

class TestRollup:
    def test_states_and_failures_land_in_status(self, tmp_path):
        root = str(tmp_path)
        q = JobQueue(root, lease_s=30.0, max_attempts=3,
                     backoff_base_s=60.0)
        enqueue_n(q, 4)
        done = q.try_claim("job00", "w")
        q.complete(done, n_candidates=7)
        q.fail(q.try_claim("job01", "w"), "transient oops")
        running = q.try_claim("job02", "w")
        assert running is not None
        doc = write_status(root, q)
        assert doc["schema"] == "peasoup_tpu.campaign_status"
        assert doc["queue"]["total"] == 4
        assert doc["queue"]["done"] == 1
        assert doc["queue"]["running"] == 1
        assert doc["queue"]["backoff"] == 1
        assert doc["queue"]["pending"] == 1
        assert doc["done"] is False
        assert doc["candidates_total"] == 7
        assert doc["running_jobs"][0]["job_id"] == "job02"
        [fl] = doc["failures"]
        assert fl["job_id"] == "job01" and "oops" in fl["last_error"]
        # the file itself round-trips
        with open(os.path.join(root, "campaign_status.json")) as f:
            assert json.load(f) == doc

    def test_throughput_and_eta(self, tmp_path):
        root = str(tmp_path)
        q = JobQueue(root, lease_s=30.0)
        enqueue_n(q, 4)
        for i in range(2):
            q.complete(q.try_claim(f"job{i:02d}", "w"))
        # synthesise spaced finish times for a deterministic rate
        for i, t in ((0, 100.0), (1, 200.0)):
            p = os.path.join(root, "queue", "done", f"job{i:02d}.json")
            with open(p) as f:
                doc = json.load(f)
            doc["finished_unix"] = t
            with open(p, "w") as f:
                json.dump(doc, f)
        st = build_status(root, q)
        assert st["throughput_jobs_per_s"] == pytest.approx(0.01)
        assert st["eta_s"] == pytest.approx(200.0)


# --------------------------------------------------------------------------
# end-to-end acceptance
# --------------------------------------------------------------------------

class TestCampaignEndToEnd:
    def test_two_workers_four_obs_with_corruption(self, tmp_path):
        """Acceptance: a 4-observation manifest with 2 concurrent
        workers — every observation processed exactly once, the corrupt
        one quarantined after its retry budget, candidates from all
        completed jobs queryable in sqlite, and a same-bucket successor
        building no kernel library (the done records)."""
        data = tmp_path / "data"
        data.mkdir()
        # three lengths, one shape bucket (all pad to 4096)
        paths = [
            make_obs(str(data / f"obs{i}.fil"), nsamps=n, seed=i)
            for i, n in enumerate((4096, 4000, 3900))
        ]
        corrupt = make_corrupt_obs(str(data / "bad.fil"), paths[0])
        root = str(tmp_path / "camp")
        campaign = save_campaign_config(
            root,
            CampaignConfig(
                pipeline="spsearch",
                config={"dm_end": 20.0, "min_snr": 7.0, "n_widths": 6},
                lease_s=30.0,
                max_attempts=2,
                backoff_base_s=0.05,
                heartbeat_interval=0.2,
            ),
        )
        queue = JobQueue(
            root, lease_s=campaign.lease_s,
            max_attempts=campaign.max_attempts,
            backoff_base_s=campaign.backoff_base_s,
        )
        entries = [{"input": p} for p in paths + [corrupt]]
        assert enqueue_entries(queue, entries, "spsearch") == 4

        runners = [
            CampaignRunner(root, device="cpu", worker_id=f"w{i}") for i in (1, 2)
        ]
        tallies = [None, None]

        def work(i):
            tallies[i] = runners[i].run(poll_s=0.05)

        threads = [
            threading.Thread(target=work, args=(i,)) for i in range(2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(not t.is_alive() for t in threads)

        # every good observation done exactly once, corrupt quarantined
        counts = queue.counts()
        assert counts == {
            "total": 4, "pending": 0, "backoff": 0, "running": 0,
            "stale": 0, "done": 3, "quarantined": 1, "throttled": 0,
        }
        done = queue.done_records()
        assert sorted(d["job_id"] for d in done) == sorted(
            job_id_for(p) for p in paths
        )
        total_done = sum(t["done"] for t in tallies)
        assert total_done == 3  # 3 completions across both workers
        [quarantined] = queue.quarantined()
        assert quarantined["job_id"] == job_id_for(corrupt)
        assert quarantined["attempts"] == 2
        assert "unterminated sigproc header" in quarantined["last_error"]

        # kernel-library reuse under warmup: same bucket everywhere, and
        # each worker warms the bucket on a background thread before its
        # first job dispatches — so the FIRST job of the bucket reports 0
        # libraries built exactly like its warm-bucket successors
        by_finish = sorted(
            done, key=lambda d: float(d["finished_unix"])
        )
        assert all(d["bucket"] == by_finish[0]["bucket"] for d in done)
        assert by_finish[0]["jit_programs_compiled"] == 0
        assert all(d["jit_programs_compiled"] == 0 for d in done)
        # the warmup itself is on the record: the first-of-bucket job
        # of at least one worker carries its warmup stats
        warmed = [d for d in done if d.get("warmup_s") is not None]
        assert warmed, "no done record carries warmup stats"
        assert all(d["warmup_s"] > 0 for d in warmed)
        assert all(d["warmup"]["error"] is None for d in warmed)

        # per-job observability stack: heartbeat + manifest per job dir
        from peasoup_tpu_torch.obs.schema import validate_manifest
        from peasoup_tpu_torch.obs.telemetry import load_manifest

        for d in done:
            job_dir = os.path.join(root, "jobs", d["job_id"])
            man = load_manifest(os.path.join(job_dir, "telemetry.json"))
            validate_manifest(man)
            assert man["context"]["command"] == "campaign-job"
            with open(os.path.join(job_dir, "status.json")) as f:
                hb = json.load(f)
            assert hb["done"] is True
            assert os.path.exists(
                os.path.join(job_dir, "candidates.singlepulse")
            )

        # survey DB: candidates from ALL completed jobs queryable
        from peasoup_tpu_torch.campaign.db import CandidateDB

        with CandidateDB(
            os.path.join(root, "candidates.sqlite")
        ) as db:
            stats = db.counts()
            assert stats["observations"] == 3
            assert stats["candidates"]["single_pulse"] >= 3
            top = db.top_candidates(kind="single_pulse", limit=10)
            assert {t["job_id"] for t in top} == {
                job_id_for(p) for p in paths
            }
            assert all(t["snr"] >= 7.0 for t in top)
            # injected pulse lands at the same DM in every observation
            dms = {round(t["dm"], 3) for t in top[:3]}
            assert len(dms) == 1

        # rollup: schema-valid, complete, quarantine tallied, warmup
        # seconds aggregated (to the millisecond, as the rollup rounds)
        st = build_status(root, queue)
        assert st["done"] is True
        assert st["queue"]["done"] == 3
        assert [q["job_id"] for q in st["quarantined"]] == [
            job_id_for(corrupt)
        ]
        assert st["warmup_jobs"] == len(warmed)
        assert st["warmup_total_s"] == pytest.approx(
            round(sum(d["warmup_s"] for d in warmed), 3)
        )

        # retry re-queues the quarantined job and a worker re-fails it
        # back into quarantine (the input really is corrupt)
        assert queue.retry(job_id_for(corrupt))
        tally = CampaignRunner(root, device="cpu", worker_id="w3").run(poll_s=0.05)
        assert tally["quarantined"] == 1
        assert queue.counts()["quarantined"] == 1

    def test_ingest_idempotent_reingest(self, tmp_path):
        """campaign ingest: re-ingesting a job replaces, not
        duplicates, its rows."""
        from peasoup_tpu_torch.campaign.db import CandidateDB

        path = make_obs(str(tmp_path / "o.fil"))
        root = str(tmp_path / "camp")
        save_campaign_config(
            root,
            CampaignConfig(
                pipeline="spsearch",
                config={"dm_end": 20.0, "min_snr": 7.0, "n_widths": 6},
                backoff_base_s=0.05,
            ),
        )
        queue = JobQueue(root)
        enqueue_entries(queue, [{"input": path}], "spsearch")
        CampaignRunner(root, device="cpu", worker_id="w").run(poll_s=0.05)
        jid = job_id_for(path)
        db_path = os.path.join(root, "candidates.sqlite")
        with CandidateDB(db_path) as db:
            n1 = len(db.candidates_for(jid))
            assert n1 >= 1
            db.ingest_job(jid, os.path.join(root, "jobs", jid), path)
            assert len(db.candidates_for(jid)) == n1


# --------------------------------------------------------------------------
# the ffa campaign pipeline (satellite) + quarantine pruning (satellite)
# --------------------------------------------------------------------------

def make_periodic_obs(path, nsamps=1 << 14, nchans=8, tsamp=0.008, P=2.51):
    """Observation with a strong slow pulsar (no dispersion) for the
    FFA pipeline: ~50 pulses of period P over nsamps*tsamp seconds."""
    rng = np.random.default_rng(7)
    t = np.arange(nsamps) * tsamp
    pulse = 40.0 * ((t % P) / P < 0.03)
    data = np.clip(
        rng.normal(100, 6, size=(nsamps, nchans)) + pulse[:, None],
        0, 255,
    ).astype(np.uint8)
    hdr = SigprocHeader(
        source_name="FFAOBS", tsamp=tsamp, tstart=55000.0, fch1=1500.0,
        foff=-1.0, nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    write_filterbank(path, Filterbank(header=hdr, data=data))
    return path


class TestFFACampaignPipeline:
    def test_ffa_job_end_to_end(self, tmp_path):
        """Satellite: pipeline 'ffa' dispatches the FFA driver through
        the same bucket/telemetry/done-record path as the other
        pipelines — the injected pulsar comes back in candidates.ffa,
        the overview.xml parses through the existing periodicity
        reader, and the candidates ingest into the campaign DB."""
        from peasoup_tpu_torch.campaign.db import CandidateDB
        from peasoup_tpu_torch.campaign.runner import run_worker
        from peasoup_tpu_torch.obs.schema import validate_manifest
        from peasoup_tpu_torch.tools.parsers import OverviewFile

        P = 2.51
        root = str(tmp_path / "camp")
        obs = make_periodic_obs(str(tmp_path / "ffa.fil"))
        save_campaign_config(
            root,
            CampaignConfig(
                pipeline="ffa",
                warmup=False,
                config={
                    "dm_end": 5.0, "p_start": 1.0, "p_end": 6.0,
                    "min_dc": 0.01, "min_snr": 8.0,
                },
            ),
        )
        q = JobQueue(root)
        enqueue_entries(q, [{"input": obs}], "ffa")
        tally = run_worker(root, device="cpu", worker_id="w1", poll_s=0.05)
        assert tally == {
            "done": 1, "failed": 0, "quarantined": 0, "released": 0,
            "lost": 0,
        }
        jid = q.job_ids()[0]
        [done] = q.done_records()
        assert done["pipeline"] == "ffa"
        assert done["bucket"] is not None  # same shape-bucket path
        assert done["n_candidates"] >= 1
        job_dir = os.path.join(root, "jobs", jid)
        # the text table holds the injected period
        with open(os.path.join(job_dir, "candidates.ffa")) as f:
            rows = [
                ln.split() for ln in f if not ln.startswith("#")
            ]
        periods = [float(r[0]) for r in rows]
        assert any(abs(p - P) / P < 2e-3 for p in periods), periods
        # overview.xml parses through the existing periodicity reader
        ov = OverviewFile(os.path.join(job_dir, "overview.xml"))
        assert len(ov.candidates) == len(rows)
        assert any(
            abs(float(c["period"]) - P) / P < 2e-3 for c in ov.candidates
        )
        assert ov.dm_list.size >= 1
        # telemetry manifest valid, with the ffa stage timers
        with open(os.path.join(job_dir, "telemetry.json")) as f:
            man = json.load(f)
        validate_manifest(man)
        assert "ffa_search" in man["timers"]
        # ... and the DB ingested the rows as periodicity candidates
        with CandidateDB(os.path.join(root, "candidates.sqlite")) as db:
            cands = db.candidates_for(jid)
        assert len(cands) == len(rows)
        assert all(c["kind"] == "periodicity" for c in cands)

    def test_manifest_accepts_ffa_and_priority(self, tmp_path):
        obs = make_obs(str(tmp_path / "a.fil"))
        q = JobQueue(str(tmp_path / "c"))
        n = enqueue_entries(
            q,
            [{"input": obs, "pipeline": "ffa", "priority": 4}],
            "spsearch",
        )
        assert n == 1
        job = q.get_job(q.job_ids()[0])
        assert job.pipeline == "ffa"
        assert job.priority == 4

    def test_unknown_pipeline_still_rejected(self, tmp_path):
        obs = make_obs(str(tmp_path / "a.fil"))
        q = JobQueue(str(tmp_path / "c"))
        with pytest.raises(ValueError, match="unknown pipeline"):
            enqueue_entries(q, [{"input": obs, "pipeline": "nope"}], "nope")


class TestPruneCorrupt:
    def _plant(self, root, age_days=0.0):
        jobs = os.path.join(root, "jobs", "j1")
        os.makedirs(jobs, exist_ok=True)
        path = os.path.join(jobs, "search.ckpt.npz.corrupt")
        with open(path, "w") as f:
            f.write("torn bytes")
        if age_days:
            old = time.time() - age_days * 86400
            os.utime(path, (old, old))
        return path

    def test_prune_dry_run_keeps_files(self, tmp_path, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path)
        path = self._plant(root, age_days=3)
        rc = main(
            ["prune", "-w", root, "--corrupt", "--dry-run"]
        )
        assert rc == 0
        assert os.path.exists(path)
        out = capsys.readouterr().out
        assert "would delete 1" in out

    def test_prune_respects_age_filter(self, tmp_path, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path)
        old = self._plant(root, age_days=10)
        fresh = os.path.join(root, "tuning_cache.json.corrupt")
        with open(fresh, "w") as f:
            f.write("{torn")
        rc = main(
            ["prune", "-w", root, "--corrupt", "--older-than-days", "7"]
        )
        assert rc == 0
        assert not os.path.exists(old)
        assert os.path.exists(fresh)  # younger than the cutoff
        # the rollup counts what remains
        q = JobQueue(root)
        q.add_job(Job(job_id="j", input="x.fil"))
        st = build_status(root, q)
        assert st["corrupt_artifact_files"] == 1

    def test_prune_requires_a_selector(self, tmp_path, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        assert main(["prune", "-w", str(tmp_path)]) == 1
        assert "--corrupt" in capsys.readouterr().out


class TestPruneProfiles:
    """Profile-capture retention —
    `peasoup-campaign prune --profiles --older-than-days N` over the
    on-demand jax.profiler capture dirs, counted in the rollup."""

    def _plant_capture(self, root, name, age_days=0.0, nbytes=64):
        cap = os.path.join(root, "profiles", name)
        os.makedirs(cap, exist_ok=True)
        with open(os.path.join(cap, "trace.json.gz"), "wb") as f:
            f.write(b"x" * nbytes)
        if age_days:
            old = time.time() - age_days * 86400
            os.utime(cap, (old, old))
        return cap

    def test_rollup_counts_capture_dirs(self, tmp_path):
        root = str(tmp_path)
        self._plant_capture(root, "w1-100", nbytes=100)
        self._plant_capture(root, "w2-200", nbytes=50)
        q = JobQueue(root)
        q.add_job(Job(job_id="j", input="x.fil"))
        st = build_status(root, q)
        assert st["profiles"] == {"captures": 2, "bytes": 150}

    def test_prune_profiles_respects_age_and_dry_run(
        self, tmp_path, capsys
    ):
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path)
        old = self._plant_capture(root, "w1-100", age_days=10)
        fresh = self._plant_capture(root, "w1-200")
        rc = main(
            [
                "prune", "-w", root, "--profiles",
                "--older-than-days", "7", "--dry-run",
            ]
        )
        assert rc == 0
        assert os.path.isdir(old) and os.path.isdir(fresh)
        assert "would delete 1" in capsys.readouterr().out
        rc = main(
            [
                "prune", "-w", root, "--profiles",
                "--older-than-days", "7",
            ]
        )
        assert rc == 0
        assert not os.path.exists(old)
        assert os.path.isdir(fresh)  # younger than the cutoff
        q = JobQueue(root)
        q.add_job(Job(job_id="j", input="x.fil"))
        st = build_status(root, q)
        assert st["profiles"]["captures"] == 1

    def test_prune_both_selectors_compose(self, tmp_path, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path)
        cap = self._plant_capture(root, "w1-100", age_days=2)
        bad = os.path.join(root, "x.json.corrupt")
        with open(bad, "w") as f:
            f.write("{torn")
        rc = main(["prune", "-w", root, "--profiles", "--corrupt"])
        assert rc == 0
        assert not os.path.exists(cap) and not os.path.exists(bad)
        assert "deleted 2" in capsys.readouterr().out


class TestCompleteRace:
    """The JAX package's ``JobQueue.complete`` takes the claim off the
    namespace before it links the done record: between the two steps the
    job has neither marker, and a second worker's ``claim_next`` wins it
    again. The port links first. A second queue's ``claim_next`` runs at
    that point, deterministically, from inside the filesystem call."""

    @staticmethod
    def _complete_with_a_claim_in_between(tmp_path, monkeypatch, qmod):
        root = str(tmp_path)
        q1 = qmod.JobQueue(root, lease_s=30.0)
        q2 = qmod.JobQueue(root, lease_s=30.0)
        q1.add_job(qmod.Job(job_id="job00", input="/nonexistent/0.fil",
                            bucket=(8, 8, 4096)))
        claim = q1.claim_next("w1")
        assert claim is not None
        stolen = []
        real_rename, real_link = os.rename, os.link

        def racer():
            if not stolen:
                stolen.append(q2.claim_next("w2"))

        def rename(src, dst, *a, **k):
            real_rename(src, dst, *a, **k)
            if ".release." in str(dst) and str(src) == claim.path:
                racer()  # the claim just left the namespace

        def link(src, dst, *a, **k):
            racer()  # the done record is about to be published
            return real_link(src, dst, *a, **k)

        monkeypatch.setattr(os, "rename", rename)
        monkeypatch.setattr(os, "link", link)
        assert q1.complete(claim) is True
        monkeypatch.undo()
        return stolen[0], q1

    def test_jax_order_lets_a_second_worker_claim(self, tmp_path, monkeypatch):
        from peasoup_tpu.campaign import queue as jqueue

        second, q = self._complete_with_a_claim_in_between(
            tmp_path, monkeypatch, jqueue)
        assert second is not None and second.job.job_id == "job00"
        assert second.worker_id == "w2"  # the finished job runs again

    def test_port_order_leaves_no_window(self, tmp_path, monkeypatch):
        from peasoup_tpu_torch.campaign import queue as tqueue

        second, q = self._complete_with_a_claim_in_between(
            tmp_path, monkeypatch, tqueue)
        assert second is None
        assert q.state("job00") == "done"
        assert not [n for n in os.listdir(os.path.join(str(tmp_path), "queue", "claims"))
                    if n.endswith(".json")]

    def test_zombie_completer_publishes_nothing(self, tmp_path):
        # reaped while wedged, the job re-claimed: the old holder's
        # complete gets False and no done record appears
        q = JobQueue(str(tmp_path), lease_s=0.2)
        enqueue_n(q, 1)
        old = q.claim_next("w1")
        time.sleep(0.3)
        assert q.reap_stale() == ["job00"]
        q2 = JobQueue(str(tmp_path), lease_s=30.0, backoff_base_s=0.0)
        job = q2.get_job("job00")
        job.next_eligible_unix = 0.0
        from peasoup_tpu_torch.campaign.queue import _atomic_write_json

        _atomic_write_json(q2._p("jobs", "job00"), job.to_doc())
        new = q2.claim_next("w2")
        assert new is not None and new.worker_id == "w2"
        assert q.complete(old) is False
        assert q.state("job00") == "running"
        assert q2.complete(new) is True
        [done] = q2.done_records()
        assert done["worker_id"] == "w2"

    def test_finished_claim_is_never_charged(self, tmp_path):
        # a holder that published its done record and died before it
        # dropped the claim: the reaper sweeps the claim without charging
        q = JobQueue(str(tmp_path), lease_s=0.2)
        enqueue_n(q, 1)
        claim = q.claim_next("w1")
        from peasoup_tpu_torch.campaign.queue import _atomic_write_json

        _atomic_write_json(q._p("done", "job00"), {"job_id": "job00", "attempts": 1})
        time.sleep(0.3)
        assert q.reap_stale() == []
        assert not os.path.exists(claim.path)
        assert q.get_job("job00").attempts == 0
        assert q.state("job00") == "done"


class TestCrossPackageQueue:
    """One queue tree, two packages: jobs either package enqueued are
    claimed, renewed and completed by the other, and both read the same
    states and done records."""

    @pytest.mark.parametrize("writer,worker", [("jax", "port"), ("port", "jax")])
    def test_enqueue_in_one_claim_and_complete_in_the_other(self, tmp_path, writer,
                                                            worker):
        from peasoup_tpu.campaign import queue as jqueue
        from peasoup_tpu_torch.campaign import queue as tqueue

        mods = {"jax": jqueue, "port": tqueue}
        w, k = mods[writer], mods[worker]
        qw = w.JobQueue(str(tmp_path), lease_s=30.0)
        for i in range(3):
            qw.add_job(w.Job(job_id=f"job{i}", input=f"/nonexistent/{i}.fil",
                             bucket=(8, 8, 4096), priority=i, tenant="alice"))
        qk = k.JobQueue(str(tmp_path), lease_s=30.0)
        order = []
        while True:
            claim = qk.claim_next("x")
            if claim is None:
                break
            assert qk.renew(claim)
            order.append(claim.job.job_id)
            assert qk.complete(claim, n_candidates=1)
        assert order == ["job2", "job1", "job0"]  # priority first, in both
        for q in (qw, qk):
            assert q.counts()["done"] == 3 and q.drained()
        docs = {d["job_id"]: d for d in qw.done_records()}
        assert sorted(docs) == ["job0", "job1", "job2"]
        assert all(d["worker_id"] == "x" and d["n_candidates"] == 1
                   for d in docs.values())
        assert qw.get_job("job1").tenant == "alice"
