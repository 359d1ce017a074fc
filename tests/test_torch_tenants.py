"""The port's multi-tenant survey service (the JAX package's
tests/test_tenants.py, class by class, on the port's modules, its workers
on the CPU): the file-backed tenant registry and quota spec, quota-checked admission through the
submission front end (CLI/HTTP/watch-folder) with its append-only
journal, claim-time throttling (max_running and the rolling
device-seconds budget) with release, the per-tenant usage ledger,
per-tenant alert scoping/routing, journal rotation with the
restart-no-refire guarantee, the incremental sift watermark, and the
cross-tenant warm-bucket run that builds no kernel library. Then against
the JAX package: the same tenants, jobs and done records give the same
throttle map and the same usage ledger, and each package reads the
other's tenant registry and submission journal."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from peasoup_tpu_torch.campaign.ingest import (
    ingest_watch_folders,
    read_submissions,
    submit_observation,
    submissions_path,
)
from peasoup_tpu_torch.campaign.queue import Job, JobQueue, job_id_for
from peasoup_tpu_torch.campaign.rollup import build_status, write_status
from peasoup_tpu_torch.campaign.tenants import (
    Tenant,
    TenantRegistry,
    throttle_map,
    valid_tenant_name,
)
from peasoup_tpu_torch.campaign.usage import build_usage, load_usage
from peasoup_tpu_torch.obs.alerts import (
    AlertEngine,
    default_rules,
    evaluate_campaign,
    tenant_journal_path,
)
from peasoup_tpu_torch.obs.metrics import rotate_journal


def _tenant_rules():
    return [r for r in default_rules() if r.get("route") == "tenant"]


def _quota_rule():
    [r] = [r for r in _tenant_rules() if r["kind"] == "tenant_quota"]
    return r


def _done_record(root, job_id, tenant, finished, duration,
                 bytes_read=0, compiled=0, attempts=1, n_candidates=0):
    """A synthetic done record planted straight into queue/done/ —
    the raw artifact usage and the budget window are rolled from."""
    ddir = os.path.join(root, "queue", "done")
    os.makedirs(ddir, exist_ok=True)
    with open(os.path.join(ddir, f"{job_id}.json"), "w") as f:
        json.dump({
            "job_id": job_id, "tenant": tenant,
            "finished_unix": finished, "duration_s": duration,
            "bytes_read": bytes_read,
            "jit_programs_compiled": compiled,
            "attempts": attempts, "n_candidates": n_candidates,
        }, f)


def _obs_file(tmp_path, name="obs.fil", seed=0):
    from test_torch_campaign_queue import make_obs

    return make_obs(str(tmp_path / name), nsamps=4096, seed=seed)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

class TestTenantRegistry:
    def test_create_mints_token_and_collides_o_excl(self, tmp_path):
        reg = TenantRegistry(str(tmp_path))
        t = reg.create(Tenant(name="alice", max_running=2))
        assert t.token and len(t.token) == 32
        with pytest.raises(FileExistsError):
            reg.create(Tenant(name="alice"))
        got = reg.get("alice")
        assert got.max_running == 2 and got.token == t.token

    def test_by_token_constant_time_lookup(self, tmp_path):
        reg = TenantRegistry(str(tmp_path))
        a = reg.create(Tenant(name="alice"))
        reg.create(Tenant(name="bob"))
        assert reg.by_token(a.token).name == "alice"
        assert reg.by_token("") is None
        assert reg.by_token("not-a-token") is None

    def test_update_and_remove(self, tmp_path):
        reg = TenantRegistry(str(tmp_path))
        t = reg.create(Tenant(name="alice"))
        t.max_queued = 7
        reg.update(t)
        assert reg.get("alice").max_queued == 7
        assert reg.remove("alice") is True
        assert reg.get("alice") is None
        assert reg.remove("alice") is False

    def test_names_are_filesystem_safe(self, tmp_path):
        assert valid_tenant_name("survey-A_2")
        for bad in ("", "a/b", "..", ".hidden", "a.b",
                    "x" * 49, "a b"):
            assert not valid_tenant_name(bad)
        with pytest.raises(ValueError):
            TenantRegistry(str(tmp_path)).create(Tenant(name="a/b"))


# --------------------------------------------------------------------------
# admission + journal
# --------------------------------------------------------------------------

class TestAdmission:
    def test_every_decision_is_journaled(self, tmp_path):
        root = str(tmp_path / "camp")
        reg = TenantRegistry(root)
        reg.create(Tenant(name="alice", max_queued=1, priority_max=2))
        obs = _obs_file(tmp_path, "a0.fil")
        obs2 = _obs_file(tmp_path, "a1.fil")

        # unknown tenant
        e = submit_observation(root, "nobody", obs)
        assert not e["accepted"] and "unknown tenant" in e["reason"]
        # missing input
        e = submit_observation(root, "alice", str(tmp_path / "no.fil"))
        assert not e["accepted"] and "not found" in e["reason"]
        # accepted, priority clamped to the ceiling (never rejected)
        e = submit_observation(root, "alice", obs, priority=9)
        assert e["accepted"] and e["priority_capped"]
        assert e["priority"] == 2
        q = JobQueue(root)
        job = q.get_job(e["job_id"])
        assert job.tenant == "alice" and job.priority == 2
        # duplicate
        e = submit_observation(root, "alice", obs)
        assert not e["accepted"] and "duplicate" in e["reason"]
        # max_queued ceiling
        e = submit_observation(root, "alice", obs2)
        assert not e["accepted"] and "max_queued" in e["reason"]

        journal = read_submissions(root)
        assert len(journal) == 5
        assert [j["accepted"] for j in journal] == [
            False, False, True, False, False,
        ]
        assert all(j["via"] == "cli" and "t_unix" in j for j in journal)

    def test_torn_journal_tail_is_skipped(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(name="alice"))
        submit_observation(root, "alice", "/nope.fil")
        with open(submissions_path(root), "a") as f:
            f.write('{"torn": ')
        assert len(read_submissions(root)) == 1

    def test_watch_folder_submits_fresh_drops_silently_skips_known(
        self, tmp_path
    ):
        root = str(tmp_path / "camp")
        wdir = tmp_path / "drop"
        wdir.mkdir()
        TenantRegistry(root).create(
            Tenant(name="alice", watch_dir=str(wdir))
        )
        obs = _obs_file(wdir, "fresh.fil")
        (wdir / "notes.txt").write_text("ignored")
        out = ingest_watch_folders(root)
        assert [e["accepted"] for e in out] == [True]
        assert out[0]["via"] == "watch"
        assert JobQueue(root).get_job(job_id_for(obs)) is not None
        # the second poll sees nothing new and journals NOTHING
        n = len(read_submissions(root))
        assert ingest_watch_folders(root) == []
        assert len(read_submissions(root)) == n

    def test_cli_ingest_folder_door(self, tmp_path, capsys):
        # drive the actual CLI entry point (one-shot and bounded-poll
        # modes), not just the library function behind it
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path / "camp")
        wdir = tmp_path / "drop"
        wdir.mkdir()
        TenantRegistry(root).create(
            Tenant(name="alice", watch_dir=str(wdir))
        )
        obs = _obs_file(wdir, "fresh.fil")
        assert main(["ingest-folder", "-w", root]) == 0
        assert "accepted" in capsys.readouterr().out
        assert JobQueue(root).get_job(job_id_for(obs)) is not None
        assert main([
            "ingest-folder", "-w", root,
            "--poll", "0.05", "--max-runtime", "0.15",
        ]) == 0


# --------------------------------------------------------------------------
# claim-time throttling
# --------------------------------------------------------------------------

class TestThrottle:
    def test_max_running_parks_then_releases(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(name="alice", max_running=1))
        q = JobQueue(root)
        for i in range(2):
            q.add_job(Job(job_id=f"j{i}", input=f"/x{i}.fil",
                          tenant="alice"))
        t0 = time.time()
        c = q.try_claim("j0", "w1", now=t0)
        assert c is not None
        # past the throttle cache TTL: the second job parks
        t1 = t0 + 0.6
        assert q.try_claim("j1", "w2", now=t1) is None
        assert q.state("j1", now=t1) == "throttled"
        assert q.counts()["throttled"] == 1
        # completion frees the slot; the parked job claims
        q.complete(c, duration_s=0.1)
        t2 = t0 + 1.2
        assert q.state("j1", now=t2) == "pending"
        assert q.try_claim("j1", "w2", now=t2) is not None

    def test_claim_revalidation_excludes_own_unwritten_claim(
        self, tmp_path
    ):
        # a tenant with max_running=1 and ONE job: the winner's own
        # in-flight claim must not count against the quota
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(name="alice", max_running=1))
        q = JobQueue(root)
        q.add_job(Job(job_id="j0", input="/x.fil", tenant="alice"))
        assert q.try_claim("j0", "w1") is not None

    def test_device_seconds_budget_slides(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(
            name="alice", device_seconds=10.0, window_s=100.0,
        ))
        now = 1_000_000.0
        _done_record(root, "old", "alice", now - 50.0, 20.0)
        m = throttle_map(root, now=now)
        assert m["alice"]["quota"] == "device_seconds"
        assert m["alice"]["spent_device_s"] == 20.0
        # the window slides past the spend: throttle releases
        assert throttle_map(root, now=now + 200.0) == {}
        # another tenant is unaffected
        TenantRegistry(root).create(Tenant(
            name="bob", device_seconds=10.0, window_s=100.0,
        ))
        assert "bob" not in throttle_map(root, now=now)

    def test_unlimited_tenant_never_throttles(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(name="alice"))
        now = 1_000_000.0
        _done_record(root, "d0", "alice", now - 1.0, 9999.0)
        assert throttle_map(root, now=now) == {}


# --------------------------------------------------------------------------
# usage ledger
# --------------------------------------------------------------------------

class TestUsageLedger:
    def test_totals_roll_from_done_records(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(
            name="alice", device_seconds=100.0, window_s=50.0,
        ))
        now = 1_000_000.0
        _done_record(root, "d0", "alice", now - 10.0, 3.0,
                     bytes_read=100, compiled=5, attempts=2,
                     n_candidates=7)
        _done_record(root, "d1", "alice", now - 200.0, 4.0,
                     bytes_read=50, compiled=0, n_candidates=1)
        doc = build_usage(root, now=now)
        u = doc["tenants"]["alice"]
        assert u["jobs_done"] == 2
        assert u["device_seconds"] == 7.0
        assert u["bytes_read"] == 150
        assert u["jit_programs_compiled"] == 5
        assert u["candidates"] == 8
        # d0 took 2 attempts: one was a failure
        assert u["jobs_failed"] == 1
        # the rolling window only sees d0 (d1 is 200s old, window 50s)
        assert u["window"]["device_seconds"] == 3.0
        assert u["window"]["budget"] == 100.0

    def test_unregistered_stamp_still_accounts(self, tmp_path):
        root = str(tmp_path / "camp")
        os.makedirs(os.path.join(root, "queue"), exist_ok=True)
        _done_record(root, "d0", "ghost", 1.0, 2.0)
        doc = build_usage(root)
        assert doc["tenants"]["ghost"]["jobs_done"] == 1

    def test_write_usage_rides_the_rollup(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(name="alice"))
        q = JobQueue(root)
        q.add_job(Job(job_id="j0", input="/x.fil", tenant="alice"))
        _done_record(root, "j0", "alice", time.time(), 1.5)
        st = write_status(root, queue=q)
        assert "alice" in st["tenants"]
        ledger = load_usage(root)
        assert ledger["tenants"]["alice"]["device_seconds"] == 1.5

    def test_rollup_tenants_section_counts_states(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(name="alice", max_running=1))
        q = JobQueue(root)
        for i in range(3):
            q.add_job(Job(job_id=f"j{i}", input=f"/x{i}.fil",
                          tenant="alice"))
        assert q.try_claim("j0", "w1") is not None
        time.sleep(0.6)  # past the throttle cache TTL
        st = build_status(root, queue=JobQueue(root))
        rec = st["tenants"]["alice"]
        assert rec["running"] == 1
        assert rec["throttled"] == 2
        assert rec["throttle"] and "max_running" in rec["throttle"]
        assert rec["quota"]["max_running"] == 1

    def test_pre_tenant_rollup_schema_tolerated(self, tmp_path):
        from peasoup_tpu_torch.tools.watch import render_campaign_status

        # a status doc written before the tenants/usage sections
        out = render_campaign_status({"queue": {"total": 1, "done": 1}})
        assert "tenants" not in out
        out = render_campaign_status({
            "queue": {"total": 2, "done": 0, "throttled": 2},
            "tenants": {"alice": {
                "queued": 0, "throttled": 2,
                "window_device_s": 5.0, "device_s_budget": 10.0,
                "throttle": "max_running reached (1/1)",
            }},
            "usage": {"alice": {"jobs_failed": 3}},
        })
        assert "throttled=2" in out
        assert "alice" in out and "THROTTLED" in out
        assert "dev-s 5.0/10" in out and "failed=3" in out


# --------------------------------------------------------------------------
# per-tenant alert scoping + routing
# --------------------------------------------------------------------------

class TestAlertRouting:
    def _findings(self, *names):
        return [
            {"labels": {"tenant": n}, "value": 1.0,
             "message": f"{n} over quota"}
            for n in names
        ]

    def test_quota_rule_fires_per_tenant_and_routes(self, tmp_path):
        root = str(tmp_path)
        eng = AlertEngine(root, rules=[_quota_rule()])
        s = eng.evaluate(samples={}, now=100.0,
                         tenant_findings=self._findings("alice", "bob"))
        by_tenant = {
            a["labels"]["tenant"]: a["state"] for a in s["alerts"]
        }
        assert by_tenant == {"alice": "firing", "bob": "firing"}
        # each tenant got its own journal, beside the fleet journal
        for name in ("alice", "bob"):
            lines = [
                json.loads(ln) for ln in
                open(tenant_journal_path(root, name))
            ]
            assert [t["to"] for t in lines] == ["pending", "firing"]
            assert all(
                t["labels"]["tenant"] == name for t in lines
            )
        fleet = open(os.path.join(root, "queue", "alerts.jsonl")).read()
        assert fleet.count('"to":"firing"') == 2
        # release: resolution routes too
        s = eng.evaluate(samples={}, now=200.0,
                         tenant_findings=self._findings("bob"))
        states = {
            a["labels"]["tenant"]: a["state"] for a in s["alerts"]
        }
        assert states["alice"] == "resolved"
        assert states["bob"] == "firing"
        lines = [
            json.loads(ln) for ln in
            open(tenant_journal_path(root, "alice"))
        ]
        assert [t["to"] for t in lines] == [
            "pending", "firing", "resolved",
        ]

    def test_evaluate_campaign_derives_quota_findings(self, tmp_path):
        root = str(tmp_path / "camp")
        TenantRegistry(root).create(Tenant(name="alice", max_running=1))
        q = JobQueue(root)
        q.add_job(Job(job_id="j0", input="/x.fil", tenant="alice"))
        assert q.try_claim("j0", "w1") is not None
        snap = evaluate_campaign(root)
        hits = [
            a for a in snap["alerts"]
            if a["rule"] == "tenant_quota_exhausted"
        ]
        assert len(hits) == 1
        assert hits[0]["labels"]["tenant"] == "alice"
        assert hits[0]["state"] == "firing"
        assert os.path.exists(tenant_journal_path(root, "alice"))

    def test_tenant_burn_rate_groups_by_label(self, tmp_path):
        [rule] = [
            r for r in _tenant_rules() if r["kind"] == "burn_rate"
        ]
        eng = AlertEngine(str(tmp_path), rules=[rule])

        def counter(t, name, value, tenant):
            return {"t": t, "kind": "counter", "name": name,
                    "value": value, "labels": {"tenant": tenant}}

        now = 10_000.0
        samples = {"w0": []}
        for i, t in enumerate(
            [now - 1700 + 100 * k for k in range(17)]
        ):
            # alice burns (every job fails); bob is healthy
            samples["w0"].append(
                counter(t, "jobs_failed_total", float(i), "alice"))
            samples["w0"].append(
                counter(t, "jobs_done_total", 0.0, "alice"))
            samples["w0"].append(
                counter(t, "jobs_failed_total", 0.0, "bob"))
            samples["w0"].append(
                counter(t, "jobs_done_total", float(i), "bob"))
        s = eng.evaluate(samples=samples, now=now)
        assert [
            (a["labels"]["tenant"], a["state"]) for a in s["alerts"]
        ] == [("alice", "firing")]
        assert "[tenant=alice]" in s["alerts"][0]["message"]


# --------------------------------------------------------------------------
# journal rotation + restart-no-refire
# --------------------------------------------------------------------------

class TestJournalRotation:
    def test_rotation_keeps_newest_complete_lines(self, tmp_path):
        path = str(tmp_path / "j.jsonl")
        with open(path, "w") as f:
            for i in range(200):
                f.write(json.dumps({"i": i, "pad": "x" * 90}) + "\n")
        size = os.path.getsize(path)
        assert rotate_journal(path, max_bytes=size + 1) is False
        assert rotate_journal(path, max_bytes=size // 2) is True
        kept = [json.loads(ln) for ln in open(path)]
        assert kept  # tail survived
        assert kept[-1]["i"] == 199  # newest line kept
        assert kept[0]["i"] > 0  # oldest rotated away
        assert [r["i"] for r in kept] == list(
            range(kept[0]["i"], 200)
        )  # contiguous: no torn line at the cut

    def test_rotation_is_restart_no_refire_safe(self, tmp_path):
        root = str(tmp_path)
        rule = _quota_rule()
        eng = AlertEngine(root, rules=[rule])
        findings = [{"labels": {"tenant": "alice"}, "value": 1.0,
                     "message": "over"}]
        eng.evaluate(samples={}, now=100.0, tenant_findings=findings)
        fleet = os.path.join(root, "queue", "alerts.jsonl")
        tj = tenant_journal_path(root, "alice")
        assert rotate_journal(fleet, max_bytes=1, keep_bytes=1) is True
        assert rotate_journal(tj, max_bytes=1, keep_bytes=1) is True
        # a fresh engine (restart) restores state from the SNAPSHOT,
        # not the journal: the still-true condition must not re-fire
        eng2 = AlertEngine(root, rules=[rule])
        s = eng2.evaluate(samples={}, now=200.0,
                          tenant_findings=findings)
        assert s["alerts"][0]["state"] == "firing"
        assert open(fleet).read().count('"to":"firing"') == 0
        assert open(tj).read().count('"to":"firing"') == 0

    def test_prune_journals_cli(self, tmp_path):
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path / "camp")
        qdir = os.path.join(root, "queue")
        os.makedirs(qdir)
        names = ("alerts.jsonl", "submissions.jsonl",
                 "alerts.alice.jsonl")
        for name in names:
            with open(os.path.join(qdir, name), "w") as f:
                for i in range(2000):
                    f.write(json.dumps({"i": i, "pad": "x" * 30})
                            + "\n")
        rc = main(["prune", "-w", root, "--journals",
                   "--max-bytes", "8192"])
        assert rc == 0
        for name in names:
            assert 0 < os.path.getsize(
                os.path.join(qdir, name)
            ) <= 8192


# --------------------------------------------------------------------------
# submission portal
# --------------------------------------------------------------------------

class TestSubmissionPortal:
    N_REQUESTS = 12

    @pytest.fixture()
    def portal(self, tmp_path):
        import socket

        from peasoup_tpu_torch.obs.portal import serve_portal

        root = str(tmp_path / "camp")
        reg = TenantRegistry(root)
        alice = reg.create(Tenant(name="alice", priority_max=1))
        _done_record(root, "d0", "alice", time.time(), 2.0)
        # the obs sits inside the portal's --data-root; anything
        # outside it (tmp_path itself) must bounce off confinement
        (tmp_path / "stage").mkdir()
        obs = _obs_file(tmp_path / "stage")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        srv = threading.Thread(
            target=serve_portal, args=(root,),
            kwargs={
                "port": port,
                "max_requests": self.N_REQUESTS,
                "data_roots": [str(tmp_path / "stage")],
            },
            daemon=True,
        )
        srv.start()
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(base + "/usage", timeout=2)
                break
            except OSError:
                time.sleep(0.05)
        yield base, root, alice, obs
        for _ in range(self.N_REQUESTS):
            if not srv.is_alive():
                break
            try:
                urllib.request.urlopen(base + "/usage", timeout=1)
            except OSError:
                break
            srv.join(timeout=0.2)
        srv.join(timeout=5)

    def _post(self, base, body, token=None):
        req = urllib.request.Request(
            base + "/submit", data=json.dumps(body).encode(),
            headers={"Authorization": f"Bearer {token}"} if token
            else {},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read() or b"{}")

    def test_submit_and_tenant_pages(self, portal, tmp_path):
        base, root, alice, obs = portal
        # no/bad token -> 401, nothing journaled
        code, _ = self._post(base, {"input": obs})
        assert code == 401
        code, _ = self._post(base, {"input": obs}, token="wrong")
        assert code == 401
        assert read_submissions(root) == []
        # a real, readable file OUTSIDE the data-root/watch_dir
        # allowlist -> 403 (confinement, not existence), journaled as
        # a rejection so the audit trail shows the attempt
        outside = _obs_file(tmp_path, "outside.fil", seed=1)
        code, entry = self._post(
            base, {"input": outside}, token=alice.token
        )
        assert code == 403 and not entry["accepted"]
        assert "data-root" in entry["reason"]
        assert JobQueue(root).get_job(job_id_for(outside)) is None
        # authenticated: accepted, journaled via=http, priority capped
        code, entry = self._post(
            base, {"input": obs, "priority": 5}, token=alice.token
        )
        assert code == 200 and entry["accepted"]
        assert entry["via"] == "http" and entry["priority_capped"]
        job = JobQueue(root).get_job(entry["job_id"])
        assert job.tenant == "alice" and job.priority == 1
        # duplicate -> 409, malformed -> 400
        code, entry = self._post(base, {"input": obs},
                                 token=alice.token)
        assert code == 409 and "duplicate" in entry["reason"]
        code, _ = self._post(base, {"nope": 1}, token=alice.token)
        assert code == 400
        assert len(read_submissions(root)) == 3

        with urllib.request.urlopen(base + "/tenants", timeout=5) as r:
            body = r.read().decode()
        assert "alice" in body and "/tenants/alice" in body
        with urllib.request.urlopen(
            base + "/tenants/alice", timeout=5
        ) as r:
            page = r.read().decode()
        assert "priority_max" in page and "jobs_done" in page
        with urllib.request.urlopen(base + "/usage", timeout=5) as r:
            ledger = json.loads(r.read())
        assert ledger["tenants"]["alice"]["device_seconds"] == 2.0

    def test_unknown_tenant_page_is_404(self, portal):
        base, _, _, _ = portal
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                base + "/tenants/../../etc", timeout=5
            )
        assert exc.value.code == 404


# --------------------------------------------------------------------------
# incremental sift watermark
# --------------------------------------------------------------------------

class TestIncrementalSift:
    def _seed(self, tmp_path):
        from test_sift import seed_campaign

        return seed_campaign(tmp_path)

    def test_noop_until_new_observations_land(self, tmp_path, capsys):
        from peasoup_tpu_torch.campaign.db import CandidateDB
        from peasoup_tpu_torch.cli.sift import main

        camp = self._seed(tmp_path)
        db_path = str(camp / "candidates.sqlite")
        assert main(["run", "-w", str(camp), "--no-fold", "--device", "cpu"]) == 0
        with CandidateDB(db_path) as db:
            run1 = db.latest_sift_run()
            wm = json.loads(run1["config"])["watermark_rowid"]
            assert wm == db.max_observation_rowid() > 0

        # no new observations: --incremental exits 0 touching nothing
        report = camp / "sift"
        before = {
            p: os.path.getmtime(p)
            for p in [str(f) for f in report.rglob("*")]
        }
        assert main(
            ["run", "-w", str(camp), "--no-fold", "--incremental", "--device", "cpu"]
        ) == 0
        assert "nothing to do" in capsys.readouterr().out
        with CandidateDB(db_path) as db:
            # the run row is untouched (latest run wins wholesale, and
            # a no-op must not replace it)
            assert db.latest_sift_run()["run_id"] == run1["run_id"]
        after = {
            p: os.path.getmtime(p)
            for p in [str(f) for f in report.rglob("*")]
        }
        assert after == before

        # one new observation: the incremental run re-sifts
        with CandidateDB(db_path) as db:
            db._conn.execute(
                "INSERT INTO observations (job_id, input, source_name,"
                " tstart, tsamp, nchans, nsamps, ingested_unix) "
                "VALUES ('jobN', '/new.fil', 'NEW', 55002.0, "
                "0.000256, 8, 4096, 0.0)"
            )
            db._conn.commit()
        assert main(
            ["run", "-w", str(camp), "--no-fold", "--incremental", "--device", "cpu"]
        ) == 0
        with CandidateDB(db_path) as db:
            run2 = db.latest_sift_run()
            assert run2["run_id"] != run1["run_id"]
            new_wm = json.loads(run2["config"])["watermark_rowid"]
            assert new_wm > wm

    def test_reingest_bumps_the_watermark(self, tmp_path):
        # INSERT OR REPLACE gives a re-ingested observation a fresh
        # rowid: re-running a job counts as new data for the sift
        from peasoup_tpu_torch.campaign.db import CandidateDB

        camp = self._seed(tmp_path)
        with CandidateDB(str(camp / "candidates.sqlite")) as db:
            before = db.max_observation_rowid()
            db._conn.execute(
                "INSERT OR REPLACE INTO observations (job_id, input) "
                "VALUES ('job0', '/re.fil')"
            )
            db._conn.commit()
            assert db.max_observation_rowid() > before


# --------------------------------------------------------------------------
# cross-tenant warm state
# --------------------------------------------------------------------------

class TestCrossTenantWarmState:
    def test_second_tenant_in_warm_bucket_compiles_nothing(
        self, tmp_path
    ):
        """Two tenants submit same-bucket observations through the
        front end; one worker runs both. The second job lands in the
        already-warm bucket and must compile ZERO new XLA programs —
        tenancy is an accounting boundary, not a compilation one."""
        from peasoup_tpu_torch.campaign.runner import (
            CampaignConfig,
            CampaignRunner,
            save_campaign_config,
        )

        root = str(tmp_path / "camp")
        reg = TenantRegistry(root)
        reg.create(Tenant(name="alice"))
        reg.create(Tenant(name="bob"))
        save_campaign_config(root, CampaignConfig(
            pipeline="spsearch",
            config={"dm_end": 20.0, "min_snr": 7.0, "n_widths": 6},
            lease_s=30.0, max_attempts=2, backoff_base_s=0.05,
        ))
        # same nchans/nbits and padded nsamps -> one shape bucket
        a = _obs_file(tmp_path, "alice.fil", seed=1)
        b = _obs_file(tmp_path, "bob.fil", seed=2)
        e1 = submit_observation(root, "alice", a)
        e2 = submit_observation(root, "bob", b)
        assert e1["accepted"] and e2["accepted"]

        tally = CampaignRunner(root, device="cpu", worker_id="w1").run(poll_s=0.05)
        assert tally["done"] == 2
        done = sorted(
            JobQueue(root).done_records(),
            key=lambda d: d["finished_unix"],
        )
        assert {d["tenant"] for d in done} == {"alice", "bob"}
        # the second tenant's observation landed in the bucket the
        # first (or the warmup) already compiled: zero new XLA programs
        assert done[1]["jit_programs_compiled"] == 0
        # and the ledger slices compile counts by tenant stamp
        usage = build_usage(root)["tenants"]
        second = done[1]["tenant"]
        assert usage[second]["jit_programs_compiled"] == 0
        assert usage[second]["jobs_done"] == 1
        assert usage[second]["device_seconds"] == pytest.approx(
            done[1]["duration_s"]
        )
        assert usage[second]["bytes_read"] == os.path.getsize(
            done[1]["input"]
        )


# --------------------------------------------------------------------------
# tenant admin CLI: rotate-token / set-quota
# --------------------------------------------------------------------------

class TestTenantAdminCLI:
    def test_rotate_token_invalidates_old_immediately(
        self, tmp_path, capsys
    ):
        """Token rotation takes effect at the next by_token read: the
        registry record is the single source of truth, no cache."""
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path / "camp")
        reg = TenantRegistry(root)
        alice = reg.create(Tenant(name="alice"))
        old = alice.token
        assert main(["tenant", "rotate-token", "alice", "-w", root]) == 0
        out = capsys.readouterr().out
        assert "token rotated" in out and "invalid immediately" in out
        fresh = reg.get("alice")
        assert fresh.token != old
        assert reg.by_token(old) is None
        assert reg.by_token(fresh.token).name == "alice"
        # audited, but the secret never lands in the journal
        [entry] = [
            s for s in read_submissions(root)
            if s.get("kind") == "tenant_admin"
        ]
        assert entry["action"] == "rotate-token"
        assert entry["tenant"] == "alice"
        assert entry["token_suffix"] == fresh.token[-6:]
        journal = open(submissions_path(root)).read()
        assert fresh.token not in journal and old not in journal

    def test_rotate_token_rejected_at_portal(self, tmp_path):
        """End to end through the HTTP front door: a submission with
        the pre-rotation bearer token gets 401, the new token works."""
        import socket

        from peasoup_tpu_torch.cli.campaign import main
        from peasoup_tpu_torch.obs.portal import serve_portal

        root = str(tmp_path / "camp")
        reg = TenantRegistry(root)
        alice = reg.create(Tenant(name="alice"))
        old = alice.token
        (tmp_path / "stage").mkdir()
        obs = _obs_file(tmp_path / "stage")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        srv = threading.Thread(
            target=serve_portal, args=(root,),
            kwargs={
                "port": port, "max_requests": 4,
                "data_roots": [str(tmp_path / "stage")],
            },
            daemon=True,
        )
        srv.start()
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(base + "/usage", timeout=2)
                break
            except OSError:
                time.sleep(0.05)

        assert main(["tenant", "rotate-token", "alice", "-w", root]) == 0
        new = TenantRegistry(root).get("alice").token

        def post(token):
            req = urllib.request.Request(
                base + "/submit",
                data=json.dumps({"input": obs}).encode(),
                headers={"Authorization": f"Bearer {token}"},
                method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=5) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as exc:
                return exc.code, json.loads(exc.read() or b"{}")

        code, body = post(old)
        assert code == 401 and "token" in body.get("error", "")
        code, body = post(new)
        assert code == 200 and body["accepted"]
        srv.join(timeout=5)

    def test_set_quota_edits_only_given_flags(self, tmp_path, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path / "camp")
        reg = TenantRegistry(root)
        reg.create(Tenant(
            name="bob", max_queued=5, max_running=2,
            device_seconds=100.0, window_s=600.0, priority_max=1,
        ))
        assert main([
            "tenant", "set-quota", "bob", "-w", root,
            "--max-running", "4",
        ]) == 0
        t = reg.get("bob")
        assert t.max_running == 4
        # every other quota untouched
        assert t.max_queued == 5 and t.device_seconds == 100.0
        assert t.window_s == 600.0 and t.priority_max == 1
        # -1 clears the priority ceiling
        assert main([
            "tenant", "set-quota", "bob", "-w", root,
            "--priority-max", "-1",
        ]) == 0
        assert reg.get("bob").priority_max is None
        # no flags -> usage error, nothing changed, nothing journaled
        capsys.readouterr()
        assert main(["tenant", "set-quota", "bob", "-w", root]) == 2
        assert "no quota flags" in capsys.readouterr().err
        audits = [
            s for s in read_submissions(root)
            if s.get("kind") == "tenant_admin"
        ]
        assert len(audits) == 2
        assert audits[0]["changes"] == {"max_running": 4}

    def test_admin_actions_require_a_name(self, tmp_path, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        root = str(tmp_path / "camp")
        TenantRegistry(root)
        for action in ("rotate-token", "set-quota", "show", "remove"):
            assert main(["tenant", action, "-w", root]) == 2
            assert "name is required" in capsys.readouterr().err

    def test_portal_tenant_page_hides_admin_entries(self, tmp_path):
        """The tenant page's recent-submissions listing shows real
        submissions, not the admin audit rows (those carry no job)."""
        from peasoup_tpu_torch.cli.campaign import main
        from peasoup_tpu_torch.obs.portal import _tenant_page_body

        root = str(tmp_path / "camp")
        reg = TenantRegistry(root)
        reg.create(Tenant(name="alice"))
        obs = _obs_file(tmp_path)
        submit_observation(root, "alice", obs)
        assert main(["tenant", "rotate-token", "alice", "-w", root]) == 0
        page = _tenant_page_body(root, "alice").decode()
        assert os.path.basename(obs) in page
        assert "tenant_admin" not in page and "rotate-token" not in page


class TestAgainstJax:
    """Tenant accounting read by both packages from one campaign tree."""

    @staticmethod
    def _tree(root, tmod, qmod):
        reg = tmod.TenantRegistry(root)
        reg.create(tmod.Tenant(name="alice", max_running=1))
        reg.create(tmod.Tenant(name="bob", device_seconds=10.0, window_s=100.0))
        reg.create(tmod.Tenant(name="carol", max_queued=5))
        q = qmod.JobQueue(root)
        for i, who in enumerate(("alice", "alice", "bob", "carol", "")):
            q.add_job(qmod.Job(job_id=f"j{i}", input=f"/x{i}.fil", tenant=who))
        assert q.try_claim("j0", "w1") is not None
        now = 1_000_000.0
        _done_record(root, "d0", "bob", now - 50.0, 20.0, bytes_read=100,
                     compiled=2, attempts=2, n_candidates=3)
        _done_record(root, "d1", "carol", now - 500.0, 4.0, bytes_read=7,
                     n_candidates=1)
        _done_record(root, "d2", "ghost", now - 5.0, 1.5)
        return now

    def test_same_throttle_map_and_usage(self, tmp_path):
        from peasoup_tpu.campaign import queue as jq
        from peasoup_tpu.campaign import tenants as jt
        from peasoup_tpu.campaign import usage as ju
        from peasoup_tpu_torch.campaign import queue as tq
        from peasoup_tpu_torch.campaign import tenants as tt
        from peasoup_tpu_torch.campaign import usage as tu

        for writer_t, writer_q in ((jt, jq), (tt, tq)):
            root = str(tmp_path / writer_t.__name__.split(".")[0])
            now = self._tree(root, writer_t, writer_q)
            maps = [m.throttle_map(root, now=now) for m in (jt, tt)]
            assert maps[0] == maps[1]
            assert set(maps[1]) == {"alice", "bob"}
            docs = [m.build_usage(root, now=now) for m in (ju, tu)]
            for d in docs:
                d.pop("generated_unix", None)
            assert docs[0] == docs[1]
            assert docs[1]["tenants"]["bob"]["jobs_failed"] == 1
            queued = [m.queued_counts(root) for m in (jt, tt)]
            assert queued[0] == queued[1]

    def test_submissions_journal_and_tokens_cross_read(self, tmp_path):
        from peasoup_tpu.campaign import ingest as ji
        from peasoup_tpu.campaign import tenants as jt

        root = str(tmp_path / "camp")
        obs = _obs_file(tmp_path)
        alice = jt.TenantRegistry(root).create(jt.Tenant(name="alice"))
        # the JAX package admits one, the port a duplicate of it
        assert ji.submit_observation(root, "alice", obs, via="cli")["accepted"]
        dup = submit_observation(root, "alice", obs, via="cli")
        assert not dup["accepted"] and dup["reason"].startswith("duplicate")
        assert TenantRegistry(root).by_token(alice.token).name == "alice"
        got = [(e["tenant"], e["accepted"]) for e in read_submissions(root)]
        assert got == [(e["tenant"], e["accepted"]) for e in ji.read_submissions(root)]
        assert got == [("alice", True), ("alice", False)]
