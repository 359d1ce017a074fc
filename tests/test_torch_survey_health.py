"""The port's survey health console (the JAX package's
tests/test_survey_health.py, class by class, on the port's modules, its
worker on the CPU): the declarative alert engine (threshold/absence/burn-rate lifecycle over the fleet metrics,
persisted transitions, lock discipline), the data-quality sentinels
(per-observation gauges, campaign baselines, injection recovery), the
ALERTS exposition series, the status portal endpoints, and the rollup
/watch integration. Then against the JAX package over the same inputs:
the same alert snapshots and journals, the same quality gauges, the same
rollup (less its clocks and host), the same watch text, and the same
portal bodies, route by route."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from peasoup_tpu_torch.obs.alerts import (
    AlertEngine,
    alerts_exposition,
    counter_increase,
    default_rules,
    evaluate_campaign,
    load_alerts,
    validate_snapshot,
)
from peasoup_tpu_torch.obs.health import (
    build_baselines,
    data_quality_summary,
    enqueue_sentinel,
    observation_quality,
    quality_findings,
    sentinel_findings,
    sentinel_status,
)
from peasoup_tpu_torch.obs.metrics import (
    MetricsRecorder,
    load_series,
    parse_exposition,
    prometheus_exposition,
)
from peasoup_tpu_torch.obs.schema import SchemaError


def _gauge_rule(value=5.0, for_s=0.0, window_s=900.0):
    return {
        "name": "queue_backlog",
        "kind": "threshold",
        "metric": "queue_depth",
        "metric_kind": "gauge",
        "op": ">",
        "value": value,
        "for_s": for_s,
        "window_s": window_s,
        "severity": "warn",
    }


def _gauge_samples(points):
    """{"w0": [gauge samples at (t, value), ...]}"""
    return {
        "w0": [
            {"t": float(t), "kind": "gauge", "name": "queue_depth",
             "value": float(v)}
            for t, v in points
        ]
    }


# --------------------------------------------------------------------------
# alert engine lifecycle
# --------------------------------------------------------------------------

class TestAlertLifecycle:
    def test_pending_then_firing_then_resolved(self, tmp_path):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule(for_s=10.0)])
        hot = _gauge_samples([(100.0, 9.0)])
        s1 = eng.evaluate(samples=hot, now=105.0)
        assert [(a["rule"], a["state"]) for a in s1["alerts"]] == [
            ("queue_backlog", "pending")
        ]
        s2 = eng.evaluate(samples=hot, now=120.0)
        assert s2["alerts"][0]["state"] == "firing"
        assert s2["alerts"][0]["firing_since_unix"] == 120.0
        cold = _gauge_samples([(100.0, 9.0), (125.0, 0.0)])
        s3 = eng.evaluate(samples=cold, now=130.0)
        assert s3["alerts"][0]["state"] == "resolved"
        assert s3["alerts"][0]["resolved_unix"] == 130.0

    def test_zero_for_fires_immediately_with_full_lifecycle_log(
        self, tmp_path
    ):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule(for_s=0.0)])
        snap = eng.evaluate(
            samples=_gauge_samples([(100.0, 9.0)]), now=101.0
        )
        assert snap["alerts"][0]["state"] == "firing"
        log = [
            json.loads(ln)
            for ln in open(
                os.path.join(str(tmp_path), "queue", "alerts.jsonl")
            )
        ]
        assert [(r["from"], r["to"]) for r in log] == [
            ("inactive", "pending"), ("pending", "firing")
        ]
        assert all(r["t_unix"] == 101.0 for r in log)

    def test_pending_that_recovers_never_logs_firing(self, tmp_path):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule(for_s=60.0)])
        eng.evaluate(samples=_gauge_samples([(100.0, 9.0)]), now=105.0)
        s2 = eng.evaluate(
            samples=_gauge_samples([(100.0, 9.0), (106.0, 1.0)]),
            now=110.0,
        )
        # pending -> inactive: dropped from the snapshot entirely
        assert s2["alerts"] == []
        states = [
            json.loads(ln)["to"]
            for ln in open(
                os.path.join(str(tmp_path), "queue", "alerts.jsonl")
            )
        ]
        assert "firing" not in states

    def test_resolved_expires_after_retention(self, tmp_path):
        from peasoup_tpu_torch.obs.alerts import RESOLVED_RETENTION_S

        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule()])
        eng.evaluate(samples=_gauge_samples([(100.0, 9.0)]), now=105.0)
        s = eng.evaluate(samples=_gauge_samples([(100.0, 9.0)]),
                         now=110.0)
        assert s["alerts"][0]["state"] in ("pending", "firing")
        s = eng.evaluate(
            samples=_gauge_samples([(100.0, 0.0)]), now=120.0
        )
        assert s["alerts"][0]["state"] == "resolved"
        s = eng.evaluate(
            samples=_gauge_samples([(100.0, 0.0)]),
            now=120.0 + RESOLVED_RETENTION_S + 1.0,
        )
        assert s["alerts"] == []

    def test_refire_after_resolution_is_a_new_alert(self, tmp_path):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule()])
        eng.evaluate(samples=_gauge_samples([(100.0, 9.0)]), now=101.0)
        eng.evaluate(samples=_gauge_samples([(100.0, 0.0)]), now=110.0)
        s = eng.evaluate(samples=_gauge_samples([(115.0, 9.0)]),
                         now=116.0)
        firing = [a for a in s["alerts"] if a["state"] == "firing"]
        assert len(firing) == 1 and firing[0]["since_unix"] == 116.0

    def test_snapshot_schema_valid_and_rejects_drift(self, tmp_path):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule()])
        snap = eng.evaluate(
            samples=_gauge_samples([(100.0, 9.0)]), now=101.0
        )
        validate_snapshot(snap)
        bad = json.loads(json.dumps(snap))
        bad["alerts"][0]["state"] = "screaming"
        with pytest.raises(SchemaError):
            validate_snapshot(bad)

    def test_live_lock_skips_evaluation(self, tmp_path):
        root = str(tmp_path)
        eng = AlertEngine(root, rules=[_gauge_rule()])
        os.makedirs(os.path.join(root, "queue"), exist_ok=True)
        with open(
            os.path.join(root, "queue", "alerts.lock"), "x"
        ) as f:
            json.dump({"pid": 1, "t_unix": 1e18}, f)
        snap = eng.evaluate(
            samples=_gauge_samples([(100.0, 9.0)]), now=101.0
        )
        assert snap["alerts"] == []  # another evaluator holds the lock

    def test_stale_lock_taken_over(self, tmp_path):
        root = str(tmp_path)
        eng = AlertEngine(root, rules=[_gauge_rule()], lock_stale_s=1.0)
        os.makedirs(os.path.join(root, "queue"), exist_ok=True)
        with open(
            os.path.join(root, "queue", "alerts.lock"), "x"
        ) as f:
            json.dump({"pid": 1, "t_unix": 10.0}, f)
        snap = eng.evaluate(
            samples=_gauge_samples([(100.0, 9.0)]), now=101.0
        )
        assert snap["alerts"]  # dead evaluator's lock was reaped
        assert not os.path.exists(
            os.path.join(root, "queue", "alerts.lock")
        )


class TestRules:
    def test_absence_pages_only_stalled_live_workers(self, tmp_path):
        rules = [r for r in default_rules(heartbeat_s=2.0)
                 if r["kind"] == "absence"]
        eng = AlertEngine(str(tmp_path), rules=rules)
        samples = {
            "fresh": [{"t": 99.0, "kind": "gauge",
                       "name": "worker_heartbeat_unix", "value": 99.0}],
            "stalled": [{"t": 10.0, "kind": "gauge",
                         "name": "worker_heartbeat_unix", "value": 10.0}],
            "dead": [{"t": 5.0, "kind": "gauge",
                      "name": "worker_heartbeat_unix", "value": 5.0}],
        }
        snap = eng.evaluate(
            samples=samples, now=100.0,
            live_sources=["fresh", "stalled"],  # dead has deregistered
        )
        assert [a["labels"] for a in snap["alerts"]] == [
            {"worker": "stalled"}
        ]

    def test_burn_rate_needs_every_window_burning(self, tmp_path):
        rules = [r for r in default_rules()
                 if r["name"] == "job_failure_burn_rate"]
        eng = AlertEngine(str(tmp_path), rules=rules)

        def counters(points, name):
            return [
                {"t": float(t), "kind": "counter", "name": name,
                 "value": float(v)}
                for t, v in points
            ]

        # an old streak of failures outside the short window: the long
        # window burns but the short one is clean -> no alert
        now = 10_000.0
        samples = {"w0": (
            counters([(now - 1500, 5.0)], "jobs_failed_total")
            + counters([(now - 1500, 1.0), (now - 100, 2.0)],
                       "jobs_done_total")
        )}
        assert eng.evaluate(samples=samples, now=now)["alerts"] == []
        # failures continuing into the short window -> fires
        samples["w0"] += counters([(now - 50, 10.0)],
                                  "jobs_failed_total")
        snap = eng.evaluate(samples=samples, now=now)
        assert snap["alerts"][0]["state"] == "firing"
        assert snap["alerts"][0]["severity"] == "page"

    def test_counter_increase_survives_rotation_and_restart(self):
        # rotation keeps the newest tail with cumulative totals carried
        # in recorder memory: the pre-window sample seeds the baseline
        samples = {"w0": [
            {"t": 50.0, "kind": "counter", "name": "c_total",
             "value": 40.0},
            {"t": 110.0, "kind": "counter", "name": "c_total",
             "value": 45.0},
        ]}
        assert counter_increase(samples, "c_total", 100.0, 200.0) == 5.0
        # a value DROP is a process-restart reset, not a negative delta
        samples["w0"].append(
            {"t": 120.0, "kind": "counter", "name": "c_total",
             "value": 2.0}
        )
        assert counter_increase(samples, "c_total", 100.0, 200.0) == 7.0

    def test_recompile_budget_not_refired_after_rotation(self, tmp_path):
        """A resolved alert must stay resolved when rotation rewrites
        the metrics file but the counter total has stopped growing."""
        rule = {
            "name": "jit_recompile_budget", "kind": "threshold",
            "metric": "jit_programs_compiled_total",
            "metric_kind": "counter", "select": "increase",
            "op": ">", "value": 5.0, "window_s": 60.0,
            "severity": "warn",
        }
        mpath = str(
            tmp_path / "queue" / "workers" / "w0.metrics.jsonl"
        )
        rec = MetricsRecorder(mpath, max_bytes=1600, keep_bytes=600)
        for _ in range(10):
            rec.counter("jit_programs_compiled_total")
        eng = AlertEngine(str(tmp_path), rules=[rule])
        t_spike = max(
            s["t"] for s in load_series(mpath)
        )
        snap = eng.evaluate(
            samples={"w0": load_series(mpath)}, now=t_spike + 1.0
        )
        assert snap["alerts"][0]["state"] == "firing"
        # the storm stops; rotation churns the file (totals carried)
        for _ in range(60):
            rec.gauge("queue_depth", 0.0)
        rotated = load_series(mpath)
        assert len(rotated) < 70  # rotation really dropped old lines
        s2 = eng.evaluate(
            samples={"w0": rotated}, now=t_spike + 120.0
        )
        assert s2["alerts"][0]["state"] == "resolved"
        s3 = eng.evaluate(
            samples={"w0": rotated}, now=t_spike + 130.0
        )
        assert s3["alerts"][0]["state"] == "resolved"  # no re-fire
        states = [
            json.loads(ln)["to"]
            for ln in open(
                os.path.join(str(tmp_path), "queue", "alerts.jsonl")
            )
        ]
        assert states.count("firing") == 1

    def test_threshold_with_no_data_is_silent(self, tmp_path):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule()])
        assert eng.evaluate(samples={}, now=100.0)["alerts"] == []


# --------------------------------------------------------------------------
# ALERTS exposition
# --------------------------------------------------------------------------

class TestAlertsExposition:
    def test_round_trip_with_metrics(self, tmp_path):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule()])
        snap = eng.evaluate(
            samples=_gauge_samples([(100.0, 9.0)]), now=101.0
        )
        text = (
            prometheus_exposition(_gauge_samples([(100.0, 9.0)]))
            + alerts_exposition(snap)
        )
        rows = parse_exposition(text)
        alerts = [r for r in rows if r[0] == "ALERTS"]
        assert alerts == [(
            "ALERTS",
            {"alertname": "queue_backlog", "alertstate": "firing",
             "severity": "warn"},
            1.0,
        )]

    def test_resolved_alerts_not_exported(self, tmp_path):
        eng = AlertEngine(str(tmp_path), rules=[_gauge_rule()])
        eng.evaluate(samples=_gauge_samples([(100.0, 9.0)]), now=101.0)
        snap = eng.evaluate(
            samples=_gauge_samples([(100.0, 0.0)]), now=110.0
        )
        assert snap["alerts"][0]["state"] == "resolved"
        assert alerts_exposition(snap) == ""

    def test_empty_snapshot_renders_nothing(self):
        assert alerts_exposition({"alerts": []}) == ""


# --------------------------------------------------------------------------
# data-quality sentinels
# --------------------------------------------------------------------------

class TestObservationQuality:
    def _clean(self, nsamps=2048, nchans=16, seed=0):
        rng = np.random.default_rng(seed)
        return rng.normal(32, 4, (nsamps, nchans)).clip(
            0, 255
        ).astype(np.uint8)

    def test_clean_observation_scores_clean(self):
        q = observation_quality(
            self._clean(), n_candidates=5, n_dm_trials=50, nbits=8
        )
        assert q["zap_fraction"] == 0.0
        assert q["clip_fraction"] < 0.01
        assert q["candidate_rate"] == pytest.approx(0.1)

    def test_rfi_storm_raises_occupancy_and_clipping(self):
        data = self._clean().astype(np.float32)
        data[:, 3] += 200.0
        data[:, 7] *= 30.0
        data = data.clip(0, 255).astype(np.uint8)
        q = observation_quality(data, nbits=8)
        assert q["zap_fraction"] >= 2.0 / 16.0
        assert q["clip_fraction"] > 0.05

    def test_dead_channel_counted(self):
        data = self._clean()
        data[:, 5] = 32
        q = observation_quality(data, nbits=8)
        assert q["dead_channels"] >= 1

    def test_degenerate_inputs(self):
        assert observation_quality(np.zeros((0, 0))) == {}
        assert observation_quality(np.zeros(16)) == {}

    def test_baselines_exclude_sentinels_and_flag_outliers(self):
        done = [
            {"job_id": f"j{i}",
             "quality": {"zap_fraction": 0.0, "clip_fraction": 0.0,
                         "candidate_rate": 0.05 + 0.002 * i}}
            for i in range(6)
        ]
        done.append(
            {"job_id": "sent", "sentinel": True,
             "quality": {"zap_fraction": 0.9, "clip_fraction": 0.9,
                         "candidate_rate": 50.0}}
        )
        base = build_baselines(done)
        assert base["candidate_rate"]["n"] == 6
        assert base["candidate_rate"]["median"] < 0.1
        assert quality_findings(done) == []  # sentinel never judged
        done.append(
            {"job_id": "storm",
             "quality": {"zap_fraction": 0.5, "clip_fraction": 0.0,
                         "candidate_rate": 30.0}}
        )
        flagged = quality_findings(done)
        assert {f["labels"]["job"] for f in flagged} == {"storm"}
        metrics = {f["labels"]["metric"] for f in flagged}
        assert "candidate_rate" in metrics
        summary = data_quality_summary(done)
        assert summary["jobs"] == 7  # sentinel not a baseline job
        assert summary["outliers"] == flagged

    def test_small_campaigns_never_flagged(self):
        done = [
            {"job_id": "a", "quality": {"candidate_rate": 0.1}},
            {"job_id": "b", "quality": {"candidate_rate": 99.0}},
        ]
        assert quality_findings(done) == []  # n < min_n: no baseline


# --------------------------------------------------------------------------
# campaign end-to-end: sentinel recovery + portal + rollup + watch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def health_campaign(tmp_path_factory):
    """A tiny campaign (one survey obs + one injection sentinel)
    drained by one worker, with alerts evaluated along the way."""
    from test_torch_campaign_queue import make_obs

    from peasoup_tpu_torch.campaign.queue import Job, JobQueue, job_id_for
    from peasoup_tpu_torch.campaign.runner import (
        CampaignConfig,
        bucket_for_input,
        run_worker,
        save_campaign_config,
    )

    tmp = tmp_path_factory.mktemp("health")
    root = str(tmp / "camp")
    os.makedirs(root)
    save_campaign_config(
        root,
        CampaignConfig(
            pipeline="spsearch",
            config={"dm_end": 20.0, "min_snr": 7.0, "n_widths": 6},
            warmup=False, heartbeat_interval=0.2, backoff_base_s=0.05,
        ),
    )
    q = JobQueue(root)
    fil = make_obs(str(tmp / "obs0.fil"))
    jid = job_id_for(fil)
    q.add_job(
        Job(job_id=jid, input=fil, pipeline="spsearch",
            bucket=bucket_for_input(fil))
    )
    truth = enqueue_sentinel(root, queue=q, seed=11)
    tally = run_worker(root, device="cpu", worker_id="w1", poll_s=0.05)
    return root, jid, truth, tally


class TestSentinelRecovery:
    def test_campaign_drained(self, health_campaign):
        _, _, _, tally = health_campaign
        assert tally["done"] == 2

    def test_sentinel_recovered(self, health_campaign):
        root, _, truth, _ = health_campaign
        rows = sentinel_status(root)
        assert [r["status"] for r in rows] == ["recovered"]
        assert rows[0]["job_id"] == truth["job_id"]
        assert sentinel_findings(root) == []

    def test_sentinel_claims_last(self, health_campaign):
        """priority=-1: the survey observation was searched first."""
        root, jid, truth, _ = health_campaign
        done = json.load(
            open(os.path.join(root, "queue", "done", f"{jid}.json"))
        )
        sdone = json.load(
            open(os.path.join(
                root, "queue", "done", f"{truth['job_id']}.json"
            ))
        )
        assert sdone.get("sentinel") is True
        assert done.get("sentinel") is None
        assert done["finished_unix"] <= sdone["finished_unix"]

    def test_broken_search_is_missed_and_alerts(self, health_campaign):
        """An impossible S/N floor simulates a search that no longer
        finds the injection: status missed, sentinel alert fires."""
        root, _, truth, _ = health_campaign
        sdir = os.path.join(root, "queue", "sentinels")
        broken = dict(truth, min_snr=1e9, job_id=truth["job_id"])
        path = os.path.join(sdir, f"{truth['job_id']}.json")
        orig = open(path).read()
        try:
            with open(path + ".tmp", "w") as f:
                json.dump(broken, f)
            os.replace(path + ".tmp", path)
            rows = sentinel_status(root)
            assert rows[0]["status"] == "missed"
            findings = sentinel_findings(root)
            assert findings and findings[0]["labels"] == {
                "job": truth["job_id"]
            }
            snap = evaluate_campaign(root)
            missed = [
                a for a in snap["alerts"]
                if a["rule"] == "sentinel_unrecovered"
            ]
            assert missed and missed[0]["state"] == "firing"
            assert missed[0]["severity"] == "page"
        finally:
            with open(path + ".tmp", "w") as f:
                f.write(orig)
            os.replace(path + ".tmp", path)
            evaluate_campaign(root)  # resolve it again

    def test_quality_gauges_in_done_record_and_metrics(
        self, health_campaign
    ):
        root, jid, _, _ = health_campaign
        done = json.load(
            open(os.path.join(root, "queue", "done", f"{jid}.json"))
        )
        assert "quality" in done
        assert set(done["quality"]) >= {
            "zap_fraction", "clip_fraction", "candidate_rate"
        }
        from peasoup_tpu_torch.obs.metrics import fleet_samples

        names = {
            r["name"] for r in fleet_samples(root)["w1"]
        }
        assert "dq_candidate_rate" in names
        assert "worker_heartbeat_unix" in names

    def test_worker_wrote_alerts_snapshot(self, health_campaign):
        # the worker evaluated the stock rules beside its rollup; with no
        # kernel library built, no failure and no stall, nothing fires
        # (the JAX package's run can journal its recompile budget)
        root, _, _, _ = health_campaign
        snap = load_alerts(root)
        validate_snapshot(snap)
        assert snap["updated_unix"] > 0
        assert not [a for a in snap["alerts"] if a["state"] == "firing"]

    def test_rollup_embeds_alerts_and_data_quality(
        self, health_campaign
    ):
        from peasoup_tpu_torch.campaign.rollup import build_status

        root, _, truth, _ = health_campaign
        st = build_status(root)
        assert "invalid" not in st["alerts"]
        assert set(st["alerts"]) >= {"firing", "pending", "resolved"}
        dq = st["data_quality"]
        assert dq["sentinels"] == {
            "total": 1, "pending": 0, "recovered": 1, "missed": 0
        }
        assert dq["jobs"] >= 1

    def test_watch_renders_health_sections(self, health_campaign):
        from peasoup_tpu_torch.campaign.rollup import build_status
        from peasoup_tpu_torch.tools.watch import render_campaign_status

        root, _, _, _ = health_campaign
        st = build_status(root)
        out = render_campaign_status(st)
        assert "sentinels: 1 recovered" in out
        # inject a firing alert + a missed sentinel: loud lines
        st["alerts"] = {
            "firing": 1, "pending": 0, "resolved": 0,
            "active": [{
                "rule": "worker_heartbeat_stalled", "state": "firing",
                "severity": "page", "labels": {"worker": "w9"},
                "value": 99.0, "message": "no beat", "since_unix": 1.0,
            }],
        }
        st["data_quality"]["sentinels"]["missed"] = 1
        out = render_campaign_status(st)
        assert "1 firing" in out
        assert "worker_heartbeat_stalled" in out and "worker=w9" in out
        assert "MISSED" in out


class TestPortal:
    @pytest.fixture()
    def portal(self, health_campaign):
        import socket

        from peasoup_tpu_torch.obs.portal import serve_portal

        root, jid, truth, _ = health_campaign
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        n_requests = 6
        srv = threading.Thread(
            target=serve_portal,
            args=(root,),
            kwargs={"port": port, "max_requests": n_requests},
            daemon=True,
        )
        srv.start()
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(base + "/alerts", timeout=2)
                break
            except OSError:
                time.sleep(0.05)
        yield base, root, jid
        # drain any unconsumed request budget so the server exits now
        # instead of the join riding its full timeout
        for _ in range(n_requests):
            if not srv.is_alive():
                break
            try:
                urllib.request.urlopen(base + "/alerts", timeout=1)
            except OSError:
                break
            srv.join(timeout=0.2)
        srv.join(timeout=5)

    def _get(self, url):
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.headers.get("Content-Type"), \
                resp.read()

    def test_endpoints(self, portal):
        base, root, jid = portal
        code, ctype, body = self._get(base + "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        rows = parse_exposition(body.decode())
        assert any(r[0] == "peasoup_jobs_done_total" for r in rows)

        code, ctype, body = self._get(base + "/status")
        st = json.loads(body)
        assert code == 200 and st["schema"] == (
            "peasoup_tpu.campaign_status"
        )
        assert "alerts" in st and "data_quality" in st

        code, _, body = self._get(base + "/alerts")
        validate_snapshot(json.loads(body))

        code, _, body = self._get(base + f"/jobs/{jid}")
        doc = json.loads(body)
        assert doc["job"]["job_id"] == jid
        assert doc["done"]["job_id"] == jid
        assert doc["trace"]["connected"]

        code, ctype, body = self._get(base + "/")
        assert code == 200 and b"/metrics" in body

    def test_unknown_job_is_404_not_traversal(self, portal):
        base, _, _ = portal
        with pytest.raises(urllib.error.HTTPError) as exc:
            self._get(base + "/jobs/../../etc/passwd")
        assert exc.value.code == 404


class TestCLI:
    def test_alerts_command(self, health_campaign, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        root, _, _, _ = health_campaign
        rc = main(["alerts", "-w", root, "--evaluate"])
        out = capsys.readouterr().out
        assert rc in (0, 2)
        rc = main(["alerts", "-w", root, "--json"])
        snap = json.loads(capsys.readouterr().out)
        validate_snapshot(snap)

    def test_sentinel_check_command(self, health_campaign, capsys):
        from peasoup_tpu_torch.cli.campaign import main

        root, _, truth, _ = health_campaign
        assert main(["sentinel", "-w", root, "--check"]) == 0
        out = capsys.readouterr().out
        assert "recovered" in out and truth["job_id"] in out

    def test_serve_command_bounded(self, health_campaign):
        import socket

        from peasoup_tpu_torch.cli.campaign import main

        root, _, _, _ = health_campaign
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        th = threading.Thread(
            target=main,
            args=(
                ["serve", "-w", root, "--port", str(port),
                 "--max-requests", "1"],
            ),
            daemon=True,
        )
        th.start()
        deadline = time.monotonic() + 10
        body = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=2
                ) as resp:
                    body = resp.read().decode()
                break
            except OSError:
                time.sleep(0.05)
        th.join(timeout=10)
        assert body is not None
        parse_exposition(body)


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

def _strip_clocks(doc):
    """A rollup without its clocks and host: the fields that name when
    and where it was built, not what the campaign holds."""
    drop = {"generated_unix", "updated_unix", "hostname", "pid", "age_s",
            "elapsed_s", "last_beat_age_s", "last_done_age_s", "eta_s"}
    if isinstance(doc, dict):
        return {k: _strip_clocks(v) for k, v in doc.items() if k not in drop}
    if isinstance(doc, list):
        return [_strip_clocks(v) for v in doc]
    return doc


class TestAgainstJax:
    def test_same_rules_same_snapshots_and_journal(self, tmp_path):
        from peasoup_tpu.obs import alerts as jalerts

        rules = [_gauge_rule(for_s=10.0)] + [
            r for r in default_rules(heartbeat_s=1.0) if r["kind"] != "absence"]
        series = [
            (105.0, [(100.0, 9.0)]),
            (120.0, [(100.0, 9.0)]),
            (130.0, [(100.0, 9.0), (125.0, 0.0)]),
            (140.0, [(100.0, 9.0), (125.0, 0.0), (135.0, 12.0)]),
        ]
        snaps, journals = [], []
        for name, mod in (("jax", jalerts), ("port", None)):
            root = str(tmp_path / name)
            eng = (mod.AlertEngine if mod else AlertEngine)(root, rules=rules)
            snaps.append([eng.evaluate(samples=_gauge_samples(p), now=now)
                          for now, p in series])
            with open(os.path.join(root, "queue", "alerts.jsonl")) as f:
                journals.append([json.loads(ln) for ln in f])
        assert snaps[0] == snaps[1]
        assert journals[0] == journals[1]
        assert [a["state"] for a in snaps[1][1]["alerts"]] == ["firing"]
        assert alerts_exposition(snaps[1][-1]) == jalerts.alerts_exposition(snaps[0][-1])

    @pytest.mark.parametrize("case", ["clean", "storm", "dead"])
    def test_same_quality_gauges(self, case):
        from peasoup_tpu.obs.health import observation_quality as jax_quality

        rng = np.random.default_rng(3)
        data = np.clip(np.rint(rng.normal(32.0, 4.0, size=(4096, 16))), 0, 255)
        if case == "storm":
            data[::7, 3:11] = 255
        elif case == "dead":
            data[:, 5] = 0
        data = data.astype(np.uint8)
        got = [f(data, n_candidates=12, n_dm_trials=40, nbits=8)
               for f in (jax_quality, observation_quality)]
        assert got[0] == got[1]
        assert got[1]

    def test_same_rollup_and_watch_text(self, health_campaign):
        from peasoup_tpu.campaign.rollup import build_status as jax_status
        from peasoup_tpu.tools.watch import render_campaign_status as jax_render
        from peasoup_tpu_torch.campaign.rollup import build_status
        from peasoup_tpu_torch.tools.watch import render_campaign_status

        root, _, _, _ = health_campaign
        docs = [f(root) for f in (jax_status, build_status)]
        assert _strip_clocks(docs[0]) == _strip_clocks(docs[1])
        assert docs[1]["queue"]["done"] == 2
        # one document, both renderers
        assert render_campaign_status(docs[0]) == jax_render(docs[0])

    def test_same_portal_bodies(self, health_campaign):
        import socket

        from peasoup_tpu.obs.portal import serve_portal as jax_serve
        from peasoup_tpu_torch.campaign.rollup import write_status
        from peasoup_tpu_torch.obs.portal import BOWTIE_NOT_PORTED, serve_portal

        root, jid, _, _ = health_campaign
        write_status(root)  # both portals then serve the one rollup file
        routes = ["/", "/metrics", "/status", "/alerts", "/usage", "/candidates",
                  "/tenants", "/report", f"/jobs/{jid}", "/jobs/none", "/bowtie.svg"]
        got = {}
        for name, serve in (("jax", jax_serve), ("port", serve_portal)):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            srv = threading.Thread(target=serve, args=(root,), daemon=True,
                                   kwargs={"port": port, "max_requests": len(routes)})
            srv.start()
            out = {}
            for route in routes:
                for _ in range(200):
                    try:
                        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                                    timeout=5) as r:
                            out[route] = (r.status, r.read())
                        break
                    except urllib.error.HTTPError as exc:
                        out[route] = (exc.code, exc.read())
                        break
                    except OSError:
                        time.sleep(0.02)
            srv.join(timeout=10)
            got[name] = out
        for route in routes[:-1]:
            (jcode, jbody), (tcode, tbody) = got["jax"][route], got["port"][route]
            assert jcode == tcode, route
            if route in ("/usage", f"/jobs/{jid}"):  # built per request
                assert _strip_clocks(json.loads(jbody)) == _strip_clocks(
                    json.loads(tbody)), route
            else:
                assert jbody == tbody, route
        # the port draws no bowtie yet: 501 names the missing module where
        # the JAX portal has no file to serve either (404)
        assert got["jax"]["/bowtie.svg"][0] == 404
        code, body = got["port"]["/bowtie.svg"]
        assert code == 501 and b"tools/plotting" in body
        assert "tools/plotting" in BOWTIE_NOT_PORTED


class TestServeMetrics:
    def test_serve_metrics_http_endpoint(self, tmp_path):
        # the fleet's exposition over HTTP, regenerated per request
        import socket

        from peasoup_tpu_torch.obs.metrics import serve_metrics

        root = tmp_path / "camp"
        wdir = root / "queue" / "workers"
        wdir.mkdir(parents=True)
        MetricsRecorder(str(wdir / "w.metrics.jsonl")).counter("up_total")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        srv = threading.Thread(target=serve_metrics, args=(str(root),),
                               kwargs={"port": port, "max_requests": 1}, daemon=True)
        srv.start()
        deadline = time.monotonic() + 5
        body = None
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                            timeout=2) as resp:
                    body = resp.read().decode()
                break
            except OSError:
                time.sleep(0.05)
        srv.join(timeout=5)
        assert body is not None and "peasoup_up_total" in body
        parse_exposition(body)
