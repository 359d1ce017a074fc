"""The port's observability core (peasoup_tpu_torch/obs/, the CLIs' shared
flags, tools/validate_manifest.py and tools/scope_trace.py) against the
JAX package's: the run manifest and its schema, the trace spans and their
Chrome export, the status.json heartbeat and its stall watchdog, the crash
flight recorder, the metrics recorder (rotation included) and its
Prometheus exposition, and logging. Cases follow the JAX package's
tests/test_obs.py, test_live_obs.py and test_fleet_obs.py."""

import json
import logging
import os
import time
from pathlib import Path

import pytest

from peasoup_tpu.obs import metrics as jmetrics
from peasoup_tpu.obs import trace as jtrace
from peasoup_tpu.obs.schema import validate_manifest as jax_validate_manifest
from peasoup_tpu_torch.obs import log as tlog
from peasoup_tpu_torch.obs import metrics as tmetrics
from peasoup_tpu_torch.obs import trace as ttrace
from peasoup_tpu_torch.obs.flight import FlightRecorder, load_flight
from peasoup_tpu_torch.obs.heartbeat import Heartbeat, load_status
from peasoup_tpu_torch.obs.schema import SchemaError, validate_manifest
from peasoup_tpu_torch.obs.telemetry import (
    MANIFEST_SCHEMA, MANIFEST_VERSION, NOOP, RunTelemetry, current, load_manifest,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["manifest.schema.json", "metrics.schema.json"])
def test_schema_copies_are_the_jax_files(name):
    # the port keeps its own copy of each schema; it must be the JAX
    # package's byte for byte, so one document validates in both
    assert (ROOT / "peasoup_tpu_torch" / "obs" / name).read_bytes() == (
        ROOT / "peasoup_tpu" / "obs" / name).read_bytes()


def _filled() -> RunTelemetry:
    tel = RunTelemetry(run_id="r1")
    tel.set_context(command="peasoup", inputfile="x.fil")
    tel.incr("widgets", 3)
    tel.incr("widgets")
    tel.gauge("level", 1.5)
    tel.gauge_max("peak", 3)
    tel.gauge_max("peak", 2)
    with tel.stage("dedispersion"):
        with tel.stage("inner"):
            pass
    tel.set_progress(2, 4, unit="chunks")
    tel.event("oom_shrink_retry", dm_block_old=8, dm_block_new=4)
    return tel


def test_manifest_round_trip(tmp_path):
    from peasoup_tpu_torch.resilience.stats import STATS

    # the manifest's resilience section is the process's: start from none
    # (an earlier test in the worker may have spent a retry budget, as
    # tests/test_torch_sift.py's exhausted fold ladder does)
    STATS.reset()
    tel = _filled()
    man = tel.write(str(tmp_path / "t" / "telemetry.json"))
    back = load_manifest(str(tmp_path / "t" / "telemetry.json"))
    assert back == json.loads(json.dumps(man))
    assert (back["schema"], back["version"]) == (MANIFEST_SCHEMA, MANIFEST_VERSION)
    assert back["counters"] == {"widgets": 4} and back["gauges"] == {"level": 1.5, "peak": 3}
    assert set(back["timers"]) == {"dedispersion", "inner"}
    assert [e["kind"] for e in back["events"]] == ["stage", "stage", "stage",
                                                   "oom_shrink_retry"]
    assert back["jit"] == {} and back["device_trace"] is None
    assert back["process_index"] == 0 and back["process_count"] == 1
    assert back["platform"]["torch"] and "jax" not in back["platform"]
    assert back["resilience"]["degraded"] is False
    # one document, both schemas (the copies are the same bytes)
    validate_manifest(back)
    jax_validate_manifest(back)


def test_aborted_manifest_and_rejections(tmp_path):
    tel = _filled()
    tel.set_stage("searching")
    man = tel.write(str(tmp_path / "a.json"), aborted=True, abort_reason="signal:SIGTERM")
    assert man["aborted"] and man["stage_at_abort"] == "searching"
    assert man["progress_at_abort"]["done"] == 2.0
    validate_manifest(man)
    (tmp_path / "f.json").write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError, match="not a"):
        load_manifest(str(tmp_path / "f.json"))
    (tmp_path / "n.json").write_text(json.dumps({"schema": MANIFEST_SCHEMA, "version": 99}))
    with pytest.raises(ValueError, match="newer"):
        load_manifest(str(tmp_path / "n.json"))
    bad = dict(man, counters={"x": "three"})
    with pytest.raises(SchemaError):
        validate_manifest(bad)


def test_current_defaults_to_noop_and_activation_scopes():
    assert current() is NOOP
    NOOP.event("x")
    NOOP.incr("y")
    assert NOOP.events == [] and NOOP.counters == {}
    tel = RunTelemetry()
    with tel.activate():
        assert current() is tel
        inner = RunTelemetry()
        with inner.activate():
            assert current() is inner
        assert current() is tel
    assert current() is NOOP
    disabled = RunTelemetry(enabled=False)
    with disabled.activate():
        assert current() is NOOP


def test_capture_device_memory_never_raises():
    # on a host without a card there is nothing to read, and nothing is
    # initialised to find that out
    tel = RunTelemetry()
    tel.capture_device_memory("search")
    assert "memory.search.peak_bytes" not in tel.gauges


def test_listeners_and_status_sections():
    tel = RunTelemetry()
    seen = []
    tel.add_listener(seen.append)
    tel.add_listener(lambda rec: 1 / 0)  # a broken listener never fails a run
    tel.set_status_section("streaming", lambda: {"chunks_done": 3})
    tel.set_status_section("broken", lambda: 1 / 0)
    tel.event("a", x=1)
    assert [r["kind"] for r in seen] == ["a"]
    secs = tel.snapshot_sections()
    assert secs["streaming"] == {"chunks_done": 3} and "error" in secs["broken"]
    assert "resilience" in secs
    man = tel.to_manifest()
    assert man["streaming"] == {"chunks_done": 3}


def test_kernel_library_builds_count(monkeypatch, tmp_path):
    # a build of a kernel's library counts under kernels.library_builds;
    # a library already built does not
    from peasoup_tpu_torch import kernels

    class _Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return b"", b""

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", _Proc)
    tel = RunTelemetry()
    with tel.activate():
        kernels.build(("resample", "boxcar"))
        kernels.build(("resample",))
    assert tel.counters == {"kernels.library_builds": 2}


# --- logging ------------------------------------------------------------------

def test_resolve_level_precedence(monkeypatch):
    monkeypatch.delenv("PEASOUP_LOG_LEVEL", raising=False)
    assert tlog.resolve_level(None) == logging.WARNING
    assert tlog.resolve_level(None, verbose=True) == logging.INFO
    monkeypatch.setenv("PEASOUP_LOG_LEVEL", "error")
    assert tlog.resolve_level(None) == logging.ERROR
    assert tlog.resolve_level("debug", verbose=True) == logging.DEBUG
    with pytest.raises(ValueError):
        tlog.resolve_level("loud")


def test_configure_is_idempotent_and_follows_stderr(capsys):
    logger = tlog.configure("info")
    tlog.configure("warning")
    ours = [h for h in logger.handlers if not isinstance(h, logging.NullHandler)]
    assert len(ours) == 1
    tlog.get_logger("search").warning("to the current stderr")
    tlog.get_logger("search").info("below the threshold")
    err = capsys.readouterr().err
    assert "[WARNING] peasoup_tpu_torch.search: to the current stderr" in err
    assert "below the threshold" not in err
    assert tlog.get_logger("x.y").name == "peasoup_tpu_torch.x.y"


# --- trace ----------------------------------------------------------------------

def _spans(mod, tmp_path, tid="t1"):
    """The same spans through one package's Tracer: two workers, a flow."""
    out = []
    for w in ("w0", "w1"):
        tr = mod.Tracer(str(tmp_path / mod.__name__ / f"trace-{w}.jsonl"), tid, worker=w)
        with tr.span("wave", flow_id=mod.flow_id_for("g", 1), wave=0):
            tr.instant("checkpoint", wave=0)
        tr.span_at("claim_wait", ts_unix=time.time() - 1, dur_s=0.5)
        sid = tr.begin("left_open")
        assert sid
        tr.close()
        out.append(tr.path)
    return mod.load_spans(out)


def test_trace_spans_summary_and_export_match_jax(tmp_path):
    got, want = _spans(ttrace, tmp_path), _spans(jtrace, tmp_path)
    summ, jsumm = ttrace.trace_summary(got), jtrace.trace_summary(want)
    assert summ == jsumm
    assert summ["connected"] and summ["unclosed"] == 0 and summ["forced_ends"] == 2
    assert summ["flows_linked"] == 1 and summ["workers"] == ["w0", "w1"]
    # the Chrome export of the same records is the same document
    recs = json.loads(json.dumps(got))
    assert ttrace.export_chrome_trace(recs) == jtrace.export_chrome_trace(recs)
    doc = ttrace.export_chrome_trace(recs)
    assert {e["ph"] for e in doc["traceEvents"]} >= {"M", "X", "i", "s", "f"}


def test_trace_telemetry_bridge_and_torn_tail(tmp_path):
    path = tmp_path / "trace-w.jsonl"
    tr = ttrace.Tracer(str(path), "t2", worker="w")
    tel = RunTelemetry()
    tr.attach(tel)
    with tr.activate(), tel.activate():
        with ttrace.job_span("wave", wave=0):
            tel.set_stage("dedispersion")
            tel.event("device_plan", n_devices=1)
            tel.set_stage("searching")
    tr.close()
    with open(path, "a") as f:
        f.write('{"trace_id": "t2", "torn')
    names = [s["name"] for s in ttrace.load_spans(str(path))]
    assert sorted(names) == ["device_plan", "stage:dedispersion", "stage:searching", "wave"]
    with ttrace.job_span("noop"):
        pass  # no ambient tracer: nothing
    assert ttrace.current_tracer() is None


# --- heartbeat and stall watchdog -------------------------------------------------

def test_heartbeat_snapshots_progress(tmp_path):
    tel = RunTelemetry()
    path = tmp_path / "status.json"
    tel.set_status_section("streaming", lambda: {"chunks_done": 1})
    with Heartbeat(tel, str(path), interval=0.02, stall_timeout=0):
        tel.set_stage("searching")
        for i in range(1, 5):
            tel.set_progress(i, 4, unit="chunks")
            time.sleep(0.03)
        st = load_status(str(path))
        assert st["done"] is False and st["stage"] == "searching"
    st = load_status(str(path))
    assert st["done"] is True and st["seq"] >= 2
    assert st["progress"]["frac"] == 1.0 and st["progress"]["eta_s"] == 0.0
    assert st["streaming"] == {"chunks_done": 1} and "resilience" in st


def test_heartbeat_stall_watchdog(tmp_path):
    tel = RunTelemetry()
    tel.set_stage("searching")

    path = str(tmp_path / "s.json")

    def wait_for(what, done):
        # poll rather than sleep a fixed time: a loaded machine may run the
        # beat late, and a stall_timeout without progress after the
        # recovery would (rightly) record a second stall
        deadline = time.monotonic() + 30
        while not done():
            assert time.monotonic() < deadline, f"no {what}"
            time.sleep(0.01)

    def stalled():
        try:
            return load_status(path)["stalled"] is True
        except (OSError, ValueError):
            return False

    with Heartbeat(tel, path, interval=0.02, stall_timeout=0.5):
        wait_for("stalled status", stalled)
        tel.set_progress(1, 2)
        wait_for("recovery", lambda: "stall_recovered" in [e["kind"] for e in tel.events])
    kinds = [e["kind"] for e in tel.events]
    assert kinds.count("stall") == 1 and "stall_recovered" in kinds


# --- the flight recorder ------------------------------------------------------------

def test_flight_ring_is_bounded_and_dump_writes_both(tmp_path):
    tel = RunTelemetry()
    for i in range(10):
        tel.event("early", i=i)
    rec = FlightRecorder(tel, str(tmp_path / "flight.json"),
                         manifest_path=str(tmp_path / "telemetry.json"), ring=4)
    for i in range(6):
        tel.event("late", i=i)
    doc = rec.dump("exception:RuntimeError", exception="RuntimeError: boom")
    assert rec.dump("again") is None  # at most once
    flight = load_flight(str(tmp_path / "flight.json"))
    assert flight == json.loads(json.dumps(doc))
    assert [e["i"] for e in flight["events"]] == [2, 3, 4, 5]
    man = load_manifest(str(tmp_path / "telemetry.json"))
    assert man["aborted"] and man["abort_reason"] == "exception:RuntimeError"
    validate_manifest(man)
    rec.close()


def test_live_observability_dumps_on_exception(tmp_path):
    import argparse

    from peasoup_tpu_torch.cli import live_observability

    args = argparse.Namespace(no_flight_recorder=False, status_json=str(tmp_path / "s.json"),
                              heartbeat_interval=0.05)
    tel = RunTelemetry()
    with pytest.raises(RuntimeError):
        with tel.activate(), live_observability(tel, args, str(tmp_path),
                                                str(tmp_path / "telemetry.json")):
            tel.set_stage("searching")
            raise RuntimeError("boom")
    assert load_flight(str(tmp_path / "flight.json"))["stage"] == "searching"
    assert load_manifest(str(tmp_path / "telemetry.json"))["aborted"]
    assert load_status(str(tmp_path / "s.json"))["done"] is True
    # a clean exit leaves no flight record
    clean = tmp_path / "clean"
    with live_observability(RunTelemetry(), args, str(clean), str(clean / "t.json")):
        pass
    assert not (clean / "flight.json").exists()


# --- metrics --------------------------------------------------------------------------

def test_metrics_counter_gauge_hist_and_schema(tmp_path):
    path = str(tmp_path / "m.metrics.jsonl")
    rec = tmetrics.MetricsRecorder(path)
    rec.counter("chunks_total")
    rec.counter("chunks_total", 2)
    rec.counter("triggers_total", tenant="a")
    rec.gauge("queue_depth_blocks", 3)
    rec.observe("chunk_latency_seconds", 0.03)
    series = tmetrics.load_series(path, validate=True)
    jmetrics.load_series(path, validate=True)  # the JAX package reads the same file
    assert [r["value"] for r in series if r["name"] == "chunks_total"] == [1.0, 3.0]
    assert series[2]["labels"] == {"tenant": "a"}
    with pytest.raises(SchemaError):
        tmetrics.validate_sample({"t": 1.0, "name": "x", "kind": "meter", "value": 1})
    off = tmetrics.MetricsRecorder(str(tmp_path / "off.jsonl"), enabled=False)
    off.counter("x")
    assert not (tmp_path / "off.jsonl").exists()


def test_metrics_rotation_keeps_counters_monotone(tmp_path):
    path = str(tmp_path / "w.metrics.jsonl")
    rec = tmetrics.MetricsRecorder(path, max_bytes=2000, keep_bytes=800)
    for _ in range(200):
        rec.counter("chunks_total")
    assert os.path.getsize(path) <= 2000
    vals = [r["value"] for r in tmetrics.load_series(path)]
    assert vals == sorted(vals) and vals[-1] == 200.0 and vals[0] > 1.0


def test_exposition_matches_jax(tmp_path):
    root = tmp_path / "camp"
    wdir = root / "queue" / "workers"
    for w, lat in (("w0", 0.03), ("w1", 7.0)):
        rec = tmetrics.MetricsRecorder(str(wdir / f"{w}.metrics.jsonl"))
        rec.counter("chunks_total", 2)
        rec.gauge("queue_depth_blocks", 1)
        rec.gauge("queue_depth_blocks", 4)
        rec.observe("chunk_latency_seconds", lat)
        rec.counter("jobs_total", tenant='a"b\\c')
    samples = tmetrics.fleet_samples(str(root))
    assert samples == jmetrics.fleet_samples(str(root))
    text = tmetrics.prometheus_exposition(samples)
    assert text == jmetrics.prometheus_exposition(samples)
    parsed = tmetrics.parse_exposition(text)
    assert parsed == jmetrics.parse_exposition(text)
    gauges = [v for n, lab, v in parsed if n == "peasoup_queue_depth_blocks"]
    assert gauges == [4.0, 4.0]
    assert any(lab.get("tenant") == 'a"b\\c' for _, lab, _ in parsed)
    with pytest.raises(ValueError):
        tmetrics.parse_exposition("bad{x=1} 2")


# --- the tools ------------------------------------------------------------------------

def test_validate_manifest_cli(tmp_path, capsys):
    from peasoup_tpu_torch.tools.validate_manifest import main

    good = tmp_path / "g.json"
    _filled().write(str(good))
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps({"schema": MANIFEST_SCHEMA, "version": 3, "run_id": 1,
                               "created_unix": 0}))
    assert main([str(good), "--fresh"]) == 0
    assert "OK: 3 manifest(s) schema-valid" in capsys.readouterr().out
    assert main([str(bad)]) == 1


def test_profile_capture_is_a_guarded_noop_on_the_cpu(tmp_path):
    from peasoup_tpu_torch.obs.profiler import capture_device_profile

    tel = RunTelemetry()
    out = capture_device_profile(str(tmp_path / "p"), duration_s=0.1, telemetry=tel)
    assert out["captured"] is False and out["backend"] == "cpu"
    assert [e["kind"] for e in tel.events] == ["device_profile"]
    out = capture_device_profile(str(tmp_path / "p"), duration_s=0.1, allow_cpu=True)
    assert out["captured"] is True and os.listdir(tmp_path / "p")


def test_scope_trace_attributes_cpu_time_to_scopes():
    import torch
    from torch.profiler import record_function

    from peasoup_tpu_torch.tools.scope_trace import port_kernel, scope_trace

    x = torch.randn(64, 4096)
    with scope_trace("cpu") as res:
        with record_function("DM-Loop"):
            with record_function("Spectrum-Chain"):
                torch.fft.rfft(x)
            with record_function("Peaks"):
                (x > 1).nonzero()
    scopes = {s for s, _, _ in res.table()}
    assert {"DM-Loop/Spectrum-Chain", "DM-Loop/Peaks"} <= scopes
    assert res.device == "cpu" and res.device_s > 0
    assert res.phase_seconds()["search"] > 0
    assert port_kernel("void harm_walk<4>(float const*)") == "harmpeaks"
    assert port_kernel("dedisperse_kernel<true>") == "dedisperse"
    assert port_kernel("at::native::vectorized_elementwise_kernel") is None


def test_scope_trace_leaves_out_the_warmup_and_counts_lost_launches():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from peasoup_tpu_torch.tools.scope_trace import (
        WARMUP_SCOPE, lost_launches, parse_events,
    )

    def op(i, name, parent=None):
        return NS(id=i, name=name, device_type=DeviceType.CPU, cpu_parent=parent,
                  linked_correlation_id=0)

    def kernel(i, name, launcher, us):
        return NS(id=i, name=name, device_type=DeviceType.CUDA, cpu_parent=None,
                  linked_correlation_id=launcher, device_time_total=us)

    warm, loop = op(1, WARMUP_SCOPE), op(3, "DM-Loop")
    events = [warm, op(2, "aten::add_", warm), loop, op(4, "Peaks", loop),
              kernel(10, "vectorized_elementwise_kernel<add>", 2, 1.0),
              kernel(11, "void harm_mask<4>(float const*)", 4, 5.0),
              kernel(12, "void harm_walk<4>(float const*)", 4, 2.0)]
    rows = parse_events(events, "cuda")
    # the warm-up's kernel is no row of the trace
    assert rows == [("DM-Loop/Peaks", 5.0, "void harm_mask<4>(float const*)"),
                    ("DM-Loop/Peaks", 2.0, "void harm_walk<4>(float const*)")]
    # a launch is held where its wrapper's last device function is
    assert lost_launches({"harmpeaks": 1}, rows) == {}
    assert lost_launches({"harmpeaks": 2, "dedisperse": 1}, rows) == {
        "harmpeaks": 1, "dedisperse": 1}
