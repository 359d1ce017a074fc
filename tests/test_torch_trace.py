"""The port's span-and-counter recorder (utils/trace.py): off while no
profiler records (no ``record_function`` entered, no table), its tables
under a CPU profiler (nesting, parents, counters on the innermost span,
starts on the profiler's clock), the interval arithmetic that names idle
gaps, and the synthetic filterbank of tests/test_torch_search.py searched
under a CPU profiler: the search's spans and counters, the candidates
bitwise those of an untraced run, and neither the stage timers nor the
telemetry's counters touched. Also the operator's capture folding the
run's table into the manifest (tools/scope_trace.py, obs/telemetry.py)."""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.obs.schema import validate_manifest
from peasoup_tpu_torch.obs.telemetry import RunTelemetry
from peasoup_tpu_torch.pipeline.search import (
    PeasoupSearch, SearchConfig, _dedupe_identity_accels,
)
from peasoup_tpu_torch.tools.scope_trace import SCOPES, scope_trace
from peasoup_tpu_torch.utils import trace
from peasoup_tpu_torch.utils.trace import (
    Innermost, Stopwatch, gaps, recorded_runs, run_tables, trace_count, trace_span,
    union_length,
)
from test_torch_search import KW, _bits, one_thread, synthetic  # noqa: F401

# the spans the search opens on the CPU path (device seconds only on a card)
SEARCH_SPANS = {"Search", "Dedisperse", "Upload", "DM-Loop", "Whitening", "Spectrum-Chain",
                "Acceleration-Loop", "Resample", "Harmonic summing", "Peaks", "Wave-Fetch",
                "Fetch", "Search-Host", "Distil-Rows", "Distil-Native", "Distil-Objects",
                "Distilling", "Scoring"}
DISTIL = ("Distil-Rows", "Distil-Native", "Distil-Objects")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def entered(monkeypatch):
    """Counts the record_function scopes the recorder enters."""
    calls = []
    real = trace.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(trace, "record_function", counting)
    return calls


def _search(path, **kw):
    with one_thread():
        return PeasoupSearch(SearchConfig(**KW, **kw), device="cpu").run(read_filterbank(path))


@pytest.fixture(scope="module")
def untraced(synthetic):  # noqa: F811
    return _search(synthetic[0])


@pytest.fixture(scope="module")
def traced(synthetic):  # noqa: F811
    """The synthetic search under a CPU profiler, with a telemetry active:
    (result, its table, the telemetry)."""
    tel = RunTelemetry(run_id="traced")
    with tel.activate(), _cpu_profile():
        res = _search(synthetic[0])
    return res, res.trace, tel


def test_off_enters_no_record_function_and_records_nothing(entered):
    n = recorded_runs()
    sw = Stopwatch()
    with trace_span("Search", root=True) as table:
        with trace_span("Fetch", sw):
            trace_count("wave.fetches")
    assert table is None and entered == []
    assert recorded_runs() == n
    assert sw.elapsed > 0.0 and sw.name == "Fetch"


def test_off_search_enters_no_record_function(synthetic, entered, untraced):  # noqa: F811
    n = recorded_runs()
    res = _search(synthetic[0])
    assert entered == [] and recorded_runs() == n
    assert res.trace is None and untraced.trace is None


def test_on_nests_counts_on_the_innermost_span_and_keeps_the_profiler_clock(entered):
    n = recorded_runs()
    with _cpu_profile() as prof:
        with trace_span("Search", root=True) as table:
            trace_count("top")
            for _ in range(3):
                with trace_span("DM-Loop"):
                    with trace_span("Fetch"):
                        trace_count("wave.fetches")
                        trace_count("wave.fetch_bytes", 64)
                        torch.ones(16).sum()
                    trace_count("rows.dispatched", 5)
            with trace_span("Fetch"):
                pass
    assert recorded_runs() == n + 1 and run_tables()[-1] is table
    assert entered.count("Fetch") == 4 and entered.count("DM-Loop") == 3
    spans = table.spans
    assert set(spans) == {("Search", None), ("DM-Loop", "Search"), ("Fetch", "DM-Loop"),
                          ("Fetch", "Search")}
    assert spans["Fetch", "DM-Loop"].counters == {"wave.fetches": 3, "wave.fetch_bytes": 192}
    assert spans["DM-Loop", "Search"].counters == {"rows.dispatched": 15}
    assert spans["Search", None].counters == {"top": 1}
    assert table.calls("Fetch") == 4 and table.count("wave.fetches") == 3
    assert table.wall_s("Search") >= table.wall_s("DM-Loop") >= spans["Fetch", "DM-Loop"].wall_s
    assert table.cpu_s("Search") > 0 and table.device_s("Search") is None
    assert table.wall_s("Whitening") is None and table.count("absent") == 0
    # each call's start on the profiler's clock: its own record_function event's
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CPU and e.name in ("DM-Loop", "Fetch")),
                    key=lambda e: e.time_range.start)
    mine = sorted((a, n) for a, _, n in table.intervals() if n in ("DM-Loop", "Fetch"))
    assert [n for _, n in mine] == [e.name for e in events]
    for (start, _), e in zip(mine, events):
        assert abs((start - t0) / 1e3 - e.time_range.start) < 100.0
    assert table.start_ns <= mine[0][0] and table.as_dict()["root"] == "Search"


def test_interval_arithmetic():
    busy = [(0, 4), (2, 6), (10, 12), (11, 11.5)]
    assert union_length(busy) == 8
    assert gaps(busy, -1, 14) == [(-1, 0), (6, 10), (12, 14)]
    host = Innermost([(0, 20, "Search"), (5, 9, "Fetch"), (9, 13, "Distil-Rows")])
    assert [host.at(t) for t in (-1, 0, 5, 8.9, 9, 13, 20)] == [
        None, "Search", "Fetch", "Fetch", "Distil-Rows", "Search", None]
    assert host.split(6, 10) == [(6, 9, "Fetch"), (9, 10, "Distil-Rows")]
    assert host.split(12, 16) == [(12, 13, "Distil-Rows"), (13, 16, "Search")]


def test_the_search_table_holds_its_spans_and_counters(synthetic, traced):  # noqa: F811
    res, table, tel = traced
    names = {n for n, _ in table.spans}
    assert SEARCH_SPANS <= names
    parents = {n: p for n, p in table.spans}
    assert parents["Upload"] == "Dedisperse" and parents["Whitening"] == "DM-Loop"
    assert parents["Spectrum-Chain"] in ("Whitening", "Acceleration-Loop")
    assert ("Spectrum-Chain", "Whitening") in table.spans
    assert parents["Fetch"] == "Wave-Fetch" and parents["Wave-Fetch"] == "DM-Loop"
    for part in DISTIL:
        assert parents[part] == "Search-Host" and table.wall_s(part) > 0
    assert parents["Search-Host"] == parents["Distilling"] == parents["Scoring"] == "Search"
    assert sum(table.wall_s(p) for p in DISTIL) <= res.timers["search_host"]
    # the counters
    assert table.count("distil.candidates_out") == tel.gauges["candidates.per_dm_distill"]
    assert table.count("distil.rows_in") >= table.count("distil.harmonic_survivors") > 0
    fil = read_filterbank(synthetic[0])
    plan = PeasoupSearch(SearchConfig(**KW), device="cpu").build_plan(fil)
    lists, _ = _dedupe_identity_accels(plan.accel_lists, fil.tsamp, plan.size)
    assert table.count("rows.dispatched") >= sum(len(a) for a in lists)
    assert 0 <= table.count("rows.redispatched") <= table.count("rows.dispatched")
    assert table.count("upload.bytes") == fil.data.nbytes
    assert table.count("whitening.trials") == plan.ndm
    assert table.count("wave.fetches") >= table.count("wave.rounds") >= 1
    assert table.count("wave.fetch_bytes") > 0
    assert res.trace is run_tables()[-1]


def test_tracing_changes_no_candidate_timer_or_telemetry_counter(untraced, traced):
    res, table, tel = traced
    assert _bits(res) == _bits(untraced)
    assert set(res.timers) == set(untraced.timers)
    spans = {s for s, _ in table.spans}
    counters = set(table.counters())
    for key in list(tel.counters) + list(tel.gauges) + list(tel.timers):
        assert key not in counters and key not in spans


def test_escalation_counts_the_rows_dispatched_again(synthetic):  # noqa: F811
    with _cpu_profile():
        res = _search(synthetic[0], max_peaks=1)
    t = res.trace
    assert 0 < t.count("rows.redispatched") <= t.count("rows.dispatched") / 2
    assert ("Acceleration-Loop", "Wave-Fetch") in t.spans


def test_capture_folds_the_table_and_names_idle_gaps(synthetic, tmp_path):  # noqa: F811
    with scope_trace("cpu") as res, one_thread():
        PeasoupSearch(SearchConfig(**KW), device="cpu").run(read_filterbank(synthetic[0]))
    assert [t["root"] for t in res.spans] == ["Search"]
    assert set(res.idle_gaps) <= set(SCOPES) | {"between spans"}
    assert set(DISTIL) <= set(res.idle_gaps)
    idle = sum(res.idle_gaps.values())
    assert 0 < res.busy_s < res.window_s
    assert idle == pytest.approx(res.window_s - res.busy_s, rel=1e-6)
    # the manifest's device_trace, through the operator's capture
    tel = RunTelemetry(run_id="capture", capture_device_trace=True)
    with tel.activate(), tel.device_capture("cpu"), one_thread():
        PeasoupSearch(SearchConfig(**KW), device="cpu").run(read_filterbank(synthetic[0]))
    dt = tel.device_trace
    assert dt["spans"][0]["root"] == "Search"
    assert {s["name"] for s in dt["spans"][0]["spans"]} >= SEARCH_SPANS
    assert dt["idle_gaps"] and dt["window_s"] > dt["busy_s"] > 0
    validate_manifest(tel.to_manifest())
