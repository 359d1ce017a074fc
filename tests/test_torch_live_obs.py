"""The port's CLIs observed, against the JAX package's on the same inputs:
the synthetic filterbank of tests/test_torch_search.py through both
packages' `peasoup` CLI with --metrics-json, and the single-pulse input of
tests/test_torch_spsearch.py through both `spsearch` CLIs. Both manifests
validate; the sequences of event kinds (stage names included) are equal,
apart from the events only the JAX package records (listed below); the
gauges are equal; an injected out-of-memory error is recorded alike and
leaves the candidates as they were; and the flags change no candidate."""

import json
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

from peasoup_tpu.cli.peasoup import main as jax_peasoup
from peasoup_tpu.cli.spsearch import main as jax_spsearch
from peasoup_tpu.obs.schema import validate_manifest as jax_validate
from peasoup_tpu.resilience import faults as jfaults
from peasoup_tpu_torch.cli.peasoup import main as peasoup
from peasoup_tpu_torch.cli.spsearch import main as spsearch
from peasoup_tpu_torch.obs.schema import validate_manifest
from peasoup_tpu_torch.resilience import faults as tfaults

# events only the JAX package records: its Pallas kernels' probes and
# fallbacks (the port takes its routes from choose_routes and the
# environment and never falls back), its asynchronous dedispersion
# dispatch, its CPU rung and its recompile accounting
JAX_ONLY = {
    "pallas_peaks_sub", "pallas_resample_disabled", "pallas_peaks_disabled",
    "mega_harm_disabled", "dedisp_async_dispatch", "oom_cpu_fallback",
    "sp_oom_cpu_fallback", "stream_steady_recompile", "sp_sharded_dedisp_fallback",
}
# the JAX package's Pallas-route ladders (a degradation on them is a
# kernel fallback, which the port does not have)
JAX_ONLY_LADDERS = {"search.pallas", "spsearch.kernel"}
# the cluster-slot escalation follows the route: the JAX package's plain
# route, which runs on the CPU, escalates on raw threshold crossings; its
# kernel route and the port (every route) on cluster counts
ROUTE_EVENTS = {"max_peaks_escalated"}

PEASOUP_FLAGS = ["--dm_start", "0", "--dm_end", "40", "--acc_start", "-2", "--acc_end", "2",
                 "-m", "6"]
SP_FLAGS = ["--dm_end", "60", "-m", "7", "--n_widths", "8"]


@contextmanager
def one_thread():
    """The port's CPU work on one thread, where its FFTs' bits do not
    depend on the batch height (tests/test_torch_search.py:one_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextmanager
def faults_active(spec):
    """``spec`` as both packages' fault plan for the duration."""
    for f in (jfaults, tfaults):
        f.configure(spec)
    try:
        yield
    finally:
        for f in (jfaults, tfaults):
            f.configure(None)


def _kinds(man, jax=False):
    out = []
    for e in man["events"]:
        if e["kind"] in ROUTE_EVENTS or (jax and e["kind"] in JAX_ONLY):
            continue
        if jax and e["kind"] == "degradation" and e["ladder"] in JAX_ONLY_LADDERS:
            continue
        out.append(e["kind"] + (f":{e['name']}" if e["kind"] == "stage" else ""))
    return out


def _load(path):
    return json.loads(Path(path).read_text())


@pytest.fixture(scope="module")
def fil(tmp_path_factory):
    from test_pipeline import make_synthetic_fil

    return str(make_synthetic_fil(tmp_path_factory.mktemp("torch_live_obs"))[0])


@pytest.fixture(scope="module")
def sp_fil(tmp_path_factory):
    import chip_smoke

    path = str(tmp_path_factory.mktemp("torch_live_obs_sp") / "sp.fil")
    chip_smoke.sp_small_fil(path)
    return path


@pytest.fixture(scope="module")
def runs(fil, tmp_path_factory):
    """Both packages' `peasoup` CLI on the synthetic input, with and
    without an injected out-of-memory error at the first search attempt:
    {(package, faulted): output directory}."""
    base = tmp_path_factory.mktemp("live_runs")
    out = {}
    for faulted in (False, True):
        spec = "device.oom:at=1" if faulted else None
        with faults_active(spec):
            d = base / f"jax{int(faulted)}"
            assert jax_peasoup(["-i", fil, "-o", str(d), *PEASOUP_FLAGS,
                                "--metrics-json", str(d / "m.json")]) == 0
            out["jax", faulted] = d
            d = base / f"torch{int(faulted)}"
            with one_thread():
                assert peasoup(["-i", fil, "-o", str(d), *PEASOUP_FLAGS, "--device", "cpu",
                                "--metrics-json", str(d / "m.json")]) == 0
            out["torch", faulted] = d
    return out


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("faulted", [False, True])
def test_manifests_validate_in_both_schemas(runs, pkg, faulted):
    man = _load(runs[pkg, faulted] / "m.json")
    validate_manifest(man)
    jax_validate(man)
    assert man["context"]["command"] == "peasoup"
    assert not (runs[pkg, faulted] / "flight.json").exists()


@pytest.mark.parametrize("faulted", [False, True])
def test_event_kinds_match_jax(runs, faulted):
    want = _kinds(_load(runs["jax", faulted] / "m.json"), jax=True)
    got = _kinds(_load(runs["torch", faulted] / "m.json"))
    assert got == want
    assert got[:3] == ["stage:reading", "stage:plan", "stage:dedispersion"]
    assert got[-2:] == ["stage:writing", "stage:done"]


def test_gauges_match_jax(runs):
    want = _load(runs["jax", False] / "m.json")
    got = _load(runs["torch", False] / "m.json")
    assert got["gauges"] == want["gauges"]
    assert got["gauges"]["candidates.written"] == 56
    # JAX's compilation-cache counters have no counterpart
    assert got["counters"] == {k: v for k, v in want["counters"].items()
                               if not k.startswith("jax.")}
    assert set(got["timers"]) == set(want["timers"])


def test_injected_oom_is_recorded_alike_and_recovered(runs):
    recs = []
    for pkg in ("jax", "torch"):
        man = _load(runs[pkg, True] / "m.json")
        ev = [e for e in man["events"] if e["kind"] in (
            "fault_injected", "oom_shrink_retry", "degradation")]
        recs.append([(e["kind"], e.get("site"), e.get("ladder"), e.get("rung"),
                      e.get("rung_index")) for e in ev])
        # the resilience section counts over the process's lifetime
        assert man["resilience"]["faults_injected"]["device.oom"] >= 1
        assert man["resilience"]["degradations"]["search.memory:dm_block_shrink"] >= 1
        # each package keeps its unfaulted candidates
        assert (runs[pkg, True] / "candidates.peasoup").read_bytes() == (
            runs[pkg, False] / "candidates.peasoup").read_bytes()
    assert recs[0] == recs[1] == [
        ("fault_injected", "device.oom", None, None, None),
        ("oom_shrink_retry", None, None, None, None),
        ("degradation", None, "search.memory", "dm_block_shrink", 0),
    ]


def test_default_manifest_beside_the_outputs(fil, runs, tmp_path):
    # with no flag, `peasoup` writes <outdir>/telemetry.json, as the JAX
    # CLI does; the observability flags change no candidate
    out = tmp_path / "plain"
    with one_thread():
        assert peasoup(["-i", fil, "-o", str(out), *PEASOUP_FLAGS, "--device", "cpu"]) == 0
    validate_manifest(_load(out / "telemetry.json"))
    flagged = tmp_path / "flagged"
    with one_thread():
        assert peasoup(["-i", fil, "-o", str(flagged), *PEASOUP_FLAGS, "--device", "cpu",
                        "--status-json", str(flagged / "status.json"),
                        "--heartbeat-interval", "0.05", "--log-level", "warning"]) == 0
    assert (flagged / "candidates.peasoup").read_bytes() == (
        out / "candidates.peasoup").read_bytes() == (
        runs["torch", False] / "candidates.peasoup").read_bytes()
    st = _load(flagged / "status.json")
    assert st["done"] is True and st["stage"] == "done"
    assert st["gauges"]["search.n_dm_trials"] == 30


def test_capture_device_trace_on_the_cpu(fil, runs, tmp_path):
    out = tmp_path / "traced"
    with one_thread():
        assert peasoup(["-i", fil, "-o", str(out), *PEASOUP_FLAGS, "--device", "cpu",
                        "--capture-device-trace"]) == 0
    tr = _load(out / "telemetry.json")["device_trace"]
    assert tr["device"] == "cpu" and tr["device_s"] > 0
    scopes = {r["scope"] for r in tr["table"]}
    assert {"Dedisperse", "DM-Loop/Spectrum-Chain", "DM-Loop/Acceleration-Loop"} <= scopes
    assert tr["phases"]["search"] > 0 and tr["phases"]["dedisp"] > 0
    assert tr["kernels"] and all(r["launches"] > 0 for r in tr["kernels"])
    # tracing changes no candidate
    assert (out / "candidates.peasoup").read_bytes() == (
        runs["torch", False] / "candidates.peasoup").read_bytes()


@pytest.fixture(scope="module")
def sp_runs(sp_fil, tmp_path_factory):
    base = tmp_path_factory.mktemp("live_sp")
    out = {}
    for faulted in (False, True):
        with faults_active("device.oom:at=1" if faulted else None):
            d = base / f"jax{int(faulted)}"
            assert jax_spsearch(["-i", sp_fil, "-o", str(d), *SP_FLAGS]) == 0
            out["jax", faulted] = d
            d = base / f"torch{int(faulted)}"
            assert spsearch(["-i", sp_fil, "-o", str(d), *SP_FLAGS, "--device", "cpu"]) == 0
            out["torch", faulted] = d
    return out


@pytest.mark.parametrize("faulted", [False, True])
def test_spsearch_manifest_matches_jax(sp_runs, faulted):
    want = _load(sp_runs["jax", faulted] / "telemetry.json")
    got = _load(sp_runs["torch", faulted] / "telemetry.json")
    validate_manifest(got)
    assert _kinds(got) == _kinds(want, jax=True)
    assert got["gauges"] == want["gauges"]
    if faulted:
        # the resilience section counts over the process's lifetime
        assert got["resilience"]["degradations"]["spsearch.memory:dm_block_shrink"] >= 1
        assert [(e["ladder"], e["rung"], e["rung_index"]) for e in got["events"]
                if e["kind"] == "degradation"] == [("spsearch.memory", "dm_block_shrink", 0)]
        assert (sp_runs["torch", True] / "candidates.singlepulse").read_bytes() == (
            sp_runs["torch", False] / "candidates.singlepulse").read_bytes()
