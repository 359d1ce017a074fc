"""The port's resilience layer (peasoup_tpu_torch/resilience/) against the
JAX package's on the same inputs: the fault schedule, the retry delays,
the taxonomy, the degradation ladder, corrupt-artifact recovery, the
thread guard and the revoke seam, and the drivers' seams that use them
(fil.read, checkpoint.write, db.ingest, device.oom)."""

import errno
import json
import sqlite3
import threading

import numpy as np
import pytest
import torch

from peasoup_tpu import resilience as jres
from peasoup_tpu.obs.schema import SchemaError as JaxSchemaError
from peasoup_tpu.resilience import faults as jfaults
from peasoup_tpu_torch import resilience as tres
from peasoup_tpu_torch.obs.schema import SchemaError
from peasoup_tpu_torch.obs.telemetry import RunTelemetry
from peasoup_tpu_torch.resilience import faults as tfaults


@pytest.fixture(autouse=True)
def clean_plans():
    """No fault plan and fresh counters around every test, in both packages."""
    for f in (jfaults, tfaults):
        f.configure(None)
    tres.STATS.reset()
    yield
    for f in (jfaults, tfaults):
        f.configure(None)
    tres.STATS.reset()


def _fired(mod, site: str, calls: int, context=lambda i: f"call{i}") -> list[int]:
    """The 1-based invocations of ``site`` on which ``mod.fire`` raised."""
    out = []
    for i in range(1, calls + 1):
        try:
            mod.fire(site, context=context(i))
        except BaseException:  # worker.kill is a BaseException, like a kill
            out.append(i)
    return out


@pytest.mark.parametrize("site", tfaults.SITES)
@pytest.mark.parametrize("spec", ["{site}:p=0.3:n=40,seed=7", "{site}:p=0.05",
                                  "seed=3,{site}:p=0.5:n=5", "{site}:at=17",
                                  "{site}:n=3", "{site}"])
def test_one_spec_fires_alike_in_both_packages(site, spec):
    # the same grammar and the same seeded per-site streams: one spec and
    # seed fire on the same invocation ordinals in both, over 200 calls
    text = spec.format(site=site)
    got = []
    for mod in (jfaults, tfaults):
        mod.configure(text)
        got.append(_fired(mod, site, 200))
        mod.configure(None)
    assert got[0] == got[1]
    assert got[1], text  # every spec here fires at least once


def test_context_match_and_seed_env(monkeypatch):
    # at=<text> fires once where the invocation context holds the text;
    # PEASOUP_FAULT_SEED seeds a spec without seed=
    monkeypatch.setenv("PEASOUP_FAULT_SEED", "11")
    ctx = lambda i: f"search:shrink{i % 4}"  # noqa: E731
    got = []
    for mod in (jfaults, tfaults):
        mod.configure("device.oom:at=shrink2,fil.read:p=0.2")
        got.append((_fired(mod, "device.oom", 50, ctx), _fired(mod, "fil.read", 200)))
        mod.configure(None)
    assert got[0] == got[1]
    assert got[1][0] == [2]


def test_malformed_specs_fail_loudly():
    for bad in ("disk.melt", "fil.read:q=1", "fil.read:p"):
        with pytest.raises(ValueError):
            tfaults.parse_faults(bad)
        with pytest.raises(ValueError):
            jfaults.parse_faults(bad)


def test_injected_exceptions_classify_alike():
    # each site's injected failure belongs to the JAX class; device.oom is
    # the card's own form, which the drivers' handler catches
    for site in tfaults.SITES:
        t = tfaults._make_exception(site, "[t]")
        j = jfaults._make_exception(site, "[t]")
        if isinstance(t, Exception):
            assert tres.classify(t) == jres.classify(j), site
        else:
            assert type(t).__name__ == type(j).__name__ == "WorkerKilled"
    oom = tfaults._make_exception("device.oom", "[t]")
    assert isinstance(oom, torch.OutOfMemoryError)
    assert "RESOURCE_EXHAUSTED" not in str(oom)


def test_fire_records_event_stats_and_plan_log():
    tel = RunTelemetry()
    tfaults.configure("checkpoint.write:at=2")
    with tel.activate():
        assert _fired(tfaults, "checkpoint.write", 3) == [2]
    ev = [e for e in tel.events if e["kind"] == "fault_injected"]
    assert [(e["site"], e["ordinal"], e["context"]) for e in ev] == [
        ("checkpoint.write", 1, "call2")]
    assert tres.STATS.snapshot()["faults_injected"] == {"checkpoint.write": 1}
    assert tfaults.active_plan().to_doc()["injected"] == [
        {"site": "checkpoint.write", "ordinal": 1, "context": "call2"}]


@pytest.mark.parametrize("policy", ["IO_RETRY", "DB_RETRY", "default"])
def test_retry_delays_equal(policy):
    if policy == "default":
        t, j = tres.RetryPolicy(), jres.RetryPolicy()
    else:
        t, j = getattr(tres, policy), getattr(jres, policy)
    assert (t.max_attempts, t.base_delay_s, t.max_delay_s, t.jitter) == (
        j.max_attempts, j.base_delay_s, j.max_delay_s, j.jitter)
    for site in ("fil.read", "db.ingest", "checkpoint.write", ""):
        for attempt in range(1, 12):
            assert t.delay(attempt, site) == j.delay(attempt, site)


def _pairs():
    """(the port's exception, the JAX package's for the same failure)."""
    locked = sqlite3.OperationalError("database is locked")
    return [
        (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
         RuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating 2147483648 bytes")),
        (RuntimeError("cuFFT error: CUFFT_ALLOC_FAILED"),
         RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate")),
        (tres.TransientIOError(errno.EIO, "flaky"), jres.TransientIOError(errno.EIO, "flaky")),
        (locked, locked),
        (OSError(errno.EAGAIN, "again"), OSError(errno.EAGAIN, "again")),
        (TimeoutError(), TimeoutError()),
        (FileNotFoundError(2, "x"), FileNotFoundError(2, "x")),
        (PermissionError(13, "x"), PermissionError(13, "x")),
        (json.JSONDecodeError("x", "doc", 0), json.JSONDecodeError("x", "doc", 0)),
        (EOFError(), EOFError()),
        (tres.CorruptArtifactError("torn"), jres.CorruptArtifactError("torn")),
        (SchemaError("bad"), JaxSchemaError("bad")),
        (ValueError("bad input"), ValueError("bad input")),
        (RuntimeError("kernel launch failed: CUDA error 700"), RuntimeError("INTERNAL: x")),
    ]


@pytest.mark.parametrize("i", range(len(_pairs())))
def test_classify_matches_jax(i):
    t, j = _pairs()[i]
    assert tres.classify(t) == jres.classify(j)
    for fn in ("is_transient", "is_corrupt", "is_resource_exhausted"):
        assert getattr(tres, fn)(t) == getattr(jres, fn)(j), fn


def test_is_oom_is_the_taxonomy():
    # one definition: the drivers' ladders step on exactly what the
    # taxonomy calls resource_exhausted; a host MemoryError, which the JAX
    # package's counts too, is fatal here (halving the card's blocks frees
    # no host memory)
    from peasoup_tpu_torch.pipeline import search

    assert search._is_oom is tres.is_resource_exhausted
    assert tres.classify(MemoryError()) == tres.FATAL
    assert jres.classify(MemoryError()) == jres.RESOURCE_EXHAUSTED


def test_retry_recovers_and_gives_up():
    tel = RunTelemetry()
    calls = []

    def flaky(n):
        calls.append(1)
        if len(calls) <= n:
            raise tres.TransientIOError(errno.EIO, "flaky")
        return "ok"

    pol = tres.RetryPolicy(max_attempts=3, base_delay_s=0.0)
    with tel.activate():
        assert pol.call(flaky, 2, site="s") == "ok"
        calls.clear()
        with pytest.raises(tres.TransientIOError):
            pol.call(flaky, 5, site="s")
        with pytest.raises(ValueError):  # fatal: no retry
            pol.call(lambda: (_ for _ in ()).throw(ValueError("x")), site="f")
    kinds = [e["kind"] for e in tel.events]
    assert kinds == ["resilience_retry", "resilience_retry", "resilience_recovered",
                     "resilience_retry", "resilience_retry", "resilience_giveup"]
    snap = tres.STATS.snapshot()
    assert snap["retries"] == {"s": 4} and snap["giveups"] == {"s": 1}
    assert snap["recoveries"] == {"s": 1} and snap["degraded"]


@pytest.mark.parametrize("mod", [jres, tres], ids=["jax", "torch"])
def test_ladder_cannot_climb_back_up(mod):
    ladder = mod.DegradationLadder("x.memory", ("dm_block_shrink", "subband", "cpu_backend"))
    assert ladder.current_rung is None
    ladder.step("dm_block_shrink")
    ladder.step("dm_block_shrink")  # a rung repeats
    ladder.step("subband")
    with pytest.raises(ValueError, match="climb back up"):
        ladder.step("dm_block_shrink")
    with pytest.raises(ValueError):
        ladder.step("no_such_rung")
    assert ladder.steps == ["dm_block_shrink", "dm_block_shrink", "subband"]
    assert ladder.current_rung == "subband"


def test_ladder_events_match_jax():
    from peasoup_tpu.obs.telemetry import RunTelemetry as JaxTelemetry

    recs = []
    for mod, tel in ((jres, JaxTelemetry()), (tres, RunTelemetry())):
        with tel.activate():
            ladder = mod.DegradationLadder("search.memory", ("dm_block_shrink", "subband"))
            ladder.step("dm_block_shrink", dm_block_old=8, dm_block_new=4)
            ladder.step("subband", nsub=4)
            ladder.exhausted(dm_block=1)
        recs.append([{k: v for k, v in e.items() if k != "t"} for e in tel.events])
    assert recs[0] == recs[1]
    assert recs[1][0] == {"kind": "degradation", "ladder": "search.memory",
                          "rung": "dm_block_shrink", "rung_index": 0, "step": 1,
                          "dm_block_old": 8, "dm_block_new": 4}
    assert recs[1][-1]["kind"] == "degradation_exhausted"


def test_load_or_recover_quarantines(tmp_path):
    tel = RunTelemetry()
    path = tmp_path / "cache.json"
    path.write_text("{torn")
    loader = lambda p: json.load(open(p))  # noqa: E731
    with tel.activate():
        assert tres.load_or_recover(str(path), loader, default="dflt", kind="cache") == "dflt"
        # a missing file is a first run: the default, silently
        assert tres.load_or_recover(str(tmp_path / "none.json"), loader, default=7) == 7
    assert not path.exists()
    assert (tmp_path / "cache.json.corrupt").read_text() == "{torn"
    ev = [e for e in tel.events if e["kind"] == "corrupt_artifact"]
    assert len(ev) == 1 and ev[0]["quarantined_to"] == str(path) + ".corrupt"
    assert tres.STATS.snapshot()["corrupt_artifacts"] == {"cache": 1}
    path.write_text('{"ok": 1}')
    assert tres.load_or_recover(str(path), loader) == {"ok": 1}


def test_guard_thread_records_the_crash():
    tel = RunTelemetry()
    out = {}

    def body():
        raise RuntimeError("reader died")

    t = threading.Thread(target=lambda: out.setdefault(
        "exc", tres.guard_thread("peasoup-test", body, telemetry=tel)))
    t.start()
    t.join()
    assert isinstance(out["exc"], RuntimeError)
    ev = [e for e in tel.events if e["kind"] == "thread_crashed"]
    assert ev and ev[0]["thread"] == "peasoup-test" and "reader died" in ev[0]["error"]
    snap = tres.STATS.snapshot()
    assert snap["thread_crashes"] == {"peasoup-test": 1} and snap["degraded"]
    assert tres.guard_thread("fine", lambda: None, telemetry=tel) is None


def test_check_revoke_stops_only_when_revoked():
    tel = RunTelemetry()
    tres.check_revoke("search.wave")  # no token: nothing
    token = tres.RevokeToken()
    with tel.activate(), tres.activate_token(token):
        tres.check_revoke("search.wave")
        token.revoke("preempt", reason="higher priority")
        token.revoke("retire")  # the first revoke wins
        with pytest.raises(tres.SearchPreempted) as err:
            tres.check_revoke("search.wave")
    assert err.value.kind == "preempt" and tres.current_token() is None
    assert [e["kind"] for e in tel.events] == ["revoke_checkpoint_stop"]


def test_stats_delta_since():
    base = tres.STATS.snapshot()
    tres.STATS.retry("a")
    tres.STATS.degradation("l", "r")
    assert tres.STATS.delta_since(base) == {"retries": {"a": 1}, "degradations": {"l:r": 1}}


# --- the drivers' seams -------------------------------------------------------

@pytest.fixture(scope="module")
def small_fil(tmp_path_factory):
    from test_pipeline import make_synthetic_fil

    return make_synthetic_fil(tmp_path_factory.mktemp("torch_resilience"))[0]


@pytest.mark.parametrize("n,ok", [(2, True), (9, False)])
def test_fil_read_retries(small_fil, n, ok):
    # two flaky reads are absorbed by IO_RETRY's three attempts; nine spend
    # the budget and the read fails transient, as in the JAX package
    from peasoup_tpu_torch.io.sigproc import read_filterbank

    tel = RunTelemetry()
    tfaults.configure(f"fil.read:n={n}")
    with tel.activate():
        if ok:
            assert read_filterbank(small_fil).nsamps > 0
        else:
            with pytest.raises(tres.TransientIOError, match="injected"):
                read_filterbank(small_fil)
    kinds = [e["kind"] for e in tel.events]
    assert kinds.count("fault_injected") == (n if ok else 3)
    assert kinds[-1] == ("resilience_recovered" if ok else "resilience_giveup")


def test_checkpoint_write_retried(tmp_path):
    from peasoup_tpu_torch.pipeline.checkpoint import SearchCheckpoint

    tel = RunTelemetry()
    ck = SearchCheckpoint(str(tmp_path / "ck.npz"), "key")
    entry = (np.arange(3, dtype=np.int32), np.ones(3, np.float32), np.int32(3))
    tfaults.configure("checkpoint.write:at=1")
    with tel.activate():
        ck.save({0: entry})
    assert [e["kind"] for e in tel.events] == [
        "fault_injected", "resilience_retry", "resilience_recovered"]
    got = SearchCheckpoint(str(tmp_path / "ck.npz"), "key").load()
    assert list(got) == [0] and np.array_equal(got[0][0], entry[0])


def test_checkpoint_cache_corrupt_seam_quarantines(tmp_path):
    from peasoup_tpu_torch.pipeline.checkpoint import SearchCheckpoint

    path = tmp_path / "ck.npz"
    entry = (np.arange(3, dtype=np.int32), np.ones(3, np.float32), np.int32(3))
    SearchCheckpoint(str(path), "key").save({0: entry})
    tel = RunTelemetry()
    tfaults.configure("cache.corrupt:n=1")
    with tel.activate():
        assert SearchCheckpoint(str(path), "key").load() == {}
    assert (tmp_path / "ck.npz.corrupt").exists() and not path.exists()
    assert [e["kind"] for e in tel.events] == ["fault_injected", "corrupt_artifact"]


def test_db_ingest_retried(tmp_path):
    from peasoup_tpu_torch.campaign.db import CandidateDB

    tel = RunTelemetry()
    tfaults.configure("db.ingest:at=1")
    with tel.activate(), CandidateDB(str(tmp_path / "c.sqlite")) as db:
        db.ingest_sift_run("r1", {}, [], [], [])
    kinds = [e["kind"] for e in tel.events]
    assert kinds == ["fault_injected", "resilience_retry", "resilience_recovered"]
    assert tres.STATS.snapshot()["retries"] == {"db.ingest": 1}
