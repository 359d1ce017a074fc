"""The port's multi-process layer (peasoup_tpu_torch/parallel/multihost.py)
on the CPU: its pure parts against the JAX package's, its per-slice
checkpoint files read by either package, the file-backed GangComm, and two
real processes joined by a gloo process group (tests/torch_multihost_worker.py)
running every driver and the `peasoup` CLI.

Two processes give the single-process result bitwise: the worker's
configurations search each DM trial as a block of its own, so a slice's
CPU FFT batches are the whole run's; each fold is made by one process and
exchanged. Every subprocess has its own timeout (120 s) and two threads,
and the workers import the port only.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import torch_multihost_worker as W
from peasoup_tpu.parallel import multihost as jmh
from peasoup_tpu.pipeline.checkpoint import SearchCheckpoint as JaxCheckpoint
from peasoup_tpu_torch.parallel import multihost as tmh
from peasoup_tpu_torch.pipeline.checkpoint import SearchCheckpoint
from peasoup_tpu_torch.resilience import TransientIOError, is_transient
from test_pipeline import make_synthetic_fil

WORKER = Path(__file__).with_name("torch_multihost_worker.py")
ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120


def test_dm_slice_for_process_is_jax():
    for ndm in (0, 1, 2, 5, 7, 59, 77, 179):
        for nproc in (1, 2, 3, 4, 8, 100):
            slices = [tmh.dm_slice_for_process(ndm, nproc, pid) for pid in range(nproc)]
            assert slices == [jmh.dm_slice_for_process(ndm, nproc, pid)
                              for pid in range(nproc)]
            # contiguous, ascending, covering, balanced to one trial
            assert slices[0][0] == 0 and slices[-1][1] == ndm
            assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
            sizes = [hi - lo for lo, hi in slices]
            assert max(sizes) - min(sizes) <= 1


def test_single_process_needs_no_group(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    tmh.initialize()  # nothing to join
    assert (tmh.process_count(), tmh.process_index()) == (1, 0)
    assert tmh._allgather_pickled(b"x") == [b"x"]
    assert tmh._comm_topology(None)[:2] == (1, 0)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    tmh.initialize()  # one process named: still nothing to join
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        tmh.initialize()


def test_environment_topology(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
              "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmh._env_topology() == (None, None, None)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "host0")
    monkeypatch.setenv("MASTER_PORT", "8476")
    assert tmh._env_topology() == ("host0:8476", 4, 3)
    # the JAX package's variables win, so one launch script serves both
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert tmh._env_topology() == ("host1:1234", 2, 1)


def test_process_device(monkeypatch):
    import torch

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert tmh.process_device("cpu", 4, 3) == torch.device("cpu")
    assert tmh.process_device("cuda:1", 4, 3) == torch.device("cuda", 1)
    assert tmh.process_device("cuda", 1, 0) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmh.process_device("cuda", 4, 3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert tmh.process_device("cuda", 4, 3) == torch.device("cuda", 0)


@pytest.mark.parametrize("msg,transient,jax_too", [
    ("Connection closed by peer [127.0.0.1]:4242", True, True),
    ("DEADLINE_EXCEEDED: barrier timed out", True, True),
    ("UNAVAILABLE: coordination service is shutting down", True, True),
    ("Tensors must be contiguous", False, True),
    # gloo's words for a silent peer, which the JAX runtime never raises
    ("[gloo] Timed out waiting 60000ms for recv operation to complete", True, False),
])
def test_collective_errors_classify_as_jax(msg, transient, jax_too):
    for mod in (tmh, jmh) if jax_too else (tmh,):
        with pytest.raises(Exception) as ei:
            mod._classify_collective_error(RuntimeError(msg), "test")
        assert is_transient(ei.value) == transient, (mod.__name__, msg)
        assert (type(ei.value).__name__ == "TransientIOError") == transient


def test_unpickle_all_classifies_a_torn_blob():
    import pickle as p

    assert tmh._unpickle_all([p.dumps([1]), p.dumps("a")]) == [[1], "a"]
    with pytest.raises(p.UnpicklingError):
        tmh._unpickle_all([b"\x80\x04torn"])


# --- per-slice checkpoint files, read by either package ----------------------


def _payload(g):
    return (np.full((2, 4), g, dtype=np.int32), np.full((4,), 0.5 * g, dtype=np.float32),
            np.asarray(g, dtype=np.int32))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("nwrite,nread", [(2, 1), (2, 3), (3, 2), (1, 4)])
def test_slice_checkpoints_cross_read(tmp_path, writer, reader, nwrite, nread):
    # tests/test_pipeline.py's process-count independence, across the two
    # packages: one package's processes each write their slice's sibling
    # file with local keys; the other package, under any process count,
    # restores every trial of its own slices, re-keyed locally
    classes = {"port": SearchCheckpoint, "jax": JaxCheckpoint}
    base, key, ndm = str(tmp_path / "search.ckpt"), "config-key-A", 7
    for pid in range(nwrite):
        lo, hi = tmh.dm_slice_for_process(ndm, nwrite, pid)
        bounds = (lo, hi) if nwrite > 1 else None
        classes[writer](base, key, slice_bounds=bounds).save(
            {g - lo: _payload(g) for g in range(lo, hi)})
    names = sorted(os.listdir(tmp_path))
    assert len(names) == nwrite
    seen = []
    for pid in range(nread):
        lo, hi = tmh.dm_slice_for_process(ndm, nread, pid)
        bounds = (lo, hi) if nread > 1 else None
        part = classes[reader](base, key, slice_bounds=bounds).load()
        assert sorted(k + lo for k in part) == list(range(lo, hi))
        for k, (idxs, snrs, counts) in part.items():
            assert idxs[0, 0] == k + lo and snrs[0] == 0.5 * (k + lo)
            assert int(counts) == k + lo
        seen.extend(k + lo for k in part)
    assert sorted(seen) == list(range(ndm))
    assert classes[reader](base, "config-key-B").load() == {}


# --- GangComm ------------------------------------------------------------------


def test_gang_comm_timeout_is_transient(tmp_path):
    comm = tmh.GangComm(str(tmp_path / "gang"), nprocs=2, rank=0, timeout_s=0.2,
                        poll_s=0.01)
    t0 = time.monotonic()
    with pytest.raises(TransientIOError, match=r"rank \[1\] missing") as ei:
        comm.allgather(b"hello", context="test:join")
    assert is_transient(ei.value) and time.monotonic() - t0 < 5.0


def test_gang_comm_exchange_in_order_and_abort(tmp_path):
    d = str(tmp_path / "gang")
    a = tmh.GangComm(d, nprocs=2, rank=0, timeout_s=5.0, poll_s=0.01)
    b = tmh.GangComm(d, nprocs=2, rank=1, timeout_s=5.0, poll_s=0.01)
    out = {}
    member = threading.Thread(target=lambda: out.update(
        b=[b.allgather(b"from-b", context="x"), b.allgather(b"b2", context="y")]))
    member.start()
    got_a = [a.allgather(b"from-a", context="x"), a.allgather(b"a2", context="y")]
    member.join(10)
    assert got_a == out["b"] == [[b"from-a", b"from-b"], [b"a2", b"b2"]]
    # a peer's abort fails the next round fast
    b.abort("member crashed")
    t0 = time.monotonic()
    with pytest.raises(TransientIOError, match="aborted"):
        a.allgather(b"a3", context="z")
    assert time.monotonic() - t0 < 2.0


def test_gang_comm_drives_the_merge(tmp_path):
    # the drivers' merge runs over a GangComm as over the process group
    d = str(tmp_path / "gang")
    comms = [tmh.GangComm(d, nprocs=2, rank=r, timeout_s=5.0, poll_s=0.01)
             for r in range(2)]
    out = [None, None]

    def member(r):
        n, rank, gather = tmh._comm_topology(comms[r])
        out[r] = tmh._merge(gather, {"rank": rank, "n": n}, "test:merge")

    threads = [threading.Thread(target=member, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert out[0] == out[1] == [{"rank": 0, "n": 2}, {"rank": 1, "n": 2}]


# --- two real processes ----------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, tmp_path, spec, attempts=2):
    """Two worker processes of MODE; returns their pickled results. A run
    that fails is retried once on a fresh port (probing a free port races
    with the rest of the machine)."""
    last = ""
    for attempt in range(attempts):
        port = _free_port()
        outs = [tmp_path / f"{mode}{attempt}.rank{r}.pkl" for r in range(2)]
        procs = []
        for r in range(2):
            env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r),
                       OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
            env.pop("LOCAL_RANK", None)
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), mode, str(outs[r]), json.dumps(spec)],
                env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"{mode} worker passed its {TIMEOUT_S} s limit")
        if all(p.returncode == 0 for p in procs):
            return [pickle.loads(o.read_bytes()) if o.exists() else None for o in outs]
        last = "\n".join(f"rank{r} rc={p.returncode}\n{log[-3000:]}"
                         for r, (p, log) in enumerate(zip(procs, logs)))
    pytest.fail(f"{mode} workers failed after {attempts} attempts:\n{last}")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    search_fil, _, _ = make_synthetic_fil(d)
    chip_smoke.sp_small_fil(str(d / "sp.fil"))
    chip_smoke.fdas_small_fil(str(d / "fdas.fil"))
    return dict(search_fil=str(search_fil), sp_fil=str(d / "sp.fil"),
                fdas_fil=str(d / "fdas.fil"), cli_out=str(d / "cli"), dir=d)


@pytest.fixture(scope="module")
def single(inputs):
    # the same drivers in this one process: each is the plain search
    return W.run_drivers(inputs)


@pytest.fixture(scope="module")
def two(inputs, tmp_path_factory):
    spec = {k: v for k, v in inputs.items() if k != "dir"}
    return _launch("drivers", tmp_path_factory.mktemp("two"), spec)


@pytest.mark.parametrize("driver", ["search", "sp", "fdas", "folds"])
def test_two_processes_give_the_single_process_result(single, two, driver):
    assert [r["nproc"] for r in two] == [2, 2]
    assert two[0][driver] == two[1][driver]  # every process holds the result
    assert two[0][driver] == single[driver]
    assert len(single[driver]) > 0


def test_two_processes_count_every_trial(single, two):
    for r in two:
        assert r["n_accel_trials"] == single["n_accel_trials"]
        assert r["fdas_trials"] == single["fdas_trials"]
        np.testing.assert_array_equal(r["search_dm_list"], single["search_dm_list"])
    # the folded candidates were folded by the process that owns the trial
    assert sum(1 for row in single["search"] if row[6] > 0) == 4


def test_only_rank_zero_writes(inputs, two):
    assert [r["cli_rc"] for r in two] == [0, 0]
    out0, out1 = Path(inputs["cli_out"] + "0"), Path(inputs["cli_out"] + "1")
    assert (out0 / "candidates.peasoup").stat().st_size > 0
    assert (out0 / "overview.xml").exists()
    assert not out1.exists()


def test_a_dead_peer_fails_the_exchange_fast(tmp_path):
    rank0, _ = _launch("dead_peer", tmp_path, {"timeout_s": 30.0})
    assert rank0["raised"] == "TransientIOError", rank0
    assert rank0["waited"] < 30.0
