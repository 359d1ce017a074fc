"""Multi-process execution: the JAX package's parallel/multihost.py over
``torch.distributed``.

The reference scales no further than one node: pthread workers over the
local GPUs (src/pipeline_multi.cu:33-81). Here, as in the JAX package,
each process searches a contiguous slice of the global DM-trial list on
its own card(s), the per-DM candidates (or events, or fold outcomes) are
exchanged, and every process runs the same global finalize, so every
process holds the same result; the CLIs' rank 0 writes it.

Topology comes from the environment, so one launch script serves both
packages: ``JAX_COORDINATOR_ADDRESS`` (host:port, or a URL),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``; where those are absent,
torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``. With
neither, a run is one process and nothing here does anything. Each
process of a CUDA run takes card ``LOCAL_RANK % device_count`` (the rank
where ``LOCAL_RANK`` is unset). The per-process runs go through the same
drivers as a single process's, so with ``tune`` each process resolves its
own dedispersion plan from the tuning cache on its own card, as the JAX
package's processes do (processes that share a cache file write it in
turn, and the last writer wins).

The exchange is ``dist.all_gather_object`` on a gloo process group, in
rank order: the payloads are host lists, and gloo, unlike NCCL, serves
two processes that share one card. Every wait is bounded: the group's
timeout (``initialize(timeout_s=...)``) and :class:`GangComm`'s, so a
peer that died fails the collective fast, as a :class:`TransientIOError`,
and the run fails with it; nothing continues alone.

Deployment, one process per card:

    JAX_COORDINATOR_ADDRESS=host0:8476 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=$RANK \\
        python -m peasoup_tpu_torch.cli.peasoup -i obs.fil ...
    torchrun --nproc_per_node 8 -m peasoup_tpu_torch.cli.peasoup -i obs.fil ...

Each process tags its telemetry with its rank, the process count, its
host and its DM slice (``set_context``) and records ``multihost_slice``
(or ``multihost_fold``), so its manifest shard (``telemetry.procN.json``,
written by the CLIs) identifies itself. The exchange carries the JAX
package's fault seams: ``multihost.barrier`` at every collective and
``multihost.merge`` where the blobs are combined, both raising
TransientIOError when a ``PEASOUP_FAULTS`` schedule fires them.
"""

from __future__ import annotations

import dataclasses
import datetime
import errno as _errno
import os
import pickle
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..obs.log import get_logger
from ..obs.telemetry import current as current_telemetry
from ..obs.trace import flow_id_for, job_span
from ..resilience import faults
from ..resilience.errors import TransientIOError
from .mesh import Mesh, local_devices, make_mesh

log = get_logger("parallel.multihost")

# how long a collective (or the rendezvous) waits for a peer
DEFAULT_TIMEOUT_S = 600.0

# message fragments that identify a distributed-runtime failure (a peer
# died at the exchange, the rendezvous timed out, a link dropped) as
# opposed to a programming error inside the collective: the JAX
# package's, and gloo's own words for a closed or silent peer
_COLLECTIVE_TRANSIENT_TOKENS = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "connection",
    "heartbeat",
    "barrier",
    "coordination service",
    "shutting down",
    "timed out",
    "timeout",
    "closed",
)


def _classify_collective_error(exc: Exception, context: str) -> None:
    """Re-raise a collective failure as a TransientIOError when it carries
    a distributed-runtime signature (a peer dying at the exchange fails
    the step fast, and a campaign's attempt budget retries it); anything
    else propagates unchanged."""
    msg = str(exc)
    low = msg.lower()
    if any(t.lower() in low for t in _COLLECTIVE_TRANSIENT_TOKENS):
        raise TransientIOError(
            _errno.ECONNRESET, f"multihost collective failed ({context}): {msg:.300}",
        ) from exc
    raise exc


def _env_topology() -> tuple[str | None, int | None, int | None]:
    """(coordinator, number of processes, this process's id) from the JAX
    package's variables, else torchrun's, else Nones."""
    env = os.environ
    if env.get("JAX_COORDINATOR_ADDRESS") or env.get("JAX_NUM_PROCESSES"):
        n, pid = env.get("JAX_NUM_PROCESSES"), env.get("JAX_PROCESS_ID")
        return (env.get("JAX_COORDINATOR_ADDRESS"), int(n) if n else None,
                int(pid) if pid else None)
    if env.get("WORLD_SIZE"):
        addr = f"{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}"
        return addr, int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
    return None, None, None


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the multi-process group (gloo, ``tcp://coordinator``). With no
    arguments, reads the environment (module docstring). A no-op when the
    group exists already or the run is one process."""
    if dist.is_initialized():
        return
    env_coord, env_n, env_pid = _env_topology()
    coordinator = coordinator or env_coord
    num_processes = num_processes if num_processes is not None else env_n
    process_id = process_id if process_id is not None else env_pid
    if num_processes in (None, 1):
        return  # single-process: nothing to do
    if coordinator is None or process_id is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address and a process "
            "id (JAX_COORDINATOR_ADDRESS and JAX_PROCESS_ID, or torchrun's "
            "MASTER_ADDR/MASTER_PORT and RANK)"
        )
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    try:
        dist.init_process_group(
            "gloo", init_method=init, world_size=int(num_processes),
            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s),
        )
    except Exception as exc:
        _classify_collective_error(exc, "initialize")
    log.info("process %d of %d joined at %s", process_id, num_processes, init)


# (world size, rank) of a group torn down after a failed collective: the
# process stays one of that many, and every later exchange fails
_torn_down: tuple[int, int] | None = None


def process_count() -> int:
    if _torn_down is not None:
        return _torn_down[0]
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    if _torn_down is not None:
        return _torn_down[1]
    return dist.get_rank() if dist.is_initialized() else 0


def _tear_down_group(context: str) -> None:
    """Destroy the process group after a failed collective, before the
    error propagates: left to the interpreter's exit, the group's
    destructor can meet the dead peer's socket and abort the process."""
    global _torn_down
    if not dist.is_initialized():
        return
    _torn_down = (dist.get_world_size(), dist.get_rank())
    try:
        dist.destroy_process_group()
    except Exception as exc:  # the collective's own error is the one to raise
        log.warning("destroying the process group after %s failed: %s", context, exc)


def process_device(device: str | torch.device, nprocs: int, rank: int) -> torch.device:
    """This process's device: in a run of several processes an unindexed
    ``cuda`` becomes card ``LOCAL_RANK % device_count`` (the rank where
    ``LOCAL_RANK`` is unset); anything else stays as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or nprocs == 1:
        return dev
    count = torch.cuda.device_count()
    if count == 0:
        return dev  # the search's own check raises
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % count)


def global_mesh(
    axes: dict[str, int], dcn_axis: str | None = None,
    device: str | torch.device = "cuda",
) -> Mesh:
    """A mesh over every process's local devices, in process order (the
    processes exchange their device lists). ``dcn_axis`` names the axis
    that crosses processes: it is laid out as the leading dimension, so
    consecutive devices along every other axis stay within one process.
    ``-1`` sizes resolve as in make_mesh. A device of another process is
    named by its torch.device on that process; ``mesh.processes`` holds
    each device's process."""
    local = [str(d) for d in local_devices(device)]
    per_proc = _unpickle_all(
        _allgather_pickled(pickle.dumps(local), context="global_mesh"),
        context="global_mesh",
    )
    devs = [d for lst in per_proc for d in lst]
    procs = [p for p, lst in enumerate(per_proc) for _ in lst]
    if dcn_axis is not None and dcn_axis in axes:
        names = [dcn_axis] + [n for n in axes if n != dcn_axis]
        axes = {n: axes[n] for n in names}
    mesh = make_mesh(axes, devices=devs)
    mesh.processes = np.asarray(procs, dtype=np.int64).reshape(mesh.devices.shape)
    return mesh


def dm_slice_for_process(
    ndm: int, num_processes: int, process_id: int
) -> tuple[int, int]:
    """Contiguous, balanced [lo, hi) slice of the global DM-trial list for
    one process (the multi-process analogue of the reference's DMDispenser
    dealing trials to per-GPU workers, pipeline_multi.cu:54-74; static
    dealing keeps it deterministic)."""
    base, extra = divmod(ndm, num_processes)
    lo = process_id * base + min(process_id, extra)
    return lo, lo + base + (1 if process_id < extra else 0)


def _allgather_pickled(payload: bytes, context: str = "") -> list[bytes]:
    """Exchange one pickled blob per process; returns every process's blob
    in process order. Single-process: identity. A peer that died raises
    TransientIOError within the group's timeout. ``multihost.barrier`` is
    this collective's fault seam."""
    faults.fire("multihost.barrier", context=context)
    n = process_count()
    if n == 1:
        return [payload]
    if _torn_down is not None:
        raise TransientIOError(
            _errno.ECONNRESET,
            f"multihost collective failed ({context or 'allgather'}): the process "
            "group was torn down after an earlier exchange failed",
        )
    out: list = [None] * n
    try:
        dist.all_gather_object(out, payload)
    except Exception as exc:
        _tear_down_group(context or "allgather")
        _classify_collective_error(exc, context or "allgather")
    return out


class GangComm:
    """File-backed allgather for N worker processes without a process
    group: pickled blobs go through a shared gang directory, so the
    drivers below run unchanged with this object supplying ``nprocs``,
    ``rank`` and ``allgather`` (the JAX package's campaign gangs).

    Each collective round writes ``r<round>.rank<k>`` (a temporary file
    and an atomic rename) and waits for every rank's blob. A member that
    dies, or a peer that calls :meth:`abort`, surfaces as a
    ``TransientIOError`` at the next round, never a hang.
    """

    def __init__(
        self,
        gang_dir: str,
        nprocs: int,
        rank: int,
        timeout_s: float = 600.0,
        poll_s: float = 0.05,
        heartbeat=None,
    ) -> None:
        self.gang_dir = os.path.abspath(gang_dir)
        self.nprocs = int(nprocs)
        self.rank = int(rank)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self._heartbeat = heartbeat  # called during waits
        self._round = 0
        os.makedirs(self.gang_dir, exist_ok=True)

    def _blob_path(self, rnd: int, rank: int) -> str:
        return os.path.join(self.gang_dir, f"r{rnd:03d}.rank{rank}")

    def abort(self, reason: str) -> None:
        """Mark the gang aborted so peers fail fast at their next round
        instead of running out the timeout."""
        try:
            with open(os.path.join(self.gang_dir, f"abort.rank{self.rank}"), "w") as f:
                f.write(f"{reason}\n")
        except OSError:
            pass  # the timeout remains the backstop

    def _aborted(self) -> str | None:
        try:
            for name in os.listdir(self.gang_dir):
                if name.startswith("abort."):
                    return name
        except FileNotFoundError:
            return "gang directory removed"
        return None

    def allgather(
        self, payload: bytes, context: str = "", timeout_s: float | None = None,
    ) -> list[bytes]:
        """Exchange one blob per member; returns every member's blob in
        rank order. The ``multihost.barrier`` fault seam fires here, as it
        does for the process group's collective."""
        faults.fire("multihost.barrier", context=context)
        rnd = self._round
        self._round += 1
        tmp = self._blob_path(rnd, self.rank) + ".w"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self._blob_path(rnd, self.rank))
        deadline = time.monotonic() + (
            self.timeout_s if timeout_s is None else float(timeout_s)
        )
        # the barrier wait is a span in the job's trace (a no-op without
        # a campaign tracer active); every rank derives the same flow id
        # from shared coordinates, linking the ranks' spans of one round
        with job_span(
            "gang_barrier", cat="sched",
            flow_id=flow_id_for(
                os.path.basename(self.gang_dir), context or "barrier", rnd
            ),
            context=context or "barrier", round=rnd, rank=self.rank,
        ):
            return self._await_round(rnd, context, deadline)

    def _await_round(self, rnd: int, context: str, deadline: float) -> list[bytes]:
        last_beat = 0.0
        while True:
            aborted = self._aborted()
            if aborted:
                raise TransientIOError(
                    _errno.ECONNRESET,
                    f"gang aborted ({aborted}) at {context or 'barrier'} round {rnd}",
                )
            present = [os.path.exists(self._blob_path(rnd, k)) for k in range(self.nprocs)]
            if all(present):
                out = []
                for k in range(self.nprocs):
                    try:
                        with open(self._blob_path(rnd, k), "rb") as f:
                            out.append(f.read())
                    except OSError as exc:
                        raise TransientIOError(
                            _errno.EIO,
                            f"gang blob unreadable at {context!r} round {rnd} "
                            f"rank {k}: {exc}",
                        ) from exc
                return out
            now = time.monotonic()
            if now > deadline:
                missing = [k for k, p in enumerate(present) if not p]
                raise TransientIOError(
                    _errno.ETIMEDOUT,
                    f"gang member(s) rank {missing} missing at "
                    f"{context or 'barrier'} round {rnd} (peer dead or never "
                    "assembled)",
                )
            if self._heartbeat is not None and now - last_beat > 0.5:
                last_beat = now
                try:
                    self._heartbeat()
                except Exception:
                    pass  # liveness beats are best-effort
            time.sleep(self.poll_s)


def _unpickle_all(blobs: list[bytes], context: str = "") -> list:
    """Deserialise every process's blob, the merge step of the drivers and
    the ``multihost.merge`` fault seam; a torn blob classifies as transient
    where its error says so."""
    faults.fire("multihost.merge", context=context)
    try:
        return [pickle.loads(b) for b in blobs]
    except TransientIOError:
        raise
    except Exception as exc:
        _classify_collective_error(exc, context or "merge")


def _comm_topology(comm: GangComm | None) -> tuple[int, int, object]:
    """(nprocs, rank, gather) for a driver: the process group by default,
    or a :class:`GangComm`."""
    if comm is not None:
        return comm.nprocs, comm.rank, comm.allgather
    initialize()
    return process_count(), process_index(), _allgather_pickled


def _merge(gather, payload, context: str) -> list:
    """Every process's payload, in process order (ascending DM slices)."""
    return _unpickle_all(gather(pickle.dumps(payload), context=context), context=context)


def _tag_slice(rank: int, nproc: int, lo: int, hi: int, ndm: int) -> None:
    """Tag this process's telemetry with its place in the run, so its
    manifest shard identifies itself, and record ``multihost_slice``."""
    tel = current_telemetry()
    tel.set_context(process_index=int(rank), process_count=int(nproc),
                    hostname=socket.gethostname(), dm_slice=[int(lo), int(hi)])
    tel.event("multihost_slice", processes=nproc, process=rank, dm_lo=lo, dm_hi=hi,
              ndm=int(ndm))


def run_search(fil, config, comm: GangComm | None = None, device="cuda"):
    """Multi-process `peasoup` search: each process dedisperses and
    searches its contiguous slice of the global DM list on its own
    card(s), the per-DM candidates (global dm_idx) are exchanged, and
    every process runs the same global distil, scoring and folding.
    Folds are computed by the process that owns the trial and exchanged,
    so every process ends with the same candidate list.

    Single-process: exactly PeasoupSearch(config, device).run(fil).
    """
    from ..pipeline.search import PeasoupSearch

    nproc, rank, gather = _comm_topology(comm)
    search = PeasoupSearch(config, device=process_device(device, nproc, rank))
    if nproc == 1:
        return search.run(fil)
    ndm = search.build_dm_plan(fil).ndm
    lo, hi = dm_slice_for_process(ndm, nproc, rank)
    log.info("multi-process search: process %d/%d owns DM trials [%d, %d) of %d",
             rank, nproc, lo, hi, ndm)
    _tag_slice(rank, nproc, lo, hi, ndm)
    part = search.run(fil, dm_slice=(lo, hi), finalize=False)
    pieces = _merge(gather, (part.cands, part.n_accel_trials), "search:candidates")
    merged = dataclasses.replace(
        part,
        cands=[c for cands, _ in pieces for c in cands],
        n_accel_trials=sum(n for _, n in pieces),
        dm_list=search.build_dm_plan(fil).dm_list,  # global
    )

    def fold_exchange(outcomes: list[dict]) -> list[dict]:
        return [o for piece in _merge(gather, outcomes, "search:folds") for o in piece]

    return search.finalize(fil, merged, fold_exchange=fold_exchange)


def run_fdas_search(fil, config, comm: GangComm | None = None, device="cuda"):
    """Multi-process `peasoup-fdas`, as :func:`run_search`: each process
    correlation-searches its DM slice (the template bank depends only on
    the geometry, so it is the same everywhere), the per-DM candidates
    (global dm_idx) are exchanged and every process runs the same global
    distil and scoring. FDAS does not fold.

    Single-process: exactly FdasSearch(config, device).run(fil).
    """
    from ..pipeline.fdas import FdasSearch

    nproc, rank, gather = _comm_topology(comm)
    search = FdasSearch(config, device=process_device(device, nproc, rank))
    if nproc == 1:
        return search.run(fil)
    plan = search.build_dm_plan(fil)
    lo, hi = dm_slice_for_process(plan.ndm, nproc, rank)
    log.info("multi-process FDAS: process %d/%d owns DM trials [%d, %d) of %d",
             rank, nproc, lo, hi, plan.ndm)
    _tag_slice(rank, nproc, lo, hi, plan.ndm)
    part = search.run(fil, dm_slice=(lo, hi), finalize=False)
    pieces = _merge(gather, (part.cands, part.n_trials), "fdas:candidates")
    merged = dataclasses.replace(
        part,
        cands=[c for cands, _ in pieces for c in cands],
        n_trials=sum(n for _, n in pieces),
        dm_list=plan.dm_list,  # global
    )
    return search.finalize(fil, merged)


def run_single_pulse_search(fil, config, comm: GangComm | None = None, device="cuda"):
    """Multi-process `spsearch`, as :func:`run_search`: each process
    searches its DM slice, the raw events (global dm_idx) are exchanged,
    and every process runs the same global friends-of-friends clustering,
    so a pulse whose DM footprint spans a slice boundary still clusters
    as one candidate.

    Single-process: exactly SinglePulseSearch(config, device).run(fil).
    """
    from ..pipeline.single_pulse import SinglePulseSearch

    nproc, rank, gather = _comm_topology(comm)
    search = SinglePulseSearch(config, device=process_device(device, nproc, rank))
    if nproc == 1:
        return search.run(fil)
    ndm = search.build_dm_plan(fil).ndm
    lo, hi = dm_slice_for_process(ndm, nproc, rank)
    log.info("multi-process spsearch: process %d/%d owns DM trials [%d, %d) of %d",
             rank, nproc, lo, hi, ndm)
    _tag_slice(rank, nproc, lo, hi, ndm)
    part = search.run(fil, dm_slice=(lo, hi), finalize=False)
    pieces = _merge(gather, (part.events, part.n_overflowed), "spsearch:events")
    merged = dataclasses.replace(
        part,
        events=np.concatenate([ev for ev, _ in pieces]),
        n_overflowed=sum(int(n) for _, n in pieces),
    )
    return search.finalize(fil, merged)


def run_survey_fold(observations, folder) -> list[dict]:
    """Multi-process survey folding (sift/fold.py): observations are
    dealt round-robin to processes, each folds its share on its own card,
    and the outcomes are exchanged in process order, so every process
    returns the same full outcome list.

    Single-process: exactly ``folder.fold_outcomes(observations)``.
    """
    initialize()
    nproc = process_count()
    if nproc == 1:
        return folder.fold_outcomes(observations)
    rank = process_index()
    mine = observations[rank::nproc]
    log.info("multi-process survey fold: process %d/%d folds %d of %d observations",
             rank, nproc, len(mine), len(observations))
    current_telemetry().event("multihost_fold", processes=nproc, process=rank,
                              observations=len(mine), total=len(observations))
    outcomes = folder.fold_outcomes(mine)
    return [o for piece in _merge(_allgather_pickled, outcomes, "survey_fold:outcomes")
            for o in piece]


def process_local_slice(mesh: Mesh, axis: str) -> tuple[int, int]:
    """The [start, stop) block of ``axis`` whose shards live on this
    process: an axis index is local when any device in its hyperplane
    belongs to this process. The local indices must be contiguous, which
    global_mesh's leading cross-process axis guarantees."""
    pid = process_index()
    planes = np.moveaxis(mesh.processes, mesh.axis_names.index(axis), 0)
    local = np.asarray([(plane == pid).any() for plane in planes])
    idxs = np.nonzero(local)[0]
    if idxs.size == 0:
        return 0, 0
    lo, hi = int(idxs[0]), int(idxs[-1]) + 1
    if idxs.size != hi - lo:
        raise ValueError(
            f"axis {axis!r} is not contiguous across this process; "
            "lay the cross-process axis leading (global_mesh dcn_axis)"
        )
    return lo, hi
