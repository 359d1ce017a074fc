"""Fleet autoscaling: grow and shrink the worker pool from the rollup
(the port's copy of the JAX package's campaign/autoscale.py; its workers
are ``python -m peasoup_tpu_torch.cli.campaign run`` processes on the
controller's ``device``).

The campaign layer already tolerates elastic membership — workers join
and leave at will, leases expire, claims reap — but *someone* has to
decide when the fleet is the wrong size. This controller closes that
loop: it reads the same ``campaign_status.json`` aggregates operators
watch (queue depth by derived state, live membership, per-worker
throughput), applies bounded hysteresis (min/max worker counts, a
cooldown between actions), and acts through the fleet's existing
elasticity verbs:

- **scale up** — spawn a REAL ``peasoup-campaign run`` subprocess
  against the campaign directory (the campaign.json already on disk
  governs its semantics; the kernels' libraries, built once per source
  under the package's ``_build/``, are loaded, not rebuilt);
- **scale down** — write a retire marker beside an idle worker's
  registry entry (campaign/registry.py ``request_retire``): the worker
  observes it between jobs — or mid-job via the revoke token, where it
  checkpoints and releases its claim with ZERO attempts consumed —
  deregisters, and exits. Retirement is elasticity, never failure.

Every decision (including the "no" ones worth explaining) is appended
to ``<root>/autoscale.json``, which the rollup embeds as the
``autoscale`` section of ``campaign_status.json`` — the controller's
reasoning is part of the campaign's operator surface.

Bounds are hard invariants, unit-tested against synthetic rollup
traces: the controller never spawns past ``max_workers``, never
retires below ``min_workers``, and honours ``cooldown_s`` between
actions (restoring the ``min_workers`` floor is the one exemption —
a fleet below its floor is an outage, not an optimisation).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

from ..obs import get_logger
from ..obs.metrics import MetricsRecorder
from .registry import WorkerRegistry
from .rollup import build_status

log = get_logger("campaign.autoscale")

AUTOSCALE_FILENAME = "autoscale.json"
AUTOSCALE_SCHEMA = "peasoup_tpu.autoscale"
MAX_LOGGED_DECISIONS = 200


@dataclasses.dataclass
class AutoscalePolicy:
    """The controller's bounds and thresholds."""

    min_workers: int = 1
    max_workers: int = 4
    cooldown_s: float = 60.0
    # scale up when the claimable backlog (pending + backoff + stale)
    # exceeds this many jobs per live worker
    backlog_per_worker: float = 2.0
    # scale down only when the backlog is empty AND at least one live
    # worker is idle (retiring a busy worker would checkpoint-cycle a
    # job for nothing)
    retire_when_idle: bool = True


def _atomic_write_json(path: str, doc: dict) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_autoscale_log(root: str) -> dict | None:
    try:
        with open(os.path.join(root, AUTOSCALE_FILENAME)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if doc.get("schema") == AUTOSCALE_SCHEMA else None


def spawn_command(root: str, worker_id: str, extra_args=None,
                  device: str = "cuda") -> list[str]:
    """The command line of a spawned worker: the port's campaign CLI on
    ``device`` (the card unless the controller was asked for the CPU)."""
    return [
        sys.executable, "-m", "peasoup_tpu_torch.cli.campaign", "run",
        "-w", root, "--worker-id", worker_id, "--device", str(device),
    ] + list(extra_args or [])


def default_spawn(root: str, worker_id: str, extra_args=None, env=None,
                  device: str = "cuda"):
    """Spawn a real campaign worker subprocess (the production scale-up
    action). The campaign.json already persisted in ``root`` governs
    its pipeline/config — first writer wins — so the spawn needs no
    knowledge of the campaign's semantics. Returns the Popen."""
    cmd = spawn_command(root, worker_id, extra_args, device)
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        env=env,
        start_new_session=True,
    )
    log.info(
        "autoscale: spawned worker %s (pid %d)", worker_id, proc.pid
    )
    return proc


class AutoscaleController:
    """One controller process (or thread) supervising one campaign.

    ``spawn`` / ``retire`` are injectable for tests; the defaults
    spawn real ``peasoup-campaign run`` subprocesses and write retire
    markers through the worker registry.
    """

    def __init__(
        self,
        root: str,
        policy: AutoscalePolicy | None = None,
        spawn=None,
        retire=None,
        extra_args=None,
        env=None,
        controller_id: str = "autoscale",
        device: str = "cuda",
    ) -> None:
        self.root = os.path.abspath(root)
        self.policy = policy or AutoscalePolicy()
        if self.policy.min_workers > self.policy.max_workers:
            raise ValueError(
                f"autoscale bounds inverted: min "
                f"{self.policy.min_workers} > max "
                f"{self.policy.max_workers}"
            )
        self.registry = WorkerRegistry(self.root)
        self.controller_id = controller_id
        # the controller's own time series rides the same fleet
        # directory as the workers': its decisions are fleet metrics
        self.metrics = MetricsRecorder(
            self.registry.metrics_path(controller_id)
        )
        self._extra_args = list(extra_args or [])
        self._env = env
        self.device = str(device)
        self._spawn = spawn or (
            lambda wid: default_spawn(
                self.root, wid, self._extra_args, self._env, self.device
            )
        )
        self._retire = retire or (
            lambda wid: self.registry.request_retire(
                wid, requester=self.controller_id
            )
        )
        self._spawned: dict[str, object] = {}  # worker_id -> handle
        self._n_spawned = 0
        self.last_action_unix = 0.0
        self.decisions: list[dict] = []
        prev = load_autoscale_log(self.root)
        if prev:
            # a restarted controller keeps its hysteresis: the
            # cooldown must survive the controller process, or a
            # crash-loop would flap the fleet
            self.last_action_unix = float(prev.get("last_action_unix", 0))
            self._n_spawned = int(prev.get("spawned_total", 0))

    # --- the pure decision (unit-tested on synthetic rollups) ---------
    def decide(self, status: dict, now: float | None = None) -> dict | None:
        """Map one rollup snapshot to an action dict ({"action":
        "up"|"down", "worker_id", "reason"}) or None. Pure in
        ``status`` + controller hysteresis state — no filesystem, no
        subprocesses — so traces of synthetic rollups pin the bounds."""
        now = time.time() if now is None else now
        pol = self.policy
        q = status.get("queue") or {}
        fleet = status.get("fleet") or {}
        live = fleet.get("live") or []
        n_live = len(live)
        backlog = (
            int(q.get("pending", 0))
            + int(q.get("backoff", 0))
            + int(q.get("stale", 0))
        )
        idle = [w for w in live if w.get("current_job") is None]
        throughput = status.get("throughput_jobs_per_s")
        in_cooldown = (
            self.last_action_unix
            and now - self.last_action_unix < pol.cooldown_s
        )
        if status.get("done"):
            return None  # drained: nothing to scale for
        if n_live < pol.min_workers:
            # the floor is an outage, not an optimisation: restoring
            # it is exempt from the cooldown
            return {
                "action": "up",
                "worker_id": self._next_worker_id(),
                "reason": (
                    f"live {n_live} below min_workers "
                    f"{pol.min_workers}"
                ),
            }
        if in_cooldown:
            return None
        if (
            backlog > pol.backlog_per_worker * max(1, n_live)
            and n_live < pol.max_workers
        ):
            return {
                "action": "up",
                "worker_id": self._next_worker_id(),
                "reason": (
                    f"backlog {backlog} > {pol.backlog_per_worker:g}/"
                    f"worker x {n_live} live"
                    + (
                        f" (throughput {throughput * 3600.0:.3g} jobs/h)"
                        if throughput else ""
                    )
                ),
            }
        if (
            backlog == 0
            and int(q.get("running", 0)) < n_live
            and n_live > pol.min_workers
            and (not self.policy.retire_when_idle or idle)
        ):
            victim = self._pick_retiree(idle or live)
            if victim is not None:
                return {
                    "action": "down",
                    "worker_id": victim,
                    "reason": (
                        f"backlog empty, {len(idle)} idle of {n_live} "
                        f"live > min_workers {pol.min_workers}"
                    ),
                }
        return None

    def _next_worker_id(self) -> str:
        self._n_spawned += 1
        return f"{self.controller_id}-{self._n_spawned}"

    def _pick_retiree(self, candidates: list[dict]) -> str | None:
        """Prefer retiring a worker this controller spawned (giving
        back what it took before touching operator-started workers)."""
        ids = [
            w.get("worker_id") for w in candidates if w.get("worker_id")
        ]
        for wid in ids:
            if wid in self._spawned:
                return wid
        return ids[0] if ids else None

    # --- acting + the decision log ------------------------------------
    def step(self, now: float | None = None) -> dict | None:
        """One control iteration: rollup -> decide -> act -> log.
        Returns the applied decision (or None)."""
        now = time.time() if now is None else now
        status = build_status(self.root)
        decision = self.decide(status, now)
        if decision is None:
            return None
        decision["unix"] = now
        decision["live"] = len(
            (status.get("fleet") or {}).get("live") or []
        )
        if decision["action"] == "up":
            handle = self._spawn(decision["worker_id"])
            self._spawned[decision["worker_id"]] = handle
        else:
            self._retire(decision["worker_id"])
        self.last_action_unix = now
        self.decisions.append(decision)
        self._write_log(now)
        try:
            self.metrics.counter(
                "autoscale_decisions_total", action=decision["action"]
            )
            self.metrics.gauge(
                "autoscale_live_workers", decision.get("live", 0)
            )
        except Exception:
            log.debug("autoscale metrics failed", exc_info=True)
        log.info(
            "autoscale %s: %s (%s)", decision["action"],
            decision["worker_id"], decision["reason"],
        )
        return decision

    def _write_log(self, now: float) -> None:
        _atomic_write_json(
            os.path.join(self.root, AUTOSCALE_FILENAME),
            {
                "schema": AUTOSCALE_SCHEMA,
                "controller_id": self.controller_id,
                "updated_unix": now,
                "last_action_unix": self.last_action_unix,
                "spawned_total": self._n_spawned,
                "policy": dataclasses.asdict(self.policy),
                "decisions": self.decisions[-MAX_LOGGED_DECISIONS:],
            },
        )

    def run(
        self,
        poll_s: float = 5.0,
        max_runtime_s: float | None = None,
        stop_when_drained: bool = True,
    ) -> list[dict]:
        """The control loop. Returns the decisions taken."""
        t0 = time.monotonic()
        while True:
            if (
                max_runtime_s is not None
                and time.monotonic() - t0 > max_runtime_s
            ):
                break
            try:
                self.step()
            except Exception:
                log.warning("autoscale step failed", exc_info=True)
            if stop_when_drained:
                try:
                    from .queue import JobQueue

                    if JobQueue(self.root).drained():
                        break
                except Exception:
                    pass
            time.sleep(poll_s)
        self.reap_spawned()
        return self.decisions

    def reap_spawned(self, timeout_s: float = 60.0) -> None:
        """Wait out subprocess handles this controller spawned (drained
        workers exit on their own; anything else is left to the fleet's
        normal lease/registry reaping)."""
        for wid, handle in list(self._spawned.items()):
            wait = getattr(handle, "wait", None)
            if wait is None:
                continue
            try:
                wait(timeout=timeout_s)
            except Exception:
                log.warning(
                    "autoscale-spawned worker %s did not exit within "
                    "%.0fs", wid, timeout_s,
                )
