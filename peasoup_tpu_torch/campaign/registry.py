"""File-backed worker registry: live fleet membership for a campaign
(the port's copy of the JAX package's campaign/registry.py, same files).

The queue (queue.py) already tolerates workers dying — leases expire
and claims are reaped — but nothing *names* the fleet: operators
watching a campaign cannot see who is working, and a worker joining
mid-campaign cannot tell warm peers from ghosts. This module is the
membership half of elasticity, built on the same idioms as the queue:

- **register** — ``O_CREAT|O_EXCL`` of ``queue/workers/<id>.json``
  carrying pid/hostname and a lease expiry. A stale entry left by a
  previous incarnation of the same worker id (a restart) is taken over
  with an atomic rewrite.
- **beat** — the owner atomically rewrites its entry with a fresh
  expiry plus live stats (jobs done, current job, last bucket); the
  campaign runner beats from the same lease-renewal thread that keeps
  its claim fresh, so a worker alive enough to hold a job is alive in
  the registry too.
- **deregister** — a clean leave unlinks the entry; joins and leaves
  need no coordinator, mirroring claim release.
- **reap** — anyone may unlink an EXPIRED entry (a SIGKILLed worker
  never deregisters). Reaping membership is advisory — job recovery is
  the queue reaper's — so the unlink needs no tombstone dance; a lost
  race is a FileNotFoundError and a shrug.

The rollup (rollup.py) reads the registry read-only into the ``fleet``
status section; ``tools.watch`` renders it.
"""

from __future__ import annotations

import json
import os
import socket
import tempfile
import time

from ..obs import get_logger
from ..resilience import faults

log = get_logger("campaign.registry")

_WORKERS = "workers"


def _atomic_write_json(path: str, doc: dict) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
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


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # gone, mid-replace, or torn: treat as absent


class WorkerRegistry:
    """Heartbeat files under ``<root>/queue/workers/``. ``group``
    names THIS process's gang-scheduling process group: it rides every
    (re-)registration, so an entry recreated by a beat — after a
    clock-skewed peer reaped a perfectly live worker — keeps its group
    membership and the gang pool never silently shrinks."""

    def __init__(
        self, root: str, lease_s: float = 60.0, group: str | None = None
    ) -> None:
        self.root = os.path.abspath(root)
        self.wdir = os.path.join(self.root, "queue", _WORKERS)
        self.lease_s = float(lease_s)
        self.group = group
        os.makedirs(self.wdir, exist_ok=True)

    def _path(self, worker_id: str) -> str:
        safe = "".join(
            c if c.isalnum() or c in "-_." else "_" for c in worker_id
        )
        return os.path.join(self.wdir, f"{safe[:80]}.json")

    def metrics_path(self, worker_id: str) -> str:
        """The worker's time-series file (obs/metrics.py), living
        beside its membership entry so the fleet aggregator finds the
        whole fleet's history in one directory. Deliberately NOT
        removed on deregister/reap: the history of a departed worker
        is the point of having history."""
        return self._path(worker_id)[: -len(".json")] + ".metrics.jsonl"

    # --- lifecycle ----------------------------------------------------
    def register(self, worker_id: str, **info) -> dict:
        """Join the fleet. Idempotent for one incarnation; a stale or
        duplicate entry for the same id is taken over (the newest pid
        wins — worker ids are operator-chosen, and a restart reusing
        one must not be locked out by its own corpse)."""
        now = time.time()
        doc = {
            "worker_id": worker_id,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "registered_unix": now,
            "expires_unix": now + self.lease_s,
            "jobs_done": 0,
            "current_job": None,
            "last_bucket": None,
            "group": self.group,  # process group for gang scheduling
            **info,
        }
        path = self._path(worker_id)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            prev = _read_json(path) or {}
            if (
                float(prev.get("expires_unix", 0)) >= now
                and prev.get("pid") != doc["pid"]
            ):
                log.warning(
                    "worker id %s already registered live by pid %s; "
                    "taking over (newest registration wins)",
                    worker_id, prev.get("pid"),
                )
            _atomic_write_json(path, doc)
            return doc
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        log.info("worker %s joined the fleet", worker_id)
        return doc

    def beat(self, worker_id: str, **updates) -> None:
        """Renew the lease (and fold in live stats). Missing entry —
        reaped from under a stalled worker — is re-created: a worker
        that beats IS alive, whatever the reaper concluded."""
        path = self._path(worker_id)
        doc = _read_json(path)
        if doc is None:
            self.register(worker_id, **updates)
            return
        doc.update(updates)
        now_unix = time.time()
        doc["expires_unix"] = now_unix + self.lease_s
        _atomic_write_json(path, doc)

    def deregister(self, worker_id: str) -> None:
        """Clean leave: remove the membership entry (and any pending
        retire or profile request — the leave answers both)."""
        self.clear_retire(worker_id)
        self.clear_profile(worker_id)
        try:
            os.unlink(self._path(worker_id))
            log.info("worker %s left the fleet", worker_id)
        except FileNotFoundError:
            pass  # reaped already — same outcome

    # --- retirement (autoscale scale-down) ----------------------------
    def _retire_path(self, worker_id: str) -> str:
        # ".retire" (not ".json") so registry scans — which filter on
        # ".json" — never mistake a request for a membership entry
        return self._path(worker_id) + ".retire"

    def request_retire(self, worker_id: str, requester: str = "") -> None:
        """Ask a worker to leave the fleet cleanly: it observes the
        marker between jobs (or mid-job via the revoke token — it then
        checkpoints and releases its claim with zero attempts
        consumed), deregisters, and exits. The autoscale controller's
        scale-down path (campaign/autoscale.py)."""
        _atomic_write_json(
            self._retire_path(worker_id),
            {
                "worker_id": worker_id,
                "requester": requester,
                "requested_unix": time.time(),
            },
        )
        log.info(
            "retire requested for worker %s%s", worker_id,
            f" (by {requester})" if requester else "",
        )

    def retire_requested(self, worker_id: str) -> dict | None:
        return _read_json(self._retire_path(worker_id))

    def clear_retire(self, worker_id: str) -> None:
        try:
            os.unlink(self._retire_path(worker_id))
        except FileNotFoundError:
            pass

    # --- on-demand profiling (obs/profiler.py) ------------------------
    def _profile_path(self, worker_id: str) -> str:
        # ".profile" (not ".json") so registry scans — which filter on
        # ".json" — never mistake a request for a membership entry
        return self._path(worker_id) + ".profile"

    def request_profile(
        self,
        worker_id: str,
        seconds: float = 5.0,
        requester: str = "",
    ) -> None:
        """Ask a live worker for a bounded ``torch.profiler`` capture:
        it observes the marker on its next lease-renewer beat (busy)
        or claim poll (idle), runs the capture on a helper thread
        (obs/profiler.py), announces it in its metrics stream,
        and clears the request — ``peasoup-campaign profile``'s write
        half."""
        _atomic_write_json(
            self._profile_path(worker_id),
            {
                "worker_id": worker_id,
                "seconds": float(seconds),
                "requester": requester,
                "requested_unix": time.time(),
            },
        )
        log.info(
            "device profile requested for worker %s (%.3gs)%s",
            worker_id, seconds,
            f" by {requester}" if requester else "",
        )

    def profile_requested(self, worker_id: str) -> dict | None:
        return _read_json(self._profile_path(worker_id))

    def clear_profile(self, worker_id: str) -> None:
        try:
            os.unlink(self._profile_path(worker_id))
        except FileNotFoundError:
            pass

    # --- reading ------------------------------------------------------
    def entries(self) -> list[dict]:
        out = []
        for name in sorted(os.listdir(self.wdir)):
            if name.endswith(".json"):
                doc = _read_json(os.path.join(self.wdir, name))
                if doc:
                    out.append(doc)
        return out

    def live(self, now: float | None = None) -> list[dict]:
        now = time.time() if now is None else now
        return [
            e for e in self.entries()
            if float(e.get("expires_unix", 0)) >= now
        ]

    def live_group(
        self, group: str, now: float | None = None
    ) -> list[str]:
        """Sorted live worker ids of one process group — the gang
        leader is the first entry (queue.claim_next's contract)."""
        return sorted(
            e["worker_id"]
            for e in self.live(now)
            if e.get("group") == group and e.get("worker_id")
        )

    # --- reaping ------------------------------------------------------
    def reap(self, now: float | None = None) -> list[str]:
        """Unlink expired entries (their worker was SIGKILLed or
        wedged past its lease). Advisory membership only — the queue's
        lease reaper owns job recovery — so a lost unlink race is
        harmless. The same clock.skew chaos seam that drills the queue
        reaper shifts this reaper's view too."""
        now = time.time() if now is None else now
        now += faults.clock_skew_s()
        reaped = []
        for name in sorted(os.listdir(self.wdir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.wdir, name)
            doc = _read_json(path)
            if doc is None:
                # TORN entry: the joiner was SIGKILLed between the
                # O_EXCL create and the document publish. It has no
                # expiry so it could never be reaped — it leaked
                # forever, and (worse) a restart reusing the id would
                # take it over and inherit garbage (found by the mc
                # registry_torn_entry scenario). Age-gate on st_ctime
                # so a mid-write joiner gets a full lease to finish
                try:
                    if now - os.stat(path).st_ctime <= self.lease_s:
                        continue
                    os.unlink(path)
                except OSError:
                    continue  # published or reaped in the gap
                reaped.append(os.path.splitext(name)[0])
                log.warning(
                    "reaped torn registry entry %s (joiner died "
                    "mid-publish)", name,
                )
                continue
            if float(doc.get("expires_unix", 0)) >= now:
                continue
            try:
                os.unlink(path)
            except FileNotFoundError:
                continue  # lost the race: already reaped
            reaped.append(doc.get("worker_id", os.path.splitext(name)[0]))
            log.warning(
                "reaped dead worker %s from the fleet registry (lease "
                "expired %.1fs ago)",
                doc.get("worker_id"),
                now - float(doc.get("expires_unix", 0)),
            )
        # orphaned retire/profile markers (the worker died, or left,
        # before observing the request) must not leak — the request is
        # moot either way
        for suffix in (".retire", ".profile"):
            for name in sorted(os.listdir(self.wdir)):
                if not name.endswith(suffix):
                    continue
                if not os.path.exists(
                    os.path.join(self.wdir, name[: -len(suffix)])
                ):
                    try:
                        os.unlink(os.path.join(self.wdir, name))
                    except FileNotFoundError:
                        pass
        return reaped
