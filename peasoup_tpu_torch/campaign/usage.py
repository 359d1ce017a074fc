"""Per-tenant usage accounting over a campaign's queue artifacts (the
port's copy of the JAX package's campaign/usage.py, same ledger).

Who consumed what: device-seconds, jobs done/failed/quarantined,
bytes read, kernel libraries built (``jit_programs_compiled``, the
field both packages' done records share), candidates found — rolled up from
tenant-stamped done records (campaign/queue.py writes them, the
runner stamps ``tenant``/``bytes_read``/``jit_programs_compiled``)
plus job/quarantine records for the failure tally. The ledger is
written atomically to ``queue/usage.json`` by the rollup
(campaign/rollup.py calls :func:`write_usage` beside the status
snapshot) and rendered at the portal's ``/tenants`` pages and by
tools/watch.py.

The ledger is DERIVED, never incremented: recomputing from the
artifacts on every rollup means a crashed writer can never leave the
accounting out of sync with the done records — the same
states-are-derived principle the queue itself follows.
"""

from __future__ import annotations

import os
import time

from .queue import JobQueue, _atomic_write_json, _read_json
from .tenants import TenantRegistry

SCHEMA = "peasoup_tpu.usage"
VERSION = 1


def usage_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), "queue", "usage.json")


def _blank() -> dict:
    return {
        "jobs_done": 0,
        "jobs_failed": 0,
        "jobs_quarantined": 0,
        "device_seconds": 0.0,
        "bytes_read": 0,
        "jit_programs_compiled": 0,
        "candidates": 0,
    }


def build_usage(
    root: str, queue: JobQueue | None = None, now: float | None = None
) -> dict:
    """The full ledger document. Tenants with a registry record appear
    even at zero usage; done records stamped with an UNREGISTERED
    tenant (record deleted after jobs ran) still account under their
    stamp — usage is historical truth, not a join against the present
    registry."""
    now = time.time() if now is None else now
    root = os.path.abspath(root)
    queue = queue or JobQueue(root)
    reg = TenantRegistry(root)
    tenants: dict[str, dict] = {t.name: _blank() for t in reg.entries()}
    quotas = {t.name: t for t in reg.entries()}

    records = queue.done_records()
    for rec in records:
        name = rec.get("tenant")
        if not name:
            continue
        u = tenants.setdefault(name, _blank())
        u["jobs_done"] += 1
        u["device_seconds"] += float(rec.get("duration_s") or 0.0)
        u["bytes_read"] += int(rec.get("bytes_read") or 0)
        u["jit_programs_compiled"] += int(
            rec.get("jit_programs_compiled") or 0
        )
        u["candidates"] += int(rec.get("n_candidates") or 0)
        # a done record's ``attempts`` counts every attempt including
        # the successful one; the excess were failures
        u["jobs_failed"] += max(0, int(rec.get("attempts") or 1) - 1)

    qdir = os.path.join(root, "queue")
    for jid in queue.job_ids():
        if os.path.exists(os.path.join(qdir, "done", f"{jid}.json")):
            continue  # already tallied above
        doc = _read_json(os.path.join(qdir, "jobs", f"{jid}.json"))
        if not doc or not doc.get("tenant"):
            continue
        u = tenants.setdefault(str(doc["tenant"]), _blank())
        u["jobs_failed"] += int(doc.get("attempts") or 0)
        if os.path.exists(
            os.path.join(qdir, "quarantine", f"{jid}.json")
        ):
            u["jobs_quarantined"] += 1

    for name, u in tenants.items():
        u["device_seconds"] = round(u["device_seconds"], 3)
        t = quotas.get(name)
        if t is not None:
            lo = now - t.window_s
            in_window = sum(
                float(rec.get("duration_s") or 0.0)
                for rec in records
                if rec.get("tenant") == name
                and float(rec.get("finished_unix") or 0.0) >= lo
            )
            u["window"] = {
                "window_s": t.window_s,
                "device_seconds": round(in_window, 3),
                "budget": t.device_seconds or None,
            }
    return {
        "schema": SCHEMA,
        "version": VERSION,
        "generated_unix": round(now, 3),
        "tenants": tenants,
    }


def write_usage(
    root: str, queue: JobQueue | None = None, now: float | None = None
) -> str:
    """Atomically (re)write ``queue/usage.json``; returns its path."""
    path = usage_path(root)
    _atomic_write_json(path, build_usage(root, queue=queue, now=now))
    return path


def load_usage(root: str) -> dict | None:
    return _read_json(usage_path(root))
