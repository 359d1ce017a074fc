"""File-backed tenant registry + quota throttling for shared fleets (the
port's copy of the JAX package's campaign/tenants.py, same records).

A survey instrument is shared infrastructure: more than one programme
submits observations to the same campaign directory, and the fleet
must account for — and bound — what each consumes. Tenants are plain
JSON records under ``queue/tenants/<name>.json`` following the same
filesystem protocol as everything else in campaign/: creation is
``O_CREAT|O_EXCL`` (two operators racing to create the same tenant
collide harmlessly, first wins), updates are tmp + ``os.replace``
rewrites, and torn/mid-replace reads parse as absent.

A tenant's quota spec:

- ``max_queued`` — ceiling on non-terminal jobs (pending, backing
  off, throttled, running) the tenant may have in the queue at once;
  enforced at ADMISSION (campaign/ingest.py rejects, journaled).
- ``max_running`` — ceiling on simultaneously held claims; enforced
  at CLAIM time (over-quota jobs park in the derived ``throttled``
  state, rendered by the rollup/watch — never silently dropped).
- ``device_seconds`` / ``window_s`` — device-seconds budget per
  rolling window, measured from done records' ``duration_s``; an
  exhausted budget throttles like ``max_running`` and releases as
  the window slides.
- ``priority_max`` — priority-class ceiling: submissions above it
  are CLAMPED (and flagged in the submissions journal), so a tenant
  cannot out-rank the operator's urgent work by asking nicely.

Zero (or ``None`` for ``priority_max``) means unlimited. Enforcement
lives in :func:`throttle_map` — a pure scan over raw queue artifacts
(job docs, live claim docs, done records) so the queue can call it
without recursing into its own derived-state machinery.
"""

from __future__ import annotations

import hmac
import json
import os
import tempfile
import time
import uuid
from dataclasses import dataclass, field

from ..obs import get_logger

log = get_logger("campaign.tenants")

_TENANTS = "tenants"


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


def valid_tenant_name(name: str) -> bool:
    """Tenant names become file names and journal suffixes
    (``queue/alerts.<tenant>.jsonl``), so the charset is alnum plus
    ``-`` and ``_`` only, non-empty, bounded. Dots are deliberately
    excluded (unlike worker ids): a name must parse back unambiguously
    out of the dotted journal filename, and can never be a hidden
    file or a path dodge. The portal's ``/tenants/<name>`` route uses
    this same predicate — one validator for every door."""
    return (
        0 < len(name) <= 48
        and all(c.isalnum() or c in "-_" for c in name)
    )


@dataclass
class Tenant:
    """One tenant record. ``token`` is the bearer secret the portal's
    POST /submit authenticates against (compare via
    :meth:`TenantRegistry.by_token`, which is constant-time); the
    watch-folder ingester maps ``watch_dir`` drops to this tenant."""

    name: str
    token: str = ""
    max_queued: int = 0  # 0 = unlimited
    max_running: int = 0  # 0 = unlimited
    device_seconds: float = 0.0  # budget per window; 0 = unlimited
    window_s: float = 3600.0  # rolling budget window
    priority_max: int | None = None  # None = no ceiling
    watch_dir: str = ""
    created_unix: float = 0.0
    meta: dict = field(default_factory=dict)

    def to_doc(self) -> dict:
        return {
            "name": self.name,
            "token": self.token,
            "max_queued": int(self.max_queued),
            "max_running": int(self.max_running),
            "device_seconds": float(self.device_seconds),
            "window_s": float(self.window_s),
            "priority_max": (
                None if self.priority_max is None else int(self.priority_max)
            ),
            "watch_dir": self.watch_dir,
            "created_unix": self.created_unix,
            "meta": self.meta,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "Tenant":
        pm = doc.get("priority_max")
        return cls(
            name=doc["name"],
            token=str(doc.get("token") or ""),
            max_queued=int(doc.get("max_queued", 0)),
            max_running=int(doc.get("max_running", 0)),
            device_seconds=float(doc.get("device_seconds", 0.0)),
            window_s=float(doc.get("window_s", 3600.0)),
            priority_max=None if pm is None else int(pm),
            watch_dir=str(doc.get("watch_dir") or ""),
            created_unix=float(doc.get("created_unix", 0.0)),
            meta=doc.get("meta") or {},
        )

    def quota_doc(self) -> dict:
        """The quota spec alone (rollup/portal rendering)."""
        return {
            "max_queued": int(self.max_queued),
            "max_running": int(self.max_running),
            "device_seconds": float(self.device_seconds),
            "window_s": float(self.window_s),
            "priority_max": (
                None if self.priority_max is None else int(self.priority_max)
            ),
        }


class TenantRegistry:
    """The tenant records rooted at ``<root>/queue/tenants/``."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.dir = os.path.join(self.root, "queue", _TENANTS)

    def _path(self, name: str) -> str:
        if not valid_tenant_name(name):
            raise ValueError(f"invalid tenant name {name!r}")
        return os.path.join(self.dir, f"{name}.json")

    def create(self, tenant: Tenant) -> Tenant:
        """O_EXCL create: raises FileExistsError when the tenant
        already exists (first creator wins; update() to change it).
        Mints a bearer token when the record carries none."""
        path = self._path(tenant.name)
        os.makedirs(self.dir, exist_ok=True)
        tenant.created_unix = tenant.created_unix or time.time()
        if not tenant.token:
            tenant.token = uuid.uuid4().hex
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        with os.fdopen(fd, "w") as f:
            json.dump(tenant.to_doc(), f, indent=2)
            f.write("\n")
        log.info("tenant %s registered", tenant.name)
        return tenant

    def update(self, tenant: Tenant) -> None:
        """Atomic rewrite of an existing record (quota changes)."""
        _atomic_write_json(self._path(tenant.name), tenant.to_doc())

    def get(self, name: str) -> Tenant | None:
        if not valid_tenant_name(name):
            return None
        doc = _read_json(os.path.join(self.dir, f"{name}.json"))
        return Tenant.from_doc(doc) if doc and doc.get("name") else None

    def entries(self) -> list[Tenant]:
        try:
            names = sorted(os.listdir(self.dir))
        except FileNotFoundError:
            return []
        out = []
        for n in names:
            if not n.endswith(".json"):
                continue
            doc = _read_json(os.path.join(self.dir, n))
            if doc and doc.get("name"):
                out.append(Tenant.from_doc(doc))
        return out

    def by_token(self, token: str) -> Tenant | None:
        """Authenticate a bearer token. Constant-time comparison per
        candidate so the portal does not leak token prefixes through
        response timing."""
        if not token:
            return None
        for t in self.entries():
            if t.token and hmac.compare_digest(t.token, token):
                return t
        return None

    def remove(self, name: str) -> bool:
        try:
            os.unlink(self._path(name))
            return True
        except FileNotFoundError:
            return False


# --------------------------------------------------------------------------
# quota evaluation over raw queue artifacts
# --------------------------------------------------------------------------

def _scan_job_tenants(qdir: str) -> dict[str, str]:
    """job_id -> tenant for every job record carrying one."""
    jobs_dir = os.path.join(qdir, "jobs")
    out: dict[str, str] = {}
    try:
        names = os.listdir(jobs_dir)
    except FileNotFoundError:
        return out
    for n in names:
        if not n.endswith(".json"):
            continue
        doc = _read_json(os.path.join(jobs_dir, n))
        if doc and doc.get("tenant"):
            out[os.path.splitext(n)[0]] = str(doc["tenant"])
    return out


def running_counts(
    qdir: str, job_tenant: dict[str, str], now: float
) -> dict[str, int]:
    """Live (unexpired) claims per tenant. A claim file whose document
    is still unwritten (a claimant mid-``try_claim``) parses as absent
    and is skipped — which is exactly what claim-time revalidation
    needs: the claimant's OWN in-flight claim never counts against it.
    Two simultaneous unwritten racers can transiently over-admit by
    one; the steady state converges on the next claim attempt."""
    counts: dict[str, int] = {}
    cdir = os.path.join(qdir, "claims")
    try:
        names = os.listdir(cdir)
    except FileNotFoundError:
        return counts
    for n in names:
        if not n.endswith(".json"):
            continue
        doc = _read_json(os.path.join(cdir, n))
        if doc is None or float(doc.get("expires_unix", 0)) < now:
            continue
        tid = job_tenant.get(os.path.splitext(n)[0])
        if tid:
            counts[tid] = counts.get(tid, 0) + 1
    return counts


def window_device_seconds(qdir: str) -> list[tuple[str, float, float]]:
    """(tenant, finished_unix, duration_s) per tenant-stamped done
    record — the caller filters per tenant window (windows differ)."""
    ddir = os.path.join(qdir, "done")
    out: list[tuple[str, float, float]] = []
    try:
        names = os.listdir(ddir)
    except FileNotFoundError:
        return out
    for n in names:
        if not n.endswith(".json"):
            continue
        doc = _read_json(os.path.join(ddir, n))
        if not doc or not doc.get("tenant"):
            continue
        out.append((
            str(doc["tenant"]),
            float(doc.get("finished_unix") or 0.0),
            float(doc.get("duration_s") or 0.0),
        ))
    return out


def throttle_map(root: str, now: float | None = None) -> dict[str, dict]:
    """tenant -> throttle finding for every currently over-quota
    tenant: ``{"reason", "quota", "running"| "spent_device_s", ...}``.
    Pure scan of raw queue artifacts (never queue.state(), which
    derives ``throttled`` FROM this map). Empty when no tenant is
    registered or none is over quota."""
    now = time.time() if now is None else now
    reg = TenantRegistry(root)
    tenants = reg.entries()
    if not tenants:
        return {}
    qdir = os.path.join(os.path.abspath(root), "queue")
    job_tenant = _scan_job_tenants(qdir)
    running = running_counts(qdir, job_tenant, now)
    spent_raw = window_device_seconds(qdir)
    out: dict[str, dict] = {}
    for t in tenants:
        if t.max_running and running.get(t.name, 0) >= t.max_running:
            out[t.name] = {
                "reason": (
                    f"max_running reached "
                    f"({running.get(t.name, 0)}/{t.max_running})"
                ),
                "quota": "max_running",
                "running": running.get(t.name, 0),
                "limit": t.max_running,
            }
            continue
        if t.device_seconds > 0:
            lo = now - t.window_s
            spent = sum(
                dur for name, fin, dur in spent_raw
                if name == t.name and fin >= lo
            )
            if spent >= t.device_seconds:
                out[t.name] = {
                    "reason": (
                        f"device-seconds budget exhausted "
                        f"({spent:.1f}/{t.device_seconds:.0f}s in "
                        f"{t.window_s:.0f}s window)"
                    ),
                    "quota": "device_seconds",
                    "spent_device_s": round(spent, 3),
                    "limit": t.device_seconds,
                }
    return out


def queued_counts(root: str, queue=None) -> dict[str, int]:
    """Non-terminal jobs per tenant (admission-time ``max_queued``
    accounting): every tenant-stamped job record without a done or
    quarantine marker."""
    qdir = os.path.join(os.path.abspath(root), "queue")
    job_tenant = _scan_job_tenants(qdir)
    counts: dict[str, int] = {}
    for jid, tid in job_tenant.items():
        if os.path.exists(os.path.join(qdir, "done", f"{jid}.json")):
            continue
        if os.path.exists(os.path.join(qdir, "quarantine", f"{jid}.json")):
            continue
        counts[tid] = counts.get(tid, 0) + 1
    return counts
