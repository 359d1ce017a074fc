"""Deterministic fault injection at named host-side seams (the port's copy
of the JAX package's resilience/faults.py): the same ``PEASOUP_FAULTS``
grammar and the same seeded per-site streams, so one spec fires on the
same invocations in both packages.

Grammar (``PEASOUP_FAULTS`` env var)::

    spec    := entry ("," entry)*
    entry   := "seed=" INT | site (":" key "=" value)*
    site    := fil.read | queue.claim | db.ingest | checkpoint.write
             | device.oom | worker.kill | cache.corrupt | clock.skew
             | multihost.barrier | multihost.merge | preempt.revoke
    key     := p     (per-invocation probability, seeded -> replayable)
             | n     (max injections; bare site defaults to n=1,at=1)
             | at    (an integer -> fire on that 1-based invocation of
                      the site; anything else -> fire when the
                      invocation context contains the value)
             | skew  (clock.skew only: seconds added to a lease clock)

    PEASOUP_FAULTS='fil.read:p=0.1:n=3,device.oom:at=1'

The campaign layer holds the JAX package's seams at its sites:
``queue.claim`` and ``clock.skew`` in campaign/queue.py, ``worker.kill``
and ``preempt.revoke`` in campaign/runner.py. ``cache.corrupt``'s warmup
seam belongs to a persistent compilation cache, which the port does not
have; ``cache.corrupt`` garbles the checkpoint and the tuning cache
before they are read (:func:`maybe_corrupt_file`).
``device.oom`` raises the card's own out-of-memory form,
:class:`torch.OutOfMemoryError`, so the driver's real handler catches it.

Contracts:

- **zero cost when disabled**: :func:`fire` is a module-global None-check
  and return, and every seam is host-side, outside the kernels;
- **determinism**: each site draws from its own
  ``random.Random(f"{seed}:{site}")`` stream, so a schedule replays
  bit-identically given the same seed and invocation order;
- **attribution**: every injection emits a ``fault_injected`` telemetry
  event and bumps the global stats table, and the injected exception's
  message carries ``[injected:<site>#<ordinal>]``.
"""

from __future__ import annotations

import errno as _errno
import os
import random
import threading

from ..obs.log import get_logger
from .errors import CorruptArtifactError, TransientIOError, WorkerKilled
from .stats import STATS

log = get_logger("resilience.faults")

ENV_VAR = "PEASOUP_FAULTS"
ENV_SEED = "PEASOUP_FAULT_SEED"

SITES = (
    "fil.read",
    "queue.claim",
    "db.ingest",
    "checkpoint.write",
    "device.oom",
    "worker.kill",
    "cache.corrupt",
    "clock.skew",
    "multihost.barrier",
    "multihost.merge",
    "preempt.revoke",
)


def _make_exception(site: str, tag: str) -> BaseException:
    if site == "fil.read":
        return TransientIOError(
            _errno.EIO, f"injected flaky read {tag}"
        )
    if site == "queue.claim":
        return TransientIOError(
            _errno.EIO, f"injected claim I/O failure {tag}"
        )
    if site == "db.ingest":
        import sqlite3

        return sqlite3.OperationalError(f"database is locked {tag}")
    if site == "checkpoint.write":
        return TransientIOError(
            _errno.EIO, f"injected checkpoint write failure {tag}"
        )
    if site == "device.oom":
        import torch

        return torch.OutOfMemoryError(
            f"CUDA out of memory. Tried to allocate 999999999999 bytes {tag}"
        )
    if site == "worker.kill":
        return WorkerKilled(f"injected worker kill {tag}")
    if site == "multihost.barrier":
        # a peer dying at the collective barrier surfaces as a broken
        # connection: TRANSIENT, so the step fails fast instead of hanging
        # (parallel/multihost.py)
        return TransientIOError(
            _errno.ECONNRESET, f"injected multihost barrier failure {tag}"
        )
    if site == "multihost.merge":
        return TransientIOError(
            _errno.EIO, f"injected multihost merge failure {tag}"
        )
    if site == "preempt.revoke":
        # the revoke-delivery seam of the campaign runner (not ported)
        return TransientIOError(
            _errno.EIO, f"injected revoke delivery failure {tag}"
        )
    if site == "cache.corrupt":
        # direct fire: a garbled cache entry, classified CORRUPT so the
        # quarantine policy answers
        return CorruptArtifactError(f"injected corrupt cache entry {tag}")
    # clock.skew acts through its dedicated helper; a direct fire()
    # raises the generic transient form
    return TransientIOError(_errno.EIO, f"injected fault {tag}")


class _Rule:
    """One parsed schedule entry for one site."""

    __slots__ = ("site", "p", "n", "at", "skew", "fired", "calls", "rng")

    def __init__(self, site: str, seed: int) -> None:
        self.site = site
        self.p: float | None = None
        self.n: int | None = None
        self.at: str | None = None
        self.skew: float = 0.0
        self.fired = 0
        self.calls = 0
        self.rng = random.Random(f"{seed}:{site}")

    def should_fire(self, context: str) -> bool:
        self.calls += 1
        if self.n is not None and self.fired >= self.n:
            return False
        if self.at is not None:
            if self.at.isdigit():
                hit = self.calls == int(self.at)
            else:
                hit = self.at in context
                # a context match fires once per budget, not on every
                # matching call, unless n raised it
                if hit and self.n is None and self.fired >= 1:
                    hit = False
            if not hit:
                return False
            if self.p is None:
                self.fired += 1
                return True
        if self.p is not None:
            if self.rng.random() >= self.p:
                return False
            self.fired += 1
            return True
        if self.at is None:
            # bare site / n-only: fire on the first n invocations
            if self.n is None and self.fired >= 1:
                return False
            self.fired += 1
            return True
        return False


class FaultPlan:
    """A parsed, seeded schedule over the fault sites."""

    def __init__(self, rules: dict[str, _Rule], seed: int, spec: str):
        self.rules = rules
        self.seed = seed
        self.spec = spec
        self._lock = threading.Lock()
        self.log: list[dict] = []  # every injection, in order

    def to_doc(self) -> dict:
        with self._lock:
            injected = list(self.log)
        return {
            "spec": self.spec,
            "seed": self.seed,
            "injected": injected,
        }


def parse_faults(spec: str, seed: int | None = None) -> FaultPlan:
    """Parse the schedule grammar; raises ValueError on unknown sites
    or malformed entries (a typo'd chaos schedule must fail loudly,
    not silently run fault-free)."""
    rules: dict[str, _Rule] = {}
    entries = [e.strip() for e in spec.split(",") if e.strip()]
    for entry in entries:
        parts = entry.split(":")
        head = parts[0].strip()
        if head.startswith("seed=") and len(parts) == 1:
            seed = int(head[5:])
            continue
        if head not in SITES:
            raise ValueError(
                f"unknown fault site {head!r} (expected one of "
                f"{', '.join(SITES)})"
            )
        if seed is None:
            seed = int(os.environ.get(ENV_SEED, "0") or 0)
        rule = rules.get(head) or _Rule(head, seed)
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(
                    f"malformed fault option {kv!r} in {entry!r} "
                    "(expected key=value)"
                )
            k, v = kv.split("=", 1)
            k = k.strip()
            v = v.strip()
            if k == "p":
                rule.p = float(v)
            elif k == "n":
                rule.n = int(v)
            elif k == "at":
                rule.at = v
            elif k == "skew":
                rule.skew = float(v)
            else:
                raise ValueError(
                    f"unknown fault option {k!r} in {entry!r}"
                )
        rules[head] = rule
    if seed is None:
        seed = 0
    # re-seed every rule now that the final seed is known (a seed=
    # entry may appear anywhere in the list)
    for site, rule in rules.items():
        rule.rng = random.Random(f"{seed}:{site}")
    return FaultPlan(rules, seed, spec)


# the active plan. None = injection disabled = the fast path: fire()
# is one global load + is-None test.
_PLAN: FaultPlan | None = None
_ENV_CHECKED = False


def configure(
    spec: str | None, seed: int | None = None
) -> FaultPlan | None:
    """Install (or clear, with ``spec=None``) the process fault plan.
    Explicit configuration wins over the environment."""
    global _PLAN, _ENV_CHECKED
    _ENV_CHECKED = True  # explicit call settles the question
    _PLAN = parse_faults(spec, seed) if spec else None
    if _PLAN is not None:
        log.warning(
            "fault injection ACTIVE: %s (seed %d)",
            _PLAN.spec, _PLAN.seed,
        )
    return _PLAN


def active_plan() -> FaultPlan | None:
    """The current plan, lazily picking up ``PEASOUP_FAULTS`` on first
    use so CLI processes need no code change to join a chaos run."""
    global _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        spec = os.environ.get(ENV_VAR)
        if spec:
            configure(spec)
    return _PLAN


def _inject(site: str, rule: _Rule, context: str) -> BaseException:
    tag = f"[injected:{site}#{rule.fired}]"
    exc = _make_exception(site, tag)
    STATS.fault_injected(site)
    plan = _PLAN
    if plan is not None:
        with plan._lock:
            plan.log.append(
                {"site": site, "ordinal": rule.fired, "context": context}
            )
    from ..obs.telemetry import current

    current().event(
        "fault_injected", site=site, ordinal=rule.fired,
        context=context,
    )
    log.warning("injecting fault at %s (%s) %s", site, context, tag)
    return exc


def fire(site: str, context: str = "") -> None:
    """The fault site seam: no-op unless an active plan schedules an
    injection here, in which case the site's mapped exception is
    raised. Call sites are host code, never inside a kernel's wrapper."""
    plan = _PLAN if _ENV_CHECKED else active_plan()
    if plan is None:
        return
    rule = plan.rules.get(site)
    if rule is None or not rule.should_fire(context):
        return
    raise _inject(site, rule, context)


def maybe_corrupt_file(path: str, context: str = "") -> bool:
    """The ``cache.corrupt`` seam: when scheduled, overwrite the head
    of ``path`` with garbage bytes (deterministic, so the damaged
    artifact is reproducible) BEFORE the caller reads it — the caller
    then exercises its real corrupt-artifact recovery against real
    torn bytes. Returns True when corruption was injected."""
    plan = _PLAN if _ENV_CHECKED else active_plan()
    if plan is None:
        return False
    rule = plan.rules.get("cache.corrupt")
    if rule is None or not os.path.exists(path):
        return False
    if not rule.should_fire(context or path):
        return False
    _inject("cache.corrupt", rule, context or path)  # records, no raise
    with open(path, "r+b") as f:
        f.write(b"\x00CHAOS-CORRUPT\x00")
    return True


def clock_skew_s() -> float:
    """The ``clock.skew`` seam: seconds a scheduled skew adds to a lease
    clock (the campaign queue's, not ported yet). The first read records
    the injection; 0.0 when unscheduled."""
    plan = _PLAN if _ENV_CHECKED else active_plan()
    if plan is None:
        return 0.0
    rule = plan.rules.get("clock.skew")
    if rule is None or not rule.skew:
        return 0.0
    if rule.fired == 0:
        rule.fired = 1
        _inject("clock.skew", rule, f"skew={rule.skew}")
    return rule.skew
