"""Cooperative revoke tokens: checkpointed preemption and retirement (the
port's copy of the JAX package's resilience/revoke.py).

A running search cannot be stopped at an arbitrary instruction without
losing or duplicating work, but it can stop cleanly at a DM-block
boundary, where the per-trial checkpoint (pipeline/checkpoint.py) has
just been saved. Whoever wants the claim back (in the JAX package, the
campaign runner's lease renewer; the port's campaign runner is not
ported yet) flips a :class:`RevokeToken` that the job's thread activated
(:func:`activate_token`); the driver calls :func:`check_revoke` after each
checkpoint save, and the first check after the flip raises
:class:`SearchPreempted`, with the checkpoint consistent by construction.

The token rides a contextvar, so only the thread running the job sees
the revoke, and the check is one contextvar read when no token is
active.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time


class SearchPreempted(Exception):
    """Control-flow: the driver stopped at a checkpoint boundary in
    answer to a revoke. The checkpoint on disk is consistent; the
    runner must release (not fail) the claim."""

    def __init__(self, kind: str, reason: str = "") -> None:
        super().__init__(f"search {kind}ed: {reason}" if reason else kind)
        self.kind = kind
        self.reason = reason


class RevokeToken:
    """One job's revoke state, set by the lease-renewer thread and read
    by the driver thread at checkpoint boundaries."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.kind: str | None = None  # "preempt" | "retire" | "lost"
        self.reason: str = ""
        self.requested_unix: float | None = None
        self.observed_unix: float | None = None

    def revoke(
        self,
        kind: str = "preempt",
        reason: str = "",
        requested_unix: float | None = None,
    ) -> None:
        """Flip the token (idempotent — the first revoke wins)."""
        with self._lock:
            if self._event.is_set():
                return
            self.kind = kind
            self.reason = reason
            self.requested_unix = requested_unix
            self.observed_unix = time.time()
            self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set()


_TOKEN: contextvars.ContextVar[RevokeToken | None] = contextvars.ContextVar(
    "peasoup_torch_revoke_token", default=None
)


def current_token() -> RevokeToken | None:
    return _TOKEN.get()


@contextlib.contextmanager
def activate_token(token: RevokeToken):
    """Install ``token`` for the calling thread's context (the runner
    wraps one job's execution in this)."""
    handle = _TOKEN.set(token)
    try:
        yield token
    finally:
        _TOKEN.reset(handle)


def check_revoke(site: str = "") -> None:
    """The driver-side seam: raise :class:`SearchPreempted` when the
    active token (if any) has been revoked. Call ONLY where the
    persisted state is consistent — immediately after a checkpoint
    save is the contract."""
    token = _TOKEN.get()
    if token is None or not token.is_set():
        return
    from ..obs.telemetry import current

    current().event(
        "revoke_checkpoint_stop",
        revoke_kind=token.kind,
        reason=token.reason,
        site=site,
    )
    raise SearchPreempted(token.kind or "preempt", token.reason)
