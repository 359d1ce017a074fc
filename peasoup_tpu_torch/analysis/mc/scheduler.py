"""Cooperative scheduler: one runnable simulated worker at a time.

Each scenario task runs the real module code on its own (daemon)
thread, but only one thread is ever runnable: a task parks at every
FS operation (:meth:`Scheduler.perform`) and the explorer *grants*
exactly one parked task per step. Event-pair handshakes — never
locks — serialize the exchange, so the module code under test
executes single-threaded and deterministically.

Crash injection: granting a ``K<i>`` token marks task *i* killed and
wakes it; the parked op raises :class:`~..resilience.errors.
WorkerKilled` (a ``BaseException``) *before executing*, and every
subsequent FS op of that task raises again without parking. Cleanup
handlers therefore cannot mutate shared state — the SIGKILL model —
and unwinding can never deadlock the scheduler.
"""

from __future__ import annotations

import threading
from hashlib import sha1
from typing import Any, Callable

from ...resilience.errors import WorkerKilled
from .vfs import MCEnv, OpDesc


class MCDeadlock(Exception):
    """Module code blocked without reaching an FS op (internal)."""


class _MCAbort(BaseException):
    """Run teardown: unwind a parked task without side effects."""


def _hchain(prev: str, item: str) -> str:
    return sha1(f"{prev}|{item}".encode()).hexdigest()[:16]


class MCTask:
    """One simulated worker process."""

    def __init__(
        self,
        index: int,
        name: str,
        fn: Callable[[], Any],
        killable: bool = False,
    ) -> None:
        self.index = index
        self.name = name
        self.fn = fn
        self.killable = killable
        self.status = "new"  # new|parked|running|done|killed|error|aborted
        self.killed = False
        self.aborted = False
        self.pending: tuple[OpDesc, Callable[[], Any]] | None = None
        self.error: BaseException | None = None
        self.result: Any = None
        self.hseq = "0"  # running hash of this task's op history
        self.pid = 1000 + index
        self._go = threading.Event()
        self._thread: threading.Thread | None = None


class Scheduler:
    """Drives :class:`MCTask` threads one granted step at a time."""

    def __init__(
        self, env: MCEnv, max_kills: int = 1, timeout_s: float = 30.0
    ) -> None:
        self.env = env
        self.tasks: list[MCTask] = []
        self.max_kills = max_kills
        self.kills_used = 0
        self._control = threading.Event()
        self._by_ident: dict[int, MCTask] = {}
        self._timeout = timeout_s

    # -- task-thread side ---------------------------------------------
    def current_task(self) -> MCTask | None:
        return self._by_ident.get(threading.get_ident())

    def perform(
        self, task: MCTask, desc: OpDesc, fn: Callable[[], Any]
    ) -> Any:
        """Called (via :meth:`MCEnv.op`) from the task's own thread:
        park, wait for a grant, then execute the op in place."""
        if task.killed:
            raise WorkerKilled(f"mc: {task.name} killed")
        if task.aborted:
            raise _MCAbort()
        task.pending = (desc, fn)
        task.status = "parked"
        self._control.set()
        task._go.wait()
        task._go.clear()
        task.pending = None
        if task.killed:
            self.env.trace.append(f"{task.name}:KILLED:{desc.key}")
            task.hseq = _hchain(task.hseq, f"KILLED:{desc.key}")
            raise WorkerKilled(f"mc: {task.name} killed at {desc.key}")
        if task.aborted:
            raise _MCAbort()
        task.status = "running"
        self.env.ops.append((task.name, desc))
        try:
            out = fn()
        except BaseException as e:
            self.env.trace.append(
                f"{task.name}:{desc.key}!{type(e).__name__}"
            )
            task.hseq = _hchain(
                task.hseq, f"{desc.key}!{type(e).__name__}"
            )
            raise
        self.env.trace.append(f"{task.name}:{desc.key}")
        task.hseq = _hchain(task.hseq, desc.key)
        return out

    def _task_main(self, task: MCTask) -> None:
        self._by_ident[threading.get_ident()] = task
        task.status = "running"
        try:
            task.result = task.fn()
            task.status = "done"
        except WorkerKilled:
            task.status = "killed"
        except _MCAbort:
            task.status = "aborted"
        except BaseException as e:  # noqa: BLE001 - reported as PSM300
            task.error = e
            task.status = "error"
        finally:
            self._control.set()

    # -- explorer side ------------------------------------------------
    def start(self, tasks: list[MCTask]) -> None:
        """Spawn the task threads one at a time, each running freely
        until its first FS op (or completion) — sequential start keeps
        even pre-op Python code single-threaded."""
        self.tasks = list(tasks)
        for t in self.tasks:
            # audit: ignore[PSA009] -- explorer-thread-only access; the
            # clear/set pair on the (itself thread-safe) Event IS the
            # handshake that keeps every other access single-threaded
            self._control.clear()
            # audit: ignore[PSP104] -- cooperative mc worker thread: the
            # scheduler owns its lifecycle and joins it at shutdown
            t._thread = threading.Thread(
                target=self._task_main,
                args=(t,),
                name=f"mc-{t.name}",
                daemon=True,
            )
            t._thread.start()
            self._wait_control()

    def _wait_control(self) -> None:
        if not self._control.wait(self._timeout):
            raise MCDeadlock(
                "module code blocked without reaching an FS op"
            )

    def enabled(self) -> dict[str, OpDesc | None]:
        """Grantable tokens: ``"<i>"`` per parked task, plus ``"K<i>"``
        when that task is killable and the kill budget remains."""
        out: dict[str, OpDesc | None] = {}
        for t in self.tasks:
            if t.status == "parked" and t.pending is not None:
                out[str(t.index)] = t.pending[0]
                if (
                    t.killable
                    and not t.killed
                    and self.kills_used < self.max_kills
                ):
                    out[f"K{t.index}"] = None
        return out

    def grant(self, token: str) -> None:
        """Wake one parked task (optionally killing it first) and wait
        until it parks again or finishes."""
        if token.startswith("K"):
            task = self.tasks[int(token[1:])]
            task.killed = True
            # audit: ignore[PSA009] -- only the explorer thread grants
            self.kills_used += 1
        else:
            task = self.tasks[int(token)]
        # audit: ignore[PSA009] -- explorer-thread-only: cleared while
        # every task thread is parked on its own _go event
        self._control.clear()
        task._go.set()
        self._wait_control()

    def shutdown(self) -> None:
        """Abort any still-parked tasks (deadlock/early-stop paths)
        and join every thread."""
        for t in self.tasks:
            if t.status == "parked":
                t.aborted = True
                t._go.set()
        for t in self.tasks:
            if t._thread is not None:
                t._thread.join(timeout=5.0)
        # audit: ignore[PSA009] -- all task threads joined above
        self._by_ident.clear()
