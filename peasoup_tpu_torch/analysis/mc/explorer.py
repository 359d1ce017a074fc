"""Interleaving exploration: replay-based DFS with state-hash dedup
and conflict-based partial-order reduction.

A *schedule* is a sequence of tokens consumed only at **decision
points** — scheduler states with more than one grantable token. A run
executes its forced schedule prefix and continues with the default
policy (lowest-index task, never a kill), recording every decision
point's enabled set, op descriptors and state hash. The explorer then
branches: for each free decision it pushes ``prefix + alternative``,
pruning alternatives that

* start from an already-explored ``(state-hash, token)`` pair — tasks
  are deterministic functions of their op history, so equal hashes
  mean equal futures (``dedup``); or
* are *independent* of every other enabled op (disjoint paths, no
  listdir-vs-entry mutation, no clock/kill/inode hazards) AND whose
  task's remaining footprint — its ops later in this very run — never
  conflicts with another task's (the dynamic-POR condition: a task
  whose future touches contended paths must be explored early, or the
  orderings where it wins the race are silently lost). Heuristic —
  futures are taken from the observed run, not all runs — backstopped
  by dedup and spot-checked against ``por=False``.

Violations carry the decision sequence; :func:`minimize` shrinks it
to the shortest prefix that still reproduces, and :func:`replay` runs
a schedule string bit-identically (same trace, same violation).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .invariants import InvariantViolation, MCContext
from .scheduler import MCDeadlock, MCTask, Scheduler
from .vfs import MCEnv, OpDesc, conflicts, interpose

DEFAULT_BUDGET = 400  # schedules per scenario


class ScheduleError(Exception):
    """A replayed schedule diverged from the recorded decisions."""


@dataclass(frozen=True)
class Scenario:
    """One protocol drill: setup, concurrent tasks, and an invariant
    checked after every complete interleaving."""

    name: str
    rule: str  # PSM3xx finding rule id
    module: str  # repo-relative path the finding anchors to
    description: str
    setup: Callable[[MCContext], None]
    tasks: tuple[tuple[str, Callable[[MCContext], Any], bool], ...]
    invariant: Callable[[MCContext], None]
    max_kills: int = 1
    skews: dict[str, float] = field(default_factory=dict)
    fix_hint: str = ""


@dataclass
class Decision:
    chosen: str
    enabled: tuple[str, ...]
    ops: dict[str, OpDesc | None]
    state: str
    n_ops: int = 0  # executed-op count at decision time


@dataclass
class RunResult:
    schedule: tuple[str, ...]  # forced prefix actually consumed
    decisions: list[Decision]
    trace: list[str]
    violation: str | None
    internal: bool  # PSM300-class (task crash / deadlock)
    tasks: dict[str, str]  # task name -> final status
    ops: list[tuple[str, OpDesc]] = field(default_factory=list)

    @property
    def chosen(self) -> tuple[str, ...]:
        return tuple(d.chosen for d in self.decisions)


def _tok_key(tok: str) -> tuple[bool, int]:
    return (tok.startswith("K"), int(tok.lstrip("K")))


def _default_pick(tokens: list[str]) -> str:
    return next(t for t in tokens if not t.startswith("K"))


def target_modules() -> tuple[Any, ...]:
    """The modules whose stdlib seams get interposed: the four
    protocol modules plus ``obs.trace`` (deterministic trace ids)."""
    from ...campaign import queue as qmod
    from ...campaign import registry as rmod
    from ...campaign import tenants as tmod
    from ...obs import alerts as amod
    from ...obs import trace as trmod

    return (qmod, rmod, tmod, amod, trmod)


def run_schedule(
    scenario: Scenario, schedule: tuple[str, ...] = ()
) -> RunResult:
    """Execute one interleaving: forced ``schedule`` prefix at the
    decision points, default policy afterwards."""
    env = MCEnv()
    for name, _, _ in scenario.tasks:
        env.skew[name] = scenario.skews.get(name, 0.0)
    ctx = MCContext(env=env)
    violation: str | None = None
    internal = False
    decisions: list[Decision] = []
    consumed = 0
    with interpose(env, target_modules()):
        scenario.setup(ctx)
        sch = Scheduler(env, max_kills=scenario.max_kills)
        env.scheduler = sch
        tasks = [
            MCTask(i, name, (lambda fn=fn: fn(ctx)), killable)
            for i, (name, fn, killable) in enumerate(scenario.tasks)
        ]
        try:
            sch.start(tasks)
            while True:
                en = sch.enabled()
                if not en:
                    break
                toks = sorted(en, key=_tok_key)
                if len(toks) == 1:
                    sch.grant(toks[0])
                    continue
                if consumed < len(schedule):
                    tok = schedule[consumed]
                    consumed += 1
                    if tok not in en:
                        raise ScheduleError(
                            f"{scenario.name}: token {tok!r} not "
                            f"enabled (enabled={toks})"
                        )
                else:
                    tok = _default_pick(toks)
                decisions.append(
                    Decision(
                        tok,
                        tuple(toks),
                        dict(en),
                        env.state_hash(),
                        len(env.ops),
                    )
                )
                sch.grant(tok)
        except MCDeadlock as e:
            violation = f"internal: {e}"
            internal = True
        finally:
            env.scheduler = None
            sch.shutdown()
        if violation is None:
            for t in tasks:
                if t.status == "error":
                    violation = (
                        f"internal: task {t.name} raised "
                        f"{type(t.error).__name__}: {t.error}"
                    )
                    internal = True
                    break
        if violation is None:
            try:
                scenario.invariant(ctx)
            except InvariantViolation as e:
                violation = str(e)
    return RunResult(
        schedule=tuple(schedule[:consumed]),
        decisions=decisions,
        trace=list(env.trace),
        violation=violation,
        internal=internal,
        tasks={t.name: t.status for t in tasks},
        ops=list(env.ops),
    )


def _por_prunable(
    alt: str,
    d: Decision,
    names: list[str],
    run_ops: list[tuple[str, OpDesc]],
) -> bool:
    """May branch ``alt`` be skipped at this decision? Only when its
    op is independent of every *other* enabled op (kills and global
    ops always conflict) AND — the dynamic condition — the task's
    remaining footprint in this run never conflicts with another
    task's. Without the future check, deferring a task whose *next*
    op is an innocent read also defers its contended write, and the
    interleavings where it wins that race are never generated."""
    op_a = d.ops.get(alt)
    if op_a is None:  # kill token: never prune
        return False
    for tok in d.enabled:
        if tok == alt:
            continue
        op_b = d.ops.get(tok)
        if op_b is None or conflicts(op_a, op_b):
            return False
    me = names[int(alt)]
    future = run_ops[d.n_ops :]
    mine = [op_a] + [op for who, op in future if who == me]
    others = [op for who, op in future if who not in ("-", me)]
    return not any(
        conflicts(x, y) for x in mine for y in others
    )


@dataclass
class ExploreResult:
    scenario: str
    schedules: int = 0
    dedup_hits: int = 0
    reductions: int = 0
    crash_points: int = 0
    exhausted: bool = False
    # distinct violation messages with the decision sequence that
    # produced them, in discovery order
    violations: list[tuple[str, tuple[str, ...]]] = field(
        default_factory=list
    )
    first: RunResult | None = None


def explore(
    scenario: Scenario,
    budget: int | None = None,
    por: bool = True,
    stop_on_first: bool = True,
) -> ExploreResult:
    """DFS over schedule prefixes up to ``budget`` runs."""
    limit = budget or DEFAULT_BUDGET
    names = [name for name, _, _ in scenario.tasks]
    seen: set[tuple[str, str]] = set()
    stack: list[tuple[str, ...]] = [()]
    res = ExploreResult(scenario.name)
    msgs: set[str] = set()
    while stack and res.schedules < limit:
        sched = stack.pop()
        run = run_schedule(scenario, sched)
        res.schedules += 1
        if run.violation is not None and run.violation not in msgs:
            msgs.add(run.violation)
            res.violations.append((run.violation, run.chosen))
            if res.first is None:
                res.first = run
            if stop_on_first:
                return res
        k = len(run.schedule)  # forced prefix = first k decisions
        for i in range(k, len(run.decisions)):
            d = run.decisions[i]
            seen.add((d.state, d.chosen))
            prefix = run.chosen[:i]
            for alt in d.enabled:
                if alt == d.chosen:
                    continue
                if (d.state, alt) in seen:
                    res.dedup_hits += 1
                    continue
                if por and _por_prunable(alt, d, names, run.ops):
                    res.reductions += 1
                    continue
                seen.add((d.state, alt))
                stack.append(prefix + (alt,))
    res.exhausted = not stack
    return res


def minimize(
    scenario: Scenario, chosen: tuple[str, ...], message: str
) -> tuple[str, ...]:
    """Shortest prefix of the violating decision sequence that still
    reproduces ``message`` under default-policy continuation."""
    for n in range(len(chosen) + 1):
        if run_schedule(scenario, chosen[:n]).violation == message:
            return tuple(chosen[:n])
    return tuple(chosen)


def schedule_to_str(schedule: tuple[str, ...]) -> str:
    return ".".join(schedule) if schedule else "-"


def str_to_schedule(s: str) -> tuple[str, ...]:
    s = s.strip()
    if not s or s == "-":
        return ()
    return tuple(tok for tok in s.split(".") if tok)


def replay(scenario: Scenario, schedule_str: str) -> RunResult:
    """Run a recorded schedule string (as embedded in a PSM finding's
    ``source_line``) — deterministic: two replays produce identical
    traces."""
    return run_schedule(scenario, str_to_schedule(schedule_str))
