"""The protocol drill library: what the model checker checks (the JAX
package's analysis/mc/scenarios.py over the port's modules, plus
``complete_vs_claim``).

Each :class:`~.explorer.Scenario` stages a small fleet — two or three
simulated workers running the *real* ``campaign``/``obs`` protocol
code against the virtual filesystem — and asserts a load-bearing
invariant over every explored interleaving and crash point:

========================  ======  =====================================
scenario                  rule    invariant
========================  ======  =====================================
claim_race                PSM301  exactly one O_EXCL claim winner
claim_crash_reap          PSM302  SIGKILLed claimer's job is recovered,
                                  never double-charged
renew_vs_reap             PSM303  lease renewal and the reaper agree on
                                  ownership (no stomped renewals)
release_vs_reap           PSM303  voluntary release consumes zero
                                  attempts, reaper charges at most one
zombie_complete           PSM301  the done record publishes exactly
                                  once, even with a reaped zombie
complete_vs_claim         PSM301  a completing job is claimed once and
                                  published once while a second worker
                                  claims until the queue is drained
preempt_handoff           PSM304  preemption hand-back XOR grace reap;
                                  carried resilience survives the fold
gang_assembly             PSM305  a published gang claim always names a
                                  full member set
gang_insufficient         PSM305  an under-strength gang never claims
registry_group_survival   PSM306  re-registration after a skewed reap
                                  keeps gang-group membership
registry_torn_entry       PSM306  torn (mid-publish) registry entries
                                  are swept after a grace lease
tenant_throttle           PSM307  concurrent claims over-admit by at
                                  most one; the next claim throttles
alerts_lock               PSM308  alert evaluation is mutually
                                  exclusive while the lock is fresh
alerts_release_race       PSM308  releasing a stale-taken-over lock
                                  never clobbers the new holder
alerts_journal            PSM308  journal lines are never torn; one
                                  firing transition per episode
========================  ======  =====================================

Violations become PSM3xx findings whose ``source_line`` embeds the
minimized schedule (``<scenario> schedule=<tokens>``) — feed it back
through :func:`~.explorer.replay` for a bit-identical reproduction.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..findings import SEV_ERROR, Finding
from .crash import enumerate_crash_points
from .explorer import (
    DEFAULT_BUDGET,
    Scenario,
    explore,
    minimize,
    schedule_to_str,
)
from .invariants import MCContext, require

ROOT = "/camp"
_Q = f"{ROOT}/queue"


def _job_path(jid: str) -> str:
    return f"{_Q}/jobs/{jid}.json"


def _claim_path(jid: str) -> str:
    return f"{_Q}/claims/{jid}.json"


def _done_path(jid: str) -> str:
    return f"{_Q}/done/{jid}.json"


def _queue(**kw):
    from ...campaign.queue import JobQueue

    return JobQueue(ROOT, **kw)


def _job(jid: str, **kw):
    from ...campaign.queue import Job

    return Job(jid, f"/data/{jid}.fil", **kw)


def _attempts(ctx: MCContext, jid: str = "j1") -> int:
    doc = ctx.read_json(_job_path(jid))
    return int(doc.get("attempts", 0)) if doc else 0


def _published(ctx: MCContext, path: str) -> int:
    """Successful publications of ``path``: every atomic-publish idiom
    lands as exactly one ``create``/``link``/``rename`` trace op on the
    destination (a failed duplicate carries an ``!ExcName`` suffix and
    does not count)."""
    wanted = {f"{k}:{path}" for k in ("create", "link", "rename")}
    n = 0
    for e in ctx.env.trace:
        _, _, rest = e.partition(":")
        if rest in wanted:
            n += 1
    return n


def _killed(ctx: MCContext) -> bool:
    return any(":KILLED:" in e for e in ctx.env.trace)


# ---------------------------------------------------------------------------
# queue: claim mutual exclusion + crash recovery
# ---------------------------------------------------------------------------


def _claim_race() -> Scenario:
    def setup(ctx: MCContext) -> None:
        _queue().add_job(_job("j1"))

    def worker(name: str):
        def body(ctx: MCContext) -> None:
            ctx.out[name] = _queue().try_claim("j1", name) is not None

        return body

    def invariant(ctx: MCContext) -> None:
        w1, w2 = ctx.out.get("w1"), ctx.out.get("w2")
        require(
            w1 != w2,
            f"claim mutual exclusion broken: w1={w1} w2={w2} "
            "(O_EXCL must admit exactly one claimer)",
        )
        doc = ctx.read_json(_claim_path("j1"))
        winner = "w1" if w1 else "w2"
        require(
            doc is not None and doc.get("worker_id") == winner,
            f"claim doc names {doc and doc.get('worker_id')!r}, "
            f"but {winner} won the claim",
        )

    return Scenario(
        name="claim_race",
        rule="PSM301",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="two workers race try_claim on the same job",
        setup=setup,
        tasks=(
            ("w1", worker("w1"), False),
            ("w2", worker("w2"), False),
        ),
        invariant=invariant,
        max_kills=0,
        fix_hint="claim creation must go through O_CREAT|O_EXCL and the "
        "loser must treat FileExistsError as a lost race, not retry",
    )


def _claim_crash_reap() -> Scenario:
    def setup(ctx: MCContext) -> None:
        _queue().add_job(_job("j1"))

    def w1(ctx: MCContext) -> None:
        ctx.out["w1"] = _queue().try_claim("j1", "w1") is not None

    def reaper(ctx: MCContext) -> None:
        q = _queue(backoff_base_s=0.0)
        ctx.advance(400)
        q.reap_stale()
        ctx.advance(10)
        ctx.out["reclaim"] = q.try_claim("j1", "r") is not None

    def invariant(ctx: MCContext) -> None:
        doc = ctx.read_json(_claim_path("j1"))
        w1_holds = doc is not None and doc.get("worker_id") == "w1"
        # a crash can leave a TORN claim younger than its grace lease
        # (created after the reaper's advance): this sweep keeps its
        # hands off it, the NEXT one recovers it — the job is pending,
        # not lost
        torn_pending = (
            _killed(ctx)
            and doc is None
            and ctx.exists(_claim_path("j1"))
        )
        require(
            ctx.out.get("reclaim") or w1_holds or torn_pending,
            "job lost after a crashed claimer: neither the reaper "
            "reclaimed it nor does the original claim survive",
        )
        att = _attempts(ctx)
        require(
            att <= 1,
            f"crash-reap charged {att} attempts for one crashed claim "
            "(double-charging burns the retry budget)",
        )
        if w1_holds:
            require(
                att == 0,
                "the live holder's job was charged an attempt by the "
                "reaper (the tombstone dance must verify before charging)",
            )

    return Scenario(
        name="claim_crash_reap",
        rule="PSM302",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="claimer SIGKILLed at any FS op; reaper recovers",
        setup=setup,
        tasks=(("w1", w1, True), ("reaper", reaper, False)),
        invariant=invariant,
        max_kills=1,
        fix_hint="reap must rename the claim to a private tombstone, "
        "re-verify it, and charge torn (empty) claims zero attempts",
    )


def _renew_vs_reap() -> Scenario:
    def setup(ctx: MCContext) -> None:
        q = _queue()
        q.add_job(_job("j1"))
        ctx.out["claim"] = q.try_claim("j1", "w1")
        ctx.advance(50)  # 10s of lease left; reaper skew pushes past it

    def w1(ctx: MCContext) -> None:
        ctx.out["renew_ok"] = _queue().renew(ctx.out["claim"])

    def reaper(ctx: MCContext) -> None:
        _queue().reap_stale()

    def invariant(ctx: MCContext) -> None:
        renew_ok = bool(ctx.out.get("renew_ok"))
        att = _attempts(ctx)
        require(
            renew_ok != (att == 1),
            f"renew/reap disagree on ownership: renew_ok={renew_ok} "
            f"attempts={att} (exactly one of them owns the outcome)",
        )
        doc = ctx.read_json(_claim_path("j1"))
        held = doc is not None and doc.get("worker_id") == "w1"
        require(
            held == renew_ok,
            f"claim state diverged from renew outcome: renew_ok="
            f"{renew_ok} but claim held={held}",
        )

    return Scenario(
        name="renew_vs_reap",
        rule="PSM303",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="lease renewal races a clock-skewed reaper",
        setup=setup,
        tasks=(("w1", w1, False), ("reaper", reaper, False)),
        invariant=invariant,
        max_kills=0,
        skews={"reaper": 30.0},
        fix_hint="renew must republish via the take-verify-republish "
        "dance and report False on a lost lease; a blind os.replace "
        "lets a reaped zombie stomp the reaper's requeue",
    )


def _release_vs_reap() -> Scenario:
    def setup(ctx: MCContext) -> None:
        q = _queue()
        q.add_job(_job("j1"))
        ctx.out["claim"] = q.try_claim("j1", "w1")

    def w1(ctx: MCContext) -> None:
        q = _queue()
        q.release(ctx.out["claim"])
        q.release(ctx.out["claim"])  # idempotence under interleaving

    def reaper(ctx: MCContext) -> None:
        ctx.advance(70)
        _queue().reap_stale()

    def invariant(ctx: MCContext) -> None:
        att = _attempts(ctx)
        require(
            att <= 1,
            f"release/reap race charged {att} attempts (a clean "
            "hand-back is elasticity, not failure)",
        )
        leftovers = [
            n for n in ctx.listdir(f"{_Q}/claims") if n.startswith("j1")
        ]
        require(
            not leftovers,
            f"claim artifacts leaked after release+reap: {leftovers}",
        )

    return Scenario(
        name="release_vs_reap",
        rule="PSM303",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="double voluntary release races the lease reaper",
        setup=setup,
        tasks=(("w1", w1, False), ("reaper", reaper, False)),
        invariant=invariant,
        max_kills=0,
        fix_hint="release must be a verified tombstone take (no-op on a "
        "lost lease) and never unlink the new owner's claim",
    )


def _zombie_complete() -> Scenario:
    def setup(ctx: MCContext) -> None:
        q = _queue(backoff_base_s=0.0)
        q.add_job(_job("j1"))
        ctx.out["claim"] = q.try_claim("j1", "w1")

    def w1(ctx: MCContext) -> None:
        _queue(backoff_base_s=0.0).complete(
            ctx.out["claim"], worker_id="w1"
        )

    def sweeper(ctx: MCContext) -> None:
        q = _queue(backoff_base_s=0.0)
        ctx.advance(70)
        q.reap_stale()
        c2 = q.try_claim("j1", "w2")
        if c2 is not None:
            q.complete(c2, worker_id="w2")

    def invariant(ctx: MCContext) -> None:
        n = _published(ctx, _done_path("j1"))
        require(
            n == 1,
            f"done record published {n} times (must be exactly once: "
            "a reaped zombie completer may not stomp or duplicate the "
            "re-claimer's publication)",
        )

    return Scenario(
        name="zombie_complete",
        rule="PSM301",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="completer races its own reap + a re-claimer",
        setup=setup,
        tasks=(("w1", w1, True), ("sweeper", sweeper, False)),
        invariant=invariant,
        max_kills=1,
        fix_hint="complete must prove ownership first (zombies get "
        "False) and publish the done record via tmp + os.link so a "
        "duplicate surfaces as FileExistsError, never an overwrite",
    )


def _complete_vs_claim() -> Scenario:
    """The race of the JAX package's two-worker queue test, modelled: the
    JAX ``complete`` takes the claim away before it links the done
    record, so between the two the job has neither marker and a second
    worker's ``claim_next`` claims it again (its zombie_complete drill
    races a completer against its own reap, never against a claimer)."""

    def setup(ctx: MCContext) -> None:
        q = _queue(backoff_base_s=0.0)
        q.add_job(_job("j1"))
        ctx.out["claim"] = q.try_claim("j1", "w1")

    def w1(ctx: MCContext) -> None:
        _queue(backoff_base_s=0.0).complete(ctx.out["claim"], worker_id="w1")

    def w2(ctx: MCContext) -> None:
        q = _queue(backoff_base_s=0.0)
        claimed = []
        for _ in range(2):  # bounded: each pass is one claim attempt
            c = q.claim_next("w2")
            if c is not None:
                claimed.append(c.job.job_id)
                q.complete(c, worker_id="w2")
            elif q.drained():
                break
        ctx.out["w2_claims"] = claimed

    def invariant(ctx: MCContext) -> None:
        again = ctx.out.get("w2_claims", [])
        require(
            "j1" not in again,
            "j1 claimed twice: w2's claim_next took the job w1 was "
            "completing (the claim was gone before the done record "
            "was published)",
        )
        n = _published(ctx, _done_path("j1"))
        require(n == 1, f"done record published {n} times (must be exactly once)")

    return Scenario(
        name="complete_vs_claim",
        rule="PSM301",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="completer races a second worker's claim_next loop",
        setup=setup,
        tasks=(("w1", w1, False), ("w2", w2, False)),
        invariant=invariant,
        max_kills=0,
        fix_hint="complete must publish the done record before it drops "
        "the claim, so the job always holds one of the two markers",
    )


def jax_order_complete(self, claim, **info) -> bool:
    """``JobQueue.complete`` in the JAX package's order
    (peasoup_tpu/campaign/queue.py:604-631): take the claim, then link
    the done record. Monkeypatched onto the port's queue, it seeds the
    race ``complete_vs_claim`` must find."""
    from ...campaign import queue as qmod

    tomb = self._take_claim(claim)
    if tomb is None:
        return False
    done = self._p(qmod._DONE, claim.job.job_id)
    fd, tmp = qmod.tempfile.mkstemp(dir=qmod.os.path.dirname(done), suffix=".tmp")
    try:
        with qmod.os.fdopen(fd, "w") as f:
            qmod.json.dump({"job_id": claim.job.job_id,
                            "worker_id": claim.worker_id, **info}, f)
        try:
            qmod.os.link(tmp, done)
        except FileExistsError:
            pass
    finally:
        try:
            qmod.os.unlink(tmp)
        except FileNotFoundError:
            pass
    self.clear_preempt(claim.job.job_id)
    qmod._discard(tomb)
    return True


def _preempt_handoff() -> Scenario:
    def setup(ctx: MCContext) -> None:
        q = _queue()
        q.add_job(_job("j1"))
        ctx.out["claim"] = q.try_claim("j1", "w1")
        q.request_preempt("j1", requester="scaler", grace_s=30.0)

    def victim(ctx: MCContext) -> None:
        q = _queue()
        ctx.out["folded"] = q.record_carried_resilience(
            ctx.out["claim"], {"retries": {"io": 2}}
        )
        q.release_preempted(ctx.out["claim"])

    def reaper(ctx: MCContext) -> None:
        ctx.advance(45)  # past the grace deadline, inside the lease
        _queue().reap_stale()

    def invariant(ctx: MCContext) -> None:
        doc = ctx.read_json(_job_path("j1")) or {}
        pre = int(doc.get("preemptions", 0))
        att = int(doc.get("attempts", 0))
        require(
            pre <= 1 and att <= 1,
            f"preempt hand-back double-counted: preemptions={pre} "
            f"attempts={att}",
        )
        require(
            (pre == 1) != (att == 1),
            f"preempt hand-back and grace reap must be exclusive: "
            f"preemptions={pre} attempts={att}",
        )
        if ctx.out.get("folded"):
            carried = (doc.get("carried_resilience") or {}).get(
                "retries", {}
            )
            require(
                int(carried.get("io", 0)) == 2,
                "carried resilience fold reported success but the "
                f"counters are missing from the job record: {carried}",
            )

    return Scenario(
        name="preempt_handoff",
        rule="PSM304",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="checkpointed hand-back races the grace-deadline reap",
        setup=setup,
        tasks=(("victim", victim, False), ("reaper", reaper, False)),
        invariant=invariant,
        max_kills=0,
        fix_hint="record_carried_resilience must report whether the "
        "fold landed; release_preempted must no-op (not re-record) on "
        "a lost lease",
    )


# ---------------------------------------------------------------------------
# queue: gang scheduling
# ---------------------------------------------------------------------------


def _gang_assembly() -> Scenario:
    def setup(ctx: MCContext) -> None:
        _queue().add_job(_job("j1", nprocs=3))

    def wa(ctx: MCContext) -> None:
        ctx.out["wa"] = _queue(backoff_base_s=0.0).claim_next(
            "wa", group="g", group_members=["wa", "wb", "wc"]
        )

    def watcher(ctx: MCContext) -> None:
        q = _queue(backoff_base_s=0.0)
        ctx.advance(70)
        q.reap_stale()
        ctx.out["c2"] = q.claim_next(
            "wb", group="g", group_members=["wb", "wc", "wd"]
        )

    def invariant(ctx: MCContext) -> None:
        doc = ctx.read_json(_claim_path("j1"))
        if doc is not None:
            gang = doc.get("gang") or {}
            members = gang.get("members") or []
            require(
                gang.get("group") == "g"
                and len(members) == 3
                and int(gang.get("nprocs", 0)) == 3
                and doc.get("worker_id") in members,
                f"published gang claim is malformed: {gang} "
                f"(leader {doc.get('worker_id')!r})",
            )
        elif not _killed(ctx):
            require(
                False,
                "gang job unclaimed with no crash injected: the "
                "leader gate or member-count gate rejected a full gang",
            )

    return Scenario(
        name="gang_assembly",
        rule="PSM305",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="gang leader crashes; a new leader re-assembles",
        setup=setup,
        tasks=(("wa", wa, True), ("watcher", watcher, False)),
        invariant=invariant,
        max_kills=1,
        fix_hint="a gang claim must publish the full member set "
        "atomically with the claim; a torn claim must be reapable",
    )


def _gang_insufficient() -> Scenario:
    def setup(ctx: MCContext) -> None:
        _queue().add_job(_job("j1", nprocs=3))

    def worker(name: str):
        def body(ctx: MCContext) -> None:
            ctx.out[name] = _queue().claim_next(
                name, group="g", group_members=["wa", "wb"]
            )

        return body

    def invariant(ctx: MCContext) -> None:
        require(
            ctx.out.get("wa") is None and ctx.out.get("wb") is None,
            "an under-strength gang (2 members, nprocs=3) claimed a "
            "gang job — it would deadlock waiting for a third rank",
        )
        require(
            not ctx.listdir(f"{_Q}/claims"),
            "claim artifacts leaked from a rejected gang assembly",
        )

    return Scenario(
        name="gang_insufficient",
        rule="PSM305",
        module="peasoup_tpu_torch/campaign/queue.py",
        description="two workers offer a 2-member gang for nprocs=3",
        setup=setup,
        tasks=(
            ("wa", worker("wa"), False),
            ("wb", worker("wb"), False),
        ),
        invariant=invariant,
        max_kills=0,
        fix_hint="claim_next must refuse a gang job unless the caller "
        "is the sorted-first live member of a full-strength group",
    )


# ---------------------------------------------------------------------------
# registry: membership under skewed reapers and torn joins
# ---------------------------------------------------------------------------


def _registry():
    from ...campaign.registry import WorkerRegistry

    return WorkerRegistry


def _registry_group_survival() -> Scenario:
    def setup(ctx: MCContext) -> None:
        _registry()(ROOT, group="g").register("wa")

    def wa(ctx: MCContext) -> None:
        reg = _registry()(ROOT, group="g")
        reg.beat("wa")
        reg.beat("wa")

    def reaper(ctx: MCContext) -> None:
        _registry()(ROOT).reap()

    def invariant(ctx: MCContext) -> None:
        doc = ctx.read_json(f"{_Q}/workers/wa.json")
        if doc is not None:
            require(
                doc.get("group") == "g",
                "a beat-recreated registry entry lost its gang group "
                f"(group={doc.get('group')!r}): the gang pool silently "
                "shrank",
            )

    return Scenario(
        name="registry_group_survival",
        rule="PSM306",
        module="peasoup_tpu_torch/campaign/registry.py",
        description="heartbeats race a clock-skewed membership reaper",
        setup=setup,
        tasks=(("wa", wa, False), ("reaper", reaper, False)),
        invariant=invariant,
        max_kills=0,
        skews={"reaper": 90.0},
        fix_hint="beat's re-registration path must carry the worker's "
        "process group, not default it away",
    )


def _registry_torn_entry() -> Scenario:
    def setup(ctx: MCContext) -> None:
        del ctx

    def wj(ctx: MCContext) -> None:
        _registry()(ROOT, group="g").register("wj")

    def sweeper(ctx: MCContext) -> None:
        ctx.advance(70)
        ctx.out["reaped"] = _registry()(ROOT).reap()

    def invariant(ctx: MCContext) -> None:
        wdir = f"{_Q}/workers"
        for name in ctx.listdir(wdir):
            if not name.endswith(".json"):
                continue
            path = f"{wdir}/{name}"
            try:
                json.loads(ctx.read(path) or "")
                continue
            except json.JSONDecodeError:
                pass
            age = ctx.now() - ctx.env.fs.stat(path).st_ctime
            require(
                age <= 60.0,
                f"torn registry entry {name} leaked past its grace "
                f"lease ({age:g}s old): it has no expiry, so nothing "
                "would ever reap it",
            )

    return Scenario(
        name="registry_torn_entry",
        rule="PSM306",
        module="peasoup_tpu_torch/campaign/registry.py",
        description="joiner SIGKILLed mid-register; sweeper cleans up",
        setup=setup,
        tasks=(("wj", wj, True), ("sweeper", sweeper, False)),
        invariant=invariant,
        max_kills=1,
        fix_hint="reap must age-gate unparsable entries on st_ctime "
        "and unlink them after a full lease",
    )


# ---------------------------------------------------------------------------
# tenants: admission control under concurrency
# ---------------------------------------------------------------------------


def _tenant_throttle() -> Scenario:
    def setup(ctx: MCContext) -> None:
        from ...campaign.tenants import Tenant, TenantRegistry

        TenantRegistry(ROOT).create(
            Tenant(name="ten", token="tok-ten", max_running=1)
        )
        q = _queue()
        for jid in ("j1", "j2", "j3"):
            q.add_job(_job(jid, tenant="ten"))

    def worker(name: str, jid: str):
        def body(ctx: MCContext) -> None:
            ctx.out[name] = _queue().try_claim(jid, name) is not None

        return body

    def invariant(ctx: MCContext) -> None:
        claims = []
        for name in ctx.listdir(f"{_Q}/claims"):
            doc = ctx.read_json(f"{_Q}/claims/{name}")
            if doc is not None:
                claims.append(doc)
        require(
            1 <= len(claims) <= 2,
            f"tenant max_running=1 admitted {len(claims)} concurrent "
            "claims (the documented race window over-admits by at most "
            "one)",
        )
        # with >=1 published claim the tenant is at/over quota: the
        # next admission must throttle (fresh revalidation, no cache)
        require(
            _queue().try_claim("j3", "w3") is None,
            "a tenant at max_running quota was admitted another job "
            "(throttle revalidation failed to see published claims)",
        )

    return Scenario(
        name="tenant_throttle",
        rule="PSM307",
        module="peasoup_tpu_torch/campaign/tenants.py",
        description="two claims race one tenant's max_running=1 quota",
        setup=setup,
        tasks=(
            ("w1", worker("w1", "j1"), False),
            ("w2", worker("w2", "j2"), False),
        ),
        invariant=invariant,
        max_kills=0,
        fix_hint="try_claim must revalidate tenant quotas after the "
        "O_EXCL create (fresh scan, not the cached throttle map) and "
        "abort the claim when the tenant is over quota",
    )


# ---------------------------------------------------------------------------
# alerts: evaluator lock + journal atomicity
# ---------------------------------------------------------------------------


def _engine(rules: list[dict] | None = None):
    from ...obs.alerts import AlertEngine

    return AlertEngine(ROOT, rules=rules if rules is not None else [])


_LOCK = f"{_Q}/alerts.lock"
_JOURNAL = f"{_Q}/alerts.jsonl"
_SNAPSHOT = f"{_Q}/alerts.json"


def _lock_depth_ok(ctx: MCContext) -> None:
    """Trace-ordered critical-section depth from alock-enter/exit
    marks must never exceed one (a killed holder leaves its section
    open — depth 1 — which is fine; overlap is not)."""
    depth = 0
    for e in ctx.env.trace:
        _, _, rest = e.partition(":")
        if rest.startswith("mark:alock-enter@"):
            depth += 1
            require(
                depth <= 1,
                "two evaluators inside the alerts critical section at "
                "once: the advisory lock failed while fresh",
            )
        elif rest.startswith("mark:alock-exit@"):
            depth -= 1


def _alerts_lock() -> Scenario:
    def setup(ctx: MCContext) -> None:
        del ctx

    def evaluator(ctx: MCContext) -> None:
        eng = _engine()
        if eng._acquire_lock(ctx.now()):
            ctx.mark("alock-enter")
            ctx.mark("alock-exit")
            eng._release_lock()

    def invariant(ctx: MCContext) -> None:
        _lock_depth_ok(ctx)
        if not _killed(ctx):
            require(
                not ctx.exists(_LOCK),
                "alerts lock leaked after both evaluators exited "
                "cleanly",
            )

    return Scenario(
        name="alerts_lock",
        rule="PSM308",
        module="peasoup_tpu_torch/obs/alerts.py",
        description="two evaluators contend for a fresh alerts lock",
        setup=setup,
        tasks=(
            ("e1", evaluator, True),
            ("e2", evaluator, False),
        ),
        invariant=invariant,
        max_kills=1,
        fix_hint="a torn (empty) lock within the staleness window is a "
        "LIVE acquirer mid-publish: back off instead of taking over",
    )


def _alerts_release_race() -> Scenario:
    def setup(ctx: MCContext) -> None:
        del ctx

    def e1(ctx: MCContext) -> None:
        eng = _engine()
        got = eng._acquire_lock(ctx.now())
        ctx.out["got1"] = got
        if got:
            eng._release_lock()

    def e2(ctx: MCContext) -> None:
        ctx.advance(70)  # e1's lock (if held) is now legitimately stale
        eng = _engine()
        got = eng._acquire_lock(ctx.now())
        ctx.out["got2"] = got
        ctx.out["tok2"] = eng._lock_token  # holds; never releases

    def invariant(ctx: MCContext) -> None:
        if ctx.out.get("got2"):
            doc = ctx.read_json(_LOCK)
            require(
                doc is not None
                and doc.get("token") == ctx.out.get("tok2"),
                "the deposed evaluator's release clobbered the new "
                f"holder's lock (doc={doc}): mutual exclusion silently "
                "lapses for the next round",
            )

    return Scenario(
        name="alerts_release_race",
        rule="PSM308",
        module="peasoup_tpu_torch/obs/alerts.py",
        description="stale-lock takeover races the old holder's release",
        setup=setup,
        tasks=(("e1", e1, False), ("e2", e2, False)),
        invariant=invariant,
        max_kills=0,
        fix_hint="release must rename the lock aside, verify the "
        "tombstone carries its own token, and link-restore a mismatch "
        "— never blind-unlink",
    )


def _alerts_journal() -> Scenario:
    rule = {
        "name": "sentinel_unrecovered",
        "kind": "sentinel",
        "severity": "page",
    }
    finding = {
        "labels": {"probe": "p1"},
        "value": 1.0,
        "message": "sentinel p1 unrecovered",
    }

    def setup(ctx: MCContext) -> None:
        del ctx

    def evaluator(ctx: MCContext) -> None:
        _engine([dict(rule)]).evaluate(
            samples={}, sentinel_findings=[dict(finding)]
        )

    def invariant(ctx: MCContext) -> None:
        raw = ctx.read(_JOURNAL) or ""
        firing = 0
        for line in raw.splitlines():
            try:
                t = json.loads(line)
            except json.JSONDecodeError:
                require(
                    False,
                    f"torn alerts journal line: {line[:80]!r} (append "
                    "must be all-or-nothing)",
                )
                return
            if t.get("to") == "firing":
                firing += 1
        require(
            firing <= 2,
            f"{firing} firing transitions for one alert episode",
        )
        if not _killed(ctx):
            require(
                firing == 1,
                f"{firing} firing transitions with both evaluators "
                "healthy (must be exactly one per episode)",
            )
            snap = ctx.read_json(_SNAPSHOT) or {}
            states = {
                (a.get("rule"), a.get("state"))
                for a in snap.get("alerts", [])
            }
            require(
                ("sentinel_unrecovered", "firing") in states,
                f"snapshot lost the firing alert: {sorted(states)}",
            )
            require(
                not ctx.exists(_LOCK),
                "alerts lock leaked after two clean evaluation rounds",
            )

    return Scenario(
        name="alerts_journal",
        rule="PSM308",
        module="peasoup_tpu_torch/obs/alerts.py",
        description="two full evaluation rounds, one killable, race",
        setup=setup,
        tasks=(
            ("e1", evaluator, True),
            ("e2", evaluator, False),
        ),
        invariant=invariant,
        max_kills=1,
        fix_hint="transitions must append before the snapshot write, "
        "in one atomic append; the lock must serialize whole rounds",
    )


# ---------------------------------------------------------------------------
# the library + the engine entry point
# ---------------------------------------------------------------------------

_SCENARIO_FACTORIES = (
    _claim_race,
    _claim_crash_reap,
    _renew_vs_reap,
    _release_vs_reap,
    _zombie_complete,
    _complete_vs_claim,
    _preempt_handoff,
    _gang_assembly,
    _gang_insufficient,
    _registry_group_survival,
    _registry_torn_entry,
    _tenant_throttle,
    _alerts_lock,
    _alerts_release_race,
    _alerts_journal,
)


def scenarios() -> tuple[Scenario, ...]:
    """The full drill library, in documentation order."""
    return tuple(b() for b in _SCENARIO_FACTORIES)


def scenario_names() -> list[str]:
    return [s.name for s in scenarios()]


@dataclass
class MCReport:
    """One model-checking pass over (a subset of) the library."""

    scenarios: int = 0
    schedules: int = 0
    crash_points: int = 0
    reductions: int = 0
    dedup_hits: int = 0
    violations: int = 0
    per_scenario: list[dict] = field(default_factory=list)
    findings: list[Finding] = field(default_factory=list)

    def to_doc(self) -> dict:
        return {
            "scenarios": self.scenarios,
            "schedules": self.schedules,
            "crash_points": self.crash_points,
            "reductions": self.reductions,
            "dedup_hits": self.dedup_hits,
            "violations": self.violations,
            "per_scenario": self.per_scenario,
        }


def run_mc(
    names: list[str] | None = None,
    budget: int | None = None,
    por: bool = True,
) -> MCReport:
    """Model-check the scenario library (audit engine 5). ``names``
    selects a subset; ``budget`` caps schedules per scenario. Each
    violation is minimized to its shortest reproducing schedule and
    reported as a PSM3xx finding (PSM300 for internal task crashes /
    deadlocks — the checker eating its own exceptions is a finding
    too, never a silent pass)."""
    lib = scenarios()
    if names:
        known = {s.name: s for s in lib}
        unknown = [n for n in names if n not in known]
        if unknown:
            raise ValueError(
                f"unknown mc scenario(s) {unknown}; "
                f"known: {sorted(known)}"
            )
        lib = tuple(known[n] for n in names)
    report = MCReport()
    for s in lib:
        res = explore(s, budget=budget or DEFAULT_BUDGET, por=por)
        cps = enumerate_crash_points(s)
        report.scenarios += 1
        report.schedules += res.schedules
        report.crash_points += cps
        report.reductions += res.reductions
        report.dedup_hits += res.dedup_hits
        report.violations += len(res.violations)
        report.per_scenario.append({
            "name": s.name,
            "rule": s.rule,
            "schedules": res.schedules,
            "crash_points": cps,
            "reductions": res.reductions,
            "dedup_hits": res.dedup_hits,
            "exhausted": res.exhausted,
            "violations": len(res.violations),
        })
        for msg, chosen in res.violations:
            mini = minimize(s, chosen, msg)
            internal = msg.startswith("internal:")
            report.findings.append(
                Finding(
                    rule="PSM300" if internal else s.rule,
                    severity=SEV_ERROR,
                    path=s.module,
                    line=1,
                    col=0,
                    message=f"mc:{s.name}: {msg}",
                    fix_hint=s.fix_hint,
                    source_line=(
                        f"{s.name} schedule={schedule_to_str(mini)}"
                    ),
                )
            )
    return report
