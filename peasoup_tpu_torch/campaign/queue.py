"""File-backed job queue for multi-worker survey campaigns (the port's
copy of the JAX package's campaign/queue.py: the same queue tree, record
formats and protocol, so either package's workers can serve one campaign
directory; the one deliberate difference is :meth:`JobQueue.complete`,
which publishes the done record before it drops the claim).

No daemon, no database: the queue IS the filesystem, so any number of
workers on any number of hosts coordinate through a shared campaign
directory (the standard deployment for survey pipelines on cluster
filesystems). Every state transition is an atomic filesystem operation:

- **enqueue** — ``O_CREAT|O_EXCL`` of ``queue/jobs/<id>.json``; two
  workers enqueueing the same manifest collide harmlessly (first wins).
- **claim** — ``O_CREAT|O_EXCL`` of ``queue/claims/<id>.json`` carrying
  the worker identity and a lease expiry. Exactly one claimant can win.
- **renew** — the owner republishes its claim with a fresh expiry via
  the ownership dance (take-verify-recreate, below); a *deposed*
  owner (reaped, job re-claimed) learns it lost the lease instead of
  stomping the new owner's claim.
- **reap** — anyone may reap an EXPIRED claim (a SIGKILLed worker never
  releases). The reaper wins an ``os.rename`` race to a private
  tombstone; the loser gets ``FileNotFoundError`` and walks away. A
  reaped job counts as one failed attempt and re-queues with backoff.
- **complete / fail** — the claim holder writes ``queue/done/<id>.json``
  (while its claim still stands, so the job is never without one of the
  two markers) or updates the job record (attempts, exponential-backoff
  ``next_eligible_unix``), then releases the claim. After
  ``max_attempts`` failures the job lands in
  ``queue/quarantine/<id>.json`` and is never claimed again until an
  operator re-queues it (``campaign retry``).

Job records are only ever mutated by the current claim holder (or the
reap winner), so a tmp + ``os.replace`` rewrite needs no further
locking. States are derived, not stored: a job is *pending* when it has
no claim/done/quarantine marker and its backoff has elapsed.

**The ownership dance.** Every holder-side transition (renew,
complete, fail, release, preempted release, carried-resilience
rewrite) must first prove it still holds the lease — a worker that
was reaped while wedged is a *zombie*, and a zombie acting on its
stale :class:`Claim` used to delete the new owner's claim, overwrite
its renewed lease, double-charge attempts or double-publish done
records (all found by the protocol model checker,
``analysis/mc/``). :meth:`JobQueue._take_claim` serializes this
against the reaper with the same primitive the reaper uses: rename
the claim to a private tombstone, re-read, and verify the document
still names us; on mismatch the rename is undone and the caller
learns the lease is lost. Done records publish via tmp +
``os.link`` — all-or-nothing, and a duplicate publication surfaces
as ``FileExistsError`` instead of a silent overwrite.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import tempfile
import time
import uuid
from dataclasses import dataclass, field

from ..obs import get_logger
from ..resilience import IO_RETRY, faults, is_transient

log = get_logger("campaign.queue")

# terminal + live marker subdirectories under <root>/queue/
_JOBS = "jobs"
_CLAIMS = "claims"
_DONE = "done"
_QUARANTINE = "quarantine"
# per-worker append-only spools for LOST attempts' resilience marks
_RESILIENCE = "resilience"


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


def _discard(path: str) -> None:
    """Consume a dance artifact (tombstone/tmp) that may already be
    gone: the orphan sweep ages tombstones out by st_ctime, so a
    holder stalled long enough mid-dance finds its tombstone swept by
    a peer — the unlink's outcome is the same either way."""
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def job_id_for(input_path: str) -> str:
    """Stable job id for an observation: file stem + a short hash of
    the absolute path, so two workers enqueueing the same manifest
    derive the same id (enqueue is idempotent) and two files with the
    same stem in different directories stay distinct."""
    ap = os.path.abspath(input_path)
    stem = os.path.splitext(os.path.basename(ap))[0]
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in stem)
    return f"{safe[:48]}-{hashlib.sha1(ap.encode()).hexdigest()[:8]}"


@dataclass
class Job:
    """One observation to process. ``config`` holds per-job pipeline
    overrides (merged over the campaign's); ``bucket`` is the padded
    shape key the scheduler groups on (None when the header could not
    be read at enqueue time — the job will fail at run time and walk
    the normal retry/quarantine path)."""

    job_id: str
    input: str
    pipeline: str = "spsearch"
    config: dict = field(default_factory=dict)
    bucket: tuple | None = None
    priority: int = 0  # higher claims sooner; outranks bucket affinity
    nprocs: int = 1  # >1: gang-scheduled across a named process group
    # multi-tenant stamp (campaign/tenants.py): which tenant submitted
    # this observation; empty = operator-owned (quota-exempt). Rides
    # into done records, metrics labels and the usage ledger
    tenant: str = ""
    # trace correlation (obs/trace.py): minted at enqueue, propagated
    # through claim docs / preempt requests / gang invitations, so a
    # preempted-and-resumed or gang-scheduled job renders as ONE
    # connected trace across every worker process that touched it
    trace_id: str = ""
    attempts: int = 0
    next_eligible_unix: float = 0.0
    last_error: str | None = None
    created_unix: float = 0.0
    # preemption provenance: how many times a revoke handed this job
    # back (zero attempts consumed) and each revoke's request->release
    # latency — carried into the resumed run's done record
    preemptions: int = 0
    preempt_latency_s: list = field(default_factory=list)
    # resilience counters a RELEASED attempt survived (retries,
    # degradations, injected faults): a revoke consumes zero attempts
    # and writes no done record, so without this carry the marks would
    # vanish and the campaign rollup could no longer attribute every
    # injected fault to its recovery path — the chaos soak's invariant
    carried_resilience: dict = field(default_factory=dict)
    # synthetic injection sentinel (obs/health.py): excluded from the
    # campaign's data-quality baselines and flagged in the rollup
    sentinel: bool = False

    def to_doc(self) -> dict:
        return {
            "job_id": self.job_id,
            "input": self.input,
            "pipeline": self.pipeline,
            "config": self.config,
            "bucket": list(self.bucket) if self.bucket else None,
            "priority": self.priority,
            "nprocs": self.nprocs,
            "tenant": self.tenant,
            "trace_id": self.trace_id,
            "attempts": self.attempts,
            "next_eligible_unix": self.next_eligible_unix,
            "last_error": self.last_error,
            "created_unix": self.created_unix,
            "preemptions": self.preemptions,
            "preempt_latency_s": self.preempt_latency_s,
            "carried_resilience": self.carried_resilience,
            "sentinel": self.sentinel,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "Job":
        b = doc.get("bucket")
        return cls(
            job_id=doc["job_id"],
            input=doc.get("input", ""),
            pipeline=doc.get("pipeline", "spsearch"),
            config=doc.get("config") or {},
            bucket=tuple(b) if b else None,
            priority=int(doc.get("priority", 0)),
            nprocs=int(doc.get("nprocs", 1)),
            tenant=str(doc.get("tenant") or ""),
            trace_id=str(doc.get("trace_id") or ""),
            attempts=int(doc.get("attempts", 0)),
            next_eligible_unix=float(doc.get("next_eligible_unix", 0.0)),
            last_error=doc.get("last_error"),
            created_unix=float(doc.get("created_unix", 0.0)),
            preemptions=int(doc.get("preemptions", 0)),
            preempt_latency_s=[
                float(x) for x in (doc.get("preempt_latency_s") or [])
            ],
            carried_resilience=doc.get("carried_resilience") or {},
            sentinel=bool(doc.get("sentinel", False)),
        )


@dataclass
class Claim:
    """A held lease on one job. Only its holder may complete/fail the
    job or rewrite the job record. ``gang`` (gang-scheduled jobs only)
    names the process group and the exact member set the leader
    assembled — {"group", "members", "nprocs", "epoch"}."""

    job: Job
    worker_id: str
    expires_unix: float
    path: str
    gang: dict | None = None


class JobQueue:
    """The file-backed queue rooted at ``<root>/queue/``."""

    def __init__(
        self,
        root: str,
        lease_s: float = 60.0,
        max_attempts: int = 3,
        backoff_base_s: float = 2.0,
    ) -> None:
        self.root = os.path.abspath(root)
        self.qdir = os.path.join(self.root, "queue")
        self.lease_s = float(lease_s)
        self.max_attempts = int(max_attempts)
        self.backoff_base_s = float(backoff_base_s)
        for sub in (_JOBS, _CLAIMS, _DONE, _QUARANTINE, _RESILIENCE):
            os.makedirs(os.path.join(self.qdir, sub), exist_ok=True)
        # tenant throttle-map cache: (valid_until_unix, map). The map
        # is an O(jobs + claims + done) artifact scan; state() asks per
        # job, so without the short TTL counts()/claim_next would go
        # quadratic. Claim-time revalidation bypasses it (fresh=True)
        self._throttle_cache: tuple[float, dict] = (0.0, {})

    # --- paths --------------------------------------------------------
    def _p(self, sub: str, job_id: str) -> str:
        return os.path.join(self.qdir, sub, f"{job_id}.json")

    # --- enqueue ------------------------------------------------------
    def add_job(self, job: Job) -> bool:
        """Idempotent enqueue: True when this call created the record,
        False when the job already exists (any state)."""
        job.created_unix = job.created_unix or time.time()
        if not job.trace_id:
            # the trace id is born here: enqueue is the first event of
            # the job's life, and everything downstream inherits it
            from ..obs.trace import new_trace_id

            job.trace_id = new_trace_id()
        path = self._p(_JOBS, job.job_id)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump(job.to_doc(), f, indent=2)
            f.write("\n")
        log.debug("enqueued %s (%s)", job.job_id, job.input)
        return True

    # --- inspection ---------------------------------------------------
    def job_ids(self) -> list[str]:
        return sorted(
            os.path.splitext(n)[0]
            for n in os.listdir(os.path.join(self.qdir, _JOBS))
            if n.endswith(".json")
        )

    def get_job(self, job_id: str) -> Job | None:
        doc = _read_json(self._p(_JOBS, job_id))
        return Job.from_doc(doc) if doc else None

    def tenant_throttles(
        self, now: float | None = None, fresh: bool = False
    ) -> dict[str, dict]:
        """Currently over-quota tenants (tenants.throttle_map), cached
        for ~0.5s so per-job state() queries stay linear. ``fresh``
        bypasses and refills the cache — the claim-time revalidation
        path, where a stale admission would over-run a quota."""
        now = time.time() if now is None else now
        until, cached = self._throttle_cache
        if not fresh and now < until:
            return cached
        # lazy import: tenants.py is pure stdlib, but keeping the
        # dependency one-way (tenants never imports queue) needs the
        # import at call time, mirroring add_job's obs.trace import
        from .tenants import throttle_map

        m = throttle_map(self.root, now=now)
        self._throttle_cache = (now + 0.5, m)
        return m

    def state(self, job_id: str, now: float | None = None) -> str:
        """Derived state: done | quarantined | running | stale |
        throttled | backoff | pending | unknown."""
        now = time.time() if now is None else now
        if os.path.exists(self._p(_DONE, job_id)):
            return "done"
        if os.path.exists(self._p(_QUARANTINE, job_id)):
            return "quarantined"
        claim = _read_json(self._p(_CLAIMS, job_id))
        if claim is not None:
            return (
                "running"
                if float(claim.get("expires_unix", 0)) >= now
                else "stale"
            )
        job = self.get_job(job_id)
        if job is None:
            return "unknown"
        if job.tenant and job.tenant in self.tenant_throttles(now):
            # over-quota tenants' jobs PARK (visible in counts, the
            # rollup and watch) rather than claim — and rather than
            # being dropped; the state clears when the quota releases
            return "throttled"
        return "backoff" if job.next_eligible_unix > now else "pending"

    def counts(self) -> dict[str, int]:
        out = {
            "total": 0, "pending": 0, "backoff": 0, "running": 0,
            "stale": 0, "done": 0, "quarantined": 0, "throttled": 0,
        }
        now = time.time()
        for jid in self.job_ids():
            out["total"] += 1
            st = self.state(jid, now)
            if st in out:
                out[st] += 1
        return out

    def drained(self) -> bool:
        """True when every job is terminal (done or quarantined)."""
        c = self.counts()
        return c["total"] > 0 and c["done"] + c["quarantined"] == c["total"]

    # --- claim / renew / release -------------------------------------
    @staticmethod
    def default_worker_id() -> str:
        return f"{socket.gethostname()}-{os.getpid()}"

    def try_claim(
        self,
        job_id: str,
        worker_id: str,
        now: float | None = None,
        gang: dict | None = None,
    ) -> Claim | None:
        now = time.time() if now is None else now
        if os.path.exists(self._p(_DONE, job_id)) or os.path.exists(
            self._p(_QUARANTINE, job_id)
        ):
            return None
        job = self.get_job(job_id)
        if job is None or job.next_eligible_unix > now:
            return None
        if job.tenant and job.tenant in self.tenant_throttles(now):
            return None  # tenant over quota: the job parks as throttled
        path = self._p(_CLAIMS, job_id)

        def _create_claim():
            faults.fire("queue.claim", context=job_id)
            return os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)

        try:
            # transient I/O (flaky mount, injected queue.claim fault)
            # retries under the shared policy; losing the O_EXCL race
            # (FileExistsError) is a protocol outcome, not an error
            fd = IO_RETRY.call(
                _create_claim, site="queue.claim", context=job_id
            )
        except FileExistsError:
            return None
        except OSError as exc:
            if is_transient(exc):
                # retry budget spent: walk away; the job stays pending
                # and any worker (including us, next poll) claims it
                log.warning(
                    "claim of %s abandoned after transient I/O "
                    "failures: %.200s", job_id, exc,
                )
                return None
            raise
        if os.path.exists(self._p(_DONE, job_id)) or os.path.exists(
            self._p(_QUARANTINE, job_id)
        ):
            # lost the completion race: between our eligibility check
            # and the O_EXCL create, the previous owner finished and
            # released — without this re-check a second worker would
            # re-run a terminal job (exactly-once violation seen as a
            # duplicate under load in the two-worker race test)
            os.close(fd)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            return None
        if job.tenant and job.tenant in self.tenant_throttles(
            now, fresh=True
        ):
            # claim-time quota REVALIDATION: between the cached
            # pre-check and winning the O_EXCL race another worker may
            # have filled the tenant's last max_running slot. Our own
            # claim file exists but its document is still unwritten, so
            # the fresh scan (which skips unparsable claims) naturally
            # excludes us — only OTHER holders count against the quota
            os.close(fd)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            return None
        expires = now + self.lease_s
        doc = {
            "job_id": job_id,
            "worker_id": worker_id,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "claimed_unix": now,
            "expires_unix": expires,
            # trace propagation: the claim is the hand-off artifact a
            # gang member (or a watcher) reads, so the trace id rides it
            "trace_id": job.trace_id,
        }
        if gang:
            doc["gang"] = gang
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        return Claim(
            job=job, worker_id=worker_id, expires_unix=expires, path=path,
            gang=gang,
        )

    def claim_next(
        self,
        worker_id: str,
        prefer_bucket: tuple | None = None,
        warm_buckets: "set[tuple] | frozenset[tuple] | None" = None,
        group: str | None = None,
        group_members: "list[str] | None" = None,
    ) -> Claim | None:
        """Claim the next eligible job, ranked priority class first
        (higher ``Job.priority`` always claims sooner — an urgent
        re-observation must not wait behind a warm-bucket streak),
        then jobs sharing ``prefer_bucket`` (the worker's previous
        shape bucket), then jobs whose bucket is in ``warm_buckets``
        (buckets already warmed/tuned — this worker's own plus any
        recorded in the campaign's done records, see runner.py), then
        the remainder — each tier grouped BY bucket, then by ARRIVAL
        (``created_unix``): a released job (preempted, or handed back
        by a retiring worker) keeps its original queue position
        instead of sorting as fresh — so a fleet of workers naturally
        partitions into shape-coherent streaks, consecutive jobs hit
        the compiled-program caches, and already-paid warmup/tuning
        work is exploited before any new bucket is opened.

        Gang jobs (``Job.nprocs > 1``): claimable only by the LEADER
        of a process group (the lexicographically-first entry of
        ``group_members``, the caller's live group membership) and
        only when the group musters ``nprocs`` live members — the
        claim then carries the assembled member set (all-or-nothing:
        non-leaders never initiate, an unassemblable gang job is
        simply skipped so it cannot head-of-line-block ordinary
        work)."""
        self.reap_stale()
        now = time.time()
        warm = {tuple(b) for b in warm_buckets} if warm_buckets else set()
        members = sorted(group_members) if group_members else []
        eligible: list[tuple[tuple, str, dict | None]] = []
        for jid in self.job_ids():
            if self.state(jid, now) != "pending":
                continue
            job = self.get_job(jid)
            if job is None:
                continue
            gang = None
            if job.nprocs > 1:
                if (
                    not group
                    or len(members) < job.nprocs
                    or worker_id != members[0]
                ):
                    continue  # not this worker's gang to lead (or none)
                gang = {
                    "group": group,
                    "members": members[: job.nprocs],
                    "nprocs": int(job.nprocs),
                    "epoch": uuid.uuid4().hex[:12],
                }
            bucket = job.bucket or ()
            if prefer_bucket and bucket == tuple(prefer_bucket):
                tier = 0
            elif bucket and tuple(bucket) in warm:
                tier = 1
            else:
                tier = 2
            rank = (
                -job.priority,
                tier,
                tuple(str(x) for x in bucket),
                job.created_unix,
                jid,
            )
            eligible.append((rank, jid, gang))
        for _, jid, gang in sorted(eligible, key=lambda e: e[0]):
            claim = self.try_claim(jid, worker_id, now, gang=gang)
            if claim is not None:
                return claim
        return None

    def _take_claim(self, claim: Claim) -> str | None:
        """Atomically take our claim file off the namespace iff we
        still hold the lease. Returns the private tombstone path
        (caller must consume or restore it), or None when the lease
        has been lost — the claim was reaped (and possibly re-claimed
        by a new owner, whose claim must not be touched).

        The verify step re-reads the TOMBSTONE, not the original
        path: the rename is the serialization point, so whatever
        document the tombstone holds is exactly what we took. Between
        the rename and the caller's follow-up the claim path is
        briefly absent; a racing claimant may win the job in that
        window (renew's O_EXCL republish then fails and the caller
        reports the lease lost — safety over liveness)."""
        doc = _read_json(claim.path)
        if doc is None or doc.get("worker_id") != claim.worker_id:
            return None
        tomb = f"{claim.path}.release.{uuid.uuid4().hex[:8]}"
        try:
            os.rename(claim.path, tomb)
        except OSError:
            return None  # reaped from under us mid-check
        fresh = _read_json(tomb)
        if fresh is None or fresh.get("worker_id") != claim.worker_id:
            # the document changed between read and rename: a reaper
            # took the lease and a new owner re-claimed — undo
            try:
                os.rename(tomb, claim.path)
            except OSError:
                try:
                    os.unlink(tomb)
                except FileNotFoundError:
                    pass
            return None
        return tomb

    def renew(self, claim: Claim) -> bool:
        """Extend the holder's lease. The rewrite is an ownership
        dance, not a blind replace: take our claim (verified rename
        to a tombstone), then republish with the fresh expiry via
        ``O_CREAT|O_EXCL``. Returns False when the lease has been
        lost — the caller must stop working on the job (a blind
        ``os.replace`` here used to let a reaped-and-replaced zombie
        stomp the new owner's claim)."""
        tomb = self._take_claim(claim)
        if tomb is None:
            return False
        claim.expires_unix = time.time() + self.lease_s
        doc = _read_json(tomb) or {}
        doc.update(
            {
                "job_id": claim.job.job_id,
                "worker_id": claim.worker_id,
                "pid": os.getpid(),
                "hostname": socket.gethostname(),
                "expires_unix": claim.expires_unix,
            }
        )
        try:
            fd = os.open(
                claim.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
            )
        except FileExistsError:
            # a claimant won the job during the absence window: it
            # owns the lease now; our tombstone is all that is ours
            _discard(tomb)
            return False
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        _discard(tomb)
        return True

    # --- terminal transitions ----------------------------------------
    def complete(self, claim: Claim, **info) -> bool:
        """Success: publish the done record exactly once, release the
        claim. Only the LIVE holder may publish — a zombie completer
        (reaped while wedged, job re-claimed) gets False and must not
        account the job as done. The record publishes via tmp +
        ``os.link``: all-or-nothing, never torn, and a duplicate
        publication surfaces as ``FileExistsError`` (swallowed — the
        record is there) instead of silently overwriting the first
        winner's document.

        The done record is published BEFORE the claim is taken off the
        namespace. The JAX package took the claim first
        (``_take_claim``'s rename) and linked the record after, so
        between the two the job had neither marker and a racing
        ``try_claim`` won it again (its two-worker race test's
        duplicate). Here the job always holds a claim or a done record,
        and ``try_claim``'s re-check after its ``O_EXCL`` create sees
        the record. Ownership is proved by reading the claim first; a
        holder reaped in the instant between that read and the link
        publishes a record that the new owner's own completion then
        finds (and swallows), and gets False here."""
        doc = _read_json(claim.path)
        if doc is None or doc.get("worker_id") != claim.worker_id:
            log.warning(
                "complete of %s by %s ignored: lease lost (reaped)",
                claim.job.job_id, claim.worker_id,
            )
            return False
        done = self._p(_DONE, claim.job.job_id)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(done), suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(
                    {
                        "job_id": claim.job.job_id,
                        "input": claim.job.input,
                        "worker_id": claim.worker_id,
                        "finished_unix": time.time(),
                        "attempts": claim.job.attempts + 1,
                        **info,
                    },
                    f,
                    indent=2,
                )
                f.write("\n")
            try:
                os.link(tmp, done)
            except FileExistsError:
                pass  # already published — exactly-once holds
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
        tomb = self._take_claim(claim)
        if tomb is None:
            log.warning(
                "complete of %s by %s: lease lost after publishing",
                claim.job.job_id, claim.worker_id,
            )
            return False
        # a revoke answered by completion is answered
        self.clear_preempt(claim.job.job_id)
        _discard(tomb)
        return True

    def fail(self, claim: Claim, error: str) -> str:
        """Failure by the claim holder: one attempt consumed. Returns
        the resulting state: 'backoff' (will retry), 'quarantined',
        or 'lost' — the lease was reaped from under us, the reaper
        already charged the attempt, and charging a second one here
        (the old behaviour) double-counted the failure."""
        tomb = self._take_claim(claim)
        if tomb is None:
            return "lost"
        state = self._record_failure(claim.job.job_id, error)
        self.clear_preempt(claim.job.job_id)
        _discard(tomb)
        return state

    def release(self, claim: Claim) -> None:
        """Voluntary release by the claim holder — a worker leaving the
        fleet cleanly hands its unstarted job back with ZERO attempts
        consumed (a clean leave is elasticity, not a failure; the job
        is immediately claimable by anyone). Idempotent, and a no-op
        for a lost lease: a deposed holder must not unlink the new
        owner's claim or clear its preempt marker (the old blind
        unlink did both)."""
        tomb = self._take_claim(claim)
        if tomb is None:
            return
        self.clear_preempt(claim.job.job_id)
        _discard(tomb)
        log.info(
            "claim on %s released cleanly by %s (no attempt consumed)",
            claim.job.job_id, claim.worker_id,
        )

    # --- priority preemption -----------------------------------------
    def _preempt_path(self, job_id: str) -> str:
        # ".preempt" (not ".json") so claim-directory scans — which
        # filter on ".json" — never mistake a request for a claim
        return self._p(_CLAIMS, job_id) + ".preempt"

    def request_preempt(
        self,
        job_id: str,
        requester: str = "",
        grace_s: float = 60.0,
    ) -> bool:
        """Ask the holder of ``job_id``'s claim to checkpoint and hand
        the job back: a preempt-request file lands beside the claim,
        the victim's lease-renewer beat observes it
        (campaign/runner.py), and the driver stops at the next
        DM-block boundary with its checkpoint freshly saved. A victim
        unresponsive past ``grace_s`` is escalated to the reap path
        by :meth:`reap_stale`. Returns False when the job holds no
        live claim (nothing to revoke)."""
        claim_doc = _read_json(self._p(_CLAIMS, job_id))
        if claim_doc is None:
            return False
        now = time.time()
        _atomic_write_json(
            self._preempt_path(job_id),
            {
                "job_id": job_id,
                "requester": requester,
                "victim_worker": claim_doc.get("worker_id"),
                "requested_unix": now,
                "deadline_unix": now + float(grace_s),
                # trace propagation: the revoke is part of the job's
                # one connected trace (the revoke-latency span)
                "trace_id": claim_doc.get("trace_id"),
            },
        )
        from ..resilience import STATS

        STATS.preemption("requested")
        log.info(
            "preempt requested on %s (held by %s%s; grace %.3gs)",
            job_id, claim_doc.get("worker_id"),
            f" for {requester}" if requester else "", grace_s,
        )
        return True

    def preempt_request(self, job_id: str) -> dict | None:
        """The pending preempt request on ``job_id``, if any."""
        return _read_json(self._preempt_path(job_id))

    def clear_preempt(self, job_id: str) -> None:
        try:
            os.unlink(self._preempt_path(job_id))
        except FileNotFoundError:
            pass

    def release_preempted(
        self, claim: Claim, observed_unix: float | None = None
    ) -> float:
        """The revoke's happy path: the victim checkpointed and hands
        the claim back with ZERO attempts consumed (preemption is
        scheduling, not failure). The job record gains a preemption
        tally + the request->release latency (flows into the resumed
        run's done record and the rollup) and keeps its
        ``created_unix`` so :meth:`claim_next` re-claims it at its
        ORIGINAL queue position. Returns the recorded latency, or 0.0
        when the lease was already lost (the grace-deadline reaper
        beat us to the hand-back and owns the accounting)."""
        now = time.time()
        tomb = self._take_claim(claim)
        if tomb is None:
            return 0.0
        req = self.preempt_request(claim.job.job_id) or {}
        requested = float(
            req.get("requested_unix") or observed_unix or now
        )
        latency = max(0.0, now - requested)
        job = self.get_job(claim.job.job_id)
        if job is not None:
            job.preemptions += 1
            job.preempt_latency_s.append(round(latency, 4))
            _atomic_write_json(self._p(_JOBS, job.job_id), job.to_doc())
            claim.job = job  # the caller sees the updated tallies
        self.clear_preempt(claim.job.job_id)
        _discard(tomb)
        from ..resilience import STATS

        STATS.preemption("released")
        log.info(
            "claim on %s preempted away from %s after %.3fs "
            "(checkpointed; zero attempts consumed)",
            claim.job.job_id, claim.worker_id, latency,
        )
        return latency

    def record_carried_resilience(
        self, claim: Claim, delta: dict
    ) -> bool:
        """Fold a to-be-released attempt's resilience counter deltas
        (resilience/stats.py ``delta_since`` shape: table -> key ->
        count) into the job record, so the resumed run's done record
        still accounts for every fault this attempt survived. Call
        BEFORE :meth:`release` / :meth:`release_preempted`. The claim
        is taken for the duration of the rewrite (and restored after)
        so the fold cannot race the reaper's own job-record write —
        the lost-update that used to drop carried counters when a
        grace-deadline reap overlapped the hand-back. Returns True
        when the fold landed on the record, False when the lease was
        lost (the reaper charged the attempt and owns the record)."""
        if not delta:
            return True
        tomb = self._take_claim(claim)
        if tomb is None:
            log.warning(
                "carried-resilience fold for %s dropped: lease lost "
                "(the reaper owns the job record now)",
                claim.job.job_id,
            )
            return False
        try:
            job = self.get_job(claim.job.job_id)
            if job is not None:
                for table, kv in delta.items():
                    if not isinstance(kv, dict):
                        continue
                    tgt = job.carried_resilience.setdefault(table, {})
                    for k, v in kv.items():
                        tgt[k] = tgt.get(k, 0) + int(v)
                _atomic_write_json(
                    self._p(_JOBS, job.job_id), job.to_doc()
                )
                claim.job = job  # the caller sees the carried tallies
        finally:
            # restore our claim: the dance only serialized the rewrite.
            # link (not rename) so a claimant that won the job during
            # the absence window is never overwritten — they keep the
            # lease and our next holder-side call reports it lost.
            # OSError also covers the tombstone itself aging out under
            # a peer's orphan sweep: the lease is simply lost
            try:
                os.link(tomb, claim.path)
            except OSError:
                pass
            _discard(tomb)
        return True

    def record_orphaned_resilience(
        self, worker_id: str, job_id: str, delta: dict
    ) -> None:
        """Spool a LOST attempt's survived-fault counters. A lease
        reaped from under a live run publishes no done record, and the
        deposed holder may not touch the job record either (the reaper
        or a new claimant owns it) — so without this spool every
        retry/recovery that attempt performed would vanish from the
        campaign rollup. Each worker appends to its OWN
        ``queue/resilience/<worker_id>.jsonl`` (single writer, append
        mode — no shared-state race to lose), and the rollup folds the
        spooled deltas in beside the done-record ones."""
        if not delta:
            return
        path = os.path.join(
            self.qdir, _RESILIENCE, f"{worker_id}.jsonl"
        )
        rec = {
            "job_id": job_id,
            "worker_id": worker_id,
            "recorded_unix": time.time(),
            "resilience": delta,
        }
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def orphaned_resilience(self) -> list[dict]:
        """Every spooled lost-attempt record (see
        :meth:`record_orphaned_resilience`), campaign-wide. A torn
        tail line — a worker killed mid-append — is skipped, not
        fatal."""
        rdir = os.path.join(self.qdir, _RESILIENCE)
        out: list[dict] = []
        try:
            names = sorted(os.listdir(rdir))
        except FileNotFoundError:
            return out
        for name in names:
            if not name.endswith(".jsonl"):
                continue
            try:
                with open(os.path.join(rdir, name)) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
        return out

    def preemption_wanted(
        self, claim: Claim, now: float | None = None
    ) -> dict | None:
        """Does a PENDING job outrank this claim's priority class? The
        decentralised preemption trigger: a busy worker's
        lease-renewer asks this each beat, and — when it also holds
        the lowest-priority running claim
        (:meth:`is_lowest_priority_running`) — revokes itself so the
        urgent job gets a worker without any coordinator. Gang jobs
        are excluded (they wait for their group, not for a victim)."""
        now = time.time() if now is None else now
        best: dict | None = None
        for jid in self.job_ids():
            if self.state(jid, now) != "pending":
                continue
            job = self.get_job(jid)
            if job is None or job.nprocs > 1:
                continue
            if job.priority > claim.job.priority and (
                best is None or job.priority > best["priority"]
            ):
                best = {"job_id": jid, "priority": job.priority}
        return best

    def is_lowest_priority_running(
        self, claim: Claim, now: float | None = None
    ) -> bool:
        """Deterministic victim selection: among live (unexpired,
        non-gang) claims, the one with the smallest (priority, job_id)
        is THE victim — so when every busy worker evaluates the same
        pending urgent job, exactly one self-revokes."""
        now = time.time() if now is None else now
        lowest: tuple | None = None
        cdir = os.path.join(self.qdir, _CLAIMS)
        for name in sorted(os.listdir(cdir)):
            if not name.endswith(".json"):
                continue
            doc = _read_json(os.path.join(cdir, name))
            if doc is None or float(doc.get("expires_unix", 0)) < now:
                continue
            if doc.get("gang"):
                continue
            jid = doc.get("job_id") or os.path.splitext(name)[0]
            job = self.get_job(jid)
            if job is None:
                continue
            key = (job.priority, jid)
            if lowest is None or key < lowest:
                lowest = key
        return lowest is not None and lowest[1] == claim.job.job_id

    # --- gang membership ----------------------------------------------
    def gang_invitation(self, worker_id: str) -> dict | None:
        """A live gang claim naming ``worker_id`` as a (non-leader)
        member: the member-side entry into a gang job. Returns the
        claim document (carrying the gang member set, epoch and
        job_id) or None."""
        now = time.time()
        cdir = os.path.join(self.qdir, _CLAIMS)
        for name in sorted(os.listdir(cdir)):
            if not name.endswith(".json"):
                continue
            doc = _read_json(os.path.join(cdir, name))
            if doc is None or float(doc.get("expires_unix", 0)) < now:
                continue
            gang = doc.get("gang")
            if (
                gang
                and worker_id in gang.get("members", [])
                and worker_id != doc.get("worker_id")
            ):
                return doc
        return None

    def _record_failure(self, job_id: str, error: str) -> str:
        """Consume one attempt: exponential backoff, or quarantine when
        the budget is spent. Caller must hold the claim (or have won
        the reap race) — job records have a single writer at a time."""
        job = self.get_job(job_id)
        if job is None:
            return "unknown"
        job.attempts += 1
        job.last_error = f"{error}"[:2000]
        if job.attempts >= self.max_attempts:
            _atomic_write_json(
                self._p(_QUARANTINE, job_id),
                {
                    "job_id": job_id,
                    "input": job.input,
                    "attempts": job.attempts,
                    "last_error": job.last_error,
                    "quarantined_unix": time.time(),
                },
            )
            _atomic_write_json(self._p(_JOBS, job_id), job.to_doc())
            log.warning(
                "job %s quarantined after %d attempts: %s",
                job_id, job.attempts, job.last_error,
            )
            return "quarantined"
        backoff = self.backoff_base_s * (2 ** (job.attempts - 1))
        job.next_eligible_unix = time.time() + backoff
        _atomic_write_json(self._p(_JOBS, job_id), job.to_doc())
        log.warning(
            "job %s failed (attempt %d/%d, retry in %.3gs): %s",
            job_id, job.attempts, self.max_attempts, backoff,
            job.last_error,
        )
        return "backoff"

    # --- stale-claim reaping -----------------------------------------
    def reap_stale(self, now: float | None = None) -> list[str]:
        """Re-queue jobs whose claim lease expired (their worker was
        SIGKILLed or wedged past its lease) — and jobs whose holder
        blew a preempt request's grace deadline (alive enough to renew
        its lease yet unresponsive to the revoke: wedged in device
        code, or the revoke delivery itself is failing — the
        ``preempt.revoke`` chaos seam). Exactly one reaper wins per
        claim: the claim is renamed to a private tombstone first, and
        only the winner of that rename records the failure.

        A renewal racing the reap is detected by re-reading the
        tombstone: if the lease is no longer expired the rename
        caught a freshly renewed claim, and it is put back. (A
        grace-deadline reap deliberately skips the putback — renewing
        the lease is exactly what an unresponsive victim does.)"""
        now = time.time() if now is None else now
        # chaos seam: a scheduled clock.skew fault shifts THIS
        # reaper's view of lease expiry (drills premature reaping —
        # the renew-race putback below must absorb it)
        now += faults.clock_skew_s()
        reaped = []
        cdir = os.path.join(self.qdir, _CLAIMS)
        for name in sorted(os.listdir(cdir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(cdir, name)
            doc = _read_json(path)
            job_id = os.path.splitext(name)[0]
            if doc is None:
                # TORN claim: its creator was SIGKILLed between the
                # O_EXCL create and the document publish. It carries
                # no expiry, so it can never go stale — yet it blocks
                # every future O_EXCL claim: the job was stuck
                # forever (found by the mc claim_crash_reap
                # scenario). Age-gate on st_ctime (rename-proof, and
                # bumped by the publish) so a mid-write claimant gets
                # a full lease to finish, then reap with ZERO
                # attempts charged — the job never ran
                try:
                    age = now - os.stat(path).st_ctime
                except OSError:
                    continue  # vanished (publish or release race)
                if age <= self.lease_s:
                    continue
                tomb = f"{path}.reap.{uuid.uuid4().hex[:8]}"
                try:
                    os.rename(path, tomb)
                except OSError:
                    continue  # lost the reap race
                if _read_json(tomb) is not None:
                    # published after all (very slow writer): put the
                    # live claim back, re-judge next sweep
                    try:
                        os.rename(tomb, path)
                    except OSError:
                        _discard(tomb)
                    continue
                _discard(tomb)
                self.clear_preempt(job_id)
                reaped.append(job_id)
                log.warning(
                    "reaped torn claim on %s (creator died mid-"
                    "publish; zero attempts charged)", job_id,
                )
                continue
            expired = float(doc.get("expires_unix", 0)) < now
            req = self.preempt_request(job_id)
            overdue = req is not None and (
                float(req.get("deadline_unix", 0)) < now
            )
            if not expired and not overdue:
                continue
            if os.path.exists(self._p(_DONE, job_id)):
                # complete() publishes the done record before it drops
                # the claim: a finished job's claim is never charged,
                # only swept once its lease is over (its holder died
                # between the two steps)
                if expired:
                    tomb = f"{path}.reap.{uuid.uuid4().hex[:8]}"
                    try:
                        os.rename(path, tomb)
                    except OSError:
                        continue
                    _discard(tomb)
                continue
            tomb = f"{path}.reap.{uuid.uuid4().hex[:8]}"
            try:
                os.rename(path, tomb)
            except OSError:
                continue  # lost the reap race
            fresh = _read_json(tomb)
            if fresh is None or (
                not overdue
                and float(fresh.get("expires_unix", 0)) >= now
            ):
                # our rename caught a renewal, not the expired claim
                # we read: either the republished document (fresh
                # lease) or the renewer's O_EXCL file still awaiting
                # its publish — torn, which is why an unreadable
                # tombstone here means a LIVE owner, never the dead
                # one we diagnosed (found by the mc renew_vs_reap
                # scenario: charging this torn file re-queued a job
                # whose renewer kept running it). Put the claim back
                # via link so a claimant that won the job in the gap
                # is never clobbered, then drop the tombstone name
                try:
                    os.link(tomb, path)
                except OSError:
                    pass  # a new claimant owns the job: they win
                _discard(tomb)
                continue
            worker = fresh.get("worker_id", "?")
            if overdue and not expired:
                self._record_failure(
                    job_id,
                    f"preempt grace deadline expired (worker {worker} "
                    "unresponsive to revoke)",
                )
                from ..resilience import STATS

                STATS.preemption("reaped")
            else:
                self._record_failure(
                    job_id,
                    f"lease expired (worker {worker} presumed dead)",
                )
            self.clear_preempt(job_id)
            os.unlink(tomb)
            reaped.append(job_id)
            log.warning(
                "reaped %s claim on %s (worker %s)",
                "revoke-unresponsive" if overdue and not expired
                else "stale",
                job_id, worker,
            )
        # orphan sweep: artifacts of dances whose worker died mid-step.
        # Tombstones (".reap."/".release.") age out by st_ctime — a
        # LIVE dance is at most a few ops long, so a full lease of age
        # means its owner is gone. Orphaned preempt requests (their
        # claim is gone) wait out deadline + lease before removal: the
        # ownership dance makes a live claim briefly absent, and a
        # revoke must survive that window
        for name in sorted(os.listdir(cdir)):
            p = os.path.join(cdir, name)
            if ".reap." in name or ".release." in name:
                try:
                    if now - os.stat(p).st_ctime > self.lease_s:
                        os.unlink(p)
                except OSError:
                    pass  # consumed by its dance, or swept by a peer
            elif name.endswith(".preempt"):
                if os.path.exists(p[: -len(".preempt")]):
                    continue  # claim lives: the request is active
                req = _read_json(p)
                deadline = float((req or {}).get("deadline_unix", 0.0))
                if now > deadline + self.lease_s:
                    try:
                        os.unlink(p)
                    except FileNotFoundError:
                        pass
        return reaped

    # --- operator controls -------------------------------------------
    def quarantined(self) -> list[dict]:
        qdir = os.path.join(self.qdir, _QUARANTINE)
        out = []
        for name in sorted(os.listdir(qdir)):
            if name.endswith(".json"):
                doc = _read_json(os.path.join(qdir, name))
                if doc:
                    out.append(doc)
        return out

    def retry(self, job_id: str) -> bool:
        """Re-queue a quarantined job: reset its attempt budget and
        remove the quarantine marker. Returns False when the job is
        not quarantined."""
        qpath = self._p(_QUARANTINE, job_id)
        if not os.path.exists(qpath):
            return False
        job = self.get_job(job_id)
        if job is None:
            return False
        job.attempts = 0
        job.next_eligible_unix = 0.0
        _atomic_write_json(self._p(_JOBS, job_id), job.to_doc())
        # marker removed LAST: a crash mid-retry leaves the job
        # quarantined (safe), never half-requeued
        os.unlink(qpath)
        log.info("job %s re-queued from quarantine", job_id)
        return True

    def done_records(self) -> list[dict]:
        ddir = os.path.join(self.qdir, _DONE)
        out = []
        for name in sorted(os.listdir(ddir)):
            if name.endswith(".json"):
                doc = _read_json(os.path.join(ddir, name))
                if doc:
                    out.append(doc)
        return out
