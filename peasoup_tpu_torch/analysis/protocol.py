"""Engine 3: concurrency / file-protocol rules (PSP101-PSP107).

The fleet's exactly-once and torn-read guarantees rest on a small set
of filesystem and threading protocols (campaign/queue.py's module
docstring is the spec): ``O_CREAT|O_EXCL`` creation for claims and
enqueues, tmp + ``os.replace`` for every rewrite a concurrent reader
may race, a private tmp file published once with ``os.link`` (the
port's ``JobQueue.complete`` and campaign config), append-only JSONL for recorders, rename (never delete) for
tombstones and corrupt-artifact quarantine, ``guard_thread`` around
every background thread body, and explicit telemetry hand-off (or a
copied ``contextvars`` context) across thread boundaries. These rules
make the protocols machine-checked instead of remembered by convention.

Unlike the PSA rules (generic hazards), these are **dataflow
aware**: a path expression is classified by the string literals that
flow into it (a per-function taint walk over assignments and
``os.path.join`` chains), so ``open(tmp, "w")`` of a ``mkstemp`` name
is sanctioned while ``open(status_path, "w")`` of the shared artifact
is not — same function, same call shape, different provenance.
"""

from __future__ import annotations

import ast

from .astlint import (
    ModuleContext,
    Rule,
    dotted_name,
    register_rule,
    walk,
)
from .findings import SEV_ERROR

# substrings marking a path literal as a SHARED artifact: files other
# processes/threads read while we write (the campaign tree's protocol
# surface plus any JSON/JSONL document)
_SHARED_MARKERS = (
    "queue/", "/queue", "jobs/", "/jobs", "campaign", "status.json",
    ".json", ".jsonl",
)
# substrings marking a path literal as a private scratch target: the
# tmp half of the tmp+rename idiom, quarantine/tombstone renames
_TMP_MARKERS = (
    ".tmp", ".part", ".reap", ".corrupt", ".ckpt.tmp",
    # ownership-dance tombstones: renamed-aside artifacts a single
    # holder consumes, no longer the shared rendezvous name
    ".release", ".preempt",
)

# functions whose RESULT is a private scratch path
_TMP_SOURCES = ("tempfile.mkstemp", "mkstemp", "tempfile.mktemp")

# the calls that publish a finished tmp file under its shared name
_PUBLISHERS = ("os.replace", "os.rename", "os.link")

# name fragments marking a helper as durability-critical: its artifact
# must survive a host crash, not just a process crash, so the tmp file
# must be fsynced before the rename publishes it
_DURABLE_MARKERS = ("checkpoint", "durable")


def _literal_strings(node: ast.AST) -> list[str]:
    return [
        n.value
        for n in walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ]


def _classify_literal(parts: list[str]) -> str:
    """'tmp' | 'shared' | 'other' for the string literals of one path
    expression. Tmp wins: ``path + ".tmp"`` is the tmp half of the
    atomic idiom even though ``path`` itself is shared."""
    text = "|".join(parts).lower()
    if any(m in text for m in _TMP_MARKERS):
        return "tmp"
    if any(m in text for m in _SHARED_MARKERS):
        return "shared"
    return "other"


class _PathTaint:
    """Per-function name -> {'shared'|'tmp'|'other'} classification.

    One linear pass over the function's assignments: a name assigned
    from an expression containing tmp markers (or a mkstemp call) is
    tmp; containing shared markers, shared. Later assignments override
    earlier ones only upward in specificity (tmp sticks — rebinding a
    tmp name from the shared name, e.g. ``tmp = path + ".tmp"``, is
    the idiom itself).
    """

    def __init__(self, fn: ast.AST):
        self.taint: dict[str, str] = {}
        for node in walk(fn):
            targets: list[str] = []
            value = None
            if isinstance(node, ast.Assign):
                value = node.value
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        targets.append(t.id)
                    elif isinstance(t, ast.Tuple):
                        targets.extend(
                            e.id for e in t.elts if isinstance(e, ast.Name)
                        )
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value = node.value
                if isinstance(node.target, ast.Name):
                    targets.append(node.target.id)
            if not targets or value is None:
                continue
            cls = self.classify(value)
            for name in targets:
                if cls == "tmp" or self.taint.get(name) != "tmp":
                    self.taint[name] = cls

    def classify(self, expr: ast.AST) -> str:
        for n in walk(expr):
            if isinstance(n, ast.Call):
                callee = dotted_name(n.func) or ""
                if callee in _TMP_SOURCES or callee.endswith("mkstemp"):
                    return "tmp"
        parts = _literal_strings(expr)
        cls = _classify_literal(parts) if parts else "other"
        if cls != "tmp":
            # names referenced by the expression carry their taint in
            for n in walk(expr):
                if isinstance(n, ast.Name):
                    t = self.taint.get(n.id)
                    if t == "tmp":
                        return "tmp"
                    if t == "shared":
                        cls = "shared"
        return cls


def _enclosing_function(ctx: ModuleContext, node: ast.AST):
    for anc in [node, *ctx.ancestors(node)]:
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return ctx.tree


def _open_mode(call: ast.Call) -> str | None:
    mode = None
    if len(call.args) > 1 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return mode if isinstance(mode, str) else None


@register_rule
class NonAtomicSharedPathWrite(Rule):
    """``open(<shared path>, "w")`` of a protocol artifact.

    Every write landing under ``queue/``, ``jobs/``, a campaign root,
    or any ``*.json``/``*.jsonl`` artifact must flow through a
    sanctioned atomic idiom: ``O_CREAT|O_EXCL`` creation (claims,
    enqueues), tmp + ``os.replace`` (rewrites), a private tmp file
    published once by ``os.link`` (which fails where the target
    exists), or append mode (the recorders). A direct ``"w"`` open of the final path gives every
    concurrent reader — the watcher, the reaper, a gang peer — a
    window onto a torn file. (PSA008 heuristically flags json.dump in
    replace-less functions; this rule is the path-aware deepening: the
    open itself is the violation, whatever is written through it.)
    """

    id = "PSP101"
    severity = SEV_ERROR
    title = "non-atomic write to a shared artifact path"
    fix_hint = (
        "write a tempfile in the same directory and os.replace() into "
        "place (campaign/queue._atomic_write_json), os.open(...O_EXCL) "
        "or a tmp file + os.link for create-once documents, or mode 'a' "
        "for append-only records"
    )
    paths = ("peasoup_tpu_torch/",)
    exclude = ("peasoup_tpu_torch/tools/",)

    def check(self, ctx: ModuleContext):
        for fn in walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            taint = _PathTaint(fn)
            for node in walk(fn):
                if not (
                    isinstance(node, ast.Call)
                    and dotted_name(node.func) == "open"
                    and node.args
                ):
                    continue
                mode = _open_mode(node)
                if mode is None or "w" not in mode:
                    continue  # reads and appends are protocol-clean
                if taint.classify(node.args[0]) == "shared":
                    yield self.finding(
                        ctx, node,
                        "open(..., 'w') directly on a shared artifact "
                        "path: concurrent readers can observe a torn "
                        "file",
                    )


@register_rule
class DeleteWhereQuarantineRequired(Rule):
    """``os.remove``/``os.unlink`` of a damaged artifact.

    The resilience policy (resilience/policy.py ``load_or_recover``)
    quarantines unreadable artifacts by RENAMING them to ``*.corrupt``
    — forensics survive, ``peasoup-campaign prune --corrupt`` reclaims
    the space deliberately. Deleting inside the exception handler that
    just failed to read/parse the file destroys the evidence the chaos
    gate (and any post-mortem) needs.
    """

    id = "PSP102"
    severity = SEV_ERROR
    title = "delete where the quarantine policy requires rename"
    fix_hint = (
        "rename the damaged file aside (resilience.load_or_recover "
        "quarantines to *.corrupt); deletion is prune's job, not the "
        "error path's"
    )
    paths = ("peasoup_tpu_torch/",)
    exclude = ("peasoup_tpu_torch/tools/", "peasoup_tpu_torch/cli/")

    _READERS = ("json.load", "json.loads", "np.load", "numpy.load",
                "pickle.load", "load")
    _UNLINKERS = ("os.remove", "os.unlink")

    def _try_reads_artifact(self, handler: ast.ExceptHandler,
                            tree: ast.AST) -> bool:
        """Does the try block this handler guards parse/read a file?"""
        for node in walk(tree):
            if isinstance(node, ast.Try) and handler in node.handlers:
                for n in walk(ast.Module(body=node.body,
                                             type_ignores=[])):
                    if isinstance(n, ast.Call):
                        callee = dotted_name(n.func) or ""
                        if callee in self._READERS or callee.endswith(
                            (".load", ".loads")
                        ):
                            return True
                return False
        return False

    def check(self, ctx: ModuleContext):
        for node in walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and dotted_name(node.func) in self._UNLINKERS
                and node.args
            ):
                continue
            handler = next(
                (
                    a for a in ctx.ancestors(node)
                    if isinstance(a, ast.ExceptHandler)
                ),
                None,
            )
            if handler is None:
                continue
            # unlinking the file we failed to READ is the anti-pattern;
            # unlinking a tmp file in a write-path cleanup handler is
            # the atomic idiom's own error path
            fn = _enclosing_function(ctx, node)
            if _PathTaint(fn).classify(node.args[0]) == "tmp":
                continue
            if not self._try_reads_artifact(handler, ctx.tree):
                continue
            yield self.finding(
                ctx, node,
                "deleting an artifact inside its failed-read handler "
                "destroys the forensics the quarantine policy keeps",
            )


@register_rule
class MissingFsyncBeforeRename(Rule):
    """tmp + ``os.replace`` without fsync in a durability-marked helper.

    ``os.replace`` makes the rewrite atomic against CONCURRENT readers,
    but not durable against a HOST crash: without ``os.fsync`` on the
    tmp file, the rename can land in the directory while the data
    blocks are still in the page cache — a power cut leaves a
    zero-length "successfully replaced" artifact. For most protocol
    files that is acceptable (they are reconstructible). For the
    durability-marked helpers — checkpoint writers a preempted job's
    bitwise-equal resume depends on — it is not.
    """

    id = "PSP103"
    severity = SEV_ERROR
    title = "missing fsync before rename in a durability-marked helper"
    fix_hint = (
        "f.flush() + os.fsync(f.fileno()) before os.replace() "
        "(durability-marked writers only: checkpoint/durable helpers)"
    )
    paths = ("peasoup_tpu_torch/",)

    def _durable(self, fn: ast.AST, cls: ast.ClassDef | None) -> bool:
        names = [getattr(fn, "name", "")]
        docs = [ast.get_docstring(fn) or ""]
        if cls is not None:
            names.append(cls.name)
            docs.append(ast.get_docstring(cls) or "")
        blob = "|".join(names + docs).lower()
        return any(m in blob for m in _DURABLE_MARKERS)

    def check(self, ctx: ModuleContext):
        reported: set[int] = set()  # replace nodes already flagged
        for node in walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cls = next(
                (
                    a for a in ctx.ancestors(node)
                    if isinstance(a, ast.ClassDef)
                ),
                None,
            )
            if not self._durable(node, cls):
                continue
            replaces = [
                n
                for n in walk(node)
                if isinstance(n, ast.Call)
                and dotted_name(n.func) in _PUBLISHERS
            ]
            if not replaces:
                continue
            has_fsync = any(
                isinstance(n, ast.Call)
                and (dotted_name(n.func) or "").endswith("fsync")
                for n in walk(node)
            )
            if has_fsync:
                continue
            for rep in replaces:
                if id(rep) in reported:
                    continue  # a nested helper inside the same writer
                reported.add(id(rep))
                yield self.finding(
                    ctx, rep,
                    f"{dotted_name(rep.func)}() in durability-marked "
                    f"helper {getattr(node, 'name', '?')!r} without an "
                    "fsync of the tmp file: a host crash can publish "
                    "an empty artifact",
                )


def _thread_targets(ctx: ModuleContext) -> list[tuple[ast.Call, ast.AST]]:
    """(Thread(...) call, target expression) pairs in this module."""
    out = []
    for node in walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func) or ""
        if not (
            name.endswith("Thread")
            and name.split(".", 1)[0] in ("threading", "Thread")
        ):
            continue
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and node.args:
            target = node.args[0]
        if target is not None:
            out.append((node, target))
    return out


def _defs_by_name(ctx: ModuleContext) -> dict[str, list[ast.AST]]:
    defs: dict[str, list[ast.AST]] = {}
    for node in walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def _resolve_target(
    ctx: ModuleContext, target: ast.AST,
    defs: dict[str, list[ast.AST]],
) -> list[ast.AST]:
    """Function bodies a Thread target resolves to, one level deep:
    plain names, ``self._method`` attributes, lambdas (followed into a
    ``ctx.run(fn, ...)`` call — the copied-context idiom)."""
    if isinstance(target, ast.Lambda):
        body = target.body
        if isinstance(body, ast.Call):
            callee = dotted_name(body.func) or ""
            if callee.endswith(".run") and body.args:
                return _resolve_target(ctx, body.args[0], defs)
            return _resolve_target(ctx, body.func, defs)
        return [target]
    name = None
    if isinstance(target, ast.Name):
        name = target.id
    elif isinstance(target, ast.Attribute):
        name = target.attr
    if name is not None and name in defs:
        return list(defs[name])
    return []


def _calls_guard_thread(fn: ast.AST) -> bool:
    for node in walk(fn):
        if isinstance(node, ast.Call):
            callee = dotted_name(node.func) or ""
            if callee.split(".")[-1] == "guard_thread":
                return True
    return False


@register_rule
class UnguardedThreadTarget(Rule):
    """Background thread body not wrapped in ``guard_thread``.

    An exception escaping a bare thread target kills the thread
    silently: the heartbeat stops beating, the lease stops renewing,
    the warmup never lands — and nothing marks the run degraded. The
    resilience contract (resilience/policy.py) is that every thread
    body runs under :func:`guard_thread`, which emits the structured
    ``thread_crashed`` event, bumps the crash counter (flipping
    ``degraded`` in status.json) and logs the traceback. Covers
    ``threading.Thread(target=...)`` (lambdas followed through the
    copied-context ``ctx.run(fn, ...)`` idiom) and ``run()`` methods
    of ``threading.Thread`` subclasses.
    """

    id = "PSP104"
    severity = SEV_ERROR
    title = "thread target not wrapped in guard_thread"
    fix_hint = (
        "run the body via resilience.guard_thread(name, fn, "
        "telemetry=...) so a crash is a structured degraded event, "
        "not a silent dead thread"
    )
    paths = ("peasoup_tpu_torch/",)
    exclude = ("peasoup_tpu_torch/resilience/",)

    def check(self, ctx: ModuleContext):
        defs = _defs_by_name(ctx)
        for call, target in _thread_targets(ctx):
            bodies = _resolve_target(ctx, target, defs)
            if not bodies:
                # unresolvable target (imported callable): flag it —
                # the guard must be visible at the spawn site
                yield self.finding(
                    ctx, call,
                    "Thread target is not resolvable in this module; "
                    "wrap the body in guard_thread at the spawn site",
                )
                continue
            for fn in bodies:
                if not _calls_guard_thread(fn):
                    yield self.finding(
                        ctx, call,
                        f"Thread target "
                        f"{getattr(fn, 'name', '<lambda>')!r} does not "
                        "run under guard_thread",
                    )
        # Thread subclasses: run() must guard
        for cls in walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if not any(
                (dotted_name(b) or "").endswith("Thread")
                for b in cls.bases
            ):
                continue
            for method in cls.body:
                if (
                    isinstance(method, ast.FunctionDef)
                    and method.name == "run"
                    and not _calls_guard_thread(method)
                ):
                    yield self.finding(
                        ctx, method,
                        f"{cls.name}.run() does not run its body under "
                        "guard_thread",
                    )


def _lock_names(with_node: ast.With) -> list[str]:
    names = []
    for item in with_node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            expr = expr.func
        name = dotted_name(expr) or ""
        leaf = name.split(".")[-1]
        if "lock" in leaf.lower() or "mutex" in leaf.lower():
            names.append(leaf)
    return names


def _attr_mutations(method: ast.AST):
    """(node, attr_name) for compound mutations of self.<attr>."""
    _MUTATORS = {
        "append", "extend", "insert", "remove", "pop", "popleft",
        "appendleft", "clear", "update", "add", "discard", "setdefault",
    }
    for node in walk(method):
        if (
            isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Attribute)
            and isinstance(node.target.value, ast.Name)
            and node.target.value.id == "self"
        ):
            yield node, node.target.attr
        elif (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Attribute)
            and isinstance(node.targets[0].value, ast.Name)
            and node.targets[0].value.id == "self"
        ):
            yield node, node.targets[0].attr
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
            and isinstance(node.func.value, ast.Attribute)
            and isinstance(node.func.value.value, ast.Name)
            and node.func.value.value.id == "self"
        ):
            yield node, node.func.value.attr


@register_rule
class MutationOutsideOwningLock(Rule):
    """Thread-shared attribute mutated outside its owning lock.

    Deepens PSA009 with per-class attribute/lock **binding**: in a
    class that spawns (or is) a thread, an attribute that is ever
    mutated under ``with self._lock:`` has declared ``_lock`` its
    owner — every other mutation of that attribute must hold the same
    lock, including plain rebinding (the half-guarded invariant is
    worse than none: readers that take the lock still see torn
    compound state). ``__init__`` is exempt (no thread exists yet).
    """

    id = "PSP105"
    severity = SEV_ERROR
    title = "thread-shared attribute mutated outside its owning lock"
    fix_hint = (
        "take the same `with self._lock:` that other mutators of this "
        "attribute hold (or suppress with the reason the access is "
        "single-threaded)"
    )
    paths = ("peasoup_tpu_torch/",)

    def _spawns_thread(self, cls: ast.ClassDef) -> bool:
        if any(
            (dotted_name(b) or "").endswith("Thread") for b in cls.bases
        ):
            return True
        for node in walk(cls):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func) or ""
                if name.endswith("Thread") and name.split(".", 1)[0] in (
                    "threading", "Thread",
                ):
                    return True
        return False

    def _enclosing_locks(self, ctx: ModuleContext, node: ast.AST):
        held = set()
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.With):
                held.update(_lock_names(anc))
        return held

    def check(self, ctx: ModuleContext):
        for cls in walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef) or not self._spawns_thread(
                cls
            ):
                continue
            # pass 1: bind attr -> owning locks
            owners: dict[str, set[str]] = {}
            sites: list[tuple[ast.AST, str, set[str], str]] = []
            for method in cls.body:
                if not isinstance(
                    method, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                for node, attr in _attr_mutations(method):
                    held = self._enclosing_locks(ctx, node)
                    if method.name != "__init__":
                        sites.append((node, attr, held, method.name))
                    owners.setdefault(attr, set()).update(held)
            # pass 2: every mutation of an owned attr must hold a lock
            for node, attr, held, method_name in sites:
                owning = owners.get(attr) or set()
                if not owning:
                    continue  # unowned attrs are PSA009's (warning) turf
                if held & owning:
                    continue
                yield self.finding(
                    ctx, node,
                    f"self.{attr} is lock-owned (mutated under "
                    f"{sorted(owning)} elsewhere in {cls.name}) but "
                    f"mutated lock-free in {method_name}()",
                )


@register_rule
class AmbientTelemetryAcrossThread(Rule):
    """Ambient (contextvar) telemetry read from a thread body.

    The active :class:`RunTelemetry` rides a ``contextvars``
    ContextVar, and context does NOT cross thread boundaries: a thread
    target calling the ambient accessor gets the process-wide no-op
    sink, so its events (and fault/retry attribution) silently vanish.
    The sanctioned patterns are an explicit ``telemetry=`` parameter
    (guard_thread and every recorder accept one) or spawning through a
    copied context (``contextvars.copy_context().run(fn, ...)`` — the
    streaming reader's idiom).
    """

    id = "PSP106"
    severity = SEV_ERROR
    title = "ambient telemetry accessor inside a thread target"
    fix_hint = (
        "pass the telemetry object into the thread explicitly, or "
        "spawn via contextvars.copy_context().run(...)"
    )
    paths = ("peasoup_tpu_torch/",)
    exclude = ("peasoup_tpu_torch/resilience/", "peasoup_tpu_torch/obs/telemetry.py")

    def _ambient_aliases(self, ctx: ModuleContext) -> set[str]:
        """Names this module binds to obs.telemetry.current."""
        aliases = set()
        for node in walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and (
                node.module or ""
            ).endswith("telemetry"):
                for alias in node.names:
                    if alias.name == "current":
                        aliases.add(alias.asname or alias.name)
        return aliases

    def check(self, ctx: ModuleContext):
        aliases = self._ambient_aliases(ctx)
        defs = _defs_by_name(ctx)
        bodies: list[ast.AST] = []
        copied: set[ast.AST] = set()
        for call, target in _thread_targets(ctx):
            resolved = _resolve_target(ctx, target, defs)
            # a lambda body of the form ctx.run(fn, ...) is the copied-
            # context idiom: everything under fn runs with context
            if isinstance(target, ast.Lambda) and isinstance(
                target.body, ast.Call
            ):
                callee = dotted_name(target.body.func) or ""
                if callee.endswith(".run"):
                    copied.update(resolved)
            bodies.extend(resolved)
        for cls in walk(ctx.tree):
            if isinstance(cls, ast.ClassDef) and any(
                (dotted_name(b) or "").endswith("Thread")
                for b in cls.bases
            ):
                for method in cls.body:
                    if (
                        isinstance(method, ast.FunctionDef)
                        and method.name == "run"
                    ):
                        bodies.append(method)
        for fn in bodies:
            if fn in copied:
                continue
            for node in walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = dotted_name(node.func) or ""
                is_ambient = (
                    callee in aliases
                    or callee.endswith("telemetry.current")
                    or callee.split(".")[-1]
                    in ("current_telemetry", "_current_telemetry")
                )
                if is_ambient:
                    yield self.finding(
                        ctx, node,
                        f"{callee}() in thread target "
                        f"{getattr(fn, 'name', '<lambda>')!r} reads "
                        "the no-op sink (contextvars do not cross "
                        "threads)",
                    )


@register_rule
class SharedArtifactDirectDelete(Rule):
    """``os.remove``/``os.unlink`` of a live shared protocol artifact.

    The fleet's ownership transfers never delete a shared rendezvous
    file in place: a holder RENAMES it to a uuid-suffixed tombstone
    (``.reap.<id>`` / ``.release.<id>``), re-verifies the renamed
    document, and only then consumes the tombstone — and damaged
    artifacts are renamed to ``*.corrupt`` for forensics. A direct
    unlink of the shared path is a blind write: between any read that
    justified it and the unlink itself, a reaper, renewer, or new
    claimant may have replaced the file, and the unlink destroys
    *their* artifact — the read-check-delete race class the mc
    scenarios (renew_vs_reap, release_vs_reap) exhibit concretely.
    Classification is the same literal-dataflow walk as PSP101:
    tombstone/tmp-marked names are sanctioned, shared-marked names
    (queue/, jobs/, ``*.json``...) are not.
    """

    id = "PSP107"
    severity = SEV_ERROR
    title = "direct delete of a shared artifact path"
    fix_hint = (
        "rename the artifact to a uuid-suffixed tombstone "
        "(*.reap.<id>/*.release.<id>), re-verify the renamed document, "
        "then consume the tombstone (campaign/queue._take_claim); "
        "quarantine damaged files to *.corrupt instead of deleting"
    )
    paths = ("peasoup_tpu_torch/",)
    exclude = ("peasoup_tpu_torch/tools/", "peasoup_tpu_torch/cli/")

    _UNLINKERS = ("os.remove", "os.unlink")

    def check(self, ctx: ModuleContext):
        for fn in walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            taint = _PathTaint(fn)
            for node in walk(fn):
                if not (
                    isinstance(node, ast.Call)
                    and dotted_name(node.func) in self._UNLINKERS
                    and node.args
                ):
                    continue
                if taint.classify(node.args[0]) == "shared":
                    yield self.finding(
                        ctx, node,
                        "os.unlink of a shared artifact path: transfer "
                        "ownership by tombstone-rename (and re-verify) "
                        "instead of deleting in place",
                    )


def protocol_rules() -> tuple[str, ...]:
    """The PSP rule IDs (the runner's engine-3 filter)."""
    return tuple(
        cls.id
        for cls in (
            NonAtomicSharedPathWrite,
            DeleteWhereQuarantineRequired,
            MissingFsyncBeforeRename,
            UnguardedThreadTarget,
            MutationOutsideOwningLock,
            AmbientTelemetryAcrossThread,
            SharedArtifactDirectDelete,
        )
    )
