"""The hazard rules (PSA001-PSA010), over the port's sources (the JAX
package's analysis/rules.py).

Each rule encodes an invariant the pipeline stakes a runtime guarantee
on; see the class docstrings for the failure mode each one prevents.
PSA004 and PSA006-PSA009 are the JAX package's rules as they are.
PSA001 and PSA003 are their torch counterparts with the same intent:
host syncs and float64 in device code. PSA002, PSA005 and PSA010 read
JAX traces, which the port does not make: :data:`EXCLUDED_RULES` gives
each one's reason, and ``peasoup-audit --list-rules`` prints them.
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
from .findings import SEV_ERROR, SEV_WARNING

_NP = ("np", "numpy")
_DEVICE_DIRS = (
    "peasoup_tpu_torch/ops/",
    "peasoup_tpu_torch/parallel/",
    "peasoup_tpu_torch/pipeline/",
    "peasoup_tpu_torch/plan/",
)

# the JAX package's rules with no counterpart here, and why
EXCLUDED_RULES = {
    "PSA002": (
        "Python branch on a tracer: the port traces nothing, so a branch "
        "on a tensor is an eager host read (inside a loop, PSA001's)"
    ),
    "PSA005": (
        "non-hashable or array-valued static jit argument: the port has "
        "no jit and no static arguments; a kernel takes its shape at "
        "each launch"
    ),
    "PSA010": (
        "NumPy op on a tracer: the port traces nothing; NumPy on a "
        "card's tensor raises at once, and .numpy() is PSA001's"
    ),
}


def _root(name: str | None) -> str:
    return (name or "").split(".", 1)[0]


@register_rule
class HostSyncInLoop(Rule):
    """A host synchronisation once an iteration of a loop in device code.

    ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` of a card's
    tensor, and ``torch.cuda.synchronize()``, wait for every launch
    queued before them. Once an iteration of a loop over row batches or
    DM blocks, each one idles the card until the host catches up and
    serialises the pipeline (the torch counterpart of the JAX package's
    host sync inside jitted code).
    """

    id = "PSA001"
    severity = SEV_ERROR
    title = "host sync inside a device-code loop"
    fix_hint = (
        "keep the values on the card and read them once after the loop, "
        "or suppress with the reason each iteration must read them"
    )
    paths = _DEVICE_DIRS

    _SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

    def check(self, ctx: ModuleContext):
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.in_loop(node):
                continue
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in self._SYNC_METHODS
                and not node.args
                and not node.keywords
            ):
                yield self.finding(
                    ctx, node,
                    f".{node.func.attr}() syncs the host with the device "
                    "once a loop iteration",
                )
            elif dotted_name(node.func) == "torch.cuda.synchronize":
                yield self.finding(
                    ctx, node,
                    "torch.cuda.synchronize() once a loop iteration",
                )


@register_rule
class Float64InDeviceCode(Rule):
    """float64 creeping into device code.

    The pipeline is float32 by design (peasoup's GPU lineage): an f64
    op runs at a small fraction of the H100's f32 rate, and an f64
    tensor doubles its memory and bytes moved. ``torch.float64``,
    ``torch.double``, ``torch.complex128`` and ``.double()`` are
    flagged in the device directories; NumPy's float64 stays legal
    there (the plan layer reproduces the reference's host f64 math).
    """

    id = "PSA003"
    severity = SEV_ERROR
    title = "float64 in device code"
    fix_hint = "use float32 (the whole pipeline is f32 by design)"
    paths = _DEVICE_DIRS

    _F64 = {"float64", "double", "complex128", "cdouble"}

    def check(self, ctx: ModuleContext):
        for node in walk(ctx.tree):
            if isinstance(node, ast.Attribute):
                name = dotted_name(node)
                if name is not None and _root(name) == "torch" and (
                    name.rsplit(".", 1)[-1] in self._F64
                ):
                    yield self.finding(ctx, node, f"{name} in device code")
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "double"
                and not node.args
            ):
                yield self.finding(ctx, node, ".double() in device code")


@register_rule
class DtypelessNpArray(Rule):
    """``np.array([...])`` without an explicit dtype in device-adjacent
    code.

    NumPy infers float64 for Python floats, so a dtype-less literal
    that later feeds torch silently promotes (``torch.from_numpy``
    keeps float64) or silently DOWNCASTS where a tensor of f32 takes it
    — two different sets of rounded values depending on which path
    touched it first. An explicit
    dtype documents which one is intended.
    """

    id = "PSA004"
    severity = SEV_WARNING
    title = "dtype-less np.array literal in device-adjacent code"
    fix_hint = "pass dtype= explicitly (np.float32 for device inputs)"
    paths = _DEVICE_DIRS

    _LITERALS = (ast.List, ast.Tuple, ast.ListComp, ast.GeneratorExp)

    def check(self, ctx: ModuleContext):
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee is None or _root(callee) not in _NP:
                continue
            if callee.rsplit(".", 1)[-1] != "array":
                continue
            if not node.args or not isinstance(node.args[0], self._LITERALS):
                continue
            if any(kw.arg == "dtype" for kw in node.keywords):
                continue
            yield self.finding(
                ctx, node,
                f"{callee}() of a literal without an explicit dtype",
            )


@register_rule
class WallClockForDuration(Rule):
    """``time.time()`` where ``perf_counter`` is required.

    Wall clock steps under NTP slew: a duration measured with
    ``time.time()`` can be negative or wildly wrong, which is exactly
    how the telemetry layer once recorded negative JIT compile times.
    Epoch *timestamps* (``*_unix`` fields, lease expiries shared
    across hosts) are the legitimate use; name the target accordingly
    or suppress with the reason.
    """

    id = "PSA006"
    severity = SEV_WARNING
    title = "time.time() where perf_counter is required"
    fix_hint = (
        "use time.perf_counter() for durations; for wall-clock epochs "
        "store into a *_unix name or suppress with the reason"
    )
    paths = ("peasoup_tpu_torch/",)

    _OK_NAMES = ("unix", "epoch", "wallclock")

    def _epoch_context(self, ctx: ModuleContext, node: ast.Call) -> bool:
        parent = ctx.parent(node)
        # walk up through arithmetic / conditional expressions
        while isinstance(parent, (ast.BinOp, ast.IfExp, ast.BoolOp)):
            node, parent = parent, ctx.parent(parent)
        if isinstance(parent, ast.Assign):
            for t in parent.targets:
                name = (
                    t.id if isinstance(t, ast.Name)
                    else t.attr if isinstance(t, ast.Attribute)
                    else ""
                )
                low = name.lower()
                if low == "now" or any(s in low for s in self._OK_NAMES):
                    return True
        if isinstance(parent, ast.Dict):
            for k, v in zip(parent.keys, parent.values):
                if v is node and isinstance(k, ast.Constant) and any(
                    s in str(k.value).lower() for s in self._OK_NAMES
                ):
                    return True
        return False

    def check(self, ctx: ModuleContext):
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func) != "time.time":
                continue
            if self._epoch_context(ctx, node):
                continue
            yield self.finding(
                ctx, node,
                "time.time() used outside an epoch-timestamp context",
            )


@register_rule
class PrintInLibrary(Rule):
    """``print()`` in library code.

    The library speaks through the peasoup_tpu_torch logger and the
    telemetry manifest; stdout belongs to the CLIs (candidate tables
    are parsed from it downstream — a stray print corrupts them).
    """

    id = "PSA007"
    severity = SEV_ERROR
    title = "print() in library code"
    fix_hint = "use the port's logger (peasoup_tpu_torch/obs/log.py)"
    paths = ("peasoup_tpu_torch/",)
    exclude = ("peasoup_tpu_torch/cli/", "peasoup_tpu_torch/tools/")

    def check(self, ctx: ModuleContext):
        for node in walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                yield self.finding(ctx, node, "print() in library code")


@register_rule
class NonAtomicSharedWrite(Rule):
    """In-place JSON writes to shared files.

    The obs/campaign layers rewrite ``status.json``, queue records and
    rollups with tmp-file + ``os.replace`` so concurrent readers (the
    watcher, other workers, the reaper) never see a torn file. A plain
    ``open(path, "w") + json.dump`` in those layers reintroduces the
    torn-read race.
    """

    id = "PSA008"
    severity = SEV_ERROR
    title = "non-atomic JSON write in a shared-file layer"
    fix_hint = (
        "write to a tempfile in the same directory and os.replace() "
        "into place (see obs/heartbeat._atomic_write_json)"
    )
    paths = (
        "peasoup_tpu_torch/obs/",
        "peasoup_tpu_torch/campaign/",
        "peasoup_tpu_torch/pipeline/",
        "peasoup_tpu_torch/io/",
    )

    def _open_write_names(self, fn: ast.AST) -> dict[str, ast.AST]:
        """as-names bound by `with open(_, "w"...)` in this function."""
        out: dict[str, ast.AST] = {}
        for node in walk(fn):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                call = item.context_expr
                if not (
                    isinstance(call, ast.Call)
                    and dotted_name(call.func) == "open"
                ):
                    continue
                mode = None
                if len(call.args) > 1 and isinstance(
                    call.args[1], ast.Constant
                ):
                    mode = call.args[1].value
                for kw in call.keywords:
                    if kw.arg == "mode" and isinstance(
                        kw.value, ast.Constant
                    ):
                        mode = kw.value.value
                if not (isinstance(mode, str) and "w" in mode):
                    continue
                if isinstance(item.optional_vars, ast.Name):
                    out[item.optional_vars.id] = call
        return out

    def check(self, ctx: ModuleContext):
        for fn in walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            has_replace = any(
                isinstance(n, ast.Call)
                and dotted_name(n.func) in ("os.replace", "os.rename")
                for n in walk(fn)
            )
            if has_replace:
                continue
            writers = self._open_write_names(fn)
            if not writers:
                continue
            for node in walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = dotted_name(node.func)
                if callee == "json.dump" and len(node.args) >= 2:
                    f = node.args[1]
                    if isinstance(f, ast.Name) and f.id in writers:
                        yield self.finding(
                            ctx, node,
                            "json.dump() into a plainly-opened file: a "
                            "concurrent reader can see a torn write",
                        )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "write"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in writers
                    and node.args
                    and isinstance(node.args[0], ast.Call)
                    and dotted_name(node.args[0].func) == "json.dumps"
                ):
                    yield self.finding(
                        ctx, node,
                        "f.write(json.dumps(...)) into a plainly-opened "
                        "file: a concurrent reader can see a torn write",
                    )


@register_rule
class UnlockedThreadShared(Rule):
    """Mutation of thread-shared state outside a lock.

    In classes that spawn a ``threading.Thread`` (the heartbeat, the
    queue's lease renewer), attributes mutated from both the worker
    thread and the main thread race unless guarded. Plain rebinding
    is atomic under the GIL; this flags the compound operations that
    are not: augmented assignment and in-place container mutation.
    """

    id = "PSA009"
    severity = SEV_WARNING
    title = "thread-shared mutation outside a lock"
    fix_hint = (
        "guard with `with self._lock:` (threading.Lock), or suppress "
        "with the reason the access is single-threaded"
    )
    paths = ("peasoup_tpu_torch/",)

    _MUTATORS = {
        "append", "extend", "insert", "remove", "pop", "popleft",
        "appendleft", "clear", "update", "add", "discard",
        "setdefault",
    }

    def _spawns_thread(self, cls: ast.ClassDef) -> bool:
        for node in walk(cls):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func) or ""
                if name.endswith("Thread") and _root(name) in (
                    "threading", "Thread",
                ):
                    return True
        return False

    def check(self, ctx: ModuleContext):
        for cls in walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if not self._spawns_thread(cls):
                continue
            for method in cls.body:
                if not isinstance(
                    method, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) or method.name == "__init__":
                    continue
                for node in walk(method):
                    if (
                        isinstance(node, ast.AugAssign)
                        and isinstance(node.target, ast.Attribute)
                        and isinstance(node.target.value, ast.Name)
                        and node.target.value.id == "self"
                        and not ctx.in_lock(node)
                    ):
                        yield self.finding(
                            ctx, node,
                            f"self.{node.target.attr} augmented outside "
                            f"a lock in thread-spawning class "
                            f"{cls.name}",
                        )
                    elif (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in self._MUTATORS
                        and isinstance(node.func.value, ast.Attribute)
                        and isinstance(node.func.value.value, ast.Name)
                        and node.func.value.value.id == "self"
                        and not ctx.in_lock(node)
                    ):
                        yield self.finding(
                            ctx, node,
                            f"self.{node.func.value.attr}."
                            f"{node.func.attr}() outside a lock in "
                            f"thread-spawning class {cls.name}",
                        )


def all_rules() -> dict[str, type[Rule]]:
    from .astlint import rule_classes

    return rule_classes()
