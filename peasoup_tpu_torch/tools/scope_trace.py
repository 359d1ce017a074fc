"""Per-scope device-time attribution from ``torch.profiler`` (the port's
counterpart of the JAX package's tools/scope_trace.py).

The drivers open spans (utils/trace.py:trace_span, ``record_function``
scopes under a profiler) named like the JAX package's named scopes
(:data:`JAX_SCOPES`: "Dedisperse", "DM-Loop", "Spectrum-Chain",
"Acceleration-Loop", "Resample", "Harmonic summing", "Peaks", "SP-Chunk",
"FDAS-Correlate"), and the search's own parts (:data:`PORT_SPANS`).
Each CUDA kernel the profiler records is linked to the operator that
launched it, and that operator's chain of enclosing JAX-named scopes
gives the kernel's scope path; summing device time by path gives a
(time, launches) breakdown per stage, and :meth:`ScopeResult.kernel_table`
names the kernels themselves, the port's hand-written ones under their
own names (:data:`KERNEL_SYMBOLS`). On the CPU, where there is no device
track, the operators' own CPU time stands in for device time.

Each search run traced (a root span ``Search``) leaves its span table
(utils/trace.py:RunTable) in :attr:`ScopeResult.spans`, and the device's
idle gaps inside it, each part named by the innermost span open then, in
:attr:`ScopeResult.idle_gaps`: the parts of the run that no kernel or copy
covers (the union of their intervals; on the CPU, of the operators').

On a card, Kineto drops the first kernel records of a profiler session
as lying outside its capture window, once the process has run for a while
(none in a fresh process, more the longer it has run: chip_smoke.py
measures it at its start and in phase 29). A trace therefore opens with
:data:`WARMUP_LAUNCHES` one-element kernels under the scope
:data:`WARMUP_SCOPE`, which take those losses and which the tables leave
out; and it counts, for each hand-written kernel, the launches its
wrapper made against the ones the trace holds (:attr:`ScopeResult.lost`).

Library use::

    with scope_trace("cuda") as result:
        run()
    result.table()  # [(scope, seconds, launches), ...]

CLI: ``python -m peasoup_tpu_torch.tools.scope_trace ARGS`` runs the
port's ``peasoup`` CLI with ARGS under the trace and prints both tables.
"""

from __future__ import annotations

import contextlib

# the scopes the drivers open, as the JAX package names them: a kernel's
# scope path is made of these
JAX_SCOPES = (
    "Dedisperse", "DM-Loop", "Spectrum-Chain", "Acceleration-Loop", "Resample",
    "Harmonic summing", "Peaks", "SP-Chunk", "FDAS-Correlate", "Fold",
)
# the search's own spans (pipeline/search.py), read from its span tables
PORT_SPANS = (
    "Search", "Upload", "Whitening", "Wave-Fetch", "Fetch", "Search-Host",
    "Distil-Rows", "Distil-Native", "Distil-Objects", "Distilling", "Scoring",
)
# every scope name the port opens
SCOPES = JAX_SCOPES + PORT_SPANS

# the one-element kernels that open a trace on a card
WARMUP_SCOPE = "Profiler-Warmup"
WARMUP_LAUNCHES = 1024

# each hand-written kernel's device symbols (csrc/*.cu); the last one is
# launched once for every launch of the kernel's wrapper
KERNEL_SYMBOLS = {
    "dedisperse": ("dedisperse_kernel",),
    "resample": ("resample_rows_kernel",),
    "specchain": ("specchain_kernel",),
    "interbin": ("interbin_kernel",),
    "dftspec": ("dftspec_kernel",),
    "peaks": ("peaks_mask", "peaks_walk"),
    "harmpeaks": ("harm_mask", "harm_walk"),
    "boxcar": ("boxcar_kernel",),
    "spchain": ("spchain_kernel",),
}


def port_kernel(symbol: str) -> str | None:
    """The port kernel a device symbol belongs to, or None."""
    for name, syms in KERNEL_SYMBOLS.items():
        if any(s in symbol for s in syms):
            return name
    return None


def lost_launches(launched: dict[str, int], events) -> dict[str, int]:
    """{kernel: launches its wrapper made that the trace does not hold}
    for the hand-written kernels, from the wrappers' launch counts over
    the traced block and its (scope path, us, kernel) rows."""
    lost = {}
    for name, n in launched.items():
        sym = KERNEL_SYMBOLS[name][-1]
        held = sum(1 for _, _, kernel in events if sym in kernel)
        if held < n:
            lost[name] = n - held
    return lost


def absorb_start_loss(n: int = WARMUP_LAUNCHES) -> None:
    """Launch ``n`` one-element kernels on the current card under
    :data:`WARMUP_SCOPE` and wait for them: called first in a profiler
    session, they take the records Kineto drops at a session's start."""
    import torch
    from torch.profiler import record_function

    with record_function(WARMUP_SCOPE):
        x = torch.zeros(1, device="cuda")
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()


class ScopeResult:
    def __init__(self, device: str = "cuda") -> None:
        self.device = device
        self.events: list[tuple[str, float, str]] = []  # (scope path, us, kernel)
        self.launched: dict[str, int] = {}  # wrapper launches in the block
        self.lost: dict[str, int] = {}  # of those, launches the trace lacks
        self.spans: list[dict] = []  # the traced runs' span tables (RunTable.as_dict)
        self.window_s = 0.0  # the traced runs' wall seconds
        self.busy_s = 0.0  # of those, the device's (union of its intervals)
        self.idle_gaps: dict[str, float] = {}  # innermost span -> idle seconds

    @property
    def device_s(self) -> float:
        return sum(e[1] for e in self.events) / 1e6

    def table(self, depth: int = 2, top: int = 20) -> list[tuple[str, float, int]]:
        """Device seconds and launches by the first ``depth`` components of
        the scope path, largest first."""
        agg: dict[str, list] = {}
        for path, us, _ in self.events:
            key = "/".join(path.split("/")[:depth]) if path else "<unscoped>"
            a = agg.setdefault(key, [0.0, 0])
            a[0] += us / 1e6
            a[1] += 1
        rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
        return [(k, v[0], v[1]) for k, v in rows]

    def kernel_table(self, top: int = 20) -> list[dict]:
        """Device seconds and launches by kernel: every hand-written kernel
        the trace holds, then the ``top`` others, largest first."""
        agg: dict[str, list] = {}
        for _, us, kernel in self.events:
            a = agg.setdefault(kernel, [0.0, 0])
            a[0] += us / 1e6
            a[1] += 1
        rows = [
            {"kernel": k[:160], "port_kernel": port_kernel(k), "seconds": v[0],
             "launches": v[1]}
            for k, v in sorted(agg.items(), key=lambda kv: -kv[1][0])
        ]
        ours = [r for r in rows if r["port_kernel"]]
        return ours + [r for r in rows if not r["port_kernel"]][:top]

    def port_kernel_seconds(self) -> dict[str, float]:
        """Device seconds of each hand-written kernel in the trace."""
        out: dict[str, float] = {}
        for _, us, kernel in self.events:
            name = port_kernel(kernel)
            if name:
                out[name] = out.get(name, 0.0) + us / 1e6
        return out

    def print_table(self, depth: int = 2, top: int = 20) -> None:
        print(f"{self.device} busy: {self.device_s * 1e3:.1f} ms")
        for scope, s, n in self.table(depth, top):
            print(f"  {s * 1e3:10.3f} ms  {n:7d} launches  {scope}")
        for r in self.kernel_table(top):
            print(f"  {r['seconds'] * 1e3:10.3f} ms  {r['launches']:7d} launches  "
                  f"{r['port_kernel'] or '-':10s} {r['kernel'][:90]}")

    # the drivers' top-level scopes per pipeline phase
    PHASES = (
        ("search", ("DM-Loop", "SP-Chunk", "FDAS-Correlate")),
        ("dedisp", ("Dedisperse",)),
        ("fold", ("Fold",)),
    )

    def phase_seconds(self) -> dict:
        """Device seconds per pipeline phase, and 'other' for anything
        unclassified (kept visible so mis-attribution cannot hide)."""
        out = {name: 0.0 for name, _ in self.PHASES}
        out["other"] = 0.0
        for path, us, _ in self.events:
            for name, pats in self.PHASES:
                if any(p in path for p in pats):
                    out[name] += us / 1e6
                    break
            else:
                out["other"] += us / 1e6
        return out


def _in_warmup(evt) -> bool:
    while evt is not None:
        if evt.name == WARMUP_SCOPE:
            return True
        evt = evt.cpu_parent
    return False


def _scope_path(evt) -> str:
    """The '/'-joined JAX-named scopes enclosing ``evt``, outermost first."""
    names = []
    e = evt
    while e is not None:
        if e.name in JAX_SCOPES:
            names.append(e.name)
        e = e.cpu_parent
    return "/".join(reversed(names))


def parse_events(events, device: str) -> list[tuple[str, float, str]]:
    """(scope path, microseconds, kernel or operator) rows from a
    profiler's FunctionEvents: CUDA kernels on a card, each attributed
    through the operator that launched it; on the CPU, the operators' own
    time (scopes themselves excluded). The kernels launched under
    :data:`WARMUP_SCOPE` are left out."""
    from torch.autograd import DeviceType

    rows = []
    if device == "cuda":
        by_id = {e.id: e for e in events if e.device_type == DeviceType.CPU}
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            launcher = by_id.get(getattr(e, "linked_correlation_id", 0) or e.id)
            if _in_warmup(launcher):
                continue
            path = _scope_path(launcher) if launcher is not None else ""
            rows.append((path, float(e.device_time_total), e.name))
    else:
        for e in events:
            if e.device_type != DeviceType.CPU or e.name in SCOPES:
                continue
            if e.name.startswith("aten::") and e.self_cpu_time_total > 0:
                rows.append((_scope_path(e), float(e.self_cpu_time_total), e.name))
    return rows


def busy_intervals(events, device: str, t0_ns: int) -> list[tuple[int, int]]:
    """The device's work in a profiler's FunctionEvents as [start, end)
    unix nanoseconds (``t0_ns``: the trace's start): on a card its kernels
    and copies (the ranges of ``record_function`` scopes, which the trace
    also holds on the device's timeline, left out, and the warm-up's
    launches); on the CPU its operators."""
    from torch.autograd import DeviceType

    out = []
    if device == "cuda":
        by_id = {e.id: e for e in events if e.device_type == DeviceType.CPU}
        for e in events:
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            if _in_warmup(by_id.get(getattr(e, "linked_correlation_id", 0) or e.id)):
                continue
            out.append((e.time_range.start, e.time_range.end))
    else:
        out = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
    return [(t0_ns + round(s * 1e3), t0_ns + round(t * 1e3)) for s, t in out]


def fold_tables(res: ScopeResult, tables, busy: list[tuple[int, int]]) -> None:
    """Fold the runs' span tables into ``res``: each table, and the device's
    idle gaps inside each run, each part of a gap named by the innermost
    span open then."""
    from ..utils.trace import Innermost, gaps, union_length

    for tab in tables:
        lo, hi = tab.start_ns, tab.end_ns
        clipped = [(max(s, lo), min(t, hi)) for s, t in busy if t > lo and s < hi]
        host = Innermost(tab.intervals())
        res.spans.append(tab.as_dict())
        res.window_s += (hi - lo) / 1e9
        res.busy_s += union_length(clipped) / 1e9
        for gap in gaps(clipped, lo, hi):
            for s, t, name in host.split(*gap):
                name = name or "between spans"
                res.idle_gaps[name] = res.idle_gaps.get(name, 0.0) + (t - s) / 1e9


@contextlib.contextmanager
def scope_trace(device: str = "cuda"):
    """Trace the with-block with ``torch.profiler`` and fill a
    :class:`ScopeResult` with its per-scope time: CUDA kernels where
    ``device`` is a card, CPU operators otherwise. Raises where the block
    launched hand-written kernels but the profiler recorded no CUDA
    kernel (a profiler that cannot see the card must not yield an empty
    table). On a card the session opens with :func:`absorb_start_loss`,
    and ``result.lost`` names the hand-written kernels' launches the trace
    still lacks (logged as a warning)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import kernels
    from ..utils.trace import recorded_runs, run_tables

    device = str(torch.device(device).type)
    res = ScopeResult(device)
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if device == "cuda":
            absorb_start_loss()
        before = dict(kernels.launches)
        runs0 = recorded_runs()
        yield res
        if device == "cuda":
            torch.cuda.synchronize()
    res.launched = {k: n - before[k] for k, n in kernels.launches.items() if n > before[k]}
    events = prof.events()
    res.events = parse_events(events, device)
    new = recorded_runs() - runs0
    if new:
        t0_ns = prof.profiler.kineto_results.trace_start_ns()
        fold_tables(res, run_tables()[-new:], busy_intervals(events, device, t0_ns))
    if device == "cuda" and res.launched and not res.events:
        raise RuntimeError(
            "torch.profiler recorded no CUDA kernel of a run that launched "
            f"{sum(res.launched.values())}: the card's trace (CUPTI) is not available"
        )
    if device == "cuda":
        res.lost = lost_launches(res.launched, res.events)
        if res.lost:
            from ..obs.log import get_logger

            get_logger("scope_trace").warning(
                "the device trace lacks launches of %s (of %s)", res.lost, res.launched)


def main(argv: list[str] | None = None) -> int:
    import sys

    import torch

    from ..cli.peasoup import main as peasoup

    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--device" in argv and argv[argv.index("--device") + 1] == "cpu" \
        else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("scope_trace: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    with scope_trace(device) as res:
        rc = peasoup(argv)
    res.print_table()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
