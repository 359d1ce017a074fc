"""The perf ratchet of the port (the JAX package's perf/ratchet.py): a
``perf.json`` against the port's own baseline,
``peasoup_tpu_torch/perf/perf_baseline.json``, pinned from a run on the
card it names (with the card's power limit).

* Structural rules gate everywhere, the CPU included: every program of
  the baseline must still be registered and still run (a deleted or
  broken program is a regression, not a shrinkage). The CLI adds the
  registry's completeness (ops/registry.py:unregistered_programs) and a
  warm pass that builds no kernel.
* The timing ratchet applies on the baseline's card (or with
  ``timing="on"``): a program whose execute median passes the baseline's
  times ``tolerance`` fails. The first call's time (``compile_s``, a
  kernel library's load) is recorded and not ratcheted: the port compiles
  nothing per shape.

New programs never fail the check; they are reported, so that the
baseline can be pinned again (``check --write-baseline``), which is also
how a gain or an accepted slowdown is recorded.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from . import write_json_atomic

BASELINE_SCHEMA = "peasoup_tpu_torch.perf_baseline"
BASELINE_VERSION = 1
BASELINE_PATH = os.path.join(os.path.dirname(__file__), "perf_baseline.json")

# the execute-median tolerance of a pinned baseline: a run may land on
# another card of the same kind, at another power limit and beside other
# neighbours on its host (every sample holds the host's enqueue of the
# call too), so it is wider than the JAX package's 1.6; a lost kernel (a
# plain-version fallback, a serialised loop) is past it
DEFAULT_TOLERANCE = 3.0


@dataclass
class PerfProblem:
    """One ratchet violation."""

    kind: str  # missing_program | program_error | slower | unregistered_entry_point
    # | built_warm
    program: str
    message: str

    def render(self) -> str:
        return f"{self.program}: [{self.kind}] {self.message}"


def baseline_from_perf(doc: dict, tolerance: float = DEFAULT_TOLERANCE,
                       more: list[dict] | None = None) -> dict:
    """Pin a baseline from a perf.json run (programs with an error are left
    out: a broken program is repaired, not pinned). With ``more`` runs of
    the same card, each program's pinned execute median is the median of
    its medians over all the runs (those where it ran), so that a baseline
    is not pinned from one lucky or unlucky pass over the registry."""
    from .measure import median

    runs = [doc, *(more or [])]
    for other in runs[1:]:
        if (other.get("backend"), other.get("device_kind")) != (
                doc["backend"], doc["device_kind"]):
            raise ValueError("a baseline is pinned from runs on one kind of device")

    def pinned(name: str) -> float:
        return median([r["programs"][name]["execute_median_s"] for r in runs
                       if not r["programs"].get(name, {"error": "absent"}).get("error")])

    return {
        "schema": BASELINE_SCHEMA,
        "version": BASELINE_VERSION,
        "generated_by": "python -m peasoup_tpu_torch.tools.perf check --write-baseline",
        "backend": doc["backend"],
        "device_kind": doc["device_kind"],
        "power_limit": doc["power_limit"],
        "torch_version": doc.get("torch_version"),
        "tolerance": tolerance,
        "runs": len(runs),
        "programs": {
            name: {"execute_median_s": pinned(name),
                   "compile_s": rec["compile_s"], "args": rec.get("args", [])}
            for name, rec in sorted(doc["programs"].items()) if not rec.get("error")
        },
    }


def load_baseline(path: str) -> dict:
    """The baseline at ``path``. A missing or unreadable one raises: a
    baseline that failed to load must fail the gate, never pass every
    regression as new."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as exc:
        raise ValueError(f"{path}: missing or unreadable perf baseline ({exc}); pin one "
                         "with check --write-baseline") from exc
    if doc.get("schema") != BASELINE_SCHEMA or not isinstance(doc.get("programs"), dict):
        raise ValueError(f"{path}: not a {BASELINE_SCHEMA} document with a programs map")
    return doc


def write_baseline(doc: dict, path: str) -> None:
    write_json_atomic(path, doc, sort_keys=True)


def timing_applies(perf_doc: dict, baseline: dict, timing: str) -> bool:
    """Whether the timing ratchet gates this comparison: ``auto`` only on a
    card of the baseline's kind (a CPU's clock measures its neighbours)."""
    if timing == "on":
        return True
    if timing == "off":
        return False
    return (perf_doc.get("backend") == baseline.get("backend") == "cuda"
            and perf_doc.get("device_kind") == baseline.get("device_kind"))


def check_perf(perf_doc: dict, baseline: dict,
               timing: str = "auto") -> tuple[list[PerfProblem], list[str]]:
    """A perf.json against the baseline: (problems, notices). Problems fail
    the gate; notices (new programs, timing skipped) inform the report."""
    problems: list[PerfProblem] = []
    notices: list[str] = []
    recs = perf_doc.get("programs", {})
    timed = timing_applies(perf_doc, baseline, timing)
    tol = float(baseline.get("tolerance", DEFAULT_TOLERANCE))
    for name, b in sorted(baseline.get("programs", {}).items()):
        rec = recs.get(name)
        if rec is None:
            problems.append(PerfProblem(
                "missing_program", name, "in the baseline but absent from this run: a "
                "registry program disappeared (a deliberate removal pins the baseline "
                "again with --write-baseline)"))
        elif rec.get("error"):
            problems.append(PerfProblem("program_error", name, f"failed: {rec['error']}"))
        elif timed:
            limit = float(b["execute_median_s"]) * tol
            if float(rec["execute_median_s"]) > limit:
                problems.append(PerfProblem(
                    "slower", name, f"execute median {rec['execute_median_s']:.6f}s > "
                    f"{limit:.6f}s (baseline {b['execute_median_s']:.6f}s x {tol:g})"))
    new = sorted(set(recs) - set(baseline.get("programs", {})))
    if new:
        notices.append(f"{len(new)} program(s) not in the baseline (pin again with "
                       f"--write-baseline): {', '.join(new[:8])}"
                       + ("..." if len(new) > 8 else ""))
    if not timed:
        notices.append(f"timing ratchet skipped ({perf_doc.get('device_kind')!r} against "
                       f"the baseline's {baseline.get('device_kind')!r}, timing={timing}); "
                       "structural rules only")
    return problems, notices
