"""Audit orchestration: all five engines, the baseline ratchet, and
the versioned ``audit.json`` report (the JAX package's analysis/runner.py
over the port's tree: ``peasoup_tpu_torch/``, ``chip_smoke.py`` and
``ab_grids.py``).

The engines:

1. **AST lints** — the PSA rules (:mod:`.rules`) over every file.
2. **Program contracts** (:mod:`.contracts`) — every registered
   program run under an op recorder at its representative shapes AND
   at every rung of the campaign bucket ladder (``--no-ladder`` skips
   the rungs), on ``device``.
3. **Concurrency / file protocols** — the PSP rules
   (:mod:`.protocol`); operationally part of the AST pass but
   separately gated (``--no-protocol``).
4. **Kernel contracts** (:mod:`.kernels`) — every CUDA kernel
   registered, its wrapper and plain version resolved with no
   fallback, the plain versions and host maps on the CPU, and on the
   card each kernel built, launched and held against its plain version
   at its registry geometry and the ladder's rungs.
5. **Protocol model checking** (:mod:`.mc`) — the PSM rules: the
   real queue/registry/tenants/alerts code run against a virtual
   filesystem under exhaustive interleaving + crash-point
   exploration, scenario invariants asserted after every complete
   schedule. Off by default in the Python API (it executes module
   code, not just reads it); the CLI runs it unless ``--no-mc``.

The report is a machine-readable manifest like the telemetry one:
versioned, schema-pinned by a checked-in JSON Schema
(``analysis/audit.schema.json``) and validated by the port's
dependency-free validator (:mod:`peasoup_tpu_torch.obs.schema`) before
it is written — the audit cannot emit a report that its own consumers
would reject.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .astlint import lint_path, rule_classes
from .findings import Baseline, Finding

AUDIT_SCHEMA = "peasoup_tpu_torch.audit"
AUDIT_VERSION = 3  # v3: mc engine (interleaving/crash model checking)

AUDIT_SCHEMA_PATH = os.path.join(
    os.path.dirname(__file__), "audit.schema.json"
)

# directories never scanned by the AST engine
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


# the port's scripts at the root of the repo, audited beside the package
ROOT_SCRIPTS = ("chip_smoke.py", "ab_grids.py")


def package_files(root: str) -> list[tuple[str, str]]:
    """(abspath, relpath) for every .py file under <root>/peasoup_tpu_torch,
    and the port's scripts at the root."""
    pkg = os.path.join(root, "peasoup_tpu_torch")
    out = [(os.path.join(root, f), f) for f in ROOT_SCRIPTS
           if os.path.exists(os.path.join(root, f))]
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            ap = os.path.join(dirpath, fname)
            rp = os.path.relpath(ap, root).replace(os.sep, "/")
            out.append((ap, rp))
    return sorted(out)


@dataclass
class AuditResult:
    findings: list[Finding] = field(default_factory=list)  # active
    new: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    resolved: list[str] = field(default_factory=list)
    suppressed: int = 0
    files_scanned: int = 0
    programs_checked: list[str] = field(default_factory=list)
    kernels_checked: list[str] = field(default_factory=list)
    ladder_rungs: list[int] = field(default_factory=list)
    ladder_coverage: dict[str, list[int]] = field(default_factory=dict)
    rules: list[str] = field(default_factory=list)
    mc_scenarios: list[str] = field(default_factory=list)
    mc: dict = field(default_factory=dict)  # MCReport.to_doc()
    device: str = "cpu"
    # kernel -> the kernel engine's record (KernelReport.checks)
    kernel_checks: dict[str, dict] = field(default_factory=dict)
    # program -> synchronising operations counted on the card
    sync_warnings: dict[str, int] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.new

    def to_manifest(self) -> dict:
        return {
            "schema": AUDIT_SCHEMA,
            "version": AUDIT_VERSION,
            "device": self.device,
            "summary": {
                "new": len(self.new),
                "baselined": len(self.baselined),
                "resolved": len(self.resolved),
                "suppressed": self.suppressed,
                "files_scanned": self.files_scanned,
                "programs_checked": len(self.programs_checked),
                "kernels_checked": len(self.kernels_checked),
                "ladder_rungs": len(self.ladder_rungs),
                "mc_scenarios": len(self.mc_scenarios),
            },
            "rules": sorted(self.rules),
            "programs": sorted(self.programs_checked),
            "kernels": sorted(self.kernels_checked),
            "kernel_checks": {k: dict(v) for k, v in sorted(self.kernel_checks.items())},
            "sync_warnings": dict(sorted(self.sync_warnings.items())),
            "ladder": {
                "rungs": list(self.ladder_rungs),
                "coverage": {
                    k: list(v)
                    for k, v in sorted(self.ladder_coverage.items())
                },
            },
            "mc": dict(self.mc),
            "findings": [f.to_json() for f in self.findings],
            "resolved_fingerprints": sorted(self.resolved),
        }


def _engine_rule_ids(rule_ids, protocol: bool, kernels: bool):
    """Resolve the AST pass's rule set from the explicit ``--rules``
    filter and the engine toggles (PSP = engine 3, static PSK =
    engine 4)."""
    classes = rule_classes()
    selected = set(classes) if rule_ids is None else set(rule_ids)
    if rule_ids is not None:
        unknown = selected - set(classes)
        if unknown:
            raise ValueError(f"unknown rule ids: {sorted(unknown)}")
    if not protocol:
        selected -= {r for r in selected if r.startswith("PSP")}
    if not kernels:
        selected -= {r for r in selected if r.startswith("PSK")}
    return sorted(selected)


def run_audit(
    root: str,
    *,
    rule_ids=None,
    ast_engine: bool = True,
    contracts: bool = True,
    protocol: bool = True,
    kernels: bool = True,
    ladder: bool = True,
    ladder_rung_count: int | None = None,
    baseline_path: str | None = None,
    max_const_bytes: int | None = None,
    kernel_specs=None,
    program_specs=None,
    mc: bool = False,
    mc_scenarios: list[str] | None = None,
    mc_budget: int | None = None,
    device: str = "cpu",
) -> AuditResult:
    """Run the five engines over the repo at ``root`` and apply the
    baseline ratchet. Engine/internal errors propagate (the CLI maps
    them to exit 2); per-file, per-program and per-kernel problems
    become findings. ``kernel_specs``/``program_specs`` override the
    real registries (tests inject doctored specs; ``kernel_specs`` names
    the kernels to check). ``device`` runs the programs and kernels there
    (``"cuda"`` raises without a card). Engine 5 (``mc``)
    defaults OFF here — it executes the protocol modules under a
    scheduler rather than reading source — and ON in the CLI;
    ``mc_scenarios`` selects a subset by name, ``mc_budget`` caps
    schedules explored per scenario."""
    result = AuditResult(device=device)
    findings: list[Finding] = []
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA device; give --device cpu "
                               "to audit on the CPU")

    effective_rules = _engine_rule_ids(rule_ids, protocol, kernels)
    result.rules = effective_rules

    if ast_engine:
        for abspath, relpath in package_files(root):
            file_findings, nsup = lint_path(
                abspath, relpath, effective_rules
            )
            findings.extend(file_findings)
            result.suppressed += nsup
            result.files_scanned += 1

    from .contracts import DEFAULT_LADDER_RUNGS, ladder_rungs

    rungs = ladder_rungs(count=ladder_rung_count or DEFAULT_LADDER_RUNGS)
    if contracts:
        from .contracts import (
            ContractConfig,
            audit_programs,
            audit_programs_ladder,
        )

        cfg = ContractConfig(device=device)
        if max_const_bytes is not None:
            cfg.max_const_bytes = max_const_bytes
        report = audit_programs(specs=program_specs, cfg=cfg)
        findings.extend(report.findings)
        result.programs_checked = report.programs
        result.sync_warnings.update(report.sync_warnings)
        if ladder:
            lrep = audit_programs_ladder(specs=program_specs, rungs=rungs, cfg=cfg)
            findings.extend(lrep.findings)
            result.sync_warnings.update(lrep.sync_warnings)
            result.ladder_rungs = lrep.rungs
            result.ladder_coverage = lrep.coverage

    if kernels:
        from .kernels import audit_kernels

        krep = audit_kernels(names=kernel_specs, device=device,
                             rungs=rungs if ladder else [])
        findings.extend(krep.findings)
        result.kernels_checked = krep.kernels
        result.kernel_checks = krep.checks

    if mc:
        from .mc.scenarios import run_mc

        mrep = run_mc(names=mc_scenarios, budget=mc_budget)
        findings.extend(mrep.findings)
        result.mc = mrep.to_doc()
        result.mc_scenarios = [
            p["name"] for p in mrep.per_scenario
        ]

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    result.findings = findings

    baseline = Baseline()
    if baseline_path is not None and os.path.exists(baseline_path):
        baseline = Baseline.load(baseline_path)
    result.new, result.baselined, result.resolved = baseline.apply(findings)
    return result


def write_report(result: AuditResult, path: str) -> None:
    """Validate against the checked-in schema, then write atomically."""
    from ..obs.schema import validate

    man = result.to_manifest()
    with open(AUDIT_SCHEMA_PATH) as f:
        validate(man, json.load(f))
    from .findings import _atomic_write_json

    _atomic_write_json(path, man)


def render_text(result: AuditResult, verbose: bool = False) -> str:
    """Human report: new findings in full, baselined summarised."""
    lines: list[str] = []
    for f in result.new:
        lines.append(f.render())
    if result.baselined:
        if verbose:
            lines.extend(f.render() for f in result.baselined)
        else:
            per_rule: dict[str, int] = {}
            for f in result.baselined:
                per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
            summary = ", ".join(
                f"{r}x{n}" for r, n in sorted(per_rule.items())
            )
            lines.append(
                f"{len(result.baselined)} baselined finding(s) "
                f"({summary}) — tolerated, ratchet down with "
                "--write-baseline after fixing"
            )
    if result.resolved:
        lines.append(
            f"{len(result.resolved)} baseline entr(ies) no longer "
            "match — run --write-baseline to ratchet the debt down"
        )
    lines.append(
        f"peasoup-audit: {len(result.new)} new, "
        f"{len(result.baselined)} baselined, "
        f"{result.suppressed} suppressed; "
        f"{result.files_scanned} files, "
        f"{len(result.programs_checked)} programs"
        + (
            f" (+{len(result.ladder_rungs)} ladder rungs)"
            if result.ladder_rungs
            else ""
        )
        + f", {len(result.kernels_checked)} kernels"
        + (
            f", {len(result.mc_scenarios)} mc scenarios "
            f"({result.mc.get('schedules', 0)} schedules, "
            f"{result.mc.get('crash_points', 0)} crash points)"
            if result.mc_scenarios
            else ""
        )
    )
    return "\n".join(lines)
