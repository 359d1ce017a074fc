"""Static analysis of the port: ``peasoup-audit`` (the JAX package's
analysis/, over ``peasoup_tpu_torch/``, ``chip_smoke.py`` and
``ab_grids.py``).

Five engines, one report:

* **AST lints** (:mod:`.astlint`, PSA rules in :mod:`.rules`): a small
  rule-plugin framework over :mod:`ast` that encodes the hazards this
  codebase stakes runtime guarantees on — host syncs inside device-code
  loops, float64 in device code, dtype-less ``np.array`` literals,
  non-atomic writes to files the obs/campaign layers rewrite
  atomically, thread-shared state mutated outside a lock,
  ``time.time()`` where ``perf_counter`` is required. The rules that
  read JAX traces are stated exclusions (``rules.EXCLUDED_RULES``).
* **Program contracts** (:mod:`.contracts` over
  :mod:`peasoup_tpu_torch.ops.registry`, PSC rules): every registered
  program runs under a recording dispatch mode — no f64 ops, no host
  syncs it does not declare, no oversized host-to-device copies inside
  the call, in-place writes matching what the registry declares — at
  its representative shapes AND at every rung of the campaign bucket
  ladder (via each program's ShapeCtx hook; PSC106 gates the coverage).
* **Concurrency / file protocols** (:mod:`.protocol`, PSP rules): the
  fleet's filesystem and threading protocols — shared-artifact writes
  ride a sanctioned atomic idiom (O_EXCL create, tmp + ``os.replace``,
  a private tmp file published by ``os.link``, append-only), corrupt
  artifacts quarantine by rename, durability-marked writers fsync
  before publishing, every thread body runs under ``guard_thread``,
  lock-owned attributes never mutate lock-free, and ambient telemetry
  never crosses a thread boundary uncopied.
* **Kernel contracts** (:mod:`.kernels`, PSK rules): every CUDA kernel
  registered (PSK201), its wrapper, plain version and registry entry
  resolving with no fallback (PSK202), its plain version and the host
  maps sound on the CPU (PSK203), and on the card built for ``sm_90a``,
  launched and held against its plain version (PSK208).
* **Protocol model checking** (:mod:`.mc`, PSM rules): the real
  queue/registry/tenants/alerts code under exhaustive interleavings and
  crash points against a virtual filesystem.

Findings ratchet against a checked-in JSON baseline
(``peasoup_tpu_torch/analysis/audit_baseline.json``): existing debt is
tolerated, anything new fails the gate. Per-line suppression:
``# audit: ignore[PSA006] -- reason`` (the reason is mandatory; a
bare suppression is inactive).

CLI: ``python -m peasoup_tpu_torch.tools.audit`` (exit 0 clean, 1 new
findings, 2 internal error; ``--device cpu`` off the card).
"""

from .findings import Finding, Baseline
from .astlint import lint_source, lint_path, ModuleContext
from .rules import all_rules
from .contracts import (
    ContractConfig,
    audit_program,
    audit_programs,
    audit_programs_ladder,
    ladder_rungs,
    ladder_shape_ctxs,
)
from .kernels import audit_kernels, check_wrapper
from .runner import AuditResult, run_audit, render_text

__all__ = [
    "Finding",
    "Baseline",
    "ModuleContext",
    "lint_source",
    "lint_path",
    "all_rules",
    "ContractConfig",
    "audit_program",
    "audit_programs",
    "audit_programs_ladder",
    "ladder_rungs",
    "ladder_shape_ctxs",
    "check_wrapper",
    "audit_kernels",
    "AuditResult",
    "run_audit",
    "render_text",
]
