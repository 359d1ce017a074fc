"""``peasoup-audit`` — the static-analysis gate over the port (the JAX
package's tools/audit.py).

Runs the five engines over ``peasoup_tpu_torch/``, ``chip_smoke.py`` and
``ab_grids.py`` — AST hazard lints (PSA), program contracts at
representative AND campaign-bucket-ladder shapes (PSC),
concurrency/file-protocol lints (PSP), CUDA kernel contracts (PSK: on
the card every kernel built, launched and held against its plain
version), and protocol model checking (PSM: the real
queue/registry/tenants/alerts code explored under exhaustive
interleavings and crash points against a virtual filesystem) —
applies the baseline ratchet, prints a human report and optionally
writes the versioned ``audit.json``. It runs on the card unless
``--device cpu`` is given, and raises (exit 2) where there is no card.

Exit codes:

* ``0`` — clean: no findings outside the baseline
* ``1`` — new findings (or, with ``--strict-resolved``, stale baseline
  entries that should be ratcheted down)
* ``2`` — internal error (engine crash, unreadable baseline, bad args)

Usage::

    python -m peasoup_tpu_torch.tools.audit \\
        --baseline peasoup_tpu_torch/analysis/audit_baseline.json
    python -m peasoup_tpu_torch.tools.audit --device cpu --baseline ...
    python -m peasoup_tpu_torch.tools.audit --list-rules
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback


def _repo_root() -> str:
    # tools/ -> peasoup_tpu_torch/ -> repo root
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-audit",
        description=(
            "the port's static-analysis gate: AST lints, program and "
            "kernel contracts, protocol model checking"
        ),
    )
    p.add_argument(
        "--root",
        default=_repo_root(),
        help="repo root to audit (default: the installed tree)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help="ratchet baseline JSON (missing file = empty baseline)",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite --baseline from the current findings and exit 0",
    )
    p.add_argument(
        "--json",
        dest="json_path",
        default=None,
        metavar="PATH",
        help="write the versioned audit.json report here",
    )
    p.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule IDs to run (default: all)",
    )
    p.add_argument(
        "--no-contracts",
        action="store_true",
        help="skip engine 2 (program contract checks, ladder included)",
    )
    p.add_argument(
        "--no-ast",
        action="store_true",
        help="skip engine 1 (AST lints; also disables the PSP/PSK "
        "static rules)",
    )
    p.add_argument(
        "--no-protocol",
        action="store_true",
        help="skip engine 3 (PSP concurrency/file-protocol rules)",
    )
    p.add_argument(
        "--no-kernels",
        action="store_true",
        help="skip engine 4 (PSK kernel contracts: registry, wrappers, "
        "and on the card every kernel built, launched and matched)",
    )
    p.add_argument(
        "--no-mc",
        action="store_true",
        help="skip engine 5 (PSM protocol model checking: exhaustive "
        "interleaving + crash-point exploration of the file-backed "
        "protocols)",
    )
    p.add_argument(
        "--mc-scenarios",
        default=None,
        metavar="NAMES",
        help="comma-separated mc scenario names to run "
        "(default: the whole library)",
    )
    p.add_argument(
        "--mc-budget",
        type=int,
        default=None,
        metavar="N",
        help="max schedules explored per mc scenario (default 400)",
    )
    p.add_argument(
        "--no-ladder",
        action="store_true",
        help="skip the bucket-ladder contract pass (representative "
        "shapes still checked)",
    )
    p.add_argument(
        "--ladder-rungs",
        type=int,
        default=None,
        metavar="N",
        help="number of bucket-ladder rungs to trace (default 2)",
    )
    p.add_argument(
        "--max-const-bytes",
        type=int,
        default=None,
        help="baked-in constant size threshold (default 1 MiB)",
    )
    p.add_argument(
        "--strict-resolved",
        action="store_true",
        help="fail (exit 1) when baseline entries no longer match",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="where programs and kernels run: cuda (default; raises "
        "without a card) or cpu (the kernels' card leg not attempted)",
    )
    p.add_argument(
        "-v",
        "--verbose",
        action="store_true",
        help="print baselined findings in full",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule table and exit",
    )
    return p


def _list_rules() -> int:
    from peasoup_tpu_torch.analysis.astlint import rule_classes
    from peasoup_tpu_torch.analysis.kernels import EXCLUDED_RULES as PSK_EXCLUDED
    from peasoup_tpu_torch.analysis.rules import EXCLUDED_RULES as PSA_EXCLUDED

    for rule_id, cls in sorted(rule_classes().items()):
        print(f"{rule_id}  [{cls.severity:7s}]  {cls.title}")
        if cls.fix_hint:
            print(f"        hint: {cls.fix_hint}")
    print(
        "PSC101-PSC106 (contract engine): f64 ops, host syncs the "
        "program does not declare, oversized host-to-device copies inside "
        "the call, in-place writes off the donate declaration, run "
        "failure, missing bucket-ladder coverage (representative + "
        "ladder-rung shapes)"
    )
    print(
        "PSK201/PSK202/PSK203/PSK208 (kernel engine, dynamic): a kernel "
        "without a registry entry, registry drift or a wrapper that falls "
        "back to its plain version, the plain version or host maps failing "
        "on the CPU, a kernel that does not build for sm_90a, launch or "
        "match its plain version on the card (--device cuda)"
    )
    print(
        "PSM300-PSM308 (mc engine, dynamic): protocol model checking "
        "— scenario invariant violations found by exhaustive "
        "interleaving + crash-point exploration of the real "
        "queue/registry/tenants/alerts code over a virtual "
        "filesystem. PSM300 internal (task crash/deadlock), PSM301 "
        "exactly-once claim/complete (complete_vs_claim: a completer "
        "against a second worker's claims), PSM302 crash-recovery reap, "
        "PSM303 renew/release-vs-reap ownership, PSM304 preemption "
        "handoff, PSM305 gang assembly, PSM306 registry liveness, "
        "PSM307 tenant throttling, PSM308 alerts lock/journal. Each "
        "finding embeds its minimized schedule; replay with "
        "peasoup_tpu_torch.analysis.mc.replay for a bit-identical trace"
    )
    print("Excluded (the JAX package's rules with no counterpart in the port):")
    for rule_id, why in sorted({**PSA_EXCLUDED, **PSK_EXCLUDED}.items()):
        print(f"{rule_id}  [excluded]  {why}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        return _list_rules()
    try:
        from peasoup_tpu_torch.analysis.findings import Baseline
        from peasoup_tpu_torch.analysis.runner import (
            render_text,
            run_audit,
            write_report,
        )

        rule_ids = None
        if args.rules:
            rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        mc_names = None
        if args.mc_scenarios:
            mc_names = [
                n.strip()
                for n in args.mc_scenarios.split(",")
                if n.strip()
            ]
        result = run_audit(
            args.root,
            rule_ids=rule_ids,
            ast_engine=not args.no_ast,
            contracts=not args.no_contracts,
            protocol=not args.no_protocol,
            kernels=not args.no_kernels,
            ladder=not args.no_ladder,
            ladder_rung_count=args.ladder_rungs,
            baseline_path=args.baseline,
            max_const_bytes=args.max_const_bytes,
            mc=not args.no_mc,
            mc_scenarios=mc_names,
            mc_budget=args.mc_budget,
            device=args.device,
        )
        if args.write_baseline:
            if not args.baseline:
                print(
                    "peasoup-audit: --write-baseline requires --baseline",
                    file=sys.stderr,
                )
                return 2
            Baseline.from_findings(result.findings).save(args.baseline)
            print(
                f"peasoup-audit: baseline written to {args.baseline} "
                f"({len(result.findings)} finding(s) tolerated)"
            )
            return 0
        if args.json_path:
            write_report(result, args.json_path)
        print(render_text(result, verbose=args.verbose))
        if result.new:
            return 1
        if args.strict_resolved and result.resolved:
            return 1
        return 0
    except Exception:
        traceback.print_exc()
        print("peasoup-audit: internal error (exit 2)", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
