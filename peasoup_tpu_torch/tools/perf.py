"""``peasoup-perf`` of the PyTorch / CUDA port (the JAX package's
tools/perf.py): warmup, microbenchmarks, the regression ratchet and the
dedispersion tuner, on the card unless ``--device cpu`` is given.

    python -m peasoup_tpu_torch.tools.perf tune --bucket 64,2,3145728,6.4e-05,1500,-4.6875 \\
        --config '{"dm_end": 20}'

Subcommands:

* ``warmup`` - build and load every kernel, and run each registered
  program once (ops/registry.py); a second process builds no kernel.
* ``bench`` - time each registered program (median of k, CUDA events on
  the card) into a ``perf.json`` that names the card and its power limit.
* ``check`` - ratchet a ``perf.json`` against the port's baseline
  (peasoup_tpu_torch/perf/perf_baseline.json): the program set, each
  program running, every kernel and every counterpart of the JAX registry
  registered, a warm pass that builds no kernel, and, on the card the
  baseline names, the timings.
* ``tune`` - resolve (and on a cold cache measure) the dedispersion plan
  of one shape bucket into ``tuning_cache.json`` (perf/tuning.py), the
  offline form of what ``--tune`` does; ``--list`` and ``--prune`` keep
  the cache.

Exit codes, the JAX package's: 0 clean, 1 regression (or a missing,
broken or unregistered program), 2 internal error (bad arguments,
unreadable files, a failed measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from ..perf.ratchet import BASELINE_PATH


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-perf",
        description="warmup, microbenchmarks, the perf ratchet and the dedispersion "
        "tuner of the PyTorch / CUDA port",
    )
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="device to run on (default cuda; cpu for the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("warmup", parents=[common], help="build every kernel and run each registered "
                       "program once")
    w.add_argument("--programs", default=None,
                   help="comma-separated program names (default: all)")
    w.add_argument("--json", dest="json_path", default=None, metavar="PATH",
                   help="also write the warmup report as JSON")

    b = sub.add_parser("bench", parents=[common], help="microbenchmark every registered program")
    b.add_argument("-o", "--output", default="perf.json",
                   help="perf.json output path (default ./perf.json)")
    b.add_argument("--reps", type=int, default=5,
                   help="timed executions per program (median reported; default 5)")
    b.add_argument("--programs", default=None,
                   help="comma-separated program names (default: all)")

    c = sub.add_parser("check", parents=[common], help="ratchet a perf.json against the baseline")
    c.add_argument("--perf", default="perf.json",
                   help="perf.json to check (default ./perf.json)")
    c.add_argument("--baseline", default=BASELINE_PATH,
                   help="baseline (default: the port's perf/perf_baseline.json)")
    c.add_argument("--timing", choices=("auto", "on", "off"), default="auto",
                   help="timing ratchet: auto = only on the baseline's card "
                   "(default), on = always, off = structural only")
    c.add_argument("--no-warm", action="store_true",
                   help="skip the warm invariant (a warm pass builds no kernel)")
    c.add_argument("--write-baseline", action="store_true",
                   help="re-pin --baseline from the perf.json and exit 0")

    t = sub.add_parser("tune", parents=[common], help="tune the dedispersion plan of one shape bucket "
                       "into the tuning cache (or --list/--prune its entries)")
    t.add_argument("--bucket", default=None,
                   help="shape bucket as nchans,nbits,nsamps,tsamp,fch1,foff "
                   "(the campaign bucket key fields)")
    t.add_argument("--list", dest="list_entries", action="store_true",
                   help="list cached plans with fingerprint, knobs and age")
    t.add_argument("--prune", action="store_true",
                   help="remove entries under stale fingerprints (not this device); "
                   "with --older-than-days also age-prune everything else")
    t.add_argument("--older-than-days", type=float, default=None,
                   help="with --prune: also remove entries older than this many days "
                   "on any fingerprint (entries without a stamp count as infinitely old)")
    t.add_argument("--keep-stale", action="store_true",
                   help="with --prune: keep other devices' entries (age-prune only)")
    t.add_argument("--dry-run", action="store_true",
                   help="with --prune: report what would go without rewriting")
    t.add_argument("--pipeline", default="search", choices=("search", "spsearch"))
    t.add_argument("--config", default="{}",
                   help="pipeline config overrides as inline JSON "
                   "(dm_end, subband_smear, subband_snr_loss, ...)")
    t.add_argument("--cache", default=None,
                   help="tuning_cache.json path (default: the per-user cache)")
    t.add_argument("--reps", type=int, default=3,
                   help="timed samples per tuner candidate (median; default 3)")
    t.add_argument("--force", action="store_true",
                   help="measure again even where the cache holds a plan for this "
                   "(device, bucket)")
    return p


def _programs(arg):
    return [s.strip() for s in arg.split(",") if s.strip()] if arg else None


def _cmd_warmup(args) -> int:
    from ..perf.warmup import warm_registry

    rep = warm_registry(programs=_programs(args.programs), device=args.device)
    for pw in rep.programs:
        state = "ERROR " + pw.error if pw.error else "ran"
        print(f"  {pw.name}: {pw.seconds:.3f}s  {state}")
    print(f"peasoup-perf warmup: {len(rep.programs)} programs in {rep.seconds:.1f}s on "
          f"{rep.device}; kernels built in this process: {rep.built or 'none'}, found "
          f"built: {rep.found}")
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(rep.to_doc(), f, indent=2)
            f.write("\n")
    return 1 if rep.errors else 0


def _cmd_bench(args) -> int:
    from ..perf.microbench import run_microbench, write_perf

    doc = run_microbench(reps=args.reps, programs=_programs(args.programs),
                         device=args.device)
    write_perf(doc, args.output)
    for name, rec in sorted(doc["programs"].items()):
        if rec["error"]:
            print(f"  {name}: ERROR {rec['error']}")
        else:
            print(f"  {name}: first call {rec['compile_s'] * 1e3:8.1f} ms"
                  f"  execute {rec['execute_median_s'] * 1e6:10.1f} us")
    t = doc["totals"]
    print(f"peasoup-perf bench: {t['programs']} programs on {doc['backend']} "
          f"({doc['device_kind']}, power limit {doc['power_limit']}) in "
          f"{t['wall_s']:.1f}s -> {args.output}"
          + (f"  [{t['errors']} ERRORS]" if t["errors"] else ""))
    return 1 if t["errors"] else 0


def _cmd_check(args) -> int:
    from ..ops.registry import unregistered_programs
    from ..perf.microbench import load_perf
    from ..perf.ratchet import (
        PerfProblem, baseline_from_perf, check_perf, load_baseline, write_baseline,
    )

    perf_doc = load_perf(args.perf)
    if args.write_baseline:
        write_baseline(baseline_from_perf(perf_doc), args.baseline)
        n = len([r for r in perf_doc["programs"].values() if not r["error"]])
        print(f"peasoup-perf: baseline written to {args.baseline} ({n} program(s) "
              f"pinned on {perf_doc['device_kind']})")
        return 0
    if not os.path.exists(args.baseline):
        print(f"peasoup-perf: baseline {args.baseline} missing (create one with: "
              "check --write-baseline)", file=sys.stderr)
        return 2
    baseline = load_baseline(args.baseline)
    problems, notices = check_perf(perf_doc, baseline, timing=args.timing)
    for name, why in unregistered_programs():
        problems.append(PerfProblem("unregistered_entry_point", name, why))
    if not args.no_warm:
        from ..perf.warmup import warm_registry

        rep = warm_registry(programs=sorted(perf_doc["programs"]), device=args.device)
        for pw in rep.errors:
            problems.append(PerfProblem("program_error", pw.name, pw.error))
        if rep.built:
            problems.append(PerfProblem(
                "built_warm", ",".join(rep.built),
                "a warm pass built kernels straight after a bench: their libraries "
                "are not reused across processes"))
        notices.append(f"warm invariant: {len(rep.programs)} programs ran, kernels "
                       f"built {len(rep.built)}, found built {len(rep.found)}")
    for n in notices:
        print(f"note: {n}")
    for pr in problems:
        print(pr.render())
    if problems:
        print(f"peasoup-perf check: {len(problems)} problem(s)")
        return 1
    print(f"peasoup-perf check: OK ({len(baseline['programs'])} baseline programs, "
          f"{perf_doc['device_kind']})")
    return 0


def _fmt_age(age_s) -> str:
    if age_s is None:
        return "age unknown"
    if age_s >= 86400:
        return f"{age_s / 86400:.1f}d old"
    if age_s >= 3600:
        return f"{age_s / 3600:.1f}h old"
    return f"{age_s:.0f}s old"


def _render_entry(row: dict) -> str:
    knobs = f"dedisp_block={row['dedisp_block']}"
    if row.get("subbands"):
        knobs += f" subbands={row['subbands']}"
    return (f"  {row['fingerprint']}  {row['key']}  {row['engine']}  {knobs}  "
            f"[{row['source']}, {_fmt_age(row['age_s'])}"
            + (", STALE device]" if row["stale"] else "]"))


def _cmd_tune(args) -> int:
    from ..perf.tuning import (
        default_cache_path, device_fingerprint, list_entries, measurement_count,
        prune_cache, resolve_plan_for_bucket,
    )

    if sum(map(bool, (args.bucket, args.list_entries, args.prune))) != 1:
        print("peasoup-perf tune: give exactly one of --bucket, --list, --prune",
              file=sys.stderr)
        return 2
    path = args.cache or default_cache_path()
    if args.list_entries:
        rows = list_entries(args.cache, device=args.device)
        for row in rows:
            print(_render_entry(row))
        stale = sum(1 for r in rows if r["stale"])
        print(f"peasoup-perf tune --list: {len(rows)} entr"
              f"{'y' if len(rows) == 1 else 'ies'} in {path}"
              + (f" ({stale} under stale fingerprints)" if stale else ""))
        return 0
    if args.prune:
        removed = prune_cache(
            args.cache,
            older_than_s=(args.older_than_days * 86400.0
                          if args.older_than_days is not None else None),
            keep_stale=args.keep_stale, dry_run=args.dry_run, device=args.device,
        )
        for row in removed:
            print(_render_entry(row))
        print(f"peasoup-perf tune --prune: {'would remove' if args.dry_run else 'removed'} "
              f"{len(removed)} entr{'y' if len(removed) == 1 else 'ies'} from {path}")
        return 0
    parts = [s.strip() for s in args.bucket.split(",")]
    if len(parts) != 6:
        print("peasoup-perf tune: --bucket wants nchans,nbits,nsamps,tsamp,fch1,foff",
              file=sys.stderr)
        return 2
    bucket = (int(parts[0]), int(parts[1]), int(parts[2]),
              float(parts[3]), float(parts[4]), float(parts[5]))
    n0 = measurement_count()
    plan = resolve_plan_for_bucket(
        bucket, args.pipeline, json.loads(args.config), args.cache,
        reps=args.reps, force=args.force, device=args.device,
    )
    measured = measurement_count() - n0
    for k, v in plan.summary().items():
        print(f"  {k}: {v}")
    print(f"peasoup-perf tune: {plan.engine} plan for {args.pipeline} bucket "
          f"{args.bucket} on {device_fingerprint(args.device)} ({measured} measurements"
          + (", served from cache)" if plan.source == "cache" else ")"))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return {
            "warmup": _cmd_warmup,
            "bench": _cmd_bench,
            "check": _cmd_check,
            "tune": _cmd_tune,
        }[args.cmd](args)
    except Exception:
        traceback.print_exc()
        print("peasoup-perf: internal error (exit 2)", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
