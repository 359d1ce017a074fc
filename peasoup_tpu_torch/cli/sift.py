"""`peasoup-sift` CLI of the PyTorch / CUDA port: survey-scale candidate
sifting over a campaign database, flag-compatible with the JAX package's
``peasoup-sift``, plus ``--device``.

    # sift a campaign (re-dedisperses each observation on the card)
    python -m peasoup_tpu_torch.cli.sift run -w camp/

    # the survey report: self-contained HTML + schema-valid JSON
    python -m peasoup_tpu_torch.cli.sift report -w camp/ \\
        -o camp/sift/report.html --json camp/sift/report.json

``run`` writes the ``sift_*`` tables into ``<workdir>/candidates.sqlite``
(the latest run replaces the previous product wholesale); the database
may have been written by either package. It runs on the CUDA device
unless ``--device cpu`` is given. As in the JAX CLI, ``run`` writes its
live heartbeat to ``<workdir>/sift/status.json`` (or ``--status-json``)
and its manifest, with the ``sift`` status section, to
``<workdir>/sift/telemetry.json`` (or ``--metrics-json``). ``report``
folds in the campaign rollup (``<workdir>/campaign_status.json``, written
by either package's ``peasoup-campaign``) as the JAX CLI does. The report
links no DM-time bowtie plot (``tools/plotting``, ROADMAP A.10).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from . import add_observability_args, init_observability, live_observability


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-sift",
        description="Peasoup survey sifting - batched folding, known-source "
        "cross-match, campaign-level dedup, multi-beam vetoing and repeat "
        "single-pulse association over the campaign candidate database "
        "(PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser(
        "run", help="sift the campaign database end to end and write the sift_* tables",
    )
    run.add_argument("-w", "--workdir", required=True,
                     help="campaign directory (holds candidates.sqlite)")
    run.add_argument("--db", default="",
                     help="explicit candidates.sqlite path (default "
                     "<workdir>/candidates.sqlite)")
    run.add_argument("--config", default=None,
                     help="SiftConfig overrides as inline JSON or @file.json")
    run.add_argument("--catalogue", default="",
                     help="known-pulsar catalogue JSON (default: the checked-in "
                     "convenience catalogue)")
    run.add_argument("--no-fold", action="store_true",
                     help="skip the batched survey folding pass (cross-match/dedup "
                     "then use the search periods)")
    run.add_argument("--incremental", action="store_true",
                     help="no-op (exit 0) unless new observations landed in the "
                     "campaign DB since the last sift run's watermark")
    run.add_argument("--fold-batch", type=int, default=None,
                     help="candidates per fixed fold batch (default 64)")
    run.add_argument("--tenant", default="",
                     help="sift only observations stamped with this tenant")
    run.add_argument("--device", default="cuda",
                     help="torch device to sift on (default cuda; cpu runs every "
                     "kernel's plain version)")
    run.add_argument("-v", "--verbose", action="store_true")
    add_observability_args(run)

    rep = sub.add_parser(
        "report", help="render the survey report from the sifted database",
    )
    rep.add_argument("-w", "--workdir", required=True)
    rep.add_argument("--db", default="")
    rep.add_argument("-o", "--html", default=None,
                     help="self-contained HTML output path (default "
                     "<workdir>/sift/report.html)")
    rep.add_argument("--json", dest="json_out", default=None,
                     help="schema-validated JSON report path (default "
                     "<workdir>/sift/report.json)")
    rep.add_argument("--limit", type=int, default=50,
                     help="catalogue rows included (default 50)")
    rep.add_argument("--tenant", default="",
                     help="report only rows touching this tenant's observations")
    rep.add_argument("--print-summary", action="store_true",
                     help="also print the tally to stdout")
    return p


def _load_config_arg(text: str | None) -> dict:
    if not text:
        return {}
    if text.startswith("@"):
        with open(text[1:]) as f:
            return json.load(f)
    return json.loads(text)


def _cmd_run(args) -> int:
    from ..campaign.db import CandidateDB
    from ..device import resolve_device
    from ..sift.service import SiftConfig, SiftRun

    device = resolve_device(args.device)
    overrides = _load_config_arg(args.config)
    names = {f.name for f in dataclasses.fields(SiftConfig)}
    unknown = set(overrides) - names
    if unknown:
        print(f"peasoup-sift: unknown SiftConfig keys {sorted(unknown)}", file=sys.stderr)
        return 2
    overrides["workdir"] = args.workdir
    if args.db:
        overrides["db_path"] = args.db
    if args.catalogue:
        overrides["catalogue"] = args.catalogue
    if args.no_fold:
        overrides["fold"] = False
    if args.fold_batch:
        overrides["fold_batch"] = args.fold_batch
    if args.tenant:
        overrides["tenant"] = args.tenant
    cfg = SiftConfig(**overrides)

    if args.incremental:
        # before any side effect: with no new observations since the last
        # run's watermark, exit 0 without touching anything
        db_path = cfg.resolved_db()
        if os.path.exists(db_path):
            with CandidateDB(db_path) as db:
                latest = db.latest_sift_run()
                prev_wm = None
                if latest:
                    try:
                        prev_wm = json.loads(latest.get("config") or "{}").get(
                            "watermark_rowid")
                    except ValueError:
                        prev_wm = None
                if prev_wm is not None and db.max_observation_rowid() <= int(prev_wm):
                    print(
                        "peasoup-sift run: no new observations since run "
                        f"{latest['run_id']} (watermark rowid {int(prev_wm)}); "
                        "nothing to do"
                    )
                    return 0

    sift_dir = os.path.join(args.workdir, "sift")
    os.makedirs(sift_dir, exist_ok=True)
    if not args.status_json:
        args.status_json = os.path.join(sift_dir, "status.json")
    manifest_path = args.metrics_json or os.path.join(sift_dir, "telemetry.json")
    tel = init_observability(args)
    tel.set_context(command="sift", workdir=os.path.abspath(args.workdir),
                    db=cfg.resolved_db())
    with tel.activate(), live_observability(tel, args, sift_dir, manifest_path):
        run = SiftRun(cfg, device=device)
        with tel.device_capture(device):
            summary = run.run()
        tel.write(manifest_path)
    print(
        f"peasoup-sift run {summary['run_id']}: "
        f"{summary['n_folded']} folded, "
        f"{summary['n_catalogue']} catalogue rows "
        f"({summary['n_known']} known, {summary['n_rfi']} rfi), "
        f"{summary['n_sp_sources']} repeat single-pulse source(s) "
        f"over {summary['observations']} observations "
        f"in {summary['duration_s']:.1f}s"
    )
    print("peasoup-sift timers (s): " + json.dumps(run.timers, sort_keys=True))
    print("peasoup-sift fold buckets: " + json.dumps(run.fold_buckets, sort_keys=True))
    return 0


def _cmd_report(args) -> int:
    from ..campaign.db import DB_FILENAME, CandidateDB
    from ..sift.report import build_report, write_report

    db_path = args.db or os.path.join(args.workdir, DB_FILENAME)
    if not os.path.exists(db_path):
        print(f"peasoup-sift: no database at {db_path}", file=sys.stderr)
        return 2
    campaign_status = None
    status_path = os.path.join(args.workdir, "campaign_status.json")
    if os.path.exists(status_path):
        try:
            from ..campaign.rollup import load_campaign_status

            campaign_status = load_campaign_status(status_path)
        except Exception as exc:
            print(
                f"peasoup-sift: ignoring unreadable rollup "
                f"{status_path}: {exc}", file=sys.stderr,
            )
    sift_dir = os.path.join(args.workdir, "sift")
    html_path = args.html or os.path.join(sift_dir, "report.html")
    json_path = args.json_out or os.path.join(sift_dir, "report.json")
    with CandidateDB(db_path) as db:
        doc = build_report(db, campaign_status, limit=args.limit,
                           tenant=args.tenant or None)
    print("peasoup-sift: bowtie plot skipped: tools/plotting is ROADMAP item A.10",
          file=sys.stderr)
    write_report(doc, json_path, html_path, bowtie_href=None)
    print(f"peasoup-sift report: {json_path} + {html_path}")
    if args.print_summary:
        run = doc["run"]
        print(
            f"  run {run['run_id']}: {run['n_catalogue']} catalogue "
            f"rows, {run['n_known']} known, {run['n_rfi']} rfi, "
            f"{run['n_sp_sources']} repeat SP source(s); tiers "
            + ", ".join(f"t{k}={v}" for k, v in sorted(doc["tiers"].items()))
        )
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return {"run": _cmd_run, "report": _cmd_report}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
