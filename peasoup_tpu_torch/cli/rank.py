"""`peasoup-rank` CLI of the PyTorch / CUDA port: train, apply and gate the
candidate scorer, flag-compatible with the JAX package's ``peasoup-rank``,
plus ``--device``.

    # retrain the artifact from injected ground truth (deterministic
    # from the seed on one device)
    python -m peasoup_tpu_torch.cli.rank train -o model.json --seed 42

    # re-score a sifted campaign DB in place from its stored fold products
    python -m peasoup_tpu_torch.cli.rank score -w camp/

    # the gate: ROC AUC on a held-out injected ground-truth set
    python -m peasoup_tpu_torch.cli.rank eval --min-auc 0.95

``eval`` (also ``evaluate``) exits 2 when the shipped (or ``--model``)
artifact scores below ``--min-auc``. Every subcommand runs on the CUDA
device unless ``--device cpu`` is given. The JAX CLI's observability
flags are refused with NotImplementedError (ROADMAP A.10).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import add_observability_args, refuse_observability


def _common(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    sp.add_argument("-v", "--verbose", action="store_true")
    add_observability_args(sp)
    sp.set_defaults(parser=sp)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-rank",
        description="Peasoup candidate ranking - batched feature extraction over "
        "sift fold products, a calibrated scorer trained on injected ground "
        "truth, and the ROC gate it is held to (PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train + calibrate the scorer on injected "
                        "ground truth and write the model artifact")
    tr.add_argument("-o", "--output", default="model.json",
                    help="artifact output path (default model.json)")
    tr.add_argument("--seed", type=int, default=42,
                    help="training seed (same seed and device, same artifact)")
    tr.add_argument("--examples", type=int, default=1200,
                    help="injected training examples (default 1200)")
    tr.add_argument("--steps", type=int, default=400, help="gradient steps (default 400)")
    tr.add_argument("--hidden", type=int, default=16, help="hidden units (default 16)")
    tr.add_argument("--lr", type=float, default=0.05, help="learning rate (default 0.05)")
    tr.add_argument("--batch", type=int, default=64,
                    help="feature-extraction batch width (default 64)")
    _common(tr)

    sc = sub.add_parser("score", help="re-score a sifted campaign database in "
                        "place from its stored fold products")
    sc.add_argument("-w", "--workdir", required=True,
                    help="campaign directory (holds candidates.sqlite)")
    sc.add_argument("--db", default="", help="explicit candidates.sqlite path")
    sc.add_argument("--model", default="",
                    help="model artifact (default: the checked-in one)")
    sc.add_argument("--batch", type=int, default=64,
                    help="scoring batch width (default 64)")
    _common(sc)

    ev = sub.add_parser("eval", aliases=["evaluate"],
                        help="ROC/AUC gate on a held-out injected set (exit 2 below "
                        "--min-auc)")
    ev.add_argument("--model", default="",
                    help="model artifact (default: the checked-in one)")
    ev.add_argument("--min-auc", type=float, default=0.95,
                    help="minimum held-out ROC AUC (default 0.95)")
    ev.add_argument("--examples", type=int, default=600,
                    help="held-out injected examples (default 600)")
    ev.add_argument("--seed", type=int, default=20260806,
                    help="held-out injection seed (distinct from any training seed)")
    ev.add_argument("--json", dest="json_out", default=None,
                    help="also write the evaluation document here")
    _common(ev)
    return p


def _start(args):
    """Refuse the observability flags, resolve the device (raising where
    the card is asked for and missing) and set up logging."""
    import logging

    from ..device import resolve_device

    refuse_observability(args, args.parser)
    device = resolve_device(args.device)
    if args.verbose:
        logging.basicConfig(level=logging.INFO, format="%(name)s %(levelname)s %(message)s")
    return device


def _cmd_train(args) -> int:
    from ..rank.model import save_model_doc
    from ..rank.train import train_model

    device = _start(args)
    doc = train_model(
        seed=args.seed, n_examples=args.examples, steps=args.steps,
        hidden=args.hidden, lr=args.lr, batch=args.batch, device=device,
    )
    save_model_doc(doc, args.output)
    print(f"peasoup-rank train: {args.output} "
          f"({doc['fingerprint']}, train AUC {doc['train']['auc']:.4f})")
    return 0


def _cmd_score(args) -> int:
    import numpy as np

    from ..campaign.db import DB_FILENAME, CandidateDB
    from ..rank.model import RankModel, score_tier
    from ..rank.score import neutral_dm_curve, score_fold_products

    device = _start(args)
    db_path = args.db or os.path.join(args.workdir, DB_FILENAME)
    if not os.path.exists(db_path):
        print(f"peasoup-rank: no database at {db_path}", file=sys.stderr)
        return 2
    model = RankModel.from_file(args.model or None)
    with CandidateDB(db_path) as db:
        rows = [r for r in db.sift_catalogue() if r.get("fold_json")]
        if not rows:
            print("peasoup-rank score: no sift rows with fold products "
                  "(run peasoup-sift first)")
            return 0
        stamps = [json.loads(r["fold_json"]) for r in rows]
        prof = np.asarray([s["prof"] for s in stamps], dtype=np.float32)
        subints = np.asarray([s["subints"] for s in stamps], dtype=np.float32)
        dm_curve = neutral_dm_curve(len(rows))
        for i, s in enumerate(stamps):
            if s.get("dm_curve") is not None:
                dm_curve[i] = np.asarray(s["dm_curve"], dtype=np.float32)
        _feats, scores = score_fold_products(
            model, prof, subints, dm_curve, batch=args.batch, device=device
        )
        scored = [
            {
                "id": r["id"],
                "score": round(float(p), 6),
                "score_tier": score_tier(float(p)),
                "model_fp": model.fingerprint,
            }
            for r, p in zip(rows, scores)
        ]
        db.update_sift_scores(scored)
    tiers = [s["score_tier"] for s in scored]
    print(
        f"peasoup-rank score: {len(scored)} rows re-scored with "
        f"{model.fingerprint} "
        f"(tier1={tiers.count(1)}, tier2={tiers.count(2)}, tier3={tiers.count(3)})"
    )
    return 0


def _cmd_eval(args) -> int:
    from ..rank.model import RankModel
    from ..rank.train import evaluate_model

    device = _start(args)
    model = RankModel.from_file(args.model or None)
    ev = evaluate_model(model, seed=args.seed, n_examples=args.examples, device=device)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(ev, f, indent=1, sort_keys=True)
            f.write("\n")
    ok = ev["auc"] >= args.min_auc
    print(
        f"peasoup-rank eval: AUC {ev['auc']:.4f} over "
        f"{ev['n_examples']} injected examples ({ev['n_pulsar']} "
        f"pulsars, {ev['n_foil']} RFI foils) with {ev['fingerprint']}; "
        f"pulsar tier-1 fraction {ev['pulsar_tier1_frac']:.2f}, "
        f"foil tier-1 fraction {ev['foil_tier1_frac']:.2f} -> "
        f"{'OK' if ok else f'BELOW --min-auc {args.min_auc}'}"
    )
    return 0 if ok else 2


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return {
        "train": _cmd_train, "score": _cmd_score, "eval": _cmd_eval,
        "evaluate": _cmd_eval,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
