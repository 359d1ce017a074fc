"""Validate telemetry manifests against the port's copy of the JAX
package's manifest schema (``peasoup_tpu_torch/obs/manifest.schema.json``).

    python -m peasoup_tpu_torch.tools.validate_manifest run/telemetry.json
    python -m peasoup_tpu_torch.tools.validate_manifest --fresh

``--fresh`` also generates a brand-new ``RunTelemetry`` manifest in a
temporary directory and validates it (and its aborted form), so a drift
between what the writer produces and what the schema promises fails in
either direction.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="peasoup-validate-manifest",
        description="Validate telemetry.json manifests against the manifest schema",
    )
    p.add_argument("manifests", nargs="*", help="manifest files to validate")
    p.add_argument("--fresh", action="store_true",
                   help="also generate a fresh RunTelemetry manifest and validate it")
    args = p.parse_args(argv)
    if not args.manifests and not args.fresh:
        p.error("nothing to validate (pass files and/or --fresh)")

    from ..obs.schema import SchemaError, validate_manifest
    from ..obs.telemetry import RunTelemetry, load_manifest

    n_ok = 0
    failed = False
    for path in args.manifests:
        try:
            validate_manifest(load_manifest(path))
            n_ok += 1
        except (SchemaError, ValueError, OSError) as exc:
            failed = True
            print(f"FAIL {path}: {exc}", file=sys.stderr)

    if args.fresh:
        tel = RunTelemetry(run_id="schema-gate")
        tel.set_context(command="validate_manifest", fresh=True)
        tel.incr("widgets", 3)
        tel.gauge("level", 1.5)
        with tel.stage("probe"):
            pass
        tel.set_progress(1, 2, unit="steps")
        tel.event("adaptive_thing", old=1, new=2)
        with tempfile.TemporaryDirectory() as d:
            man = tel.write(os.path.join(d, "telemetry.json"))
            aborted = tel.write(os.path.join(d, "aborted.json"), aborted=True,
                                abort_reason="schema-gate")
        for label, doc in (("fresh", man), ("fresh-aborted", aborted)):
            try:
                validate_manifest(doc)
                n_ok += 1
            except SchemaError as exc:
                failed = True
                print(f"FAIL <{label} manifest>: {exc}", file=sys.stderr)

    if failed:
        return 1
    print(f"OK: {n_ok} manifest(s) schema-valid")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
