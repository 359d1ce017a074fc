"""Dump an overview.xml candidate table as text (reference:
tools/peasoup_as_text.py): the port's copy of the JAX package's tool.

    python -m peasoup_tpu_torch.tools.as_text outdir/overview.xml
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="peasoup-as-text")
    p.add_argument("overview", help="path to overview.xml")
    args = p.parse_args(argv)
    from .parsers import OverviewFile

    ov = OverviewFile(args.overview)
    cols = ("period", "opt_period", "dm", "acc", "nh", "snr", "folded_snr",
            "is_adjacent", "is_physical", "ddm_count_ratio", "ddm_snr_ratio",
            "nassoc")
    print("#" + "\t".join(cols))
    for row in ov.candidates:
        print("\t".join(str(row[c]) for c in cols))
    return 0


if __name__ == "__main__":
    sys.exit(main())
