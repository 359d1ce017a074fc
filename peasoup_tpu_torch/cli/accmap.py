"""`accmap` CLI of the PyTorch / CUDA port: the cross-beam delay finder
(the JAX package's ``accmap``; the reference's src/accmap.cpp, which does
not compile as shipped), plus ``--device``.

Usage:
  python -m peasoup_tpu_torch.cli.accmap beam0.fil beam1.fil ... -d 600

Each beam is a SIGPROC filterbank (channel-summed to a zero-DM series on
the host) or a .tim series; every pair is cross-correlated on the CUDA
device unless ``--device cpu`` is given, and one line a pair printed:
the reference's "Distance" and the signed lag and power of the peak.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="accmap", description="Cross-beam delay finder")
    p.add_argument("files", nargs="+", help="Beam files (.fil or .tim)")
    p.add_argument("-d", "--max_delay", type=int, default=600,
                   help="Maximum lag to search (samples)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the correlation runs (default: the CUDA device)")
    return p


def _load_series(path: str) -> np.ndarray:
    from ..io.sigproc import read_filterbank, read_timeseries

    if path.endswith(".tim"):
        return read_timeseries(path)[1].astype(np.float32)
    return read_filterbank(path).data.sum(axis=1, dtype=np.float32)  # zero-DM series


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..ops.correlate import find_delays

    dev = resolve_device(args.device)
    series = [_load_series(f) for f in args.files]
    n = min(len(s) for s in series)
    res = find_delays(np.stack([s[:n] for s in series]), args.max_delay, device=dev)
    distance, lag, power = (t.cpu().numpy() for t in (res.distance, res.lag, res.power))
    for k, (ii, jj) in enumerate(res.pairs):
        # the reference prints "<ii> <jj> Distance: <argmax>"
        # (correlator.hpp:85-86); the signed lag is the useful number
        print(
            f"{args.files[ii]} {args.files[jj]} Distance: {int(distance[k])} "
            f"(lag {int(lag[k])} samples, power {float(power[k]):.3g})"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
