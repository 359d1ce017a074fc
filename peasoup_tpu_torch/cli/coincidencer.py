"""`coincidencer` CLI of the PyTorch / CUDA port: multibeam RFI masks and
birdie lists by coincidence-matching zero-DM time series and spectra
across beams (the JAX package's ``coincidencer``; the reference's
src/coincidencer.cpp), flag-compatible, its observability flags included
(cli/__init__.py; the manifest is written only with ``--metrics-json``),
plus ``--device``.

Usage:
  python -m peasoup_tpu_torch.cli.coincidencer beam*.fil --thresh 4 \\
      --beam_thresh 4

Per beam: dedisperse at DM 0 with the dedisperse kernel, then deredden
and normalise the spectrum and the time series over the full dedispersed
length (a non-power-of-two FFT, coincidencer.cpp:136); then count, per
sample and per bin, the beams above ``--thresh``: what fires in
``--beam_thresh`` beams or more is multibeam RFI. Writes a 0/1 sample
mask (``--o``, rfi.eb_mask) and a (freq, width) birdie list (``--o2``,
birdies.txt) from the zero runs of the spectral mask
(include/transforms/coincidencer.hpp:42-78). Runs on the CUDA device
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import add_observability_args, init_observability, live_observability


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="coincidencer",
        description="Peasoup multibeam coincidence RFI detector (PyTorch/CUDA port)",
    )
    p.add_argument("filterbanks", nargs="+", help="File names")
    p.add_argument("--o", dest="samp_outfilename", default="rfi.eb_mask",
                   help="Sample mask output filename")
    p.add_argument("--o2", dest="spec_outfilename", default="birdies.txt",
                   help="Birdie list output filename")
    p.add_argument("-l", "--boundary_5_freq", type=float, default=0.05)
    p.add_argument("-a", "--boundary_25_freq", type=float, default=0.5)
    p.add_argument("-n", "--nharmonics", type=int, default=4)
    p.add_argument("--thresh", type=float, default=4.0,
                   help="S/N threshold for coincidence matching")
    p.add_argument("--beam_thresh", type=int, default=4,
                   help="Beams a candidate must appear in to be multibeam")
    p.add_argument("-L", "--min_freq", type=float, default=0.1)
    p.add_argument("-H", "--max_freq", type=float, default=1100.0)
    p.add_argument("-b", "--max_harm", type=int, default=16)
    p.add_argument("-f", "--freq_tol", type=float, default=0.0001)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the beams are processed (default: the CUDA device)")
    add_observability_args(p)
    return p


def write_samp_mask(mask: np.ndarray, filename: str) -> None:
    with open(filename, "w") as fo:
        fo.write("#0 1\n")
        for v in mask:
            fo.write(f"{int(v)}\n")


def birdies_from_mask(mask: np.ndarray, bin_width: float) -> list[tuple[float, float]]:
    """Zero runs of the spectral mask -> (freq, width) rows
    (coincidencer.hpp:53-72)."""
    birdies = []
    ii = 0
    size = len(mask)
    while ii < size:
        if mask[ii] == 0:
            count = 0
            while ii < size and mask[ii] == 0:
                count += 1
                ii += 1
            birdies.append((((ii - 1) - count / 2.0) * bin_width, count * bin_width))
        else:
            ii += 1
    return birdies


def write_birdie_list(mask: np.ndarray, bin_width: float, filename: str) -> None:
    with open(filename, "w") as fo:
        for freq, width in birdies_from_mask(mask, bin_width):
            fo.write(f"{freq:.9f}\t{width:.6f}\n")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..io.sigproc import read_filterbank
    from ..ops.coincidence import coincidence_mask
    from ..ops.dedisperse import dedisperse, fil_to_device, output_scale
    from ..parallel.coincidence import baseline_beam
    from ..plan.dm_plan import DMPlan

    dev = resolve_device(args.device)
    tel = init_observability(args)
    tel.set_context(command="coincidencer", n_beams=len(args.filterbanks))
    workdir = os.path.dirname(args.metrics_json or args.samp_outfilename) or "."
    manifest_path = args.metrics_json or os.path.join(workdir, "telemetry.json")
    with tel.activate(), live_observability(
        tel, args, workdir,
        manifest_path if (args.metrics_json or args.status_json) else None,
    ):
        tims = []
        tsamp = None
        n_beams = len(args.filterbanks)
        with tel.stage("reading"):
            for i, path in enumerate(args.filterbanks):
                if args.verbose:
                    print(f"Reading and dedispersing {path}")
                tel.set_progress(i, n_beams, unit="beams")
                fil = read_filterbank(path)
                plan = DMPlan.create(
                    nsamps=fil.nsamps, nchans=fil.nchans, tsamp=fil.tsamp,
                    fch1=fil.fch1, foff=fil.foff, dm_start=0.0, dm_end=0.0,
                    pulse_width=0.4, tol=1.1,
                )
                tims.append(dedisperse(
                    fil_to_device(fil, dev), plan.delay_samples(), plan.killmask,
                    plan.out_nsamps, scale=output_scale(fil.nbits, fil.nchans),
                )[0])
                tsamp = fil.tsamp
        sizes = {len(t) for t in tims}
        if len(sizes) != 1:
            raise SystemExit("Not all filterbanks the same length")
        # the full dedispersed length, not a power of two (coincidencer.cpp:136)
        size = sizes.pop()
        bin_width = 1.0 / (size * tsamp)
        pos5 = int(args.boundary_5_freq / bin_width)
        pos25 = int(args.boundary_25_freq / bin_width)

        specs, series = [], []
        with tel.device_capture(dev):
            with tel.stage("baselining"):
                for i, t in enumerate(tims):
                    if args.verbose:
                        print("Baselining beam")
                    tel.set_progress(n_beams + i, 2 * n_beams, unit="beams")
                    spec, tim = baseline_beam(t, size=size, pos5=pos5, pos25=pos25)
                    specs.append(spec)
                    series.append(tim)
            if args.verbose:
                print("Performing cross beam coincidence matching")
            with tel.stage("coincidence"):
                samp_mask = coincidence_mask(torch.stack(series), args.thresh,
                                             args.beam_thresh)
                spec_mask = coincidence_mask(torch.stack(specs), args.thresh,
                                             args.beam_thresh)
        tel.set_progress(2 * n_beams, 2 * n_beams, unit="beams")
    samp_mask, spec_mask = samp_mask.cpu().numpy(), spec_mask.cpu().numpy()
    write_samp_mask(samp_mask, args.samp_outfilename)
    write_birdie_list(spec_mask, bin_width, args.spec_outfilename)
    tel.gauge("mask.samples_flagged", int((samp_mask == 0).sum()))
    tel.gauge("mask.bins_flagged", int((spec_mask == 0).sum()))
    if args.metrics_json:
        tel.write(args.metrics_json)
    if args.verbose:
        print(f"Wrote {args.samp_outfilename} and {args.spec_outfilename}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
