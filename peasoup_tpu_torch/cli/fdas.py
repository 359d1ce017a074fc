"""`peasoup-fdas` CLI of the PyTorch / CUDA port: the Fourier-domain
acceleration search, flag-compatible with the JAX package's
``peasoup-fdas``, plus ``--device``.

Usage:
  python -m peasoup_tpu_torch.cli.fdas -i data.fil --dm_end 250 --zmax 128

The same input, DM-plan and spectrum flags as `peasoup`, with the
acceleration range replaced by PRESTO's --zmax/--wmax template-bank bounds
(f-dot and f-ddot extent in DFT bins over the observation). The search runs
on the CUDA device unless ``--device cpu`` is given. It writes, in the
output directory:
  candidates.peasoup   the periodicity binary format
  candidates.fdas      the JAX package's .fdas text table
  overview.xml         header, the <fdas_search> section, DM trials,
                       device, candidates with fdot/fddot/z/w, timers
``--checkpoint FILE`` saves each DM block's peaks and resumes from them.
Every run goes through the multi-process driver
(parallel/multihost.py:run_fdas_search), as the JAX CLI's does: launched
N times with JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID (or under torchrun), each process searches its slice of
the DM list and rank 0 writes the files. Refused with
NotImplementedError: the JAX CLI's observability flags
(``--metrics-json`` and the rest, ROADMAP A.10).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import add_observability_args, refuse_observability


def default_outdir() -> str:
    return time.strftime("./%Y-%m-%d-%H:%M_peasoup_fdas/", time.gmtime())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-fdas",
        description="Peasoup Fourier-domain acceleration search (PyTorch/CUDA port)",
    )
    p.add_argument("-i", "--inputfile", required=True, help="File to process (.fil)")
    p.add_argument("-o", "--outdir", default=None, help="The output directory")
    p.add_argument("-k", "--killfile", default="", help="Channel mask file")
    p.add_argument("-z", "--zapfile", default="", help="Birdie list file")
    p.add_argument("--limit", type=int, default=1000,
                   help="upper limit on number of candidates to write out")
    p.add_argument("--fft_size", type=int, default=0,
                   help="Transform size to use (defaults to lower power of two)")
    p.add_argument("--dm_start", type=float, default=0.0)
    p.add_argument("--dm_end", type=float, default=100.0)
    p.add_argument("--dm_tol", type=float, default=1.10,
                   help="DM smearing tolerance (1.11=10%%)")
    p.add_argument("--dm_pulse_width", type=float, default=64.0,
                   help="Minimum pulse width (us) for which dm_tol is valid")
    p.add_argument("--zmax", type=float, default=64.0,
                   help="f-dot search extent in DFT bins over the observation "
                   "(PRESTO -z; 0 = pure periodicity)")
    p.add_argument("--zstep", type=float, default=2.0,
                   help="f-dot template spacing in bins")
    p.add_argument("--wmax", type=float, default=0.0,
                   help="f-ddot (jerk) search extent in bins (PRESTO -w; 0 = jerk "
                   "plane off)")
    p.add_argument("--wstep", type=float, default=20.0,
                   help="f-ddot template spacing in bins")
    p.add_argument("--boundary_5_freq", type=float, default=0.05)
    p.add_argument("--boundary_25_freq", type=float, default=0.5)
    p.add_argument("-n", "--nharmonics", type=int, default=4)
    p.add_argument("-m", "--min_snr", type=float, default=9.0)
    p.add_argument("--min_freq", type=float, default=0.1)
    p.add_argument("--max_freq", type=float, default=1100.0)
    p.add_argument("--max_harm_match", type=int, default=16, dest="max_harm")
    p.add_argument("--freq_tol", type=float, default=0.0001)
    p.add_argument("--segment", type=int, default=0,
                   help="overlap-save FFT length (0 = auto from template width)")
    p.add_argument("--template_block", type=int, default=0,
                   help="template rows per device tile (0 = auto)")
    p.add_argument("--dm_block", type=int, default=0,
                   help="DM trials per device tile (0 = auto from the memory budget)")
    p.add_argument("--checkpoint", default="",
                   help="Checkpoint file for resumable searches")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-p", "--progress_bar", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the search runs (default: the CUDA device)")
    add_observability_args(p)
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_observability(args, parser)
    outdir = args.outdir or default_outdir()

    from ..device import resolve_device
    from ..io.output import CandidateFileWriter, OutputFileWriter, write_fdas_candidates
    from ..io.sigproc import read_filterbank
    from ..parallel import multihost
    from ..pipeline.fdas import FdasConfig

    cfg = FdasConfig(
        outdir=outdir, killfilename=args.killfile, zapfilename=args.zapfile,
        limit=args.limit, size=args.fft_size, dm_start=args.dm_start,
        dm_end=args.dm_end, dm_tol=args.dm_tol, dm_pulse_width=args.dm_pulse_width,
        zmax=args.zmax, zstep=args.zstep, wmax=args.wmax, wstep=args.wstep,
        boundary_5_freq=args.boundary_5_freq, boundary_25_freq=args.boundary_25_freq,
        nharmonics=args.nharmonics, min_snr=args.min_snr, min_freq=args.min_freq,
        max_freq=args.max_freq, max_harm=args.max_harm, freq_tol=args.freq_tol,
        verbose=args.verbose, progress_bar=args.progress_bar, segment=args.segment,
        template_block=args.template_block, dm_block=args.dm_block,
        checkpoint_file=args.checkpoint,
    )
    device = resolve_device(args.device)  # no card: raise before reading

    t0 = time.perf_counter()
    if args.progress_bar:
        print(f"Reading data from {args.inputfile}")
    fil = read_filterbank(args.inputfile)
    reading = time.perf_counter() - t0

    result = multihost.run_fdas_search(fil, cfg, device=device)
    result.timers["reading"] = reading
    if multihost.process_index() != 0:
        return 0  # every process holds the same result; rank 0 writes

    t0 = time.perf_counter()
    writer = CandidateFileWriter(outdir)
    writer.write_binary(result.candidates, "candidates.peasoup")
    write_fdas_candidates(os.path.join(outdir, "candidates.fdas"), result.candidates)
    result.timers["writing"] = time.perf_counter() - t0

    stats = OutputFileWriter()
    stats.add_misc_info()
    stats.add_header(fil.header)
    stats.add_fdas_section(cfg, result.zs, result.ws)
    stats.add_dm_list(result.dm_list)
    stats.add_device_info(multihost.process_device(device, multihost.process_count(), 0))
    stats.add_candidates_fdas(result.candidates, writer.byte_mapping)
    stats.add_timing_info(result.timers)
    stats.to_file(os.path.join(outdir, "overview.xml"))
    if args.verbose or args.progress_bar:
        print(f"Done: {len(result.candidates)} candidates -> {outdir} "
              f"(total {result.timers['total']:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
