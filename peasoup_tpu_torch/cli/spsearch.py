"""`spsearch` CLI of the PyTorch / CUDA port: the single-pulse search,
flag-compatible with the JAX package's ``peasoup-spsearch`` (except its
observability flags), plus ``--device``.

Usage:
  python -m peasoup_tpu_torch.cli.spsearch -i data.fil --dm_end 250 -m 7

The search runs on the CUDA device unless ``--device cpu`` is given. It
writes, in the output directory:
  candidates.singlepulse   the whitespace table the JAX package's
                           tools.parsers.read_singlepulse reads
  overview.xml             header, DM trials, device, the
                           <single_pulse_search> section and the timers
The JAX CLI's telemetry.json is not written: the port has no run
telemetry yet. ``--checkpoint FILE`` saves each DM block's events as it is
searched and resumes from them; ``--tune`` takes the segment height of
trials dedispersed into host RAM from the per-device tuning cache
(``--tuning-cache FILE``), measured on the card the first time a bucket is
seen (peasoup_tpu_torch/perf/tuning.py).

Every run goes through the multi-process driver
(parallel/multihost.py:run_single_pulse_search), as the JAX CLI's does:
launched N times with JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID (or under torchrun), each process searches its slice of
the DM list, the events are exchanged and clustered alike everywhere,
and rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def default_outdir() -> str:
    return time.strftime("./%Y-%m-%d-%H:%M_spsearch/", time.gmtime())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-spsearch",
        description="Peasoup single-pulse search - matched-filter transient "
        "detection over the DM-time plane (PyTorch/CUDA port)",
    )
    p.add_argument("-i", "--inputfile", required=True, help="File to process (.fil)")
    p.add_argument("-o", "--outdir", default=None, help="The output directory")
    p.add_argument("-k", "--killfile", default="", help="Channel mask file")
    p.add_argument(
        "-t", "--num_threads", type=int, default=14,
        help="Number of device workers (reference: number of GPUs)",
    )
    p.add_argument("--limit", type=int, default=1000,
                   help="upper limit on number of candidates to write out")
    p.add_argument("--dm_start", type=float, default=0.0)
    p.add_argument("--dm_end", type=float, default=100.0)
    p.add_argument("--dm_tol", type=float, default=1.10,
                   help="DM smearing tolerance (1.11=10%%)")
    p.add_argument("--dm_pulse_width", type=float, default=64.0,
                   help="Minimum pulse width (us) for which dm_tol is valid")
    p.add_argument("-m", "--min_snr", type=float, default=6.0,
                   help="single-pulse S/N threshold")
    p.add_argument("--n_widths", type=int, default=12,
                   help="number of octave-spaced boxcar widths (1..2^(n-1) samples)")
    p.add_argument("--max_width", type=int, default=0,
                   help="cap on the widest boxcar (samples; 0 = n_widths and "
                   "trial-length caps only)")
    p.add_argument("--max_events", type=int, default=256,
                   help="events kept per DM trial")
    p.add_argument("--time_link", type=float, default=1.0,
                   help="friends-of-friends time tolerance in units of the wider "
                   "member's boxcar width")
    p.add_argument("--dm_link", type=int, default=2,
                   help="friends-of-friends DM-trial adjacency tolerance")
    p.add_argument("--checkpoint", default="",
                   help="Checkpoint file for resumable searches")
    p.add_argument("--hbm_bytes", type=int, default=0,
                   help="device memory budget in bytes (0 = ask the device)")
    p.add_argument("--dm_block", type=int, default=0,
                   help="DM trials per device block (0 = auto from the memory budget)")
    p.add_argument("--tune", action=argparse.BooleanOptionalAction, default=False,
                   help="take the dedispersion knobs from the per-device tuning "
                   "cache, measuring them on a cold bucket")
    p.add_argument("--tuning-cache", default="",
                   help="tuning_cache.json path ('' = the per-user cache)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-p", "--progress_bar", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the search runs (default: the CUDA device)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    outdir = args.outdir or default_outdir()

    from ..device import resolve_device
    from ..io.output import OutputFileWriter, write_singlepulse
    from ..io.sigproc import read_filterbank
    from ..parallel import multihost
    from ..pipeline.single_pulse import SinglePulseConfig

    cfg = SinglePulseConfig(
        outdir=outdir,
        killfilename=args.killfile,
        limit=args.limit,
        dm_start=args.dm_start,
        dm_end=args.dm_end,
        dm_tol=args.dm_tol,
        dm_pulse_width=args.dm_pulse_width,
        min_snr=args.min_snr,
        n_widths=args.n_widths,
        max_width=args.max_width,
        max_events=args.max_events,
        time_link=args.time_link,
        dm_link=args.dm_link,
        verbose=args.verbose,
        progress_bar=args.progress_bar,
        max_num_threads=args.num_threads,
        dm_block=args.dm_block,
        hbm_bytes=args.hbm_bytes,
        checkpoint_file=args.checkpoint,
        tune=args.tune,
        tuning_cache=args.tuning_cache,
    )
    device = resolve_device(args.device)  # no card: raise before reading

    t0 = time.perf_counter()
    if args.progress_bar:
        print(f"Reading data from {args.inputfile}")
    fil = read_filterbank(args.inputfile)
    reading = time.perf_counter() - t0

    result = multihost.run_single_pulse_search(fil, cfg, device=device)
    result.timers["reading"] = reading
    if multihost.process_index() != 0:
        return 0  # every process holds the same result; rank 0 writes
    os.makedirs(outdir, exist_ok=True)

    t0 = time.perf_counter()
    write_singlepulse(os.path.join(outdir, "candidates.singlepulse"), result.candidates)
    result.timers["writing"] = time.perf_counter() - t0

    stats = OutputFileWriter()
    stats.add_misc_info()
    stats.add_header(fil.header)
    stats.add_dm_list(result.dm_list)
    stats.add_device_info(multihost.process_device(device, multihost.process_count(), 0))
    stats.add_single_pulse_section(cfg, args.inputfile, result.widths, result.candidates)
    stats.add_timing_info(result.timers)
    stats.to_file(os.path.join(outdir, "overview.xml"))
    if args.verbose or args.progress_bar:
        print(
            f"Done: {len(result.candidates)} single-pulse candidates -> {outdir} "
            f"(total {result.timers['total']:.2f}s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
