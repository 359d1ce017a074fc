"""`peasoup` CLI of the PyTorch / CUDA port: flag-compatible with the
reference binary (reference: include/utils/cmdline.hpp:69-209 TCLAP
spec) and with the JAX package's ``peasoup``, its observability flags
included (cli/__init__.py), plus ``--device``.

Usage:
  python -m peasoup_tpu_torch.cli.peasoup -i data.fil --dm_end 250 \\
      --acc_start -5 --acc_end 5 --npdmp 10

The search runs on the CUDA device unless ``--device cpu`` is given;
``--npdmp N`` folds and optimises the top N candidates. ``--subbands N``
dedisperses in two stages over N subbands (``--subband_smear`` samples of
smear allowed, 0 for the exact sum), ``--dedisp_engine matmul`` through the
banded-matmul engine, and ``--checkpoint FILE`` saves the per-DM results
as they are searched and resumes from them. ``--tune`` takes the
dedispersion plan of the observation's shape bucket from the per-device
tuning cache (``--tuning-cache FILE``, default
~/.cache/peasoup_tpu_torch/tuning_cache.json or $PEASOUP_TUNING_CACHE),
measured on the card the first time a bucket is seen
(peasoup_tpu_torch/perf/tuning.py).

Every run goes through the multi-process driver
(parallel/multihost.py:run_search), as the JAX CLI's does: alone, one
process searches the whole DM list on every local card (up to
``--num_threads``); launched N times with JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID (or under torchrun), each process
searches its slice of the list on its own card, and rank 0 writes the
files. ``--hbm_bytes`` splits a card that processes share.

The acceleration chain takes the JAX package's routes: the dftspec
kernel for the spectrum where its geometry gate holds (FFT sizes up to
2^18 with small resample spans, such as the tutorial's 2^17) and cuFFT +
the interbin kernel elsewhere; the harmpeaks kernel for harmonic sums
and peaks. The JAX package's environment switches select the other
routes: ``PEASOUP_FUSED_DFT=0`` or ``PEASOUP_FUSED_FFT=0`` (cuFFT +
interbin at every size) and ``PEASOUP_MEGA_HARM=0`` (torch harmonic sums
+ the peaks kernel).

Every run writes its telemetry manifest to ``<outdir>/telemetry.json``
(or ``--metrics-json PATH``); in a run of several processes each also
writes ``telemetry.procN.json``. ``--status-json``, ``--heartbeat-interval``,
``--capture-device-trace``, ``--log-level`` and ``--no-flight-recorder``
work as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import add_observability_args, init_observability, live_observability, write_shard


def default_outdir() -> str:
    return time.strftime("./%Y-%m-%d-%H:%M_peasoup/", time.gmtime())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup",
        description="Peasoup - a GPU pulsar search pipeline (PyTorch/CUDA port)",
        epilog="Environment: PEASOUP_FUSED_DFT=0 (or PEASOUP_FUSED_FFT=0) takes "
        "cuFFT + the interbin kernel where the dftspec kernel would run; "
        "PEASOUP_MEGA_HARM=0 takes "
        "torch harmonic sums + the peaks kernel in place of the harmpeaks "
        "kernel (the JAX package's switches).",
    )
    p.add_argument("-i", "--inputfile", required=True, help="File to process (.fil)")
    p.add_argument("-o", "--outdir", default=None, help="The output directory")
    p.add_argument("-k", "--killfile", default="", help="Channel mask file")
    p.add_argument("-z", "--zapfile", default="", help="Birdie list file")
    p.add_argument(
        "-t", "--num_threads", type=int, default=14,
        help="Number of device workers (reference: number of GPUs)",
    )
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
    p.add_argument("--acc_start", type=float, default=0.0)
    p.add_argument("--acc_end", type=float, default=0.0)
    p.add_argument("--acc_tol", type=float, default=1.10)
    p.add_argument("--acc_pulse_width", type=float, default=64.0)
    p.add_argument("--boundary_5_freq", type=float, default=0.05)
    p.add_argument("--boundary_25_freq", type=float, default=0.5)
    p.add_argument("-n", "--nharmonics", type=int, default=4)
    p.add_argument("--npdmp", type=int, default=0,
                   help="Number of candidates to fold and pdmp (0: no folding)")
    p.add_argument("-m", "--min_snr", type=float, default=9.0)
    p.add_argument("--min_freq", type=float, default=0.1)
    p.add_argument("--max_freq", type=float, default=1100.0)
    p.add_argument("--max_harm_match", type=int, default=16, dest="max_harm")
    p.add_argument("--freq_tol", type=float, default=0.0001)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-p", "--progress_bar", action="store_true")
    p.add_argument("--subbands", type=int, default=0,
                   help="two-stage subband dedispersion over this many subbands "
                   "(0 = direct)")
    p.add_argument("--subband_smear", type=float, default=1.0,
                   help="largest intra-subband smear (samples) a DM group may take; "
                   "0 = exact")
    p.add_argument("--dedisp_engine", default="", choices=("", "exact", "matmul"),
                   help="dedispersion engine: the dedisperse kernel ('' or "
                   "'exact') or the banded-matmul engine")
    p.add_argument("--tune", action=argparse.BooleanOptionalAction, default=False,
                   help="take the dedispersion plan and search knobs from the "
                   "per-device tuning cache, measuring them on a cold bucket")
    p.add_argument("--tuning-cache", default="",
                   help="tuning_cache.json path ('' = the per-user cache)")
    p.add_argument("--checkpoint", default="",
                   help="Checkpoint file for resumable searches")
    p.add_argument("--hbm_bytes", type=int, default=0,
                   help="device memory budget in bytes (0 = ask the device)")
    p.add_argument(
        "--no_accel_dedupe", action="store_true",
        help="dispatch every accel trial even when trials provably "
        "share their entire rounded resample-shift map",
    )
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the search runs (default: the CUDA device)")
    add_observability_args(p)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    outdir = args.outdir or default_outdir()

    from ..device import resolve_device
    from ..io.output import CandidateFileWriter, OutputFileWriter
    from ..io.sigproc import read_filterbank
    from ..parallel import multihost
    from ..pipeline.search import SearchConfig

    cfg = SearchConfig(
        outdir=outdir,
        killfilename=args.killfile,
        zapfilename=args.zapfile,
        max_num_threads=args.num_threads,
        limit=args.limit,
        size=args.fft_size,
        dm_start=args.dm_start,
        dm_end=args.dm_end,
        dm_tol=args.dm_tol,
        dm_pulse_width=args.dm_pulse_width,
        acc_start=args.acc_start,
        acc_end=args.acc_end,
        acc_tol=args.acc_tol,
        acc_pulse_width=args.acc_pulse_width,
        boundary_5_freq=args.boundary_5_freq,
        boundary_25_freq=args.boundary_25_freq,
        nharmonics=args.nharmonics,
        npdmp=args.npdmp,
        min_snr=args.min_snr,
        min_freq=args.min_freq,
        max_freq=args.max_freq,
        max_harm=args.max_harm,
        freq_tol=args.freq_tol,
        verbose=args.verbose,
        progress_bar=args.progress_bar,
        checkpoint_file=args.checkpoint,
        hbm_bytes=args.hbm_bytes,
        dedupe_accel=not args.no_accel_dedupe,
        subbands=args.subbands,
        subband_smear=args.subband_smear,
        dedisp_engine=args.dedisp_engine,
        tune=args.tune,
        tuning_cache=args.tuning_cache,
    )
    device = resolve_device(args.device)  # no card: raise before reading
    tel = init_observability(args)
    tel.set_context(command="peasoup", inputfile=args.inputfile, outdir=outdir)
    manifest_path = args.metrics_json or os.path.join(outdir, "telemetry.json")

    with tel.activate(), live_observability(tel, args, outdir, manifest_path):
        t0 = time.perf_counter()
        tel.set_stage("reading")
        if args.progress_bar:
            print(f"Reading data from {args.inputfile}")
        fil = read_filterbank(args.inputfile)
        reading = time.perf_counter() - t0

        with tel.device_capture(device):
            result = multihost.run_search(fil, cfg, device=device)
        result.timers["reading"] = reading
        tel.merge_timers(result.timers)
        write_shard(tel, manifest_path)
        if multihost.process_index() != 0:
            return 0  # every process holds the same result; rank 0 writes

        tel.set_stage("writing")
        t0 = time.perf_counter()
        writer = CandidateFileWriter(outdir)
        writer.write_binary(result.candidates, "candidates.peasoup")
        result.timers["writing"] = time.perf_counter() - t0
        tel.add_timer("writing", result.timers["writing"])

        stats = OutputFileWriter()
        stats.add_misc_info()
        stats.add_header(fil.header)
        stats.add_search_parameters(cfg, args.inputfile)
        stats.add_dm_list(result.dm_list)
        stats.add_acc_list(result.acc_list_dm0)
        stats.add_device_info(
            multihost.process_device(device, multihost.process_count(), 0))
        stats.add_candidates(result.candidates, writer.byte_mapping)
        stats.add_timing_info(result.timers)
        stats.to_file(os.path.join(outdir, "overview.xml"))

        # the machine-readable twin of overview.xml, written beside it
        # unless --metrics-json redirects it
        tel.gauge("candidates.written", len(result.candidates))
        tel.set_stage("done")
        tel.write(manifest_path)
    if args.verbose or args.progress_bar:
        print(
            f"Done: {len(result.candidates)} candidates -> {outdir} "
            f"(total {result.timers['total']:.2f}s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
