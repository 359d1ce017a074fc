"""`peasoup-stream` CLI of the PyTorch / CUDA port: the streaming real-time
single-pulse search, flag-compatible with the JAX package's
``peasoup-stream``, plus ``--device``.

Usage:
  # replay a recorded filterbank at 4x real time (--rate 0: as fast as
  # the search drains)
  python -m peasoup_tpu_torch.cli.stream --replay data.fil --rate 4 -o out/
  # tail a growing .fil a recorder is appending to
  python -m peasoup_tpu_torch.cli.stream --tail /data/live.fil -o out/
  # consume PSRDADA-style .dada segment files from a ring dump directory
  python -m peasoup_tpu_torch.cli.stream --dada /data/ring/ -o out/

The search runs on the CUDA device unless ``--device cpu`` is given. It
writes, as it runs, in the output directory:
  triggers.jsonl          one JSON line per confirmed trigger
  candidates.singlepulse  the rolling top-N table (the batch format)
  telemetry.json          the run manifest (or ``--metrics-json PATH``),
                          with the ``streaming`` section
``--metrics-jsonl FILE`` appends the stream's time series (chunk latency,
queue depth, triggers) one JSON sample a line (obs/metrics.py), and
``--status-json`` writes the live heartbeat with its ``streaming``
section, as in the JAX CLI (cli/__init__.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import add_observability_args, init_observability, live_observability


def default_outdir() -> str:
    return time.strftime("./%Y-%m-%d-%H:%M_stream/", time.gmtime())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-stream",
        description="Peasoup streaming real-time single-pulse search - bounded-latency "
        "chunked ingest with backpressure and live triggers (PyTorch/CUDA port)",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--replay", metavar="FIL",
                     help="replay a recorded filterbank (deterministic testing)")
    src.add_argument("--tail", metavar="FIL", help="tail a growing sigproc filterbank file")
    src.add_argument("--dada", metavar="PATH",
                     help="consume PSRDADA-style .dada segments (file or directory)")
    p.add_argument("--rate", type=float, default=1.0,
                   help="replay real-time factor (--replay only): 2 = twice real time, "
                   "0 = as fast as the search drains (default 1)")
    p.add_argument("-o", "--outdir", default=None, help="The output directory")
    p.add_argument("-k", "--killfile", default="", help="Channel mask file")
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
                   "quarter-chunk caps only)")
    p.add_argument("--max_events", type=int, default=256,
                   help="events kept per DM trial and chunk")
    p.add_argument("--decimate", type=int, default=32,
                   help="best-plane max-decimation factor (chunk and hold must be "
                   "multiples of this)")
    p.add_argument("--time_link", type=float, default=1.0,
                   help="friends-of-friends time tolerance in units of the wider "
                   "member's boxcar width")
    p.add_argument("--dm_link", type=int, default=2,
                   help="friends-of-friends DM-trial adjacency tolerance")
    p.add_argument("--limit", type=int, default=1000,
                   help="rolling candidates.singlepulse table size")
    g = p.add_argument_group("streaming")
    g.add_argument("--chunk", dest="chunk_samples", type=int, default=16384,
                   help="dedispersed samples per search chunk (default 16384)")
    g.add_argument("--hold", dest="hold_samples", type=int, default=0,
                   help="carried-tail samples across chunk boundaries (0 = auto from "
                   "the widest boxcar)")
    g.add_argument("--block-samples", dest="block_samples", type=int, default=0,
                   help="source block size in samples (default chunk/4)")
    g.add_argument("--queue-blocks", dest="queue_blocks", type=int, default=8,
                   help="bounded ingest queue capacity in blocks (default 8)")
    g.add_argument("--policy", choices=("block", "drop_oldest"), default="block",
                   help="backpressure policy when the queue fills: block the reader "
                   "(lossless, falls behind) or drop_oldest (bounded latency, "
                   "counted sensitivity loss)")
    g.add_argument("--latency-slo", dest="latency_slo_s", type=float, default=2.0,
                   help="per-chunk arrival->trigger latency budget in seconds (misses "
                   "are counted and logged, never fatal; default 2)")
    g.add_argument("--max-chunks", dest="max_chunks", type=int, default=0,
                   help="stop after N chunks (0 = run to stream end)")
    g.add_argument("--metrics-jsonl", dest="metrics_jsonl", default="",
                   help="append-only time-series metrics file (chunk latency, queue "
                   "depth, trigger counts; obs/metrics.py); default off")
    g.add_argument("--no-warmup", dest="no_warmup", action="store_true",
                   help="skip building and loading the kernels before ingest")
    g.add_argument("--idle-timeout", dest="idle_timeout_s", type=float, default=10.0,
                   help="tail/dada modes: end the stream after this many seconds "
                   "without new data (default 10)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the search runs (default: the CUDA device)")
    add_observability_args(p)
    return p


def make_source(args, block_samples: int):
    """The StreamSource the flags name."""
    from ..io.stream_source import DadaStreamSource, FileTailSource, ReplaySource

    if args.replay:
        from ..io.sigproc import read_filterbank

        return ReplaySource(read_filterbank(args.replay), block_samples, rate=args.rate)
    if args.tail:
        return FileTailSource(args.tail, block_samples, idle_timeout_s=args.idle_timeout_s)
    return DadaStreamSource(args.dada, block_samples, idle_timeout_s=args.idle_timeout_s)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    outdir = (args.outdir or default_outdir()).rstrip("/")
    tel = init_observability(args)
    tel.set_context(
        command="stream", outdir=outdir, source=args.replay or args.tail or args.dada,
        mode="replay" if args.replay else "tail" if args.tail else "dada",
    )
    manifest_path = args.metrics_json or os.path.join(outdir, "telemetry.json")

    from ..stream import StreamConfig, StreamingSearch

    block_samples = args.block_samples or max(args.decimate, args.chunk_samples // 4)
    cfg = StreamConfig(
        outdir=outdir, killfilename=args.killfile, dm_start=args.dm_start,
        dm_end=args.dm_end, dm_tol=args.dm_tol, dm_pulse_width=args.dm_pulse_width,
        min_snr=args.min_snr, n_widths=args.n_widths, max_width=args.max_width,
        max_events=args.max_events, decimate=args.decimate, time_link=args.time_link,
        dm_link=args.dm_link, limit=args.limit, chunk_samples=args.chunk_samples,
        hold_samples=args.hold_samples, queue_blocks=args.queue_blocks,
        policy=args.policy, latency_slo_s=args.latency_slo_s,
        max_chunks=args.max_chunks, warmup=not args.no_warmup,
        metrics_jsonl=args.metrics_jsonl,
    )
    search = StreamingSearch(cfg, device=args.device)
    os.makedirs(outdir, exist_ok=True)
    with tel.activate(), live_observability(tel, args, outdir, manifest_path):
        result = search.run(make_source(args, block_samples))
        tel.merge_timers(result.timers)
        tel.gauge("candidates.written", len(result.candidates))
        tel.set_stage("done")
        tel.write(manifest_path)
    if args.verbose:
        lat = result.latency
        print(
            f"Stream drained: {result.n_chunks} chunks, {result.n_triggers} triggers -> "
            f"{outdir} (latency p50 {(lat['p50'] or 0.0) * 1e3:.3f} ms, p95 "
            f"{(lat['p95'] or 0.0) * 1e3:.3f} ms vs SLO {cfg.latency_slo_s * 1e3:.0f} ms; "
            f"{result.drops['blocks']} dropped blocks, {result.drops['gap_samples']} "
            "gap samples)"
        )
        print("Stage timers (s): " + json.dumps(result.timers, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
