"""`peasoup-ffa` CLI of the PyTorch / CUDA port: the FFA pulsar search,
flag-compatible with the JAX package's ``peasoup-ffa`` (the reference's
FFA spec, read_ffa_cmdline_options, include/utils/cmdline.hpp:211-292,
whose implementing source is absent from the reference tree), its
observability flags included (cli/__init__.py; the manifest is written
only with ``--metrics-json``, as in the JAX CLI), plus ``--device``.

Usage:
  python -m peasoup_tpu_torch.cli.ffa -i data.fil --dm_end 20 \\
      --p_start 0.8 --p_end 5

The filterbank is dedispersed by the dedisperse kernel and every DM trial
searched by the FFA staircase (ops/ffa.py) on the CUDA device unless
``--device cpu`` is given. It writes the JAX CLI's XML: the search
parameters, the DM trial count, the period-collapsed candidates and the
stage timers. ``-t`` and ``--nstreams`` are accepted for compatibility and
do nothing, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import add_observability_args, init_observability, live_observability


def get_default_ffa_output_filename() -> str:
    """UTC-stamped default like the reference's search CLI
    (cmdline.hpp:53-59)."""
    return time.strftime("./%Y-%m-%d-%H:%M_peasoup_ffa.xml", time.gmtime())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-ffa",
        description="Peasoup/FFAster extension - an FFA pulsar search "
        "pipeline (PyTorch/CUDA port)",
    )
    p.add_argument("-i", "--inputfile", required=True, help="File to process (.fil)")
    p.add_argument("-o", "--outfilename", default=None, help="The output filename")
    p.add_argument("-k", "--killfile", default="", help="Channel mask file")
    p.add_argument("-t", "--num_threads", type=int, default=14,
                   help="(compatibility) number of devices; one is used")
    p.add_argument("--nstreams", type=int, default=16,
                   help="(compatibility) stream count")
    p.add_argument("--dm_start", type=float, default=0.0,
                   help="First DM to dedisperse to")
    p.add_argument("--dm_end", type=float, default=100.0,
                   help="Last DM to dedisperse to")
    p.add_argument("--dm_tol", type=float, default=1.10,
                   help="DM smearing tolerance (1.11=10%%)")
    p.add_argument("--dm_pulse_width", type=float, default=64.0,
                   help="Minimum pulse width (us) for which dm_tol is valid")
    p.add_argument("--p_start", type=float, default=0.8,
                   help="Start period for FFA search (s)")
    p.add_argument("--p_end", type=float, default=20.0,
                   help="End period for FFA search (s)")
    p.add_argument("--min_dc", type=float, default=0.001,
                   help="Minimum duty cycle (fraction)")
    p.add_argument("--min_snr", type=float, default=8.0,
                   help="Candidate S/N threshold")
    p.add_argument("--limit", type=int, default=1000,
                   help="Maximum candidates to write")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-p", "--progress_bar", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the search runs (default: the CUDA device)")
    add_observability_args(p)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    out = args.outfilename or get_default_ffa_output_filename()

    from ..io.sigproc import read_filterbank
    from ..io.xml_writer import Element
    from ..pipeline.ffa import FFAConfig, FFASearch

    cfg = FFAConfig(
        killfilename=args.killfile, limit=args.limit, dm_start=args.dm_start,
        dm_end=args.dm_end, dm_tol=args.dm_tol, dm_pulse_width=args.dm_pulse_width,
        p_start=args.p_start, p_end=args.p_end, min_dc=args.min_dc,
        min_snr=args.min_snr, verbose=args.verbose, progress_bar=args.progress_bar,
    )
    search = FFASearch(cfg, device=args.device)
    tel = init_observability(args)
    tel.set_context(command="peasoup-ffa", inputfile=args.inputfile, outfile=out)
    workdir = os.path.dirname(args.metrics_json or out) or "."
    manifest_path = args.metrics_json or os.path.join(workdir, "telemetry.json")
    t0 = time.perf_counter()
    with tel.activate(), live_observability(
        tel, args, workdir,
        manifest_path if (args.metrics_json or args.status_json) else None,
    ):
        tel.set_stage("reading")
        fil = read_filterbank(args.inputfile)
        reading = time.perf_counter() - t0
        if args.verbose:
            print(f"FFA search: {search.build_dm_plan(fil).ndm} DM trials, periods "
                  f"{args.p_start}-{args.p_end} s, min_dc {args.min_dc}")
        progress = None
        if args.verbose or args.progress_bar:
            progress = lambda f: print(f"FFA octaves: {f * 100:5.1f}% done")  # noqa: E731
        with tel.device_capture(search.device):
            result = search.run(fil, progress=progress)
        tel.set_stage("writing")
    if args.verbose:
        print(f"{len(result.candidates)} period-collapsed candidates")

    root = Element("ffa_search")
    params = root.append(Element("search_parameters"))
    for k in ("p_start", "p_end", "min_dc", "dm_start", "dm_end",
              "dm_tol", "dm_pulse_width", "min_snr"):
        params.append(Element(k, getattr(args, k)))
    dm_el = root.append(Element("dedispersion_trials"))
    dm_el.add_attribute("count", len(result.dm_list))
    cands_el = root.append(Element("candidates"))
    for i, c in enumerate(result.candidates):
        el = cands_el.append(Element("candidate"))
        el.add_attribute("id", i)
        el.append(Element("period", c.period))
        el.append(Element("dm", c.dm))
        el.append(Element("snr", c.snr))
        el.append(Element("width", c.width))
        el.append(Element("duty_cycle", c.dc))
    timers = dict(reading=reading, dedispersion=result.timers["dedispersion"],
                  ffa_search=result.timers["ffa_search"],
                  total=time.perf_counter() - t0)
    tel.merge_timers(timers)
    tel.gauge("candidates.final", len(result.candidates))
    times = root.append(Element("execution_times"))
    for key in sorted(timers):
        times.append(Element(key, float(timers[key])))
    with open(out, "w") as f:
        f.write(root.to_string(header=True))
    if args.metrics_json:
        tel.write(args.metrics_json)
    print(f"Done: {len(result.candidates)} FFA candidates -> {out} "
          f"(total {timers['total']:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
