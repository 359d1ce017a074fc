"""Where the dedisperse kernel's time goes, on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 dedisp_probe.py [--source NAME=PATH ...] [--wrapper-only] [--reps N]

It builds csrc/dedisperse.cu as it is and with ``DEDISP_STAMPS`` (each
warp's clock64() cycles by phase: staging a chunk, waiting at a barrier,
summing, the output tile; summed over the launch's warps), plus any
``--source`` (another dedisperse.cu taking the same tables, built from
PATH against csrc/'s headers), one nvcc each, all at once, into a
temporary directory, and prints each build's registers and spills as the
runtime reports them (``cudaFuncGetAttributes``, both template variants).
Then, at the launch shapes of the benchmark's cells (gbncc.dedisp: 4096
channels, DM 0-100; htru_hilat.fft: 870 of 1024 channels, DM 0-1000; the
plan the search builds, random samples of the configuration's bit width),
it times each build's C entry (CUDA events around one launch after a
warm-up, the builds in turns, ``--reps`` rounds), checks every build's
output bitwise against the wrapper's, and prints the stamps' breakdown.
Last, chip_smoke.py's dedisperse check at the surveys' channel layouts
(``dedisperse_bands_phase``: 64 channels, 870 of 1024 and 4096, on fewer
trials and samples; bitwise its plain version, every chunk staged by
16-byte loads). ``--wrapper-only`` times ``dedisperse()`` at the two
shapes and nothing else (it needs nothing this file adds to the package,
so it also runs in an older checkout). The card's name and power limit
come first, one JSON object per measurement after.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from peasoup_tpu_torch import kernels  # noqa: E402
from peasoup_tpu_torch.device import stream_ptr  # noqa: E402
from peasoup_tpu_torch.ops import dedisperse as dd  # noqa: E402
from peasoup_tpu_torch.perf.measure import event_samples  # noqa: E402
from peasoup_tpu_torch.plan.dm_plan import DMPlan  # noqa: E402
from portbench.cell import killmask, load_cell  # noqa: E402

CELLS = ("gbncc.dedisp", "htru_hilat.fft")
STAMPS_MACRO = "DEDISP_STAMPS"  # dedisperse.cu's measuring build
STAMPS = ("staging", "barrier", "sums", "output")


def say(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def cell_plan(name: str):
    """(header, delays, kill mask, out_nsamps) of a cell's search plan."""
    cell = load_cell(name)
    h, s = cell.header, cell.traffic["search"]
    keep = killmask(cell.config)
    plan = DMPlan.create(
        nsamps=h["nsamps"], nchans=h["nchans"], tsamp=h["tsamp"], fch1=h["fch1"],
        foff=h["foff"], dm_start=s["dm_start"], dm_end=s["dm_end"],
        pulse_width=s["dm_pulse_width"], tol=s["dm_tol"], killmask=keep,
    )
    return h, plan.delay_samples(), plan.killmask, plan.out_nsamps


def samples(h: dict, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 1 << h["nbits"], (h["nsamps"], h["nchans"]), generator=g,
                         dtype=torch.uint8, device="cuda")


def timed(fn) -> float:
    """ms of one call of fn() on the card (CUDA events)."""
    return event_samples(fn, 1, "cuda")[0] * 1e3


def build(tmp: str, sources: dict) -> dict:
    """One shared library a build, all at once; each one's resources printed."""
    builds = {}
    for name, path in sources.items():
        builds[name] = (path, [])
        if STAMPS_MACRO in open(path).read():
            builds[f"{name}+stamps"] = (path, [STAMPS_MACRO])
    libs = kernels.build_variants("dedisperse", builds, tmp)
    for name, lib in libs.items():
        say({"build": name, "resources": kernels.dedisperse_resources(lib)})
    return libs


def probe_cell(name: str, libs: dict, reps: int) -> None:
    h, delays, kill, out_n = cell_plan(name)
    x = samples(h, 7)
    ndm = delays.shape[0]
    scale = dd.output_scale(h["nbits"], int(kill.sum()))
    ref = dd.dedisperse(x, delays, kill, out_n, scale=scale)
    chans = np.flatnonzero(kill).astype(np.int32)
    tab, buf, geom = dd._device_tables(delays.tobytes(), delays.shape, chans.tobytes(), x.device)
    base = buf.data_ptr()
    out = torch.empty_like(ref)
    stamps = torch.zeros(len(STAMPS) + 1, dtype=torch.int64, device="cuda")

    def call(lib):
        rc = lib.dedisperse_u8(
            x.data_ptr(), x.shape[0], x.shape[1], base + geom["chunks_at"], len(chans), base,
            base + geom["lo_spread_at"], tab["log_chunk"], tab["nchunks"], tab["pitch"],
            out.data_ptr(), ndm, out_n, float(scale), int(scale != 1.0), stream_ptr(x.device))
        if rc != 0:
            raise RuntimeError(f"the entry returned {rc}")

    say({"cell": name, "shape": [x.shape[0], x.shape[1], ndm, out_n], "kept": len(chans),
         "log_chunk": tab["log_chunk"], "nchunks": tab["nchunks"], "pitch": tab["pitch"],
         "wide_staging": kernels.dedisperse_wide_staging(tab["log_chunk"], x.shape[1],
                                                          x.data_ptr())})
    ms = {b: [] for b in libs}
    for b, lib in libs.items():
        if b.endswith("+stamps"):
            rc = lib.dedisperse_stamps_to(ctypes.c_void_p(stamps.data_ptr()))
            if rc != 0:
                raise RuntimeError(f"dedisperse_stamps_to returned {rc}")
        out.fill_(0)
        call(lib)  # warm-up, and the bitwise check
        torch.cuda.synchronize()
        say({"cell": name, "build": b, "bitwise": bool(torch.equal(out, ref))})
    order = list(libs)
    for r in range(reps):
        for b in order if r % 2 == 0 else order[::-1]:
            if b.endswith("+stamps"):
                stamps.zero_()
            ms[b].append(timed(lambda: call(libs[b])))
            if b.endswith("+stamps"):
                cyc = stamps.tolist()
                warps = max(cyc[-1], 1)
                total = sum(cyc[:-1])
                say({"cell": name, "build": b, "warps": warps,
                     "cycles_per_warp": {k: cyc[i] / warps for i, k in enumerate(STAMPS)},
                     "share": {k: cyc[i] / total for i, k in enumerate(STAMPS)}})
    for b in order:
        say({"cell": name, "build": b, "ms": ms[b], "median_ms": statistics.median(ms[b])})
    del x, ref, out, buf


def wrapper_only(reps: int) -> None:
    for name in CELLS:
        h, delays, kill, out_n = cell_plan(name)
        x = samples(h, 7)
        scale = dd.output_scale(h["nbits"], int(kill.sum()))
        dd.dedisperse(x, delays, kill, out_n, scale=scale)
        ms = [timed(lambda: dd.dedisperse(x, delays, kill, out_n, scale=scale))
              for _ in range(reps)]
        say({"cell": name, "wrapper_ms": ms, "median_ms": statistics.median(ms)})
        del x
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH: another dedisperse.cu to build and time")
    ap.add_argument("--wrapper-only", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dedisp_probe: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    if args.wrapper_only:
        wrapper_only(args.reps)
        return 0
    sources = {"kernel": str(kernels.source("dedisperse"))}
    sources.update(s.split("=", 1) for s in args.source)
    with tempfile.TemporaryDirectory(prefix="dedisp_probe_") as tmp:
        libs = build(tmp, sources)
        for name in CELLS:
            probe_cell(name, libs, args.reps)
            torch.cuda.empty_cache()
    from chip_smoke import dedisperse_bands_phase

    dedisperse_bands_phase(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
