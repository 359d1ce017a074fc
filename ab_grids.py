"""Time the port's two survey-sized searches in several checkouts on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 ab_grids.py DIR [DIR ...] [--rounds N]

Each DIR is the root of a checkout of the repository (this one is ".").
The script synthesizes chip_smoke.py's big grid (64 channels x 2^21+8192
2-bit samples at 64 us, a P = 31.4 ms pulsar at DM 10) and single-pulse
grid (the same geometry with three dispersed pulses) once, builds every
checkout's kernels (one process per checkout, all at once), and then runs
`peasoup` on the big grid and `spsearch` on the single-pulse grid with
chip_smoke.py's flags in a fresh process from each checkout, in the order
given and then reversed (A B B A; ``--rounds`` times), so that a drift of
the card's clocks falls on every checkout alike. In the same order it
times, in a process per checkout, the per-trial statistics of the two
searches on the card at the grids' shapes: ``spectrum_stats`` over the
big grid's spectra (77 x 2^20+1) and ``normalise_trials`` over the
single-pulse grid's trials (179 x 2,101,288), CUDA events, median of 5
after a warm-up. Also in that order, each in a fresh process: the boxcar
kernel (``ops.singlepulse.boxcar_best``) at the stream's window (179 x
27,648 prefix sums, 12 widths) and at the single-pulse grid's block (179
x 2,108,416), random prefix sums from seed 7: one call under CUDA events
(median of 5, after a warm-up), the kernel's device time alone
(torch.profiler, the mean over the launches it recorded of 10) and the time a call takes
with 20 queued back to back; and `peasoup-stream --replay` of the
single-pulse grid with chip_smoke.py's flags (chunk latency p50 and p95,
stage timers). It prints each run's stage timers (from the run's
overview.xml, or the stream's -v lines) and each timing as a JSON line,
then the card's name and power limit, then one line with every
checkout's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

import chip_smoke

GRIDS = (
    ("big grid", "peasoup", chip_smoke.GRID_FLAGS, chip_smoke.big_grid_fil),
    ("single-pulse grid", "spsearch", chip_smoke.SP_FLAGS, chip_smoke.sp_grid_fil),
)
WARM = (
    "from peasoup_tpu_torch import kernels; kernels.build(); "
    "from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig; "
    "PeasoupSearch(SearchConfig())"
)

# timing helpers for the scripts below, which run in a fresh process from
# each checkout and so import nothing of this one
MEDIAN_MS = """
import json, statistics, torch

def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
"""

STATS = MEDIAN_MS + """
from peasoup_tpu_torch.ops.singlepulse import normalise_trials
from peasoup_tpu_torch.ops.spectrum import spectrum_stats

g = torch.Generator(device="cuda").manual_seed(7)
s0 = torch.rand((77, (1 << 20) + 1), device="cuda", generator=g)
trials = torch.randn((179, 2_101_288), device="cuda", generator=g)
print(json.dumps({"spectrum_stats_ms": median_ms(lambda: spectrum_stats(s0)),
                  "normalise_trials_ms": median_ms(lambda: normalise_trials(trials))}))
"""


BOXCAR = MEDIAN_MS + """
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from peasoup_tpu_torch.ops.singlepulse import (
    boxcar_best, default_widths, plan_pad, width_extent, width_scales,
)

# chip_smoke.py:kernel_split's rule: the mean over the launches the
# profiler recorded (it can miss some), failing if it recorded none
def kernel_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = [e.device_time_total / 1e3 for e in prof.events()
          if e.device_type == DeviceType.CUDA and "boxcar" in e.name]  # the parent's name too
    if not ms:
        raise RuntimeError(f"the profiler recorded no boxcar launch ({reps} calls)")
    return sum(ms) / len(ms), len(ms)

def queued_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps

widths = default_widths(12)
scales = width_scales(widths)
wext = width_extent(widths)
g = torch.Generator(device="cuda").manual_seed(7)
out = {}
for label, n in (("stream", 18_432), ("single-pulse grid", 2_101_288)):
    tpad = plan_pad(n)[0]
    csum = torch.zeros((179, tpad + wext), device="cuda")
    csum[:, 1 : n + 1] = torch.cumsum(torch.randn((179, n), device="cuda", generator=g), -1)
    fn = lambda: boxcar_best(csum, widths, scales, n, tpad)
    ms, launches = kernel_ms(fn)
    out[label] = {"call_ms": median_ms(fn), "kernel_ms": ms, "profiled_launches": launches,
                  "queued_ms": queued_ms(fn), "shape": [179, tpad + wext]}
    del csum
print(json.dumps(out))
"""

# the stream's `-v` summary and its stage timers (cli/stream.py)
DRAINED = re.compile(r"Stream drained: (\d+) chunks, (\d+) triggers -> .* \(latency p50 "
                     r"([\d.]+) ms, p95 ([\d.]+) ms")


def run_script(tree: str, script: str, what: str) -> dict:
    """The JSON line a timing script prints, run in a fresh process from ``tree``."""
    proc = subprocess.run([sys.executable, "-c", script], cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"{what} timing in {tree} exited with {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_stream(tree: str, fil: str, outdir: str) -> dict:
    """`peasoup-stream --replay` of ``fil`` in a fresh process from ``tree``:
    its chunks, triggers, chunk latency p50 and p95 (ms) and stage timers."""
    cmd = [sys.executable, "-m", "peasoup_tpu_torch.cli.stream", "--replay", fil,
           "-o", outdir, *chip_smoke.STREAM_FLAGS, "-v"]
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"peasoup-stream in {tree} exited with {proc.returncode}")
    drained, timer_line = proc.stdout.strip().splitlines()[-2:]
    m = DRAINED.match(drained)
    if m is None:
        raise RuntimeError(f"peasoup-stream in {tree} printed no summary: {drained!r}")
    return {"chunks": int(m.group(1)), "triggers": int(m.group(2)),
            "p50_ms": float(m.group(3)), "p95_ms": float(m.group(4)),
            "timers": json.loads(timer_line.split(": ", 1)[1])}


def run_cli(tree: str, cli: str, fil: str, outdir: str, flags: list) -> dict:
    """One CLI run in a fresh process from ``tree``; returns its timers."""
    cmd = [sys.executable, "-m", f"peasoup_tpu_torch.cli.{cli}", "-i", fil,
           "-o", outdir, *flags]
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"{cli} in {tree} exited with {proc.returncode}")
    root = ET.parse(os.path.join(outdir, "overview.xml")).getroot()
    return {e.tag: float(e.text) for e in root.find("execution_times")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in order")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times the order and its reverse are run")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    builds = [subprocess.Popen([sys.executable, "-c", WARM], cwd=t) for t in trees]
    if any(p.wait() != 0 for p in builds):
        raise RuntimeError("a checkout's kernels did not build")
    with tempfile.TemporaryDirectory() as tmp:
        fils = {}
        for label, _, _, make in GRIDS:
            fils[label] = os.path.join(tmp, label.replace(" ", "_") + ".fil")
            make(fils[label])
        runs: dict = {t: {label: [] for label, *_ in GRIDS} for t in trees}
        for t in trees:
            runs[t].update(statistics=[], boxcar=[], stream=[])
        for i, tree in enumerate((trees + trees[::-1]) * args.rounds):
            stats = run_script(tree, STATS, "statistics")
            runs[tree]["statistics"].append(stats)
            print(json.dumps({"tree": tree, "statistics": stats}), flush=True)
            box = run_script(tree, BOXCAR, "boxcar")
            runs[tree]["boxcar"].append(box)
            print(json.dumps({"tree": tree, "boxcar": box}), flush=True)
            stream = run_stream(tree, fils["single-pulse grid"],
                                os.path.join(tmp, f"out{i}_stream"))
            runs[tree]["stream"].append(stream)
            print(json.dumps({"tree": tree, "stream": stream}), flush=True)
            for label, cli, flags, _ in GRIDS:
                outdir = os.path.join(tmp, f"out{i}_{cli}")
                timers = run_cli(tree, cli, fils[label], outdir, flags)
                runs[tree][label].append(timers)
                print(json.dumps({"tree": tree, "grid": label, "timers": timers}),
                      flush=True)
    print(card)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
