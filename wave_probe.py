"""Time the big grid's acceleration-search loop by part, in several checkouts
on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 wave_probe.py DIR [DIR ...]

Each DIR is the root of a checkout of the repository (this one is "."). The
script synthesizes chip_smoke.py's big grid once (64 channels x 2^21+8192
2-bit samples at 64 us, a P = 31.4 ms pulsar at DM 10; 77 DM x 45 accel
trials) and then, in the order given, runs a fresh process from each
checkout. Each process builds its checkout's kernels and searches the grid
with chip_smoke.py's GRID_CONFIG through ``PeasoupSearch`` on cuda:0
(a fresh search object each run, as one CLI run has):

1. a warm-up run, discarded;
2. two plain runs: their stage timers (``search_device``, ``search_host``,
   ``total``, ...);
3. a run with the search loop's parts wrapped in host clocks: the time
   inside each part (inclusive: a part called inside another counts in
   both), its calls, and the bytes the loop read back from the card (the
   numpy results of the parent's per-batch reads, or of the wave's packed
   fetches);
4. a run under ``torch.cuda.set_sync_debug_mode("warn")``: the
   synchronising operations the search loop made, each counted in the
   innermost part it happened in;
5. a run under ``torch.profiler``: the device's busy seconds (the CUDA
   kernels' and copies' device time, summed; the ranges of the pipelines'
   ``record_function`` scopes, which the trace also holds on the
   device's timeline, left out), the five largest by name,
   and the busy seconds' share of the plain runs' mean ``total`` (the
   profiler slows the host, so its own wall is printed apart).

The parts are whichever of these names the checkout has: the search loop
(``PeasoupSearch._search_trials``), the DM block's preprocessing
(``preprocess_block``), the row batch's arguments (``PeasoupSearch._job``:
in the per-batch loop, its two uploads), the round's table uploads
(``_upload``), the chain's dispatch (``sharded_search.search_rows``), the
resample wrapper (``accel_search.resample_rows``: in the per-batch loop,
with its bounds read), the sharded call (the function
``make_sharded_search_fn`` returns: in the per-batch loop, the dispatch and
its four reads), the per-batch overflow loop
(``PeasoupSearch._search_batch``), the wave's pack and compaction
(``pack_chunk_results``, ``compact_peaks_device``), its fetch (``_fetch``)
and the host unpack (``PeasoupSearch._collect``). Derived parts: dispatch
= search_rows less resample; the per-batch reads = the sharded call less
search_rows.

Each process prints one ``probe:`` JSON line; the script then prints the
card's name and power limit and one line with every checkout's numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

PROBE = r'''
import importlib, json, sys, time, warnings
import numpy as np
import torch

import chip_smoke
from peasoup_tpu_torch import kernels
from peasoup_tpu_torch.io.sigproc import read_filterbank
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from peasoup_tpu_torch.pipeline.search import PeasoupSearch

S, SH, AS = ("peasoup_tpu_torch.pipeline.search", "peasoup_tpu_torch.parallel.sharded_search",
             "peasoup_tpu_torch.pipeline.accel_search")
PARTS = [
    ("search loop", S, "PeasoupSearch._search_trials"),
    ("preprocess", S, "preprocess_block"),
    ("job", S, "PeasoupSearch._job"),
    ("upload", S, "_upload"),
    ("search_rows", SH, "search_rows"),
    ("resample", AS, "resample_rows"),
    ("search_batch", S, "PeasoupSearch._search_batch"),
    ("pack", S, "pack_chunk_results"),
    ("compact", S, "compact_peaks_device"),
    ("fetch", S, "_fetch"),
    ("collect", S, "PeasoupSearch._collect"),
]
dev = torch.device("cuda", 0)
fil = read_filterbank(sys.argv[1])
kernels.build()
stack, secs, calls, syncs, nbytes = [], {}, {}, {}, [0]
SYNCS = [False]


def timed(name, fn):
    def wrapper(*a, **k):
        stack.append(name)
        t0 = time.perf_counter()
        try:
            out = fn(*a, **k)
        finally:
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
            calls[name] = calls.get(name, 0) + 1
            stack.pop()
        if name in ("fetch", "sharded call") and not SYNCS[0]:
            arrays = [out] if isinstance(out, np.ndarray) else list(out)
            nbytes[0] += sum(a.nbytes for a in arrays if isinstance(a, np.ndarray))
        return out
    return wrapper


def patch():
    found = []
    for name, mod, attr in PARTS:
        m = importlib.import_module(mod)
        owner, _, leaf = attr.rpartition(".")
        obj = getattr(m, owner) if owner else m
        raw = obj.__dict__.get(leaf) if owner else getattr(m, leaf, None)
        if raw is None:
            continue
        if isinstance(raw, staticmethod):
            setattr(obj, leaf, staticmethod(timed(name, raw.__func__)))
        else:
            setattr(obj, leaf, timed(name, raw))
        found.append(name)
    sh = importlib.import_module(SH)
    make = sh.make_sharded_search_fn
    sh.make_sharded_search_fn = lambda *a, **k: timed("sharded call", make(*a, **k))
    return found


def run():
    res = PeasoupSearch(chip_smoke.GRID_CONFIG, device=dev).run(fil)
    torch.cuda.synchronize()
    return res


def timers(res):
    return {k: round(v, 6) for k, v in sorted(res.timers.items())}


run()
plain = [timers(run()) for _ in range(2)]
found = patch()
t0 = time.perf_counter()
res = run()
inst = dict(wall=time.perf_counter() - t0, timers=timers(res),
            secs={k: round(v, 6) for k, v in secs.items()}, calls=dict(calls),
            bytes_read=nbytes[0], candidates=len(res.candidates))
if "sharded call" in secs and "search_rows" in secs:
    inst["reads_s"] = round(secs["sharded call"] - secs["search_rows"], 6)
if "search_rows" in secs and "resample" in secs:
    inst["dispatch_s"] = round(secs["search_rows"] - secs["resample"], 6)
SYNCS[0] = True


def hook(message, category, filename, lineno, file=None, line=None):
    if "synchroniz" in str(message).lower():
        where = stack[-1] if stack else "outside"
        syncs[where] = syncs.get(where, 0) + 1


torch.cuda.synchronize()
old = warnings.showwarning
torch.cuda.set_sync_debug_mode("warn")
try:
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        run()
finally:
    torch.cuda.set_sync_debug_mode(0)
    warnings.showwarning = old
SYNCS[0] = False
t0 = time.perf_counter()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    run()
wall = time.perf_counter() - t0
by_name = {}
for e in prof.events():
    if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e6
busy = sum(by_name.values())
top = dict(sorted(((k[:60], round(v, 6)) for k, v in by_name.items()), key=lambda kv: -kv[1])[:5])
total = sum(t["total"] for t in plain) / len(plain)
print("probe: " + json.dumps(dict(
    checkout=sys.argv[2], plain=plain, parts_found=found, instrumented=inst,
    syncs=syncs, device_busy_s=round(busy, 6), device_top=top,
    profiled_wall_s=round(wall, 6), busy_share=round(busy / total, 6),
    device=torch.cuda.get_device_name(0),
)), flush=True)
'''


def main() -> int:
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("wave_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    with tempfile.TemporaryDirectory(prefix="wave_probe_") as tmp:
        path = os.path.join(tmp, "big.fil")
        chip_smoke.big_grid_fil(path)
        for d in dirs:
            root = os.path.abspath(d)
            proc = subprocess.run(
                [sys.executable, "-c", PROBE, path, d], cwd=root, capture_output=True,
                text=True, timeout=900, env=dict(os.environ, PYTHONPATH=root),
            )
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("probe: ")]
            if proc.returncode or not lines:
                print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
                print(f"wave_probe: the run in {d} failed (rc {proc.returncode})")
                return 1
            print(lines[-1], flush=True)
            rows.append(json.loads(lines[-1][len("probe: "):]))
    print(smi)
    print(json.dumps([dict(checkout=r["checkout"], plain=r["plain"],
                           syncs=r["syncs"], bytes_read=r["instrumented"]["bytes_read"],
                           busy_share=r["busy_share"]) for r in rows]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
