"""What holds the boxcar kernel and its wrapper on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 boxcar_probe.py

It builds csrc/boxcar.cu as it is and in variants that each change one
thing (a macro boxcar.cu tests, defined on nvcc's command line; one nvcc
each, all at once, into a temporary directory): ``plain_stores``
(st.global in place of the evict-first streaming stores),
``spchain_sweep`` (spchain's tracking sweep, which keeps each group's
eight prefix sums in registers across the widths), ``no_skip`` (warps
past nvalid sweep too) and ``memory_only`` (the tiles that fit are not
swept: each sample's lo stored as its best; not the kernel's function,
so not bitwise). It prints each one's registers and spills as the
runtime reports them, then times each at the stream's window (179 x
27,648 prefix sums, 12 widths) and at the single-pulse grid's block (179
x 2,108,416):
CUDA events around 20 launches queued back to back through the C entry,
after a warm-up, in turns (the variants in order, then reversed, three
times), with each checked bitwise against the plain version. Last, the
host's part of a ``boxcar_best`` call at the stream's shape, piece by
piece (host clock over 300 calls each). The card's name and power limit
come first, one JSON object per measurement after.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from peasoup_tpu_torch import kernels  # noqa: E402
from peasoup_tpu_torch.device import check, on_cpu, stream_ptr  # noqa: E402
from peasoup_tpu_torch.ops import singlepulse as sp  # noqa: E402

# variant -> the macros it defines (boxcar.cu says what each changes)
VARIANTS = {
    "kernel": [],
    "plain_stores": ["BOXCAR_PLAIN_STORES"],
    "spchain_sweep": ["BOXCAR_SPCHAIN_SWEEP"],
    "no_skip": ["BOXCAR_NO_SKIP"],
    "memory_only": ["BOXCAR_MEMORY_ONLY"],
}
SHAPES = (("stream", 18_432), ("single-pulse grid", 2_101_288))


def say(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def build(tmp: str) -> dict:
    """One shared library a variant, built at once; each one's resources
    printed."""
    libs = kernels.build_variants(
        "boxcar", {name: (kernels.source("boxcar"), macros) for name, macros in VARIANTS.items()},
        tmp,
    )
    for name, lib in libs.items():
        say({"variant": name, "resources": kernels.boxcar_resources(lib)})
    return {name: lib.boxcar_best for name, lib in libs.items()}


def time_variants(entries: dict) -> None:
    widths = sp.default_widths(12)
    scales = sp.width_scales(widths)
    wext = sp.width_extent(widths)
    w_host = np.asarray(widths, np.int32)
    s_host = np.asarray(scales, np.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    stream = torch.cuda.current_stream().cuda_stream
    for label, n in SHAPES:
        tpad = sp.plan_pad(n)[0]
        csum = torch.zeros((179, tpad + wext), device="cuda")
        csum[:, 1 : n + 1] = torch.cumsum(torch.randn((179, n), device="cuda", generator=g), -1)
        ref = sp.boxcar_best_plain(csum, widths, scales, n, tpad)
        best = torch.empty((179, tpad), device="cuda")
        bw = torch.empty((179, tpad), dtype=torch.int32, device="cuda")

        def call(name):
            rc = entries[name](csum.data_ptr(), w_host.ctypes.data, s_host.ctypes.data,
                               len(widths), 179, tpad + wext, tpad, n, best.data_ptr(),
                               bw.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"variant {name}: the entry returned {rc}")

        res = {}
        for name in entries:
            best.fill_(7.0)
            bw.fill_(-1)
            call(name)
            torch.cuda.synchronize()
            res[name] = {"bitwise": torch.equal(best.view(torch.int32), ref[0].view(torch.int32))
                         and torch.equal(bw, ref[1]), "ms": []}
        del ref
        reps = 20
        for _ in range(3):
            for name in list(entries) + list(entries)[::-1]:
                call(name)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(reps):
                    call(name)
                end.record()
                end.synchronize()
                res[name]["ms"].append(start.elapsed_time(end) / reps)
        for name, r in res.items():
            say({"shape": label, "variant": name, "bitwise": r["bitwise"],
                 "median_ms": statistics.median(r["ms"]), "ms": r["ms"]})
        del csum, best, bw
        torch.cuda.empty_cache()


def time_host() -> None:
    """The host's part of a boxcar_best call at the stream's shape."""
    widths = sp.default_widths(12)
    scales = sp.width_scales(widths)
    wext = sp.width_extent(widths)
    n = SHAPES[0][1]
    tpad = sp.plan_pad(n)[0]
    csum = torch.zeros((179, tpad + wext), device="cuda")
    dev = csum.device
    w_host = np.asarray(widths, np.int32)
    s_host = np.asarray(scales, np.float32)
    best = torch.empty((179, tpad), dtype=torch.float32, device=dev)
    bw = torch.empty((179, tpad), dtype=torch.int32, device=dev)
    stream = stream_ptr(dev)
    args = (csum.data_ptr(), w_host.ctypes.data, s_host.ctypes.data, len(widths), 179,
            tpad + wext, tpad, n, best.data_ptr(), bw.data_ptr(), stream)
    parts = {
        "boxcar_best": lambda: sp.boxcar_best(csum, widths, scales, n, tpad),
        "checks": lambda: (sp._check_sweep(csum, widths, scales, tpad), on_cpu(csum),
                           check(csum, "csum_pad", torch.float32, 2)),
        "bank to host arrays": lambda: sp._kernel_bank(csum, widths, scales),
        "torch.empty x2": lambda: (torch.empty((179, tpad), dtype=torch.float32, device=dev),
                                   torch.empty((179, tpad), dtype=torch.int32, device=dev)),
        "stream_ptr": lambda: stream_ptr(dev),
        "kernels.launch": lambda: kernels.launch("boxcar", *args, shape=(179, tpad, wext, 12)),
    }
    us = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(300):
            fn()
        us[name] = (time.perf_counter() - t0) / 300 * 1e6
        torch.cuda.synchronize()
    say({"host_us_a_call": us})


def main() -> int:
    if not torch.cuda.is_available():
        print("boxcar_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    say(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    kernels.load(["boxcar"])
    with tempfile.TemporaryDirectory(prefix="boxcar_probe_") as tmp:
        time_variants(build(tmp))
    time_host()
    return 0


if __name__ == "__main__":
    sys.exit(main())
