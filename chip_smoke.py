"""On-card smoke test of the PyTorch / CUDA port (peasoup_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build every kernel from csrc/ (one nvcc per source, in parallel).
  3. The port's `peasoup` CLI on a synthesized big-grid filterbank
     (64 channels x 2^21+8192 2-bit samples, 64 us, P = 31.4 ms pulsar
     at DM 10; dm_end 20, acc +-0.5, every accel trial searched): the
     top candidate must be the pulsar and every kernel must have run.
     With --profile this run is traced by torch.profiler, which prints
     device time by kernel and the device's busy share (and slows the
     host, so the stage timers of a profiled run are not the search's).
  4. Hold each kernel against its plain torch version on the card at the
     launch shape the CLI run used most, and time both (CUDA events,
     median of a few runs) beside the least time the card could take.
  5. The card's search against the CPU search (plain versions) on a
     small 8-bit filterbank: the strong candidates must agree.
The second-last line is a JSON object with one entry per kernel, the
last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from peasoup_tpu_torch import kernels  # noqa: E402
from peasoup_tpu_torch.io.sigproc import (  # noqa: E402
    Filterbank, SigprocHeader, read_filterbank, write_filterbank,
)
from peasoup_tpu_torch.ops.dedisperse import (  # noqa: E402
    dedisperse, dedisperse_block, fil_to_device, output_scale,
)
from peasoup_tpu_torch.ops.fft import (  # noqa: E402
    packed_dft_z, untwist_interbin_normalise, untwist_interbin_normalise_plain,
)
from peasoup_tpu_torch.ops.harmonics import level_scales  # noqa: E402
from peasoup_tpu_torch.ops.peaks import (  # noqa: E402
    find_harmonic_cluster_peaks, find_harmonic_cluster_peaks_plain,
)
from peasoup_tpu_torch.ops.resample import accel_factor, resample_accel  # noqa: E402
from peasoup_tpu_torch.ops.spectrum import (  # noqa: E402
    interp_deredden_zap, s0_envelope, specchain,
)
from peasoup_tpu_torch.pipeline.accel_search import (  # noqa: E402
    _pre_spectrum_parts, padded_bins, preprocess_block,
)
from peasoup_tpu_torch.pipeline.search import (  # noqa: E402
    PeasoupSearch, SearchConfig,
)
from peasoup_tpu_torch.plan.dm_plan import delay_table  # noqa: E402

# the H100 SXM's published peaks (NVIDIA data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# the big grid: bench.py's pinned survey-scale grid ("Big grid, round 5")
NCHANS, NSAMPS, TSAMP, FCH1 = 64, (1 << 21) + 8192, 64e-6, 1500.0
FOFF = -300.0 / NCHANS
PERIOD, PULSAR_DM = 0.0314, 10.0
# every accel trial is searched (no dedupe), as the JAX package's bench
# runs this grid (bench.py:411)
GRID_FLAGS = [
    "--dm_end", "20", "--acc_start", "-0.5", "--acc_end", "0.5",
    "--acc_pulse_width", "0.064", "--npdmp", "0", "--no_accel_dedupe",
]
GRID_CONFIG = SearchConfig(
    dm_end=20.0, acc_start=-0.5, acc_end=0.5, acc_pulse_width=0.064,
    npdmp=0, dedupe_accel=False,
)

SOURCES = {
    "dedisperse": "peasoup_tpu/ops/pallas/dedisperse.py:157",
    "specchain": "peasoup_tpu/ops/pallas/specchain.py:139",
    "interbin": "peasoup_tpu/ops/pallas/interbin.py:152",
    "harmpeaks": "peasoup_tpu/ops/pallas/harmpeaks.py:202",
}


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def big_grid_fil(path: str) -> None:
    """Synthesize the big-grid filterbank (the recipe of bench.py:355,
    seed 7)."""
    nchans, nsamps = NCHANS, NSAMPS
    rng = np.random.default_rng(7)
    delays = np.rint(
        np.float32(10.0) * np.abs(delay_table(FCH1, FOFF, nchans, TSAMP))
    ).astype(np.int64)
    t = np.arange(nsamps, dtype=np.float64)
    pulse = ((t * TSAMP / PERIOD) % 1.0) < 0.08
    data = rng.integers(0, 3, size=(nsamps, nchans), dtype=np.uint8)
    for c in range(nchans):
        src = np.clip(t - delays[c], 0, nsamps - 1).astype(np.int64)
        data[:, c] += pulse[src]
    hdr = SigprocHeader(
        source_name="big_grid_synth", data_type=1, nchans=nchans, nbits=2,
        nifs=1, tsamp=TSAMP, tstart=51000.0, fch1=FCH1, foff=FOFF,
    )
    write_filterbank(path, Filterbank(header=hdr, data=data))


def small_fil(path: str) -> None:
    """8-bit 16-channel filterbank with a P = 64 ms pulsar at DM 20 (the
    recipe of tests/test_pipeline.py:make_synthetic_fil)."""
    nsamps, nchans, tsamp, period, dm, fch1, foff = (
        1 << 15, 16, 0.000256, 0.064, 20.0, 1400.0, -8.0,
    )
    rng = np.random.default_rng(7)
    data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
    freqs = fch1 + np.arange(nchans) * foff
    delays = 4.148808e3 * dm * (freqs**-2 - fch1**-2) / tsamp
    t = np.arange(nsamps)
    for c in range(nchans):
        phase = ((t - delays[c]) * tsamp / period) % 1.0
        data[:, c] += 1.2 * 8.0 * (phase < 0.03)
    hdr = SigprocHeader(
        source_name="FAKE", tsamp=tsamp, tstart=55000.0, fch1=fch1, foff=foff,
        nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    data = np.clip(np.rint(data), 0, 255).astype(np.uint8)
    write_filterbank(path, Filterbank(header=hdr, data=data))


def main_shape(shapes: dict, name: str) -> tuple:
    """The launch shape kernel ``name`` ran at most often on the main
    path (the full row batch; the larger on a tie)."""
    require(len(shapes[name]) > 0, f"kernel {name} launched on the main path")
    return max(shapes[name].items(), key=lambda kv: (kv[1], kv[0]))[0]


def kernel_phase(dev: torch.device, fil, cfg: SearchConfig, shapes: dict) -> dict:
    """Each kernel against its plain version, on the inputs the big-grid
    search gives it: the filterbank and the search plan, the spectra of
    its DM trials, and one row batch, as large as the main path's and
    built as the search builds it, of the (DM, accel) rows around the
    pulsar's DM trial."""
    out = {}
    search = PeasoupSearch(cfg, device=dev)
    plan = search.build_plan(fil)
    size = plan.size
    m, nbins, npad = size // 2, size // 2 + 1, padded_bins(size)

    # dedisperse: every DM trial of the plan over the 2-bit filterbank
    x = fil_to_device(fil, dev)
    delays = torch.from_numpy(plan.delays).to(dev)
    kill = torch.from_numpy(plan.killmask).to(dev)
    ndm, out_n = plan.ndm, plan.out_nsamps
    require(main_shape(shapes, "dedisperse") == (fil.nsamps, fil.nchans, ndm, out_n),
            "dedisperse checked at the main path's shape")
    require(main_shape(shapes, "specchain") == (ndm, nbins),
            "specchain checked at the main path's shape (one DM block)")
    scale = output_scale(fil.nbits, int(plan.killmask.sum()))
    trials = dedisperse(x, delays, kill, out_n, scale=scale)
    ref = dedisperse_block(x, delays, kill, out_nsamps=out_n, scale=scale)
    torch.cuda.synchronize()
    err = float((trials.int() - ref.int()).abs().max())
    require(err == 0, "dedisperse bitwise equal to its plain version")
    out["dedisperse"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: dedisperse(x, delays, kill, out_n, scale=scale)),
        plain_ms=time_ms(
            lambda: dedisperse_block(x, delays, kill, out_nsamps=out_n, scale=scale),
            reps=3,
        ),
        bound=bound(x.numel() + delays.numel() * 4 + ndm * out_n,
                    2.0 * ndm * out_n * fil.nchans),
        shape=f"({fil.nsamps}, {fil.nchans}) u8 -> ({ndm}, {out_n}) u8",
    )
    del x, ref

    # specchain: the raw spectra of every DM trial
    tobs = float(np.float32(size) * np.float32(fil.tsamp))
    bin_width = float(np.float32(1.0 / tobs))
    geometry = dict(
        size=size, nsamps_valid=min(out_n, size),
        pos5=int(cfg.boundary_5_freq / bin_width),
        pos25=int(cfg.boundary_25_freq / bin_width),
    )
    re, im, med = _pre_spectrum_parts(trials, **geometry)
    zap = torch.from_numpy(plan.zapmask).to(dev)
    got = specchain(re, im, med, zap)
    ref = interp_deredden_zap(re, im, med, zap)
    torch.cuda.synchronize()
    require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
            "specchain parts bitwise equal to the plain version")
    dev_s0 = (got[2] - ref[2]).abs()
    require(bool((dev_s0 <= s0_envelope(ref[2])).all()),
            "specchain s0 within s0_envelope")
    out["specchain"] = dict(
        max_abs_err=float(dev_s0.max()),
        ms=time_ms(lambda: specchain(re, im, med, zap)),
        plain_ms=time_ms(lambda: interp_deredden_zap(re, im, med, zap)),
        bound=bound(ndm * nbins * 24 + nbins, ndm * nbins * 14),
        shape=f"3 x ({ndm}, {nbins}) f32",
    )
    del re, im, med, got, ref, dev_s0

    # interbin and harmpeaks: one row batch of the main path's size, the
    # (DM, accel) rows around the pulsar's DM trial, resampled and
    # transformed as PeasoupSearch._search_trials and search_rows do
    rows, m_main, npad_main = main_shape(shapes, "interbin")
    h_rows, h_npad, nharms, mx = main_shape(shapes, "harmpeaks")
    require((m_main, npad_main, h_rows, h_npad) == (m, npad, rows, npad),
            "interbin and harmpeaks ran at one row batch of the plan's size")
    all_rows = [(d, a) for d in range(ndm) for a in range(len(plan.accel_lists[d]))]
    require(rows <= len(all_rows), "the row batch fits the grid")
    dp = int(np.argmin(np.abs(plan.dm_list - PULSAR_DM)))
    mid = all_rows.index((dp, 0)) + len(plan.accel_lists[dp]) // 2
    r0 = max(0, min(mid - rows // 2, len(all_rows) - rows))
    batch = all_rows[r0 : r0 + rows]
    lo, hi = batch[0][0], batch[-1][0] + 1
    xd, mean_d, std_d = preprocess_block(trials[lo:hi, :size], zap, **geometry)
    del trials
    dsel = torch.tensor([d - lo for d, _ in batch], device=dev)
    afs = torch.from_numpy(np.asarray(
        [accel_factor(plan.accel_lists[d], fil.tsamp).astype(np.float32)[a]
         for d, a in batch], np.float32,
    )).to(dev)
    z = packed_dft_z(resample_accel(xd[dsel], afs[:, None])[:, 0])
    mean, std = mean_d[dsel], std_d[dsel]
    got = untwist_interbin_normalise(z, mean, std, npad=npad)
    ref = untwist_interbin_normalise_plain(z, mean, std, npad=npad)
    torch.cuda.synchronize()
    body, ref_body = got[:, :nbins], ref[:, :nbins]
    rms = torch.sqrt(torch.mean(ref_body * ref_body, dim=1, keepdim=True))
    err = (body - ref_body).abs()
    require(bool((err <= 1e-5 * (ref_body.abs() + rms)).all()),
            "interbin within 1e-5*(|ref|+rms) of the plain version")
    require(not bool(got[:, nbins:].any()), "interbin pad bins exactly zero")
    out["interbin"] = dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: untwist_interbin_normalise(z, mean, std, npad=npad)),
        plain_ms=time_ms(
            lambda: untwist_interbin_normalise_plain(z, mean, std, npad=npad)
        ),
        bound=bound(rows * (m * 8 + npad * 4) + (m + 1) * 8, rows * nbins * 30.0),
        shape=f"({rows}, {m}) c64 -> ({rows}, {npad}) f32, DM trials "
              f"{lo}..{hi - 1}",
    )
    del z, ref, body, ref_body, err

    windows = plan.windows
    kw = dict(nharms=nharms, threshold=float(np.float32(cfg.min_snr)),
              max_peaks=mx, scales=level_scales(nharms), nbins=nbins)
    spec = got
    k_out = find_harmonic_cluster_peaks(spec, windows, **kw)
    p_out = find_harmonic_cluster_peaks_plain(spec, windows, **kw)
    torch.cuda.synchronize()
    for a, b, name in zip(k_out, p_out, ("idxs", "snrs", "counts", "ccounts")):
        require(torch.equal(a, b), f"harmpeaks {name} equal to the plain version")
    require(int(k_out[3].sum()) > 0, "harmpeaks test rows hold clusters")
    nlev = nharms + 1
    out["harmpeaks"] = dict(
        max_abs_err=float((k_out[1] - p_out[1]).abs().max()),
        ms=time_ms(lambda: find_harmonic_cluster_peaks(spec, windows, **kw)),
        plain_ms=time_ms(
            lambda: find_harmonic_cluster_peaks_plain(spec, windows, **kw), reps=3
        ),
        bound=bound(rows * nbins * 4 + rows * nlev * (mx * 8 + 8),
                    rows * nbins * (15 + 2 * nlev)),
        shape=f"({rows}, {npad}) f32, nharms {nharms}, max_peaks {mx}, "
              f"{int(k_out[3].sum())} clusters",
    )
    return out


def grid_phase(path: str, outdir: str, profile: bool) -> dict:
    """The port's CLI on the big grid; returns its launches, launch
    shapes and timers."""
    from peasoup_tpu_torch.cli.peasoup import main

    argv = ["-i", path, "-o", outdir, *GRID_FLAGS]
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tracer

        prof = tracer(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    shapes = {k: v.copy() for k, v in kernels.launch_shapes.items()}
    if profile:
        prof.stop()
        print_profile(prof, wall)
    require(rc == 0, "peasoup CLI exit code 0")
    for name in ("candidates.peasoup", "overview.xml"):
        require(os.path.exists(os.path.join(outdir, name)), f"{name} written")
    root = ET.parse(os.path.join(outdir, "overview.xml")).getroot()
    top = root.find("candidates/candidate")
    require(top is not None, "at least one candidate")
    period = float(top.find("period").text)
    say(f"top candidate: period {period!r} s, dm {top.find('dm').text}, "
        f"acc {top.find('acc').text}, nh {top.find('nh').text}, "
        f"snr {top.find('snr').text}")
    require(abs(period - PERIOD) / PERIOD < 2e-3,
            f"top candidate period {period} within 2e-3 of {PERIOD}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} launched on the main path")
    timers = {e.tag: float(e.text) for e in root.find("execution_times")}
    return dict(launches=launches, shapes=shapes, timers=timers, wall=wall)


def agreement_phase(tmp: str) -> int:
    """The card's search against the CPU search on a small input."""
    path = os.path.join(tmp, "small.fil")
    small_fil(path)
    fil = read_filterbank(path)
    cfg = SearchConfig(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0,
                       min_snr=6.0)
    gpu = PeasoupSearch(cfg, device="cuda").run(fil).candidates
    cpu = PeasoupSearch(cfg, device="cpu").run(fil).candidates
    # cuFFT and the CPU FFT round differently, so compare the candidates
    # clear of the threshold: same identity, S/N within 1e-3
    strong = [c for c in cpu if c.snr >= 1.1 * cfg.min_snr]
    require(len(strong) > 0, "small input yields strong candidates")
    got = [c for c in gpu if c.snr >= 1.1 * cfg.min_snr]
    require(len(got) == len(strong), "same number of strong candidates")
    for a, b in zip(strong, got):
        require(
            (a.dm_idx, a.acc, a.nh, a.freq) == (b.dm_idx, b.acc, b.nh, b.freq)
            and abs(a.snr - b.snr) <= 1e-3 * a.snr,
            f"candidate agrees: cpu {a} vs cuda {b}",
        )
    return len(strong)


def print_profile(prof, wall: float) -> None:
    """Device time by kernel (sums over the traced run) and the device's
    busy share of the run's wall time."""
    from torch.autograd import DeviceType

    by_kernel: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_kernel.setdefault(e.name, [0.0, 0])
            entry[0] += e.device_time_total / 1e3
            entry[1] += 1
    busy = sum(ms for ms, _ in by_kernel.values())
    say(f"profile: {wall:.3f} s wall under the profiler, {busy / 1e3:.3f} s of "
        f"kernels on the device ({100 * busy / 1e3 / wall:.1f}% busy)")
    for name, (ms, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        say(f"profile: {ms:10.3f} ms {n:6d} launches  {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the big grid's CLI run with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = kernels.build()
    say(f"built kernels in {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "big_grid.fil")
        t0 = time.perf_counter()
        big_grid_fil(path)
        say(f"synthesized big-grid filterbank in {time.perf_counter() - t0:.1f} s")
        fil = read_filterbank(path)
        plan = PeasoupSearch(GRID_CONFIG, device=dev).build_plan(fil)
        ntrials = sum(len(a) for a in plan.accel_lists)

        grid = grid_phase(path, os.path.join(tmp, "out"), args.profile)
        say(f"big grid: {plan.ndm} DM trials, {ntrials} DM x accel trials, "
            f"{grid['wall']:.3f} s CLI wall, "
            f"{ntrials / grid['timers']['searching']:.1f} trials/s "
            "over the searching stage")
        say("stage timers (s): " + json.dumps(grid["timers"], sort_keys=True))
        say("kernel launches on the main path: " + json.dumps(grid["launches"]))
        say("launch shapes on the main path: " + json.dumps(
            {k: {str(s): n for s, n in v.items()} for k, v in grid["shapes"].items()}
        ))

        checks = kernel_phase(dev, fil, GRID_CONFIG, grid["shapes"])
        for name, c in checks.items():
            say(f"{name}: {c['shape']}: {c['ms']:.4f} ms kernel, "
                f"{c['plain_ms']:.4f} ms plain, bound {c['bound'][0]:.4f} ms "
                f"({c['bound'][1]}), max |err| {c['max_abs_err']}")
        del fil
        torch.cuda.empty_cache()

        n = agreement_phase(tmp)
        say(f"small input: {n} strong candidates agree between cuda and cpu")

    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": f"peasoup_tpu_torch/csrc/{name}.cu",
            "replaces": SOURCES[name],
            "launches": grid["launches"][name],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1],
            "library_ms": None,
        }
        for name, c in checks.items()
    ]
    say(json.dumps({"kernels": entries}))
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
