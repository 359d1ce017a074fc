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
     With --profile this run and the next are traced by torch.profiler,
     which prints device time by kernel and the device's busy share (and
     slows the host, so the stage timers of a profiled run are not the
     search's).
  4. The CLI on the binary grid: the big grid's filterbank geometry with
     a P = 5.03 ms pulsar (duty 0.03) at DM 10 under a constant
     +100 m/s^2 acceleration, searched with dm_end 20, acc -150..150
     (resample shifts of up to 17.6 samples) and --npdmp 10: the top
     candidate must be the pulsar at a non-zero accel trial near
     +100 m/s^2, folded, and every kernel must have run.
  5. Hold each kernel against its plain torch version on the card at the
     launch shape a CLI run used most (resample: the binary grid's; the
     others: the big grid's), and time both (CUDA events, median of a
     few runs) beside the least time the card could take.
  6. The card's search against the CPU search (plain versions) on a
     small 8-bit filterbank, folding its top 5: the strong candidates
     and the fold outcomes must agree.
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
from peasoup_tpu_torch.ops.resample import (  # noqa: E402
    accel_factor, resample_rows, resample_rows_plain,
)
from peasoup_tpu_torch.ops.spectrum import (  # noqa: E402
    interp_deredden_zap, s0_envelope, specchain,
)
from peasoup_tpu_torch.pipeline.accel_search import (  # noqa: E402
    _pre_spectrum_parts, padded_bins, preprocess_block,
)
from peasoup_tpu_torch.pipeline.search import (  # noqa: E402
    PeasoupSearch, SearchConfig,
)
from peasoup_tpu_torch.plan.accel_plan import AccelerationPlan  # noqa: E402
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

# the binary grid: the big grid's geometry, an accelerated pulsar, and a
# binary search's accel range with folding (every other flag at the
# CLI's default, accel dedupe included). The pulse is 2.4 samples wide
# (duty 0.03): at duty 0.10 the fundamental folds to S/N 13.6 at the
# pulsar's own trial, in the JAX package as in the port
# (tests/test_torch_search.py::test_binary_grid_pulse_duty).
BIN_PERIOD, BIN_DUTY, BIN_ACC, BIN_SIZE = 0.00503, 0.03, 100.0, 1 << 21
BINARY_FLAGS = [
    "--dm_end", "20", "--acc_start", "-150", "--acc_end", "150", "--npdmp", "10",
]
BINARY_CONFIG = SearchConfig(dm_end=20.0, acc_start=-150.0, acc_end=150.0, npdmp=10)

SOURCES = {
    "dedisperse": "peasoup_tpu/ops/pallas/dedisperse.py:157",
    "resample": "peasoup_tpu/ops/pallas/resample.py:167",
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


def binary_grid_fil(path: str, duty: float = BIN_DUTY) -> None:
    """Synthesize the binary grid's filterbank: the big grid's geometry and
    noise, with the pulse phase (on for a fraction ``duty`` of the
    period) following the inverse of the search's resample map at
    +100 m/s^2 (tests/test_accel_recovery.py's recipe), so that the
    matching accel trial resamples it back to an exactly periodic
    series; whole-sample DM delays per channel."""
    nchans, nsamps = NCHANS, NSAMPS
    rng = np.random.default_rng(7)
    delays = np.rint(
        np.float32(PULSAR_DM) * np.abs(delay_table(FCH1, FOFF, nchans, TSAMP))
    ).astype(np.int64)
    af = float(accel_factor(np.array([BIN_ACC]), TSAMP)[0])
    j = np.arange(nsamps, dtype=np.float64)
    ginv = j - af * j * (j - BIN_SIZE)
    pulse = (((ginv * TSAMP / BIN_PERIOD) % 1.0) < duty).astype(np.uint8)
    data = rng.integers(0, 3, size=(nsamps, nchans), dtype=np.uint8)
    for c in range(nchans):
        src = np.clip(j - delays[c], 0, nsamps - 1).astype(np.int64)
        data[:, c] += pulse[src]
    hdr = SigprocHeader(
        source_name="binary_grid_synth", data_type=1, nchans=nchans, nbits=2,
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


def pulsar_rows(plan, dms, rows: int) -> list:
    """``rows`` consecutive (DM, accel) rows of the DM trials ``dms``,
    centred on the pulsar's DM trial, in the search's row order."""
    all_rows = [(d, a) for d in dms for a in range(len(plan.accel_lists[d]))]
    require(rows <= len(all_rows), "the row batch fits the grid")
    dp = int(np.argmin(np.abs(plan.dm_list - PULSAR_DM)))
    mid = all_rows.index((dp, 0)) + len(plan.accel_lists[dp]) // 2
    r0 = max(0, min(mid - rows // 2, len(all_rows) - rows))
    return all_rows[r0 : r0 + rows]


def batch_rows(plan, batch: list, lo: int, tsamp: float, dev) -> tuple:
    """(row_dm, afs) of a row batch, as PeasoupSearch._search_trials
    builds them for a DM block starting at trial ``lo``."""
    row_dm = torch.tensor([d - lo for d, _ in batch], dtype=torch.int32, device=dev)
    afs = torch.from_numpy(np.asarray(
        [accel_factor(plan.accel_lists[d], tsamp).astype(np.float32)[a]
         for d, a in batch], np.float32,
    )).to(dev)
    return row_dm, afs


def resample_phase(dev: torch.device, fil, cfg: SearchConfig, shapes: dict) -> dict:
    """The resample kernel against its plain version at the binary grid's
    modal launch shape (R rows over a DM block of D trials of N samples):
    the block of preprocessed DM trials that holds the pulsar's, and the R
    rows around the pulsar's DM trial, built as the search builds them."""
    search = PeasoupSearch(cfg, device=dev)
    plan = search.build_plan(fil)
    size = plan.size
    rows, d_blk, n = main_shape(shapes, "resample")
    require(n == size, "resample ran at the plan's FFT size")
    dp = int(np.argmin(np.abs(plan.dm_list - PULSAR_DM)))
    lo = dp // d_blk * d_blk
    require(lo + d_blk <= plan.ndm, "the modal DM block holds the pulsar's trial")
    trials = dedisperse(
        fil_to_device(fil, dev), torch.from_numpy(plan.delays).to(dev),
        torch.from_numpy(plan.killmask).to(dev), plan.out_nsamps,
        scale=output_scale(fil.nbits, int(plan.killmask.sum())),
    )
    tobs = float(np.float32(size) * np.float32(fil.tsamp))
    bin_width = float(np.float32(1.0 / tobs))
    zap = torch.from_numpy(plan.zapmask).to(dev)
    xd, _, _ = preprocess_block(
        trials[lo : lo + d_blk, :size], zap, size=size,
        nsamps_valid=min(plan.out_nsamps, size),
        pos5=int(cfg.boundary_5_freq / bin_width),
        pos25=int(cfg.boundary_25_freq / bin_width),
    )
    del trials
    batch = pulsar_rows(plan, range(lo, lo + d_blk), rows)
    row_dm, afs = batch_rows(plan, batch, lo, fil.tsamp, dev)
    got = resample_rows(xd, row_dm, afs)
    ref = resample_rows_plain(xd, row_dm, afs)
    torch.cuda.synchronize()
    require(torch.equal(got, ref), "resample bitwise equal to its plain version")
    err = float((got - ref).abs().max())
    del got, ref
    ndist = len({d for d, _ in batch})
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: resample_rows(xd, row_dm, afs)),
        plain_ms=time_ms(lambda: resample_rows_plain(xd, row_dm, afs), reps=3),
        # each output written once, each DM trial the rows read once, and
        # the rows' DM index and factor
        bound=bound(rows * n * 4 + ndist * n * 4 + rows * 8, rows * n * 4.0),
        shape=f"({d_blk}, {n}) f32 DM block -> ({rows}, {n}) f32, DM trials "
              f"{batch[0][0]}..{batch[-1][0]}",
    )


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
    batch = pulsar_rows(plan, range(ndm), rows)
    lo, hi = batch[0][0], batch[-1][0] + 1
    xd, mean_d, std_d = preprocess_block(trials[lo:hi, :size], zap, **geometry)
    del trials
    row_dm, afs = batch_rows(plan, batch, lo, fil.tsamp, dev)
    z = packed_dft_z(resample_rows(xd, row_dm, afs))
    mean, std = mean_d[row_dm], std_d[row_dm]
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


def cli_phase(path: str, outdir: str, flags: list, period: float,
              profile: bool = False) -> dict:
    """The port's CLI on one grid; checks that it wrote its files, that
    the top candidate has the pulsar's period (within 2e-3) and that
    every kernel ran, and returns the launches, launch shapes, timers and
    the top candidate of the run."""
    from peasoup_tpu_torch.cli.peasoup import main

    argv = ["-i", path, "-o", outdir, *flags]
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
    for e in root.findall("candidates/candidate")[:5]:
        say("  candidate " + ", ".join(
            f"{k} {e.find(k).text}"
            for k in ("period", "dm", "acc", "nh", "snr", "folded_snr", "opt_period")
        ))
    top_period = float(top.find("period").text)
    say(f"top candidate: period {top_period!r} s, dm {top.find('dm').text}, "
        f"acc {top.find('acc').text}, nh {top.find('nh').text}, "
        f"snr {top.find('snr').text}")
    require(abs(top_period - period) / period < 2e-3,
            f"top candidate period {top_period} within 2e-3 of {period}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} launched on the main path")
    timers = {e.tag: float(e.text) for e in root.find("execution_times")}
    return dict(launches=launches, shapes=shapes, timers=timers, wall=wall,
                top=top)


def binary_checks(run: dict, plan, tsamp: float, outdir: str) -> None:
    """The binary grid's top candidate is the pulsar, found at a non-zero
    accel trial within 1.5 planner steps of +100 m/s^2, and folded."""
    top = run["top"]
    acc, dm = float(top.find("acc").text), float(top.find("dm").text)
    step = AccelerationPlan(
        acc_lo=BINARY_CONFIG.acc_start, acc_hi=BINARY_CONFIG.acc_end,
        tol=BINARY_CONFIG.acc_tol, pulse_width=BINARY_CONFIG.acc_pulse_width,
        nsamps=plan.size, tsamp=tsamp, cfreq=FCH1 + (NCHANS / 2) * FOFF, bw=FOFF,
    ).step(dm)
    folded_snr = float(top.find("folded_snr").text)
    opt_period = float(top.find("opt_period").text)
    say(f"binary grid top candidate: acc {acc} m/s^2 (step {step:.3f}), "
        f"folded_snr {folded_snr}, opt_period {opt_period!r} s")
    require(acc != 0.0, "the top candidate sits at a non-zero accel trial")
    require(abs(acc - BIN_ACC) <= 1.5 * step,
            f"top candidate acc {acc} within 1.5 steps of {BIN_ACC}")
    require(folded_snr > 15.0, f"top candidate folded_snr {folded_snr} > 15")
    require(abs(opt_period - BIN_PERIOD) / BIN_PERIOD < 2e-3,
            f"top candidate opt_period {opt_period} within 2e-3 of {BIN_PERIOD}")
    with open(os.path.join(outdir, "candidates.peasoup"), "rb") as f:
        nfolds = f.read().count(b"FOLD")
    say(f"binary grid: candidates.peasoup holds {nfolds} FOLD blocks")
    require(nfolds > 0, "candidates.peasoup holds FOLD blocks")


def agreement_phase(tmp: str) -> tuple[int, int]:
    """The card's search against the CPU search on a small input, folding
    the top 5 candidates in both."""
    path = os.path.join(tmp, "small.fil")
    small_fil(path)
    fil = read_filterbank(path)
    cfg = SearchConfig(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0,
                       min_snr=6.0, npdmp=5)
    gpu = PeasoupSearch(cfg, device="cuda").run(fil).candidates
    cpu = PeasoupSearch(cfg, device="cpu").run(fil).candidates

    def ident(c):
        return (c.dm_idx, c.acc, c.nh, c.freq)

    # cuFFT and the CPU FFT round differently, so compare the candidates
    # clear of the threshold: same identity, S/N within 1e-3
    strong = [c for c in cpu if c.snr >= 1.1 * cfg.min_snr]
    require(len(strong) > 0, "small input yields strong candidates")
    got = [c for c in gpu if c.snr >= 1.1 * cfg.min_snr]
    require(len(got) == len(strong), "same number of strong candidates")
    for a, b in zip(strong, got):
        require(
            ident(a) == ident(b) and abs(a.snr - b.snr) <= 1e-3 * a.snr,
            f"candidate agrees: cpu {a} vs cuda {b}",
        )
    # the same candidates folded, the same optimised period (whole
    # phase-bin shifts), and the folded S/N within 1e-3 relative: the
    # dereddening FFTs round differently and the card's fold sums use
    # atomics, whose order changes from run to run
    folded = {ident(c): c for c in cpu if c.fold is not None}
    folded_gpu = {ident(c): c for c in gpu if c.fold is not None}
    require(len(folded) == cfg.npdmp and folded.keys() == folded_gpu.keys(),
            "the card and the CPU fold the same candidates")
    for key, a in folded.items():
        b = folded_gpu[key]
        require(a.opt_period == b.opt_period
                and abs(a.folded_snr - b.folded_snr) <= 1e-3 * max(1.0, a.folded_snr),
                f"fold outcome agrees: cpu {a.opt_period!r} {a.folded_snr!r} vs "
                f"cuda {b.opt_period!r} {b.folded_snr!r}")
    return len(strong), len(folded)


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
                    help="trace each grid's CLI run with torch.profiler")
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

    runs, checks = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for label, synth, cfg, flags, period in (
            ("big grid", big_grid_fil, GRID_CONFIG, GRID_FLAGS, PERIOD),
            ("binary grid", binary_grid_fil, BINARY_CONFIG, BINARY_FLAGS, BIN_PERIOD),
        ):
            path = os.path.join(tmp, "grid.fil")
            t0 = time.perf_counter()
            synth(path)
            say(f"synthesized {label} filterbank in {time.perf_counter() - t0:.1f} s")
            fil = read_filterbank(path)
            plan = PeasoupSearch(cfg, device=dev).build_plan(fil)
            ntrials = sum(len(a) for a in plan.accel_lists)
            # the widest trial's resample shift at mid-series, max|af|*N^2/4
            max_shift = max(
                float(np.abs(accel_factor(a, fil.tsamp)).max()) for a in plan.accel_lists
            ) * (plan.size / 2.0) ** 2
            outdir = os.path.join(tmp, label.replace(" ", "_"))
            run = cli_phase(path, outdir, flags, period, profile=args.profile)
            runs[label] = run
            say(f"{label}: {plan.ndm} DM trials, {ntrials} DM x accel trials, "
                f"largest resample shift {max_shift:.2f} samples, "
                f"{run['wall']:.3f} s CLI wall, "
                f"{ntrials / run['timers']['searching']:.1f} trials/s "
                "over the searching stage")
            say(f"{label} stage timers (s): "
                + json.dumps(run["timers"], sort_keys=True))
            say(f"{label} kernel launches: " + json.dumps(run["launches"]))
            say(f"{label} launch shapes: " + json.dumps(
                {k: {str(s): n for s, n in v.items()} for k, v in run["shapes"].items()}
            ))
            if label == "big grid":
                for name, c in kernel_phase(dev, fil, cfg, run["shapes"]).items():
                    checks[name] = dict(c, path=label)
            else:
                binary_checks(run, plan, fil.tsamp, outdir)
                checks["resample"] = dict(
                    resample_phase(dev, fil, cfg, run["shapes"]), path=label
                )
            del fil
            os.remove(path)
            torch.cuda.empty_cache()
        for name in SOURCES:
            c = checks[name]
            say(f"{name} ({c['path']}): {c['shape']}: {c['ms']:.4f} ms kernel, "
                f"{c['plain_ms']:.4f} ms plain, bound {c['bound'][0]:.4f} ms "
                f"({c['bound'][1]}), max |err| {c['max_abs_err']}")

        n, nfold = agreement_phase(tmp)
        say(f"small input: {n} strong candidates and {nfold} fold outcomes "
            "agree between cuda and cpu")

    # each kernel with the launches of the run whose launch shape it was
    # checked and timed at
    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": f"peasoup_tpu_torch/csrc/{name}.cu",
            "replaces": SOURCES[name],
            "launches": runs[c["path"]]["launches"][name],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1],
            "library_ms": None,
            "path": c["path"],
            "shape": c["shape"],
        }
        for name, c in ((name, checks[name]) for name in SOURCES)
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
