"""On-card smoke test of the PyTorch / CUDA port (peasoup_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build every kernel from csrc/ (one nvcc per source, in parallel).
  3. The port's `peasoup` CLI on a synthesized big-grid filterbank
     (64 channels x 2^21+8192 2-bit samples, 64 us, P = 31.4 ms pulsar
     at DM 10; dm_end 20, acc +-0.5, every accel trial searched): the
     top candidate must be the pulsar and each kernel of the path must
     have run. With --profile every CLI run is traced by torch.profiler,
     which prints device time by kernel and the device's busy share (and
     slows the host, so the stage timers of a profiled run are not the
     search's).
  4. The CLI on the binary grid: the big grid's filterbank geometry with
     a P = 5.03 ms pulsar (duty 0.03) at DM 10 under a constant
     +100 m/s^2 acceleration, searched with dm_end 20, acc -150..150
     (resample shifts of up to 17.6 samples) and --npdmp 10: the top
     candidate must be the pulsar at a non-zero accel trial near
     +100 m/s^2, folded, and each kernel of the path must have run.
  5. The CLI three times on the tutorial grid (the JAX package's primary
     configuration: tutorial.fil's geometry, 64 channels x 187,520 2-bit
     samples at 320 us, a 2^17-point FFT, a P = 250 ms pulsar at DM 30;
     bench.py's flags, 59 DM x 44 accel trials), one run per route: the
     default (dftspec and harmpeaks launch, interbin does not),
     PEASOUP_MEGA_HARM=0 (peaks in place of harmpeaks; the candidates are
     the default run's, field for field) and PEASOUP_FUSED_DFT=0 (cuFFT +
     interbin in place of dftspec; the candidates with S/N >= 12 agree on
     DM, accel, nh and period, S/N within 1e-3). The top candidate of each
     must be the pulsar.
  6. The port's `spsearch` CLI on the single-pulse grid: the big grid's
     geometry and noise with three dispersed top-hat pulses (widths 16,
     128 and 2 samples at DM trials near 30, 120 and 220), searched with
     dm_end 250 and -m 7 (179 DM trials): the top three candidates must
     be the three pulses at their DM trials, samples and widths, with
     S/N within 15% of the matched filter, and dedisperse and spchain
     must have run.
  Every `peasoup` run (3-5) must distil its candidates in the native
  library (peasoup_tpu_torch/native, whose calls are counted), and prints
  which distil ran and its `search_host` and `total` timers.
  7. Hold each kernel against its plain torch version on the card at the
     launch shape a CLI run used most (resample: the binary grid's;
     dftspec and peaks: the tutorial grid's; spchain: the single-pulse
     grid's; boxcar: the stream's, phase 18; the others: the big grid's), and
     time both (CUDA events, median of a few runs) beside the least time
     the card could take; dftspec also beside torch.fft.fft + the
     interbin kernel, at m = 2^14, 2^15 and 2^17, and with the memory it
     allocates beside its output (no T or Z scratch); resample and
     harmpeaks also at the tutorial grid's shapes (``other_shapes`` in
     the kernels line), dedisperse also at the single-pulse grid's
     179-trial shape and spchain also with `spsearch --n_widths 16`'s
     bank (widths to 32,768, a ring whose windows wrap; both
     ``other_shapes``). Kernels whose plain version is bitwise are held
     bit for bit (a zero's sign included). peaks and harmpeaks also print
     how their time splits between their two kernels (mask, walk;
     torch.profiler device time a launch, ``phases_ms`` in the kernels
     line); peaks also the time of calls queued back to back (CUDA
     events), at its threshold and at one no bin crosses, a cross-check of
     its mask's time. Under --profile the CLI runs' device time names harmpeaks' two
     kernels (harm_mask, harm_walk), peaks' two (peaks_mask, peaks_walk)
     and dftspec's one.
  8. The card's search against the CPU search (plain versions) on a
     small 8-bit filterbank, folding its top 5: the strong candidates
     and the fold outcomes must agree; and the card's single-pulse
     search against the CPU's on a small 8-bit filterbank with a narrow
     and a broad pulse.
  9. The dedispersion engines on an 8-bit, 256-channel input (2^20
     samples at 64 us over the big grid's band, dm_end 40: 190 trials):
     exact subbands (nsub 16) with scan and with matmul stages, and the
     banded-matmul engine, each bitwise the dedisperse kernel's trials
     and timed beside it (CUDA events, median of 5).
 10. `peasoup --subbands 8` on the big grid (smear 1.0): the top
     candidate is the pulsar.
 11. The tutorial grid with `--subbands 8 --subband_smear 0` and with
     `--dedisp_engine matmul`: the default run's candidates, field for
     field.
 12. Checkpoints: the tutorial grid with --checkpoint, then with the store
     rewritten to every other DM trial (the resumed run searches only
     the missing ones), then on the full store (the fast path: no kernel
     launches), each with the default run's candidates; the same for
     `spsearch` on the small single-pulse input.
 13. The big grid in a subprocess whose allocator may hold 3 GB: real
     out-of-memory errors, at least one DM-block shrink in its log, and
     the unconstrained run's candidates.
 14. `peasoup-ffa` on the big grid's geometry with a P = 1.2 s pulsar at
     DM 10: the top candidate's period is the JAX package's on the same
     file (FFA_JAX_PERIOD, to 1e-6; its row-to-period map reads it
     2e-3 long), and dedisperse ran.
 15. `coincidencer` on 13 beams of the tutorial grid's geometry (a burst
     in 10, a tone in all, a pulsar in one): the mask flags the burst
     only, birdies.txt lists the tone, and the card's mask is the CPU's.
 16. `accmap` on four beams with planted lags: every lag found.
 17. The subband search (smear 1.0) on the card against the CPU on a
     small 8-bit input: the same strong candidates, bitwise trials.
 18. `peasoup-stream --replay` of the single-pulse grid's file (run inside
     phase 6's section; --rate 0, dm_end 250, -m 7, the default chunk of
     16,384 samples and 12 widths, dec 32: ~128 chunks of 179 DM trials):
     the three pulses among the triggers at their DM trials, samples,
     widths and matched-filter S/N (phase 6's standard); dedisperse and
     boxcar launch once a chunk, spchain never; prints the chunk latency
     p50/p95 and the drops. boxcar's kernels-line entry is checked and
     timed at the stream's modal launch shape (path "stream"), the
     single-pulse grid's shape under other_shapes: at each, one call
     under CUDA events (``ms``), the kernel's device time alone
     (torch.profiler, ``kernel_ms``, the mean over the launches it
     recorded of 10) and a call's share of 20 queued back to back
     (``queued_ms``); the loaded kernel's registers, local memory
     (spills) and static shared memory, as the runtime reports them, are
     printed after the build and kept as ``resources``.
 19. `peasoup-fdas` on the FDAS grid (the big grid's geometry, a faint
     P = 5.03 ms square-wave pulsar at DM 10 drifting z = -24 bins;
     --dm_end 20, zmax 64, 4 harmonics: 77 DM x 65 templates of 2^20 + 1
     bins): the top candidate within 2e-3 of the period, within 0.99 of DM
     10 and at a negative z; dedisperse ran; prints its timers and the
     host cluster walk's time.
 20. FDAS on the card against the CPU on tests/test_fdas.py's input: the
     same candidates at the recall standard; template batches of 5 and 8
     give the auto run's candidates field for field on the card.
 21. The streaming search on the card against the CPU on
     tests/test_stream.py's input: the same triggers.
 22. The batch single-pulse search at decimate 48 (the boxcar kernel and
     the torch dec-fold; spchain takes powers of two only): the CPU's
     candidates on the card.
 23. A campaign of this run's own outputs: the big grid's and the tutorial
     grid's three routes' output directories ingested (CandidateDB.
     ingest_job) as four observations, sifted by `cli.sift run` with the
     default SiftConfig (each observation re-dedispersed with the
     dedisperse kernel at its candidates' DMs, fold batch 64, up to 256
     folded an observation, DM-curve refold, scoring), then `cli.sift
     report` and `cli.rank score`: the dedisperse kernel launched (its
     launch shapes printed), a 2^21-sample fold bucket folded, the
     tutorial pulsar one catalogue row over the 3 observations and the big
     grid's pulsar a row, each folded to S/N >= 6, every scored row tiered
     with the shipped model's fingerprint, and rank score's scores the
     sift's; prints the stage timers and the fold buckets. dedisperse is
     checked and timed at the sift's big-grid launch (``other_shapes``).
 24. The sift on the card against the CPU on tests/test_sift.py's
     seed_campaign recipe (and its six-beam RFI variant) and a pulsar
     campaign: the same catalogue, known matches and repeat sources
     (folded S/N to 1e-3, scores to 2e-3); the survey folder bit for bit
     the per-observation folder on the card at batch 4 and 64; `rank
     train` on the card and the CPU from one seed (weights within 1e-5),
     each model through `rank eval`'s ROC gate.
 25. The in-process split on the card: PeasoupSearch with
     devices=[cuda:0, cuda:0] on the big grid and on the binary grid
     (--npdmp 10), SinglePulseSearch likewise on the single-pulse grid
     (the grids' files made again): dedisperse launches once a shard (39
     of the 77 trials a shard; 90 of the 179), every kernel of the path
     runs, and the candidates are phases 3, 4 and 6's, bitwise or at the
     recall standard (printed); the three pulses at phase 6's standard.
 26. Two processes on the card: `peasoup` on the binary grid (--npdmp 10),
     `spsearch` on the single-pulse grid and `peasoup-fdas` on the FDAS
     grid, each launched twice as `chip_smoke.py --worker cli ...` with
     JAX_COORDINATOR_ADDRESS=127.0.0.1:<free port>, JAX_NUM_PROCESSES=2
     and JAX_PROCESS_ID=0/1, and --hbm_bytes at half the card's free
     memory (FDAS: --dm_block 4). Each process dedisperses its DM slice in
     one launch (its shape printed: 39 and 38 trials; 90 and 89); only
     rank 0 writes; the candidates are phase 4's and 6's (bitwise or at
     the recall standard, printed) and phase 19's top candidate; each
     pulse clusters once, across the slice boundary where it spans it.
 27. Phase 23's survey fold in two processes sharing the card
     (`chip_smoke.py --worker fold ...`, run_survey_fold): each process's
     merged outcomes are bitwise the single process's.
  Every worker process must exit 0 within WORKER_TIMEOUT_S. The dedisperse
  kernel is also held bit for bit at the shapes phases 25-26 add, on the
  big grid (39, 38 and one padding row, 38 trials) and the single-pulse
  grid (90, 89 and one padding row, 89 trials) (``other_shapes``).
 28. The tuning and measurement layer (peasoup_tpu_torch/perf). (a) `peasoup
     --tune` on the big grid with a fresh --tuning-cache: the tuner measures
     (dedisperse at (t_in, 64) -> (b, 65,536) for b in 8..64 and in the
     engine race, resample at (b, 32,768) for b in 8, 16, 32, the
     normaliser at b in 16, 32, 64; its launches and their shapes printed,
     with its trials, knobs and fingerprint), the plan is tuned and exact,
     and the candidates are phase 3's, bytes for bytes; (b) the same run
     warm: no measurement, the plan from the cache, the same bytes; (c)
     `spsearch --tune` on the single-pulse grid, cold then warm: the three
     pulses at phase 6's standard and phase 6's candidates, bytes for
     bytes; (d) SearchConfig(tune=True, subband_snr_loss=0.3) on the big
     grid through the API, cold: the tuner times the subband counts and
     races the engines (the winner printed) and the top candidate is the
     pulsar; then the same search from a cache that holds the planner's
     analytic plan: subband, 16 subbands, DM-scaled budgets, its trials
     bitwise a direct dedisperse_subband(..., budgets=dm_smear_budgets(...))
     and its top candidate the pulsar; (e) `python -m
     peasoup_tpu_torch.tools.perf warmup` in a fresh process builds no
     kernel, `bench` writes perf.json (each kernel's median printed beside
     phase 7's time at the main path's shape) and `check` passes against
     the port's baseline (peasoup_tpu_torch/perf/perf_baseline.json).
 29. Observability on the card (peasoup_tpu_torch/obs, resilience): (a)
     `peasoup` on the big grid plain, observed (--metrics-json
     --status-json --heartbeat-interval 1), traced (--capture-device-trace)
     and plain again, each with phase 3's candidates bytes for bytes, valid
     manifests and status.json ending "done": true; the traced run's device
     table (torch.profiler) names dedisperse, resample, specchain, interbin
     and harmpeaks with device time above zero; each run's `total` and the
     observed and traced runs' excess over the plain runs are printed; (b)
     the binary grid under the fault plan device.oom:at=1 records
     fault_injected and the search.memory ladder's rung 0 and gives phase
     4's candidates; (c) under fil.read:n=9 (a subprocess) the retries run
     out, the exit is non-zero, flight.json and an aborted manifest are
     left; (d) `peasoup-stream --metrics-jsonl` on the single-pulse grid,
     every sample valid against the metrics schema; (e) `spsearch
     --metrics-json --capture-device-trace` (phase 6's candidates bytes for
     bytes; dedisperse and spchain in the device table) and `peasoup-sift
     run --metrics-json` on phase 23's campaign.
 30. The campaign layer on the card (peasoup_tpu_torch/campaign, `python
     -m peasoup_tpu_torch.cli.campaign`), with --bucket-nsamps at each
     file's own length, so nothing is padded: (a) `campaign run --pipeline
     search` over the big grid (phase 3's flags) and the binary grid
     (phase 4's) as per-job config lines of one bucket: each job's
     candidates.peasoup is its phase's bytes, overview.xml parses, the DB
     rows are the candidates, the rollup has 2 done and none quarantined,
     the first job was warmed (warmup_s > 0) and the second built no
     kernel library (jit_programs_compiled 0); each job's launches are
     printed (the big grid's: dedisperse 1, specchain 1, resample, interbin
     and harmpeaks each once a row batch); then the big grid alone in a
     fresh campaign and worker with --no-warmup, its duration printed
     beside the warmed job's, its candidates phase 3's bytes; (b) a
     `--pipeline spsearch`
     campaign of the single-pulse grid: phase 6's candidates bytes for
     bytes, spchain and dedisperse launched; (c) two worker processes
     sharing the card over four copies of the tutorial grid's file: every
     job done once, no claim left, none quarantined, each job phase 5's
     default route's bytes, each worker beat and deregistered; (d) a
     checkpointed tutorial-grid job (DM blocks of 2) preempted at a wave
     boundary by a preempt request, released with zero attempts consumed,
     resumed from its checkpoint with (c)'s bytes; (e) a gang job of two
     worker processes (--nprocs 2 --group pod) on the binary grid: the
     leader's candidates are (a)'s binary job's bytes and each member
     dedispersed its own slice; (f) `campaign status`, `campaign alerts
     --evaluate` over the five campaigns with nothing firing, `campaign
     sentinel` enqueued, run and recovered, `campaign serve` on 127.0.0.1
     answering /status with the rollup and /metrics with an exposition,
     and `peasoup-sift run --no-fold` then `report` with the campaign
     section. Each sub-phase's wall time is printed.
 31. The chaos soak and the user-facing tools on the card: (a) `python -m
     peasoup_tpu_torch.tools.chaos --mode both --device cuda --seed 7` at
     the tool's defaults exits 0, SURVIVED, its report ok, each campaign
     job's done record shows dedisperse and spchain launched and the
     stream soak dedisperse and boxcar; (b) `--mode fleet --seed 11
     --workers 4 --n-obs 6 --lease 1.0`, every worker a port campaign
     process on the card: 7 jobs done, a kill reaped, 2 flaky reads, a
     preemption resumed, the gang done, an autoscale up; (c) the campaign
     soak in this process at CHAOS_FULL_NSAMPS samples (the single-pulse
     grid's length) at the tool's 8 channels and 3 observations: every
     job's candidates the fault-free run's bytes, spchain's launch shapes
     printed; (d) tools.divergence on the tutorial grid's file at DM 30,
     accelerations -5, 0 and 5, on the card and on the CPU: every S/N
     level meets the standard against the f64 oracle (the same S/N > 9
     membership, |dS/N| < 5e-3), the resample kernel launched; (e)
     tools.report --merge over phase 26's spsearch shards validates,
     tools.as_text reads the big grid's overview.xml, phase 23's sift
     wrote sift/bowtie.svg, phase 30's campaign portal answers
     /bowtie.svg with 200 and an SVG, and the tutorial grid with `-p`
     draws the bar on stderr and writes the default run's candidate
     bytes. Each part's wall time is printed.
The second-last line is a JSON object with one entry per kernel, the
last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from peasoup_tpu_torch import kernels, native  # noqa: E402
from peasoup_tpu_torch.campaign.buckets import bucket_for_header  # noqa: E402
from peasoup_tpu_torch.io.sigproc import (  # noqa: E402
    Filterbank, SigprocHeader, read_filterbank, write_filterbank,
)
from peasoup_tpu_torch.ops.dedisperse import (  # noqa: E402
    dedisperse, dedisperse_block, fil_to_device, output_scale,
)
from peasoup_tpu_torch.ops.dftspec import (  # noqa: E402
    ACC_MAX_REL, ACC_Q999_REL, accuracy, dft_untwist_interbin,
    dft_untwist_interbin_plain, oracle_data,
)
from peasoup_tpu_torch.ops.fft import (  # noqa: E402
    packed_dft_z, untwist_interbin_normalise, untwist_interbin_normalise_plain,
)
from peasoup_tpu_torch.ops.harmonics import harmonic_sums, level_scales  # noqa: E402
from peasoup_tpu_torch.ops.peaks import (  # noqa: E402
    find_cluster_peaks_multi, find_cluster_peaks_multi_plain,
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
from peasoup_tpu_torch.ops.singlepulse import (  # noqa: E402
    boxcar_best, boxcar_best_plain, boxcar_dec_best, boxcar_dec_best_plain,
    dec_fold, default_widths, matched_filter_snr, normalise_trials, plan_pad, prefix_sum_padded,
    width_extent, width_scales,
)
from peasoup_tpu_torch.pipeline.search import (  # noqa: E402
    PeasoupSearch, SearchConfig,
)
from peasoup_tpu_torch.pipeline.single_pulse import (  # noqa: E402
    SinglePulseConfig, SinglePulseSearch,
)
from peasoup_tpu_torch.plan.accel_plan import AccelerationPlan  # noqa: E402
from peasoup_tpu_torch.plan.dm_plan import DMPlan, delay_table  # noqa: E402
from peasoup_tpu_torch.fdas.templates import SPEED_OF_LIGHT  # noqa: E402
from peasoup_tpu_torch.parallel.multihost import dm_slice_for_process  # noqa: E402
from peasoup_tpu_torch.perf.roofline import device_peaks  # noqa: E402
from peasoup_tpu_torch.tools.scope_trace import absorb_start_loss  # noqa: E402

# the H100 SXM's published peaks (NVIDIA data sheet, at its 700 W limit),
# the roofline's one row
F32_FLOPS, HBM_BYTES_PER_S = device_peaks("H100")

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

# the single-pulse grid: the big grid's geometry, noise and seed, with
# three dispersed top-hat pulses (each +1 on the 2-bit samples of its
# channels) at exact DM trials of the search's own delay table, searched
# with the JAX CLI's usage example (cli/spsearch.py:8), every other flag
# at its default
SP_FLAGS = ["--dm_end", "250", "-m", "7"]
SP_CONFIG = SinglePulseConfig(dm_end=250.0, min_snr=7.0)
# (label, DM the trial is nearest, width, dedispersed start, channel stride)
SP_PULSES = (
    ("A", 30.0, 16, 400_000, 1),
    ("B", 120.0, 128, 1_000_000, 4),
    ("C", 220.0, 2, 1_600_000, 1),
)
SP_CHANNEL_SIGMA = float(np.sqrt(2.0 / 3.0))  # std of uniform {0, 1, 2}

# the tutorial grid: the JAX package's primary configuration, the
# geometry of the reference's tutorial.fil (64 channels x 187,520 2-bit
# samples at 320 us, a 2^17-point FFT) with a P = 250 ms pulsar at DM 30,
# searched with bench.py's pinned flags (bench.py:505-526): 59 DM trials x
# the dense +-5 m/s^2 accel list, every accel trial dispatched
TUT_NCHANS, TUT_NSAMPS, TUT_TSAMP, TUT_FCH1, TUT_FOFF = 64, 187_520, 320e-6, 1510.0, -1.09375
TUT_PERIOD, TUT_DM, TUT_DUTY = 0.25, 30.0, 0.05
TUT_FLAGS = [
    "--dm_end", "250", "--acc_start", "-5", "--acc_end", "5",
    "--acc_pulse_width", "0.064", "--npdmp", "0", "--limit", "1000",
    "--no_accel_dedupe",
]
TUT_CONFIG = SearchConfig(
    dm_end=250.0, acc_start=-5.0, acc_end=5.0, acc_pulse_width=0.064, npdmp=0,
    limit=1000, dedupe_accel=False,
)

# the kernels each CLI path launches: the survey-sized grids take cuFFT +
# interbin (m = 2^20 is past the dftspec gate), the tutorial grid dftspec
PEASOUP_KERNELS = ("dedisperse", "resample", "specchain", "interbin", "harmpeaks")
TUT_KERNELS = ("dedisperse", "resample", "specchain", "dftspec", "harmpeaks")
SP_KERNELS = ("dedisperse", "spchain")

SOURCES = {
    "dedisperse": "peasoup_tpu/ops/pallas/dedisperse.py:157",
    "resample": "peasoup_tpu/ops/pallas/resample.py:167",
    "specchain": "peasoup_tpu/ops/pallas/specchain.py:139",
    "interbin": "peasoup_tpu/ops/pallas/interbin.py:152",
    "dftspec": "peasoup_tpu/ops/pallas/dftspec.py:444",
    "peaks": "peasoup_tpu/ops/pallas/peaks.py:535",
    "harmpeaks": "peasoup_tpu/ops/pallas/harmpeaks.py:202",
    "boxcar": "peasoup_tpu/ops/pallas/boxcar.py:120",
    "spchain": "peasoup_tpu/ops/pallas/spchain.py:135",
}


STARTED = time.perf_counter()


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


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: a float's sign of zero included."""
    if a.dtype == torch.float32:
        return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def kernel_split(fn, names: tuple, reps: int = 10) -> tuple[dict, dict]:
    """Device time in ms of each CUDA kernel whose name holds one of
    ``names``, and how many launches of each it is taken over:
    torch.profiler over ``reps`` calls of fn() after a warm-up call, the
    mean over the launches it recorded. Kineto drops the first records of
    a session once the process has run for minutes (phase 29 measures it),
    so the session opens with scope_trace's one-element warm-up kernels; a
    launch missed all the same counts in neither the sum nor the count.
    Fails if it recorded no launch of a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        absorb_start_loss()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    count = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    total[n] += e.device_time_total / 1e3
                    count[n] += 1
    require(all(count.values()), f"the profiler recorded a launch of each of {names} "
                                 f"({reps} calls): {count}")
    return {n: total[n] / count[n] for n in names}, count


def time_ms_queued(fn, reps: int = 20) -> float:
    """Device time in ms a call of fn() takes when ``reps`` calls are queued
    back to back (CUDA events around them all, after one warm-up): the host
    runs ahead of the card wherever its part of a call is the shorter."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_work(d: int, nvalid: int, tpad: int, row_len: int, nw: int) -> tuple[int, float]:
    """What a width sweep of d prefix-sum rows of row_len must read, in
    bytes, and the operations it must do: csum[:, 0 .. nvalid] (no boxcar
    reads past csum[nvalid]), and five operations (subtract, multiply,
    compare, two selects) a width at each sample with a boxcar (t <
    nvalid)."""
    return d * min(nvalid + 1, row_len) * 4, 5.0 * d * min(nvalid, tpad) * nw


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


def tutorial_grid_fil(path: str, duty: float = TUT_DUTY) -> None:
    """Synthesize the tutorial grid's filterbank: the tutorial.fil header
    geometry, rng.integers(0, 3) noise from seed 7, and a P = 250 ms
    top-hat pulse (on for a fraction ``duty`` of the period, +1 on every
    channel) at DM 30 with whole-sample delays."""
    nchans, nsamps = TUT_NCHANS, TUT_NSAMPS
    rng = np.random.default_rng(7)
    delays = np.rint(
        np.float32(TUT_DM) * np.abs(delay_table(TUT_FCH1, TUT_FOFF, nchans, TUT_TSAMP))
    ).astype(np.int64)
    t = np.arange(nsamps, dtype=np.float64)
    pulse = (((t * TUT_TSAMP / TUT_PERIOD) % 1.0) < duty).astype(np.uint8)
    data = rng.integers(0, 3, size=(nsamps, nchans), dtype=np.uint8)
    for c in range(nchans):
        src = np.clip(t - delays[c], 0, nsamps - 1).astype(np.int64)
        data[:, c] += pulse[src]
    hdr = SigprocHeader(
        source_name="tutorial_grid_synth", data_type=1, nchans=nchans, nbits=2,
        nifs=1, tsamp=TUT_TSAMP, tstart=51000.0, fch1=TUT_FCH1, foff=TUT_FOFF,
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


def sp_grid_fil(path: str) -> list[dict]:
    """Synthesize the single-pulse grid's filterbank: the big grid's
    geometry and noise (seed 7) with SP_PULSES injected through the
    search's own delay table, so each pulse is an exact top-hat at its DM
    trial. Returns each pulse with its DM trial and the matched-filter S/N
    it should reach there (channel noise std sqrt(2/3))."""
    nchans, nsamps = NCHANS, NSAMPS
    rng = np.random.default_rng(7)
    data = rng.integers(0, 3, size=(nsamps, nchans), dtype=np.uint8)
    hdr = SigprocHeader(
        source_name="sp_grid_synth", data_type=1, nchans=nchans, nbits=2,
        nifs=1, tsamp=TSAMP, tstart=51000.0, fch1=FCH1, foff=FOFF,
    )
    fil = Filterbank(header=hdr, data=data)
    plan = SinglePulseSearch(SP_CONFIG, device="cpu").build_dm_plan(fil)
    delays = plan.delay_samples()
    pulses = []
    for label, dm, width, start, stride in SP_PULSES:
        idx = int(np.argmin(np.abs(plan.dm_list - dm)))
        chans = range(0, nchans, stride)
        for c in chans:
            lo = start + int(delays[idx, c])
            data[lo : lo + width, c] += 1
        pulses.append(dict(
            label=label, dm_idx=idx, dm=float(plan.dm_list[idx]), width=width,
            start=start, snr=matched_filter_snr(
                len(chans), width, SP_CHANNEL_SIGMA * np.sqrt(nchans)),
        ))
    write_filterbank(path, fil)
    return pulses


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


# the coincidencer's beams: the tutorial grid's geometry, 13 beams (the
# Parkes multibeam receiver's count); a zero-DM burst in 10 of them, a
# zero-DM tone (a 20 Hz square wave on 8 of the 64 channels: strong in the
# spectrum, a fraction of a sigma in the time series) in all, and the
# tutorial grid's dispersed pulsar in beam 0 only
COIN_BEAMS, COIN_BURST_BEAMS, COIN_TONE_HZ = 13, 10, 20.0
COIN_BURST = (60_000, 8)  # start sample, length (2.56 ms)


def coincidence_beams(tmp: str, nbeams: int = COIN_BEAMS,
                      burst_beams: int = COIN_BURST_BEAMS,
                      nsamps: int = TUT_NSAMPS, nchans: int = TUT_NCHANS,
                      burst: tuple = COIN_BURST) -> list[str]:
    """Write ``nbeams`` 2-bit filterbanks of the tutorial grid's channel
    and sample geometry into ``tmp``: rng.integers(0, 3) noise (a seed a
    beam), +1 on every channel over the ``burst`` samples in the first
    ``burst_beams`` beams, +1 on every eighth channel for the on half of a
    COIN_TONE_HZ square wave in every beam, and the tutorial grid's P =
    250 ms DM 30 pulsar in beam 0. Returns the paths."""
    t = np.arange(nsamps, dtype=np.float64)
    tone = (((t * TUT_TSAMP * COIN_TONE_HZ) % 1.0) < 0.5).astype(np.uint8)
    delays = np.rint(
        np.float32(TUT_DM) * np.abs(delay_table(TUT_FCH1, TUT_FOFF, nchans, TUT_TSAMP))
    ).astype(np.int64)
    pulse = (((t * TUT_TSAMP / TUT_PERIOD) % 1.0) < TUT_DUTY).astype(np.uint8)
    paths = []
    for b in range(nbeams):
        rng = np.random.default_rng(100 + b)
        data = rng.integers(0, 3, size=(nsamps, nchans), dtype=np.uint8)
        data[:, ::8] += tone[:, None]
        if b < burst_beams:
            data[burst[0] : burst[0] + burst[1]] += 1
        if b == 0:
            for c in range(nchans):
                src = np.clip(t - delays[c], 0, nsamps - 1).astype(np.int64)
                data[:, c] += pulse[src]
        hdr = SigprocHeader(
            source_name=f"beam{b:02d}", data_type=1, nchans=nchans, nbits=2, nifs=1,
            tsamp=TUT_TSAMP, tstart=51000.0, fch1=TUT_FCH1, foff=TUT_FOFF,
        )
        path = os.path.join(tmp, f"beam{b:02d}.fil")
        write_filterbank(path, Filterbank(header=hdr, data=np.minimum(data, 3)))
        paths.append(path)
    return paths


def main_shape(shapes: dict, name: str) -> tuple:
    """The launch shape kernel ``name`` ran at most often on the main
    path (the full row batch; the larger on a tie)."""
    require(len(shapes[name]) > 0, f"kernel {name} launched on the main path")
    return max(shapes[name].items(), key=lambda kv: (kv[1], kv[0]))[0]


def pulsar_rows(plan, dms, rows: int, dm: float = PULSAR_DM) -> list:
    """``rows`` consecutive (DM, accel) rows of the DM trials ``dms``,
    centred on the pulsar's DM trial (the one nearest ``dm``), in the
    search's row order."""
    all_rows = [(d, a) for d in dms for a in range(len(plan.accel_lists[d]))]
    require(rows <= len(all_rows), "the row batch fits the grid")
    dp = int(np.argmin(np.abs(plan.dm_list - dm)))
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
        fil_to_device(fil, dev), plan.delays, plan.killmask, plan.out_nsamps,
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


def dedisperse_check(x, nbits: int, delays, kill, out_n: int) -> tuple:
    """dedisperse on the (T, C) filterbank ``x`` with the plan's host
    delays and kill mask, bitwise against its plain version and timed with
    its wrapper (the host tables and their upload). Returns the trials and
    the check's record."""
    scale = output_scale(nbits, int(kill.sum()))
    trials = dedisperse(x, delays, kill, out_n, scale=scale)
    ref = dedisperse_block(x, delays, kill, out_nsamps=out_n, scale=scale)
    torch.cuda.synchronize()
    err = float((trials.int() - ref.int()).abs().max())
    require(err == 0, f"dedisperse bitwise equal to its plain version ({delays.shape[0]} trials)")
    del ref
    ndm, nchans = delays.shape
    return trials, dict(
        max_abs_err=err,
        ms=time_ms(lambda: dedisperse(x, delays, kill, out_n, scale=scale)),
        plain_ms=time_ms(
            lambda: dedisperse_block(x, delays, kill, out_nsamps=out_n, scale=scale),
            reps=3,
        ),
        # the f32 reckoning: a multiply and an add per (trial, sample,
        # channel), as the plain version does them
        bound=bound(x.numel() + delays.size * 4 + ndm * out_n,
                    2.0 * ndm * out_n * nchans),
        shape=f"({x.shape[0]}, {nchans}) u8 -> ({ndm}, {out_n}) u8",
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
    ndm, out_n = plan.ndm, plan.out_nsamps
    require(main_shape(shapes, "dedisperse") == (fil.nsamps, fil.nchans, ndm, out_n),
            "dedisperse checked at the main path's shape")
    require(main_shape(shapes, "specchain") == (ndm, nbins),
            "specchain checked at the main path's shape (one DM block)")
    trials, out["dedisperse"] = dedisperse_check(x, fil.nbits, plan.delays, plan.killmask,
                                                 out_n)
    del x

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
        require(bitwise_equal(a, b), f"harmpeaks {name} equal to the plain version")
    require(int(k_out[3].sum()) > 0, "harmpeaks test rows hold clusters")
    nlev = nharms + 1
    split, _ = kernel_split(lambda: find_harmonic_cluster_peaks(spec, windows, **kw),
                            ("harm_mask", "harm_walk"))
    say(f"harmpeaks phases (torch.profiler device time a call): mask "
        f"{split['harm_mask']:.4f} ms, walk {split['harm_walk']:.4f} ms")
    out["harmpeaks"] = dict(
        phases_ms={"mask": split["harm_mask"], "walk": split["harm_walk"]},
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


def cli_phase(main, argv: list, outdir: str, outputs: tuple, path_kernels: tuple,
              profile: bool = False) -> dict:
    """One CLI run of the port (``main(argv)``): checks its exit code, that
    it wrote ``outputs`` into ``outdir`` and that every kernel of
    ``path_kernels`` ran, and returns the launches, launch shapes, timers,
    wall time and parsed overview.xml of the run."""
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tracer

        prof = tracer(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    kernels.reset_launches()
    native.calls.clear()
    t0 = time.perf_counter()
    rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    native_calls = dict(native.calls)
    shapes = {k: v.copy() for k, v in kernels.launch_shapes.items()}
    if profile:
        prof.stop()
        print_profile(prof, wall)
    require(rc == 0, "CLI exit code 0")
    for name in outputs:
        require(os.path.exists(os.path.join(outdir, name)), f"{name} written")
    for name in path_kernels:
        require(launches[name] > 0, f"kernel {name} launched on the main path")
    root = ET.parse(os.path.join(outdir, "overview.xml")).getroot()
    timers = {e.tag: float(e.text) for e in root.find("execution_times")}
    return dict(launches=launches, shapes=shapes, timers=timers, wall=wall, root=root,
                native_calls=native_calls)


def periodicity_phase(path: str, outdir: str, flags: list, period: float,
                      profile: bool = False,
                      path_kernels: tuple = PEASOUP_KERNELS) -> dict:
    """The port's `peasoup` CLI on one grid; checks that it wrote its
    files, that its kernels ran and that the top candidate has the
    pulsar's period (within 2e-3). Returns cli_phase's record and the top
    candidate."""
    from peasoup_tpu_torch.cli.peasoup import main

    run = cli_phase(main, ["-i", path, "-o", outdir, *flags], outdir,
                    ("candidates.peasoup", "overview.xml"), path_kernels, profile)
    calls = run["native_calls"]
    distil = ("native segmented" if calls.get("ps_harmonic_distill_seg") and
              calls.get("ps_accel_distill_seg") else "python per-trial")
    say(f"distil: {distil} (native library calls {json.dumps(calls, sort_keys=True)}); "
        f"search_host {run['timers']['search_host']!r} s of total "
        f"{run['timers']['total']!r} s")
    require(distil == "native segmented", "the per-DM distil ran in the native library")
    root = run["root"]
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
    return dict(run, top=top)


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


# the tutorial grid's three runs: (label, environment, kernels that must
# launch, kernels that must not)
TUT_RUNS = (
    ("tutorial grid", {}, TUT_KERNELS, ("interbin", "peaks")),
    ("tutorial grid, PEASOUP_MEGA_HARM=0", {"PEASOUP_MEGA_HARM": "0"},
     ("dedisperse", "resample", "specchain", "dftspec", "peaks"),
     ("interbin", "harmpeaks")),
    ("tutorial grid, PEASOUP_FUSED_DFT=0", {"PEASOUP_FUSED_DFT": "0"},
     PEASOUP_KERNELS, ("dftspec", "peaks")),
)


def xml_candidates(root) -> list[dict]:
    """Every field of every candidate in an overview.xml, as text."""
    return [{f.tag: f.text for f in e} for e in root.findall("candidates/candidate")]


def tutorial_phase(path: str, tmp: str, profile: bool = False) -> dict:
    """The port's `peasoup` CLI three times on the tutorial grid, in one
    process, each route as the JAX package's switches select it: the
    default (dftspec and harmpeaks), PEASOUP_MEGA_HARM=0 (dftspec, torch
    harmonic sums and peaks) and PEASOUP_FUSED_DFT=0 (cuFFT + interbin,
    harmpeaks). Each run's top candidate must be the pulsar and each must
    launch its route's kernels and not the others'; the harmonic-sum route
    must give the default run's candidates field for field, and the cuFFT
    route those with S/N >= 12 on DM, accel, nh and period, S/N within
    1e-3 relative. Returns each run by label."""
    runs = {}
    for label, env, must, must_not in TUT_RUNS:
        outdir = os.path.join(tmp, label.split(", ")[-1].replace(" ", "_"))
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            run = periodicity_phase(path, outdir, TUT_FLAGS, TUT_PERIOD,
                                    profile=profile, path_kernels=must)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        for name in must_not:
            require(run["launches"][name] == 0, f"{label}: kernel {name} not launched")
        with open(os.path.join(outdir, "candidates.peasoup"), "rb") as f:
            run["cands_file"] = f.read()
        run["cands"] = xml_candidates(run["root"])
        runs[label] = run
    base, split, cufft = (runs[label] for label, *_ in TUT_RUNS)
    require(split["cands"] == base["cands"] and split["cands_file"] == base["cands_file"],
            "PEASOUP_MEGA_HARM=0 gives the default run's candidates field for field")

    def strong(cands):
        return {(c["dm"], c["acc"], c["nh"], c["period"]): float(c["snr"])
                for c in cands if float(c["snr"]) >= 12.0}

    a, b = strong(base["cands"]), strong(cufft["cands"])
    require(len(a) > 0, "the tutorial grid yields candidates with S/N >= 12")
    for one, other in ((a, b), (b, a)):
        for key, snr in one.items():
            require(key in other and abs(other[key] - snr) <= 1e-3 * snr,
                    f"PEASOUP_FUSED_DFT=0 agrees with the default run on {key}, {snr}")
    say(f"tutorial grid: {len(base['cands'])} candidates, identical under "
        f"PEASOUP_MEGA_HARM=0; {len(a)} with S/N >= 12 agree under PEASOUP_FUSED_DFT=0")
    return runs


def dftspec_check(x, mean, std, npad: int, label: str) -> dict:
    """dftspec against its plain version within the accuracy gate (pad
    bins exactly 0), timed beside the plain version and the port's other
    route for the same function (torch.fft.fft + the interbin kernel)."""
    rows, n = x.shape
    m = n // 2
    dft_untwist_interbin(x, mean, std, npad=npad)  # the cached untwist tables
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = dft_untwist_interbin(x, mean, std, npad=npad)
    torch.cuda.synchronize()
    # one launch keeps T and Z on chip: the call allocates its output only
    scratch = torch.cuda.max_memory_allocated() - base - got.nbytes
    require(scratch < rows * m * 8,
            f"dftspec allocates no (rows, m) complex scratch ({label}: {scratch} B)")
    ref = dft_untwist_interbin_plain(x, mean, std, npad=npad)
    torch.cuda.synchronize()
    require(not bool(got[:, m + 1 :].any()), f"dftspec pad bins exactly zero ({label})")
    acc_max, q999 = accuracy(got, ref, mean, std, m)
    err = float((got[:, : m + 1] - ref[:, : m + 1]).abs().max())
    del got, ref
    say(f"dftspec {label}: accuracy max {acc_max!r}, q99.9 {q999!r}, max |err| {err!r}")
    require(acc_max <= ACC_MAX_REL and q999 <= ACC_Q999_REL,
            f"dftspec within the accuracy gate ({label})")
    nbins = m + 1
    flops = rows * (5.0 * m * np.log2(m) + 30.0 * nbins)
    return dict(
        max_abs_err=err, accuracy_max=acc_max, accuracy_q999=q999, scratch_bytes=scratch,
        ms=time_ms(lambda: dft_untwist_interbin(x, mean, std, npad=npad)),
        plain_ms=time_ms(lambda: dft_untwist_interbin_plain(x, mean, std, npad=npad),
                         reps=3),
        library_ms=time_ms(
            lambda: untwist_interbin_normalise(packed_dft_z(x), mean, std, npad=npad)
        ),
        # each series read once, each spectrum written once
        bound=bound(rows * (n * 4 + npad * 4 + 8), flops),
        shape=f"({rows}, {n}) f32 -> ({rows}, {npad}) f32, {label}",
    )


def other_shape(c: dict) -> dict:
    """The record of a kernel checked at a launch shape besides its modal
    one, as the kernels line lists it under ``other_shapes``."""
    return {k: c[k] for k in ("path", "shape", "max_abs_err", "accuracy_max",
                              "accuracy_q999", "scratch_bytes", "ms", "kernel_ms",
                              "kernel_ms_launches", "queued_ms", "plain_ms",
                              "library_ms")
            if k in c} | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]}


def tutorial_kernel_phase(dev: torch.device, fil, runs: dict) -> tuple[dict, dict]:
    """dftspec and peaks against their plain versions at the tutorial
    grid's modal launch shapes (dftspec: the default run's; peaks: the
    PEASOUP_MEGA_HARM=0 run's), on the (DM, accel) rows around the
    pulsar's DM trial built as the search builds them; then dftspec at the
    other factorisations (m = 2^14, 2^15, 2^17) on the accuracy gate's
    tone + noise rows. Returns those two kernels' records, and the records
    of resample and harmpeaks checked and timed on the same rows at the
    default run's launch shapes (their modal shapes are other grids')."""
    cfg = TUT_CONFIG
    plan = PeasoupSearch(cfg, device=dev).build_plan(fil)
    size = plan.size
    nbins, npad = size // 2 + 1, padded_bins(size)
    label, split_label = TUT_RUNS[0][0], TUT_RUNS[1][0]
    rows, n, npad_main = main_shape(runs[label]["shapes"], "dftspec")
    p_rows, p_npad, nlev, mx = main_shape(runs[split_label]["shapes"], "peaks")
    r_rows, d_blk, r_n = main_shape(runs[label]["shapes"], "resample")
    h_rows, h_npad, nharms, h_mx = main_shape(runs[label]["shapes"], "harmpeaks")
    require((n, npad_main, p_rows, p_npad) == (size, npad, rows, npad),
            "dftspec and peaks ran at one row batch of the plan's size")
    require((r_rows, d_blk, r_n, h_rows, h_npad, nharms + 1) == (rows, plan.ndm, size,
                                                                  rows, npad, nlev),
            "resample and harmpeaks ran at that row batch over one DM block")
    batch = pulsar_rows(plan, range(plan.ndm), rows, dm=TUT_DM)
    lo, hi = batch[0][0], batch[-1][0] + 1
    trials = dedisperse(
        fil_to_device(fil, dev), plan.delays, plan.killmask, plan.out_nsamps,
        scale=output_scale(fil.nbits, int(plan.killmask.sum())),
    )
    tobs = float(np.float32(size) * np.float32(fil.tsamp))
    bin_width = float(np.float32(1.0 / tobs))
    xd, mean_d, std_d = preprocess_block(
        trials[lo:hi, :size], torch.from_numpy(plan.zapmask).to(dev), size=size,
        nsamps_valid=min(plan.out_nsamps, size),
        pos5=int(cfg.boundary_5_freq / bin_width),
        pos25=int(cfg.boundary_25_freq / bin_width),
    )
    del trials
    row_dm, afs = batch_rows(plan, batch, lo, fil.tsamp, dev)
    x = resample_rows(xd, row_dm, afs)
    ref = resample_rows_plain(xd, row_dm, afs)
    torch.cuda.synchronize()
    require(torch.equal(x, ref), "resample bitwise equal to its plain version (tutorial)")
    del ref
    other = {"resample": dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: resample_rows(xd, row_dm, afs)),
        plain_ms=time_ms(lambda: resample_rows_plain(xd, row_dm, afs), reps=3),
        bound=bound(rows * n * 4 + (hi - lo) * n * 4 + rows * 8, rows * n * 4.0),
        shape=f"({hi - lo}, {n}) f32 DM trials {lo}..{hi - 1} -> ({rows}, {n}) f32",
        path=label,
    )}
    mean, std = mean_d[row_dm], std_d[row_dm]
    del xd
    out = {"dftspec": dftspec_check(x, mean, std, npad, f"DM trials {lo}..{hi - 1}")}
    out["dftspec"]["path"] = label

    s = dft_untwist_interbin(x, mean, std, npad=npad)
    del x
    windows = plan.windows
    kw = dict(threshold=float(np.float32(cfg.min_snr)), max_peaks=h_mx,
              scales=level_scales(nharms), nbins=nbins)
    k_out = find_harmonic_cluster_peaks(s, windows, nharms=nharms, **kw)
    p_out = find_harmonic_cluster_peaks_plain(s, windows, nharms=nharms, **kw)
    torch.cuda.synchronize()
    for a, b, name in zip(k_out, p_out, ("idxs", "snrs", "counts", "ccounts")):
        require(bitwise_equal(a, b), f"harmpeaks {name} equal to the plain version (tutorial)")
    nclusters = int(k_out[3].sum())
    other["harmpeaks"] = dict(
        max_abs_err=float((k_out[1] - p_out[1]).abs().max()),
        ms=time_ms(lambda: find_harmonic_cluster_peaks(s, windows, nharms=nharms, **kw)),
        plain_ms=time_ms(
            lambda: find_harmonic_cluster_peaks_plain(s, windows, nharms=nharms, **kw),
            reps=3,
        ),
        bound=bound(rows * nbins * 4 + rows * nlev * (h_mx * 8 + 8),
                    rows * nbins * (15 + 2 * nlev)),
        shape=f"({rows}, {npad}) f32, nharms {nharms}, max_peaks {h_mx}, "
              f"{nclusters} clusters",
        path=label,
    )
    del k_out, p_out

    levels = [s, *harmonic_sums(s, nharms=nlev - 1, scaled=False)]
    kw = dict(kw, max_peaks=mx, scales=level_scales(nlev - 1))
    # the bins each level's clamped window holds, summed over the levels
    w = np.asarray(windows, np.int64).reshape(nlev, 2)
    win_bins = int(np.clip(np.minimum(w[:, 1], nbins) - np.maximum(w[:, 0], 0), 0, None).sum())
    k_out = find_cluster_peaks_multi(levels, windows, **kw)
    p_out = find_cluster_peaks_multi_plain(levels, windows, **kw)
    torch.cuda.synchronize()
    for a, b, name in zip(k_out, p_out, ("idxs", "snrs", "counts", "ccounts")):
        require(bitwise_equal(a, b), f"peaks {name} bitwise equal to the plain version")
    nclusters = int(k_out[3].sum())
    require(nclusters > 0, "peaks test rows hold clusters")
    # the two phases (mask, then the walk harmpeaks shares), by kernel
    split, _ = kernel_split(lambda: find_cluster_peaks_multi(levels, windows, **kw),
                            ("peaks_mask", "peaks_walk"))
    # a cross-check of the mask's time by CUDA events: calls queued back to
    # back at a threshold no bin crosses, whose walk only reads its mask
    # words; and the profiler's split of such calls
    kw_none = dict(kw, threshold=float("inf"))
    require(int(find_cluster_peaks_multi(levels, windows, **kw_none)[2].sum()) == 0,
            "an infinite threshold crosses nowhere")
    none_ms = time_ms_queued(lambda: find_cluster_peaks_multi(levels, windows, **kw_none))
    split_none, _ = kernel_split(lambda: find_cluster_peaks_multi(levels, windows, **kw_none),
                                 ("peaks_mask", "peaks_walk"))
    queued_ms = time_ms_queued(lambda: find_cluster_peaks_multi(levels, windows, **kw))
    win_bytes = rows * win_bins * 4
    say(f"peaks phases (torch.profiler device time a launch): mask "
        f"{split['peaks_mask']:.4f} ms, walk {split['peaks_walk']:.4f} ms; calls queued "
        f"back to back (CUDA events) {queued_ms:.4f} ms a call; with no crossing "
        f"{none_ms:.4f} ms a call (profiler: mask {split_none['peaks_mask']:.4f}, walk "
        f"{split_none['peaks_walk']:.4f}); the mask's {win_bytes / 1e9:.4f} GB of window "
        f"bins at {win_bytes / split['peaks_mask'] / 1e9:.4f} TB/s (profiler) and "
        f"{win_bytes / none_ms / 1e9:.4f} TB/s (the no-crossing call)")
    out["peaks"] = dict(
        phases_ms={"mask": split["peaks_mask"], "walk": split["peaks_walk"],
                   "queued_call": queued_ms, "no_crossing_call": none_ms,
                   "no_crossing_mask": split_none["peaks_mask"],
                   "no_crossing_walk": split_none["peaks_walk"]},
        max_abs_err=float((k_out[1] - p_out[1]).abs().max()),
        ms=time_ms(lambda: find_cluster_peaks_multi(levels, windows, **kw)),
        plain_ms=time_ms(lambda: find_cluster_peaks_multi_plain(levels, windows, **kw),
                         reps=3),
        # the bins inside each level's window read once, the cluster slots
        # and counts written
        bound=bound(rows * (win_bins * 4 + nlev * (mx * 8 + 8)), rows * win_bins * 3.0),
        shape=f"{nlev} x ({rows}, {npad}) f32, {win_bins} window bins a row, "
              f"max_peaks {mx}, {nclusters} clusters",
        path=split_label,
    )
    del levels, s, k_out, p_out

    sizes = []
    for n_o in (1 << 15, 1 << 16, 1 << 18):
        r_o = 128
        npad_o = padded_bins(n_o)
        x_o, _, _, mean_o, std_o = oracle_data(n_o, r=r_o, seed=n_o.bit_length())
        x_o, mean_o, std_o = (torch.from_numpy(a).to(dev) for a in (x_o, mean_o, std_o))
        c = dftspec_check(x_o, mean_o, std_o, npad_o, f"m = 2^{n_o.bit_length() - 2}")
        say(f"dftspec ({c['shape']}): {c['ms']:.4f} ms kernel, {c['plain_ms']:.4f} ms "
            f"plain, {c['library_ms']:.4f} ms torch.fft.fft + interbin, bound "
            f"{c['bound'][0]:.4f} ms ({c['bound'][1]})")
        sizes.append(c)
    out["dftspec"]["other_shapes"] = [other_shape(c) for c in sizes]
    return out, other


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

    # the card's DFT (dftspec at this size) and the CPU FFT round
    # differently, so compare the candidates clear of the threshold: same
    # identity, S/N within 1e-3
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


def sp_grid_phase(path: str, outdir: str, profile: bool = False) -> dict:
    """The port's `spsearch` CLI on the single-pulse grid: checks that it
    wrote its files and ran its kernels, and that its top three candidates
    are the three injected pulses, each at its DM trial, within 2 + w/8
    samples of its start, within one width step of its width and with S/N
    within 15% of the matched-filter expectation."""
    from peasoup_tpu_torch.cli.spsearch import main

    pulses = sp_grid_fil(path)
    run = cli_phase(main, ["-i", path, "-o", outdir, *SP_FLAGS], outdir,
                    ("candidates.singlepulse", "overview.xml"), SP_KERNELS, profile)
    cands = run["root"].findall("single_pulse_search/candidates/candidate")
    require(len(cands) >= 3, "at least three single-pulse candidates")
    check_sp_pulses([{k: float(e.find(k).text) for k in SP_FIELDS} for e in cands[:3]],
                    pulses)
    return dict(run, pulses=pulses)


SP_FIELDS = ("dm", "dm_idx", "snr", "sample", "width", "width_idx", "members")


def check_sp_pulses(top: list[dict], pulses: list[dict]) -> None:
    """Phase 6's standard: the top three candidates are the injected
    pulses, each at its DM trial, within 2 + w/8 samples of its start,
    within one width step and with S/N within 15% of the matched filter."""
    fields = SP_FIELDS
    for c in top:
        say("  sp candidate " + ", ".join(f"{k} {c[k]:g}" for k in fields))
    unmatched = list(pulses)
    for c in top:
        near = [p for p in unmatched if abs(c["sample"] - p["start"]) <= 2 + p["width"] / 8]
        require(len(near) == 1, f"top candidate at sample {c['sample']:g} is an injected pulse")
        p = near[0]
        unmatched.remove(p)
        say(f"pulse {p['label']}: DM trial {p['dm_idx']} (DM {p['dm']:.3f}), width "
            f"{p['width']}, start {p['start']}: found at trial {c['dm_idx']:g}, "
            f"sample {c['sample']:g}, width {c['width']:g}, S/N {c['snr']:g} "
            f"(matched filter {p['snr']:.3f}, ratio {c['snr'] / p['snr']:.4f})")
        require(c["dm_idx"] == p["dm_idx"], f"pulse {p['label']} at its DM trial")
        require(abs(c["width_idx"] - np.log2(p["width"])) <= 1,
                f"pulse {p['label']} width within one step")
        require(abs(c["snr"] / p["snr"] - 1.0) <= 0.15,
                f"pulse {p['label']} S/N within 15% of the matched filter")


def max_abs_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref|, with equal entries (-inf among them) at 0."""
    diff = torch.where(got == ref, 0.0, (got.double() - ref.double()).abs())
    return float(diff.max())


def sp_kernel_phase(dev: torch.device, fil, shapes: dict) -> dict:
    """spchain and boxcar against their plain versions at the single-pulse
    grid's modal spchain launch shape: the prefix sums of the first block
    of DM trials, built as the search builds them. Also checks that the
    plain dec-fold of boxcar's output is spchain's, bit for bit."""
    search = SinglePulseSearch(SP_CONFIG, device=dev)
    plan = search.build_dm_plan(fil)
    widths = search.widths_for(plan.out_nsamps)
    n = plan.out_nsamps
    d, tpad, wext, nw, dec = main_shape(shapes, "spchain")
    require((tpad, wext, nw, dec) == (plan_pad(n)[0], width_extent(widths),
                                      len(widths), SP_CONFIG.decimate),
            "spchain ran at the plan's geometry")
    # dedisperse at the search's own launch shape, every DM trial of the plan
    x = fil_to_device(fil, dev)
    require(main_shape(shapes, "dedisperse") == (fil.nsamps, fil.nchans, plan.ndm, n),
            "dedisperse checked at the single-pulse search's shape")
    trials, dd = dedisperse_check(x, fil.nbits, plan.delay_samples(), plan.killmask, n)
    del x
    out = {"dedisperse": dict(dd, path="single-pulse grid")}
    norm = normalise_trials(trials[:d])
    del trials
    csum = prefix_sum_padded(norm, tpad, wext)
    scales = width_scales(widths)
    args = (csum, widths, scales, n, tpad)

    got = boxcar_dec_best(*args, dec)
    ref = boxcar_dec_best_plain(*args, dec)
    torch.cuda.synchronize()
    for a, b, name in zip(got, ref, ("bmax", "barg", "bwidx")):
        require(bitwise_equal(a, b), f"spchain {name} bitwise equal to its plain version")
    csum_bytes, ops = sweep_work(d, n, tpad, tpad + wext, nw)
    out["spchain"] = dict(
        max_abs_err=max_abs_err(got[0], ref[0]),
        ms=time_ms(lambda: boxcar_dec_best(*args, dec)),
        plain_ms=time_ms(lambda: boxcar_dec_best_plain(*args, dec), reps=3),
        # the prefix sums read once, the three planes written once
        bound=bound(csum_bytes + 3 * d * (tpad // dec) * 4, ops),
        shape=f"({d}, {tpad + wext}) f32, {nw} widths, dec {dec} -> "
              f"3 x ({d}, {tpad // dec})",
    )
    del ref
    # spsearch --n_widths 16 (widths to 32,768): a ring whose windows wrap
    wide = default_widths(16)
    wext16 = width_extent(wide)
    wargs = (prefix_sum_padded(norm, tpad, wext16), wide, width_scales(wide), n, tpad)
    wide_bytes, wide_ops = sweep_work(d, n, tpad, tpad + wext16, len(wide))
    del norm
    w_got = boxcar_dec_best(*wargs, dec)
    w_ref = boxcar_dec_best_plain(*wargs, dec)
    torch.cuda.synchronize()
    for a, b, name in zip(w_got, w_ref, ("bmax", "barg", "bwidx")):
        require(bitwise_equal(a, b), f"spchain {name} bitwise equal to its plain version "
                                     "(16 widths)")
    out["spchain"]["other_shapes"] = [other_shape(dict(
        path="spsearch --n_widths 16",
        max_abs_err=max_abs_err(w_got[0], w_ref[0]),
        ms=time_ms(lambda: boxcar_dec_best(*wargs, dec)),
        plain_ms=time_ms(lambda: boxcar_dec_best_plain(*wargs, dec), reps=3),
        bound=bound(wide_bytes + 3 * d * (tpad // dec) * 4, wide_ops),
        shape=f"({d}, {tpad + wext16}) f32, {len(wide)} widths, dec {dec} -> "
              f"3 x ({d}, {tpad // dec})",
    ))]
    del wargs, w_got, w_ref

    best, bw = boxcar_best(*args)
    ref = boxcar_best_plain(*args)
    torch.cuda.synchronize()
    require(bitwise_equal(best, ref[0]) and bitwise_equal(bw, ref[1]),
            "boxcar bitwise equal to its plain version")
    err = max_abs_err(best, ref[0])
    del ref
    folded = dec_fold(best, bw, dec)
    require(all(bitwise_equal(a, b) for a, b in zip(folded, got)),
            "the dec-fold of boxcar's output is spchain's")
    del best, bw, folded, got
    # boxcar is not on the batch search's path (spchain is): the stream's
    # path takes its modal shape, this one is listed under other_shapes
    out["boxcar"] = dict(
        boxcar_times(args),
        path="single-pulse grid (spchain's shape)",
        max_abs_err=err,
        plain_ms=time_ms(lambda: boxcar_best_plain(*args), reps=3),
        bound=bound(csum_bytes + d * tpad * 8, ops),
        shape=f"({d}, {tpad + wext}) f32, {nw} widths -> 2 x ({d}, {tpad})",
    )
    return out


def boxcar_times(args: tuple) -> dict:
    """boxcar's times at one shape: a call of the wrapper as the stream
    sees it (``ms``: CUDA events around one call on an idle card, the
    host's part included), the kernel's device time alone (``kernel_ms``,
    kernel_split over the ``kernel_ms_launches`` launches the profiler
    recorded of 10) and a call's share of 20 queued back to back
    (``queued_ms``)."""
    fn = lambda: boxcar_best(*args)  # noqa: E731
    kernel_ms, recorded = kernel_split(fn, ("boxcar_kernel",))
    return dict(ms=time_ms(fn), kernel_ms=kernel_ms["boxcar_kernel"],
                kernel_ms_launches=recorded["boxcar_kernel"],
                queued_ms=time_ms_queued(fn))


def sp_small_fil(path: str, nsamps: int = 1 << 15) -> tuple[int, list]:
    """8-bit 16-channel filterbank of ``nsamps`` samples with one narrow (8
    samples) and one broad (64 samples) dispersed top-hat pulse at the
    middle DM trial of a dm_end 60 plan (tests/test_singlepulse.py:
    make_sp_fil's recipe)."""
    nchans, tsamp, fch1, foff = 16, 0.000256, 1400.0, -8.0
    hdr = SigprocHeader(
        source_name="SPFAKE", tsamp=tsamp, tstart=55000.0, fch1=fch1, foff=foff,
        nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    rng = np.random.default_rng(3)
    data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
    fil = Filterbank(header=hdr, data=np.zeros((nsamps, nchans), np.uint8))
    plan = SinglePulseSearch(SinglePulseConfig(dm_end=60.0), device="cpu").build_dm_plan(fil)
    idx = plan.ndm // 2
    delays = plan.delay_samples()[idx]
    for start, width, amp in ((9000, 8, 9.0), (20000, 64, 4.0)):
        for c in range(nchans):
            data[start + delays[c] : start + delays[c] + width, c] += amp
    fil.data[:] = np.clip(np.rint(data), 0, 255).astype(np.uint8)
    write_filterbank(path, fil)
    return idx, [9000, 20000]


def sp_agreement_phase(tmp: str) -> int:
    """SinglePulseSearch on the card against the CPU on a small input: the
    same candidates clear of the threshold, (dm_idx, sample, width_idx)
    exactly and S/N within 1e-4 relative (the two sum in other orders)."""
    path = os.path.join(tmp, "sp_small.fil")
    idx, starts = sp_small_fil(path)
    fil = read_filterbank(path)
    cfg = SinglePulseConfig(dm_end=60.0, min_snr=7.0, n_widths=8)
    gpu = SinglePulseSearch(cfg, device="cuda").run(fil).candidates
    cpu = SinglePulseSearch(cfg, device="cpu").run(fil).candidates
    strong = [c for c in cpu if c.snr >= 1.1 * cfg.min_snr]
    got = [c for c in gpu if c.snr >= 1.1 * cfg.min_snr]
    require(len(strong) >= 2, "small input yields both pulses")
    require(len(got) == len(strong), "same number of strong single-pulse candidates")
    for a, b in zip(strong, got):
        require(
            (a.dm_idx, a.sample, a.width_idx) == (b.dm_idx, b.sample, b.width_idx)
            and abs(a.snr - b.snr) <= 1e-4 * a.snr,
            f"single-pulse candidate agrees: cpu {a} vs cuda {b}",
        )
    for s in starts:
        require(any(c.dm_idx == idx and abs(c.sample - s) <= 2 for c in strong),
                f"the pulse at sample {s} is found at DM trial {idx}")
    return len(strong)


# --- the phases of the dedispersion engines, checkpoints, the memory ladder
# and the smaller searches ----------------------------------------------------

# the engines' input: 8-bit samples in 256 channels over the big grid's band,
# 2^20 samples at 64 us; dm_end 40 gives 190 trials. At 16 channels a band
# (nsub 16) stage 2 sums up to 16 x 255 = 4,080 a sample, past the 2,048
# TF32 holds exactly.
ENG_NCHANS, ENG_NSAMPS, ENG_DM_END, ENG_NSUB = 256, 1 << 20, 40.0, 16
# the FFA grid: the big grid's geometry and noise with a P = 1.2 s pulsar of
# duty 0.02 at DM 10
FFA_PERIOD, FFA_DUTY = 1.2, 0.02
FFA_FLAGS = ["--dm_end", "20", "--p_start", "0.8", "--p_end", "5"]
# the JAX package's top period on this file (`python -m peasoup_tpu.cli.ffa`
# with FFA_FLAGS on ffa_grid_fil's file, on the CPU): its row-to-period map,
# which the port follows, reads the 1.2 s pulsar 2e-3 long (ROADMAP §C)
FFA_JAX_PERIOD = 1.20239452252252
# the memory ladder's phase: the caching allocator may hold this much, less
# than the big grid's first DM block and row batch take
OOM_LIMIT_BYTES = 3_000_000_000
# accmap: four beams of one noise series at these sample offsets
ACC_OFFSETS, ACC_NSAMPS = (0, 17, 40, 123), 1 << 16


class LogLines(logging.Handler):
    """The messages the named loggers emit at INFO and above while the
    block runs."""

    def __init__(self, *names: str):
        super().__init__(logging.INFO)
        self.lines: list[str] = []
        self.loggers = [logging.getLogger(n) for n in names]

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.levels = [lg.level for lg in self.loggers]
        for lg in self.loggers:
            lg.setLevel(logging.INFO)
            lg.addHandler(self)
        return self

    def __exit__(self, *exc):
        for lg, level in zip(self.loggers, self.levels):
            lg.removeHandler(self)
            lg.setLevel(level)

    def find(self, prefix: str) -> list[str]:
        return [ln for ln in self.lines if ln.startswith(prefix)]


def engines_phase(dev: torch.device) -> dict:
    """The dedispersion engines on ENG_*'s 8-bit, 256-channel input against
    the dedisperse kernel: exact subbands (max_smear 0) with scan and with
    matmul stages, and the banded-matmul engine, each bitwise the kernel's
    trials; each timed (CUDA events, median of 5) beside the kernel."""
    from peasoup_tpu_torch.ops.dedisperse import (
        dedisperse_matmul, dedisperse_subband, subband_groups,
    )
    from peasoup_tpu_torch.plan.dm_plan import DMPlan

    plan = DMPlan.create(nsamps=ENG_NSAMPS, nchans=ENG_NCHANS, tsamp=TSAMP, fch1=FCH1,
                         foff=-300.0 / ENG_NCHANS, dm_start=0.0, dm_end=ENG_DM_END)
    delays = plan.delay_samples()
    kill = plan.killmask.copy()
    kill[[7, ENG_NCHANS // 2 - 28, ENG_NCHANS - 55]] = 0  # three channels killed
    scale = output_scale(8, int(kill.sum()))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(
        rng.integers(0, 256, size=(ENG_NSAMPS, ENG_NCHANS), dtype=np.uint8)).to(dev)
    args = (x, delays, kill, plan.out_nsamps)
    groups = subband_groups(delays, ENG_NSUB, 0.0)
    say(f"engines: {plan.ndm} DM trials (dm_end {ENG_DM_END}) of {plan.out_nsamps} samples, "
        f"{ENG_NCHANS} 8-bit channels ({int(kill.sum())} kept), nsub {ENG_NSUB}, "
        f"{len(groups)} groups at max_smear 0")
    calls = {
        "dedisperse kernel": lambda: dedisperse(*args, scale=scale),
        "subband, scan stages": lambda: dedisperse_subband(
            *args, nsub=ENG_NSUB, max_smear=0.0, scale=scale),
        "subband, matmul stages": lambda: dedisperse_subband(
            *args, nsub=ENG_NSUB, max_smear=0.0, scale=scale, use_matmul=True),
        "banded matmul": lambda: dedisperse_matmul(*args, scale=scale),
    }
    ref = calls["dedisperse kernel"]()
    out = {}
    for label, fn in calls.items():
        got = fn()
        require(got.dtype == torch.uint8 and torch.equal(got, ref),
                f"{label}: bitwise the dedisperse kernel's trials")
        out[label] = time_ms(fn)
        say(f"engines: {label}: {out[label]:.3f} ms (median of 5), bitwise the kernel's")
    del x, ref
    torch.cuda.empty_cache()
    return out


def timers_line(label: str, run: dict) -> None:
    say(f"{label} stage timers (s): " + json.dumps(run["timers"], sort_keys=True))


def subband_grid_phase(path: str, tmp: str) -> dict:
    """`peasoup --subbands 8` on the big grid at the default smear: the top
    candidate is the pulsar, and the dedisperse kernel does not run."""
    run = periodicity_phase(path, os.path.join(tmp, "big_subbands"),
                            GRID_FLAGS + ["--subbands", "8"], PERIOD,
                            path_kernels=PEASOUP_KERNELS[1:])
    require(run["launches"]["dedisperse"] == 0, "the subband path replaces the kernel")
    timers_line("big grid, --subbands 8", run)
    return run


def same_candidates(run: dict, base: dict, what: str) -> None:
    """Two runs' candidates, field for field: overview.xml's and the
    candidates file's bytes."""
    with open(os.path.join(run["outdir"], "candidates.peasoup"), "rb") as f:
        data = f.read()
    require(xml_candidates(run["root"]) == base["cands"] and data == base["cands_file"],
            f"{what} gives the default run's candidates field for field")


def tutorial_engine_phase(path: str, tmp: str, base: dict) -> dict:
    """The tutorial grid with exact subbands and with the banded-matmul
    engine: the default run's candidates, field for field."""
    runs = {}
    for label, flags in (("--subbands 8 --subband_smear 0",
                          ["--subbands", "8", "--subband_smear", "0"]),
                         ("--dedisp_engine matmul", ["--dedisp_engine", "matmul"])):
        outdir = os.path.join(tmp, "tut_" + flags[1])
        run = periodicity_phase(path, outdir, TUT_FLAGS + flags, TUT_PERIOD,
                                path_kernels=TUT_KERNELS[1:])
        run["outdir"] = outdir
        require(run["launches"]["dedisperse"] == 0, f"{label}: the kernel is replaced")
        same_candidates(run, base, f"tutorial grid, {label}")
        timers_line(f"tutorial grid, {label}", run)
        runs[label] = run
    return runs


def checkpoint_phase(path: str, tmp: str, base: dict) -> dict:
    """Checkpoints on the tutorial grid: a run with --checkpoint; the store
    rewritten through SearchCheckpoint with every other DM trial; a resumed
    run that searches only the missing ones; a third run on the full store
    that takes the fast path (no kernel launches). Each gives the default
    run's candidates field for field. Then the same on the small
    single-pulse input (blocks of 8 trials, every other block kept)."""
    from peasoup_tpu_torch.cli.peasoup import main
    from peasoup_tpu_torch.cli.spsearch import main as sp_main
    from peasoup_tpu_torch.pipeline.checkpoint import SearchCheckpoint

    def halve(ck: str, keep) -> tuple[int, int]:
        key = str(np.load(ck)["config_key"])
        store = SearchCheckpoint(ck, key)
        full = store.load()
        store.save({d: v for d, v in full.items() if keep(d)})
        return len(full), len(store.load())

    out = {}
    ck = os.path.join(tmp, "tut.ckpt")
    for step in ("first", "resumed", "fast path"):
        outdir = os.path.join(tmp, "tut_ckpt_" + step.replace(" ", "_"))
        with LogLines("peasoup_tpu_torch.search") as log_lines:
            run = periodicity_phase(path, outdir, TUT_FLAGS + ["--checkpoint", ck],
                                    TUT_PERIOD, path_kernels=() if step == "fast path"
                                    else TUT_KERNELS)
        run["outdir"] = outdir
        same_candidates(run, base, f"tutorial grid --checkpoint, {step} run")
        searched = log_lines.find("searched ")
        say(f"checkpoint, {step} run: {searched[-1] if searched else 'no trial searched'}; "
            f"{sum(run['launches'].values())} kernel launches")
        timers_line(f"tutorial grid --checkpoint, {step} run", run)
        if step == "first":
            ndm, kept = halve(ck, lambda d: d % 2 == 0)
            say(f"checkpoint: store rewritten with {kept} of {ndm} DM trials")
            require(f"searched {ndm} of {ndm} DM trials (0 restored)" in searched,
                    "the first run searches every trial")
        elif step == "resumed":
            require(f"searched {ndm - kept} of {ndm} DM trials ({kept} restored)"
                    in searched, "the resumed run searches only the missing trials")
        else:
            require(sum(run["launches"].values()) == 0 and run["launches"]["dedisperse"] == 0,
                    "the fast path launches no kernel, dedisperse included")
            require(log_lines.find("resume fast path"), "the fast path was taken")
        out[step] = run

    sp_path = os.path.join(tmp, "sp_ckpt.fil")
    sp_small_fil(sp_path)
    ck = os.path.join(tmp, "sp.ckpt")
    flags = ["--dm_end", "60", "-m", "7", "--n_widths", "8", "--dm_block", "8"]
    ref = None
    for step in ("plain", "first", "resumed", "fast path"):
        outdir = os.path.join(tmp, "sp_ckpt_" + step.replace(" ", "_"))
        argv = ["-i", sp_path, "-o", outdir, *flags]
        if step != "plain":
            argv += ["--checkpoint", ck]
        with LogLines("peasoup_tpu_torch.single_pulse") as log_lines:
            run = cli_phase(sp_main, argv, outdir, ("candidates.singlepulse", "overview.xml"),
                            () if step == "fast path" else SP_KERNELS)
        with open(os.path.join(outdir, "candidates.singlepulse")) as f:
            text = f.read()
        searched = log_lines.find("searched ")
        say(f"sp checkpoint, {step} run: {searched[-1] if searched else 'no trial searched'}; "
            f"{sum(run['launches'].values())} kernel launches")
        if step == "plain":
            ref = text
            require(len(text.splitlines()) >= 2, "the small single-pulse input yields candidates")
            continue
        require(text == ref, f"spsearch --checkpoint, {step} run: the plain run's candidates")
        if step == "first":
            ndm, kept = halve(ck, lambda d: (d // 8) % 2 == 0)
            say(f"sp checkpoint: store rewritten with {kept} of {ndm} DM trials")
        elif step == "resumed":
            require(f"searched {ndm - kept} of {ndm} DM trials ({kept} restored)"
                    in searched, "the resumed spsearch searches only the missing blocks")
        else:
            require(sum(run["launches"].values()) == 0, "the sp fast path launches no kernel")
        out["sp " + step] = run
    return out


def oom_phase(path: str, tmp: str, base: dict) -> dict:
    """The big grid's `peasoup` run in a subprocess whose caching allocator
    may hold OOM_LIMIT_BYTES (torch.cuda.set_per_process_memory_fraction),
    less than its first DM block takes: a real out-of-memory error. Its log
    shows the DM block shrinking, and its candidates equal the unconstrained
    run's."""
    outdir = os.path.join(tmp, "big_oom")
    frac = OOM_LIMIT_BYTES / torch.cuda.get_device_properties(0).total_memory
    code = (
        "import logging, sys, torch\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
        f"torch.cuda.set_per_process_memory_fraction({frac!r}, 0)\n"
        "logging.basicConfig(level=logging.WARNING, stream=sys.stderr)\n"
        "from peasoup_tpu_torch.cli.peasoup import main\n"
        f"sys.exit(main({['-i', path, '-o', outdir, *GRID_FLAGS]!r}))\n"
    )
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    shrinks = [ln for ln in proc.stderr.splitlines() if "device OOM at dm_block" in ln]
    for ln in shrinks:
        say("oom: " + ln[:240])
    require(proc.returncode == 0, f"the memory-limited run exits 0: {proc.stderr[-2000:]}")
    require(len(shrinks) >= 1, "the log shows at least one dm_block shrink")
    root = ET.parse(os.path.join(outdir, "overview.xml")).getroot()
    got, want = xml_candidates(root), xml_candidates(base["root"])
    diff = [(a, b) for a, b in zip(got, want) if a != b]
    if diff or len(got) != len(want):
        say(f"oom: {len(got)} candidates against {len(want)}; first difference: "
            f"{diff[0] if diff else 'the count'}")
    require(got == want, "the memory-limited run gives the unconstrained run's candidates")
    timers = {e.tag: float(e.text) for e in root.find("execution_times")}
    say(f"oom: {len(shrinks)} shrink(s) under a {OOM_LIMIT_BYTES} B allocator limit, "
        f"{wall:.3f} s subprocess wall; stage timers (s): {json.dumps(timers, sort_keys=True)}")
    return dict(shrinks=len(shrinks), timers=timers)


def ffa_grid_fil(path: str) -> None:
    """The big grid's filterbank geometry and noise (seed 7) with a P = 1.2 s
    pulsar of duty 0.02 at DM 10, whole-sample delays."""
    nchans, nsamps = NCHANS, NSAMPS
    rng = np.random.default_rng(7)
    delays = np.rint(
        np.float32(PULSAR_DM) * np.abs(delay_table(FCH1, FOFF, nchans, TSAMP))
    ).astype(np.int64)
    t = np.arange(nsamps, dtype=np.float64)
    pulse = (((t * TSAMP / FFA_PERIOD) % 1.0) < FFA_DUTY).astype(np.uint8)
    data = rng.integers(0, 3, size=(nsamps, nchans), dtype=np.uint8)
    for c in range(nchans):
        src = np.clip(t - delays[c], 0, nsamps - 1).astype(np.int64)
        data[:, c] += pulse[src]
    hdr = SigprocHeader(
        source_name="ffa_grid_synth", data_type=1, nchans=nchans, nbits=2,
        nifs=1, tsamp=TSAMP, tstart=51000.0, fch1=FCH1, foff=FOFF,
    )
    write_filterbank(path, Filterbank(header=hdr, data=data))


def ffa_phase(tmp: str) -> dict:
    """`peasoup-ffa` on the FFA grid: the top candidate's period is the JAX
    package's on the same file (FFA_JAX_PERIOD) to 1e-6, and dedisperse
    ran."""
    from peasoup_tpu_torch.cli.ffa import main

    path = os.path.join(tmp, "ffa.fil")
    ffa_grid_fil(path)
    out = os.path.join(tmp, "ffa.xml")
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = main(["-i", path, "-o", out, *FFA_FLAGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(rc == 0, "peasoup-ffa exit code 0")
    launches = dict(kernels.launches)
    require(launches["dedisperse"] > 0, "peasoup-ffa ran the dedisperse kernel")
    root = ET.parse(out).getroot()
    cands = root.findall("candidates/candidate")
    require(len(cands) > 0, "peasoup-ffa found candidates")
    for e in cands[:3]:
        say("  ffa candidate " + ", ".join(
            f"{k} {e.find(k).text}" for k in ("period", "dm", "snr", "width", "duty_cycle")))
    top = float(cands[0].find("period").text)
    require(abs(top - FFA_JAX_PERIOD) / FFA_JAX_PERIOD < 1e-6,
            f"the top FFA candidate's period {top} within 1e-6 of the JAX package's "
            f"{FFA_JAX_PERIOD}")
    timers = {e.tag: float(e.text) for e in root.find("execution_times")}
    say(f"ffa: {root.find('dedispersion_trials').get('count')} DM trials, {len(cands)} "
        f"candidates, {wall:.3f} s CLI wall, dedisperse launches {launches['dedisperse']}; "
        f"stage timers (s): {json.dumps(timers, sort_keys=True)}")
    os.remove(path)
    return dict(timers=timers, wall=wall)


def coincidence_phase(tmp: str) -> dict:
    """`coincidencer` over 13 beams (coincidence_beams), on the card and on
    the CPU: the sample mask flags the burst and nothing else (the pulsar
    in beam 0 is not masked), birdies.txt lists the tone's bin, and the
    card's mask equals the CPU's."""
    from peasoup_tpu_torch.cli.coincidencer import main

    beam_dir = os.path.join(tmp, "beams")
    os.makedirs(beam_dir)
    paths = coincidence_beams(beam_dir)
    res = {}
    for dev in ("cuda", "cpu"):
        mask, birdies = (os.path.join(tmp, f"{dev}.{n}") for n in ("eb_mask", "birdies"))
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = main([*paths, "--o", mask, "--o2", birdies, "--device", dev])
        wall = time.perf_counter() - t0
        require(rc == 0, f"coincidencer on {dev} exits 0")
        with open(mask) as f:
            lines = f.read().splitlines()
        res[dev] = dict(lines=lines, birdies=np.loadtxt(birdies, ndmin=2), wall=wall,
                        launches=kernels.launches["dedisperse"])
    cuda = res["cuda"]
    require(cuda["launches"] == COIN_BEAMS, "dedisperse ran once a beam on the card")
    require(cuda["lines"] == res["cpu"]["lines"], "the card's sample mask equals the CPU's")
    mask = np.array([int(v) for v in cuda["lines"][1:]])
    require(mask.size == TUT_NSAMPS, "the mask covers the full dedispersed length")
    b0, blen = COIN_BURST
    flagged = np.flatnonzero(mask == 0)
    require((mask[b0 : b0 + blen] == 0).all(), "the sample mask flags the burst")
    require(((flagged >= b0 - 64) & (flagged < b0 + blen + 64)).all(),
            "nothing but the burst is masked (the pulsar's beam is not)")
    bird = cuda["birdies"]
    require(bool((np.abs(bird[:, 0] - COIN_TONE_HZ) <= bird[:, 1] / 2 + 0.01).any()),
            "birdies.txt lists the tone's bin")
    say(f"coincidencer: {COIN_BEAMS} beams of {TUT_NSAMPS} samples, {flagged.size} samples "
        f"masked (burst {b0}..{b0 + blen - 1}), {len(bird)} birdies ({len(res['cpu']['birdies'])} "
        f"on the CPU); {cuda['wall']:.3f} s on the card, {res['cpu']['wall']:.3f} s on the CPU")
    return res


def accmap_phase(tmp: str) -> dict:
    """`accmap` on four beams of one noise series at ACC_OFFSETS: every
    pair's lag is found."""
    import contextlib
    import io

    from peasoup_tpu_torch.cli.accmap import main

    rng = np.random.default_rng(9)
    base = rng.normal(100, 5, size=ACC_NSAMPS + max(ACC_OFFSETS))
    files = []
    for k, off in enumerate(ACC_OFFSETS):
        data = np.clip(base[off : off + ACC_NSAMPS, None]
                       + rng.normal(0, 0.5, size=(ACC_NSAMPS, 4)), 0, 255).astype(np.uint8)
        hdr = SigprocHeader(source_name=f"acc{k}", data_type=1, nchans=4, nbits=8, nifs=1,
                            tsamp=64e-6, tstart=51000.0, fch1=FCH1, foff=-1.0)
        files.append(os.path.join(tmp, f"acc{k}.fil"))
        write_filterbank(files[-1], Filterbank(header=hdr, data=data))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(files + ["-d", "256"])
    wall = time.perf_counter() - t0
    require(rc == 0, "accmap exits 0")
    lines = buf.getvalue().splitlines()
    require(len(lines) == 6, "accmap prints one line a pair")
    k = 0
    for i in range(len(files)):
        for j in range(i + 1, len(files)):
            lag = int(lines[k].split("(lag ")[1].split(" ")[0])
            require(lag == ACC_OFFSETS[i] - ACC_OFFSETS[j],
                    f"accmap pair ({i}, {j}): lag {lag}, planted {ACC_OFFSETS[i] - ACC_OFFSETS[j]}")
            k += 1
    say(f"accmap: {len(lines)} pairs, every planted lag found, {wall:.3f} s wall")
    return dict(wall=wall)


def subband_agreement_phase(tmp: str) -> int:
    """The subband search (nsub 4, max_smear 1.0) on the card against the
    CPU on the small 8-bit input: the same strong candidates (identity
    exact, S/N within 1e-3, as agreement_phase holds them), and the subband
    trials bitwise equal."""
    from peasoup_tpu_torch.ops.dedisperse import dedisperse_subband

    path = os.path.join(tmp, "small_sub.fil")
    small_fil(path)
    fil = read_filterbank(path)
    cfg = SearchConfig(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0,
                       min_snr=6.0, subbands=4, subband_smear=1.0)
    gpu = PeasoupSearch(cfg, device="cuda").run(fil).candidates
    cpu = PeasoupSearch(cfg, device="cpu").run(fil).candidates
    strong = [c for c in cpu if c.snr >= 1.1 * cfg.min_snr]
    got = [c for c in gpu if c.snr >= 1.1 * cfg.min_snr]
    require(len(strong) > 0 and len(got) == len(strong),
            "the subband search gives the same number of strong candidates")
    for a, b in zip(strong, got):
        require((a.dm_idx, a.acc, a.nh, a.freq) == (b.dm_idx, b.acc, b.nh, b.freq)
                and abs(a.snr - b.snr) <= 1e-3 * a.snr,
                f"subband candidate agrees: cpu {a} vs cuda {b}")
    plan = PeasoupSearch(cfg, device="cpu").build_plan(fil)
    scale = output_scale(fil.nbits, int(plan.killmask.sum()))
    trials = {dev: dedisperse_subband(fil_to_device(fil, torch.device(dev)), plan.delays,
                                      plan.killmask, plan.out_nsamps, nsub=4,
                                      max_smear=1.0, scale=scale).cpu()
              for dev in ("cuda", "cpu")}
    require(torch.equal(trials["cuda"], trials["cpu"]),
            "the card's subband trials are the CPU's bit for bit")
    return len(strong)


# --- the FDAS search, the streaming search and odd decimations (their
# phases after the smaller searches') -----------------------------------------

# the FDAS grid: the big grid's geometry and noise (seed 7) with a P = 5.03 ms
# pulsar at DM 10, its phase following the FDAS template model at z = -24
# bins over the 2^21-sample FFT (tests/test_fdas.py:_make_fil's recipe);
# `peasoup-fdas --dm_end 20` with the CLI's defaults, --zmax 64 (65
# templates) and --nharmonics 4. The pulse is a square wave (duty 0.5),
# which has no even harmonics: one template serves every harmonic sum
# level, so a narrow pulse's second harmonic (z = -48, inside zmax) wins
# over its fundamental (on the H100 with the binary grid's duty-0.03
# pulse). It is faint, each in-pulse 2-bit sample raised a level with
# probability 0.005: the spectrum's own mean and std normalise it, and a
# bright pulsar inflates them most at its own DM, moving its top S/N a few
# trials off (PERF.md §6). Its
# fundamental tells DM trials apart only by the smear across the band
# (1.015 ms a unit of DM), so the top candidate's DM is held within a
# fifth of the period's smear, |DM - 10| <= 0.99.
FDAS_Z, FDAS_SIZE, FDAS_DUTY, FDAS_Q = -24.0, 1 << 21, 0.5, 0.005
FDAS_DM_TOL = 0.99
FDAS_FLAGS = ["--dm_end", "20"]
# FDAS card against CPU: tests/test_fdas.py's geometry (8 channels of 8-bit
# samples at 4 ms, a 2^15-point FFT) and its config, the "midz" pulsar
FDAS_SMALL = dict(nchans=8, tsamp=0.004, fch1=1500.0, foff=-20.0, fftn=1 << 15,
                  period=0.02, dm=60.0)
FDAS_SMALL_CONFIG = dict(dm_start=50.0, dm_end=70.0, zmax=32.0, zstep=2.0,
                         nharmonics=2, limit=20)
# the streaming grid: `peasoup-stream --replay` of the single-pulse grid's
# file as fast as it drains, the batch search's DM range and threshold, the
# CLI's default chunk (16,384 samples) and widths (12), dec 32
STREAM_FLAGS = ["--rate", "0", "--dm_end", "250", "-m", "7", "--decimate", "32"]
STREAM_KERNELS = ("dedisperse", "boxcar")
# streaming card against CPU: tests/test_stream.py's stream_fil and config
STREAM_SMALL_CONFIG = dict(dm_end=20.0, min_snr=7.0, n_widths=6, decimate=8,
                           chunk_samples=1024, latency_slo_s=30.0, warmup=False)
# the batch single-pulse search at a decimation spchain does not take: the
# small single-pulse input cut to 24,576 samples (tpad 24,576 = 512 x 48)
ODD_DEC, ODD_NSAMPS = 48, 24_576


def fdas_grid_fil(path: str) -> None:
    """The FDAS grid's filterbank: the big grid's geometry and noise (seed
    7), a P = 5.03 ms square-wave pulse (FDAS_DUTY) whose phase is b0*u +
    z*u^2/2 (u = t/T over the FFT length, z = FDAS_Z, mean frequency 1/P),
    at DM 10 with whole-sample delays, each in-pulse sample of each
    channel raised a level with probability FDAS_Q."""
    nchans, nsamps = NCHANS, NSAMPS
    rng = np.random.default_rng(7)
    delays = np.rint(
        np.float32(PULSAR_DM) * np.abs(delay_table(FCH1, FOFF, nchans, TSAMP))
    ).astype(np.int64)
    j = np.arange(nsamps, dtype=np.float64)
    u = j / FDAS_SIZE
    b0 = FDAS_SIZE * TSAMP / BIN_PERIOD - FDAS_Z / 2.0
    pulse = ((b0 * u + FDAS_Z * u * u / 2.0) % 1.0) < FDAS_DUTY
    data = rng.integers(0, 3, size=(nsamps, nchans), dtype=np.uint8)
    for c in range(nchans):
        src = np.clip(j - delays[c], 0, nsamps - 1).astype(np.int64)
        data[:, c] += pulse[src] & (rng.random(nsamps) < FDAS_Q)
    hdr = SigprocHeader(
        source_name="fdas_grid_synth", data_type=1, nchans=nchans, nbits=2,
        nifs=1, tsamp=TSAMP, tstart=51000.0, fch1=FCH1, foff=FOFF,
    )
    write_filterbank(path, Filterbank(header=hdr, data=data))


def fdas_small_fil(path: str, z: float = -24.0, seed: int = 7) -> None:
    """tests/test_fdas.py:_make_fil's filterbank (8 channels, 8-bit, a
    P = 20 ms pulsar at DM 60) with a constant acceleration of z bins of
    drift, injected through the resampler's inverse map."""
    g = FDAS_SMALL
    rng = np.random.default_rng(seed)
    size = g["fftn"] + 64
    plan = DMPlan.create(size + 64, g["nchans"], g["tsamp"], g["fch1"], g["foff"],
                         0.0, 100.0)
    nsamps = size + plan.max_delay
    j = np.arange(nsamps, dtype=np.float64)
    f0, tobs = 1.0 / g["period"], g["fftn"] * g["tsamp"]
    accel = -z * SPEED_OF_LIGHT / (f0 * tobs * tobs)
    af = float(accel_factor(np.array([accel]), g["tsamp"])[0])
    phase = (j - af * j * (j - g["fftn"])) * g["tsamp"] / g["period"]
    pulse = ((phase % 1.0) < 0.08) * 20.0
    delays = np.rint(
        (np.float32(g["dm"]) * np.abs(plan.delays)).astype(np.float32)
    ).astype(int)
    data = rng.normal(100, 8, size=(nsamps, g["nchans"]))
    for c in range(g["nchans"]):
        src = np.clip(j - delays[c], 0, nsamps - 1).astype(int)
        data[:, c] += pulse[src]
    hdr = SigprocHeader(
        source_name="fdas_inj", data_type=1, nchans=g["nchans"], nbits=8, nifs=1,
        tsamp=g["tsamp"], tstart=50000.0, fch1=g["fch1"], foff=g["foff"],
    )
    write_filterbank(path, Filterbank(header=hdr,
                                      data=np.clip(data, 0, 255).astype(np.uint8)))


def stream_small_fil(path: str) -> None:
    """tests/test_stream.py's stream_fil: 4,096 8-bit samples in 8 channels
    with two dispersed 4-sample pulses at samples 900 and 2040 (the second
    inside a 1,024-sample chunk's deferred zone) at the middle DM trial of
    a dm_end 20 plan."""
    nsamps, nchans, tsamp, fch1, foff = 1 << 12, 8, 0.000256, 1400.0, -16.0
    plan = DMPlan.create(nsamps, nchans, tsamp, fch1, foff, 0.0, 20.0)
    delays = plan.delay_samples()[plan.ndm // 2]
    rng = np.random.default_rng(3)
    data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
    for s0 in (900, 2040):
        for c in range(nchans):
            data[s0 + delays[c] : s0 + 4 + delays[c], c] += 16.0
    hdr = SigprocHeader(
        source_name="STREAMTEST", tsamp=tsamp, tstart=55000.0, fch1=fch1, foff=foff,
        nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    write_filterbank(path, Filterbank(header=hdr,
                                      data=np.clip(np.rint(data), 0, 255).astype(np.uint8)))


def fdas_phase(tmp: str) -> dict:
    """`peasoup-fdas` on the FDAS grid at full width (77 DM x 65 templates
    of 2^20 + 1 bins): the top candidate within 2e-3 of the pulsar's
    period, within FDAS_DM_TOL of DM 10 and at a negative z; dedisperse ran.
    Prints its stage timers, and times the host's cluster walk
    (ops/peaks.py:cluster_peaks_device, a Python loop of max_peaks + 1
    steps) a call at the run's tile, and the calls a run makes."""
    from peasoup_tpu_torch.cli.fdas import main
    from peasoup_tpu_torch.ops.peaks import cluster_peaks_device

    path = os.path.join(tmp, "fdas.fil")
    fdas_grid_fil(path)
    outdir = os.path.join(tmp, "fdas")
    with LogLines("peasoup_tpu_torch.fdas") as logs:
        run = cli_phase(main, ["-i", path, "-o", outdir, *FDAS_FLAGS], outdir,
                        ("candidates.peasoup", "candidates.fdas", "overview.xml"),
                        ("dedisperse",))
    os.remove(path)
    root = run["root"]
    cands = root.findall("candidates/candidate")
    require(len(cands) > 0, "peasoup-fdas found candidates")
    fields = ("period", "dm", "acc", "nh", "snr", "z", "w", "fdot")
    for e in cands[:5]:
        say("  fdas candidate " + ", ".join(f"{k} {e.find(k).text}" for k in fields))
    top = {k: float(cands[0].find(k).text) for k in fields}
    dms = np.array([float(e.text) for e in root.findall("dedispersion_trials/trial")])
    near = dms[int(np.argmin(np.abs(dms - PULSAR_DM)))]
    require(abs(top["period"] - BIN_PERIOD) / BIN_PERIOD < 2e-3,
            f"the top FDAS candidate's period {top['period']} within 2e-3 of {BIN_PERIOD}")
    require(abs(top["dm"] - PULSAR_DM) <= FDAS_DM_TOL,
            f"the top FDAS candidate's DM {top['dm']} within {FDAS_DM_TOL} of "
            f"{PULSAR_DM} (the nearest trial {near})")
    require(top["z"] < 0, f"the top FDAS candidate's z {top['z']} is negative")
    timers = run["timers"]
    say(f"fdas: {len(dms)} DM trials x {root.find('fdas_search/fdot_trials').get('count')} "
        f"templates; top candidate z {top['z']:g}, nh {top['nh']:g}, DM {top['dm']!r} "
        f"(injected z {FDAS_Z:g} at DM {PULSAR_DM}, the nearest trial {near!r}); "
        f"dedisperse launches {run['launches']['dedisperse']}; {run['wall']:.3f} s CLI wall")
    say("fdas stage timers (s): " + json.dumps(
        {k: timers[k] for k in ("plan", "dedispersion", "search_device", "search_host",
                                "distilling", "total")}))
    tiles = [ln for ln in logs.lines if "in tiles of" in ln]
    require(len(tiles) == 1, "the FDAS search logged its tiles")
    db, tb = (int(v) for v in tiles[0].split("tiles of ")[1].split(" templates")[0]
              .split(" DM x "))
    ntemplates = int(root.find("fdas_search/fdot_trials").get("count"))
    calls = -(-len(dms) // db) * -(-ntemplates // tb) * (4 + 1)
    cells, k = db * tb, 128
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(7)
    idxs = torch.sort(torch.randint(0, 1 << 20, (cells, k), generator=gen), dim=1)[0].to(dev)
    snrs = (9.0 + torch.rand((cells, k), generator=gen)).to(dev)
    counts = torch.randint(0, k + 1, (cells,), generator=gen).to(dev)
    walk_ms = time_ms(lambda: cluster_peaks_device(idxs, snrs, counts, nbins=1 << 20))
    say(f"fdas: tiles of {db} DM x {tb} templates; the cluster walk "
        f"(cluster_peaks_device) {walk_ms:.3f} ms a call at ({cells}, {k}) cells x "
        f"slots (CUDA events), {calls} calls a run, ~{walk_ms * calls / 1e3:.3f} s; "
        f"the candidate loop and distils are search_host")
    return dict(run, top=top, walk_ms=walk_ms, walk_calls=calls, tiles=(db, tb))


def fdas_agreement_phase(tmp: str) -> int:
    """FdasSearch on the card against the CPU on tests/test_fdas.py's input:
    the same candidates at the recall standard (freq, DM, z, w and nh
    exact, S/N within 1e-3 relative, the same ranks); and on the card,
    template batches of 5 and 8 give the auto run's candidates field for
    field."""
    from peasoup_tpu_torch.pipeline.fdas import FdasConfig, FdasSearch

    path = os.path.join(tmp, "fdas_small.fil")
    fdas_small_fil(path)
    fil = read_filterbank(path)

    def cands(device, **kw):
        res = FdasSearch(FdasConfig(**FDAS_SMALL_CONFIG, **kw), device=device).run(fil)
        return [(c.freq, c.dm, c.z, c.w, c.nh, c.snr, c.acc, c.fdot) for c in res.candidates]

    gpu, cpu = cands("cuda"), cands("cpu")
    require(len(gpu) == len(cpu) > 0, "the same number of FDAS candidates, card and cpu")
    for a, b in zip(cpu, gpu):
        require(a[:5] == b[:5] and abs(a[5] - b[5]) <= 1e-3 * a[5],
                f"FDAS candidate agrees: cpu {a} vs cuda {b}")
    for tb in (5, 8):
        require(cands("cuda", template_block=tb) == gpu,
                f"--template_block {tb} gives the auto run's candidates on the card")
    say(f"fdas small input: top z {gpu[0][2]:g}, S/N {gpu[0][5]:.4f} (cuda) / "
        f"{cpu[0][5]:.4f} (cpu)")
    # the z = 0 row is an exact delta: measure how close cuFFT's round trip
    # comes to the time-domain search's S/N (XLA:CPU is bitwise there,
    # tests/test_fdas.py; torch's CPU FFT within 1e-6, test_torch_fdas.py)
    z0 = os.path.join(tmp, "fdas_z0.fil")
    fdas_small_fil(z0, z=0.0)
    fil = read_filterbank(z0)
    ftop = FdasSearch(FdasConfig(**FDAS_SMALL_CONFIG), device="cuda").run(fil).candidates[0]
    ttop = PeasoupSearch(SearchConfig(
        dm_start=50.0, dm_end=70.0, acc_start=-30.0, acc_end=30.0, acc_pulse_width=834.0,
        nharmonics=2, limit=20), device="cuda").run(fil).candidates[0]
    say(f"fdas z = 0 row on the card: top freq {ftop.freq!r} (time domain {ttop.freq!r}), "
        f"S/N {ftop.snr!r} (time domain {ttop.snr!r}, relative difference "
        f"{(ftop.snr - ttop.snr) / ttop.snr:.3e}), z {ftop.z:g}")
    return len(gpu)


def stream_phase(path: str, tmp: str, pulses: list) -> dict:
    """`peasoup-stream --replay` of the single-pulse grid's file: the three
    injected pulses among the triggers at their DM trial, within 2 + w/8
    samples of their start and one width step, with S/N within 15% of the
    matched filter; dedisperse and boxcar launched once a chunk, spchain
    never. Prints the chunk latency p50/p95 and the drops."""
    import contextlib
    import io

    from peasoup_tpu_torch.cli.stream import main

    outdir = os.path.join(tmp, "stream")
    kernels.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(["--replay", path, "-o", outdir, *STREAM_FLAGS, "-v"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(rc == 0, "peasoup-stream exit code 0")
    drained, timer_line = out.getvalue().strip().splitlines()[-2:]
    say(drained)
    m = re.match(r"Stream drained: (\d+) chunks, (\d+) triggers -> .* \(latency p50 "
                 r"([\d.]+) ms, p95 ([\d.]+) ms vs SLO .*; (\d+) dropped blocks, "
                 r"(\d+) gap samples\)", drained)
    require(m is not None, "peasoup-stream -v printed its chunks, latency and drops")
    n = int(m.group(1))
    stats = dict(chunks=n, triggers=int(m.group(2)), p50_ms=float(m.group(3)),
                 p95_ms=float(m.group(4)), drops=dict(blocks=int(m.group(5)),
                                                       gap_samples=int(m.group(6))),
                 timers=json.loads(timer_line.split(": ", 1)[1]))
    launches = dict(kernels.launches)
    shapes = {k: v.copy() for k, v in kernels.launch_shapes.items()}
    for name in STREAM_KERNELS:
        require(launches[name] == n, f"{name} launched once a chunk ({launches[name]} "
                                     f"launches, {n} chunks)")
    require(launches["spchain"] == 0, "spchain not launched by the stream")
    with open(os.path.join(outdir, "triggers.jsonl")) as f:
        trig = [json.loads(ln) for ln in f]
    for p in pulses:
        hits = [t for t in trig if t["dm_idx"] == p["dm_idx"]
                and abs(t["sample"] - p["start"]) <= 2 + p["width"] / 8]
        require(len(hits) == 1, f"pulse {p['label']} among the triggers at its DM trial")
        t = hits[0]
        say(f"stream pulse {p['label']}: trigger at trial {t['dm_idx']}, sample "
            f"{t['sample']}, width {t['width']}, S/N {t['snr']} (matched filter "
            f"{p['snr']:.3f}, ratio {t['snr'] / p['snr']:.4f}), latency {t['latency_s']} s")
        require(abs(t["width_idx"] - np.log2(p["width"])) <= 1,
                f"pulse {p['label']} width within one step")
        require(abs(t["snr"] / p["snr"] - 1.0) <= 0.15,
                f"pulse {p['label']} S/N within 15% of the matched filter")
    say(f"stream: {n} chunks, {len(trig)} triggers, chunk latency p50 {stats['p50_ms']} "
        f"ms, p95 {stats['p95_ms']} ms, drops {json.dumps(stats['drops'])}, {wall:.3f} s "
        f"CLI wall; stage timers (s): {json.dumps(stats['timers'], sort_keys=True)}; "
        f"kernel launches: {json.dumps(launches)}")
    return dict(launches=launches, shapes=shapes, wall=wall, stats=stats)


def stream_kernel_phase(dev: torch.device, fil, shapes: dict) -> dict:
    """boxcar against its plain version at the stream's modal launch shape:
    the prefix sums of a full window (the first hold + chunk samples of
    every DM trial, normalised as the step does), bit for bit, and timed."""
    from peasoup_tpu_torch.ops.streaming import normalise_window, stream_geometry
    from peasoup_tpu_torch.stream import StreamConfig, StreamingSearch

    d, tpad, wext, nw = main_shape(shapes, "boxcar")
    cfg = StreamConfig(dm_end=250.0, min_snr=7.0, decimate=32)
    search = StreamingSearch(cfg, device=dev)
    plan = search.plan_for(fil)
    widths = search.widths_for()
    w = stream_geometry(widths, cfg.chunk_samples, cfg.decimate) + cfg.chunk_samples
    require((d, wext, nw) == (plan.ndm, width_extent(widths), len(widths))
            and plan_pad(w)[0] == tpad, "boxcar ran at the stream's window")
    n_in = w + plan.max_delay
    x = torch.from_numpy(np.ascontiguousarray(fil.data[:n_in])).to(dev)
    trials = dedisperse(x, plan.delay_samples(), plan.killmask, w,
                        scale=output_scale(fil.nbits, int(plan.killmask.sum())))
    norm = normalise_window(trials, torch.ones(w, dtype=torch.bool, device=dev))
    del x, trials
    args = (prefix_sum_padded(norm, tpad, wext), widths, width_scales(widths), w, tpad)
    csum_bytes, ops = sweep_work(d, w, tpad, tpad + wext, nw)
    del norm
    best, bw = boxcar_best(*args)
    ref = boxcar_best_plain(*args)
    torch.cuda.synchronize()
    require(bitwise_equal(best, ref[0]) and bitwise_equal(bw, ref[1]),
            "boxcar bitwise equal to its plain version at the stream's shape")
    err = max_abs_err(best, ref[0])
    del best, bw, ref
    return dict(
        boxcar_times(args),
        max_abs_err=err,
        plain_ms=time_ms(lambda: boxcar_best_plain(*args), reps=3),
        bound=bound(csum_bytes + d * tpad * 8, ops),
        shape=f"({d}, {tpad + wext}) f32, {nw} widths -> 2 x ({d}, {tpad})",
    )


def stream_agreement_phase(tmp: str) -> int:
    """StreamingSearch on the card against the CPU on tests/test_stream.py's
    input: the same triggers, (dm_idx, sample, width, members) exactly and
    S/N within 1e-4 relative, and the same drop and gap accounting."""
    from peasoup_tpu_torch.io.stream_source import ReplaySource
    from peasoup_tpu_torch.stream import StreamConfig, StreamingSearch

    path = os.path.join(tmp, "stream_small.fil")
    stream_small_fil(path)
    fil = read_filterbank(path)
    res = {
        device: StreamingSearch(
            StreamConfig(outdir=os.path.join(tmp, f"stream_small_{device}"),
                         **STREAM_SMALL_CONFIG), device=device,
        ).run(ReplaySource(fil, 256, rate=0.0))
        for device in ("cuda", "cpu")
    }
    gpu, cpu = res["cuda"], res["cpu"]
    require(len(cpu.candidates) >= 2, "the small stream yields both pulses")
    require(len(gpu.candidates) == len(cpu.candidates), "the same number of triggers")
    for a, b in zip(cpu.candidates, gpu.candidates):
        require((a.dm_idx, a.sample, a.width, a.members) == (b.dm_idx, b.sample, b.width,
                                                             b.members)
                and abs(a.snr - b.snr) <= 1e-4 * a.snr,
                f"trigger agrees: cpu {a} vs cuda {b}")
    require((gpu.n_chunks, gpu.n_events, gpu.drops) == (cpu.n_chunks, cpu.n_events,
                                                         cpu.drops),
            "the same chunks, events and drops")
    return len(gpu.candidates)


def odd_decimation_phase(tmp: str) -> int:
    """The batch single-pulse search at decimate 48, which spchain does not
    take: on the card the boxcar kernel and the torch dec-fold run (spchain
    does not), and the candidates are the CPU's, (dm_idx, sample,
    width_idx) exactly and S/N within 1e-4 relative."""
    path = os.path.join(tmp, "sp_odd.fil")
    idx, starts = sp_small_fil(path, nsamps=ODD_NSAMPS)
    fil = read_filterbank(path)
    cfg = SinglePulseConfig(dm_end=60.0, min_snr=7.0, n_widths=8, decimate=ODD_DEC)
    kernels.reset_launches()
    gpu = SinglePulseSearch(cfg, device="cuda").run(fil).candidates
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    cpu = SinglePulseSearch(cfg, device="cpu").run(fil).candidates
    require(launches["boxcar"] > 0 and launches["spchain"] == 0,
            f"decimate {ODD_DEC} ran boxcar, not spchain ({json.dumps(launches)})")
    require(len(gpu) == len(cpu) >= 2, "the same candidates, both pulses among them")
    for a, b in zip(cpu, gpu):
        require((a.dm_idx, a.sample, a.width_idx) == (b.dm_idx, b.sample, b.width_idx)
                and abs(a.snr - b.snr) <= 1e-4 * a.snr,
                f"decimate {ODD_DEC} candidate agrees: cpu {a} vs cuda {b}")
    for s in starts:
        require(any(c.dm_idx == idx and abs(c.sample - s) <= ODD_DEC for c in gpu),
                f"the pulse at sample {s} is found at DM trial {idx}")
    return len(gpu)


# --- the survey sift and candidate ranking (phases 23-24) --------------------

# phase 23's campaign: the big grid's and the tutorial grid's own outputs
# (the tutorial grid's three routes as three observations of one file)
SIFT_TUT_PERIOD_TOL = SIFT_BIG_PERIOD_TOL = 2e-3
SIFT_MIN_FOLDED_SNR = 6.0
# phase 24 and tests/test_torch_sift.py: card and CPU agree to these (the
# dereddening FFTs round differently, so folded S/N to 1e-3 relative;
# scores through those folds to 2e-3)
SIFT_SNR_RTOL, SIFT_SCORE_ATOL = 1e-3, 2e-3
# rank train on the card against the CPU from one seed
RANK_WEIGHT_ATOL = 1e-5
SIFT_P0 = 0.714519699726  # J0332+5434, tests/test_sift.py's P0
SIFT_PSR_P, SIFT_PSR_DM = 0.05, 20.0


def sift_seed_campaign(root: str, with_rfi: bool = False) -> str:
    """tests/test_sift.py:seed_campaign's database and filterbanks, written
    by the port: two 4,096-sample 8-bit observations (six with the RFI
    variant, one beam each) of noise, the known pulsar J0332+5434 at its
    fundamental in one and its 1/2 harmonic in the other, an unrelated
    candidate, a repeating single-pulse source (P = 0.5 s) across both,
    and with the RFI variant a comb in every beam. Returns the campaign
    directory."""
    from peasoup_tpu_torch.campaign.db import CandidateDB

    camp = os.path.join(root, "camp")
    os.makedirs(camp, exist_ok=True)
    nsamps, nchans, tsamp = 4096, 8, 0.000256
    rng = np.random.default_rng(0)
    prrat = 0.5
    with CandidateDB(os.path.join(camp, "candidates.sqlite")) as db:
        conn = db._conn
        for i in range(6 if with_rfi else 2):
            data = np.clip(np.rint(rng.normal(32.0, 4.0, size=(nsamps, nchans))),
                           0, 255).astype(np.uint8)
            hdr = SigprocHeader(source_name=f"OBS{i}", tsamp=tsamp, tstart=55000.0 + i * 0.01,
                                fch1=1400.0, foff=-16.0, nchans=nchans, nbits=8, nifs=1,
                                data_type=1, ibeam=i + 1)
            path = os.path.join(camp, f"obs{i}.fil")
            write_filterbank(path, Filterbank(header=hdr, data=data))
            conn.execute(
                "INSERT INTO observations (job_id, input, source_name, tstart, tsamp, nchans,"
                " nsamps, ingested_unix, beam, src_raj, src_dej) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (f"job{i}", path, f"OBS{i}", 55000.0 + i * 0.01, tsamp, nchans, nsamps, 0.0,
                 i + 1, 0.0, 0.0),
            )
        for job, dm, snr, period, nh in (("job0", 26.76, 12.0, SIFT_P0, 2),
                                         ("job1", 26.80, 9.0, SIFT_P0 / 2, 1),
                                         ("job1", 80.0, 8.0, 0.1234, 1)):
            conn.execute("INSERT INTO candidates (job_id, kind, dm, snr, period, acc, nh) "
                         "VALUES (?, 'periodicity', ?, ?, ?, 0.0, ?)",
                         (job, dm, snr, period, nh))
        if with_rfi:
            for i in range(6):
                conn.execute("INSERT INTO candidates (job_id, kind, dm, snr, period, acc, nh) "
                             "VALUES (?, 'periodicity', 5.0, 9.5, 0.02, 0.0, 1)", (f"job{i}",))
        for i, ks in enumerate([(1, 3, 7), (2, 5, 11)]):
            for k in ks:
                t = 0.05 + k * prrat
                conn.execute("INSERT INTO candidates (job_id, kind, dm, snr, time_s, sample, "
                             "width, members) VALUES (?, 'single_pulse', ?, 8.0, ?, ?, 4, 3)",
                             (f"job{i}", 40.0 + 0.1 * i, t, int(t / tsamp)))
        conn.commit()
    return camp


def sift_pulsar_campaign(root: str) -> str:
    """Two 16,384-sample, 16-channel 8-bit observations holding a P = 50 ms
    pulsar at DM 20 (the second listed at its 1/2 harmonic), with the
    candidates a search would list: the pulsar, a detection at zero DM,
    one at the wrong period and one unrelated. Returns the campaign
    directory."""
    from peasoup_tpu_torch.campaign.db import CandidateDB

    camp = os.path.join(root, "pcamp")
    os.makedirs(camp)
    nsamps, nchans, tsamp, fch1, foff = 1 << 14, 16, 0.000256, 1400.0, -16.0
    delays = np.rint(SIFT_PSR_DM * np.abs(delay_table(fch1, foff, nchans, tsamp))).astype(int)
    rng = np.random.default_rng(11)
    with CandidateDB(os.path.join(camp, "candidates.sqlite")) as db:
        conn = db._conn
        for i in range(2):
            data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
            t = np.arange(nsamps)[:, None] - delays[None, :]
            data += 12.0 * (((t * tsamp / SIFT_PSR_P) % 1.0) < 0.06)
            data = np.clip(np.rint(data), 0, 255).astype(np.uint8)
            hdr = SigprocHeader(source_name=f"PSR{i}", tsamp=tsamp, tstart=55000.0 + i,
                                fch1=fch1, foff=foff, nchans=nchans, nbits=8, nifs=1,
                                data_type=1, ibeam=i + 1)
            path = os.path.join(camp, f"p{i}.fil")
            write_filterbank(path, Filterbank(header=hdr, data=data))
            conn.execute(
                "INSERT INTO observations (job_id, input, source_name, tstart, tsamp, nchans,"
                " nsamps, ingested_unix, beam, src_raj, src_dej) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (f"pjob{i}", path, f"PSR{i}", 55000.0 + i, tsamp, nchans, nsamps, 0.0,
                 i + 1, 0.0, 0.0),
            )
        for job, dm, snr, period, acc in (
            ("pjob0", SIFT_PSR_DM, 15.0, SIFT_PSR_P, 0.0), ("pjob0", 0.0, 8.0, SIFT_PSR_P, 0.0),
            ("pjob0", SIFT_PSR_DM, 7.0, 0.0377, 1.5),
            ("pjob1", SIFT_PSR_DM + 0.3, 14.0, SIFT_PSR_P / 2, 0.0),
            ("pjob1", 35.0, 6.5, 0.2, -2.0),
        ):
            conn.execute("INSERT INTO candidates (job_id, kind, dm, snr, period, acc, nh) "
                         "VALUES (?, 'periodicity', ?, ?, ?, ?, 1)", (job, dm, snr, period, acc))
        conn.commit()
    return camp


def sift_catalogue(camp: str) -> list[dict]:
    """The sifted catalogue of a campaign, fold stamps parsed."""
    from peasoup_tpu_torch.campaign.db import CandidateDB

    with CandidateDB(os.path.join(camp, "candidates.sqlite")) as db:
        rows = db.sift_catalogue()
    for r in rows:
        r["fold"] = json.loads(r.pop("fold_json") or "null")
    return rows


def run_cli(main, argv: list) -> tuple[int, str]:
    """``main(argv)`` with its standard output captured (and echoed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        say("  | " + line)
    return rc, out


def sift_campaign_phase(tmp: str, dev: torch.device) -> dict:
    """Phase 23: a campaign of this run's own outputs on the card. The big
    grid's and the tutorial grid's three routes' output directories are
    ingested (four observations) into a fresh database with the port's
    CandidateDB; `cli.sift run` sifts it with the default SiftConfig (fold
    batch 64, 64 bins x 16 subints, up to 256 folded per observation,
    scoring on), re-dedispersing each observation with the dedisperse
    kernel; then `cli.sift report` and `cli.rank score`. Returns the
    dedisperse kernel's check at the sift's big-grid launch shape."""
    from peasoup_tpu_torch.campaign.db import CandidateDB
    from peasoup_tpu_torch.cli.rank import main as rank_main
    from peasoup_tpu_torch.cli.sift import main as sift_main
    from peasoup_tpu_torch.rank.model import SCORE_TIER1, SCORE_TIER2, RankModel
    from peasoup_tpu_torch.sift.service import SiftConfig

    camp = os.path.join(tmp, "campaign")
    big, tut = os.path.join(tmp, "big.fil"), os.path.join(tmp, "tut.fil")
    jobs = [("big", os.path.join(tmp, "big_grid"), big)] + [
        (f"tut{i}", os.path.join(tmp, label.split(", ")[-1].replace(" ", "_")), tut)
        for i, (label, *_) in enumerate(TUT_RUNS)
    ]
    with CandidateDB(os.path.join(camp, "candidates.sqlite")) as db:
        for job, outdir, path in jobs:
            say(f"ingested {job} ({outdir}): {db.ingest_job(job, outdir, path)}")
    cfg = SiftConfig()
    say(f"sift config: fold batch {cfg.fold_batch}, {cfg.fold_nbins} bins x "
        f"{cfg.fold_nints} subints, up to {cfg.max_fold_per_obs} folded an observation, "
        f"scoring {cfg.score}")

    kernels.reset_launches()
    t0 = time.perf_counter()
    rc, out = run_cli(sift_main, ["run", "-w", camp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    shapes = {str(s): n for s, n in kernels.launch_shapes["dedisperse"].items()}
    require(rc == 0, "cli.sift run exit code 0")
    say(f"sift run: {wall:.3f} s wall; kernel launches {json.dumps(launches)}")
    say(f"sift dedisperse launch shapes (T, C, DM trials, out samples): {json.dumps(shapes)}")
    require(launches["dedisperse"] > 0, "the sift re-dedispersed with the dedisperse kernel")
    timers = json.loads(re.search(r"peasoup-sift timers \(s\): (.*)", out).group(1))
    buckets = json.loads(re.search(r"peasoup-sift fold buckets: (.*)", out).group(1))
    say(f"sift stage timers (s): {json.dumps(timers, sort_keys=True)}")
    for name, bs in buckets.items():
        say(f"sift fold buckets ({name}): " + ", ".join(
            f"2^{int(b['size']).bit_length() - 1} samples: {b['candidates']} candidates "
            f"at batch {b['batch']}" for b in bs))
    require(any(b["size"] == 1 << 21 for b in buckets["survey"]),
            "the survey fold folded a 2^21-sample bucket")

    cat = sift_catalogue(camp)
    fp = RankModel.from_file().fingerprint
    for r in cat[:8]:
        say("  catalogue " + ", ".join(f"{k} {r[k]}" for k in (
            "label", "tier", "period", "dm", "snr", "folded_snr", "n_obs", "members",
            "known_source", "score", "score_tier")))
    # the tutorial pulsar's strongest row: its detections in the three
    # routes merged into one row
    tut_rows = sorted((r for r in cat if abs(r["period"] - TUT_PERIOD) / TUT_PERIOD
                       < SIFT_TUT_PERIOD_TOL), key=lambda r: -r["snr"])
    require(len(tut_rows) >= 1 and tut_rows[0]["n_obs"] == 3
            and (tut_rows[0]["folded_snr"] or 0) >= SIFT_MIN_FOLDED_SNR,
            f"the tutorial pulsar is one catalogue row over 3 observations, folded S/N "
            f">= {SIFT_MIN_FOLDED_SNR}")
    say(f"catalogue rows within {SIFT_TUT_PERIOD_TOL} of the tutorial pulsar's period: "
        f"{len(tut_rows)}, n_obs {[r['n_obs'] for r in tut_rows]}")
    big_rows = [r for r in cat if abs(r["period"] - PERIOD) / PERIOD < SIFT_BIG_PERIOD_TOL
                and (r["folded_snr"] or 0) >= SIFT_MIN_FOLDED_SNR]
    require(len(big_rows) >= 1, f"the big grid's pulsar has a catalogue row folded to S/N "
            f">= {SIFT_MIN_FOLDED_SNR}")
    scored = [r for r in cat if r["score"] is not None]
    require(len(scored) > 0 and all(r["score_tier"] in (1, 2, 3) and r["model_fp"] == fp
                                    for r in scored),
            "every scored row has a tier and the shipped model's fingerprint")
    say(f"sift catalogue: {len(cat)} rows, {len(scored)} scored; tutorial pulsar folded S/N "
        f"{tut_rows[0]['folded_snr']!r}, score {tut_rows[0]['score']!r}; big grid pulsar "
        f"folded S/N {big_rows[0]['folded_snr']!r}, score {big_rows[0]['score']!r}")

    rc, _ = run_cli(sift_main, ["report", "-w", camp])
    require(rc == 0 and os.path.getsize(os.path.join(camp, "sift", "report.html")) > 1000,
            "cli.sift report wrote the report")
    # rank score recomputes from the fold stamps as stored (3 decimals):
    # the sift's scores to SIFT_SCORE_ATOL, and its tiers where a score is
    # that far clear of a tier's threshold
    rc, _ = run_cli(rank_main, ["score", "-w", camp])
    require(rc == 0, "cli.rank score exit code 0")
    after = {r["id"]: r for r in sift_catalogue(camp)}
    worst = 0.0
    for r in scored:
        a = after[r["id"]]
        near = min(abs(r["score"] - t) for t in (SCORE_TIER1, SCORE_TIER2)) <= SIFT_SCORE_ATOL
        require(a["model_fp"] == fp and abs(a["score"] - r["score"]) <= SIFT_SCORE_ATOL
                and (near or a["score_tier"] == r["score_tier"]),
                f"rank score rewrote the sift's score: {r['score']} (tier {r['score_tier']})"
                f" -> {a['score']} (tier {a['score_tier']})")
        worst = max(worst, abs(a["score"] - r["score"]))
    say(f"rank score: {len(scored)} rows re-scored from the stored stamps, the sift's "
        f"scores to {worst!r} (bound {SIFT_SCORE_ATOL})")

    # the dedisperse kernel at the sift's big-grid launch: the distinct DMs
    # of the big grid's top candidates, with the sift's own delays
    with CandidateDB(os.path.join(camp, "candidates.sqlite")) as db:
        rows = [c for c in db.all_candidates("periodicity") if c["job_id"] == "big"]
    rows = sorted(rows, key=lambda c: -float(c["snr"] or 0.0))[: cfg.max_fold_per_obs]
    fil = read_filterbank(big)
    hdr = fil.header
    dms = sorted({float(c["dm"]) for c in rows})
    per_unit = np.abs(delay_table(hdr.fch1, hdr.foff, hdr.nchans, hdr.tsamp))
    delays = np.rint((np.asarray(dms, dtype=np.float32)[:, None] * per_unit[None, :])
                     .astype(np.float32)).astype(np.int32)
    out_n = fil.nsamps - int(delays.max())
    x = fil_to_device(fil, dev)
    _, c = dedisperse_check(x, hdr.nbits, delays, np.ones(hdr.nchans, dtype=np.float32), out_n)
    require(str((x.shape[0], hdr.nchans, len(dms), out_n)) in shapes,
            "the checked shape is one the sift launched")
    del x, fil
    say(f"dedisperse (sift, big grid): {c['shape']}: {c['ms']:.4f} ms kernel, "
        f"{c['plain_ms']:.4f} ms plain, bound {c['bound'][0]:.4f} ms ({c['bound'][1]}), "
        f"max |err| {c['max_abs_err']}")
    return dict(c, path="sift, big grid")


def _same_sift(gpu: list, cpu: list, what: str) -> None:
    """The card's sifted catalogue against the CPU's: labels, tiers, known
    sources, harmonics, n_obs, members, job ids and score tiers exactly,
    folded S/N and period to SIFT_SNR_RTOL, scores to SIFT_SCORE_ATOL."""
    require(len(gpu) == len(cpu), f"{what}: the same catalogue length")
    for g, c in zip(gpu, cpu):
        exact = ("kind", "label", "tier", "dm", "snr", "known_source", "harmonic", "n_obs",
                 "members", "job_ids", "score_tier", "model_fp")
        require({k: g[k] for k in exact} == {k: c[k] for k in exact},
                f"{what}: catalogue row agrees exactly: cuda {g} vs cpu {c}")
        for k in ("folded_snr", "period", "opt_period"):
            require((g[k] is None) == (c[k] is None) and (
                c[k] is None or abs(g[k] - c[k]) <= SIFT_SNR_RTOL * abs(c[k]) + 1e-6),
                f"{what}: {k} {g[k]} vs {c[k]}")
        require((g["score"] is None) == (c["score"] is None) and (
            c["score"] is None or abs(g["score"] - c["score"]) <= SIFT_SCORE_ATOL),
            f"{what}: score {g['score']} vs {c['score']}")


def sift_agreement_phase(tmp: str) -> dict:
    """Phase 24: the sift on the card against the CPU at a small size, on
    tests/test_sift.py:seed_campaign's recipe (and its six-beam RFI
    variant, vetoed with the fold off) and on a pulsar campaign; the
    survey folder bitwise the per-observation folder on the card; and
    `rank train` on the card against the CPU from one seed, each model
    passing the ROC gate (`rank eval`)."""
    import shutil

    from peasoup_tpu_torch.campaign.db import CandidateDB
    from peasoup_tpu_torch.cli.rank import main as rank_main
    from peasoup_tpu_torch.core.candidates import Candidate
    from peasoup_tpu_torch.pipeline.folder import MultiFolder
    from peasoup_tpu_torch.sift.fold import SurveyFolder
    from peasoup_tpu_torch.sift.service import SiftConfig, SiftRun

    out = {}
    for label, make, kw in (
        ("seed", lambda d: sift_seed_campaign(d), dict(fold_batch=8, sp_min_pulses=4)),
        ("seed, RFI, no fold", lambda d: sift_seed_campaign(d, with_rfi=True),
         dict(fold=False, sp_min_pulses=4)),
        ("seed, RFI", lambda d: sift_seed_campaign(d, with_rfi=True),
         dict(fold_batch=8, sp_min_pulses=4)),
        ("pulsar", sift_pulsar_campaign, dict(fold_batch=4)),
    ):
        root = os.path.join(tmp, "sift_small_" + label.replace(", ", "_").replace(" ", "_"))
        camp = make(root)
        shutil.copytree(camp, camp + "_cpu")
        res = {}
        for device, d in (("cuda", camp), ("cpu", camp + "_cpu")):
            summary = SiftRun(SiftConfig(workdir=d, **kw), device=device).run()
            with CandidateDB(os.path.join(d, "candidates.sqlite")) as db:
                res[device] = (sift_catalogue(d), [
                    {k: m[k] for k in m if k not in ("id", "run_id")}
                    for m in db.sift_known_matches()
                ], [{k: s[k] for k in s if k not in ("id", "run_id")}
                    for s in db.sift_sp_sources()], summary)
        (gcat, gknown, gsp, gsum), (ccat, cknown, csp, csum) = res["cuda"], res["cpu"]
        _same_sift(gcat, ccat, label)
        require(gknown == cknown and gsp == csp, f"{label}: the same known matches and "
                "repeat sources")
        for k in ("n_folded", "n_catalogue", "n_known", "n_rfi", "n_sp_sources"):
            require(gsum[k] == csum[k], f"{label}: {k} {gsum[k]} vs {csum[k]}")
        say(f"sift {label}: {gsum['n_catalogue']} catalogue rows ({gsum['n_known']} known, "
            f"{gsum['n_rfi']} rfi), {gsum['n_sp_sources']} repeat sources, "
            f"{gsum['n_folded']} folded: the card's are the CPU's")
        out[label] = gsum
    require(out["seed"]["n_known"] == 1 and out["seed"]["n_sp_sources"] == 1
            and out["seed, RFI, no fold"]["n_rfi"] == 1,
            "the known pulsar, the repeating source and the RFI comb are found")

    # the survey folder bitwise the per-observation folder on the card
    camp = os.path.join(tmp, "sift_small_pulsar", "pcamp")
    run = SiftRun(SiftConfig(workdir=camp), device="cuda")
    with CandidateDB(os.path.join(camp, "candidates.sqlite")) as db:
        inputs = run.build_fold_inputs(db.observations(), db.all_candidates("periodicity"))
    for fi in inputs:  # MultiFolder takes 1/freq: compare on that period
        for c in fi.cands:
            c.period = 1.0 / (1.0 / c.period)
    n = 0
    for batch in (4, 64):
        got = {o["key"]: o for o in SurveyFolder(batch=batch).fold_outcomes(inputs)}
        for fi in inputs:
            cands = [Candidate(dm_idx=c.dm_row, acc=c.acc, snr=9.0, freq=1.0 / c.period)
                     for c in fi.cands]
            for w in MultiFolder(fi.trials, fi.tsamp).fold_outcomes(cands, len(cands)):
                g = got[fi.cands[w["cand_idx"]].key]
                require(g["opt_sn"] == w["opt_sn"] and g["opt_period"] == w["opt_period"]
                        and np.array_equal(g["opt_fold"], w["opt_fold"]),
                        f"the survey folder (batch {batch}) is MultiFolder bit for bit")
                n += 1
    say(f"survey folder against MultiFolder on the card: {n} outcomes bit for bit")

    # rank train on the card and on the CPU from one seed; the ROC gate on each
    docs = {}
    for device in ("cuda", "cpu"):
        path = os.path.join(tmp, f"rank_model_{device}.json")
        rc, _ = run_cli(rank_main, ["train", "-o", path, "--seed", "42", "--device", device])
        require(rc == 0, f"rank train on {device}")
        rc, _ = run_cli(rank_main, ["eval", "--model", path, "--device", device])
        require(rc == 0, f"the {device} model passes the ROC gate")
        with open(path) as f:
            docs[device] = json.load(f)
    dw = max(float(np.abs(np.asarray(docs["cuda"][k]) - np.asarray(docs["cpu"][k])).max())
             for k in ("w1", "b1", "w2", "b2"))
    require(dw <= RANK_WEIGHT_ATOL, f"trained weights agree within {RANK_WEIGHT_ATOL}: {dw}")
    say(f"rank train: card and CPU weights agree to {dw!r} (bound {RANK_WEIGHT_ATOL})")
    return out


# --- the split runs: DM trials over shards of one card and over processes
# (phases 25-27) --------------------------------------------------------------

# the shards of phase 25: two on the one card, the smallest mesh that splits
NSHARDS = 2
# each worker process of phases 26-27 may take this long, start included
WORKER_TIMEOUT_S = 300.0
# phase 26's FDAS processes: DM tiles of this height (the CLI's --dm_block),
# so two processes' tiles fit the card together (phase 19 alone: 9)
FDAS_SPLIT_DM_BLOCK = 4


def write_periodicity(result, outdir: str) -> dict:
    """A library run's candidates through the CLI's writers
    (candidates.peasoup and overview.xml's candidates), for a comparison
    with a CLI run's files."""
    from peasoup_tpu_torch.io.output import CandidateFileWriter, OutputFileWriter

    writer = CandidateFileWriter(outdir)
    writer.write_binary(result.candidates, "candidates.peasoup")
    stats = OutputFileWriter()
    stats.add_candidates(result.candidates, writer.byte_mapping)
    stats.to_file(os.path.join(outdir, "overview.xml"))
    return dict(outdir=outdir, root=ET.parse(os.path.join(outdir, "overview.xml")).getroot())


def compare_periodicity(got: dict, base_outdir: str, what: str) -> bool:
    """``got``'s candidates against a CLI run's (its output directory):
    True where they are the same field for field (overview.xml's fields
    and candidates.peasoup's bytes); else they must hold the recall
    standard (the same candidates rank by rank, period, DM, accel and nh
    as written, S/N and folded S/N within 1e-3 relative). Prints which."""
    base_root = ET.parse(os.path.join(base_outdir, "overview.xml")).getroot()
    want, have = xml_candidates(base_root), xml_candidates(got["root"])
    files = [open(os.path.join(d, "candidates.peasoup"), "rb").read()
             for d in (base_outdir, got["outdir"])]
    bitwise = want == have and files[0] == files[1]
    if not bitwise:
        require(len(have) == len(want) > 0, f"{what}: {len(have)} candidates, {len(want)} "
                "in the single run")
        for rank, (a, b) in enumerate(zip(want, have)):
            require(all(a[k] == b[k] for k in ("period", "dm", "acc", "nh")),
                    f"{what}: rank {rank} is the single run's candidate")
            for k in ("snr", "folded_snr"):
                ref = float(a[k])
                require(abs(float(b[k]) - ref) <= 1e-3 * max(abs(ref), 1e-30),
                        f"{what}: rank {rank} {k} {b[k]} within 1e-3 of {a[k]}")
    say(f"{what}: {len(have)} candidates, "
        + ("bitwise the single run's (overview.xml fields and candidates.peasoup bytes)"
           if bitwise else "NOT bitwise the single run's; the recall standard holds"))
    return bitwise


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_processes(argvs: list[list[str]]) -> list[dict]:
    """One ``chip_smoke.py --worker`` process per argv, joined into one
    process group through the JAX package's variables (a free port on
    localhost); each must exit 0 within WORKER_TIMEOUT_S. Returns each
    process's "worker:" record."""
    port = free_port()
    procs = []
    for rank, argv in enumerate(argvs):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(len(argvs)), JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", *argv], env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        require(False, f"{len(argvs)} worker processes within {WORKER_TIMEOUT_S} s")
    records = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            for line in out.splitlines()[-30:]:
                say(f"  process {rank} | {line}")
        require(p.returncode == 0, f"worker process {rank} exit code 0 (got {p.returncode})")
        lines = [ln for ln in out.splitlines() if ln.startswith("worker: ")]
        require(len(lines) == 1, f"worker process {rank} printed its record")
        records.append(json.loads(lines[0][len("worker: "):]))
    return records


def worker(argv: list[str]) -> int:
    """One process of phases 26-27 (``chip_smoke.py --worker ...``, started
    by :func:`launch_processes`): ``cli NAME ARGS...`` runs the port's CLI
    ``peasoup_tpu_torch.cli.NAME`` in this process; ``fold CAMPAIGN OUT``
    the survey fold of phase 23's campaign through run_survey_fold,
    pickling the merged outcomes to OUT. Prints one line, "worker: " and
    the JSON of its rank, exit code, kernel launches and launch shapes."""
    import importlib
    import pickle

    from peasoup_tpu_torch.parallel import multihost

    kernels.reset_launches()
    if argv[0] == "cli":
        rc = importlib.import_module(f"peasoup_tpu_torch.cli.{argv[1]}").main(argv[2:])
    elif argv[0] == "fold":
        outcomes = multihost.run_survey_fold(*survey_fold_inputs(argv[1]))
        with open(argv[2], "wb") as f:
            pickle.dump(fold_rows(outcomes), f)
        rc = 0
    else:
        raise SystemExit(f"unknown worker {argv[0]}")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    say("worker: " + json.dumps(dict(
        rank=multihost.process_index(), nproc=multihost.process_count(), rc=rc,
        launches=dict(kernels.launches),
        shapes={k: [[list(s), n] for s, n in v.items()]
                for k, v in kernels.launch_shapes.items() if v},
    )))
    return rc


def survey_fold_inputs(camp: str):
    """Phase 23's survey fold: its fold inputs (every observation of the
    campaign re-dedispersed on the card at its candidates' DMs, as
    SiftRun.run builds them) and its folder (the default SiftConfig's)."""
    from peasoup_tpu_torch.campaign.db import CandidateDB
    from peasoup_tpu_torch.sift.fold import SurveyFolder
    from peasoup_tpu_torch.sift.service import SiftConfig, SiftRun

    cfg = SiftConfig(workdir=camp)
    with CandidateDB(os.path.join(camp, "candidates.sqlite")) as db:
        obs_rows, cands = db.observations(), db.all_candidates("periodicity")
    inputs = SiftRun(cfg, device="cuda").build_fold_inputs(obs_rows, cands)
    return inputs, SurveyFolder(nbins=cfg.fold_nbins, nints=cfg.fold_nints,
                                batch=cfg.fold_batch)


def fold_rows(outcomes: list[dict]) -> list[tuple]:
    """Fold outcomes as sortable host rows: key, optimised S/N and period,
    and the optimised fold's bytes."""
    return sorted((o["key"], o["opt_sn"], o["opt_period"],
                   np.asarray(o["opt_fold"]).tobytes()) for o in outcomes)


def split_phase(tmp: str, dev: torch.device, paths: dict, runs: dict) -> dict:
    """Phase 25: the in-process split on the card. PeasoupSearch with
    devices=[cuda:0] * 2 on the big grid and the binary grid (--npdmp 10:
    the folder reads each shard's trials), and SinglePulseSearch likewise
    on the single-pulse grid: dedisperse launches once a shard, at the
    shard's trials (39 of the 77, the second shard with one padding row),
    every kernel of the path runs, and the candidates are the single
    runs' (phases 3, 4 and 6): bitwise, or at the recall standard, which
    is printed; the single-pulse search finds the three pulses at phase 6's
    standard."""
    from peasoup_tpu_torch.io.output import write_singlepulse

    devices = [dev] * NSHARDS
    out = {}
    for label, cfg, path, base in (
        ("big grid", GRID_CONFIG, paths["big"], os.path.join(tmp, "big_grid")),
        ("binary grid", BINARY_CONFIG, paths["binary"], os.path.join(tmp, "binary_grid")),
    ):
        fil = read_filterbank(path)
        search = PeasoupSearch(cfg, devices=devices)
        kernels.reset_launches()
        native.calls.clear()
        t0 = time.perf_counter()
        res = search.run(fil)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        shapes = {str(s): n for s, n in kernels.launch_shapes["dedisperse"].items()}
        say(f"{label}, {NSHARDS} shards on one card: {wall:.3f} s wall; kernel launches "
            f"{json.dumps(launches)}; dedisperse launch shapes {json.dumps(shapes)}; "
            f"stage timers (s) {json.dumps(res.timers, sort_keys=True)}")
        for name in PEASOUP_KERNELS:
            require(launches[name] > 0, f"{label}, shards: kernel {name} launched")
        ndm = len(res.dm_list)
        per = -(-ndm // NSHARDS)
        require(launches["dedisperse"] == NSHARDS and all(
            s[2] == per for s in kernels.launch_shapes["dedisperse"]),
            f"{label}, shards: dedisperse launched once a shard at {per} trials")
        got = write_periodicity(res, os.path.join(tmp, f"shards_{label.replace(' ', '_')}"))
        out[label] = dict(bitwise=compare_periodicity(got, base, f"{label}, {NSHARDS} shards"),
                          launches=launches, shapes=shapes, wall=wall)
        del fil, search, res
        torch.cuda.empty_cache()

    label = "single-pulse grid"
    fil = read_filterbank(paths["sp"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = SinglePulseSearch(SP_CONFIG, devices=devices).run(fil)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    shapes = {str(s): n for s, n in kernels.launch_shapes["dedisperse"].items()}
    say(f"{label}, {NSHARDS} shards on one card: {wall:.3f} s wall; kernel launches "
        f"{json.dumps(launches)}; dedisperse launch shapes {json.dumps(shapes)}")
    for name in SP_KERNELS:
        require(launches[name] > 0, f"{label}, shards: kernel {name} launched")
    require(launches["dedisperse"] == NSHARDS,
            f"{label}, shards: dedisperse launched once a shard")
    sp_file = os.path.join(tmp, "shards_single_pulse.txt")
    write_singlepulse(sp_file, res.candidates)
    with open(sp_file, "rb") as f, open(os.path.join(
            tmp, "single_pulse_grid", "candidates.singlepulse"), "rb") as g:
        bitwise = f.read() == g.read()
    base = [{k: float(e.find(k).text) for k in SP_FIELDS} for e in runs[label]["root"]
            .findall("single_pulse_search/candidates/candidate")]
    have = [{k: float(getattr(c, k)) for k in SP_FIELDS} for c in res.candidates]
    if not bitwise:
        require(len(have) == len(base) and all(
            all(a[k] == b[k] for k in SP_FIELDS if k != "snr")
            and abs(b["snr"] - a["snr"]) <= 1e-3 * a["snr"] for a, b in zip(base, have)),
            f"{label}, shards: the single run's candidates at the recall standard")
    say(f"{label}, {NSHARDS} shards: {len(have)} candidates, " + (
        "bitwise the single run's (candidates.singlepulse bytes)" if bitwise
        else "NOT bitwise the single run's; the recall standard holds"))
    check_sp_pulses(have[:3], runs[label]["pulses"])
    out[label] = dict(bitwise=bitwise, launches=launches, shapes=shapes, wall=wall)
    return out


def process_phase(tmp: str, paths: dict, runs: dict) -> dict:
    """Phase 26: two processes share the card. `peasoup` on the binary grid
    (--npdmp 10), `spsearch` on the single-pulse grid and `peasoup-fdas` on
    the FDAS grid, each launched twice with JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES=2 and JAX_PROCESS_ID=0/1 and --hbm_bytes at half the
    card's free memory (FDAS, which has no such flag, with DM tiles of
    FDAS_SPLIT_DM_BLOCK). Each process dedisperses its DM slice in one
    launch (39 and 38 of the 77 trials; 90 and 89 of the 179); only rank 0
    writes; the candidates are phases 4's and 6's (bitwise, or at the
    recall standard, printed) and phase 19's top candidate; the pulse at
    the slice boundary clusters once."""
    torch.cuda.empty_cache()
    hbm = torch.cuda.mem_get_info()[0] // 2
    out = {}
    for label, cli, path, flags, base, files in (
        ("binary grid", "peasoup", paths["binary"], BINARY_FLAGS,
         os.path.join(tmp, "binary_grid"), ("candidates.peasoup", "overview.xml")),
        ("single-pulse grid", "spsearch", paths["sp"], SP_FLAGS,
         os.path.join(tmp, "single_pulse_grid"), ("candidates.singlepulse", "overview.xml")),
        ("fdas grid", "fdas", paths["fdas"], FDAS_FLAGS, None,
         ("candidates.peasoup", "candidates.fdas", "overview.xml")),
    ):
        outdir = os.path.join(tmp, f"procs_{cli}")
        extra = (["--dm_block", str(FDAS_SPLIT_DM_BLOCK)] if cli == "fdas"
                 else ["--hbm_bytes", str(hbm)])
        t0 = time.perf_counter()
        recs = launch_processes([
            ["cli", cli, "-i", path, "-o", f"{outdir}.rank{r}", *flags, *extra]
            for r in range(2)])
        wall = time.perf_counter() - t0
        for r, rec in enumerate(recs):
            say(f"{label}, process {rec['rank']} of {rec['nproc']}: dedisperse launch shapes "
                f"(T, C, DM trials, out samples; launches) "
                f"{json.dumps(rec['shapes'].get('dedisperse'))}; "
                f"kernel launches {json.dumps(rec['launches'])}")
            require(rec["rank"] == r and rec["nproc"] == 2 and rec["rc"] == 0,
                    f"{label}: process {r} of 2 ran")
        ndm = len(ET.parse(os.path.join(f"{outdir}.rank0", "overview.xml")).getroot()
                  .findall("dedispersion_trials/trial"))
        for r, rec in enumerate(recs):
            lo, hi = dm_slice_for_process(ndm, 2, r)
            trials = [shape[2] for shape, _ in rec["shapes"]["dedisperse"]]
            require(rec["launches"]["dedisperse"] == 1 and trials == [hi - lo],
                    f"{label}: process {r} dedispersed its {hi - lo} trials in one launch")
        for name in files:
            require(os.path.getsize(os.path.join(f"{outdir}.rank0", name)) > 0,
                    f"{label}: rank 0 wrote {name}")
        # beside rank 0's outputs, every process writes its manifest shard
        # (telemetry.procN.json) and rank 1 nothing else
        require(sorted(os.listdir(f"{outdir}.rank1")) == ["telemetry.proc1.json"],
                f"{label}: rank 1 wrote its manifest shard and nothing else")
        for r in range(2):
            man = _manifest(os.path.join(f"{outdir}.rank{r}", f"telemetry.proc{r}.json"))
            require((man["process_index"], man["process_count"]) == (r, 2),
                    f"{label}: process {r}'s manifest shard names its rank")
        require(_manifest(os.path.join(f"{outdir}.rank0", "telemetry.json"))
                ["process_index"] == 0, f"{label}: rank 0 wrote the manifest")
        rec = dict(wall=wall, shapes=[r["shapes"]["dedisperse"] for r in recs])
        root = ET.parse(os.path.join(f"{outdir}.rank0", "overview.xml")).getroot()
        if cli == "peasoup":
            rec["bitwise"] = compare_periodicity(
                dict(outdir=f"{outdir}.rank0", root=root), base, f"{label}, 2 processes")
        elif cli == "spsearch":
            with open(os.path.join(f"{outdir}.rank0", files[0]), "rb") as f, \
                    open(os.path.join(base, files[0]), "rb") as g:
                rec["bitwise"] = f.read() == g.read()
            fields = (*SP_FIELDS, "dm_idx_lo", "dm_idx_hi")
            have = [{k: float(e.find(k).text) for k in fields}
                    for e in root.findall("single_pulse_search/candidates/candidate")]
            want = [{k: float(e.find(k).text) for k in fields} for e in runs[label]["root"]
                    .findall("single_pulse_search/candidates/candidate")]
            if not rec["bitwise"]:
                require(len(have) == len(want) and all(
                    all(a[k] == b[k] for k in fields if k != "snr")
                    and abs(b["snr"] - a["snr"]) <= 1e-3 * a["snr"]
                    for a, b in zip(want, have)),
                    f"{label}, 2 processes: the single run's candidates at the recall "
                    "standard")
            say(f"{label}, 2 processes: {len(have)} candidates, " + (
                "bitwise the single run's (candidates.singlepulse bytes)" if rec["bitwise"]
                else "NOT bitwise the single run's; the recall standard holds"))
            check_sp_pulses([{k: c[k] for k in SP_FIELDS} for c in have[:3]],
                            runs[label]["pulses"])
            cut = dm_slice_for_process(ndm, 2, 1)[0]
            for p in runs[label]["pulses"]:
                near = [c for c in have if abs(c["sample"] - p["start"]) <= 2 + p["width"] / 8]
                require(len(near) == 1, f"pulse {p['label']} clusters once")
                c = near[0]
                say(f"{label}, 2 processes: pulse {p['label']} one candidate over DM trials "
                    f"{c['dm_idx_lo']:g}..{c['dm_idx_hi']:g}"
                    + (f", across the slice boundary at trial {cut}"
                       if c["dm_idx_lo"] < cut <= c["dm_idx_hi"] else ""))
        else:
            cands = root.findall("candidates/candidate")
            require(len(cands) > 0, f"{label}, 2 processes: candidates")
            top = {k: float(cands[0].find(k).text) for k in runs["fdas"]["top"]}
            want = runs["fdas"]["top"]
            same = top == want
            require(all(top[k] == want[k] for k in ("period", "dm", "acc", "nh", "z", "w"))
                    and abs(top["snr"] - want["snr"]) <= 1e-3 * want["snr"],
                    f"{label}, 2 processes: phase 19's top candidate {want} (got {top})")
            say(f"{label}, 2 processes: the top candidate is phase 19's, "
                + ("bitwise" if same else "at the recall standard (NOT bitwise)"))
            rec["bitwise_top"] = same
        say(f"{label}, 2 processes: {wall:.3f} s wall for both, start included")
        out[label] = rec
    return out


def survey_fold_phase(tmp: str) -> dict:
    """Phase 27: phase 23's survey fold in two processes sharing the card
    (run_survey_fold deals the observations round-robin): every process's
    merged outcomes are the single process's, bitwise."""
    import pickle

    from peasoup_tpu_torch.parallel.multihost import run_survey_fold

    camp = os.path.join(tmp, "campaign")
    inputs, folder = survey_fold_inputs(camp)
    want = fold_rows(run_survey_fold(inputs, folder))
    del inputs
    torch.cuda.empty_cache()
    outs = [os.path.join(tmp, f"fold.rank{r}.pkl") for r in range(2)]
    t0 = time.perf_counter()
    recs = launch_processes([["fold", camp, outs[r]] for r in range(2)])
    wall = time.perf_counter() - t0
    got = []
    for r, rec in enumerate(recs):
        with open(outs[r], "rb") as f:
            got.append(pickle.load(f))
        say(f"survey fold, process {r} of 2: kernel launches {json.dumps(rec['launches'])}")
    bitwise = got[0] == got[1] == want
    say(f"survey fold, 2 processes: {len(want)} outcomes over "
        f"{len({k for k, *_ in want})} candidates; "
        + ("every process's merged outcomes are bitwise the single process's"
           if bitwise else "NOT bitwise the single process's")
        + f"; {wall:.3f} s wall for both, start included")
    require(bitwise, "the two processes' merged fold outcomes are the single process's")
    return dict(bitwise=bitwise, wall=wall, outcomes=len(want))


def shard_shape_checks(dev: torch.device, paths: dict) -> list[dict]:
    """The dedisperse kernel at the launch shapes phases 25-26 add, bit for
    bit against its plain version, on the big grid's file and on the
    single-pulse grid's, each with its own search's plan: the first shard
    of 2 (also process 0 of 2), the second shard (its trials and one
    padding row, a copy of the last) and process 1 of 2."""
    out = []
    for grid, search, path in (
        ("big grid", PeasoupSearch(GRID_CONFIG, device=dev), paths["big"]),
        ("single-pulse grid", SinglePulseSearch(SP_CONFIG, device=dev), paths["sp"]),
    ):
        fil = read_filterbank(path)
        plan = search.build_dm_plan(fil)
        delays, kill = plan.delay_samples(), plan.killmask
        ndm = len(delays)
        per = -(-ndm // NSHARDS)
        padded = np.concatenate([delays, np.repeat(delays[-1:], per * NSHARDS - ndm, axis=0)])
        x = fil_to_device(fil, dev)
        for label, rows in (
            (f"shard 0 of {NSHARDS} and process 0 of 2", delays[:per]),
            (f"shard 1 of {NSHARDS} (one padding row)", padded[per:]),
            ("process 1 of 2", delays[dm_slice_for_process(ndm, 2, 1)[0]:]),
        ):
            _, c = dedisperse_check(x, fil.nbits, rows, kill, plan.out_nsamps)
            c["path"] = f"{grid}, {label}"
            say(f"dedisperse ({c['path']}): {c['shape']}: {c['ms']:.4f} ms kernel, "
                f"{c['plain_ms']:.4f} ms plain, bound {c['bound'][0]:.4f} ms "
                f"({c['bound'][1]}), max |err| {c['max_abs_err']}")
            out.append(other_shape(c))
        del x, fil
        torch.cuda.empty_cache()
    return out


# --- the tuning and measurement layer (phase 28) -----------------------------

# the planner's subband plan of the big grid's bucket: a 0.3 S/N loss
# admits 16 subbands under DM-scaled smear budgets (tests/test_torch_dedisp_plan.py)
TUNE_SUBBAND_LOSS = 0.3
TUNE_SUBBANDS = 16
# the tuner's probe on the big grid: 2^22 samples over 64 channels, and
# rows of 2^15 samples for the resample kernel (perf/tuning.py)
TUNE_PROBE_SAMPLES, TUNE_RESAMPLE_SAMPLES = 65_536, 32_768


class _Records(logging.Handler):
    """The messages one logger emits while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def tuned_entry(cache: str, pipeline: str, smi: str) -> dict:
    """The cache's one entry for ``pipeline`` on this card, printed: the
    fingerprint, knobs, tuning time and each trial (knob -> median)."""
    from peasoup_tpu_torch.perf import tuning

    fp = tuning.device_fingerprint(torch.device("cuda", 0))
    doc = tuning.load_cache(cache)
    tuning.validate_cache(doc)
    entries = {k: v for k, v in doc["devices"].get(fp, {}).items()
               if k.startswith(pipeline + "|")}
    require(len(entries) == 1, f"one {pipeline} entry under {fp} in the tuning cache")
    key, e = next(iter(entries.items()))
    say(f"tuning cache ({smi}): {fp} {key}: engine {e['engine']}, dedisp_block "
        f"{e['dedisp_block']}, dm_block {e['dm_block']}, accel_bucket {e['accel_bucket']}, "
        f"tuning_s {e['tuning_s']!r}, source {e['source']}")
    for t in e["trials"]:
        say(f"  trial {json.dumps(t['params'])} -> median {t['median_s']!r} s ({smi})")
    return e


def tuner_launches(run: dict) -> dict:
    """The launches a CLI run made at the tuner's probe shapes, by kernel and
    shape: dedisperse to (b, 65,536) from 64 channels, resample of (b,
    32,768) rows from one series. No grid of this script launches either
    at those shapes."""
    probe = {"dedisperse": lambda s: s[1] == NCHANS and s[3] == TUNE_PROBE_SAMPLES,
             "resample": lambda s: s[1] == 1 and s[2] == TUNE_RESAMPLE_SAMPLES}
    return {name: {str(s): n for s, n in sorted(run["shapes"][name].items()) if probe[name](s)}
            for name in probe}


def tuned_cli_run(main, argv, outdir, outputs, path_kernels):
    """cli_phase with the tuner's log captured: (record, measurements, log)."""
    from peasoup_tpu_torch.perf import tuning

    rec = _Records()
    lg = logging.getLogger("peasoup_tpu_torch.tuning")
    lg.addHandler(rec)
    level = lg.level
    lg.setLevel(logging.INFO)
    n0 = tuning.measurement_count()
    try:
        run = cli_phase(main, argv, outdir, outputs, path_kernels)
    finally:
        lg.removeHandler(rec)
        lg.setLevel(level)
    return run, tuning.measurement_count() - n0, rec.messages


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def tuning_phase(tmp: str, dev: torch.device, paths: dict, runs: dict, checks: dict,
                 smi: str) -> dict:
    """Phase 28 (a)-(e), the docstring's."""
    from peasoup_tpu_torch.cli.peasoup import main as ps_main
    from peasoup_tpu_torch.cli.spsearch import main as sp_main
    from peasoup_tpu_torch.ops.dedisperse import dedisperse_subband
    from peasoup_tpu_torch.perf import tuning
    from peasoup_tpu_torch.plan.dedisp_plan import dm_smear_budgets

    out = {}
    # (a), (b): peasoup --tune on the big grid, cold then warm
    cache = os.path.join(tmp, "tuning_cache.json")
    base_dir = os.path.join(tmp, "big_grid")
    for state in ("cold", "warm"):
        outdir = os.path.join(tmp, f"big_tuned_{state}")
        run, measured, log = tuned_cli_run(
            ps_main, ["-i", paths["big"], "-o", outdir, *GRID_FLAGS, "--tune",
                      "--tuning-cache", cache],
            outdir, ("candidates.peasoup", "overview.xml"), PEASOUP_KERNELS)
        entry = tuned_entry(cache, "search", smi)
        launches = tuner_launches(run)
        say(f"big grid --tune, {state}: {measured} measurements, {run['wall']:.3f} s CLI wall, "
            f"stage timers {json.dumps(run['timers'], sort_keys=True)} ({smi})")
        say(f"big grid --tune, {state}: launches at the tuner's probe shapes "
            f"(t_in, nchans, trials, samples) / (rows, series, samples): "
            f"{json.dumps(launches)}")
        require(entry["engine"] == "exact", "the big grid's tuned plan is exact")
        if state == "cold":
            require(measured > 0 and entry["source"] == "tuned",
                    "a cold --tune measures on the card and stores a tuned plan")
            require(any(log_line.startswith("tuned plan for search|") for log_line in log),
                    "the cold run tuned its plan")
            require(len(launches["dedisperse"]) >= 4 and len(launches["resample"]) == 3,
                    "the tuner launched dedisperse at each height and resample at "
                    "each accel bucket")
            out["plan"] = entry
        else:
            fil = read_filterbank(paths["big"])
            t0 = time.perf_counter()
            warm = tuning.resolve_plan_for_filterbank(
                fil, "search", dataclasses.replace(GRID_CONFIG, tune=True), cache,
                device=dev)
            load_ms = (time.perf_counter() - t0) * 1e3
            del fil
            say(f"big grid --tune, warm: the plan resolved from the cache alone in "
                f"{load_ms:.3f} ms ({smi})")
            require(warm.source == "cache", "the warm plan comes from the cache")
            out["warm load ms"] = load_ms
            require(measured == 0, "a warm --tune makes no measurement")
            require(any(log_line.startswith("tuning cache hit for search|")
                        for log_line in log), "the warm run read its plan from the cache")
            require(sum(sum(v.values()) for v in launches.values()) == 0,
                    "a warm --tune launches nothing at the tuner's probe shapes")
        bitwise = (same_bytes(os.path.join(outdir, "candidates.peasoup"),
                              os.path.join(base_dir, "candidates.peasoup"))
                   and xml_candidates(run["root"]) == xml_candidates(runs["big grid"]["root"]))
        say(f"big grid --tune, {state}: candidates " + (
            "bytes for bytes phase 3's" if bitwise else "NOT phase 3's bytes"))
        require(bitwise, f"big grid --tune, {state}: phase 3's candidates bytes for bytes")
        out[f"big {state}"] = dict(measured=measured, launches=launches, wall=run["wall"],
                                   timers=run["timers"])

    # (c): spsearch --tune on the single-pulse grid, cold then warm
    sp_base = os.path.join(tmp, "single_pulse_grid", "candidates.singlepulse")
    for state in ("cold", "warm"):
        outdir = os.path.join(tmp, f"sp_tuned_{state}")
        run, measured, log = tuned_cli_run(
            sp_main, ["-i", paths["sp"], "-o", outdir, *SP_FLAGS, "--tune",
                      "--tuning-cache", cache],
            outdir, ("candidates.singlepulse", "overview.xml"), SP_KERNELS)
        entry = tuned_entry(cache, "spsearch", smi)
        say(f"single-pulse grid --tune, {state}: {measured} measurements, "
            f"{run['wall']:.3f} s CLI wall ({smi})")
        require((measured > 0) == (state == "cold"),
                f"spsearch --tune, {state}: {'some' if state == 'cold' else 'no'} measurement")
        cands = run["root"].findall("single_pulse_search/candidates/candidate")
        check_sp_pulses([{k: float(e.find(k).text) for k in SP_FIELDS} for e in cands[:3]],
                        runs["single-pulse grid"]["pulses"])
        bitwise = same_bytes(os.path.join(outdir, "candidates.singlepulse"), sp_base)
        say(f"single-pulse grid --tune, {state}: candidates " + (
            "bytes for bytes phase 6's" if bitwise else "NOT phase 6's bytes"))
        require(bitwise, f"spsearch --tune, {state}: phase 6's candidates bytes for bytes")
        out[f"sp {state}"] = dict(measured=measured, wall=run["wall"], plan=entry)

    # (d): the subband route through the API
    fil = read_filterbank(paths["big"])
    cfg = dataclasses.replace(GRID_CONFIG, tune=True, subband_snr_loss=TUNE_SUBBAND_LOSS,
                              tuning_cache=os.path.join(tmp, "tuning_subband.json"))
    n0 = tuning.measurement_count()
    search = PeasoupSearch(cfg, device=dev)
    res = search.run(fil)
    plan = search.dedisp_plan
    raced = {t["params"]["engine"]: t["median_s"] for t in plan.trials
             if "engine" in t["params"]}
    counts = {t["params"]["subbands"]: t["median_s"] for t in plan.trials
              if "subbands" in t["params"]}
    say(f"big grid, tune with subband_snr_loss {TUNE_SUBBAND_LOSS}, cold: "
        f"{tuning.measurement_count() - n0} measurements; subband counts timed "
        f"{json.dumps(counts)}; engine race {json.dumps(raced)}; the plan: "
        f"{json.dumps(plan.summary())} ({smi})")
    require(set(raced) >= {"exact", "subband_matmul"} and len(counts) == 3,
            "the tuner timed the subband counts and raced the engines")
    require(abs(1.0 / res.candidates[0].freq - PERIOD) / PERIOD < 2e-3,
            "the tuned subband-loss search's top candidate is the pulsar")
    out["subband race"] = dict(engine=plan.engine, subbands=plan.subbands, raced=raced,
                               counts=counts)
    # the planner's analytic plan, from the cache: the subband route
    bucket = bucket_for_header(dataclasses.replace(fil.header, nsamples=fil.nsamps))
    analytic = os.path.join(tmp, "tuning_analytic.json")
    tuning.resolve_plan_for_bucket(bucket, "search", dataclasses.asdict(cfg), analytic,
                                   tune=False, device=dev)
    search = PeasoupSearch(dataclasses.replace(cfg, tuning_cache=analytic, npdmp=1),
                           device=dev)
    part = search.run(fil, finalize=False)
    plan, knobs = search.dedisp_plan, search.knobs
    require(plan.source == "cache" and plan.engine == "subband"
            and plan.subbands == TUNE_SUBBANDS and plan.smear_dm_scaled,
            f"the analytic plan: subband, {TUNE_SUBBANDS} subbands, DM-scaled budgets")
    sp = search.build_plan(fil)
    budgets = dm_smear_budgets(sp.dm_list, tsamp=fil.tsamp, fch1=fil.fch1, foff=fil.foff,
                               nchans=fil.nchans, pulse_width_us=cfg.dm_pulse_width,
                               max_snr_loss=TUNE_SUBBAND_LOSS, floor=plan.subband_smear)
    require(knobs.budgets is not None and np.array_equal(knobs.budgets, budgets),
            "the search rebuilt the DM-scaled budgets")
    direct = dedisperse_subband(
        fil_to_device(fil, dev), sp.delays, sp.killmask, sp.out_nsamps, nsub=TUNE_SUBBANDS,
        max_smear=plan.subband_smear, scale=output_scale(fil.nbits, int(sp.killmask.sum())),
        budgets=budgets)
    require(bitwise_equal(torch.as_tensor(part.trials).to(dev), direct),
            "the subband search's trials are bitwise a direct dedisperse_subband call")
    res = search.finalize(fil, part)
    top = res.candidates[0]
    say(f"big grid, the analytic subband plan from the cache: {json.dumps(plan.summary())}; "
        f"budgets {float(budgets.min())!r}..{float(budgets.max())!r} samples; trials bitwise "
        f"the direct call; top candidate period {1.0 / top.freq!r} s, dm {top.dm!r}, "
        f"snr {top.snr!r} ({smi})")
    require(abs(1.0 / top.freq - PERIOD) / PERIOD < 2e-3,
            "the subband plan's top candidate is the pulsar")
    del fil, search, part, direct, res
    torch.cuda.empty_cache()

    # (e): peasoup-perf warmup, bench and check, each a fresh process
    perf_json = os.path.join(tmp, "perf.json")
    warm_json = os.path.join(tmp, "warmup.json")
    here = os.path.dirname(os.path.abspath(__file__))
    for argv in (["warmup", "--json", warm_json], ["bench", "-o", perf_json],
                 ["check", "--perf", perf_json]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "peasoup_tpu_torch.tools.perf", *argv],
                              cwd=here, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        for line in lines[-3:]:
            say(f"  perf {argv[0]} | {line}")
        if proc.returncode != 0:
            for line in (lines + proc.stderr.strip().splitlines())[-40:]:
                say(f"  perf {argv[0]} ! {line}")
        require(proc.returncode == 0, f"peasoup-perf {argv[0]} exit code 0")
        say(f"peasoup-perf {argv[0]}: {time.perf_counter() - t0:.1f} s wall ({smi})")
    with open(warm_json) as f:
        warm = json.load(f)
    require(warm["kernels_built"] == [] and not warm["errors"],
            "peasoup-perf warmup in a fresh process builds no kernel")
    with open(perf_json) as f:
        perf = json.load(f)
    require(perf["power_limit"] == smi, "perf.json names the card and its power limit")
    for name in SOURCES:
        rec = perf["programs"][f"kernels.{name}"]
        say(f"perf bench kernels.{name}: {rec['execute_median_s'] * 1e3:.4f} ms at "
            f"{rec['args']}; phase 7: {checks[name]['ms']:.4f} ms at {checks[name]['shape']} "
            f"({perf['power_limit']})")
    out["perf"] = {k: perf["programs"][f"kernels.{k}"]["execute_median_s"] for k in SOURCES}
    return out


# --- observability on the card (phase 29) -----------------------------------

def _manifest(path: str) -> dict:
    """A telemetry manifest, validated against the port's schema copy."""
    from peasoup_tpu_torch.obs.schema import validate_manifest

    with open(path) as f:
        man = json.load(f)
    validate_manifest(man)
    return man


def _device_kernels(man: dict) -> dict:
    """{port kernel: (device ms, launches the trace recorded)} from a
    manifest's device_trace (a kernel of two device functions, harmpeaks'
    and peaks' mask and walk, counts both)."""
    out: dict = {}
    for r in man["device_trace"]["kernels"]:
        if r["port_kernel"]:
            ms, n = out.get(r["port_kernel"], (0.0, 0))
            out[r["port_kernel"]] = (ms + r["seconds"] * 1e3, n + r["launches"])
    return out


def profiler_loss(warmup: bool, n: int = 60) -> tuple[int, int]:
    """(launched, recorded): one torch.profiler session of ``n`` spin
    kernels, each waited for and 2 ms apart, opened with scope_trace's
    warm-up kernels or not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if warmup:
            absorb_start_loss()
        for _ in range(n):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.002)
    got = sum(1 for e in prof.events()
              if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name)
    return n, got


def observability_phase(tmp: str, paths: dict, runs: dict, smi: str) -> dict:
    """Phase 29: the port's run telemetry on the card, with every check of
    the run's result it must leave alone. (a) `peasoup` on the big grid
    plain, with --metrics-json --status-json --heartbeat-interval 1
    (observed), with --metrics-json --status-json --capture-device-trace
    (traced), and plain again: each run's candidates are phase 3's bytes,
    the manifests validate against the port's schema copy, status.json ends
    with "done": true, and the traced run's device table names dedisperse,
    resample, specchain, interbin and harmpeaks with device time above
    zero; the `total` of each run and the observed and traced runs' excess
    over the plain runs' mean are printed. (b) The binary grid under the
    fault plan device.oom:at=1: fault_injected, then a degradation of the
    search.memory ladder at rung 0 (dm_block_shrink), and phase 4's
    candidates. (c) The big grid under fil.read:n=9 in a subprocess: the
    reads' retries run out, the process exits non-zero and leaves
    flight.json and a manifest marked aborted. (d) `peasoup-stream` on the
    single-pulse grid with --metrics-jsonl: every line valid against the
    metrics schema copy, one chunks_total step a chunk. (e) `spsearch` on
    the single-pulse grid with --metrics-json --capture-device-trace
    (phase 6's candidates, bytes for bytes; dedisperse and spchain in the
    device table) and `peasoup-sift run` on phase 23's campaign with
    --metrics-json (the sift section and the sift_* events)."""
    from peasoup_tpu_torch.cli.peasoup import main as peasoup
    from peasoup_tpu_torch.cli.sift import main as sift_main
    from peasoup_tpu_torch.cli.spsearch import main as spsearch
    from peasoup_tpu_torch.cli.stream import main as stream_main
    from peasoup_tpu_torch.obs.metrics import load_series
    from peasoup_tpu_torch.resilience import faults

    out: dict = {}
    big, base = paths["big"], os.path.join(tmp, "big_grid")
    files = ("candidates.peasoup", "overview.xml")

    # the records a profiler session loses at its start, this far into the
    # process, without the device trace's warm-up and with it
    for warmup in (False, True):
        n, got = profiler_loss(warmup)
        say(f"29a profiler probe {time.perf_counter() - STARTED:.1f} s into the script, "
            f"{'with' if warmup else 'without'} the warm-up: {n - got} of {n} spin-kernel "
            f"records lost ({smi})")

    # (a) the big grid, plain / observed / traced / plain
    totals: dict = {}
    for label, extra in (
        ("plain 1", []),
        ("observed", ["--status-json", "{d}/status.json", "--heartbeat-interval", "1",
                      "--metrics-json", "{d}/m.json"]),
        ("traced", ["--status-json", "{d}/status.json", "--metrics-json", "{d}/m.json",
                    "--capture-device-trace"]),
        ("plain 2", []),
    ):
        d = os.path.join(tmp, "obs_big_" + label.replace(" ", ""))
        run = cli_phase(peasoup, ["-i", big, "-o", d, *GRID_FLAGS,
                                  *(a.format(d=d) for a in extra)], d, files,
                        PEASOUP_KERNELS)
        totals[label] = run["timers"]["total"]
        same = same_bytes(os.path.join(d, "candidates.peasoup"),
                          os.path.join(base, "candidates.peasoup"))
        say(f"29a big grid, {label}: total {run['timers']['total']!r} s, "
            f"search_device {run['timers']['search_device']!r} s, {run['wall']:.3f} s "
            f"CLI wall; candidates {'bytes for bytes' if same else 'NOT'} phase 3's; "
            f"launches {json.dumps(run['launches'])}")
        require(same, f"29a big grid {label}: phase 3's candidates bytes for bytes")
        man = _manifest(os.path.join(d, "m.json" if extra else "telemetry.json"))
        require(man["gauges"]["candidates.written"] > 0, "the manifest counts the candidates")
        if extra:
            with open(os.path.join(d, "status.json")) as f:
                st = json.load(f)
            require(st["done"] is True and st["stage"] == "done",
                    f"29a {label}: status.json ends with done: true")
            say(f"29a {label}: status.json seq {st['seq']}, stage {st['stage']}, "
                f"memory gauges {json.dumps({k: v for k, v in st['gauges'].items() if k.startswith('memory.')})}")
        if label == "traced":
            tr = man["device_trace"]
            ker = _device_kernels(man)
            say(f"29a traced: device busy {tr['device_s']!r} s over the run; phases (s) "
                f"{json.dumps(tr['phases'])}")
            for row in tr["table"]:
                say(f"29a scope {row['scope']}: {row['seconds'] * 1e3:.3f} ms device, "
                    f"{row['launches']} kernels")
            for name, (ms, n) in sorted(ker.items()):
                say(f"29a kernel {name}: {ms:.3f} ms device over {n} recorded launches "
                    f"(the run counted {run['launches'][name]} wrapper launches)")
            say(f"29a traced: wrapper launches in the trace's window "
                f"{json.dumps(tr['launches'])}, of them lost to the trace "
                f"{json.dumps(tr['lost_launches'])}")
            for name in PEASOUP_KERNELS:
                require(name in ker and ker[name][0] > 0,
                        f"29a the device trace names {name} with device time above zero")
            require(tr["launches"] == {k: v for k, v in run["launches"].items() if v}
                    and not tr["lost_launches"],
                    "29a the device trace holds every launch of the run's kernels")
            out["trace"] = dict(kernels=ker, device_s=tr["device_s"], phases=tr["phases"])
    plain = (totals["plain 1"] + totals["plain 2"]) / 2
    say(f"29a big grid total (s): {json.dumps(totals)} ({smi})")
    say(f"29a observed - plain (total, s): {totals['observed'] - plain!r} ({smi})")
    say(f"29a traced - plain (total, s): {totals['traced'] - plain!r} ({smi})")
    out["totals"] = totals

    # (b) the binary grid with an injected out-of-memory error
    d = os.path.join(tmp, "obs_binary_oom")
    faults.configure("device.oom:at=1")
    try:
        run = cli_phase(peasoup, ["-i", paths["binary"], "-o", d, *BINARY_FLAGS], d, files,
                        PEASOUP_KERNELS)
    finally:
        faults.configure(None)
    man = _manifest(os.path.join(d, "telemetry.json"))
    ev = [(e["kind"], e.get("ladder"), e.get("rung"), e.get("rung_index"))
          for e in man["events"] if e["kind"] in ("fault_injected", "degradation")]
    say(f"29b binary grid under device.oom:at=1: events {ev}; total "
        f"{run['timers']['total']!r} s; launches {json.dumps(run['launches'])}")
    require(ev == [("fault_injected", None, None, None),
                   ("degradation", "search.memory", "dm_block_shrink", 0)],
            "29b fault_injected, then the search.memory ladder's dm_block_shrink at rung 0")
    got, want = xml_candidates(run["root"]), xml_candidates(runs["binary grid"]["root"])
    same = same_bytes(os.path.join(d, "candidates.peasoup"),
                      os.path.join(tmp, "binary_grid", "candidates.peasoup"))
    say(f"29b candidates: {len(got)} against phase 4's {len(want)}, "
        f"{'bytes for bytes' if same else 'field for field' if got == want else 'DIFFERENT'}")
    require(got == want, "29b the faulted run gives phase 4's candidates")

    # (c) reads that fail past the retry budget
    d = os.path.join(tmp, "obs_failread")
    proc = subprocess.run(
        [sys.executable, "-m", "peasoup_tpu_torch.cli.peasoup", "-i", big, "-o", d,
         *GRID_FLAGS], env=dict(os.environ, PEASOUP_FAULTS="fil.read:n=9"),
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300,
    )
    require(proc.returncode != 0, "29c the failing read exits non-zero")
    with open(os.path.join(d, "flight.json")) as f:
        flight = json.load(f)
    man = _manifest(os.path.join(d, "telemetry.json"))
    kinds = [e["kind"] for e in man["events"]]
    say(f"29c fil.read:n=9: exit {proc.returncode}; flight.json reason {flight['reason']!r} "
        f"at stage {flight['stage']!r}; manifest aborted {man.get('aborted')} "
        f"({man.get('abort_reason')!r}); events {kinds}")
    require(man.get("aborted") is True, "29c the partial manifest is marked aborted")
    require(kinds.count("fault_injected") == 3 and "resilience_giveup" in kinds,
            "29c three injected reads, then the retry policy gives up")

    # (d) the stream's time series
    d = os.path.join(tmp, "obs_stream")
    mpath = os.path.join(d, "metrics.jsonl")
    kernels.reset_launches()
    rc, _ = run_cli(stream_main, ["--replay", paths["sp"], "-o", d, *STREAM_FLAGS,
                                  "--metrics-jsonl", mpath])
    require(rc == 0, "29d peasoup-stream exit code 0")
    series = load_series(mpath, validate=True)
    man = _manifest(os.path.join(d, "telemetry.json"))
    n = man["streaming"]["chunks_done"]
    steps = [r["value"] for r in series if r["name"] == "chunks_total"]
    say(f"29d stream: {len(series)} metric samples, each valid against the metrics schema; "
        f"{n} chunks, chunks_total {steps[-1] if steps else None!r}, triggers "
        f"{man['streaming']['triggers']}, latency p95 {man['streaming']['latency_s']['p95']!r} "
        f"s; launches {json.dumps(dict(kernels.launches))}")
    require(steps == [float(i) for i in range(1, n + 1)], "29d one chunks_total step a chunk")
    for name in STREAM_KERNELS:
        require(kernels.launches[name] == n, f"29d {name} launched once a chunk")

    # (e) spsearch and peasoup-sift with their manifests
    d = os.path.join(tmp, "obs_sp")
    run = cli_phase(spsearch, ["-i", paths["sp"], "-o", d, *SP_FLAGS, "--metrics-json",
                               os.path.join(d, "m.json"), "--capture-device-trace"], d,
                    ("candidates.singlepulse", "overview.xml"), SP_KERNELS)
    man = _manifest(os.path.join(d, "m.json"))
    ker = _device_kernels(man)
    same = same_bytes(os.path.join(d, "candidates.singlepulse"),
                      os.path.join(tmp, "single_pulse_grid", "candidates.singlepulse"))
    say(f"29e spsearch: candidates {'bytes for bytes' if same else 'NOT'} phase 6's; "
        f"device trace {json.dumps({k: [round(v[0], 3), v[1]] for k, v in ker.items()})}; "
        f"events {[e['kind'] for e in man['events'] if e['kind'] != 'stage']}; "
        f"lost to the trace {json.dumps(man['device_trace']['lost_launches'])}")
    require(same, "29e spsearch: phase 6's candidates bytes for bytes")
    for name in SP_KERNELS:
        require(name in ker and ker[name][0] > 0,
                f"29e the device trace names {name} with device time above zero")
    require(not man["device_trace"]["lost_launches"],
            "29e the device trace holds every launch of the run's kernels")
    out["sp_trace"] = ker
    camp = os.path.join(tmp, "campaign")
    mpath = os.path.join(tmp, "obs_sift.json")
    kernels.reset_launches()
    rc, _ = run_cli(sift_main, ["run", "-w", camp, "--metrics-json", mpath])
    require(rc == 0, "29e peasoup-sift run exit code 0")
    man = _manifest(mpath)
    say(f"29e sift: section {json.dumps(man['sift'])}; events "
        f"{[e['kind'] for e in man['events'] if e['kind'] != 'stage']}; launches "
        f"{json.dumps(dict(kernels.launches))}")
    require(man["sift"]["stage"] == "done" and "sift_done" in [
        e["kind"] for e in man["events"]], "29e the sift's manifest holds its section")
    return out


# --- the campaign layer on the card (phase 30) -------------------------------

# the campaign worker's lease: short, so that the preempted job's
# lease-renewer beat (a third of it) observes the request at once
CAMPAIGN_PREEMPT_LEASE_S = 0.6
# the preempted job's DM block: many wave boundaries to stop at
CAMPAIGN_PREEMPT_DM_BLOCK = 2
CAMPAIGN_TIMEOUT_S = 300.0


def config_overrides(cfg) -> dict:
    """The fields of a pipeline config that differ from its class's
    defaults: a campaign job's config that builds ``cfg`` again (the
    CLI's flags and the smoke's configs build the same one)."""
    base = dataclasses.asdict(type(cfg)())
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("outdir", "checkpoint_file") and v != base[k]}


def campaign_procs(argvs: list[list[str]]) -> list[str]:
    """``python -m peasoup_tpu_torch.cli.campaign ... --device cuda`` once
    per argv, all started together; each must exit 0 within
    CAMPAIGN_TIMEOUT_S. Returns their outputs."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "peasoup_tpu_torch.cli.campaign", *argv, "--device", "cuda"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for argv in argvs]
    deadline = time.monotonic() + CAMPAIGN_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        require(False, f"{len(argvs)} campaign worker(s) within {CAMPAIGN_TIMEOUT_S} s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-(40 if p.returncode else 2):]:
            say(f"  campaign worker {i} | {line}")
        require(p.returncode == 0, f"campaign worker {i} exit code 0 (got {p.returncode})")
    return outs


def write_manifest(path: str, entries: list[dict]) -> str:
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")
    return path


def done_records(camp: str) -> dict:
    """{input basename: done record} of a campaign."""
    from peasoup_tpu_torch.campaign.queue import JobQueue

    return {os.path.basename(d["input"]): d for d in JobQueue(camp).done_records()}


def job_file(camp: str, rec: dict, name: str) -> str:
    return os.path.join(camp, "jobs", rec["job_id"], name)


def check_rollup(camp: str, done: int) -> dict:
    """The campaign's rollup: a campaign_status.json under the JAX
    package's schema name with ``done`` jobs done, none quarantined, no
    claim left."""
    from peasoup_tpu_torch.campaign.rollup import (
        CAMPAIGN_SCHEMA, load_campaign_status, write_status,
    )

    write_status(camp)
    st = load_campaign_status(os.path.join(camp, "campaign_status.json"))
    require(st["schema"] == CAMPAIGN_SCHEMA, f"{camp}: the rollup is a {CAMPAIGN_SCHEMA}")
    q = st["queue"]
    require(q["done"] == done and q["total"] == done and q["quarantined"] == 0,
            f"{camp}: {done} jobs done, none quarantined (queue {json.dumps(q)})")
    claims = [n for n in os.listdir(os.path.join(camp, "queue", "claims"))
              if n.endswith(".json")]
    require(not claims, f"{camp}: no claim left")
    return st


def db_rows(camp: str, rec: dict) -> int:
    from peasoup_tpu_torch.campaign.db import DB_FILENAME, CandidateDB

    with CandidateDB(os.path.join(camp, DB_FILENAME)) as db:
        return len(db.candidates_for(rec["job_id"]))


def telemetry_launches(path: str) -> dict:
    """The kernel launches a campaign job's telemetry manifest records."""
    with open(path) as f:
        gauges = json.load(f)["gauges"]
    return {k.split(".")[-1]: int(v) for k, v in gauges.items()
            if k.startswith("kernels.launches.")}


def campaign_phase(tmp: str, paths: dict, smi: str) -> dict:
    """Phase 30 (a)-(f), the docstring's, on the card: campaigns of the
    grids' files, each job held to its standalone phase's outputs."""
    import shutil
    import threading
    import urllib.request

    from peasoup_tpu_torch.campaign.queue import Job, JobQueue, job_id_for
    from peasoup_tpu_torch.campaign.runner import (
        CampaignConfig, bucket_for_input, run_worker, save_campaign_config,
    )
    from peasoup_tpu_torch.cli.campaign import main as campaign_main
    from peasoup_tpu_torch.cli.sift import main as sift_main
    from peasoup_tpu_torch.io.sigproc import read_sigproc_header
    from peasoup_tpu_torch.obs.metrics import parse_exposition

    configs = dict(big=GRID_CONFIG, binary=BINARY_CONFIG, tut=TUT_CONFIG, sp=SP_CONFIG)
    base_dirs = {k: os.path.join(tmp, v) for k, v in (
        ("big", "big_grid"), ("binary", "binary_grid"), ("tut", "tutorial_grid"),
        ("sp", "single_pulse_grid"))}
    hbm = torch.cuda.mem_get_info()[0] // 2

    def nsamps(path):
        with open(path, "rb") as f:
            return read_sigproc_header(f).nsamples

    def base_bytes(key, name):
        with open(os.path.join(base_dirs[key], name), "rb") as f:
            return f.read()

    times, out = {}, {}
    t_phase = time.perf_counter()

    # (a): one bucket, two search jobs (the big and the binary grid)
    t0 = time.perf_counter()
    camp = os.path.join(tmp, "camp")
    os.makedirs(camp)
    obs = write_manifest(os.path.join(tmp, "obs.txt"), [
        {"input": paths["big"], "config": config_overrides(configs["big"])},
        {"input": paths["binary"], "config": config_overrides(configs["binary"])},
    ])
    ladder = sorted({nsamps(paths[k]) for k in ("big", "binary")})
    campaign_procs([["run", "-w", camp, "--manifest", obs, "--pipeline", "search",
                     "--bucket-nsamps", ",".join(map(str, ladder))]])
    recs = done_records(camp)
    first, second = (recs[os.path.basename(paths[k])] for k in ("big", "binary"))
    for key, rec in (("big", first), ("binary", second)):
        got = open(job_file(camp, rec, "candidates.peasoup"), "rb").read()
        same = got == base_bytes(key, "candidates.peasoup")
        root = ET.parse(job_file(camp, rec, "overview.xml")).getroot()
        ncand = len(root.findall("candidates/candidate"))
        rows = db_rows(camp, rec)
        say(f"campaign (a), {key} grid job: candidates "
            + ("bytes for bytes" if same else "NOT") + f" the standalone run's; {ncand} "
            f"candidates, {rows} DB rows; warmup_s {rec.get('warmup_s')!r}, "
            f"kernel libraries built {rec['jit_programs_compiled']}, duration "
            f"{rec['duration_s']!r} s; kernel launches "
            f"{json.dumps(rec.get('kernel_launches', {}), sort_keys=True)} ({smi})")
        require(same, f"campaign (a): the {key} grid job's candidates are its standalone "
                "phase's bytes")
        require(rows == ncand == sum(rec["ingested"].values()), f"campaign (a): the {key} grid job's DB "
                "rows are its candidates")
    require(first.get("warmup_s") is not None and first["warmup_s"] > 0,
            "campaign (a): the bucket's first job was warmed")
    require(second["jit_programs_compiled"] == 0 and second.get("warmup_s") is None,
            "campaign (a): the warm job built no kernel library and was not warmed again")
    big = first["kernel_launches"]
    require(big.get("dedisperse") == 1 and big.get("specchain") == 1
            and all(big.get(k, 0) > 0 for k in ("resample", "interbin", "harmpeaks")),
            "campaign (a): the big grid's job launched every kernel of its path")
    require(second["kernel_launches"].get("dedisperse") == 1,
            "campaign (a): the binary grid's job launched dedisperse")
    st = check_rollup(camp, 2)
    # the big grid again, in a fresh campaign and worker with no warmup:
    # what the bucket's warmup saves its first job
    camp_cold = os.path.join(tmp, "camp_cold")
    cold_txt = write_manifest(os.path.join(tmp, "cold.txt"), [
        {"input": paths["big"], "config": config_overrides(configs["big"])}])
    campaign_procs([["run", "-w", camp_cold, "--manifest", cold_txt, "--pipeline", "search",
                     "--bucket-nsamps", str(nsamps(paths["big"])), "--no-warmup"]])
    [cold] = done_records(camp_cold).values()
    same = open(job_file(camp_cold, cold, "candidates.peasoup"), "rb").read() == \
        base_bytes("big", "candidates.peasoup")
    say(f"campaign (a), the big grid's job with no warmup in a fresh worker: duration "
        f"{cold['duration_s']!r} s, against {first['duration_s']!r} s warmed (warmup_s "
        f"{first['warmup_s']!r}); candidates " + ("bytes for bytes" if same else "NOT")
        + f" the standalone run's ({smi})")
    require(same and cold.get("warmup_s") is None,
            "campaign (a): the unwarmed big grid job ran unwarmed to phase 3's bytes")
    out["a"] = dict(first=first, second=second, cold=cold)
    times["a"] = time.perf_counter() - t0

    # (b): a spsearch campaign of the single-pulse grid
    t0 = time.perf_counter()
    camp_sp = os.path.join(tmp, "camp_sp")
    sp_dir = os.path.join(tmp, "sp_obs")
    os.makedirs(sp_dir)
    shutil.copy(paths["sp"], os.path.join(sp_dir, "sp.fil"))
    campaign_procs([["run", "-w", camp_sp, "--data-dir", sp_dir, "--pipeline", "spsearch",
                     "--config", json.dumps(config_overrides(configs["sp"])),
                     "--bucket-nsamps", str(nsamps(paths["sp"])), "--no-warmup"]])
    [rec] = done_records(camp_sp).values()
    same = open(job_file(camp_sp, rec, "candidates.singlepulse"), "rb").read() == \
        base_bytes("sp", "candidates.singlepulse")
    say(f"campaign (b), spsearch job: candidates " + ("bytes for bytes" if same else "NOT")
        + f" the standalone run's; {rec['n_candidates']} candidates; kernel launches "
        f"{json.dumps(rec.get('kernel_launches', {}), sort_keys=True)} ({smi})")
    require(same, "campaign (b): the single-pulse job's candidates are phase 6's bytes")
    require(rec["kernel_launches"].get("spchain", 0) > 0
            and rec["kernel_launches"].get("dedisperse", 0) > 0,
            "campaign (b): spchain and dedisperse launched")
    check_rollup(camp_sp, 1)
    times["b"] = time.perf_counter() - t0

    # (c): two worker processes over four copies of the tutorial grid
    t0 = time.perf_counter()
    camp_tut = os.path.join(tmp, "camp_tut")
    tut_dir = os.path.join(tmp, "tut_obs")
    os.makedirs(tut_dir)
    tut_cfg = dict(config_overrides(configs["tut"]), hbm_bytes=hbm)
    copies = [shutil.copy(paths["tut"], os.path.join(tut_dir, f"tut{i}.fil"))
              for i in range(4)]
    tut_txt = write_manifest(os.path.join(tmp, "tut.txt"),
                             [{"input": c, "config": tut_cfg} for c in copies])
    outs = campaign_procs([["run", "-w", camp_tut, "--manifest", tut_txt, "--pipeline",
                            "search", "--bucket-nsamps", str(nsamps(paths["tut"])),
                            "--no-warmup", "--worker-id", f"tw{i}", "--poll", "0.2"]
                           for i in range(2)])
    recs = done_records(camp_tut)
    require(sorted(recs) == sorted(os.path.basename(c) for c in copies),
            "campaign (c): every job done")
    require(all(r["attempts"] == 1 for r in recs.values()),
            "campaign (c): every job done exactly once, in one attempt")
    tut_bytes = {open(job_file(camp_tut, r, "candidates.peasoup"), "rb").read()
                 for r in recs.values()}
    require(tut_bytes == {base_bytes("tut", "candidates.peasoup")},
            "campaign (c): the four jobs' candidates are phase 5's default route's bytes")
    by_worker: dict = {}
    for r in recs.values():
        by_worker[r["worker_id"]] = by_worker.get(r["worker_id"], 0) + 1
    workers = os.path.join(camp_tut, "queue", "workers")
    for wid in ("tw0", "tw1"):
        require(not os.path.exists(os.path.join(workers, f"{wid}.json")),
                f"campaign (c): worker {wid} deregistered")
        with open(os.path.join(workers, f"{wid}.metrics.jsonl")) as f:
            beats = sum(1 for ln in f if '"worker_heartbeat_unix"' in ln)
        require(beats > 0, f"campaign (c): worker {wid} beat")
    say(f"campaign (c): jobs by worker {json.dumps(by_worker, sort_keys=True)}; "
        f"candidates phase 5's bytes; kernel launches a job "
        + "; ".join(json.dumps(r.get("kernel_launches", {}), sort_keys=True)
                    for _, r in sorted(recs.items()))
        + "; workers' last lines: "
        + " | ".join(o.strip().splitlines()[-1] for o in outs) + f" ({smi})")
    check_rollup(camp_tut, 4)
    times["c"] = time.perf_counter() - t0

    # (d): a checkpointed tutorial-grid job preempted at a wave boundary
    t0 = time.perf_counter()
    camp_pre = os.path.join(tmp, "camp_pre")
    os.makedirs(camp_pre)
    pre_fil = shutil.copy(paths["tut"], os.path.join(camp_pre, "tut_pre.fil"))
    save_campaign_config(camp_pre, CampaignConfig(
        pipeline="search", lease_s=CAMPAIGN_PREEMPT_LEASE_S, backoff_base_s=0.05,
        warmup=False, config=dict(config_overrides(configs["tut"]),
                                  dm_block=CAMPAIGN_PREEMPT_DM_BLOCK)))
    q = JobQueue(camp_pre, lease_s=CAMPAIGN_PREEMPT_LEASE_S, backoff_base_s=0.05)
    jid = job_id_for(pre_fil)
    q.add_job(Job(job_id=jid, input=pre_fil, pipeline="search",
                  bucket=bucket_for_input(pre_fil)))
    tally: dict = {}
    worker_t = threading.Thread(target=lambda: tally.update(run_worker(
        camp_pre, worker_id="victim", poll_s=0.05, device="cuda")))
    worker_t.start()
    claim = os.path.join(camp_pre, "queue", "claims", f"{jid}.json")
    deadline = time.monotonic() + CAMPAIGN_TIMEOUT_S
    while not os.path.exists(claim) and worker_t.is_alive():
        require(time.monotonic() < deadline, "campaign (d): the job was claimed")
        time.sleep(0.005)
    # the claim is created (O_EXCL) before its document is written: a
    # request that reads it empty finds no claim and asks again
    requested = False
    while not requested and worker_t.is_alive():
        require(time.monotonic() < deadline, "campaign (d): the preempt request landed")
        requested = q.request_preempt(jid, requester="chip_smoke", grace_s=120.0)
    worker_t.join(timeout=CAMPAIGN_TIMEOUT_S)
    require(requested and not worker_t.is_alive(), "campaign (d): the worker drained")
    [rec] = q.done_records()
    with open(os.path.join(camp_pre, "jobs", jid, "telemetry.json")) as f:
        events = {e["kind"] for e in json.load(f)["events"]}
    same = open(job_file(camp_pre, rec, "candidates.peasoup"), "rb").read() == \
        base_bytes("tut", "candidates.peasoup")
    say(f"campaign (d): tally {json.dumps(tally, sort_keys=True)}; attempts "
        f"{rec['attempts']}, preemptions {rec.get('preemptions')}, latency "
        f"{rec.get('preempt_latency_s')} s; resume events "
        f"{sorted(events & {'checkpoint_resume', 'resume_fast_path'})}; the resumed "
        f"attempt's kernel launches {json.dumps(rec.get('kernel_launches', {}), sort_keys=True)}"
        "; candidates " + ("bytes for bytes (c)'s" if same else "NOT (c)'s bytes")
        + f" ({smi})")
    require(tally.get("released") == 1 and rec["attempts"] == 1
            and rec.get("preemptions") == 1,
            "campaign (d): preempted once, released with zero attempts consumed")
    require("checkpoint_resume" in events, "campaign (d): the job resumed from its checkpoint")
    require(same, "campaign (d): the resumed job's candidates are (c)'s bytes")
    check_rollup(camp_pre, 1)
    times["d"] = time.perf_counter() - t0

    # (e): a gang job, nprocs 2, on the binary grid
    t0 = time.perf_counter()
    camp_gang = os.path.join(tmp, "camp_gang")
    gang_txt = write_manifest(os.path.join(tmp, "gang.txt"), [
        {"input": paths["binary"], "config": dict(config_overrides(configs["binary"]),
                                                  hbm_bytes=hbm)}])
    campaign_procs([["run", "-w", camp_gang, "--manifest", gang_txt, "--pipeline", "search",
                     "--nprocs", "2", "--group", "pod", "--worker-id", f"g{i}",
                     "--bucket-nsamps", str(nsamps(paths["binary"])), "--no-warmup",
                     "--poll", "0.2"] for i in range(2)])
    [rec] = done_records(camp_gang).values()
    same = open(job_file(camp_gang, rec, "candidates.peasoup"), "rb").read() == \
        open(job_file(camp, second, "candidates.peasoup"), "rb").read()
    leader = telemetry_launches(job_file(camp_gang, rec, "telemetry.json"))
    member = telemetry_launches(job_file(camp_gang, rec, "telemetry.proc1.json"))
    say(f"campaign (e): gang {json.dumps(rec.get('gang'), sort_keys=True)}; leader's "
        f"candidates " + ("bytes for bytes (a)'s binary job's" if same else "NOT (a)'s")
        + f"; launches leader {json.dumps(leader, sort_keys=True)}, member "
        f"{json.dumps(member, sort_keys=True)} ({smi})")
    require(rec.get("gang", {}).get("nprocs") == 2, "campaign (e): a gang of two ran the job")
    require(same, "campaign (e): the gang's candidates are the single-process job's bytes")
    require(leader.get("dedisperse") == 1 and member.get("dedisperse") == 1,
            "campaign (e): each member dedispersed its own slice")
    check_rollup(camp_gang, 1)
    times["e"] = time.perf_counter() - t0

    # (f): the operator surface
    t0 = time.perf_counter()
    require(run_cli(campaign_main, ["status", "-w", camp])[0] == 0,
            "campaign (f): campaign status renders")
    for c in (camp, camp_sp, camp_tut, camp_pre, camp_gang):
        rc, text = run_cli(campaign_main, ["alerts", "-w", c, "--evaluate"])
        require(rc == 0 and "firing" not in text, f"campaign (f): no alert firing over {c}")
    require(run_cli(campaign_main, ["sentinel", "-w", camp])[0] == 0,
            "campaign (f): a sentinel enqueued")
    campaign_procs([["run", "-w", camp, "--no-warmup"]])
    rc, text = run_cli(campaign_main, ["sentinel", "-w", camp, "--check"])
    say("campaign (f): sentinel: " + " | ".join(text.strip().splitlines()[-2:]))
    require(rc == 0 and "[recovered]" in text, "campaign (f): the sentinel was recovered")
    port = free_port()
    server = threading.Thread(target=campaign_main, args=(
        ["serve", "-w", camp, "--host", "127.0.0.1", "--port", str(port),
         "--max-requests", "2"],))
    server.start()
    bodies = {}
    for route in ("/status", "/metrics"):
        for _ in range(100):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                            timeout=30) as r:
                    bodies[route] = r.read().decode()
                break
            except OSError:
                time.sleep(0.05)
    server.join(timeout=60)
    require(not server.is_alive(), "campaign (f): the portal shut down")
    status = json.loads(bodies["/status"])
    require(status["queue"]["done"] == 3, "campaign (f): /status answers with the rollup")
    series = parse_exposition(bodies["/metrics"])
    require(len(series) > 0, "campaign (f): /metrics answers with a valid exposition")
    require(run_cli(sift_main, ["run", "-w", camp, "--no-fold", "--device", "cuda"])[0] == 0,
            "campaign (f): peasoup-sift run over the campaign")
    rc, _ = run_cli(sift_main, ["report", "-w", camp])
    with open(os.path.join(camp, "sift", "report.json")) as f:
        report = json.load(f)
    require(rc == 0 and (report.get("campaign") or {}).get("schema")
            == "peasoup_tpu.campaign_status",
            "campaign (f): the sift report holds the campaign section")
    times["f"] = time.perf_counter() - t0
    say(f"campaign (f): status, alerts over five campaigns, the sentinel, /status and "
        f"/metrics ({len(series)} samples), the sift report's campaign section ({smi})")
    wall = time.perf_counter() - t_phase
    say("phase 30 sub-phases (s): " + json.dumps({k: round(v, 3) for k, v in times.items()})
        + f"; {wall:.1f} s in all ({smi})")
    out.update(times=times, wall=wall, rollup=st)
    return out


# --- the chaos soak and the user-facing tools on the card (phase 31) --------

# (c)'s observations: the single-pulse grid's length at the chaos tool's
# own 8 channels
CHAOS_FULL_NSAMPS = 1 << 21
CHAOS_TIMEOUT_S = 400.0


def chaos_cli(argv: list[str], workdir: str) -> tuple[dict, str, float]:
    """``python -m peasoup_tpu_torch.tools.chaos ARGV -o WORKDIR --device
    cuda`` in a process of its own; it must exit 0 and survive. Returns its
    report, output and wall time."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "peasoup_tpu_torch.tools.chaos", *argv, "-o", workdir,
             "--device", "cuda"],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
            text=True, timeout=CHAOS_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired:
        require(False, f"peasoup-chaos {' '.join(argv)} within {CHAOS_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    report_path = os.path.join(workdir, "chaos_report.json")
    report = json.load(open(report_path)) if os.path.exists(report_path) else {}
    if proc.returncode or not report.get("ok"):
        for line in out.strip().splitlines()[-60:]:
            say(f"  chaos | {line}")
    require(proc.returncode == 0 and "SURVIVED" in proc.stdout and report.get("ok"),
            f"peasoup-chaos {' '.join(argv)}: exit 0, SURVIVED, report ok (rc "
            f"{proc.returncode}, violations {report.get('violations')}, error "
            f"{report.get('error')})")
    return report, out, wall


def chaos_tools_phase(tmp: str, smi: str) -> dict:
    """Phase 31 (a)-(e), the docstring's, on the card."""
    import contextlib
    import io
    import threading
    import urllib.request

    from peasoup_tpu_torch.cli.campaign import main as campaign_main
    from peasoup_tpu_torch.cli.peasoup import main as peasoup_main
    from peasoup_tpu_torch.obs.schema import validate_manifest
    from peasoup_tpu_torch.resilience import STATS, faults
    from peasoup_tpu_torch.tools import chaos
    from peasoup_tpu_torch.tools.as_text import main as as_text_main
    from peasoup_tpu_torch.tools.divergence import (
        STANDARD_ABS, compare_trial, level_standard,
    )
    from peasoup_tpu_torch.tools.parsers import OverviewFile
    from peasoup_tpu_torch.tools.report import main as report_main

    times, out = {}, {}

    # (a) the campaign and stream soaks, the tool's defaults
    report, _, times["a"] = chaos_cli(["--mode", "both", "--seed", "7"],
                                      os.path.join(tmp, "chaos_both"))
    jobs = report["campaign"]["jobs"]
    stream_launches = report["stream"]["chaos"]["kernel_launches"]
    say(f"31a chaos --mode both: {times['a']:.1f} s wall; campaign queue "
        f"{json.dumps(report['campaign']['queue'])}, workers killed "
        f"{report['campaign']['chaos']['workers_killed']}, injections "
        f"{[(r['site'], r['ordinal']) for r in report['campaign']['injections']['injected']]}"
        f"; jobs {json.dumps(jobs, sort_keys=True)}; stream {report['stream']['n_triggers']}"
        f" triggers over {report['stream']['chaos']['n_chunks']} chunks, launches "
        f"{json.dumps(stream_launches, sort_keys=True)} ({smi})")
    require(len(jobs) == 3 and all(
        j["kernel_launches"].get("dedisperse", 0) > 0
        and j["kernel_launches"].get("spchain", 0) > 0 for j in jobs.values()),
        "31a every campaign job launched dedisperse and spchain")
    require(stream_launches.get("dedisperse", 0) > 0 and stream_launches.get("boxcar", 0) > 0,
            "31a the stream soak launched dedisperse and boxcar")
    out["a"] = dict(jobs=jobs, stream=stream_launches)

    # (b) the fleet: worker processes of the port's campaign CLI on the card
    report, _, times["b"] = chaos_cli(
        ["--mode", "fleet", "--seed", "11", "--workers", "4", "--n-obs", "6",
         "--lease", "1.0", "--fleet-timeout", "300"], os.path.join(tmp, "chaos_fleet"))
    sec = report["fleet"]
    say(f"31b chaos --mode fleet: {times['b']:.1f} s wall (the fleet {sec['wall_s']} s); "
        f"queue {json.dumps(sec['queue'])}; kills {json.dumps(sec['kills'])}; late joins "
        f"{sec['late_joins']}; recovery {json.dumps(sec['recovery'], sort_keys=True)}; "
        f"preemption resumed {sec['preemption']['jobs_resumed']}, latency "
        f"{sec['preemption']['latency_s']} s; gang {json.dumps(sec['gang'])}; autoscale ups "
        f"{sec['autoscale']['ups']}; profile {json.dumps(sec['observability'].get('profile'))}"
        f"; launches a job (attempts, preemptions) " + "; ".join(
            f"{json.dumps(j['kernel_launches'], sort_keys=True)} ({j['attempts']}, "
            f"{j['preemptions']})" for j in sec["jobs"].values())
        + f" ({smi})")
    require(sec["violations"] == [] and sec["queue"]["done"] == 7,
            "31b the fleet: 7 jobs done, no violation")
    require(bool(sec["kills"]) and bool(sec["late_joins"])
            and sec["recovery"]["worker.kill"]["reaped_retries"] >= 1,
            "31b the fleet: a worker SIGKILLed, its job reaped and retried")
    require(sec["recovery"]["fil.read"]["injected"] == 2, "31b the fleet: 2 flaky reads")
    require(sec["preemption"]["jobs_resumed"] >= 1 and bool(sec["preemption"]["latency_s"]),
            "31b the fleet: a preemption resumed, its latency attributed")
    require(sec["gang"]["done"] == 1 and sec["autoscale"]["ups"] >= 1,
            "31b the fleet: the gang job done, an autoscale up")
    # a preempted or reaped job resumes from the checkpoint its first attempt
    # saved: where that came after the job's one DM block, it launches nothing
    first = [j for j in sec["jobs"].values() if j["attempts"] == 1 and not j["preemptions"]]
    require(len(first) > 0 and all(j["kernel_launches"].get("dedisperse", 0) > 0
                                   and j["kernel_launches"].get("spchain", 0) > 0
                                   for j in first),
            "31b every fleet job done at its first attempt launched dedisperse and spchain")
    out["b"] = dict(wall_s=sec["wall_s"], recovery=sec["recovery"])

    # (c) the campaign soak at the single-pulse grid's length, in this process
    t0 = time.perf_counter()
    w = os.path.join(tmp, "chaos_full")
    kernels.reset_launches()
    try:
        sec = chaos.run_campaign_soak(w, chaos.DEFAULT_CAMPAIGN_FAULTS, 7,
                                      nsamps=CHAOS_FULL_NSAMPS, lease_s=1.0, device="cuda")
    finally:
        faults.configure(None)
        STATS.reset()
    times["c"] = time.perf_counter() - t0
    launches = dict(kernels.launches)
    spchain_shapes = {str(k): v for k, v in kernels.launch_shapes["spchain"].items()}
    same = all(
        open(os.path.join(w, "ref", "jobs", j, "candidates.singlepulse"), "rb").read()
        == open(os.path.join(w, "chaos", "jobs", j, "candidates.singlepulse"), "rb").read()
        for j in sec["jobs"])
    say(f"31c campaign soak at {CHAOS_FULL_NSAMPS} samples x 8 channels, 3 obs: "
        f"{times['c']:.1f} s wall (reference {sec['reference']['wall_s']} s, chaos "
        f"{sec['chaos']['wall_s']} s); queue {json.dumps(sec['queue'])}; killed "
        f"{sec['chaos']['workers_killed']}; candidates "
        + ("bytes for bytes the fault-free run's" if same else "NOT the fault-free run's")
        + f"; launches (both campaigns) {json.dumps({k: v for k, v in launches.items() if v})}"
        f"; spchain launch shapes {json.dumps(spchain_shapes)} ({smi})")
    require(sec["violations"] == [] and same and len(sec["jobs"]) == 3,
            "31c the full-size soak survived with the fault-free run's candidate bytes")
    require(launches["spchain"] > 0 and launches["dedisperse"] > 0,
            "31c dedisperse and spchain launched")
    out["c"] = dict(launches=launches, spchain_shapes=spchain_shapes)

    # (d) the divergence chain on the card against the f64 oracle
    t0 = time.perf_counter()
    tut = os.path.join(tmp, "tut.fil")
    accs = [-5.0, 0.0, 5.0]
    kernels.reset_launches()
    rows, oracle, meta = compare_trial(tut, 30.0, accs, device="cuda")
    resampled = kernels.launches["resample"]
    cpu_rows, _, cpu_meta = compare_trial(tut, 30.0, accs, device="cpu")
    times["d"] = time.perf_counter() - t0
    for (name, err), (_, cerr) in zip(rows, cpu_rows):
        say(f"31d {name:>16s}  relerr card {err:9.3e}  cpu {cerr:9.3e}")
    std = level_standard(oracle, meta)
    for (name, dsnr, same), (_, cdsnr, csame) in zip(std, level_standard(oracle, cpu_meta)):
        say(f"31d {name:>16s}  max|dS/N| card {dsnr:9.3e} cpu {cdsnr:9.3e}; S/N > 9 "
            f"membership card {'same' if same else 'DIFFERS'}, cpu "
            f"{'same' if csame else 'DIFFERS'}")
    say(f"31d divergence at DM 30, accelerations {accs}: {times['d']:.1f} s wall; resample "
        f"launches {resampled} ({smi})")
    require(all(same and dsnr < STANDARD_ABS for _, dsnr, same in std),
            "31d every S/N level on the card at the standard against the oracle")
    require(resampled == len(accs), "31d the resample kernel launched once an acceleration")
    out["d"] = dict(levels=std, resample_launches=resampled)

    # (e) the tools over earlier phases' outputs
    t0 = time.perf_counter()
    shards = [os.path.join(tmp, f"procs_spsearch.rank{r}", f"telemetry.proc{r}.json")
              for r in range(2)]
    merged_path = os.path.join(tmp, "merged.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report_main(["--merge", *shards, "-o", merged_path])
    merged = json.load(open(merged_path))
    validate_manifest(merged)
    imb = merged["straggler"]["imbalance"]
    say(f"31e report --merge over phase 26's spsearch shards: {merged['n_hosts']} hosts, "
        f"{len(buf.getvalue().splitlines())} lines rendered, slowest/mean "
        f"{imb['ratio']:.3f}, stages {sorted(merged['timers'])}")
    require(rc == 0 and merged["merged"] and merged["n_hosts"] == 2,
            "31e report --merge over phase 26's two spsearch shards validates")
    big_xml = os.path.join(tmp, "big_grid", "overview.xml")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = as_text_main([big_xml])
    lines = buf.getvalue().splitlines()
    ncand = len(OverviewFile(big_xml).candidates)
    say(f"31e as_text over the big grid's overview.xml: {ncand} candidates; "
        f"{lines[0]} | {lines[1] if len(lines) > 1 else ''}")
    require(rc == 0 and len(lines) == ncand + 1 and ncand > 0,
            "31e as_text prints every candidate of the big grid")
    svg = open(os.path.join(tmp, "campaign", "sift", "bowtie.svg")).read()
    require(svg.startswith("<svg") and svg.endswith("</svg>"),
            "31e phase 23's sift wrote sift/bowtie.svg")
    camp = os.path.join(tmp, "camp")
    port = free_port()
    server = threading.Thread(target=campaign_main, args=(
        ["serve", "-w", camp, "--host", "127.0.0.1", "--port", str(port),
         "--max-requests", "1"],))
    server.start()
    body, status, ctype = b"", 0, ""
    for _ in range(100):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/bowtie.svg",
                                        timeout=30) as r:
                body, status, ctype = r.read(), r.status, r.headers.get("Content-Type")
            break
        except OSError:
            time.sleep(0.05)
    server.join(timeout=60)
    say(f"31e the portal over phase 30's campaign: /bowtie.svg {status} {ctype}, "
        f"{len(body)} bytes")
    require(status == 200 and body.startswith(b"<svg") and ctype == "image/svg+xml",
            "31e the portal answers /bowtie.svg with 200 and an SVG")
    outdir = os.path.join(tmp, "tut_p")
    err = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = peasoup_main(["-i", os.path.join(tmp, "tut.fil"), "-o", outdir, *TUT_FLAGS,
                           "-p"])
    same = same_bytes(os.path.join(outdir, "candidates.peasoup"),
                      os.path.join(tmp, "tutorial_grid", "candidates.peasoup"))
    frames = err.getvalue().count("\rComplete:")
    say(f"31e the tutorial grid with -p: {frames} bar frames on stderr, the last "
        f"{err.getvalue().rsplit(chr(13), 1)[-1].strip()!r}; candidates "
        + ("bytes for bytes" if same else "NOT") + " phase 5's default route's; launches "
        f"{json.dumps({k: v for k, v in kernels.launches.items() if v})}")
    require(rc == 0 and "Complete: 100.0%" in err.getvalue() and same,
            "31e -p draws the bar on stderr and leaves the candidates' bytes")
    times["e"] = time.perf_counter() - t0
    say("phase 31 parts (s): " + json.dumps({k: round(v, 3) for k, v in times.items()})
        + f" ({smi})")
    out["times"] = times
    return out


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
    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2:])
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
    resources = kernels.boxcar_resources()
    say(f"boxcar's resources (cudaFuncGetAttributes): {json.dumps(resources)}")
    require(all(r["registers"] > 0 for r in resources.values()),
            "the runtime reported boxcar's registers")
    n, got = profiler_loss(False)
    say(f"profiler probe {time.perf_counter() - STARTED:.1f} s into the script, the "
        f"process's first session, without a warm-up: {n - got} of {n} spin-kernel "
        f"records lost (phase 29 probes again)")

    runs, checks = {}, {}
    t_smoke = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for label, synth, cfg, flags, period in (
            ("big grid", big_grid_fil, GRID_CONFIG, GRID_FLAGS, PERIOD),
            ("binary grid", binary_grid_fil, BINARY_CONFIG, BINARY_FLAGS, BIN_PERIOD),
        ):
            # the big grid's file stays for the later phases
            path = os.path.join(tmp, "big.fil" if label == "big grid" else "grid.fil")
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
            run = periodicity_phase(path, outdir, flags, period, profile=args.profile)
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
            if label != "big grid":
                os.remove(path)
            torch.cuda.empty_cache()

        path = os.path.join(tmp, "tut.fil")  # stays for the later phases
        t0 = time.perf_counter()
        tutorial_grid_fil(path)
        say(f"synthesized tutorial grid filterbank in {time.perf_counter() - t0:.1f} s")
        fil = read_filterbank(path)
        plan = PeasoupSearch(TUT_CONFIG, device=dev).build_plan(fil)
        ntrials = sum(len(a) for a in plan.accel_lists)
        tut = tutorial_phase(path, tmp, profile=args.profile)
        for label, run in tut.items():
            runs[label] = run
            say(f"{label}: {plan.ndm} DM trials, {ntrials} DM x accel trials of "
                f"{plan.size} samples, {run['wall']:.3f} s CLI wall, "
                f"{ntrials / run['timers']['searching']:.1f} trials/s over the "
                "searching stage")
            say(f"{label} stage timers (s): " + json.dumps(run["timers"], sort_keys=True))
            say(f"{label} kernel launches: " + json.dumps(run["launches"]))
            say(f"{label} launch shapes: " + json.dumps(
                {k: {str(s): n for s, n in v.items()} for k, v in run["shapes"].items()}
            ))
        modal, other = tutorial_kernel_phase(dev, fil, tut)
        checks.update(modal)
        for name, c in other.items():
            say(f"{name} ({c['path']}): {c['shape']}: {c['ms']:.4f} ms kernel, "
                f"{c['plain_ms']:.4f} ms plain, bound {c['bound'][0]:.4f} ms "
                f"({c['bound'][1]}), max |err| {c['max_abs_err']}")
            checks[name].setdefault("other_shapes", []).append(other_shape(c))
        del fil
        torch.cuda.empty_cache()

        label = "single-pulse grid"
        path = os.path.join(tmp, "grid.fil")
        outdir = os.path.join(tmp, "single_pulse_grid")
        t0 = time.perf_counter()
        run = sp_grid_phase(path, outdir, profile=args.profile)
        runs[label] = run
        fil = read_filterbank(path)
        search = SinglePulseSearch(SP_CONFIG, device=dev)
        plan = search.build_dm_plan(fil)
        widths = search.widths_for(plan.out_nsamps)
        say(f"{label}: {plan.ndm} DM trials of {plan.out_nsamps} samples, "
            f"tpad {plan_pad(plan.out_nsamps)[0]}, wext {width_extent(widths)}, "
            f"{len(widths)} widths {widths[0]}..{widths[-1]}, dec {SP_CONFIG.decimate}; "
            f"{run['wall']:.3f} s CLI wall ({time.perf_counter() - t0:.1f} s with "
            "the synthesis)")
        say(f"{label} stage timers (s): " + json.dumps(run["timers"], sort_keys=True))
        say(f"{label} kernel launches: " + json.dumps(run["launches"]))
        say(f"{label} launch shapes: " + json.dumps(
            {k: {str(s): n for s, n in v.items()} for k, v in run["shapes"].items()}
        ))
        sp_checks = sp_kernel_phase(dev, fil, run["shapes"])
        for name, c in sp_checks.items():
            if name == "dedisperse":  # the main path's second dedisperse shape
                say(f"dedisperse ({label}): {c['shape']}: {c['ms']:.4f} ms kernel, "
                    f"{c['plain_ms']:.4f} ms plain, bound {c['bound'][0]:.4f} ms "
                    f"({c['bound'][1]}), max |err| {c['max_abs_err']}")
                checks[name].setdefault("other_shapes", []).append(other_shape(c))
            elif name == "spchain":
                checks[name] = dict(c, path=label)
        torch.cuda.empty_cache()

        # the streaming search replays the same file: boxcar's path
        t0 = time.perf_counter()
        stream = stream_phase(path, tmp, run["pulses"])
        runs["stream"] = stream
        say(f"stream launch shapes: " + json.dumps(
            {k: {str(s): n for s, n in v.items()} for k, v in stream["shapes"].items()}
        ))
        c = sp_checks["boxcar"]
        say(f"boxcar ({c['path']}): {c['shape']}: {c['ms']:.4f} ms kernel, "
            f"{c['kernel_ms']:.4f} ms device time alone, {c['queued_ms']:.4f} ms "
            f"queued, {c['plain_ms']:.4f} ms plain, bound {c['bound'][0]:.4f} ms "
            f"({c['bound'][1]}), max |err| {c['max_abs_err']}")
        checks["boxcar"] = dict(stream_kernel_phase(dev, fil, stream["shapes"]),
                                path="stream", other_shapes=[other_shape(c)],
                                resources=resources)
        say(f"phase stream: {time.perf_counter() - t0:.1f} s wall")
        del fil
        os.remove(path)
        torch.cuda.empty_cache()

        for name in SOURCES:
            c = checks[name]
            lib = c.get("library_ms")
            say(f"{name} ({c['path']}): {c['shape']}: {c['ms']:.4f} ms kernel, "
                + (f"{c['kernel_ms']:.4f} ms device time alone, {c['queued_ms']:.4f} "
                   "ms queued, " if "kernel_ms" in c else "")
                + f"{c['plain_ms']:.4f} ms plain, "
                + (f"{lib:.4f} ms library, " if lib is not None else "")
                + f"bound {c['bound'][0]:.4f} ms ({c['bound'][1]}), "
                f"max |err| {c['max_abs_err']}")

        n, nfold = agreement_phase(tmp)
        say(f"small input: {n} strong candidates and {nfold} fold outcomes "
            "agree between cuda and cpu")
        n = sp_agreement_phase(tmp)
        say(f"small single-pulse input: {n} strong candidates agree between "
            "cuda and cpu")

        # the dedispersion engines, checkpoints, the memory ladder and the
        # smaller searches, each phase timed
        big, tut = os.path.join(tmp, "big.fil"), os.path.join(tmp, "tut.fil")
        tut_base = runs["tutorial grid"]
        for label, fn in (
            ("dedispersion engines", lambda: engines_phase(dev)),
            ("big grid, --subbands 8", lambda: subband_grid_phase(big, tmp)),
            ("tutorial grid, subband and matmul engines",
             lambda: tutorial_engine_phase(tut, tmp, tut_base)),
            ("checkpoints", lambda: checkpoint_phase(tut, tmp, tut_base)),
            ("out of memory", lambda: oom_phase(big, tmp, runs["big grid"])),
            ("ffa", lambda: ffa_phase(tmp)),
            ("coincidencer", lambda: coincidence_phase(tmp)),
            ("accmap", lambda: accmap_phase(tmp)),
            ("subband search, card against cpu", lambda: subband_agreement_phase(tmp)),
            ("fdas", lambda: runs.setdefault("fdas", fdas_phase(tmp))),
            ("fdas, card against cpu", lambda: fdas_agreement_phase(tmp)),
            ("stream, card against cpu", lambda: stream_agreement_phase(tmp)),
            (f"single-pulse search at decimate {ODD_DEC}, card against cpu",
             lambda: odd_decimation_phase(tmp)),
        ):
            t0 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            say(f"phase {label}: {time.perf_counter() - t0:.1f} s wall")

        # the survey sift over this run's own outputs, then card against cpu
        t0 = time.perf_counter()
        checks["dedisperse"].setdefault("other_shapes", []).append(
            other_shape(sift_campaign_phase(tmp, dev)))
        torch.cuda.empty_cache()
        say(f"phase sift campaign: {time.perf_counter() - t0:.1f} s wall")
        t0 = time.perf_counter()
        sift_agreement_phase(tmp)
        torch.cuda.empty_cache()
        say(f"phase sift and rank, card against cpu: {time.perf_counter() - t0:.1f} s wall")

        # the split runs: the DM trials over two shards of the card, then
        # over two processes sharing it; the grids' files made again
        paths = dict(big=os.path.join(tmp, "big.fil"), binary=os.path.join(tmp, "grid.fil"),
                     sp=os.path.join(tmp, "sp.fil"), fdas=os.path.join(tmp, "fdas.fil"))
        t0 = time.perf_counter()
        binary_grid_fil(paths["binary"])
        sp_grid_fil(paths["sp"])
        fdas_grid_fil(paths["fdas"])
        say(f"synthesized the binary, single-pulse and FDAS grids' filterbanks again in "
            f"{time.perf_counter() - t0:.1f} s")
        for label, fn in (
            (f"25, {NSHARDS} shards on one card", lambda: split_phase(tmp, dev, paths, runs)),
            ("26, two processes on one card", lambda: process_phase(tmp, paths, runs)),
            ("27, the survey fold in two processes", lambda: survey_fold_phase(tmp)),
            ("28, the tuning and measurement layer",
             lambda: runs.setdefault("tuning", tuning_phase(tmp, dev, paths, runs, checks, smi))),
            ("29, observability on the card",
             lambda: runs.setdefault("obs", observability_phase(tmp, paths, runs, smi))),
            ("30, the campaign layer on the card",
             lambda: runs.setdefault("campaign", campaign_phase(
                 tmp, dict(paths, tut=os.path.join(tmp, "tut.fil")), smi))),
            ("31, the chaos soak and the user-facing tools on the card",
             lambda: runs.setdefault("chaos", chaos_tools_phase(tmp, smi))),
        ):
            t0 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            say(f"phase {label}: {time.perf_counter() - t0:.1f} s wall ({smi})")
        checks["dedisperse"].setdefault("other_shapes", []).extend(
            shard_shape_checks(dev, paths))
        say(f"chip_smoke: {time.perf_counter() - t_smoke:.1f} s wall after the build ({smi})")

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
            # dftspec's: torch.fft.fft + the interbin kernel, the port's
            # other route for the same function (two calls)
            "library_ms": c.get("library_ms"),
            "path": c["path"],
            "shape": c["shape"],
            **{k: c[k] for k in ("accuracy_max", "accuracy_q999", "scratch_bytes",
                                 "phases_ms", "kernel_ms", "kernel_ms_launches",
                                 "queued_ms", "resources",
                                 "other_shapes")
               if k in c},
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
