"""One process of a multi-process run of the port on the CPU, for
tests/test_torch_multihost.py (and the recipe of its single-process
reference, :func:`run_drivers` without a process group).

    python tests/torch_multihost_worker.py MODE OUT SPEC_JSON

with JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID set
(parallel/multihost.py:initialize reads them). MODE is

- ``drivers``: run_search (with folding), run_single_pulse_search,
  run_fdas_search and run_survey_fold on SPEC's inputs, then the `peasoup`
  CLI into ``SPEC["cli_out"] + rank``; pickles the results to OUT;
- ``dead_peer``: rank 1 leaves right after the rendezvous, rank 0 then
  exchanges a blob and pickles what it raised and how long it waited.

Imports the port only, never JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from peasoup_tpu_torch.io.sigproc import read_filterbank  # noqa: E402
from peasoup_tpu_torch.parallel import multihost  # noqa: E402
from peasoup_tpu_torch.pipeline.fdas import FdasConfig  # noqa: E402
from peasoup_tpu_torch.pipeline.search import SearchConfig  # noqa: E402
from peasoup_tpu_torch.pipeline.single_pulse import SinglePulseConfig  # noqa: E402
from peasoup_tpu_torch.sift.fold import (  # noqa: E402
    FoldCandidate, FoldObservation, SurveyFolder,
)

# each DM trial a block of its own, so a slice's FFT batches are the whole
# run's and the split run is bitwise the single one
SEARCH = dict(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0,
              npdmp=4, dm_block=1, limit=100)
SP = dict(dm_end=60.0, min_snr=7.0, n_widths=8)
FDAS = dict(dm_start=50.0, dm_end=70.0, zmax=32.0, zstep=2.0, nharmonics=2, limit=20,
            dm_block=1)
CLI_FLAGS = ["--dm_start", "0", "--dm_end", "40", "--acc_start", "-2", "--acc_end",
             "2", "-m", "6", "--npdmp", "4", "--device", "cpu"]


def fold_observations(seed: int = 11, nobs: int = 3) -> list[FoldObservation]:
    """Three observations of trials holding a P = 16.4 ms pulse train, two
    candidates each (the fundamental and a wrong period)."""
    rng = np.random.default_rng(seed)
    tsamp, nsamps, period = 0.000256, 1 << 13, 0.0164
    t = np.arange(nsamps) * tsamp
    out = []
    for o in range(nobs):
        rows = []
        for _ in range(2):
            x = rng.normal(40, 4, size=nsamps) + 12.0 * ((t / period) % 1.0 < 0.08)
            rows.append(np.clip(np.rint(x), 0, 255).astype(np.uint8))
        cands = [FoldCandidate(key=10 * o + k, period=period * (1 + 0.01 * k),
                               acc=0.0, dm_row=k) for k in range(2)]
        out.append(FoldObservation(job_id=f"obs{o}", trials=np.stack(rows),
                                   trials_nsamps=nsamps, tsamp=tsamp, cands=cands))
    return out


def run_drivers(spec: dict) -> dict:
    """Every driver on SPEC's inputs, as plain host rows."""
    res = multihost.run_search(read_filterbank(spec["search_fil"]),
                               SearchConfig(**SEARCH), device="cpu")
    search = [(c.freq, c.snr, c.dm, c.dm_idx, c.acc, c.nh, c.folded_snr, c.opt_period)
              for c in res.candidates]
    sp = multihost.run_single_pulse_search(read_filterbank(spec["sp_fil"]),
                                           SinglePulseConfig(**SP), device="cpu")
    fd = multihost.run_fdas_search(read_filterbank(spec["fdas_fil"]),
                                   FdasConfig(**FDAS), device="cpu")
    folds = multihost.run_survey_fold(fold_observations(), SurveyFolder(batch=4))
    return dict(
        search=search, n_accel_trials=res.n_accel_trials,
        search_dm_list=np.asarray(res.dm_list),
        sp=[vars(c) for c in sp.candidates],
        fdas=[(c.freq, c.snr, c.dm, c.dm_idx, c.z, c.w, c.nh) for c in fd.candidates],
        fdas_trials=fd.n_trials,
        folds=sorted((o["key"], o["opt_sn"], o["opt_period"],
                      np.asarray(o["opt_fold"]).tobytes()) for o in folds),
    )


def main() -> int:
    mode, out, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    torch.set_num_threads(2)
    multihost.initialize(timeout_s=spec.get("timeout_s", 60.0))
    rank, nproc = multihost.process_index(), multihost.process_count()
    if mode == "drivers":
        got = run_drivers(spec)
        from peasoup_tpu_torch.cli.peasoup import main as cli_main

        rc = cli_main(["-i", spec["search_fil"], "-o", f"{spec['cli_out']}{rank}",
                       *CLI_FLAGS])
        got.update(rank=rank, nproc=nproc, cli_rc=rc)
    elif mode == "dead_peer":
        # both ranks hold the full mesh before the peer dies: under load
        # rank 1's init can return while rank 0 still connects to it
        torch.distributed.barrier()
        if rank == 1:
            os._exit(0)  # a peer that dies after the rendezvous
        time.sleep(1.0)
        t0 = time.monotonic()
        try:
            multihost._allgather_pickled(b"payload", context="test:dead_peer")
            got = dict(raised=None)
        except Exception as exc:
            got = dict(raised=type(exc).__name__, message=str(exc))
        got.update(rank=rank, waited=time.monotonic() - t0)
    else:
        raise SystemExit(f"unknown mode {mode}")
    with open(out, "wb") as f:
        pickle.dump(got, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
