"""Per-device tuning of the dedispersion and search shape knobs, and the
tuning cache that makes it a cost paid once (the JAX package's
perf/tuning.py): measure, decide, cache, reuse.

The planner (plan/dedisp_plan.py) picks exact or subband dedispersion
analytically; which shape knobs run fastest is a property of the device
("Real-Time Dedispersion ... using Auto Tuning", arXiv:1601.01165). This
module times a small grid of candidates over a probe of the bucket's real
delay table (65,536 samples x 64 trials at 64 channels), through the port's
own launches on the card:

* ``dedisp_block``, the segment height of ``dedisperse_host``: per-trial
  time of the dedisperse kernel on the first b trials, b in 8..64;
* the subband count around the planner's (``dedisperse_subband``);
* the engine race: the dedisperse kernel against ``dedisperse_matmul``
  where the planner flags matmul a candidate, and against
  ``dedisperse_subband(use_matmul=True)`` where the plan is subband; the
  fastest measured median wins;
* ``dm_block`` (``normalise_trials`` on b rows) and ``accel_bucket`` (the
  resample kernel, ``resample_rows``, on b rows of 32,768 samples).

The JAX package's ``pallas_block`` (its Pallas resample tile) has no
counterpart: the port's resample kernel has no tile knob, and the field
stays 0 in the plan document.

Winners persist in ``tuning_cache.json``, keyed by the device fingerprint
and the pipeline plus shape bucket (campaign/buckets.py). The file's
schema name and version are the JAX package's, so either package's
validator reads the other's file. The fingerprint (:func:`device_fingerprint`)
starts with ``torch-``, which no JAX fingerprint does, so one file holds
both packages' entries and neither reads the other's knobs, which mean
other things in the two packages. A warm bucket resolves with no
measurement (:func:`measurement_count`); writers replace the file
atomically and the last writer wins.

Where the port departs from the JAX package, by its rule that nothing on
the card falls back: the JAX ``tune_plan`` never raises and its drivers
catch planning failures. Here a kernel that fails to build or launch, or
a measurement that fails, raises and fails the run. Only the file faults
keep the JAX behaviour: a corrupt cache is moved aside to ``*.corrupt``
with a warning and the bucket tunes afresh, and a cache that cannot be
written logs a warning.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..obs.schema import SchemaError, validate
from ..plan.dedisp_plan import DedispPlan
from . import write_json_atomic
from .measure import median, timed_samples

log = logging.getLogger("peasoup_tpu_torch.tuning")

TUNING_SCHEMA = "peasoup_tpu.tuning_cache"
TUNING_VERSION = 1
SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "tuning_cache.schema.json")

# every timed candidate adds one; the warm-bucket contract ("a second
# resolve of a tuned bucket makes no measurement") is held against it
_TUNER_INVOCATIONS = 0

DEFAULT_REPS = 3
# the probe: a slice of the bucket big enough to rank the candidates and
# small enough that the grid takes seconds
PROBE_SAMPLE_BUDGET = 1 << 22
PROBE_MAX_TRIALS = 64
BLOCK_CANDIDATES = (8, 16, 32, 64)
DM_BLOCK_CANDIDATES = (16, 32, 64)
ACCEL_BUCKET_CANDIDATES = (8, 16, 32)


def measurement_count() -> int:
    """Timed tuner measurements this process has made."""
    return _TUNER_INVOCATIONS


def device_fingerprint(device: str | torch.device = "cuda") -> str:
    """The cache's device identity: ``torch-cuda:<card name>:n<local card
    count>`` or ``torch-cpu:cpu:n1``. A tuned knob is a property of one
    card; the count tells a host of several from one. Asking for the card
    where there is none raises (device.py)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return (f"torch-cuda:{torch.cuda.get_device_name(device)}"
                f":n{torch.cuda.device_count()}")
    return "torch-cpu:cpu:n1"


def bucket_key(bucket, pipeline: str) -> str:
    return pipeline + "|" + "|".join(str(x) for x in bucket)


def default_cache_path() -> str:
    """``$PEASOUP_TUNING_CACHE``, else ~/.cache/peasoup_tpu_torch/tuning_cache.json."""
    env = os.environ.get("PEASOUP_TUNING_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "peasoup_tpu_torch", "tuning_cache.json"
    )


# --------------------------------------------------------------------------
# the cache document
# --------------------------------------------------------------------------

def _empty_cache() -> dict:
    return {"schema": TUNING_SCHEMA, "version": TUNING_VERSION, "devices": {}}


def validate_cache(doc: dict) -> None:
    """Validate a tuning-cache document against the schema beside this
    module; raises SchemaError."""
    with open(SCHEMA_PATH) as f:
        schema = json.load(f)
    validate(doc, schema)


def load_cache(path: str) -> dict:
    """The tuning cache at ``path``: empty where the file is missing; where
    it is unreadable or breaks the schema, empty too, with a warning and
    the damaged file moved aside to ``*.corrupt`` (a torn shared file
    re-tunes, it never stops a run)."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != TUNING_SCHEMA:
            raise SchemaError(f"not a {TUNING_SCHEMA} document")
        validate_cache(doc)
        return doc
    except FileNotFoundError:
        return _empty_cache()
    except (OSError, ValueError) as exc:  # JSONDecodeError and SchemaError too
        qpath = path + ".corrupt"
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = None
        log.warning(
            "discarding unreadable tuning cache %s (%s: %.200s)%s; re-tuning from scratch",
            path, type(exc).__name__, exc,
            f"; quarantined to {qpath}" if qpath else "",
        )
        return _empty_cache()


def save_cache(path: str, doc: dict) -> None:
    """Validate the document and replace the cache file atomically."""
    validate_cache(doc)
    write_json_atomic(path, doc, sort_keys=True)


def cache_lookup(doc: dict, fingerprint: str, key: str) -> dict | None:
    return (doc.get("devices", {}).get(fingerprint) or {}).get(key)


def cache_store(doc: dict, fingerprint: str, key: str, plan_doc: dict) -> None:
    # stamped, so that `tune --list/--prune` can report and prune by age
    plan_doc = dict(plan_doc, stored_unix=round(time.time(), 3))
    doc.setdefault("devices", {}).setdefault(fingerprint, {})[key] = plan_doc


# --------------------------------------------------------------------------
# cache hygiene: list entries with their age, prune stale fingerprints
# --------------------------------------------------------------------------

def _row(fp: str, key: str, plan_doc: dict, age, stale: bool) -> dict:
    return {
        "fingerprint": fp,
        "key": key,
        "engine": plan_doc.get("engine"),
        "source": plan_doc.get("source"),
        "dedisp_block": plan_doc.get("dedisp_block"),
        "subbands": plan_doc.get("subbands"),
        "stored_unix": plan_doc.get("stored_unix"),
        "age_s": None if age is None else round(max(0.0, age), 3),
        "stale": stale,
    }


def _age(plan_doc: dict, now: float):
    stored = plan_doc.get("stored_unix")
    return None if stored is None else now - float(stored)


def list_entries(cache_path: str | None = None, device="cuda") -> list[dict]:
    """One row per cached plan: fingerprint, bucket key, the knobs, its age
    and whether its fingerprint is stale (not ``device``'s)."""
    doc = load_cache(cache_path or default_cache_path())
    now = time.time()
    fp_now = device_fingerprint(device)
    return [
        _row(fp, key, plan_doc, _age(plan_doc, now), fp != fp_now)
        for fp, entries in sorted((doc.get("devices") or {}).items())
        for key, plan_doc in sorted(entries.items())
    ]


def prune_cache(
    cache_path: str | None = None,
    *,
    older_than_s: float | None = None,
    keep_stale: bool = False,
    dry_run: bool = False,
    device="cuda",
) -> list[dict]:
    """Remove entries under a stale fingerprint (unless ``keep_stale``)
    and, with ``older_than_s``, entries older than that on any
    fingerprint (an entry without a stamp counts as infinitely old).
    ``dry_run`` reports without rewriting. Returns the removed rows, as
    :func:`list_entries` shapes them. Entries of the JAX package count as
    stale here, as the port's count as stale there."""
    path = cache_path or default_cache_path()
    doc = load_cache(path)
    now = time.time()
    fp_now = device_fingerprint(device)
    removed = []
    devices = doc.get("devices") or {}
    for fp in list(devices):
        for key in list(devices[fp]):
            plan_doc = devices[fp][key]
            age = _age(plan_doc, now)
            stale = fp != fp_now
            too_old = older_than_s is not None and (age is None or age > older_than_s)
            if (stale and not keep_stale) or too_old:
                removed.append(_row(fp, key, plan_doc, age, stale))
                if not dry_run:
                    del devices[fp][key]
        if not dry_run and fp in devices and not devices[fp]:
            del devices[fp]
    if removed and not dry_run:
        save_cache(path, doc)
        log.info("pruned %d tuning-cache entr%s from %s", len(removed),
                 "y" if len(removed) == 1 else "ies", path)
    return removed


# --------------------------------------------------------------------------
# the tuner
# --------------------------------------------------------------------------

def _probe_geometry(dm_plan, nchans: int) -> tuple[int, int]:
    """(output samples, trials) of the probe: the lowest-DM trials, so the
    probe's input stays close to its output, in whole 128-sample blocks."""
    out = int(min(dm_plan.out_nsamps, max(2048, PROBE_SAMPLE_BUDGET // max(1, nchans))))
    out = max(256, (out // 128) * 128)
    ndm = int(min(dm_plan.ndm, PROBE_MAX_TRIALS))
    return out, ndm


def _measure(call, reps: int, device: torch.device) -> float:
    """One tuner measurement: the median of ``reps`` host-clock samples of
    ``call()``, each ending with a synchronise of the device, after one
    untimed call (a first launch loads the kernel). Counts toward
    :func:`measurement_count`; a failure raises."""
    global _TUNER_INVOCATIONS
    call()
    _TUNER_INVOCATIONS += 1
    return median(timed_samples(call, reps, device=device))


def tune_plan(
    plan: DedispPlan,
    dm_plan,
    *,
    nbits: int,
    reps: int = DEFAULT_REPS,
    block_candidates: tuple[int, ...] = BLOCK_CANDIDATES,
    pipeline: str = "search",
    device: str | torch.device = "cuda",
) -> DedispPlan:
    """Refine ``plan``'s knobs on ``device`` by timing candidates over a
    probe of the bucket's delay table (random samples of ``nbits``, seed
    0): the subband count around the planner's where the plan is subband,
    ``dedisp_block``, and for the ``search`` pipeline the engine race and
    ``dm_block`` and ``accel_bucket``; for ``spsearch``, ``dm_block``.
    Every measurement lands in ``plan.trials``. Raises where a launch or a
    measurement fails."""
    from ..ops.dedisperse import dedisperse, dedisperse_subband, output_scale

    device = resolve_device(device)
    t0 = time.perf_counter()
    nchans = len(dm_plan.delays)
    probe_out, probe_ndm = _probe_geometry(dm_plan, nchans)
    if probe_ndm < 1:
        return plan
    delays = dm_plan.delay_samples()[:probe_ndm]
    t_in = probe_out + int(delays.max()) + 1
    rng = np.random.default_rng(0)
    hi = (1 << min(int(nbits), 8)) - 1
    x = torch.from_numpy(
        rng.integers(0, hi + 1, size=(t_in, nchans), dtype=np.uint8)
    ).to(device)
    kill = np.ones(nchans, dtype=np.float32)
    scale = output_scale(int(nbits), nchans)
    trials: list[dict] = []
    engine_meds: dict[str, float] = {}  # medians per engine for the race

    def timed(params: dict, call) -> float:
        med = _measure(call, reps, device)
        trials.append({"params": params, "median_s": round(med, 6)})
        return med

    if plan.engine == "subband":
        cands = sorted({max(2, min(nchans // 2, s))
                        for s in (plan.subbands // 2, plan.subbands, plan.subbands * 2)})
        best = min(
            (timed({"subbands": int(nsub)}, lambda nsub=nsub: dedisperse_subband(
                x, delays, kill, probe_out, nsub=nsub, max_smear=plan.subband_smear,
                scale=scale)), nsub)
            for nsub in cands
        )
        plan.subbands = int(best[1])
        plan.source = "tuned"
        engine_meds["subband"] = best[0]
    # dedisp_block ranks segment heights by the per-trial time of one
    # dedisperse launch over that many trials (one segment's work)
    best_b = None
    for b in sorted({min(b, probe_ndm) for b in block_candidates}):
        med = timed({"dedisp_block": int(b)},
                    lambda b=b: dedisperse(x, delays[:b], kill, probe_out, scale=scale))
        if best_b is None or med / b < best_b[1]:
            best_b = (b, med / b)
    plan.dedisp_block = int(best_b[0])
    plan.source = "tuned"
    if pipeline == "search":
        _race_engines(plan, timed, engine_meds, x, delays, kill, probe_out, scale)
        _tune_search_knobs(plan, timed, probe_out, device)
    elif pipeline == "spsearch":
        _tune_dm_block_knob(plan, timed, probe_out, device)
    plan.trials = trials
    plan.tuning_s = round(time.perf_counter() - t0, 3)
    return plan


def _race_engines(plan, timed, engine_meds, x, delays, kill, probe_out, scale) -> None:
    """The engine race over the probe: the dedisperse kernel always, the
    banded matmul where the planner flagged it a candidate, subband with
    matmul stages where the parity gate approved subband. Each is
    parity-safe (matmul is bitwise the exact sum; subband passed the
    gate), so the fastest measured median wins."""
    from ..ops.dedisperse import dedisperse, dedisperse_matmul, dedisperse_subband

    def race(name: str, call) -> None:
        engine_meds[name] = timed({"engine": name}, call)

    race("exact", lambda: dedisperse(x, delays, kill, probe_out, scale=scale))
    if plan.matmul_candidate or plan.engine == "matmul":
        race("matmul", lambda: dedisperse_matmul(x, delays, kill, probe_out, scale=scale))
    if plan.engine == "subband" and plan.subbands:
        race("subband_matmul", lambda: dedisperse_subband(
            x, delays, kill, probe_out, nsub=plan.subbands, max_smear=plan.subband_smear,
            scale=scale, use_matmul=True))
    current = plan.engine if plan.engine in engine_meds else "exact"
    winner = min(engine_meds, key=engine_meds.get)
    if winner != current and engine_meds[winner] < engine_meds.get(current, float("inf")):
        if winner == "subband_matmul":
            plan.engine, plan.subband_matmul = "subband", True
        else:
            plan.engine, plan.subband_matmul = winner, False
        plan.source = "tuned"
    log.info("dedispersion engine race: %s (measured %s)",
             plan.engine + (" [matmul stages]" if plan.subband_matmul else ""),
             {k: round(v, 5) for k, v in engine_meds.items()})


def _tune_dm_block_knob(plan, timed, probe_out: int, device) -> None:
    """Rank DM-block heights by the per-trial time of the single-pulse
    normaliser (the head of every block's chain) on b probe rows."""
    from ..ops.singlepulse import normalise_trials

    rng = np.random.default_rng(1)
    n = int(min(probe_out, 1 << 16))
    best = None
    for b in DM_BLOCK_CANDIDATES:
        xb = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(device)
        med = timed({"dm_block": int(b)}, lambda xb=xb: normalise_trials(xb))
        if best is None or med / b < best[1]:
            best = (b, med / b)
    plan.dm_block = int(best[0])
    plan.source = "tuned"


def _tune_search_knobs(plan, timed, probe_out: int, device) -> None:
    """The search's knobs: ``dm_block`` (:func:`_tune_dm_block_knob`) and
    ``accel_bucket``, ranked by the per-row time of the resample kernel
    (``resample_rows``, the port's counterpart of the JAX package's
    ``resample_accel``) on b rows of one series: row_dm of zeros and the
    JAX package's acceleration-factor grid. The JAX package's Pallas tile
    (``pallas_block``) has no counterpart and stays 0."""
    from ..ops.resample import resample_rows

    _tune_dm_block_knob(plan, timed, probe_out, device)
    rng = np.random.default_rng(2)
    n = int(min(max(1024, probe_out), 1 << 15))
    x = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).to(device)
    best = None
    for b in ACCEL_BUCKET_CANDIDATES:
        af = 0.5 / (n * 64)
        afs = torch.from_numpy(np.linspace(-af, af, b).astype(np.float32)).to(device)
        row_dm = torch.zeros(b, dtype=torch.int32, device=device)
        med = timed({"accel_bucket": int(b)},
                    lambda afs=afs, row_dm=row_dm: resample_rows(x, row_dm, afs))
        if best is None or med / b < best[1]:
            best = (b, med / b)
    plan.accel_bucket = int(best[0])
    plan.source = "tuned"


# --------------------------------------------------------------------------
# plan resolution: bucket -> cached or freshly tuned DedispPlan
# --------------------------------------------------------------------------

def _dm_plan_for_bucket(bucket, overrides: dict):
    from ..plan.dm_plan import DMPlan

    nchans, _nbits, nsamps, tsamp, fch1, foff = bucket
    return DMPlan.create(
        nsamps=int(nsamps), nchans=int(nchans), tsamp=float(tsamp), fch1=float(fch1),
        foff=float(foff), dm_start=float(overrides.get("dm_start", 0.0)),
        dm_end=float(overrides.get("dm_end", 100.0)),
        pulse_width=float(overrides.get("dm_pulse_width", 64.0)),
        tol=float(overrides.get("dm_tol", 1.10)),
    )


def resolve_plan_for_bucket(
    bucket,
    pipeline: str,
    overrides: dict,
    cache_path: str | None = None,
    *,
    tune: bool = True,
    reps: int = DEFAULT_REPS,
    force: bool = False,
    device: str | torch.device = "cuda",
) -> DedispPlan:
    """The measure -> decide -> cache -> reuse loop for one shape bucket on
    ``device``. A warm (fingerprint, bucket) entry returns the cached plan
    (``source`` "cache") with no measurement; a cold one is selected
    analytically (plan/dedisp_plan.py), tuned on the device where
    ``tune``, and stored."""
    device = resolve_device(device)
    cache_path = cache_path or default_cache_path()
    fp = device_fingerprint(device)
    key = bucket_key(bucket, pipeline)
    doc = load_cache(cache_path)
    if not force:
        hit = cache_lookup(doc, fp, key)
        if hit is not None:
            plan = DedispPlan.from_doc(hit)
            plan.source = "cache"
            log.info("tuning cache hit for %s on %s: %s", key, fp, plan.summary())
            return plan
    nchans, nbits = int(bucket[0]), int(bucket[1])
    dm_plan = _dm_plan_for_bucket(bucket, overrides)
    if pipeline == "search" and not overrides.get("subbands"):
        plan = DedispPlan.select(
            dm_plan, nbits=nbits, tsamp=float(bucket[3]), fch1=float(bucket[4]),
            foff=float(bucket[5]),
            max_smear=float(overrides.get("subband_smear", 1.0)),
            max_snr_loss=float(overrides.get("subband_snr_loss", 0.1)),
            pulse_width_us=float(overrides.get("dm_pulse_width", 64.0)),
        )
    else:
        # the single-pulse search has no subband path, and an explicit
        # subband count is the operator's: only the block knobs tune
        plan = DedispPlan(
            engine="exact",
            cost_exact=float(dm_plan.ndm) * nchans * max(1, dm_plan.out_nsamps),
        )
    if tune:
        plan = tune_plan(plan, dm_plan, nbits=nbits, reps=reps, pipeline=pipeline,
                         device=device)
    cache_store(doc, fp, key, plan.to_doc())
    try:
        save_cache(cache_path, doc)
    except OSError as exc:
        log.warning("could not persist tuning cache %s: %.200s", cache_path, exc)
    log.info("tuned plan for %s on %s: %s", key, fp, plan.summary())
    return plan


def resolve_plan_for_filterbank(
    fil, pipeline: str, cfg, cache_path: str | None = None, *,
    device: str | torch.device = "cuda",
) -> DedispPlan:
    """The drivers' entry: the observation's shape bucket (the campaign's
    bucketing, so a CLI run and a campaign worker share cache entries) and
    its plan on ``device``."""
    from ..campaign.buckets import bucket_for_header

    hdr = dataclasses.replace(fil.header, nsamples=fil.nsamps)
    return resolve_plan_for_bucket(
        bucket_for_header(hdr), pipeline, dataclasses.asdict(cfg), cache_path or None,
        device=device,
    )
