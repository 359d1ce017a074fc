"""Scientific data-quality sentinels for survey campaigns.

Fleet metrics (obs/metrics.py) say whether the MACHINERY is healthy;
nothing said whether the SCIENCE is: an RFI storm that zaps half the
band, a dead receiver polarisation, or a silently broken search all
complete "successfully". This module is the scientific health layer:

- :func:`observation_quality` — cheap per-job gauges computed from the
  filterbank already in memory (a bounded host-side pass, never the
  full observation): dead/RFI channel occupancy via robust per-channel
  statistics, quantisation clip/saturation fraction, and the
  candidate-rate per DM trial that PulsarX-style triage treats as the
  first-class RFI signal.
- per-campaign **baselines** — median/MAD of each gauge across the
  campaign's completed jobs (robust: one storm does not drag the
  baseline), and :func:`quality_findings` flagging jobs whose gauges
  sit beyond a z-score threshold — the ``data_quality`` alert feed.
- the **injection sentinel** — :func:`enqueue_sentinel` writes a
  synthetic observation with one dispersed pulse of KNOWN DM/arrival
  time (the chaos tool's injection recipe), enqueues it at low
  priority (it must never displace real observations), and records the
  ground truth under ``<root>/queue/sentinels/``;
  :func:`sentinel_status` checks each completed sentinel against the
  candidate database — an unrecovered injection means the search
  itself is broken, which no infrastructure metric can see — and
  :func:`sentinel_findings` turns misses into the ``sentinel`` alert
  feed.

Everything here is advisory: quality computation failures degrade to
"no gauges", never to a failed job.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
import uuid

import numpy as np

from .log import get_logger

log = get_logger("obs.health")

# the per-job gauges fed into campaign baselines (and recorded as
# dq_<name> metrics gauges by the runner)
QUALITY_METRICS = ("zap_fraction", "clip_fraction", "candidate_rate")

# MAD floors per metric: a perfectly clean campaign has zero spread,
# and a zero MAD would turn any nonzero gauge into an infinite z-score
_MAD_FLOOR = {
    "zap_fraction": 0.02,
    "clip_fraction": 0.02,
    "candidate_rate": 0.25,
}

# robust z threshold for a data_quality finding, and the minimum
# campaign size before baselines mean anything
DEFAULT_Z = 6.0
DEFAULT_MIN_N = 4

_SENTINELS = "sentinels"  # truth docs live under <root>/queue/sentinels/


# --------------------------------------------------------------------------
# per-observation quality gauges
# --------------------------------------------------------------------------

def observation_quality(
    data: np.ndarray,
    n_candidates: int = 0,
    n_dm_trials: int = 1,
    nbits: int | None = None,
    max_samples: int = 8192,
) -> dict:
    """Quality gauges for one observation's ``(nsamps, nchans)`` block.

    A strided subset of at most ``max_samples`` time samples keeps the
    cost bounded for long observations; the statistics are robust
    (median/MAD across channels), so the injected pulse itself never
    reads as RFI.
    """
    arr = np.asarray(data)
    if arr.ndim != 2 or arr.size == 0:
        return {}
    step = max(1, arr.shape[0] // int(max_samples))
    block = arr[::step].astype(np.float32)
    nchans = block.shape[1]

    ch_mean = block.mean(axis=0)
    ch_std = block.std(axis=0)
    med_std = float(np.median(ch_std))
    dead = ch_std < max(1e-6, 0.05 * med_std)

    # channel-power outliers: robust z of per-channel mean across the
    # band (a persistent narrowband carrier lifts the whole channel)
    med_mean = float(np.median(ch_mean))
    mad_mean = float(np.median(np.abs(ch_mean - med_mean)))
    mad_mean = max(mad_mean, 1e-3 * max(abs(med_mean), 1.0))
    z_power = np.abs(ch_mean - med_mean) / (1.4826 * mad_mean)
    # variance outliers catch impulsive RFI that keeps the mean flat
    mad_std = float(np.median(np.abs(ch_std - med_std)))
    mad_std = max(mad_std, 1e-3 * max(med_std, 1.0))
    z_var = np.abs(ch_std - med_std) / (1.4826 * mad_std)
    rfi = (~dead) & ((z_power > 8.0) | (z_var > 8.0))

    clip = 0.0
    if np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(arr.dtype)
        hi = (1 << int(nbits)) - 1 if nbits else info.max
        lo = info.min
        clip = float(np.mean((block <= lo) | (block >= hi)))
    elif np.issubdtype(arr.dtype, np.floating):
        clip = float(np.mean(~np.isfinite(block)))

    return {
        "zap_fraction": float((dead.sum() + rfi.sum()) / nchans),
        "dead_channels": float(dead.sum()),
        "rfi_channels": float(rfi.sum()),
        "clip_fraction": clip,
        "candidate_rate": float(n_candidates)
        / float(max(1, n_dm_trials)),
        "nchans": float(nchans),
    }


# --------------------------------------------------------------------------
# campaign baselines + findings
# --------------------------------------------------------------------------

def _quality_records(done_records: list[dict]) -> list[tuple[str, dict]]:
    """(job_id, quality) for real (non-sentinel) completed jobs."""
    out = []
    for rec in done_records or []:
        if rec.get("sentinel"):
            continue  # injections must not drag the science baseline
        q = rec.get("quality")
        if isinstance(q, dict) and q:
            out.append((str(rec.get("job_id", "?")), q))
    return out


def build_baselines(done_records: list[dict]) -> dict:
    """Median/MAD per quality metric across the campaign's completed
    jobs — the robust envelope a single storm cannot shift."""
    recs = _quality_records(done_records)
    out: dict = {}
    for metric in QUALITY_METRICS:
        vals = sorted(
            float(q[metric]) for _, q in recs
            if isinstance(q.get(metric), (int, float))
            and math.isfinite(float(q[metric]))
        )
        if not vals:
            continue
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        out[metric] = {
            "median": med,
            "mad": mad,
            "n": len(vals),
        }
    return out


def quality_findings(
    done_records: list[dict],
    baselines: dict | None = None,
    z_threshold: float = DEFAULT_Z,
    min_n: int = DEFAULT_MIN_N,
) -> list[dict]:
    """Jobs whose quality gauges sit beyond ``z_threshold`` robust
    z-scores from the campaign baseline — the ``data_quality`` alert
    feed, in the engine's finding shape."""
    recs = _quality_records(done_records)
    if baselines is None:
        baselines = build_baselines(done_records)
    findings: list[dict] = []
    for metric in QUALITY_METRICS:
        base = baselines.get(metric)
        if not base or int(base.get("n", 0)) < int(min_n):
            continue
        scale = 1.4826 * max(
            float(base["mad"]), _MAD_FLOOR.get(metric, 0.05)
        )
        for job_id, q in recs:
            v = q.get(metric)
            if not isinstance(v, (int, float)) or not math.isfinite(
                float(v)
            ):
                continue
            z = (float(v) - float(base["median"])) / scale
            if abs(z) < float(z_threshold):
                continue
            findings.append({
                "labels": {"metric": metric, "job": job_id},
                "value": round(z, 3),
                "message": (
                    f"{metric}={float(v):.4g} on {job_id} is "
                    f"{z:+.1f} MADs from the campaign median "
                    f"{float(base['median']):.4g} (n={base['n']})"
                ),
            })
    return findings


def data_quality_summary(done_records: list[dict]) -> dict:
    """The rollup's ``data_quality`` section: baselines + outliers."""
    baselines = build_baselines(done_records)
    findings = quality_findings(done_records, baselines=baselines)
    return {
        "jobs": len(_quality_records(done_records)),
        "baselines": baselines,
        "outliers": findings,
    }


# --------------------------------------------------------------------------
# the injection sentinel
# --------------------------------------------------------------------------

def write_sentinel_observation(
    path: str,
    nsamps: int = 1 << 12,
    nchans: int = 8,
    seed: int = 7,
    amplitude: float = 15.0,
) -> dict:
    """Write one synthetic filterbank with a single dispersed pulse of
    known DM and arrival time (the chaos tool's injection recipe) and
    return the ground truth the recovery check needs."""
    from ..io.sigproc import (
        Filterbank,
        SigprocHeader,
        write_filterbank,
    )
    from ..plan.dm_plan import DMPlan

    tsamp, fch1, foff = 0.000256, 1400.0, -16.0
    plan = DMPlan.create(
        nsamps=nsamps, nchans=nchans, tsamp=tsamp, fch1=fch1, foff=foff,
        dm_start=0.0, dm_end=20.0, pulse_width=64.0, tol=1.10,
    )
    dm_idx = plan.ndm // 2
    delays = plan.delay_samples()[dm_idx]
    rng = np.random.default_rng(seed)
    data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
    s0 = nsamps // 3
    for c in range(nchans):
        data[s0 + delays[c] : s0 + 4 + delays[c], c] += amplitude
    hdr = SigprocHeader(
        source_name="SENTINEL", tsamp=tsamp, tstart=55999.0,
        fch1=fch1, foff=foff, nchans=nchans, nbits=8, nifs=1,
        data_type=1,
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_filterbank(
        path,
        Filterbank(
            header=hdr,
            data=np.clip(np.rint(data), 0, 255).astype(np.uint8),
        ),
    )
    return {
        "input": os.path.abspath(path),
        "dm": float(plan.dm_list[dm_idx]),
        "time_s": float(s0 * tsamp),
        "nsamps": int(nsamps),
    }


def _sentinel_dir(root: str) -> str:
    return os.path.join(os.path.abspath(root), "queue", _SENTINELS)


def _atomic_write_json(path: str, doc: dict) -> None:
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def enqueue_sentinel(
    root: str,
    queue=None,
    data_dir: str | None = None,
    min_snr: float = 7.0,
    dm_tol: float = 5.0,
    time_tol_s: float = 0.05,
    priority: int = -1,
    nsamps: int = 1 << 12,
    seed: int | None = None,
) -> dict:
    """Inject one sentinel observation into a campaign: write the
    synthetic filterbank, enqueue it at low priority (it must never
    displace survey observations), and persist the ground truth for
    :func:`sentinel_status`. Returns the truth doc."""
    from ..campaign.queue import Job, JobQueue, job_id_for
    from ..campaign.runner import bucket_for_input

    root = os.path.abspath(root)
    if queue is None:
        queue = JobQueue(root)
    data_dir = data_dir or os.path.join(root, "sentinel_data")
    tag = uuid.uuid4().hex[:10]
    path = os.path.join(data_dir, f"sentinel_{tag}.fil")
    truth = write_sentinel_observation(
        path, nsamps=nsamps,
        seed=int(seed) if seed is not None else int(tag[:6], 16),
    )
    job_id = job_id_for(path)
    queue.add_job(Job(
        job_id=job_id,
        input=path,
        pipeline="spsearch",
        bucket=bucket_for_input(path),
        priority=int(priority),
        sentinel=True,
    ))
    doc = {
        **truth,
        "job_id": job_id,
        "min_snr": float(min_snr),
        "dm_tol": float(dm_tol),
        "time_tol_s": float(time_tol_s),
        "enqueued_unix": time.time(),
    }
    _atomic_write_json(
        os.path.join(_sentinel_dir(root), f"{job_id}.json"), doc
    )
    log.info(
        "sentinel enqueued: %s (dm %.2f, t %.3fs, min snr %.1f)",
        job_id, doc["dm"], doc["time_s"], doc["min_snr"],
    )
    return doc


def _sentinel_recovered(root: str, truth: dict) -> tuple[bool, str]:
    """Did the candidate database recover the injected pulse?"""
    from ..campaign.db import DB_FILENAME, CandidateDB

    db_path = os.path.join(root, DB_FILENAME)
    if not os.path.exists(db_path):
        return False, "candidate database missing"
    try:
        with CandidateDB(db_path) as db:
            cands = db.candidates_for(truth["job_id"])
    except Exception as exc:
        return False, f"candidate database unreadable: {exc!s:.120}"
    for c in cands:
        if c.get("kind") != "single_pulse":
            continue
        snr = float(c.get("snr") or 0.0)
        dm = float(c.get("dm") or 0.0)
        t = float(c.get("time_s") or -1e9)
        if (
            snr >= float(truth.get("min_snr", 0.0))
            and abs(dm - float(truth["dm"])) <= float(
                truth.get("dm_tol", 5.0)
            )
            and abs(t - float(truth["time_s"])) <= float(
                truth.get("time_tol_s", 0.05)
            )
        ):
            return True, (
                f"recovered at dm {dm:.2f}, t {t:.3f}s, snr {snr:.1f}"
            )
    return False, (
        f"no candidate within dm±{truth.get('dm_tol', 5.0):.1f} / "
        f"t±{truth.get('time_tol_s', 0.05):.3f}s at snr>="
        f"{truth.get('min_snr', 0.0):.1f} among {len(cands)}"
    )


def sentinel_status(root: str, queue=None) -> list[dict]:
    """Recovery status of every sentinel injection in a campaign:
    ``pending`` (not yet searched), ``recovered``, or ``missed``
    (searched but the known pulse did not come back — the search is
    broken)."""
    root = os.path.abspath(root)
    sdir = _sentinel_dir(root)
    try:
        names = sorted(
            n for n in os.listdir(sdir) if n.endswith(".json")
        )
    except OSError:
        return []
    out = []
    for name in names:
        truth = _read_json(os.path.join(sdir, name))
        if not truth or "job_id" not in truth:
            continue
        jid = truth["job_id"]
        done = _read_json(
            os.path.join(root, "queue", "done", f"{jid}.json")
        )
        ent = {
            "job_id": jid,
            "dm": truth.get("dm"),
            "time_s": truth.get("time_s"),
            "min_snr": truth.get("min_snr"),
            "enqueued_unix": truth.get("enqueued_unix"),
        }
        if done is None:
            quarantined = os.path.exists(
                os.path.join(root, "queue", "quarantine", f"{jid}.json")
            )
            if quarantined:
                ent.update(
                    status="missed",
                    detail="sentinel job quarantined before searching",
                )
            else:
                ent["status"] = "pending"
            out.append(ent)
            continue
        ok, detail = _sentinel_recovered(root, truth)
        ent.update(
            status="recovered" if ok else "missed", detail=detail
        )
        out.append(ent)
    return out


def sentinel_findings(root: str, queue=None) -> list[dict]:
    """Missed sentinels in the alert engine's finding shape."""
    out = []
    for ent in sentinel_status(root, queue=queue):
        if ent.get("status") != "missed":
            continue
        out.append({
            "labels": {"job": str(ent["job_id"])},
            "value": 1.0,
            "message": (
                f"sentinel injection {ent['job_id']} not recovered: "
                f"{ent.get('detail', '')}"
            ),
        })
    return out
