"""The ``peasoup-sift run`` orchestration (the JAX package's
sift/service.py).

One run consumes the campaign candidate database end to end:

  load -> re-dedisperse each observation at its candidates' DMs (the
  dedisperse kernel on the card) -> batch-fold (sift/fold.py) ->
  known-pulsar cross-match -> multi-beam coincidence veto ->
  campaign-level harmonic/DM dedup (sky-position gated) -> calibrated
  candidate scoring (rank/, a DM-curve refold + batched features) ->
  repeat single-pulse association -> one transaction writing the
  ``sift_*`` tables.

Re-running replaces the previous sifted product wholesale (latest run
wins). Each pass's wall time lands in :attr:`SiftRun.timers` under the
JAX package's timer names (``sift_folding``, ``sift_crossmatch``,
``sift_dedup``, ``sift_scoring``, ``sift_repeats``); the run telemetry
and status section the JAX package records are ROADMAP item A.10. Both
folds (the survey fold and the DM-curve refold) go through
parallel/multihost.py:run_survey_fold, which splits the observations over
the processes of a multi-process run.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import uuid

import numpy as np
import torch

from ..campaign.db import DB_FILENAME, CandidateDB
from ..device import resolve_device
from ..io.sigproc import read_filterbank
from ..ops.candidate_features import DM_CURVE_FRACTIONS
from ..ops.dedisperse import dedisperse, fil_to_device, output_scale
from ..parallel.multihost import run_survey_fold
from ..plan.dm_plan import delay_table
from ..rank.model import RankModel, score_tier
from ..rank.score import score_fold_products
from .crossmatch import load_catalogue, match_candidate
from .dedup import dedup_candidates, multibeam_veto
from .fold import FoldCandidate, FoldObservation, SurveyFolder
from .repeats import repeat_sources

log = logging.getLogger("peasoup_tpu_torch.sift.service")


@dataclasses.dataclass
class SiftConfig:
    """Knobs for one sift run (persisted in the ``sift_runs`` row)."""

    workdir: str = "."  # campaign root (holds candidates.sqlite)
    db_path: str = ""  # explicit DB override
    # batched survey folding
    fold: bool = True
    fold_batch: int = 64  # candidates per fixed device batch
    fold_nbins: int = 64
    fold_nints: int = 16
    max_fold_per_obs: int = 256  # top-N by S/N folded per observation
    fold_snr_min: float = 6.0  # folded S/N confirming a candidate
    # adopt the optimiser's refined period only when the observation
    # spans at least this many pulses — the phase-shift period update
    # is meaningless when the fold holds a handful of rotations
    opt_period_min_pulses: float = 16.0
    # known-pulsar cross-match
    catalogue: str = ""  # "" = the checked-in convenience catalogue
    max_harm: int = 16
    period_tol: float = 2e-3
    dm_tol: float = 2.0
    dm_tol_frac: float = 0.05
    # campaign-level dedup
    dedup_max_harm: int = 8
    dedup_period_tol: float = 2e-3
    dedup_dm_tol: float = 2.0
    # multi-beam coincidence veto
    beam_thresh: int = 4
    coinc_snr: float = 6.0
    # repeat single-pulse association
    sp_dm_tol: float = 1.0
    sp_min_pulses: int = 3
    sp_min_obs: int = 2
    sp_min_period: float = 0.05
    sp_max_harm: int = 1000
    sp_phase_tol: float = 0.02
    # sky-position association gates (degrees; <= 0 disables): members
    # must lie within this angular separation to merge into one source
    # — a harmonic coincidence between opposite sky poles is not one
    # pulsar. Generous default: adjacent beams of one pointing pass,
    # antipodal detections never do.
    dedup_pos_tol_deg: float = 3.0
    sp_pos_tol_deg: float = 3.0
    # candidate ranking (peasoup-rank): score every catalogue row with
    # fold products through the calibrated model artifact
    score: bool = True
    score_model: str = ""  # "" = the checked-in default artifact
    score_batch: int = 64
    # per-tenant slice: sift only observations stamped with this tenant
    tenant: str = ""

    def resolved_db(self) -> str:
        return self.db_path or os.path.join(self.workdir, DB_FILENAME)


class SiftRun:
    """One sift pass over a campaign database, on ``device`` (the card
    unless the caller asks for the CPU; no step moves to the CPU)."""

    def __init__(self, cfg: SiftConfig, device: str | torch.device = "cuda") -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        # each pass's wall time (s), under the JAX package's timer names
        self.timers: dict[str, float] = {}
        # the shape buckets each fold pass folded ("survey", "dm_curve")
        self.fold_buckets: dict[str, list] = {}

    def _timer(self, name: str, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timers[name] = time.perf_counter() - t0

    # --- fold input assembly ------------------------------------------
    def build_fold_inputs(
        self, obs_rows: list[dict], cands: list[dict]
    ) -> list[FoldObservation]:
        """Re-dedisperse each observation at its candidates' DMs and
        package the survey folder's inputs. A missing/unreadable input
        file skips that observation (the sift must survive an archive
        where raw data has been aged out). The trials are u8 rows on the
        run's device: the dedisperse kernel's output on the card."""
        by_job: dict[str, list[dict]] = {}
        for c in cands:
            by_job.setdefault(c["job_id"], []).append(c)
        out: list[FoldObservation] = []
        for obs in obs_rows:
            rows = by_job.get(obs["job_id"])
            if not rows:
                continue
            rows = sorted(
                rows, key=lambda c: -float(c.get("snr") or 0.0)
            )[: self.cfg.max_fold_per_obs]
            try:
                fil = read_filterbank(obs["input"])
            except Exception as exc:
                log.warning(
                    "skipping %s: cannot read %s (%s)",
                    obs["job_id"], obs.get("input"), exc,
                )
                continue
            hdr = fil.header
            # the dedisp-parity delay table at this observation's
            # geometry; one trial per distinct candidate DM
            per_unit = np.abs(
                delay_table(hdr.fch1, hdr.foff, hdr.nchans, hdr.tsamp)
            )
            dms = sorted({float(c["dm"]) for c in rows})
            dm_row = {dm: i for i, dm in enumerate(dms)}
            prod = (
                np.asarray(dms, dtype=np.float32)[:, None]
                * per_unit[None, :]
            ).astype(np.float32)
            delays = np.rint(prod).astype(np.int32)
            max_delay = int(delays.max()) if delays.size else 0
            out_nsamps = fil.nsamps - max_delay
            if out_nsamps < 64:
                log.warning("skipping %s: too short after dedispersion (%d samples)",
                            obs["job_id"], out_nsamps)
                continue
            trials = dedisperse(
                fil_to_device(fil, self.device), delays,
                np.ones(hdr.nchans, dtype=np.float32), out_nsamps,
                scale=output_scale(hdr.nbits, hdr.nchans),
            )
            out.append(
                FoldObservation(
                    job_id=obs["job_id"],
                    trials=trials,
                    trials_nsamps=out_nsamps,
                    tsamp=float(hdr.tsamp),
                    cands=[
                        FoldCandidate(
                            key=c["id"],
                            period=float(c["period"]),
                            acc=float(c.get("acc") or 0.0),
                            dm_row=dm_row[float(c["dm"])],
                        )
                        for c in rows
                    ],
                )
            )
        return out

    # --- candidate ranking --------------------------------------------
    def _dm_curve_refold(
        self, scorable: list[tuple[int, dict]], obs_rows: list[dict]
    ) -> dict[int, np.ndarray]:
        """Refold each scored lead at fractions of its own DM (same
        batched survey-fold path, synthetic candidate keys): the curve
        of optimised S/N over trial DM peaks at the candidate DM for a
        celestial signal and at zero for terrestrial interference — the
        scorer's strongest discriminant. Returns row-index -> curve."""
        cfg = self.cfg
        ndm = len(DM_CURVE_FRACTIONS)
        per_obs_cap = max(1, cfg.max_fold_per_obs // ndm)
        synth: list[dict] = []
        per_job: dict[str, int] = {}
        for ridx, lead in scorable:
            jid = lead["job_id"]
            if per_job.get(jid, 0) >= per_obs_cap:
                continue
            per_job[jid] = per_job.get(jid, 0) + 1
            for fi, frac in enumerate(DM_CURVE_FRACTIONS):
                synth.append(
                    {
                        "id": ridx * ndm + fi,
                        "job_id": jid,
                        "dm": float(frac) * float(lead["dm"]),
                        "period": float(lead["eff_period"]),
                        "acc": float(lead.get("acc") or 0.0),
                        "snr": float(lead.get("snr") or 0.0),
                    }
                )
        if not synth:
            return {}
        fold_inputs = self.build_fold_inputs(obs_rows, synth)
        folder = SurveyFolder(
            nbins=cfg.fold_nbins, nints=cfg.fold_nints,
            batch=cfg.fold_batch,
        )
        curves: dict[int, np.ndarray] = {}
        outcomes = run_survey_fold(fold_inputs, folder)
        self.fold_buckets["dm_curve"] = folder.buckets
        for o in outcomes:
            ridx, fi = divmod(int(o["key"]), ndm)
            curves.setdefault(
                ridx, np.zeros(ndm, dtype=np.float32)
            )[fi] = float(o["opt_sn"])
        return curves

    def _score_catalogue(
        self,
        catalogue_rows: list[dict],
        row_leads: list[tuple[int, dict]],
        outcomes_by_key: dict,
        obs_rows: list[dict],
    ) -> int:
        """Attach calibrated scores, triage tiers, and the model
        fingerprint to every catalogue row with fold products. The DM
        curve lands in the row's fold stamp so ``peasoup-rank score``
        can re-score the database later without raw data."""
        cfg = self.cfg
        scorable = [
            (ridx, lead)
            for ridx, lead in row_leads
            if outcomes_by_key.get(lead["id"]) is not None
        ]
        if not scorable:
            return 0
        model = RankModel.from_file(cfg.score_model or None)
        curves = self._dm_curve_refold(scorable, obs_rows)
        ndm = len(DM_CURVE_FRACTIONS)
        prof = np.stack(
            [
                np.asarray(
                    outcomes_by_key[lead["id"]]["opt_prof"],
                    dtype=np.float32,
                )
                for _, lead in scorable
            ]
        )
        subints = np.stack(
            [
                np.asarray(
                    outcomes_by_key[lead["id"]]["opt_fold"],
                    dtype=np.float32,
                )
                for _, lead in scorable
            ]
        )
        dm_curve = np.stack(
            [
                curves.get(ridx, np.zeros(ndm, dtype=np.float32))
                for ridx, _ in scorable
            ]
        )
        _feats, scores = score_fold_products(
            model, prof, subints, dm_curve, batch=cfg.score_batch,
            device=self.device,
        )
        for (ridx, _), p, curve in zip(scorable, scores, dm_curve):
            row = catalogue_rows[ridx]
            row["score"] = round(float(p), 6)
            row["score_tier"] = score_tier(float(p))
            row["model_fp"] = model.fingerprint
            if row.get("fold") is not None:
                row["fold"]["dm_curve"] = [
                    round(float(v), 3) for v in curve
                ]
        log.info(
            "scored %d/%d catalogue rows (model %s)",
            len(scorable), len(catalogue_rows), model.fingerprint,
        )
        return len(scorable)

    # --- the run -------------------------------------------------------
    def run(self) -> dict:
        cfg = self.cfg
        t_run = time.perf_counter()
        db_path = cfg.resolved_db()
        if not os.path.exists(db_path):
            raise FileNotFoundError(
                f"no campaign database at {db_path} (run the campaign "
                "and `peasoup-campaign ingest` first)"
            )
        run_id = uuid.uuid4().hex[:12]

        with CandidateDB(db_path) as db:
            obs_rows = db.observations()
            watermark_rowid = db.max_observation_rowid()
            periodicity = db.all_candidates("periodicity")
            single_pulse = db.all_candidates("single_pulse")
            if cfg.tenant:
                # per-tenant slice: only observations stamped with this
                # tenant (and their candidates) enter the sift
                keep = {
                    o["job_id"]
                    for o in obs_rows
                    if (o.get("tenant") or "") == cfg.tenant
                }
                obs_rows = [o for o in obs_rows if o["job_id"] in keep]
                periodicity = [
                    c for c in periodicity if c["job_id"] in keep
                ]
                single_pulse = [
                    c for c in single_pulse if c["job_id"] in keep
                ]

            # --- batched survey folding --------------------------------
            outcomes_by_key: dict = {}
            n_folded = 0
            if cfg.fold and periodicity:
                t0 = time.perf_counter()
                fold_inputs = self.build_fold_inputs(
                    obs_rows, periodicity
                )
                folder = SurveyFolder(
                    nbins=cfg.fold_nbins, nints=cfg.fold_nints,
                    batch=cfg.fold_batch,
                )
                outcomes = run_survey_fold(fold_inputs, folder)
                self.fold_buckets["survey"] = folder.buckets
                outcomes_by_key = {o["key"]: o for o in outcomes}
                n_folded = len(outcomes)
                self._timer("sift_folding", t0)

            # effective parameters post-fold: the optimiser's refined
            # period and S/N supersede the search's trial values
            for c in periodicity:
                o = outcomes_by_key.get(c["id"])
                c["eff_period"] = float(c["period"] or 0.0)
                if o is not None:
                    c["folded_snr"] = float(o["opt_sn"])
                    c["opt_period"] = float(o["opt_period"])
                    trial_p = float(c["period"] or 0.0)
                    if (
                        trial_p > 0
                        and o["tobs"]
                        >= cfg.opt_period_min_pulses * trial_p
                    ):
                        c["eff_period"] = float(o["opt_period"])

            # --- known-pulsar cross-match ------------------------------
            t0 = time.perf_counter()
            catalogue = load_catalogue(cfg.catalogue or None)
            known_matches: list[dict] = []
            match_by_id: dict = {}
            for c in periodicity:
                m = match_candidate(
                    c["eff_period"], float(c["dm"]), catalogue,
                    max_harm=cfg.max_harm, period_tol=cfg.period_tol,
                    dm_tol=cfg.dm_tol, dm_tol_frac=cfg.dm_tol_frac,
                )
                if m is not None:
                    match_by_id[c["id"]] = m
                    known_matches.append(
                        dict(m, candidate_id=c["id"], job_id=c["job_id"])
                    )
            self._timer("sift_crossmatch", t0)

            # --- multi-beam coincidence veto ---------------------------
            vetoed = multibeam_veto(
                [
                    {
                        "id": c["id"], "period": c["eff_period"],
                        "dm": c["dm"], "snr": c["snr"],
                        "beam": c.get("beam"),
                    }
                    for c in periodicity
                ],
                snr_thresh=cfg.coinc_snr,
                beam_thresh=cfg.beam_thresh,
                period_tol=cfg.dedup_period_tol,
                dm_cell=cfg.dedup_dm_tol,
                device=self.device,
            )

            # --- campaign-level dedup ----------------------------------
            t0 = time.perf_counter()
            groups = dedup_candidates(
                [
                    {
                        "id": c["id"], "job_id": c["job_id"],
                        "period": c["eff_period"], "dm": c["dm"],
                        "snr": c["snr"],
                        "src_raj": c.get("src_raj"),
                        "src_dej": c.get("src_dej"),
                    }
                    for c in periodicity
                ],
                max_harm=cfg.dedup_max_harm,
                period_tol=cfg.dedup_period_tol,
                dm_tol=cfg.dedup_dm_tol,
                pos_tol_deg=cfg.dedup_pos_tol_deg,
            )
            by_id = {c["id"]: c for c in periodicity}
            catalogue_rows: list[dict] = []
            row_leads: list[tuple[int, dict]] = []
            for g in groups:
                lead = by_id[g["leader"]["id"]]
                member_matches = [
                    match_by_id[m["id"]]
                    for m in g["members"]
                    if m["id"] in match_by_id
                ]
                known = (
                    min(
                        member_matches,
                        key=lambda m: m["period_frac_err"],
                    )
                    if member_matches else None
                )
                is_rfi = all(
                    m["id"] in vetoed for m in g["members"]
                ) and bool(vetoed)
                folded_snr = float(lead.get("folded_snr") or 0.0)
                confirmed = folded_snr >= cfg.fold_snr_min
                if known is not None:
                    label, tier = "known", 1
                elif is_rfi:
                    label, tier = "rfi", 3
                elif g["n_obs"] >= 2 and confirmed:
                    label, tier = "candidate", 1
                elif g["n_obs"] >= 2 or confirmed:
                    label, tier = "candidate", 2
                else:
                    label, tier = "candidate", 3
                fold_out = outcomes_by_key.get(lead["id"])
                catalogue_rows.append(
                    {
                        "kind": "periodicity",
                        "label": label,
                        "tier": tier,
                        "dm": float(lead["dm"]),
                        "snr": float(lead["snr"]),
                        "period": float(lead["eff_period"]),
                        "folded_snr": folded_snr or None,
                        "opt_period": lead.get("opt_period"),
                        "known_source": known["psr"] if known else None,
                        "harmonic": known["harmonic"] if known else None,
                        "n_obs": g["n_obs"],
                        "members": len(g["members"]),
                        "job_ids": g["job_ids"],
                        "fold": (
                            None
                            if fold_out is None
                            else {
                                "prof": [
                                    round(float(v), 3)
                                    for v in fold_out["opt_prof"]
                                ],
                                "subints": [
                                    [round(float(v), 3) for v in row]
                                    for row in fold_out["opt_fold"]
                                ],
                            }
                        ),
                    }
                )
                row_leads.append((len(catalogue_rows) - 1, lead))
            self._timer("sift_dedup", t0)

            # --- candidate ranking -------------------------------------
            if cfg.score and catalogue_rows:
                t0 = time.perf_counter()
                n_scored = self._score_catalogue(
                    catalogue_rows, row_leads, outcomes_by_key, obs_rows
                )
                self._timer("sift_scoring", t0)

            # --- repeat single-pulse association -----------------------
            t0 = time.perf_counter()
            sp_sources = repeat_sources(
                single_pulse,
                dm_tol=cfg.sp_dm_tol,
                min_pulses=cfg.sp_min_pulses,
                min_obs=cfg.sp_min_obs,
                min_period=cfg.sp_min_period,
                max_harm=cfg.sp_max_harm,
                phase_tol=cfg.sp_phase_tol,
                pos_tol_deg=cfg.sp_pos_tol_deg,
            )
            for s in sp_sources:
                s.pop("member_ids", None)
            self._timer("sift_repeats", t0)

            # --- write the sifted product ------------------------------
            config_doc = dataclasses.asdict(cfg)
            config_doc["n_folded"] = n_folded
            # Incremental-sift watermark: the highest observation rowid
            # this run saw.  `peasoup-sift run --incremental` no-ops
            # while the campaign DB is still at or below it.
            config_doc["watermark_rowid"] = watermark_rowid
            tally = db.ingest_sift_run(
                run_id, config_doc, catalogue_rows, known_matches,
                sp_sources,
            )
            summary = {
                "run_id": run_id,
                "db_path": db_path,
                "observations": len(obs_rows),
                "periodicity": len(periodicity),
                "single_pulse": len(single_pulse),
                "watermark_rowid": watermark_rowid,
                "duration_s": round(time.perf_counter() - t_run, 3),
                **tally,
            }
            log.info(
                "sift run %s: %d folded, %d catalogue rows (%d known, "
                "%d rfi), %d repeat single-pulse sources in %.1fs",
                run_id, tally["n_folded"], tally["n_catalogue"],
                tally["n_known"], tally["n_rfi"],
                tally["n_sp_sources"], summary["duration_s"],
            )
            return summary
