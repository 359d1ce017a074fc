"""Acc-tie crown stability analysis: the port's copy of the JAX package's
tools/tie_mc.py, replaying the port's own native distil chain.

Context: on tutorial.fil the three accel trials {0, -5, +5} produce
BITWISE-IDENTICAL spectra (shifts < half a sample), so each golden
candidate's acceleration is decided purely by how std::sort's unstable
introsort happens to arrange EXACT S/N ties (distiller.hpp:31) — which
in turn depends on comparator outcomes between UNRELATED rows across
the whole per-DM list. The native library replays the identical
libstdc++ introsort (``ps_snr_sort_perm_seg``); the question this module
answers quantitatively is whether a crown that differs from the
reference's is a meaningful target at all.

Method: ``PEASOUP_TIE_CAPTURE=<path.npz>`` makes the search driver dump
the raw pre-sort candidate rows and segment structure
(pipeline/search.py ``_distill_segmented``, the JAX package's keys and
dtypes). :func:`replay` re-runs the full host distil chain — segmented
introsort, harmonic distil, per-DM accel distil, global DM + harmonic
distils — from those rows with an arbitrary S/N vector, and
:func:`mc_crown_stability` Monte-Carlos the crowns under iid
U(-delta, +delta) S/N perturbations at delta = the combined FFT-rounding
bound of two independent implementations (<= 4.2e-3 absolute against
the f64 oracle of tools/divergence.py, the CUDA chain's own ~1e-4). A
crown whose identity changes under such perturbations is NOT determined
by the physics or the algorithm — only by sub-rounding comparator noise
— so no independent FFT implementation can be expected to reproduce it.

The distil chain replayed here is the search's own (the same native
calls, the same distiller classes); folding is irrelevant to crown
identity (it reorders final ranks, never the acc of a matched
frequency). A capture written by either package replays here.
"""

from __future__ import annotations

import numpy as np

COMBINED_FFT_BOUND = 4.3e-3  # ours (<=4.2e-3) + CUDA's (~1e-4), absolute S/N


def load_capture(path: str) -> dict:
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


def replay(cap: dict, snr: np.ndarray) -> list:
    """Run the full host distill chain on the captured rows with S/N
    vector ``snr`` (same length/order as cap['snr']); returns the final
    candidate list (pre-fold order: S/N descending)."""
    from .. import native
    from ..core.candidates import Candidate
    from ..pipeline.distill import (
        AccelerationDistiller, DMDistiller, HarmonicDistiller,
    )

    freqs = cap["freqs"]
    lvl = cap["lvl"]
    a = cap["a"]
    seg_counts = cap["seg_counts"].astype(np.int64)
    dm_of_seg = cap["dm_of_seg"].astype(np.int64)
    acc_tab = cap["acc_tab"]
    dm_list = cap["dm_list"]
    ndm = len(dm_list)
    snr = np.asarray(snr, np.float64)

    seg_off0 = np.concatenate([np.zeros(1, np.int64), np.cumsum(seg_counts)])
    seg_id = np.repeat(np.arange(seg_counts.size), seg_counts)
    order = native.snr_sort_perm_seg(snr.astype(np.float32), seg_off0)
    unique = native.harmonic_distill_seg(
        freqs[order], lvl[order], seg_off0,
        float(cap["harm_tol"]), int(cap["harm_max"]),
        bool(cap["harm_frac"]),
    )
    surv = order[unique]
    s_dm = dm_of_seg[seg_id[surv]]
    s_acc = acc_tab[s_dm, a[surv]]
    s_snr = snr[surv]
    s_freq = freqs[surv]
    s_lvl = lvl[surv]

    seg_bounds = np.searchsorted(s_dm, np.arange(ndm + 1))
    order2 = native.snr_sort_perm_seg(
        s_snr.astype(np.float32), seg_bounds.astype(np.int64)
    )
    d_dm, d_a_ = s_dm[order2], s_acc[order2]
    d_lvl, d_snr, d_freq = s_lvl[order2], s_snr[order2], s_freq[order2]
    seg_off2 = np.searchsorted(d_dm, np.arange(ndm + 1))
    unique2, esrc, edst = native.accel_distill_seg(
        d_freq, d_a_, seg_off2, float(cap["acc_tobs_over_c"]),
        float(cap["acc_tol"]),
    )
    row_cands = [
        Candidate(
            dm=float(dm_list[d_dm[r]]), dm_idx=int(d_dm[r]),
            acc=float(d_a_[r]), nh=int(d_lvl[r]), snr=float(d_snr[r]),
            freq=float(d_freq[r]),
        )
        for r in range(len(order2))
    ]
    for s_, t_ in zip(esrc, edst):
        row_cands[s_].append(row_cands[t_])
    per_dm = [
        row_cands[r]
        for dm_idx in range(ndm)
        for r in range(seg_off2[dm_idx], seg_off2[dm_idx + 1])
        if unique2[r]
    ]

    freq_tol = float(cap["freq_tol"])
    max_harm = int(cap["max_harm"])
    dm_still = DMDistiller(freq_tol, keep_related=True)
    harm_still = HarmonicDistiller(
        freq_tol, max_harm, keep_related=True, fractional_harms=False
    )
    return harm_still.distill(dm_still.distill(per_dm))


def crowns_for_golden(cands: list, golden_freqs: np.ndarray) -> list:
    """For each golden frequency (bit-exact f32 match expected), the
    (acc, snr) of our surviving candidate — or None if not recalled."""
    out = []
    for gf in golden_freqs:
        best = None
        for c in cands:
            # golden freqs arrive as 1/period from XML text: equal to
            # our bit-exact f32 freq chain only to print precision
            if abs(c.freq - gf) <= 1e-7 * max(abs(gf), 1.0):
                if best is None or c.snr > best.snr:
                    best = c
        out.append((best.acc, best.snr) if best is not None else None)
    return out


def mc_crown_stability(
    cap: dict,
    golden_freqs: np.ndarray,
    n_draws: int = 200,
    delta: float = COMBINED_FFT_BOUND,
    seed: int = 0,
) -> dict:
    """Monte-Carlo the crowned acc of each golden candidate under iid
    U(-delta, +delta) S/N perturbations. Returns per-candidate crown
    histograms plus the baseline (unperturbed) crowns. A candidate
    whose histogram has more than one key is UNSTABLE at the combined
    FFT-rounding bound: its reference crown is not reproducible by any
    independent FFT implementation."""
    rng = np.random.default_rng(seed)
    base = crowns_for_golden(replay(cap, cap["snr"]), golden_freqs)
    hists: list[dict] = [dict() for _ in golden_freqs]
    snr0 = cap["snr"]
    for _ in range(n_draws):
        pert = snr0 + rng.uniform(-delta, delta, size=snr0.shape)
        crowns = crowns_for_golden(replay(cap, pert), golden_freqs)
        for h, cr in zip(hists, crowns):
            key = None if cr is None else round(cr[0], 6)
            h[key] = h.get(key, 0) + 1
    return {
        "baseline": base,
        "histograms": hists,
        "n_draws": n_draws,
        "delta": delta,
        "unstable": [len(h) > 1 for h in hists],
    }
