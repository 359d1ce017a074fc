"""The comparison that decides ``correct``: the port's candidate lists
against the plain reference (reference/plan.py, reference/search.py).

For each observation of the window the port's list is judged (lists of
one filterbank that are identical are judged once). The numbers, each
held to its limit in the traffic mix (``limits``) by :func:`decide`:

- ``snr_gap``: over the list's strongest candidates and a sample drawn
  from the seed, the largest relative gap between a candidate's S/N and
  the reference's value of its harmonic level at its bin, in the
  reference's spectrum of its own (DM, acceleration) trial; and where the
  reference's cluster round that bin peaks higher, the gap below that
  peak. A frequency that is not the level's frequency of a whole bin
  inside the level's window reads infinite. This covers dedispersion
  (the unpack, the kill mask, the delays, the scale), the spectrum chain,
  the resample, the FFT, interbinning and normalisation, the harmonic
  sums, the cluster walk and the wave fetch's compaction of the peaks.
- ``recall_gap``: the relative gap between the list's top candidate and
  the largest peak in the reference's spectra of every acceleration trial
  of the DM trials round it (``box_dm`` each side), every level, inside
  the levels' windows. The strongest peak of the search survives every
  distil, so a sound list's top is that maximum. An empty list reads 1.
- ``pulsar_gap``: for each pulsar the generator injected, the same box
  round the DM trial nearest its DM: the reference's largest peak there
  and its frequency. The list's strongest candidate within ``family_tol``
  of that frequency (the distils' tolerances chained) is the family's
  survivor: the family's strongest peak survives every distil, wherever
  it lies. A survivor inside the box has that peak's S/N, and its
  relative gap from it is the pulsar's number; one past the box has that
  S/N or higher, and its shortfall below it is. The number is the largest
  over the pulsars (1 where the list holds no survivor). Rows skipped, lost or
  altered, and distils that merge distinct pulsars, show here wherever
  they fall, not only round the list's top.
- ``distil_pairs``: pairs of final candidates that the last two distils
  (peasoup's DM distil and its harmonic distil without fractional
  harmonics) should have merged: a weaker candidate within ``freq_tol``
  of a stronger one's frequency or of a whole multiple of it. Exact: 0.
- ``score_mismatches``: final candidates whose scores (physical,
  adjacent, the two delta-DM ratios) differ from the reference scorer's
  over the candidate's own associations. Exact: 0.

The control (``control=True``) is the reference in bfloat16
(reference/search.py's ``Rounding``) put in the program's place: each
candidate whose S/N a number reads takes the bfloat16 reference's value
at its bin in its own trial (its scores worked out again from it), and
that list goes through the same numbers and :func:`decide`.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict
from dataclasses import dataclass, replace

import numpy as np
import torch

from .plan import accel_factor, cfreq, make_plan
from .search import MIN_GAP, Rounding, channel_major, clusters, dedisperse, levels, whiten

F32 = np.float32
NUMBERS = ("snr_gap", "recall_gap", "pulsar_gap", "distil_pairs", "score_mismatches")
EXACT = ("distil_pairs", "score_mismatches")


@dataclass(frozen=True)
class Answer:
    """One final candidate as the port gave it, copied out of its objects:
    what the comparison reads, and its associations' DM index, DM and S/N
    (the scorer's inputs) as arrays."""

    dm_idx: int
    dm: float
    acc: float
    nh: int
    snr: float
    freq: float
    is_physical: bool
    is_adjacent: bool
    ddm_count_ratio: float
    ddm_snr_ratio: float
    assoc_dm_idx: np.ndarray
    assoc_dm: np.ndarray
    assoc_snr: np.ndarray

    def key(self) -> tuple:
        return (self.dm_idx, self.acc, self.nh, self.snr, self.freq)


def answers_of(cands) -> list[Answer]:
    """The port's final candidates as Answers."""
    return [Answer(
        dm_idx=int(c.dm_idx), dm=float(c.dm), acc=float(c.acc), nh=int(c.nh),
        snr=float(c.snr), freq=float(c.freq), is_physical=bool(c.is_physical),
        is_adjacent=bool(c.is_adjacent), ddm_count_ratio=float(c.ddm_count_ratio),
        ddm_snr_ratio=float(c.ddm_snr_ratio),
        assoc_dm_idx=np.fromiter((a.dm_idx for a in c.assoc), np.int64, len(c.assoc)),
        assoc_dm=np.fromiter((a.dm for a in c.assoc), np.float64, len(c.assoc)),
        assoc_snr=np.fromiter((a.snr for a in c.assoc), np.float64, len(c.assoc)),
    ) for c in cands]


def _cluster_max(row: np.ndarray, crossings: np.ndarray, b: int) -> float | None:
    """The peak of the cluster that bin ``b`` belongs to in peasoup's walk
    over ``crossings``, or None where ``b`` is not a crossing. The walk
    starts after the last gap of MIN_GAP bins or more before ``b`` and
    stops at the first after it: no cluster spans such a gap."""
    pos = int(np.searchsorted(crossings, b))
    if pos >= len(crossings) or crossings[pos] != b:
        return None
    gaps = np.flatnonzero(np.diff(crossings) >= MIN_GAP)
    before, after = gaps[gaps < pos], gaps[gaps >= pos]
    lo = int(before[-1]) + 1 if len(before) else 0
    hi = int(after[0]) + 1 if len(after) else len(crossings)
    _, values, owner = clusters(row, crossings[lo:hi])
    return float(values[owner[pos - lo]])


def _gap(s: float, row: np.ndarray, b: int, window, thr) -> float:
    """The relative gap of the S/N ``s`` claimed at bin ``b`` of a level."""
    start, limit = int(window[0]), int(window[1])
    if not start <= b < limit:
        return math.inf
    r = float(row[b])
    if not r > 0:
        return math.inf
    g = abs(s - r) / r
    crossings = np.flatnonzero(row[start:limit] > thr) + start
    m = _cluster_max(row, crossings, b)
    if m is not None and m > s:
        g = max(g, (m - s) / m)
    return g


def related_pairs(cands, tol: float, max_harm: int) -> int:
    """Pairs of the final list a DM distil or a harmonic distil (whole
    multiples up to ``max_harm``) would have merged, the stronger the
    fundamental; both ways for equal S/N."""
    if len(cands) < 2:
        return 0
    snr = np.array([c.snr for c in cands], dtype=np.float64)
    f = np.array([c.freq for c in cands], dtype=np.float64)
    order = np.argsort(-snr, kind="stable")
    snr, f = snr[order], f[order]
    ratio = f[None, :] / f[:, None]  # [i, j] = f_j / f_i
    hit = np.zeros(ratio.shape, dtype=bool)
    for jj in range(1, max_harm + 1):
        r = ratio / jj
        hit |= (r > 1 - tol) & (r < 1 + tol)
    upper = np.triu(np.ones_like(hit), k=1)
    ties = snr[:, None] == snr[None, :]
    counted = hit & (upper | (ties & ~np.eye(len(f), dtype=bool)))
    # an equal-S/N pair related either way counts once
    both = counted & counted.T & ties
    return int(counted.sum() - np.triu(both, k=1).sum())


def scores(c, header: dict) -> tuple:
    """peasoup's scores of candidate ``c`` over its own associations:
    (physical, adjacent, delta-DM count ratio, delta-DM S/N ratio)."""
    nchans, foff = header["nchans"], header["foff"]
    cf = cfreq(header)
    bw = abs(foff) * nchans
    ftop, fbot = cf + bw / 2.0, cf - bw / 2.0
    chan = 8300.0 * foff / cf**3
    band = 4150.0 * (1.0 / fbot**2 - 1.0 / ftop**2)
    physical = bool(1.0 / c.freq > c.dm * chan)
    idx = c.assoc_dm_idx
    adjacent = bool(np.isin(idx, (c.dm_idx - 1, c.dm_idx + 1)).any() or (idx == c.dm_idx).all())
    ddm = 1.0 / (c.freq * band)
    n_in, n_all, s_in, s_all = 1, 1, c.snr, c.snr
    # summed one by one in the associations' order, as the scorer does
    for dm, snr in zip(c.assoc_dm.tolist(), c.assoc_snr.tolist()):
        n_all += 1
        s_all += snr
        if abs(c.dm - dm) <= ddm:
            n_in += 1
            s_in += snr
    return physical, adjacent, n_in / n_all, s_in / s_all


def score_mismatches(cands, header: dict) -> int:
    """Final candidates whose scores differ from peasoup's scorer over
    their own associations."""
    return sum((c.is_physical, c.is_adjacent, c.ddm_count_ratio, c.ddm_snr_ratio)
               != scores(c, header) for c in cands)


class _Reference:
    """The reference's view of one observation at one precision: whitened
    DM trials made on demand, each (DM, acceleration) trial's levels, and
    each trial's strongest peak inside the windows, kept."""

    def __init__(self, xc, plan, tsamp: float, nh: int, rnd: Rounding, block: int = 16):
        self.xc, self.plan, self.tsamp, self.nh, self.rnd = xc, plan, tsamp, nh, rnd
        self.block = block
        self.done: dict[int, tuple] = {}
        self.best: dict[tuple, tuple] = {}
        self.rows = 0

    def need(self, dms) -> None:
        todo = sorted(set(dms) - set(self.done))
        for i in range(0, len(todo), self.block):
            part = todo[i : i + self.block]
            u8 = dedisperse(self.xc, self.plan.delays[part], self.plan.out_nsamps,
                            self.plan.scale, self.plan.chans)
            xd, mean, std = whiten(u8, self.plan, self.rnd)
            for j, d in enumerate(part):
                self.done[d] = (xd[j], mean[j], std[j])

    def levels(self, d: int, acc: float) -> torch.Tensor:
        self.need([d])
        xd, mean, std = self.done[d]
        self.rows += 1
        return levels(xd, float(accel_factor(acc, self.tsamp)), mean, std, self.nh, self.rnd)

    def box_best(self, dms) -> tuple:
        """(value, level, bin) of the strongest peak of every acceleration
        trial of the DM trials ``dms``, every level, inside the windows."""
        self.need(dms)
        out = (-math.inf, 0, 0)
        for d in dms:
            for acc in self.plan.accels[d]:
                key = (d, float(acc))
                if key not in self.best:
                    lv = self.levels(d, float(acc))
                    row = (-math.inf, 0, 0)
                    for h in range(self.nh + 1):
                        lo, hi = (int(v) for v in self.plan.windows[h])
                        if hi > lo:
                            v, b = torch.max(lv[h, lo:hi], dim=0)
                            row = max(row, (float(v), h, lo + int(b)))
                    self.best[key] = row
                out = max(out, self.best[key])
        return out


def _choose(n: int, rng, top: int, sample: int) -> list[int]:
    """The indices of the top ``top`` candidates and ``sample`` more drawn."""
    head = list(range(min(top, n)))
    if n > top and sample:
        pick = rng.choice(n - top, size=min(sample, n - top), replace=False)
        head += sorted(top + int(i) for i in pick)
    return head


@dataclass
class _Setting:
    header: dict
    plan: object
    check: dict
    thr: np.float32
    nh: int
    tol: float
    max_harm: int


def _box(plan, d: int, half: int) -> list[int]:
    return list(range(max(0, d - half), min(len(plan.dm_list), d + half + 1)))


def _bin_of(c, plan) -> int | None:
    """The bin of candidate ``c`` at its level, or None where its frequency
    is not the level's frequency of a whole bin."""
    if not 0 <= c.nh < len(plan.factors):
        return None
    b = int(round(c.freq / float(plan.factors[c.nh])))
    return b if F32(F32(b) * plan.factors[c.nh]) == F32(c.freq) else None


def _numbers(cands, ref: _Reference, pulsars, rng, st: _Setting):
    """The numbers of one list, the indices of the candidates whose S/N
    they read, and each pulsar's (frequency over the injected one,
    reference peak, the survivor's S/N, 1 where it lies in the box)."""
    plan = st.plan
    out = {"snr_gap": 0.0, "recall_gap": 0.0, "pulsar_gap": 0.0,
           "distil_pairs": related_pairs(cands, st.tol, st.max_harm),
           "score_mismatches": score_mismatches(cands, st.header)}
    read: set[int] = set()
    found = []
    if not cands:
        out["recall_gap"] = 1.0
        out["pulsar_gap"] = 1.0 if pulsars else 0.0
        return out, read, found
    ndm = len(plan.dm_list)
    by_row = defaultdict(list)
    for i in _choose(len(cands), rng, int(st.check["top"]), int(st.check["sample"])):
        c = cands[i]
        read.add(i)
        if 0 <= c.dm_idx < ndm and _bin_of(c, plan) is not None:
            by_row[(c.dm_idx, float(c.acc))].append(i)
        else:
            out["snr_gap"] = math.inf
    for (d, acc), idx in by_row.items():
        lv = ref.levels(d, acc)
        for i in idx:
            c = cands[i]
            row = lv[c.nh].cpu().numpy()
            g = _gap(float(c.snr), row, _bin_of(c, plan), plan.windows[c.nh], st.thr)
            out["snr_gap"] = max(out["snr_gap"], g)
        del lv
    half = int(st.check["box_dm"])
    top = cands[0]
    read.add(0)
    if 0 <= top.dm_idx < ndm:
        best = ref.box_best(_box(plan, top.dm_idx, half))[0]
        out["recall_gap"] = abs(best - top.snr) / best
    else:
        out["recall_gap"] = math.inf
    freqs = np.array([c.freq for c in cands], dtype=np.float64)
    snrs = np.array([c.snr for c in cands], dtype=np.float64)
    ftol = float(st.check["family_tol"])
    for p in pulsars:
        d0 = int(np.argmin(np.abs(plan.dm_list.astype(np.float64) - p.dm)))
        m, h, b = ref.box_best(_box(plan, d0, half))
        f = float(F32(F32(b) * plan.factors[h]))
        fam = np.flatnonzero(np.abs(freqs / f - 1.0) <= ftol)
        read.update(int(i) for i in fam)
        if len(fam):
            j = int(fam[np.argmax(snrs[fam])])
            s = float(snrs[j])
            # in the box its S/N is that peak's; past it, at least as high
            inside = abs(cands[j].dm_idx - d0) <= half
            g = abs(s - m) / m if inside else max(0.0, (m - s) / m)
        else:
            s, inside, g = 0.0, False, 1.0
        out["pulsar_gap"] = max(out["pulsar_gap"], g)
        found.append((f * p.period_s, m, s, float(inside)))
    return out, read, found


def _control_list(cands, read, ref16: _Reference, st: _Setting) -> list:
    """The list with the bfloat16 reference in the program's place: each
    candidate in ``read`` takes its value at its bin in its own trial, and
    the scores worked out from it."""
    plan = st.plan
    out = list(cands)
    by_row = defaultdict(list)
    for i in sorted(read):
        c = cands[i]
        b = _bin_of(c, plan)
        if 0 <= c.dm_idx < len(plan.dm_list) and b is not None and b < plan.nbins:
            by_row[(c.dm_idx, float(c.acc))].append((i, b))
    for (d, acc), idx in by_row.items():
        lv = ref16.levels(d, acc)
        for i, b in idx:
            c = replace(cands[i], snr=float(lv[cands[i].nh, b]))
            physical, adjacent, count_ratio, snr_ratio = scores(c, st.header)
            out[i] = replace(c, is_physical=physical, is_adjacent=adjacent,
                             ddm_count_ratio=count_ratio, ddm_snr_ratio=snr_ratio)
        del lv
    return out


def _fold(into: dict, nums: dict) -> None:
    """The run's numbers: the largest gap of any list, and the exact
    counts summed over the lists."""
    for n in NUMBERS:
        into[n] = into[n] + nums[n] if n in EXACT else max(into[n], nums[n])


def decide(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Each number beside its limit, and whether every one keeps to it."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def judge(header: dict, search: dict, birdies: list, observations: list, seed: int,
          device, check: dict, keep=None, control: bool = False) -> dict:
    """The numbers of one run. ``observations``: [(samples, [lists of
    Answers], pulsars)] for each filterbank: its bytes as the generator
    made them, the distinct lists the port gave for it, and the pulsars
    injected into it. ``keep``: the configuration's kill mask. With
    ``control`` the control list's numbers are returned too, under
    ``control``."""
    t0 = time.perf_counter()
    plan = make_plan(header, search, birdies, keep)
    s = dict(search)
    st = _Setting(header=header, plan=plan, check=check, thr=F32(s.get("min_snr", 9.0)),
                  nh=int(s.get("nharmonics", 4)), tol=float(s.get("freq_tol", 1e-4)),
                  max_harm=int(s.get("max_harm", 16)))
    out = dict.fromkeys(NUMBERS, 0)
    ctl = dict.fromkeys(NUMBERS, 0)
    info = {"lists": 0, "rows": 0, "families": []}
    for k, (samples, lists, pulsars) in enumerate(observations):
        xc = channel_major(samples, header, device)
        tsamp = float(header["tsamp"])
        ref = _Reference(xc, plan, tsamp, st.nh, Rounding(torch.float32))
        ref16 = _Reference(xc, plan, tsamp, st.nh, Rounding(torch.bfloat16)) if control else None
        for li, cands in enumerate(lists):
            info["lists"] += 1
            key = [int(seed) % (1 << 63), k, li]
            nums, read, found = _numbers(cands, ref, pulsars, np.random.default_rng(key), st)
            info["families"].append([[float(v) for v in f] for f in found])
            _fold(out, nums)
            if control:
                ctl_list = _control_list(cands, read, ref16, st)
                _fold(ctl, _numbers(ctl_list, ref, pulsars, np.random.default_rng(key), st)[0])
        info["rows"] += ref.rows + (ref16.rows if control else 0)
        del ref, ref16, xc
        if device.type == "cuda":
            torch.cuda.empty_cache()
    result = {"numbers": out, "info": dict(info, seconds=time.perf_counter() - t0)}
    if control:
        result["control"] = ctl
    return result
