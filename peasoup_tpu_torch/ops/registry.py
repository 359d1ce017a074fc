"""The port's registry of device programs (the JAX package's ops/registry.py):
every kernel of ``kernels.KERNELS``, called through its wrapper, and each
torch op whose JAX counterpart the JAX package's registry lists.

Each entry has a build thunk ``build(device) -> (fn, args, kwargs)`` that
makes its inputs at a small representative shape from a seeded
``torch.Generator`` (host arrays, such as a plan's delay table, from a
seeded numpy generator), on ``device``. Two consumers run them:
perf/warmup.py (each program once, after building every kernel) and
perf/microbench.py (the median of k, CUDA events on the card).

:data:`JAX_COUNTERPARTS` maps each program of the JAX registry to its
port counterpart here, or to the reason it has none;
:func:`unregistered_programs` is the completeness check
``peasoup-perf check`` gates on: every kernel registered, and every
counterpart named there registered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

Build = Callable[..., tuple[Callable, tuple, dict[str, Any]]]


@dataclass(frozen=True)
class ProgramSpec:
    """One registered program. ``kernel`` names the kernel its CUDA call
    launches ("" for a torch op).

    ``build(device, **sizes)`` makes the program's inputs; ``param`` is its
    ShapeCtx hook (the JAX package's ops/registry.py:145-175): the sizes
    ``build`` takes at a campaign bucket's geometry, or None where the
    program does not apply to the context. ``donate`` lists the argument
    indices the program writes in place, and ``allow_syncs`` the host
    syncs its call may make, as (aten op, reason) pairs: the audit's
    contract engine holds each program to both (analysis/contracts.py)."""

    name: str
    build: Build
    kernel: str = ""
    param: Callable[[Any], dict | None] | None = None
    donate: tuple[int, ...] = ()
    allow_syncs: tuple[tuple[str, str], ...] = ()

    def build_for(self, ctx=None, device: str | torch.device = "cpu"):
        """``(fn, args, kwargs)`` at ``ctx``'s shapes through the hook, or
        at the representative shapes when no ctx is given; None where the
        program has no build for ``ctx``."""
        device = torch.device(device)
        if ctx is None:
            return self.build(device)
        if self.param is None:
            return None
        sizes = self.param(ctx)
        return None if sizes is None else self.build(device, **sizes)


# JAX registry program -> the port's registered program, or why none
_NO_SELECT = ("the port resamples by the resample kernel's gather (kernels.resample) "
              "or inside the dftspec kernel; it has no packed select program")
JAX_COUNTERPARTS = {
    "ops.candidate_features.candidate_features_batch":
        "ops.candidate_features.candidate_features_batch",
    "ops.candidate_features.score_apply": "ops.candidate_features.score_apply",
    "ops.coincidence.coincidence_mask": "ops.coincidence.coincidence_mask",
    "ops.correlate.find_delays": "ops.correlate.find_delays",
    "ops.dedisperse.dedisperse_block": "kernels.dedisperse",
    "ops.dedisperse.dedisperse_matmul_block": "ops.dedisperse.dedisperse_matmul",
    "ops.dedisperse.subband_stage1": "ops.dedisperse.subband_stage1",
    "ops.dedisperse.subband_stage1_batched": "ops.dedisperse.subband_stage1",
    "ops.dedisperse.subband_stage1_matmul": "ops.dedisperse.subband_stage1_matmul",
    "ops.dedisperse.subband_stage2": "ops.dedisperse.subband_stage2",
    "ops.dedisperse.subband_stage2_matmul": "ops.dedisperse.subband_stage2_matmul",
    "ops.dedisperse.unpack_fil_device": "ops.dedisperse.unpack_fil_device",
    "ops.fdas.correlate_bank": "ops.fdas.correlate_bank",
    "ops.fdas.fdas_correlate_search": "ops.fdas.fdas_spectrum_peaks",
    "ops.ffa.octave": "ops.ffa.ffa_octave",
    "ops.fold.fold_time_series": "ops.fold.fold_time_series",
    "ops.fold_optimise.optimise_device": "ops.fold_optimise.optimise_device",
    "ops.harmonics.harmonic_sums": "ops.harmonics.harmonic_sums",
    "ops.peaks.cluster_peaks_device": "ops.peaks.cluster_peaks_device",
    "ops.peaks.compact_peaks_device": "ops.peaks.compact_peaks_device",
    "ops.peaks.find_peaks_device": "ops.peaks.find_peaks_device",
    "ops.peaks.pack_chunk_results": "ops.peaks.pack_chunk_results",
    "ops.rednoise.running_median": "ops.rednoise.running_median",
    "ops.rednoise.whiten_fseries": "ops.rednoise.whiten_fseries",
    "ops.resample.resample_accel": "kernels.resample",
    "ops.resample.resample_accel_quadratic": "ops.resample.resample_accel_quadratic",
    "ops.resample.resample_select": _NO_SELECT,
    "ops.resample.resample_select_packed": _NO_SELECT,
    "ops.resample.resample_select_packed_planes": _NO_SELECT,
    "ops.singlepulse.normalise_trials": "ops.singlepulse.normalise_trials",
    "ops.singlepulse.single_pulse_search": "ops.singlepulse.single_pulse_search_block",
    "ops.spectrum.form_interpolated": "ops.spectrum.form_interpolated",
    "ops.spectrum.form_interpolated_parts": "ops.spectrum.form_interpolated_parts",
    "ops.spectrum.form_power": "ops.spectrum.form_power",
    "ops.spectrum.interp_deredden_zap": "kernels.specchain",
    "ops.spectrum.normalise": "ops.spectrum.normalise",
    "ops.spectrum.spectrum_stats": "ops.spectrum.spectrum_stats",
    "ops.streaming.stream_chunk_search": "ops.streaming.stream_chunk_search",
    "ops.survey_fold.survey_fold_batch": "ops.survey_fold.survey_fold_batch",
    "ops.zap.zap_birdies": "ops.zap.zap_birdies",
}


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _randn(g, dev, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32).to(dev)


def _rand(g, dev, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, dtype=torch.float32).to(dev)


def _complex(g, dev, *shape) -> torch.Tensor:
    return torch.complex(_randn(g, dev, *shape), _randn(g, dev, *shape))


def _fil(g, dev, t: int, c: int) -> torch.Tensor:
    """(t, c) u8 2-bit samples."""
    return torch.randint(0, 4, (t, c), generator=g, dtype=torch.uint8).to(dev)


def _delays(seed: int, d: int, c: int, spread: int) -> np.ndarray:
    """(d, c) i32 delays falling with channel, the last trial the widest."""
    rng = np.random.default_rng(seed)
    dms = np.sort(rng.uniform(0, 1, d))
    dms[-1] = 1.0
    return np.rint(dms[:, None] * np.linspace(1.0, 0.0, c) ** 2 * spread).astype(np.int32)


def _boxcar_args(dev, nsamps: int = 8192, widths=None, seed: int = 6, rows: int = 4):
    from . import singlepulse as sp

    x = _randn(_gen(seed), dev, rows, nsamps)
    widths = widths or sp.default_widths(8)
    tpad, _ = sp.plan_pad(nsamps)
    csum = sp.prefix_sum_padded(sp.normalise_trials(x), tpad, sp.width_extent(widths))
    return csum, widths, sp.width_scales(widths), nsamps, tpad


def _peaks_levels(dev, rows: int = 4, nbins: int = 8000, nlev: int = 5, seed: int = 8):
    g = _gen(seed)
    npad = -(-nbins // 4096) * 4096
    # a bright bin every 61 at the representative width, at most 256 a row
    # at a bucket's (a real spectrum's crossings do not grow with its bins,
    # and the plain walk takes one step a crossing)
    stride = max(61, nbins // 256)
    levels = []
    for lv in range(nlev):
        s = torch.randn((rows, nbins), generator=g).abs()
        s[:, lv::stride] += 30.0
        levels.append(torch.nn.functional.pad(s, (0, npad - nbins), value=1e9).to(dev))
    windows = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (nlev, 1))
    return levels, windows, nbins


# --------------------------------------------------------------------------
# the kernels, through their wrappers
#
# Each build takes its sizes as keywords, their defaults the representative
# shape; its ShapeCtx hook (``_H``) maps a bucket's geometry to those sizes,
# or to None where the program does not apply to the context.
# --------------------------------------------------------------------------

def _rows(ctx, cap: int | None = None) -> int:
    """Rows a ladder build takes: the bucket's DM trials, at most ``cap``
    (default ``ctx.ladder_rows``; 0 takes them all). The contract ladder
    caps them, as it walks the sample axis; the kernel engine's card leg
    takes the bucket's own."""
    cap = ctx.ladder_rows if cap is None else cap
    return max(1, min(ctx.ndm, cap) if cap else ctx.ndm)


def _nbins(ctx) -> int:
    return ctx.fft_size // 2 + 1


def _k_dedisperse(dev, nsamps=4096, nchans=64, ndm=32, spread=200, nbits=2):
    from .dedisperse import dedisperse

    delays = _delays(0, ndm, nchans, spread)
    x = torch.randint(0, 1 << min(nbits, 8), (nsamps + spread, nchans), generator=_gen(0),
                      dtype=torch.uint8).to(dev)
    return dedisperse, (x, delays, np.ones(nchans, np.int32), nsamps), {}


def _h_dedisperse(ctx):
    if ctx.out_nsamps <= 0:
        return None
    # a host-RAM segment's trials under the cap; uncapped, the device's all
    ndm = ctx.ndm if ctx.ladder_rows == 0 else min(ctx.ndm, ctx.dedisp_block)
    return dict(nsamps=ctx.out_nsamps, nchans=ctx.nchans, ndm=ndm,
                spread=max(0, ctx.nsamps - ctx.out_nsamps), nbits=ctx.nbits)


def _k_resample(dev, n=1 << 15, ndm=4, rows=32):
    from .resample import resample_rows

    g = _gen(1)
    row_dm = (torch.arange(rows, dtype=torch.int32) % ndm).to(dev)
    afs = torch.linspace(-2e-9, 2e-9, rows, dtype=torch.float32).to(dev)
    return resample_rows, (_randn(g, dev, ndm, n), row_dm, afs), {}


def _h_resample(ctx):
    if ctx.fft_size <= 0:
        return None
    ndm = _rows(ctx)
    return dict(n=ctx.fft_size, ndm=ndm, rows=ndm * max(1, min(ctx.accel_pad, 8)))


def _k_specchain(dev, rows=8, nbins=8193):
    from .spectrum import specchain

    g = _gen(2)
    zap = torch.zeros(nbins, dtype=torch.bool)
    zap[[2, nbins // 16 - 1, nbins // 16]] = True
    return specchain, (_randn(g, dev, rows, nbins), _randn(g, dev, rows, nbins),
                       0.5 + _rand(g, dev, rows, nbins), zap.to(dev)), {}


def _h_spectrum(ctx):
    return None if ctx.fft_size <= 0 else dict(rows=_rows(ctx), nbins=_nbins(ctx))


def _k_interbin(dev, rows=4, n=1 << 14):
    from .fft import packed_dft_z, untwist_interbin_normalise

    g = _gen(3)
    z = packed_dft_z(_randn(g, dev, rows, n))
    return (untwist_interbin_normalise, (z, _randn(g, dev, rows), 0.5 + _rand(g, dev, rows)),
            dict(npad=n // 2 + 2))


def _h_series(ctx):
    return None if ctx.fft_size <= 0 else dict(rows=_rows(ctx), n=ctx.fft_size)


def _k_dftspec(dev, rows=4, n=1 << 15):
    from ..pipeline.accel_search import padded_bins
    from .dftspec import dft_untwist_interbin

    g = _gen(4)
    return (dft_untwist_interbin, (_randn(g, dev, rows, n), _randn(g, dev, rows),
                                   0.5 + _rand(g, dev, rows)), dict(npad=padded_bins(n)))


def _h_dftspec(ctx):
    from ..pipeline.accel_search import padded_bins
    from .dftspec import dftspec_supported

    if ctx.fft_size <= 0 or not dftspec_supported(ctx.fft_size, padded_bins(ctx.fft_size)):
        return None
    return dict(rows=_rows(ctx), n=ctx.fft_size)


def _k_peaks(dev, rows=4, nbins=8000, nharms=4):
    from .harmonics import level_scales
    from .peaks import find_cluster_peaks_multi

    levels, windows, nbins = _peaks_levels(dev, rows, nbins, nharms + 1)
    return find_cluster_peaks_multi, (levels, windows), dict(
        threshold=9.0, max_peaks=16, scales=level_scales(nharms), nbins=nbins)


def _h_peaks(ctx):
    if ctx.fft_size <= 0:
        return None
    return dict(rows=_rows(ctx), nbins=_nbins(ctx), nharms=ctx.nharms)


def _k_harmpeaks(dev, rows=4, nbins=8000, nharms=4):
    from .harmonics import level_scales
    from .peaks import find_harmonic_cluster_peaks

    levels, windows, nbins = _peaks_levels(dev, rows, nbins, nharms + 1)
    return find_harmonic_cluster_peaks, (levels[0], windows), dict(
        nharms=nharms, threshold=9.0, max_peaks=16, scales=level_scales(nharms), nbins=nbins)


def _k_boxcar(dev, nsamps=8192, widths=None, rows=4):
    from .singlepulse import boxcar_best

    return boxcar_best, _boxcar_args(dev, nsamps, widths, rows=rows), {}


def _h_boxcar(ctx):
    if not ctx.widths or ctx.out_nsamps <= 0:
        return None
    return dict(nsamps=ctx.out_nsamps, widths=tuple(ctx.widths), rows=_rows(ctx))


def _k_spchain(dev, nsamps=8192, widths=None, dec=32, rows=4):
    from .singlepulse import boxcar_dec_best

    return boxcar_dec_best, (*_boxcar_args(dev, nsamps, widths, rows=rows), dec), {}


def _h_spchain(ctx):
    sizes = _h_boxcar(ctx)
    if sizes is None or ctx.decimate <= 1 or ctx.tpad % ctx.decimate:
        return None
    return dict(sizes, dec=ctx.decimate)


_KERNEL_BUILDS = {
    "dedisperse": (_k_dedisperse, _h_dedisperse),
    "resample": (_k_resample, _h_resample),
    "specchain": (_k_specchain, _h_spectrum),
    "interbin": (_k_interbin, _h_series),
    "dftspec": (_k_dftspec, _h_dftspec),
    "peaks": (_k_peaks, _h_peaks),
    "harmpeaks": (_k_harmpeaks, _h_peaks),
    "boxcar": (_k_boxcar, _h_boxcar),
    "spchain": (_k_spchain, _h_spchain),
}


# --------------------------------------------------------------------------
# the torch ops with a counterpart in the JAX registry
# --------------------------------------------------------------------------

def _candidate_features_batch(dev, rows=3, nbins=16, nints=4):
    from .candidate_features import DM_CURVE_POINTS, candidate_features_batch

    g = _gen(10)
    return candidate_features_batch, (0.5 + _rand(g, dev, rows, nbins),
                                      0.5 + _rand(g, dev, rows, nints, nbins),
                                      0.5 + _rand(g, dev, rows, DM_CURVE_POINTS)), {}


def _h_fold_batch(ctx):
    """The sift's fold geometry (64 bins x 16 subints) for a batch of 8."""
    return None if ctx.fold_nsamps <= 0 else dict(rows=8, nbins=64, nints=16)


def _score_apply(dev, rows=3):
    from .candidate_features import NFEATURES, score_apply

    g = _gen(11)
    return score_apply, (_randn(g, dev, rows, NFEATURES), _randn(g, dev, NFEATURES),
                         0.5 + _rand(g, dev, NFEATURES), _randn(g, dev, NFEATURES, 16),
                         _randn(g, dev, 16), _randn(g, dev, 16), _randn(g, dev)), {}


def _h_score(ctx):
    return None if ctx.fold_nsamps <= 0 else dict(rows=8)


def _coincidence_mask(dev, n=4096):
    from .coincidence import coincidence_mask

    return coincidence_mask, (_randn(_gen(12), dev, 4, n), 3.0, 2), {}


def _h_trial_len(ctx):
    return None if ctx.out_nsamps <= 0 else dict(n=ctx.out_nsamps)


def _find_delays(dev, n=4096):
    from .correlate import find_delays

    return find_delays, (_randn(_gen(13), dev, 3, n), max(1, min(64, n // 2))), {}


def _h_find_delays(ctx):
    return None if ctx.out_nsamps <= 8 else dict(n=ctx.out_nsamps)


def _unpack_fil_device(dev, nsamps=4096, nchans=64, nbits=2):
    from .dedisperse import unpack_fil_device

    raw = torch.randint(0, 256, (nsamps * nchans * nbits // 8,), generator=_gen(14),
                        dtype=torch.uint8)
    return unpack_fil_device, (raw.to(dev),), dict(nbits=nbits, nsamps=nsamps, nchans=nchans)


def _h_unpack(ctx):
    if ctx.nbits not in (1, 2, 4):  # byte data uploads unpacked
        return None
    return dict(nsamps=ctx.nsamps, nchans=ctx.nchans, nbits=ctx.nbits)


def _dedisperse_matmul(dev, nsamps=2048, nchans=64, ndm=32, spread=40):
    from .dedisperse import dedisperse_matmul

    delays = _delays(15, ndm, nchans, spread)
    return dedisperse_matmul, (_fil(_gen(15), dev, nsamps + spread, nchans), delays,
                               np.ones(nchans, np.int32), nsamps), {}


def _h_dedisperse_matmul(ctx):
    if ctx.dedisp_engine not in ("", "matmul") or ctx.out_nsamps <= 0:
        return None
    return dict(nsamps=ctx.out_nsamps, nchans=ctx.nchans, ndm=min(ctx.ndm, 4),
                spread=max(0, ctx.nsamps - ctx.out_nsamps))


def _stage1_inputs(dev, seed: int, nchans=64, subbands=8, out_len=2048, spread=64):
    s = max(1, min(subbands, nchans))
    w = -(-nchans // s)
    s = -(-nchans // w)
    x = _fil(_gen(seed), dev, s * w, out_len + spread).reshape(s, w, out_len + spread)
    d1 = np.random.default_rng(seed).integers(0, spread // 2, size=(4, s, w))
    return x, np.ones((s, w), np.float32), d1, out_len


def _h_subbands(ctx, matmul: bool):
    if ctx.subbands <= 0 or ctx.subband_matmul != matmul or ctx.out_nsamps <= 0:
        return None
    return dict(nchans=ctx.nchans, subbands=ctx.subbands, out_len=ctx.out_nsamps,
                spread=max(4, ctx.nsamps - ctx.out_nsamps))


def _subband_stage1(dev, **sizes):
    from .dedisperse import subband_stage1

    return subband_stage1, _stage1_inputs(dev, 16, **sizes), {}


def _subband_stage1_matmul(dev, **sizes):
    from .dedisperse import subband_stage1_matmul

    return subband_stage1_matmul, _stage1_inputs(dev, 17, **sizes), {}


def _stage2_inputs(dev, seed: int, nchans=64, subbands=8, out_len=2048, spread=64):
    g_n, g_pad = 4, 4
    s = -(-nchans // -(-nchans // max(1, min(subbands, nchans))))
    rd = np.random.default_rng(seed).integers(0, spread // 2, size=(g_n, g_pad, s))
    return _randn(_gen(seed), dev, g_n, s, out_len + spread // 2), rd, out_len


def _subband_stage2(dev, **sizes):
    from .dedisperse import subband_stage2

    return subband_stage2, _stage2_inputs(dev, 18, **sizes), {}


def _subband_stage2_matmul(dev, **sizes):
    from .dedisperse import subband_stage2_matmul

    return subband_stage2_matmul, _stage2_inputs(dev, 19, **sizes), {}


def _correlate_bank(dev, nbins=4096, templates=8, width=33, segment=512):
    from .fdas import correlate_bank

    g = _gen(20)
    return correlate_bank, (_complex(g, dev, 2, nbins), _complex(g, dev, templates, width)), dict(
        segment=segment)


def _h_fdas(ctx):
    if ctx.fdas_templates <= 0 or ctx.fft_size <= 0:
        return None  # not an FDAS context
    return dict(nbins=_nbins(ctx), templates=ctx.fdas_templates, width=ctx.fdas_width,
                segment=ctx.fdas_segment)


def _fdas_spectrum_peaks(dev, rows=2, nbins=4096, templates=8, width=33, segment=512,
                         nharms=2):
    from .fdas import fdas_spectrum_peaks

    g = _gen(21)
    windows = np.tile(np.asarray([[16, nbins]], np.int32), (nharms + 1, 1))
    return fdas_spectrum_peaks, (_complex(g, dev, rows, nbins), _complex(g, dev, templates, width),
                                 windows), dict(threshold=6.0, segment=segment, nharms=nharms,
                                                max_peaks=16)


def _h_fdas_peaks(ctx):
    sizes = _h_fdas(ctx)
    return None if sizes is None else dict(sizes, rows=_rows(ctx, 2), nharms=ctx.nharms)


def _ffa_octave(dev, n=2048, m_pad=16, rows=2):
    from .ffa import duty_cycle_widths, ffa_octave

    return ffa_octave, (_randn(_gen(22), dev, rows, n), m_pad, duty_cycle_widths(0.05)), {}


def _h_ffa(ctx):
    """The first octave (the largest) at the bucket's trial length."""
    from .ffa import _PMIN

    n = ctx.out_nsamps
    if n < 2 * _PMIN:
        return None
    return dict(n=n, m_pad=1 << max(1, int(np.ceil(np.log2(max(2, n // _PMIN))))), rows=1)


def _fold_inputs(n: int, nbins: int = 64, nints: int = 16):
    from .fold import fold_bins_np

    return fold_bins_np(n, 1e-3, 0.0573, nbins, nints)


def _fold_time_series(dev, n=4096):
    from .fold import fold_time_series

    bins = torch.from_numpy(np.tile(_fold_inputs(n), (3, 1))).to(dev)
    return fold_time_series, (_randn(_gen(23), dev, 3, bins.shape[1]), bins), dict(
        nbins=64, nints=16)


def _h_fold(ctx):
    return None if ctx.fold_nsamps < 16 else dict(n=ctx.fold_nsamps)


def _optimise_device(dev):
    from .fold_optimise import NBINS, NINTS, FoldOptimiser

    opt = FoldOptimiser()
    opt._shiftar, opt._templates = opt._shiftar.to(dev), opt._templates.to(dev)
    return opt._device_pass, (0.5 + _rand(_gen(24), dev, 3, NINTS, NBINS),), {}


def _h_optimise(ctx):
    """Every fold optimises the reference's 64 x 16 profiles: one shape at
    every rung."""
    return None if ctx.fold_nsamps <= 0 else {}


def _harmonic_sums(dev, rows=4, nbins=8193, nharms=4):
    from .harmonics import harmonic_sums

    return harmonic_sums, (_rand(_gen(25), dev, rows, nbins),), dict(nharms=nharms)


def _find_peaks_device(dev, rows=4, nbins=8193):
    from .peaks import find_peaks_device

    spec = _randn(_gen(26), dev, rows, nbins).abs() * 4
    lim = torch.full((rows,), nbins, dtype=torch.int64, device=dev)
    return find_peaks_device, (spec, 9.0, torch.zeros_like(lim), lim), dict(max_peaks=32)


def _cluster_peaks_device(dev, rows=4, nbins=8193):
    from .peaks import cluster_peaks_device

    fn, args, kw = _find_peaks_device(dev, rows, nbins)
    return cluster_peaks_device, fn(*args, **kw), dict(nbins=nbins)


def _peak_slots(dev, seed: int, dm_block=4, nlev=5, accel_pad=8, max_peaks=16):
    """(idxs, snrs, counts, cluster counts) of (dm_block, nlev, accel_pad)
    cells of ``max_peaks`` slots, as a round's row batches leave them: some
    cells empty, some past their slots."""
    g = _gen(seed)
    cells = (dm_block, nlev, accel_pad)
    idxs = torch.randint(0, 1 << 20, (*cells, max_peaks), generator=g, dtype=torch.int32)
    cc = torch.randint(0, max_peaks + 3, cells, generator=g, dtype=torch.int32)
    return (idxs.to(dev), _rand(g, dev, *cells, max_peaks),
            (cc + torch.randint(0, 8, cells, generator=g, dtype=torch.int32)).to(dev), cc.to(dev))


def _compact_peaks_device(dev, total_pad=4096, **sizes):
    from .peaks import compact_peaks_device

    idxs, snrs, _, cc = _peak_slots(dev, 46, **sizes)
    return compact_peaks_device, (idxs, snrs, cc), dict(total_pad=total_pad)


def _pack_chunk_results(dev, total_pad=4096, **sizes):
    from .peaks import pack_chunk_results

    return pack_chunk_results, _peak_slots(dev, 47, **sizes), dict(total_pad=total_pad)


def _h_peak_slots(ctx):
    """The JAX package's ops/peaks.py:_param_compact_peaks: the cells of a
    DM block, (dm_block, nharms+1, accel_pad), its slots, a 4096-entry
    stream."""
    if ctx.fft_size <= 0 or ctx.accel_pad <= 0:
        return None
    return dict(dm_block=_rows(ctx), nlev=ctx.nharms + 1, accel_pad=ctx.accel_pad,
                max_peaks=ctx.max_peaks)


def _h_bins(ctx):
    return None if ctx.fft_size <= 0 else dict(rows=_rows(ctx), nbins=_nbins(ctx))


def _running_median(dev, rows=4, nbins=8193, pos5=40, pos25=400):
    from .rednoise import running_median

    return running_median, (0.5 + _rand(_gen(27), dev, rows, nbins),), dict(pos5=pos5,
                                                                            pos25=pos25)


def _whiten_fseries(dev, rows=4, n=16384, pos5=40, pos25=400):
    from .rednoise import whiten_fseries

    return whiten_fseries, (_randn(_gen(28), dev, rows, n),), dict(pos5=pos5, pos25=pos25)


def _h_whiten(ctx, key: str):
    if ctx.fft_size <= 0 or ctx.pos25 <= 0:
        return None
    size = _nbins(ctx) if key == "nbins" else ctx.fft_size
    return {"rows": _rows(ctx), key: size, "pos5": ctx.pos5, "pos25": ctx.pos25}


def _resample_accel_quadratic(dev, n=1 << 15, naccel=16):
    from .resample import resample_accel_quadratic

    afs = torch.linspace(-2e-9, 2e-9, naccel, dtype=torch.float32).to(dev)
    return resample_accel_quadratic, (_randn(_gen(29), dev, n), afs), {}


def _h_quadratic(ctx):
    if ctx.fft_size <= 0:
        return None
    return dict(n=ctx.fft_size, naccel=max(1, min(ctx.accel_pad, 16)))


def _normalise_trials(dev, rows=16, n=8192):
    from .singlepulse import normalise_trials

    return normalise_trials, (_randn(_gen(30), dev, rows, n),), {}


def _h_sp_trials(ctx):
    if not ctx.widths or ctx.out_nsamps <= 0:
        return None
    return dict(rows=_rows(ctx), n=ctx.out_nsamps)


def _single_pulse_search_block(dev, rows=8, n=8192, widths=None, dec=32):
    from .singlepulse import default_widths, single_pulse_search_block

    trials = torch.randint(0, 256, (rows, n), generator=_gen(31), dtype=torch.uint8)
    return single_pulse_search_block, (trials.to(dev), widths or default_widths(8), 6.0, 64,
                                       dec), {}


def _h_sp_search(ctx):
    sizes = _h_sp_trials(ctx)
    if sizes is None or ctx.decimate <= 1 or ctx.tpad % ctx.decimate:
        return None
    return dict(sizes, widths=tuple(ctx.widths), dec=ctx.decimate)


def _spectrum_op(name: str, seed: int):
    def build(dev, rows=4, nbins=8193):
        from . import spectrum

        g = _gen(seed)
        if name in ("form_interpolated", "form_power"):
            args = (_complex(g, dev, rows, nbins),)
        elif name == "form_interpolated_parts":
            args = (_randn(g, dev, rows, nbins), _randn(g, dev, rows, nbins))
        elif name == "normalise":
            args = (_randn(g, dev, rows, nbins), _randn(g, dev, rows, 1),
                    0.5 + _rand(g, dev, rows, 1))
        else:  # spectrum_stats
            args = (_randn(g, dev, rows, nbins),)
        return getattr(spectrum, name), args, {}
    return build


def _stream_chunk_search(dev, rows=4, widths=None, chunk=4096, dec=32):
    from .singlepulse import default_widths
    from .streaming import make_stream_chunk_fn, stream_geometry

    widths = widths or default_widths(6)
    hold = stream_geometry(widths, chunk, dec)
    fn = make_stream_chunk_fn(widths, 6.0, 64, dec, hold, chunk)
    g = _gen(32)
    return fn, (_randn(g, dev, rows, hold), _randn(g, dev, rows, chunk), 0, hold + chunk, 0,
                chunk // dec), {}


def _h_stream(ctx):
    """The context's chunk, or the smallest that holds the carried tail of
    its width bank (the stream's own geometry rule, ops/streaming.py)."""
    if not (ctx.stream_chunk and ctx.widths) or ctx.decimate <= 1:
        return None
    dec = ctx.decimate
    hold = -(-max(max(ctx.widths), dec) // dec) * dec
    chunk = max(-(-ctx.stream_chunk // dec) * dec, hold)
    return dict(rows=_rows(ctx), widths=tuple(ctx.widths), chunk=chunk, dec=dec)


def _survey_fold_batch(dev, n=4096):
    from .survey_fold import survey_fold_batch

    bins = torch.from_numpy(np.tile(_fold_inputs(n), (3, 1))).to(dev)
    afs = torch.tensor([0.0, 1e-9, -1e-9], dtype=torch.float32).to(dev)
    return survey_fold_batch, (_randn(_gen(33), dev, 3, n), afs, bins), dict(
        nbins=64, nints=16)


def _zap_birdies(dev, rows=4, nbins=8193):
    from .zap import zap_birdies

    mask = torch.zeros(nbins, dtype=torch.bool)
    mask[nbins // 80 - 2 : nbins // 80 + 8] = True
    return zap_birdies, (_complex(_gen(34), dev, rows, nbins), mask.to(dev)), {}


_OP_BUILDS = {
    "ops.candidate_features.candidate_features_batch": (_candidate_features_batch,
                                                        _h_fold_batch),
    "ops.candidate_features.score_apply": (_score_apply, _h_score),
    "ops.coincidence.coincidence_mask": (_coincidence_mask, _h_trial_len),
    "ops.correlate.find_delays": (_find_delays, _h_find_delays),
    "ops.dedisperse.unpack_fil_device": (_unpack_fil_device, _h_unpack),
    "ops.dedisperse.dedisperse_matmul": (_dedisperse_matmul, _h_dedisperse_matmul),
    "ops.dedisperse.subband_stage1": (_subband_stage1, lambda c: _h_subbands(c, False)),
    "ops.dedisperse.subband_stage1_matmul": (_subband_stage1_matmul,
                                             lambda c: _h_subbands(c, True)),
    "ops.dedisperse.subband_stage2": (_subband_stage2, lambda c: _h_subbands(c, False)),
    "ops.dedisperse.subband_stage2_matmul": (_subband_stage2_matmul,
                                             lambda c: _h_subbands(c, True)),
    "ops.fdas.correlate_bank": (_correlate_bank, _h_fdas),
    "ops.fdas.fdas_spectrum_peaks": (_fdas_spectrum_peaks, _h_fdas_peaks),
    "ops.ffa.ffa_octave": (_ffa_octave, _h_ffa),
    "ops.fold.fold_time_series": (_fold_time_series, _h_fold),
    "ops.fold_optimise.optimise_device": (_optimise_device, _h_optimise),
    "ops.harmonics.harmonic_sums": (_harmonic_sums, lambda c: None if c.fft_size <= 0 else dict(
        rows=_rows(c), nbins=_nbins(c), nharms=c.nharms)),
    "ops.peaks.cluster_peaks_device": (_cluster_peaks_device, _h_bins),
    "ops.peaks.compact_peaks_device": (_compact_peaks_device, _h_peak_slots),
    "ops.peaks.pack_chunk_results": (_pack_chunk_results, _h_peak_slots),
    "ops.peaks.find_peaks_device": (_find_peaks_device, _h_bins),
    "ops.rednoise.running_median": (_running_median, lambda c: _h_whiten(c, "nbins")),
    "ops.rednoise.whiten_fseries": (_whiten_fseries, lambda c: _h_whiten(c, "n")),
    "ops.resample.resample_accel_quadratic": (_resample_accel_quadratic, _h_quadratic),
    "ops.singlepulse.normalise_trials": (_normalise_trials, _h_sp_trials),
    "ops.singlepulse.single_pulse_search_block": (_single_pulse_search_block, _h_sp_search),
    **{f"ops.spectrum.{n}": (_spectrum_op(n, 35 + i), _h_bins) for i, n in enumerate(
        ("form_interpolated", "form_interpolated_parts", "form_power", "normalise",
         "spectrum_stats"))},
    "ops.streaming.stream_chunk_search": (_stream_chunk_search, _h_stream),
    "ops.survey_fold.survey_fold_batch": (_survey_fold_batch, _h_fold),
    "ops.zap.zap_birdies": (_zap_birdies, _h_bins),
}


# programs whose call reads a value back from the card, and why
_COUNT_READ = ("find_peaks_device without max_peaks reads the largest crossing count "
               "to size the block's events (ops/peaks.py:69)")
_ALLOW_SYNCS: dict[str, tuple[tuple[str, str], ...]] = {
    "kernels.resample": (
        ("aten::_to_copy (device to host)",
         "the wrapper reads row_dm's bounds to check them before the kernel gathers "
         "with it (ops/resample.py:112), one read a call"),),
    "ops.singlepulse.single_pulse_search_block": (
        ("aten::_local_scalar_dense", _COUNT_READ), ("aten::nonzero", _COUNT_READ)),
}


def registered_programs() -> tuple[ProgramSpec, ...]:
    """Every registered program, sorted by name: the kernels as
    ``kernels.<name>``, then the torch ops as ``ops.<module>.<function>``."""
    specs = [ProgramSpec(f"kernels.{k}", b, kernel=k, param=h,
                         allow_syncs=_ALLOW_SYNCS.get(f"kernels.{k}", ()))
             for k, (b, h) in _KERNEL_BUILDS.items()]
    specs += [ProgramSpec(n, b, param=h, allow_syncs=_ALLOW_SYNCS.get(n, ()))
              for n, (b, h) in _OP_BUILDS.items()]
    return tuple(sorted(specs, key=lambda s: s.name))


def unregistered_programs() -> list[tuple[str, str]]:
    """(name, why) for each kernel of ``kernels.KERNELS`` and each
    counterpart :data:`JAX_COUNTERPARTS` names that has no registered
    program. Empty means every kernel and every counterpart is warmed and
    benchmarked."""
    from .. import kernels

    names = {s.name for s in registered_programs()}
    missing = [(f"kernels.{k}", "kernel without a registry entry")
               for k in kernels.KERNELS if f"kernels.{k}" not in names]
    missing += [(port, f"counterpart of the JAX registry's {jax} without a registry entry")
                for jax, port in sorted(JAX_COUNTERPARTS.items())
                if port.startswith(("ops.", "kernels.")) and port not in names]
    return missing
