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

Build = Callable[[torch.device], tuple[Callable, tuple, dict[str, Any]]]


@dataclass(frozen=True)
class ProgramSpec:
    """One registered program. ``kernel`` names the kernel its CUDA call
    launches ("" for a torch op)."""

    name: str
    build: Build
    kernel: str = ""


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
    "ops.peaks.compact_peaks_device": (
        "the peaks and harmpeaks kernels compact the clusters in their walk "
        "(kernels.peaks, kernels.harmpeaks)"),
    "ops.peaks.find_peaks_device": "ops.peaks.find_peaks_device",
    "ops.peaks.pack_chunk_results": (
        "the port unpacks each DM trial's cluster slots on the host "
        "(pipeline/search.py:PeasoupSearch._collect); nothing packs them on the card"),
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


def _boxcar_args(dev, nsamps: int = 8192, n_widths: int = 8, seed: int = 6):
    from . import singlepulse as sp

    x = _randn(_gen(seed), dev, 4, nsamps)
    widths = sp.default_widths(n_widths)
    tpad, _ = sp.plan_pad(nsamps)
    csum = sp.prefix_sum_padded(sp.normalise_trials(x), tpad, sp.width_extent(widths))
    return csum, widths, sp.width_scales(widths), nsamps, tpad


def _peaks_levels(dev, rows: int = 4, nbins: int = 8000, nlev: int = 5, seed: int = 8):
    g = _gen(seed)
    npad = -(-nbins // 4096) * 4096
    levels = []
    for lv in range(nlev):
        s = torch.randn((rows, nbins), generator=g).abs()
        s[:, lv::61] += 30.0
        levels.append(torch.nn.functional.pad(s, (0, npad - nbins), value=1e9).to(dev))
    windows = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (nlev, 1))
    return levels, windows, nbins


# --------------------------------------------------------------------------
# the kernels, through their wrappers
# --------------------------------------------------------------------------

def _k_dedisperse(dev):
    from .dedisperse import dedisperse

    delays = _delays(0, 32, 64, 200)
    x = _fil(_gen(0), dev, 4096 + 200, 64)
    return dedisperse, (x, delays, np.ones(64, np.int32), 4096), {}


def _k_resample(dev):
    from .resample import resample_rows

    g = _gen(1)
    row_dm = (torch.arange(32, dtype=torch.int32) % 4).to(dev)
    afs = torch.linspace(-2e-9, 2e-9, 32, dtype=torch.float32).to(dev)
    return resample_rows, (_randn(g, dev, 4, 1 << 15), row_dm, afs), {}


def _k_specchain(dev):
    from .spectrum import specchain

    g = _gen(2)
    rows, nbins = 8, 8193
    zap = torch.zeros(nbins, dtype=torch.bool)
    zap[[2, 511, 512]] = True
    return specchain, (_randn(g, dev, rows, nbins), _randn(g, dev, rows, nbins),
                       0.5 + _rand(g, dev, rows, nbins), zap.to(dev)), {}


def _k_interbin(dev):
    from .fft import packed_dft_z, untwist_interbin_normalise

    g = _gen(3)
    n = 1 << 14
    z = packed_dft_z(_randn(g, dev, 4, n))
    return (untwist_interbin_normalise, (z, _randn(g, dev, 4), 0.5 + _rand(g, dev, 4)),
            dict(npad=n // 2 + 2))


def _k_dftspec(dev):
    from .dftspec import dft_untwist_interbin

    g = _gen(4)
    n = 1 << 15
    npad = -(-(n // 2 + 1) // 4096) * 4096
    return (dft_untwist_interbin, (_randn(g, dev, 4, n), _randn(g, dev, 4),
                                   0.5 + _rand(g, dev, 4)), dict(npad=npad))


def _k_peaks(dev):
    from .harmonics import level_scales
    from .peaks import find_cluster_peaks_multi

    levels, windows, nbins = _peaks_levels(dev)
    return find_cluster_peaks_multi, (levels, windows), dict(
        threshold=9.0, max_peaks=16, scales=level_scales(len(levels) - 1), nbins=nbins)


def _k_harmpeaks(dev):
    from .harmonics import level_scales
    from .peaks import find_harmonic_cluster_peaks

    levels, windows, nbins = _peaks_levels(dev)
    return find_harmonic_cluster_peaks, (levels[0], windows), dict(
        nharms=4, threshold=9.0, max_peaks=16, scales=level_scales(4), nbins=nbins)


def _k_boxcar(dev):
    from .singlepulse import boxcar_best

    return boxcar_best, _boxcar_args(dev), {}


def _k_spchain(dev):
    from .singlepulse import boxcar_dec_best

    return boxcar_dec_best, (*_boxcar_args(dev), 32), {}


_KERNEL_BUILDS = {
    "dedisperse": _k_dedisperse,
    "resample": _k_resample,
    "specchain": _k_specchain,
    "interbin": _k_interbin,
    "dftspec": _k_dftspec,
    "peaks": _k_peaks,
    "harmpeaks": _k_harmpeaks,
    "boxcar": _k_boxcar,
    "spchain": _k_spchain,
}


# --------------------------------------------------------------------------
# the torch ops with a counterpart in the JAX registry
# --------------------------------------------------------------------------

def _candidate_features_batch(dev):
    from .candidate_features import DM_CURVE_POINTS, candidate_features_batch

    g = _gen(10)
    return candidate_features_batch, (0.5 + _rand(g, dev, 3, 16), 0.5 + _rand(g, dev, 3, 4, 16),
                                      0.5 + _rand(g, dev, 3, DM_CURVE_POINTS)), {}


def _score_apply(dev):
    from .candidate_features import NFEATURES, score_apply

    g = _gen(11)
    return score_apply, (_randn(g, dev, 3, NFEATURES), _randn(g, dev, NFEATURES),
                         0.5 + _rand(g, dev, NFEATURES), _randn(g, dev, NFEATURES, 16),
                         _randn(g, dev, 16), _randn(g, dev, 16), _randn(g, dev)), {}


def _coincidence_mask(dev):
    from .coincidence import coincidence_mask

    return coincidence_mask, (_randn(_gen(12), dev, 4, 4096), 3.0, 2), {}


def _find_delays(dev):
    from .correlate import find_delays

    return find_delays, (_randn(_gen(13), dev, 3, 4096), 64), {}


def _unpack_fil_device(dev):
    from .dedisperse import unpack_fil_device

    raw = torch.randint(0, 256, (4096 * 64 // 4,), generator=_gen(14), dtype=torch.uint8)
    return unpack_fil_device, (raw.to(dev),), dict(nbits=2, nsamps=4096, nchans=64)


def _dedisperse_matmul(dev):
    from .dedisperse import dedisperse_matmul

    delays = _delays(15, 32, 64, 40)
    return dedisperse_matmul, (_fil(_gen(15), dev, 2048 + 40, 64), delays,
                               np.ones(64, np.int32), 2048), {}


def _stage1_inputs(dev, seed: int):
    s, w, t, g_n = 8, 8, 2048 + 64, 4
    x = _fil(_gen(seed), dev, s * w, t).reshape(s, w, t)
    d1 = np.random.default_rng(seed).integers(0, 32, size=(g_n, s, w))
    return x, np.ones((s, w), np.float32), d1, 2048


def _subband_stage1(dev):
    from .dedisperse import subband_stage1

    return subband_stage1, _stage1_inputs(dev, 16), {}


def _subband_stage1_matmul(dev):
    from .dedisperse import subband_stage1_matmul

    return subband_stage1_matmul, _stage1_inputs(dev, 17), {}


def _stage2_inputs(dev, seed: int):
    g_n, g_pad, s, out = 4, 4, 8, 2048
    rd = np.random.default_rng(seed).integers(0, 32, size=(g_n, g_pad, s))
    return _randn(_gen(seed), dev, g_n, s, out + 32), rd, out


def _subband_stage2(dev):
    from .dedisperse import subband_stage2

    return subband_stage2, _stage2_inputs(dev, 18), {}


def _subband_stage2_matmul(dev):
    from .dedisperse import subband_stage2_matmul

    return subband_stage2_matmul, _stage2_inputs(dev, 19), {}


def _correlate_bank(dev):
    from .fdas import correlate_bank

    g = _gen(20)
    return correlate_bank, (_complex(g, dev, 2, 4096), _complex(g, dev, 8, 33)), dict(
        segment=512)


def _fdas_spectrum_peaks(dev):
    from .fdas import fdas_spectrum_peaks

    g = _gen(21)
    nbins = 4096
    windows = np.asarray([[16, nbins], [16, nbins], [16, nbins]], np.int32)
    return fdas_spectrum_peaks, (_complex(g, dev, 2, nbins), _complex(g, dev, 8, 33),
                                 windows), dict(threshold=6.0, segment=512, nharms=2,
                                                max_peaks=16)


def _ffa_octave(dev):
    from .ffa import duty_cycle_widths, ffa_octave

    return ffa_octave, (_randn(_gen(22), dev, 2, 2048), 16, duty_cycle_widths(0.05)), {}


def _fold_inputs(n: int, nbins: int = 64, nints: int = 16):
    from .fold import fold_bins_np

    return fold_bins_np(n, 1e-3, 0.0573, nbins, nints)


def _fold_time_series(dev):
    from .fold import fold_time_series

    bins = torch.from_numpy(np.tile(_fold_inputs(4096), (3, 1))).to(dev)
    return fold_time_series, (_randn(_gen(23), dev, 3, bins.shape[1]), bins), dict(
        nbins=64, nints=16)


def _optimise_device(dev):
    from .fold_optimise import NBINS, NINTS, FoldOptimiser

    opt = FoldOptimiser()
    opt._shiftar, opt._templates = opt._shiftar.to(dev), opt._templates.to(dev)
    return opt._device_pass, (0.5 + _rand(_gen(24), dev, 3, NINTS, NBINS),), {}


def _harmonic_sums(dev):
    from .harmonics import harmonic_sums

    return harmonic_sums, (_rand(_gen(25), dev, 4, 8193),), dict(nharms=4)


def _find_peaks_device(dev):
    from .peaks import find_peaks_device

    spec = _randn(_gen(26), dev, 4, 8193).abs() * 4
    lim = torch.full((4,), 8193, dtype=torch.int64, device=dev)
    return find_peaks_device, (spec, 9.0, torch.zeros_like(lim), lim), dict(max_peaks=32)


def _cluster_peaks_device(dev):
    from .peaks import cluster_peaks_device

    fn, args, kw = _find_peaks_device(dev)
    return cluster_peaks_device, fn(*args, **kw), dict(nbins=8193)


def _running_median(dev):
    from .rednoise import running_median

    return running_median, (0.5 + _rand(_gen(27), dev, 4, 8193),), dict(pos5=40, pos25=400)


def _whiten_fseries(dev):
    from .rednoise import whiten_fseries

    return whiten_fseries, (_randn(_gen(28), dev, 4, 16384),), dict(pos5=40, pos25=400)


def _resample_accel_quadratic(dev):
    from .resample import resample_accel_quadratic

    afs = torch.linspace(-2e-9, 2e-9, 16, dtype=torch.float32).to(dev)
    return resample_accel_quadratic, (_randn(_gen(29), dev, 1 << 15), afs), {}


def _normalise_trials(dev):
    from .singlepulse import normalise_trials

    return normalise_trials, (_randn(_gen(30), dev, 16, 8192),), {}


def _single_pulse_search_block(dev):
    from .singlepulse import default_widths, single_pulse_search_block

    trials = torch.randint(0, 256, (8, 8192), generator=_gen(31), dtype=torch.uint8)
    return single_pulse_search_block, (trials.to(dev), default_widths(8), 6.0, 64, 32), {}


def _spectrum_op(name: str, seed: int):
    def build(dev):
        from . import spectrum

        g = _gen(seed)
        if name in ("form_interpolated", "form_power"):
            args = (_complex(g, dev, 4, 8193),)
        elif name == "form_interpolated_parts":
            args = (_randn(g, dev, 4, 8193), _randn(g, dev, 4, 8193))
        elif name == "normalise":
            args = (_randn(g, dev, 4, 8193), _randn(g, dev, 4, 1), 0.5 + _rand(g, dev, 4, 1))
        else:  # spectrum_stats
            args = (_randn(g, dev, 4, 8193),)
        return getattr(spectrum, name), args, {}
    return build


def _stream_chunk_search(dev):
    from .singlepulse import default_widths
    from .streaming import make_stream_chunk_fn, stream_geometry

    widths, chunk, dec = default_widths(6), 4096, 32
    hold = stream_geometry(widths, chunk, dec)
    fn = make_stream_chunk_fn(widths, 6.0, 64, dec, hold, chunk)
    g = _gen(32)
    return fn, (_randn(g, dev, 4, hold), _randn(g, dev, 4, chunk), 0, hold + chunk, 0,
                chunk // dec), {}


def _survey_fold_batch(dev):
    from .survey_fold import survey_fold_batch

    bins = torch.from_numpy(np.tile(_fold_inputs(4096), (3, 1))).to(dev)
    afs = torch.tensor([0.0, 1e-9, -1e-9], dtype=torch.float32).to(dev)
    return survey_fold_batch, (_randn(_gen(33), dev, 3, 4096), afs, bins), dict(
        nbins=64, nints=16)


def _zap_birdies(dev):
    from .zap import zap_birdies

    mask = torch.zeros(8193, dtype=torch.bool)
    mask[100:110] = True
    return zap_birdies, (_complex(_gen(34), dev, 4, 8193), mask.to(dev)), {}


_OP_BUILDS = {
    "ops.candidate_features.candidate_features_batch": _candidate_features_batch,
    "ops.candidate_features.score_apply": _score_apply,
    "ops.coincidence.coincidence_mask": _coincidence_mask,
    "ops.correlate.find_delays": _find_delays,
    "ops.dedisperse.unpack_fil_device": _unpack_fil_device,
    "ops.dedisperse.dedisperse_matmul": _dedisperse_matmul,
    "ops.dedisperse.subband_stage1": _subband_stage1,
    "ops.dedisperse.subband_stage1_matmul": _subband_stage1_matmul,
    "ops.dedisperse.subband_stage2": _subband_stage2,
    "ops.dedisperse.subband_stage2_matmul": _subband_stage2_matmul,
    "ops.fdas.correlate_bank": _correlate_bank,
    "ops.fdas.fdas_spectrum_peaks": _fdas_spectrum_peaks,
    "ops.ffa.ffa_octave": _ffa_octave,
    "ops.fold.fold_time_series": _fold_time_series,
    "ops.fold_optimise.optimise_device": _optimise_device,
    "ops.harmonics.harmonic_sums": _harmonic_sums,
    "ops.peaks.cluster_peaks_device": _cluster_peaks_device,
    "ops.peaks.find_peaks_device": _find_peaks_device,
    "ops.rednoise.running_median": _running_median,
    "ops.rednoise.whiten_fseries": _whiten_fseries,
    "ops.resample.resample_accel_quadratic": _resample_accel_quadratic,
    "ops.singlepulse.normalise_trials": _normalise_trials,
    "ops.singlepulse.single_pulse_search_block": _single_pulse_search_block,
    **{f"ops.spectrum.{n}": _spectrum_op(n, 35 + i) for i, n in enumerate(
        ("form_interpolated", "form_interpolated_parts", "form_power", "normalise",
         "spectrum_stats"))},
    "ops.streaming.stream_chunk_search": _stream_chunk_search,
    "ops.survey_fold.survey_fold_batch": _survey_fold_batch,
    "ops.zap.zap_birdies": _zap_birdies,
}


def registered_programs() -> tuple[ProgramSpec, ...]:
    """Every registered program, sorted by name: the kernels as
    ``kernels.<name>``, then the torch ops as ``ops.<module>.<function>``."""
    specs = [ProgramSpec(f"kernels.{k}", b, kernel=k) for k, b in _KERNEL_BUILDS.items()]
    specs += [ProgramSpec(n, b) for n, b in _OP_BUILDS.items()]
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
