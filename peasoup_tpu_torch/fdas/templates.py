"""Finite-duration response template banks for the FDAS search.

A pulsar with constant frequency drift smears its Fourier power over
neighbouring bins: over an observation of T seconds a drift of
``fdot`` Hz/s moves the signal by ``z = fdot * T**2`` DFT bins, and a
jerk ``fddot`` Hz/s^2 curves it by ``w = fddot * T**3`` bins. The
matched filter for a drifting tone is the complex conjugate of its
own finite-duration Fourier response, so the search correlates the
dereddened spectrum against a bank of such responses — one template
per (z, w) trial — and reads the recovered power off the correlation
output (Ransom et al. 2002; the PRESTO accelsearch formulation).

Everything in this module is host-side numpy and cheap relative to a
search; the bank for one (zmax, wmax) geometry is lru-cached. It is the
port's copy of the JAX package's peasoup_tpu/fdas/templates.py, line for
line, so the bank is bitwise the JAX package's (the bank plays the part
of weights here; tests/test_torch_fdas.py holds it so). The geometry
helpers (:func:`template_half_width`, :func:`auto_segment`) are shared by
the device code (ops/fdas.py) and the driver (pipeline/fdas.py).

Template math: for a tone at bin offset ``d`` from the template
centre the finite-duration response is

    A_{z,w}(d) = (1/M) * sum_m exp(2j*pi*(w*u^3/6 + z*u^2/2 - d*u))

with ``u = (m + 0.5)/M`` the normalised time over the observation,
evaluated by midpoint quadrature with ``M`` samples. ``z`` and ``w``
are the TOTAL drift/curvature in bins over the observation; the
``z*u^2/2`` phase term is the integral of a linearly drifting
frequency, ``w*u^3/6`` of a quadratically drifting one. Templates
are normalised to unit energy so correlation output power is
directly comparable across the bank, and the ``z = w = 0`` template
collapses to (a discretised) delta — the zero-drift row of the FDAS
plane reproduces the plain power spectrum, which is what the z=0
parity tests pin.

Sign convention (matches ``plan/accel_plan.py`` and the time-domain
resampling search): a POSITIVE line-of-sight acceleration ``a``
stretches the apparent period, i.e. ``fdot = -a * f / c`` — so an
``a > 0`` injection is recovered by a NEGATIVE-z template.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

SPEED_OF_LIGHT = 299792458.0  # m/s

# extra single-sided template reach beyond the drift extent: the
# finite-duration response of a tone decays slowly (~1/d) past the
# swept range, and the interbin/harmonic stages downstream read
# power right up to the template edge
_EDGE_PAD = 16

# quadrature floor: enough midpoint samples that the z = w = 0
# template is a delta to f32 precision even for narrow banks
_MIN_QUAD = 256


def template_half_width(zmax: float, wmax: float = 0.0) -> int:
    """Single-sided template extent in bins for a (zmax, wmax) bank.

    A drift of z bins sweeps the tone across |z| bins centred z/2
    from its start frequency; with the template centred on the
    mid-observation frequency the response spans ~|z|/2 + |w|/8 bins
    each side, padded so the slowly-decaying tails are captured.
    Shared by the bank builder and the driver.
    """
    reach = abs(float(zmax)) / 2.0 + abs(float(wmax)) / 8.0
    return int(np.ceil(reach)) + _EDGE_PAD


def effective_zmax(zmax: float, wmax: float = 0.0) -> int:
    """The pure-z extent whose template width equals the (zmax, wmax)
    bank's: ``template_half_width(effective_zmax(z, w)) ==
    template_half_width(z, w)``."""
    return 2 * (template_half_width(zmax, wmax) - _EDGE_PAD)


def auto_segment(width: int) -> int:
    """Overlap-save FFT segment length for templates of ``width``
    taps: the next power of two >= max(1024, 4*(width-1)), which
    keeps the valid fraction of each segment >= 3/4 while staying in
    pow2 FFT sizes the fft machinery is fastest at."""
    target = max(1024, 4 * (max(int(width), 1) - 1))
    return 1 << int(np.ceil(np.log2(target)))


def z_trials(zmax: float, zstep: float = 2.0) -> np.ndarray:
    """Symmetric f-dot trial grid in bins: 0, ±zstep, … ±zmax.

    zstep defaults to 2 bins — the classic accelsearch spacing where
    adjacent templates overlap at ~the half-power point, so no drift
    inside ±zmax falls between trials.
    """
    zmax = abs(float(zmax))
    if zmax == 0.0:
        return np.zeros(1, dtype=np.float64)
    n = int(np.floor(zmax / float(zstep) + 1e-9))
    ladder = np.arange(1, n + 1, dtype=np.float64) * float(zstep)
    return np.concatenate([[0.0], np.stack([ladder, -ladder], 1).ravel()])


def w_trials(wmax: float, wstep: float = 20.0) -> np.ndarray:
    """Symmetric f-ddot (jerk) trial grid in bins; [0] when the jerk
    plane is off. The default 20-bin spacing mirrors the coarse jerk
    ladders PRESTO uses — curvature tolerance is much wider than
    drift tolerance."""
    wmax = abs(float(wmax))
    if wmax == 0.0:
        return np.zeros(1, dtype=np.float64)
    n = int(np.floor(wmax / float(wstep) + 1e-9))
    ladder = np.arange(1, n + 1, dtype=np.float64) * float(wstep)
    return np.concatenate([[0.0], np.stack([ladder, -ladder], 1).ravel()])


@dataclass(frozen=True)
class FdasTemplateBank:
    """One immutable (z, w) template bank.

    ``templates[t, j]`` is A_{z_t, w_t}(j - half): row ``t`` is the
    conjugate-ready finite-duration response of trial ``t`` laid out
    over ``width = 2*half + 1`` taps. Rows are independent, which is what
    lets the memory ladder halve the template batch.
    """

    zmax: float
    wmax: float
    zstep: float
    wstep: float
    half: int
    zs: np.ndarray = field(repr=False)  # (T,) f64, trial drift
    ws: np.ndarray = field(repr=False)  # (T,) f64, trial curvature
    templates: np.ndarray = field(repr=False)  # (T, 2*half+1) c64

    @property
    def ntemplates(self) -> int:
        return int(self.templates.shape[0])

    @property
    def width(self) -> int:
        return 2 * self.half + 1


def _response(
    zs: np.ndarray, ws: np.ndarray, half: int
) -> np.ndarray:
    """Midpoint-quadrature finite-duration responses, (T, 2*half+1)
    complex64, unit energy per row."""
    width = 2 * half + 1
    m = max(_MIN_QUAD, 8 * width)
    u = (np.arange(m, dtype=np.float64) + 0.5) / m  # (M,)
    d = np.arange(-half, half + 1, dtype=np.float64)  # (W,)
    # phase[t, m] for the drift part; the -d*u tone offset enters as
    # a DFT over u, evaluated for all offsets at once
    drift = (
        ws[:, None] * u[None, :] ** 3 / 6.0
        + zs[:, None] * u[None, :] ** 2 / 2.0
    )  # (T, M)
    ph = np.exp(2j * np.pi * drift)  # (T, M)
    tone = np.exp(-2j * np.pi * u[:, None] * d[None, :])  # (M, W)
    resp = ph @ tone / m  # (T, W)
    energy = np.sqrt(np.sum(np.abs(resp) ** 2, axis=1, keepdims=True))
    resp = resp / np.maximum(energy, 1e-30)
    # the zero-drift response is analytically a unit impulse; snap the
    # quadrature's ~1e-16 side-tap residue to the exact delta so the
    # z=0 trial reproduces the plain periodicity spectrum bit for bit
    zero = (zs == 0.0) & (ws == 0.0)
    if zero.any():
        delta = np.zeros(width, dtype=np.complex128)
        delta[half] = 1.0
        resp[zero] = delta
    return resp.astype(np.complex64)


@functools.lru_cache(maxsize=8)
def build_template_bank(
    zmax: float,
    wmax: float = 0.0,
    zstep: float = 2.0,
    wstep: float = 20.0,
) -> FdasTemplateBank:
    """Build (and cache) the full (z, w) product bank for a geometry.

    Trial order is the (w, z) product with zeros first on both axes,
    so template row 0 is always the zero-drift delta and the bank for
    ``wmax = 0`` is exactly the pure-acceleration bank.
    """
    zs1 = z_trials(zmax, zstep)
    ws1 = w_trials(wmax, wstep)
    zs = np.tile(zs1, len(ws1))
    ws = np.repeat(ws1, len(zs1))
    half = template_half_width(zmax, wmax)
    templates = _response(zs, ws, half)
    return FdasTemplateBank(
        zmax=float(zmax),
        wmax=float(wmax),
        zstep=float(zstep),
        wstep=float(wstep),
        half=half,
        zs=zs,
        ws=ws,
        templates=templates,
    )


def bank_geometry(
    zmax: float, wmax: float = 0.0, zstep: float = 2.0, wstep: float = 20.0
) -> tuple[int, int, int]:
    """(ntemplates, width, segment) for a geometry without building
    the bank, from the formulas the bank builder uses."""
    nt = len(z_trials(zmax, zstep)) * len(w_trials(wmax, wstep))
    half = template_half_width(zmax, wmax)
    width = 2 * half + 1
    return nt, width, auto_segment(width)
