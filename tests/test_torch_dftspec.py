"""The port's fused spectrum (peasoup_tpu_torch/ops/dftspec.py
dft_untwist_interbin: packed DFT, untwist, interbin, normalise) against
the JAX package's Pallas dftspec kernel (interpret mode) and its exact
chain (rfft_pow2_matmul_parts -> form_interpolated_parts -> normalise),
and the route helpers against the JAX package's.

Tolerance: the JAX package's accuracy gate for its kernel
(ops/pallas/dftspec.py:338-340), per-bin ``accuracy_rel`` max <= 1e-3 and
99.9% quantile <= 2e-4, against both references. The Pallas kernel is
3-pass bf16 (XLA's Precision.HIGH class); the port's plain version (an
f32 FFT) is more accurate, and it is also held to a tenth of the gate
against the exact chain (its largest residual, 1.5e-5, sits at an untwist
cancellation bin, where the f32 exact chain rounds too) and to 1e-5 at the
edge bins against an f64 FFT. Bins past the Nyquist bin m are exactly
zero.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.fft import rfft_pow2_matmul_parts
from peasoup_tpu.ops.pallas import dftspec as jax_dftspec
from peasoup_tpu.ops.pallas.resample import choose_block as jax_choose_block
from peasoup_tpu.ops.resample import select_span as jax_select_span
from peasoup_tpu.ops.spectrum import form_interpolated_parts, normalise
from peasoup_tpu_torch.ops import dftspec, resample

# (rows, series length, output pad, seed): a square factorisation with a
# row count that is no multiple of the JAX kernel's 8-row stripe, and a
# rectangular one (n1 = 128, n2 = 256) with a pad several planes wide
CASES = [(9, 1 << 15, (1 << 14) + 128, 0), (4, 1 << 16, (1 << 15) + 1024, 3)]


@lru_cache(maxsize=None)
def _outputs(r, n, npad, seed):
    """(x, mean, std, port, pallas, exact) for one case, numpy."""
    x, xe, xo, mean, std = jax_dftspec.oracle_data(n, r=r, seed=seed)
    port = dftspec.dft_untwist_interbin(
        torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(std),
        npad=npad,
    ).numpy()
    pallas = np.asarray(
        jax_dftspec.dft_untwist_interbin(
            jnp.asarray(xe), jnp.asarray(xo), jnp.asarray(mean), jnp.asarray(std),
            npad=npad, interpret=True,
        )
    )
    exact = np.asarray(
        normalise(
            form_interpolated_parts(*rfft_pow2_matmul_parts(jnp.asarray(x))),
            jnp.asarray(mean), jnp.asarray(std),
        )
    )
    return x, mean, std, port, pallas, exact


@pytest.mark.parametrize("ref", ["pallas", "exact"])
@pytest.mark.parametrize("case", CASES)
def test_matches_jax_within_accuracy_gate(case, ref):
    r, n, npad, _ = case
    m = n // 2
    x, mean, std, port, pallas, exact = _outputs(*case)
    assert port.shape == (r, npad) and port.dtype == np.float32
    assert not port[:, m + 1 :].any()
    want = exact if ref == "exact" else pallas[:, : m + 1]
    acc_max, q999 = dftspec.accuracy(
        *(torch.tensor(a) for a in (port, want, mean, std)), m
    )
    assert acc_max <= dftspec.ACC_MAX_REL
    assert q999 <= dftspec.ACC_Q999_REL
    if ref == "exact":
        assert acc_max <= 0.1 * dftspec.ACC_MAX_REL


def test_edge_bins_match_f64():
    # bins 0 (its own mirror), 1, m-1 and the Nyquist bin m against an f64
    # rfft, as tests/test_pallas.py holds the TPU kernel's edges
    r, n, npad, seed = 8, 1 << 15, (1 << 14) + 128, 5
    m = n // 2
    x, _, _, mean, std = dftspec.oracle_data(n, r=r, seed=seed)
    got = dftspec.dft_untwist_interbin(
        torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(std),
        npad=npad,
    ).numpy()
    assert not got[:, m + 1 :].any()
    X = np.fft.rfft(x.astype(np.float64), axis=1)
    Xl = np.concatenate([np.zeros((r, 1)), X[:, :-1]], axis=1)
    amp64 = np.maximum(np.abs(X), np.sqrt(0.5) * np.abs(X - Xl))
    scale = np.sqrt((amp64**2).mean(axis=1))
    amp = got[:, : m + 1] * std[:, None] + mean[:, None]
    for k in (0, 1, m - 1, m):
        err = np.abs(amp[:, k] - amp64[:, k])
        assert (err <= 1e-5 * (np.abs(amp64[:, k]) + scale)).all(), k


GEOMETRIES = [
    # (size, npad): supported ones, then each way to be refused
    (1 << 15, (1 << 14) + 128),
    (1 << 16, (1 << 15) + 1024),
    (1 << 17, 69632),
    (1 << 18, (1 << 17) + 4096),
    (1 << 19, (1 << 18) + 4096),  # m past the 2^17 gate
    (1 << 14, (1 << 13) + 4096),  # n1 = 64, not a multiple of 128
    (3 << 14, (3 << 13) + 4096),  # m not a power of two
    (1 << 16, (1 << 15) + 100),  # npad not a multiple of n1
    (1 << 16, 1 << 15),  # npad not past m
    (1 << 16 | 1, 1 << 16),  # odd size
    (0, 4096),
]


@pytest.mark.parametrize("size,npad", GEOMETRIES)
def test_geometry_helpers_match_jax(size, npad):
    assert dftspec.dftspec_supported(size, npad) == jax_dftspec.dftspec_supported(size, npad)
    m = size // 2
    if m > 0:
        assert dftspec.plane_factors(m) == jax_dftspec.plane_factors(m)
    try:
        want = jax_dftspec._geometry(m, npad)
    except ValueError:
        with pytest.raises(ValueError):
            dftspec._geometry(m, npad)
    else:
        assert dftspec._geometry(m, npad) == want
    if not dftspec.dftspec_supported(size, npad) and size > 0 and size % 2 == 0:
        x = torch.zeros((1, size))
        one = torch.ones(1)
        with pytest.raises(ValueError):
            dftspec.dft_untwist_interbin(x, one, one, npad=npad)


@pytest.mark.parametrize("size", [1 << 15, 1 << 17, 1 << 21, 3 << 16])
@pytest.mark.parametrize("af_max", [0.0, 1e-13, 2.7e-12, 1e-10, 5e-9, 3e-7])
def test_resample_route_helpers_match_jax(size, af_max):
    assert resample.select_span(af_max, size) == jax_select_span(af_max, size)
    assert resample.choose_block(af_max, size) == jax_choose_block(af_max, size)


def test_oracle_helpers_match_jax():
    for a, b in zip(dftspec.oracle_data(1 << 12, r=3, seed=2),
                    jax_dftspec.oracle_data(1 << 12, r=3, seed=2)):
        np.testing.assert_array_equal(a, b)
    assert (dftspec.ACC_MAX_REL, dftspec.ACC_Q999_REL) == (
        jax_dftspec.ACC_MAX_REL, jax_dftspec.ACC_Q999_REL)
    rng = np.random.default_rng(1)
    got, ref = rng.normal(size=(2, 3, 65)).astype(np.float32)
    mean, std = rng.normal(size=3), 0.5 + rng.random(3)
    want = jax_dftspec.accuracy_rel(got, ref[:, :33], mean, std, 32)
    args = [torch.from_numpy(a) for a in (got, ref, mean, std)]
    np.testing.assert_allclose(dftspec.accuracy_rel(*args, 32).numpy(), want, rtol=1e-12)
    # the gate's two numbers: the max, and numpy's default 99.9% quantile
    acc_max, q999 = dftspec.accuracy(*args, 32)
    np.testing.assert_allclose(
        [acc_max, q999], [want.max(), np.quantile(want, 0.999)], rtol=1e-12
    )
