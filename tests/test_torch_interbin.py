"""The port's packed DFT and untwist + interbin + normalise
(peasoup_tpu_torch/ops/fft.py) against the JAX package's Pallas interbin
kernel (interpret mode) and its jnp chain.

Both sides take the same Z (the JAX package's packed DFT), so the
comparison holds the untwist/interbin/normalise arithmetic alone. The
tolerance is the per-bin envelope the JAX package documents for its
kernel against its twin, 1e-5 * (|ref| + rms) (FMA contraction and
term grouping, ops/pallas/interbin.py:222-228); bins past the Nyquist
bin m must be exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.fft import packed_dft_z as jax_packed_dft_z
from peasoup_tpu.ops.fft import rfft_pow2_matmul_parts
from peasoup_tpu.ops.pallas.interbin import untwist_interbin_normalise as jax_kernel
from peasoup_tpu_torch.ops import fft


def _series(seed, r, n):
    """A tone plus noise, so interbin's max() takes both branches."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = rng.normal(size=(r, n)) + 3.0 * np.sin(2 * np.pi * t * 0.1317)
    mean = rng.normal(size=r).astype(np.float32)
    std = (0.5 + rng.random(r)).astype(np.float32)
    return x.astype(np.float32), mean, std


def _assert_envelope(got, ref):
    rms = np.sqrt(np.mean(ref * ref, axis=-1, keepdims=True))
    bad = np.abs(got - ref) > 1e-5 * (np.abs(ref) + rms)
    assert not bad.any(), f"{bad.sum()} bins outside the envelope"


@pytest.mark.parametrize("r,n,block", [(9, 1 << 13, 1024), (3, 1 << 12, 2048)])
def test_matches_pallas_kernel(r, n, block):
    x, mean, std = _series(r, r, n)
    m = n // 2
    npad = (m // block + 1) * block
    zr, zi = jax_packed_dft_z(jnp.asarray(x))
    want = np.asarray(
        jax_kernel(
            zr, zi, jnp.asarray(mean), jnp.asarray(std), npad=npad, block=block,
            interpret=True,
        )
    )
    z = torch.complex(torch.from_numpy(np.array(zr)), torch.from_numpy(np.array(zi)))
    got = fft.untwist_interbin_normalise(
        z, torch.from_numpy(mean), torch.from_numpy(std), npad=npad
    ).numpy()
    assert got.shape == (r, npad)
    _assert_envelope(got[:, : m + 1], want[:, : m + 1])
    assert not got[:, m + 1 :].any()


def test_untwist_matches_jax_rfft_parts():
    # the plain untwist formulas against the JAX package's, from one Z
    x, _, _ = _series(1, 4, 1 << 11)
    zr, zi = jax_packed_dft_z(jnp.asarray(x))
    wr, wi = (np.asarray(a) for a in rfft_pow2_matmul_parts(jnp.asarray(x)))
    z = torch.complex(torch.from_numpy(np.array(zr)), torch.from_numpy(np.array(zi)))
    unc, uns = fft.untwist_tables(z.shape[-1], z.device)
    gr, gi = (a.numpy() for a in fft.untwist_parts(z, unc, uns))
    scale = np.sqrt(np.mean(wr * wr + wi * wi, axis=-1, keepdims=True))
    np.testing.assert_allclose(gr, wr, rtol=0, atol=1e-6 * scale.max())
    np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6 * scale.max())


def test_packed_dft_matches_numpy():
    x, _, _ = _series(2, 3, 1 << 12)
    got = fft.packed_dft_z(torch.from_numpy(x)).numpy()
    want = np.fft.fft(x[:, 0::2].astype(np.float64) + 1j * x[:, 1::2])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_rejects_bad_geometry():
    z = torch.zeros((2, 64), dtype=torch.complex64)
    one = torch.ones(2)
    with pytest.raises(ValueError, match="geometry"):
        fft.untwist_interbin_normalise(z, one, one, npad=64)

