"""The port's resample (peasoup_tpu_torch.ops.resample) against the JAX
package's on the same numpy inputs, on the CPU: the plain version of the
resample kernel, resample_rows_plain, must be bitwise equal to every
route the JAX package takes (its jnp gather resample_accel, and its
Pallas kernel resample_block_pallas in interpret mode, as
tests/test_pallas.py runs it), at shift spans past 8 samples, for both
signs of the acceleration and with the index clipped at both ends.
The folder's quadratic variant is held to the JAX package's bitwise too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.pallas.resample import choose_block, resample_block_pallas
from peasoup_tpu.ops.resample import accel_factor as jax_accel_factor
from peasoup_tpu.ops.resample import resample_accel as jax_resample_accel
from peasoup_tpu.ops.resample import (
    resample_accel_quadratic as jax_resample_quadratic,
)
from peasoup_tpu.ops.resample import select_span as jax_select_span
from peasoup_tpu_torch.ops import resample

N, TSAMP = 16384, 256e-6


def _rows(afs: np.ndarray):
    """(D, A) factors -> the port's row form: row_dm (D*A,) i32, afs (D*A,)."""
    d, a = afs.shape
    return (
        torch.from_numpy(np.repeat(np.arange(d, dtype=np.int32), a)),
        torch.from_numpy(afs.reshape(-1)),
    )


def _port(x: np.ndarray, afs: np.ndarray) -> np.ndarray:
    row_dm, af = _rows(afs)
    out = resample.resample_rows_plain(torch.from_numpy(x), row_dm, af)
    return out.numpy().reshape(*afs.shape, x.shape[-1])


def _jax_gather(x: np.ndarray, afs: np.ndarray) -> np.ndarray:
    return np.asarray(jax.vmap(jax_resample_accel)(jnp.asarray(x), jnp.asarray(afs)))


def _afs(accs, rows: int = 2) -> np.ndarray:
    return np.stack(
        [resample.accel_factor(np.asarray(accs), TSAMP).astype(np.float32)] * rows
    )


def test_accel_factor_matches_jax():
    accs = np.asarray([-150.0, -23.4, 0.0, 107.7, 1.4e6])
    np.testing.assert_array_equal(
        resample.accel_factor(accs, 64e-6), jax_accel_factor(accs, 64e-6)
    )


@pytest.mark.parametrize(
    "accs",
    [
        [0.0, 5.0, -5.0, 125.5],  # spans of a sample or less
        [-4.0e5, 3.0e5, 9.0e5, -1.1e6],  # select spans of 10 to 33 samples
    ],
)
def test_plain_matches_jax_gather(accs):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, N)).astype(np.float32)
    afs = _afs(accs, rows=3)
    np.testing.assert_array_equal(_port(x, afs), _jax_gather(x, afs))


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("acc", [3.0e5, 1.4e6])
def test_plain_matches_pallas_kernel_past_the_select_span(sign, acc):
    """Select spans of 10 and 42 samples, where the JAX package takes
    its Pallas kernel (choose_block > 0, select_span > 8)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, N)).astype(np.float32)
    afs = _afs([sign * acc, sign * acc / 3.0, -sign * acc / 2.0])
    af_max = float(np.abs(afs).max())
    span = jax_select_span(af_max, N)
    blk = choose_block(af_max, N)
    assert span > 8 and blk > 0, (span, blk)
    want = resample_block_pallas(
        jnp.asarray(x), jnp.asarray(afs), block=blk, interpret=True
    )
    np.testing.assert_array_equal(_port(x, afs), np.asarray(want))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_plain_matches_jax_where_the_pallas_kernel_refuses(sign):
    """|af|*N > 1: no Pallas block exists (choose_block = 0) and the
    source index is clipped at the first (af > 0) or last (af < 0)
    samples; the JAX package takes its jnp gather."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, N)).astype(np.float32)
    afs = np.asarray([[sign * 2.0e-4, sign * 7.0e-5]] * 2, dtype=np.float32)
    assert choose_block(float(np.abs(afs).max()), N) == 0
    i = np.arange(N, dtype=np.float32)
    src = np.arange(N) + np.rint(afs[0, 0] * (i * (i - np.float32(N))))
    assert (src < 0).any() if sign > 0 else (src > N - 1).any()
    got = _port(x, afs)
    np.testing.assert_array_equal(got, _jax_gather(x, afs))
    edge = x[:, :1] if sign > 0 else x[:, -1:]
    assert (got[:, 0] == edge).sum(axis=-1).min() > 1  # clipped reads repeat


def test_rows_of_several_dm_trials_out_of_order():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 4097)).astype(np.float32)  # odd N
    row_dm = np.asarray([2, 0, 3, 3, 1, 0, 2], dtype=np.int32)
    afs = rng.uniform(-3e-6, 3e-6, size=row_dm.size).astype(np.float32)
    got = resample.resample_rows(
        torch.from_numpy(x), torch.from_numpy(row_dm), torch.from_numpy(afs)
    )
    for r, (d, af) in enumerate(zip(row_dm, afs)):
        want = np.asarray(jax_resample_accel(jnp.asarray(x[d]), jnp.asarray([af])))[0]
        np.testing.assert_array_equal(got[r].numpy(), want)


@pytest.mark.parametrize("n", [N, 4097])
def test_quadratic_matches_jax(n):
    rng = np.random.default_rng(5)
    x = rng.normal(size=n).astype(np.float32)
    afs = np.asarray([0.0, 3e-7, -3e-7, 2e-5, -2e-5], dtype=np.float32)
    got = resample.resample_accel_quadratic(torch.from_numpy(x), torch.from_numpy(afs))
    want = jax.vmap(lambda af: jax_resample_quadratic(jnp.asarray(x), af))(
        jnp.asarray(afs)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    x = torch.zeros((2, 64))
    row_dm = torch.zeros(3, dtype=torch.int32)
    afs = torch.zeros(3)
    assert resample.resample_rows(x, row_dm, afs).shape == (3, 64)
    with pytest.raises(ValueError, match="more than one device"):
        resample.resample_rows(x, row_dm, afs.to("meta"))
