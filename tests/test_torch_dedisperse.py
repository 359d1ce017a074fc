"""The port's dedispersion (peasoup_tpu_torch/ops/dedisperse.py) against
the JAX package's Pallas kernel (interpret mode) and its jnp scan.

Channel sums of <=8-bit samples are exact integers in f32, so every
comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.dedisperse import (
    dedisperse_block as jax_dedisperse_block,
    output_scale as jax_output_scale,
    unpack_fil_device as jax_unpack_fil_device,
)
from peasoup_tpu.ops.pallas.dedisperse import dedisperse_pallas
from peasoup_tpu.plan.dm_plan import delay_table
from peasoup_tpu_torch.ops import dedisperse as tdd


def _case(seed, d, c, t):
    """Ascending delays for d DM trials, u8 samples, a partial killmask."""
    rng = np.random.default_rng(seed)
    k = np.abs(delay_table(1400.0, -8.0, c, 0.000256))
    dms = np.sort(rng.uniform(0.0, 60.0, d))
    delays = np.rint(dms[:, None] * k[None, :]).astype(np.int32)
    fil = rng.integers(0, 4, size=(t, c)).astype(np.uint8)
    kill = (rng.random(c) > 0.2).astype(np.int32)
    return fil, delays, kill, t - int(delays.max())


def test_matches_pallas_kernel_bitwise():
    # one interpret-mode call: its trace costs ~10 s whatever the shape
    fil, delays, kill, out_nsamps = _case(616, 6, 16, 4096)
    want = np.asarray(
        dedisperse_pallas(fil, delays, kill, out_nsamps, scale=0.7, interpret=True)
    )
    got = tdd.dedisperse(
        torch.from_numpy(fil), torch.from_numpy(delays), torch.from_numpy(kill),
        out_nsamps, scale=0.7,
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "d,c,t,scale", [(6, 16, 4096, 0.7), (8, 16, 1500, 1.0), (3, 5, 700, 0.25)]
)
def test_matches_jnp_scan_bitwise(d, c, t, scale):
    fil, delays, kill, out_nsamps = _case(d * 100 + c, d, c, t)
    want = np.asarray(
        jax_dedisperse_block(
            jnp.asarray(fil), jnp.asarray(delays), jnp.asarray(kill),
            out_nsamps=out_nsamps, scale=scale,
        )
    )
    got = tdd.dedisperse(
        torch.from_numpy(fil), torch.from_numpy(delays), torch.from_numpy(kill),
        out_nsamps, scale=scale,
    )
    assert got.dtype == torch.uint8 and got.shape == (d, out_nsamps)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_unpack_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    nsamps, nchans = 48, 16
    raw = rng.integers(0, 256, size=nsamps * nchans * nbits // 8).astype(np.uint8)
    want = np.asarray(
        jax_unpack_fil_device(
            jnp.asarray(raw), nbits=nbits, nsamps=nsamps, nchans=nchans
        )
    )
    got = tdd.unpack_fil_device(
        torch.from_numpy(raw), nbits=nbits, nsamps=nsamps, nchans=nchans
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nbits,nchans", [(2, 64), (8, 16), (8, 1), (4, 300)])
def test_output_scale_matches_jax(nbits, nchans):
    assert tdd.output_scale(nbits, nchans) == jax_output_scale(nbits, nchans)


def test_rejects_mixed_devices():
    # the delays and the kill mask are host arrays: the kernel's tables are
    # built from them on the host
    fil, delays, kill, out_nsamps = _case(1, 2, 4, 256)
    with pytest.raises(ValueError, match="host array"):
        tdd.dedisperse(
            torch.from_numpy(fil), torch.from_numpy(delays),
            torch.from_numpy(kill).to("meta"), out_nsamps,
        )

