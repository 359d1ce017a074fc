"""The port's subband and banded-matmul dedispersion
(peasoup_tpu_torch.ops.dedisperse) against the JAX package's on the CPU,
same inputs, and the forced engines end to end.

Equality classes, as the JAX package states them for its own engines
(its tests/test_matmul_dedisp.py): every engine is bitwise the JAX
package's, and the direct sum's, for <=8-bit inputs, whose channel sums
are exact integers in f32; for float32 inputs the banded contraction may
associate the channel sum differently, so it is held within 4 ULP of the
accumulated magnitude of the direct sum (16 channels)."""

import importlib

import numpy as np
import pytest
import torch

from peasoup_tpu.plan.dm_plan import DMPlan as JaxDMPlan
from peasoup_tpu_torch.ops.dedisperse import (
    dedisperse, dedisperse_block, dedisperse_host, dedisperse_matmul,
    dedisperse_subband, matmul_band, output_scale, subband_groups,
)
from peasoup_tpu_torch.plan.dm_plan import DMPlan

J = importlib.import_module("peasoup_tpu.ops.dedisperse")

GEO = dict(
    nsamps=4096, nchans=16, tsamp=0.000256, fch1=1400.0, foff=-16.0,
    dm_start=0.0, dm_end=30.0,
)


def _data(nbits, nsamps=GEO["nsamps"], nchans=GEO["nchans"], seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << nbits, size=(nsamps, nchans), dtype=np.uint8)


@pytest.fixture(scope="module")
def plan():
    p = DMPlan.create(**GEO)
    np.testing.assert_array_equal(p.delay_samples(), JaxDMPlan.create(**GEO).delay_samples())
    return p


@pytest.mark.parametrize("budgets", [False, True])
@pytest.mark.parametrize("nsub,max_smear", [(4, 0.0), (4, 1.0), (5, 2.0), (16, 3.0)])
def test_subband_groups_match_jax(plan, nsub, max_smear, budgets):
    d = plan.delay_samples()
    b = np.linspace(0.5, 4.0, d.shape[0]) if budgets else None
    got = subband_groups(d, nsub, max_smear, b)
    assert got == J.subband_groups(d, nsub, max_smear, b)
    assert [lo for lo, _ in got] == sorted({lo for lo, _ in got})
    if max_smear == 0.0 and not budgets:
        assert all(hi - lo == 1 for lo, hi in got)


def _kill(nchans=GEO["nchans"]):
    kill = np.ones(nchans, dtype=np.float32)
    kill[5] = 0.0
    kill[11] = 0.0
    return kill


@pytest.mark.parametrize("use_matmul", [False, True])
@pytest.mark.parametrize("max_smear", [0.0, 1.0])
@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_subband_bitwise_jax(plan, nbits, max_smear, use_matmul):
    # an awkward band count (5 over 16 channels: 4 bands of 4), two killed
    # channels and the output scale of the kept ones
    d = plan.delay_samples()
    x = _data(nbits, seed=nbits)
    kill = _kill()
    scale = output_scale(nbits, int(kill.sum()))
    kw = dict(nsub=5, max_smear=max_smear, scale=scale, use_matmul=use_matmul)
    want = np.asarray(J.dedisperse_subband(x, d, kill, plan.out_nsamps, **kw))
    got = dedisperse_subband(torch.from_numpy(x), d, kill, plan.out_nsamps, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    host = dedisperse_subband(torch.from_numpy(x), d, kill, plan.out_nsamps,
                              to_host=True, **kw)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, want)
    if max_smear == 0.0:
        # exact subbands are the direct sum
        direct = dedisperse(torch.from_numpy(x), d, kill, plan.out_nsamps, scale=scale)
        np.testing.assert_array_equal(got.numpy(), direct.numpy())


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_matmul_bitwise_jax(plan, nbits):
    d = plan.delay_samples()
    x = _data(nbits, seed=10 + nbits)
    kill = _kill()
    scale = output_scale(nbits, int(kill.sum()))
    want = np.asarray(J.dedisperse_matmul(x, d, kill, plan.out_nsamps, scale=scale, block=8))
    got = dedisperse_matmul(torch.from_numpy(x), d, kill, plan.out_nsamps, scale=scale,
                            block=8)
    np.testing.assert_array_equal(got.numpy(), want)
    direct = dedisperse(torch.from_numpy(x), d, kill, plan.out_nsamps, scale=scale)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())


def test_matmul_channel_chunking(plan):
    # a chunk_bytes of three channels' windows forces the channel-chunk
    # recursion (unquantized partials, quantized once)
    d = plan.delay_samples()
    x = _data(8, seed=3)
    kill = np.ones(GEO["nchans"], dtype=np.float32)
    scale = output_scale(8, GEO["nchans"])
    small = 4 * (plan.out_nsamps + 64) * 3
    whole = dedisperse_matmul(torch.from_numpy(x), d, kill, plan.out_nsamps, scale=scale)
    chunked = dedisperse_matmul(torch.from_numpy(x), d, kill, plan.out_nsamps,
                                scale=scale, chunk_bytes=small)
    want = np.asarray(J.dedisperse_matmul(x, d, kill, plan.out_nsamps, scale=scale,
                                          chunk_bytes=small))
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    np.testing.assert_array_equal(chunked.numpy(), want)


def test_matmul_band_and_padding(plan):
    # the band of a block and the last block's padding (repeated trials)
    d = plan.delay_samples()
    assert matmul_band(d[:8]) == J.matmul_band(d[:8])
    assert matmul_band(d[-3:]) % 8 == 0
    x = _data(2, seed=4)
    kill = np.ones(GEO["nchans"], dtype=np.float32)
    zero = np.zeros_like(d[:5])
    got = dedisperse_matmul(torch.from_numpy(x), zero, kill, plan.out_nsamps)
    want = dedisperse_block(torch.from_numpy(x), zero, kill, out_nsamps=plan.out_nsamps)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_float_inputs_within_ulp(plan):
    d = plan.delay_samples()
    rng = np.random.default_rng(4)
    x = rng.normal(10.0, 2.0, size=(GEO["nsamps"], GEO["nchans"])).astype(np.float32)
    kill = np.ones(GEO["nchans"], dtype=np.float32)
    ref = np.asarray(J.dedisperse_block(x, d, kill, out_nsamps=plan.out_nsamps,
                                        quantize=False))
    tol = 4 * np.spacing(np.maximum(np.abs(ref), 1.0))
    got = dedisperse_matmul(torch.from_numpy(x), d, kill, plan.out_nsamps,
                            quantize=False).numpy()
    assert (np.abs(got - ref) <= tol).all()
    want = np.asarray(J.dedisperse_matmul(x, d, kill, plan.out_nsamps, quantize=False))
    assert (np.abs(got - want) <= tol).all()
    # the scan stages add in the JAX package's order: the same f32 bits
    sub = dedisperse_subband(torch.from_numpy(x), d, kill, plan.out_nsamps, nsub=4,
                             max_smear=0.0, quantize=False).numpy()
    np.testing.assert_array_equal(
        sub, np.asarray(J.dedisperse_subband(x, d, kill, plan.out_nsamps, nsub=4,
                                             max_smear=0.0, quantize=False)))


def test_host_trials_match_device_trials(plan):
    d = plan.delay_samples()
    x = torch.from_numpy(_data(4, seed=5))
    kill = _kill()
    scale = output_scale(4, int(kill.sum()))
    got = dedisperse_host(x, d, kill, plan.out_nsamps, scale=scale, block=4)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(
        got, dedisperse(x, d, kill, plan.out_nsamps, scale=scale).numpy())


# --- the forced engines end to end: the JAX package's
# test_forced_engine_three_way_candidates (its tests/test_matmul_dedisp.py:578)


@pytest.fixture(scope="module")
def three_way_fil(tmp_path_factory):
    from peasoup_tpu_torch.io.sigproc import (
        Filterbank, SigprocHeader, read_filterbank, write_filterbank,
    )

    nsamps, nchans, tsamp, fch1, foff = 1 << 12, 8, 0.000256, 1400.0, -16.0
    p = DMPlan.create(nsamps=nsamps, nchans=nchans, tsamp=tsamp, fch1=fch1,
                      foff=foff, dm_start=0.0, dm_end=20.0)
    delays = p.delay_samples()[p.ndm // 2]
    rng = np.random.default_rng(5)
    data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
    for s0 in range(100, nsamps - 200, 128):
        for c in range(nchans):
            data[s0 + delays[c] : s0 + 4 + delays[c], c] += 14.0
    hdr = SigprocHeader(
        source_name="3WAY", tsamp=tsamp, tstart=55000.0, fch1=fch1,
        foff=foff, nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    path = tmp_path_factory.mktemp("three_way") / "smoke.fil"
    write_filterbank(
        path, Filterbank(header=hdr, data=np.clip(np.rint(data), 0, 255).astype(np.uint8))
    )
    return path


ENGINES = [
    {},
    dict(dedisp_engine="matmul"),
    dict(subbands=4, subband_smear=0.0),
    dict(subbands=4, subband_smear=0.0, subband_matmul=True),
]


def _port_cands(path, **kw):
    from peasoup_tpu_torch.io.sigproc import read_filterbank
    from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig

    res = PeasoupSearch(SearchConfig(dm_end=20.0, min_snr=6.0, **kw), device="cpu").run(
        read_filterbank(path)
    )
    return [(c.dm, c.acc, c.freq, c.snr, c.nh) for c in res.candidates]


@pytest.fixture(scope="module")
def jax_three_way(three_way_fil):
    from peasoup_tpu.io.sigproc import read_filterbank
    from peasoup_tpu.pipeline.search import PeasoupSearch, SearchConfig

    out = {}
    for i, kw in enumerate(ENGINES):
        res = PeasoupSearch(SearchConfig(dm_end=20.0, min_snr=6.0, **kw)).run(
            read_filterbank(str(three_way_fil))
        )
        out[i] = [(c.dm, c.acc, c.freq, c.snr, c.nh) for c in res.candidates]
    return out


@pytest.mark.parametrize("engine", range(len(ENGINES)))
def test_forced_engine_three_way_candidates(three_way_fil, engine):
    exact = _port_cands(three_way_fil)
    assert exact  # the injected pulsar was found
    assert _port_cands(three_way_fil, **ENGINES[engine]) == exact


@pytest.mark.parametrize("engine", range(len(ENGINES)))
def test_three_way_candidates_match_jax(three_way_fil, jax_three_way, engine):
    # the recall standard against the JAX package's run of the same engine:
    # the same candidates, S/N within a relative 1e-3 (the FFTs round
    # differently)
    want = jax_three_way[engine]
    got = _port_cands(three_way_fil, **ENGINES[engine])
    assert want == jax_three_way[0]
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert (b[0], b[1], b[2], b[4]) == (a[0], a[1], a[2], a[4])
        assert abs(b[3] - a[3]) <= 1e-3 * abs(a[3])
