"""The port's FFA search (peasoup_tpu_torch.ops.ffa, pipeline.ffa and
cli.ffa) against the JAX package's on the CPU, same inputs (the recipes
of tests/test_ffa.py).

The port takes the JAX package's row-to-period map: it searches the rows
j < m (the complete periods in the series) at p0 + j/(m - 1). Row j of
the m_pad-row transform holds the fold at p0 + j/(m_pad - 1), so where m
< m_pad both packages place a period off (ROADMAP §C, a fault of the
reference the port follows until the reference is repaired;
test_jax_row_periods_are_off_where_the_series_is_short states by how
much). Every search is compared with the unmodified JAX package.

Equality classes: the FFA transform adds what the JAX package adds in its
order, so it is held bit for bit. The matched filter's means, variances
and prefix sums over a 256-bin profile run in torch's order, not XLA's,
and XLA:CPU sums in neither sequential nor numpy's pairwise order, so its
S/N is held to a relative 1e-5 (a few f32 roundings of 256-term sums) and
its best width and phase exactly; the candidates of a search likewise:
period, DM and width exact, S/N within 1e-5."""

import importlib
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu_torch.ops.ffa import (
    boxcar_snr, collapse_periods, duty_cycle_widths, ffa_octave, ffa_search_series,
    ffa_transform,
)

J = importlib.import_module("peasoup_tpu.ops.ffa")
SNR_RTOL = 1e-5


@pytest.mark.parametrize(
    "m_pad,p0,extra", [(4, 255, 0), (8, 200, 0), (16, 131, 37), (32, 200, -50), (8, 150, -110)]
)
def test_ffa_transform_bitwise(m_pad, p0, extra):
    # complete periods, a partial last row and a short series
    x = np.random.default_rng(m_pad).normal(size=m_pad * p0 + extra).astype(np.float32)
    want = np.asarray(J.ffa_transform(jnp.asarray(x), jnp.int32(p0), m_pad))
    got = ffa_transform(torch.from_numpy(x), p0, m_pad)
    np.testing.assert_array_equal(got.numpy(), want)
    # the batched form over base periods holds the same rows
    batched = ffa_transform(torch.from_numpy(x), torch.tensor([p0 - 1, p0]), m_pad)
    np.testing.assert_array_equal(batched[1].numpy(), want)


@pytest.mark.parametrize("m_pad,p0", [(8, 200), (16, 131), (32, 255)])
def test_boxcar_snr_matches_jax(m_pad, p0):
    rng = np.random.default_rng(p0)
    prof = rng.normal(size=(m_pad, 256)).astype(np.float32)
    prof[:, 3:9] += 4.0  # a pulse on every row
    widths = duty_cycle_widths(0.004)
    ws, ww, wp = (np.asarray(t) for t in J.boxcar_snr(jnp.asarray(prof), jnp.int32(p0), widths))
    gs, gw, gp = (t.numpy() for t in boxcar_snr(torch.from_numpy(prof), p0, widths))
    np.testing.assert_allclose(gs, ws, rtol=SNR_RTOL)
    np.testing.assert_array_equal(gw, ww)
    np.testing.assert_array_equal(gp, wp)


def test_octave_block_matches_jax():
    x = np.random.default_rng(5).normal(size=(3, 4096)).astype(np.float32)
    x[1, ::200] += 6.0
    widths = (1, 2, 4, 8)
    want = J._octave_fn(32, widths)(jnp.asarray(x))
    got = ffa_octave(torch.from_numpy(x), 32, widths)
    np.testing.assert_allclose(got.snr.numpy(), np.asarray(want.snr), rtol=SNR_RTOL,
                               atol=SNR_RTOL)
    np.testing.assert_array_equal(got.width.numpy(), np.asarray(want.width))
    np.testing.assert_array_equal(got.phase.numpy(), np.asarray(want.phase))


def test_duty_cycle_widths_and_collapse():
    for dc in (0.001, 0.01, 0.1, 0.9):
        assert duty_cycle_widths(dc) == J.duty_cycle_widths(dc)
    rng = np.random.default_rng(6)
    cands = [J.FFACandidate(period=float(p), dm=0.0, snr=float(s), width=1, dc=0.01)
             for p, s in zip(rng.uniform(1, 1.01, 40), rng.uniform(5, 9, 40))]
    assert collapse_periods(cands) == J.collapse_periods(cands)


def _same_candidates(want, got):
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        assert (b.period, b.dm, b.width, b.dc) == (a.period, a.dm, a.width, a.dc)
        assert abs(b.snr - a.snr) <= SNR_RTOL * a.snr


def test_search_series_matches_jax():
    rng = np.random.default_rng(2)
    tsamp, n, period = 0.008, 1 << 15, 5.37
    t = np.arange(n) * tsamp
    x = rng.normal(0, 1, size=n).astype(np.float32)
    x += 8.0 * ((t % period) / period < 0.02)
    kw = dict(snr_min=8.0)
    want = J.ffa_search_series(x, tsamp, 0.8, 8.0, 0.01, **kw)
    got = ffa_search_series(x, tsamp, 0.8, 8.0, 0.01, device="cpu", **kw)
    _same_candidates(want, got)
    assert any(abs(c.period - period) / period < 2e-3 for c in got)


@pytest.mark.parametrize("row,seed", [(5, 0), (30, 1), (55, 2)])
def test_search_block_matches_unmodified_jax_where_every_row_is_complete(row, seed):
    # n // 128 a power of two and [p_start, p_end] inside base period
    # 128's bin: the one octave searched has m == m_pad (64 rows) at
    # p0 = 128, where the two packages' row-to-period maps agree, so the
    # JAX package's own search, extraction included, is the reference
    from peasoup_tpu_torch.ops.ffa import ffa_search_block

    tsamp, n = 0.01, 128 * 64
    period_samples = 128.0 + row / 63
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, size=(3, n)).astype(np.float32)
    x[1] += 6.0 * (((t / period_samples) % 1.0) < 0.02)
    x[2] += 3.0 * (((t / period_samples) % 1.0) < 0.02)
    dms = [0.0, 5.0, 10.0]
    p_start, p_end = 128 * tsamp, 128.99 * tsamp
    want = J.ffa_search_block(x, tsamp, p_start, p_end, 0.01, dms, snr_min=6.0)
    got = ffa_search_block(x, tsamp, p_start, p_end, 0.01, dms, snr_min=6.0,
                           device="cpu")
    _same_candidates(want, got)
    top = max(got, key=lambda c: c.snr)
    assert top.dm == 5.0
    # within one row, 1/63 of a sample
    assert abs(top.period / tsamp - period_samples) <= 1.0 / 63 + 1e-9


def _ffa_fil(path):
    from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader, write_filterbank

    rng = np.random.default_rng(4)
    nsamps, nchans, tsamp, period = 1 << 14, 8, 0.016, 2.51
    t = np.arange(nsamps) * tsamp
    pulse = 40.0 * ((t % period) / period < 0.03)
    data = np.clip(rng.normal(100, 6, size=(nsamps, nchans)) + pulse[:, None], 0, 255)
    hdr = SigprocHeader(
        source_name="fake", data_type=1, nchans=nchans, nbits=8, nifs=1,
        tsamp=tsamp, tstart=50000.0, fch1=1500.0, foff=-1.0,
    )
    write_filterbank(path, Filterbank(header=hdr, data=data.astype(np.uint8)))
    return period


FLAGS = ["--dm_end", "10", "--p_start", "1.0", "--p_end", "8.0", "--min_dc", "0.01"]


def test_search_pipeline_matches_jax(tmp_path):
    from peasoup_tpu.io import read_filterbank as jax_read
    from peasoup_tpu.pipeline.ffa import FFAConfig as JaxConfig
    from peasoup_tpu.pipeline.ffa import FFASearch as JaxSearch
    from peasoup_tpu_torch.io.sigproc import read_filterbank
    from peasoup_tpu_torch.pipeline.ffa import FFAConfig, FFASearch

    path = tmp_path / "ffa.fil"
    period = _ffa_fil(path)
    kw = dict(dm_end=10.0, p_start=1.0, p_end=8.0, min_dc=0.01)
    want = JaxSearch(JaxConfig(**kw)).run(jax_read(str(path)))
    got = FFASearch(FFAConfig(**kw), device="cpu").run(read_filterbank(path))
    np.testing.assert_array_equal(got.dm_list, want.dm_list)
    _same_candidates(want.candidates, got.candidates)
    assert abs(got.candidates[0].period - period) / period < 2e-3
    assert vars(FFAConfig()) == vars(JaxConfig())


def test_cli_matches_jax(tmp_path):
    from peasoup_tpu.cli.ffa import main as jax_main
    from peasoup_tpu_torch.cli.ffa import main

    path = tmp_path / "ffa.fil"
    period = _ffa_fil(path)
    port_out, jax_out = str(tmp_path / "port.xml"), str(tmp_path / "jax.xml")
    assert main(["-i", str(path), "-o", port_out, "--device", "cpu", *FLAGS]) == 0
    assert jax_main(["-i", str(path), "-o", jax_out, *FLAGS]) == 0
    got, want = ET.parse(port_out).getroot(), ET.parse(jax_out).getroot()
    assert [(e.tag, e.text) for e in got.find("search_parameters")] == [
        (e.tag, e.text) for e in want.find("search_parameters")]
    assert got.find("dedispersion_trials").get("count") == want.find(
        "dedispersion_trials").get("count")
    gc, wc = got.findall("candidates/candidate"), want.findall("candidates/candidate")
    assert len(gc) == len(wc) > 0
    for a, b in zip(wc, gc):
        for tag in ("period", "dm", "width", "duty_cycle"):
            assert b.find(tag).text == a.find(tag).text
        assert abs(float(b.find("snr").text) - float(a.find("snr").text)) <= (
            SNR_RTOL * float(a.find("snr").text))
    assert sorted(e.tag for e in got.find("execution_times")) == sorted(
        e.tag for e in want.find("execution_times"))
    assert any(abs(float(c.find("period").text) - period) / period < 2e-3 for c in gc)


@pytest.mark.parametrize("frac,offset", [(0.3, 1.6681612620169219e-3),
                                          (0.8, 1.7163364019347198e-3)], ids=["0.3", "0.8"])
def test_jax_row_periods_are_off_where_the_series_is_short(frac, offset):
    # a noise-free train of one-sample pulses at 150 + frac samples, 70
    # periods long: the transform has m_pad = 128 rows of which the series
    # fills m = 70. Both packages read the fold of row j as p0 + j/69, so
    # both give the same period, off by ``offset`` relative (frac 0.3: the
    # row holding it is read 1.7e-3 long; frac 0.8: that row, 102, is past
    # the rows searched, and the nearest searched one wins)
    tsamp, period_samples = 0.01, 150.0 + frac
    n = int(period_samples * 70)
    t = np.arange(n)
    x = (np.floor(t / period_samples) != np.floor((t - 1) / period_samples)).astype(np.float32)
    period = period_samples * tsamp
    kw = dict(snr_min=3.0)
    got = ffa_search_series(x, tsamp, 1.3, 1.6, 0.004, device="cpu", **kw)
    want = J.ffa_search_series(x, tsamp, 1.3, 1.6, 0.004, **kw)
    # the weaker candidates of this noise-free train tie in S/N to the last
    # bits, where the two packages' filters round apart, so only the top
    # one is compared
    assert (got[0].period, got[0].width) == (want[0].period, want[0].width)
    assert abs(got[0].snr - want[0].snr) <= SNR_RTOL * want[0].snr
    assert abs((got[0].period - period) / period - offset) < 1e-12
