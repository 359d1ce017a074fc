"""The port's dedispersion (peasoup_tpu_torch/ops/dedisperse.py) against
the JAX package's Pallas kernel (interpret mode) and its jnp scan.

Channel sums of <=8-bit samples are exact integers in f32, so every
comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from peasoup_tpu.ops.dedisperse import (
    dedisperse_block as jax_dedisperse_block,
    output_scale as jax_output_scale,
    unpack_fil_device as jax_unpack_fil_device,
)
from peasoup_tpu.ops.pallas.dedisperse import dedisperse_pallas
from peasoup_tpu.plan.dm_plan import delay_table
from peasoup_tpu_torch.ops import dedisperse as tdd
from peasoup_tpu_torch.utils.trace import trace_span


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


# (nchans, kill mask, 16-channel chunks walked)
_COUNT_CASES = {
    "htru_band": (1024, np.arange(1024) >= 154, 55),
    "scattered": (1024, np.random.default_rng(3).random(1024) >= 0.4, 64),
    "nchans_1000": (1000, np.arange(1000) % 7 != 3, 63),
}


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("case", sorted(_COUNT_CASES))
def test_chunk_counters(case, wide):
    # the tables walk every 16-channel chunk of the row that holds a kept
    # channel, its mask naming the chunk's kept channels; a launch stages
    # each (DM tile, chunk, time tile) once, all by 16-byte loads where the
    # kernel's entry says so and none elsewhere, and the counts land on the
    # innermost span of the run's table under a profiler
    nchans, keep, nchunks = _COUNT_CASES[case]
    rng = np.random.default_rng(5)
    k = np.abs(delay_table(1581.8, -0.390625, nchans, 0.000064))
    delays = np.rint(np.sort(rng.uniform(0.0, 30.0, 20))[:, None] * k).astype(np.int32)
    chans = np.flatnonzero(keep).astype(np.int32)
    tab = tdd._tables(delays, chans, nchans)
    assert tab["log_chunk"] == 4 and tab["nchunks"] == nchunks
    first, mask = tab["chunks"].T
    named = [f + b for f, m in zip(first, mask) for b in range(16) if m >> b & 1]
    np.testing.assert_array_equal(named, chans)
    out_n = 5000 - int(delays.max())
    staged = -(-delays.shape[0] // tdd.TRIALS) * nchunks * -(-out_n // tdd.TILE)
    tdd._count_chunks(tab, delays.shape[0], out_n, wide)  # no profiler: nothing kept
    with profile(activities=[ProfilerActivity.CPU]):
        with trace_span("Search", root=True) as table:
            with trace_span("Dedisperse"):
                tdd._count_chunks(tab, delays.shape[0], out_n, wide)
    assert table.count("dedisp.chunks") == staged
    assert table.count("dedisp.chunks_wide") == (staged if wide else 0)
    assert "dedisp.chunks_wide" in table.spans["Dedisperse", "Search"].counters


def test_dedisp_probe_stamps_apply():
    # dedisp_probe.py's measuring build defines one macro that dedisperse.cu
    # tests; the port's own build defines it nowhere, and the probe reads
    # every phase the build counts and the warps
    import sys
    from pathlib import Path

    from peasoup_tpu_torch import kernels

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import dedisp_probe

    text = kernels.source("dedisperse").read_text()
    assert f"#ifdef {dedisp_probe.STAMPS_MACRO}" in text
    assert not any(dedisp_probe.STAMPS_MACRO in flag for flag in kernels.NVCC_FLAGS)
    enum = text.split("enum {", 1)[1].split("}", 1)[0].replace(" ", "").split(",")
    assert enum[-2:] == ["kWarps", "kStamps"] and len(enum) - 2 == len(dedisp_probe.STAMPS)


@pytest.mark.parametrize("config", ["htru_hilat", "gbncc"])
def test_smoke_bands_are_the_benchmark_surveys(config):
    # chip_smoke.py holds the kernel bitwise at each benchmark survey's
    # band on the card: its header and kill ranges are the configuration's
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke

    cfg = json.loads((root / "portbench" / "configs" / f"{config}.json").read_text())
    (h, nkill), = [(h, n) for label, h, n, *_ in chip_smoke.DEDISP_BANDS
                   if label.startswith(config)]
    assert h == {k: cfg["header"][k] for k in ("nchans", "fch1", "foff", "tsamp", "nbits")}
    assert (cfg.get("killed") or [[0, 0]]) == [[0, nkill]]


@pytest.mark.parametrize("band", range(3))
def test_smoke_bands_stage_16_channel_chunks(band):
    # the trials chip_smoke.py takes at each band keep 16-channel chunks,
    # so on the card every chunk is staged by 16-byte loads
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from peasoup_tpu_torch.plan.dm_plan import DMPlan

    _, h, nkill, dm_end, ndm, nsamps = chip_smoke.DEDISP_BANDS[band]
    keep = (np.arange(h["nchans"]) >= nkill).astype(np.int32)
    plan = DMPlan.create(nsamps=nsamps, nchans=h["nchans"], tsamp=h["tsamp"], fch1=h["fch1"],
                         foff=h["foff"], dm_start=0.0, dm_end=dm_end, killmask=keep)
    delays = plan.delay_samples()[-ndm:] if ndm else plan.delay_samples()
    tab = tdd._tables(delays.astype(np.int32), np.flatnonzero(keep).astype(np.int32),
                      h["nchans"])
    assert tab["log_chunk"] == 4 and h["nchans"] % 16 == 0
    assert plan.out_nsamps > 0 and tab["chunks"][0, 0] == nkill // 16 * 16
