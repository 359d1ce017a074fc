"""The port's search plan (peasoup_tpu_torch/plan/, pipeline/search.py
build_plan, io/masks.py) against the JAX package's planner: every array
bit for bit. ``from_arrays`` builds the port's plan from the JAX
package's arrays, so both packages can be run on one plan.
"""

import numpy as np
import pytest

from peasoup_tpu.io.masks import read_killfile as jax_read_killfile
from peasoup_tpu.io.masks import read_zapfile as jax_read_zapfile
from peasoup_tpu.ops.zap import birdie_mask as jax_birdie_mask
from peasoup_tpu.pipeline.search import _freq_factor as jax_freq_factor
from peasoup_tpu.pipeline.search import _level_windows as jax_level_windows
from peasoup_tpu.plan import AccelerationPlan as JaxAccelPlan
from peasoup_tpu.plan import DMPlan as JaxDMPlan
from peasoup_tpu.plan import choose_fft_size as jax_choose_fft_size
from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from peasoup_tpu_torch.plan import from_arrays

# (nsamps, nchans, tsamp, fch1, foff): the small test grid, the tutorial
# geometry and the survey-scale big grid's header
HEADERS = [
    (1 << 15, 16, 0.000256, 1400.0, -8.0),
    (187520, 64, 0.00032, 1510.0, -1.09375),
    ((1 << 21) + 8192, 64, 64e-6, 1500.0, -300.0 / 64),
]


def _fil(nsamps, nchans, tsamp, fch1, foff):
    hdr = SigprocHeader(
        source_name="plan", tsamp=tsamp, tstart=55000.0, fch1=fch1, foff=foff,
        nchans=nchans, nbits=8, nifs=1, data_type=1,
    )
    # the planner reads only the header and the sample count
    return Filterbank(header=hdr, data=np.zeros((nsamps, nchans), np.uint8))


def _jax_arrays(fil, cfg, killmask=None, zap=None):
    """The plan's arrays as the JAX package's search derives them
    (peasoup_tpu/pipeline/search.py: build_dm_plan and the search setup)."""
    dm_plan = JaxDMPlan.create(
        nsamps=fil.nsamps, nchans=fil.nchans, tsamp=fil.tsamp, fch1=fil.fch1,
        foff=fil.foff, dm_start=cfg.dm_start, dm_end=cfg.dm_end,
        pulse_width=cfg.dm_pulse_width, tol=cfg.dm_tol, killmask=killmask,
    )
    size = jax_choose_fft_size(fil.nsamps, cfg.size)
    tobs = float(np.float32(size) * np.float32(fil.tsamp))
    bin_width = float(np.float32(1.0 / tobs))
    acc_plan = JaxAccelPlan(
        acc_lo=cfg.acc_start, acc_hi=cfg.acc_end, tol=cfg.acc_tol,
        pulse_width=cfg.acc_pulse_width, nsamps=size, tsamp=fil.tsamp,
        cfreq=fil.cfreq, bw=fil.foff,
    )
    zapmask = (
        jax_birdie_mask(*zap, bin_width, size // 2 + 1)
        if zap is not None else np.zeros(size // 2 + 1, dtype=bool)
    )
    return dict(
        dm_list=dm_plan.dm_list,
        delays=dm_plan.delay_samples(),
        killmask=dm_plan.killmask,
        out_nsamps=dm_plan.out_nsamps,
        size=size,
        accel_lists=[acc_plan.generate_accel_list(float(d)) for d in dm_plan.dm_list],
        zapmask=zapmask,
        windows=jax_level_windows(
            size, cfg.nharmonics, cfg.min_freq, cfg.max_freq, fil.tsamp
        ),
        factors=[
            jax_freq_factor(size, nh, fil.tsamp) for nh in range(cfg.nharmonics + 1)
        ],
    )


def _assert_plans_equal(a, b):
    for name in ("dm_list", "delays", "killmask", "zapmask", "windows", "factors"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.out_nsamps, a.size) == (b.out_nsamps, b.size)
    assert len(a.accel_lists) == len(b.accel_lists)
    for x, y in zip(a.accel_lists, b.accel_lists):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("header", HEADERS)
@pytest.mark.parametrize(
    "cfg",
    [
        SearchConfig(dm_end=40.0, acc_start=-2.0, acc_end=2.0),
        SearchConfig(dm_end=20.0, acc_start=-0.5, acc_end=0.5, acc_pulse_width=0.064),
        SearchConfig(dm_start=5.0, dm_end=250.0, nharmonics=5, size=1 << 14),
    ],
)
def test_planner_matches_jax_bitwise(header, cfg):
    fil = _fil(*header)
    got = PeasoupSearch(cfg, device="cpu").build_plan(fil)
    want = from_arrays(**_jax_arrays(fil, cfg))
    _assert_plans_equal(got, want)
    assert got.ndm == len(want.dm_list) and got.nharms == cfg.nharmonics


def test_killfile_and_zapfile(tmp_path):
    fil = _fil(*HEADERS[0])
    kill = tmp_path / "kill.txt"
    kill.write_text("".join(f"{int(c % 5 != 2)}\n" for c in range(fil.nchans)))
    zap = tmp_path / "zap.txt"
    zap.write_text("50.0 0.5\n0.2 0.3\n1900.0 50.0\n")  # the last clips at the top
    cfg = SearchConfig(dm_end=40.0, killfilename=str(kill), zapfilename=str(zap))
    got = PeasoupSearch(cfg, device="cpu").build_plan(fil)
    want = from_arrays(**_jax_arrays(
        fil, cfg, killmask=jax_read_killfile(str(kill), fil.nchans),
        zap=jax_read_zapfile(str(zap)),
    ))
    _assert_plans_equal(got, want)
    assert got.zapmask.any() and not got.killmask.all()


def test_from_arrays_round_trip():
    fil = _fil(*HEADERS[0])
    cfg = SearchConfig(dm_end=40.0, acc_start=-2.0, acc_end=2.0)
    arrays = _jax_arrays(fil, cfg)
    plan = from_arrays(**arrays)
    again = from_arrays(
        **{name: getattr(plan, name) for name in arrays}
    )
    _assert_plans_equal(plan, again)
    assert plan.delays.dtype == np.int32 and plan.zapmask.dtype == bool


def test_from_arrays_checks_shapes():
    fil = _fil(*HEADERS[0])
    arrays = _jax_arrays(fil, SearchConfig(dm_end=40.0))
    with pytest.raises(ValueError, match="delays"):
        from_arrays(**{**arrays, "delays": arrays["delays"][:, :-1]})
    with pytest.raises(ValueError, match="one acceleration list"):
        from_arrays(**{**arrays, "accel_lists": arrays["accel_lists"][:-1]})
    with pytest.raises(ValueError, match="zapmask"):
        from_arrays(**{**arrays, "zapmask": arrays["zapmask"][:-1]})
