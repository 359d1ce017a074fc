"""The reference against the port's plain CPU path on a tiny filterbank:
the plan, dedispersion, the whitened series and every harmonic level of
a row, and a whole run of the harness judged correct."""

import numpy as np
import pytest
import torch

from portbench.gen import birdies, make_observation, write_birdies
from portbench.reference import search as ref
from portbench.reference.plan import make_plan

from .conftest import TINY_CONFIG, TINY_TRAFFIC

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig

    path = tmp_path_factory.mktemp("tiny") / "birdies.txt"
    write_birdies(path, TINY_CONFIG, TINY_TRAFFIC)
    obs = make_observation(TINY_CONFIG, TINY_TRAFFIC, 2**31 + 3, CPU)
    cfg = SearchConfig(zapfilename=str(path), **TINY_TRAFFIC["search"])
    search = PeasoupSearch(cfg, device=CPU)
    plan = make_plan(TINY_CONFIG["header"], TINY_TRAFFIC["search"], birdies(TINY_CONFIG, TINY_TRAFFIC))
    return obs, search, search.build_plan(obs.fil), plan


def test_the_plan_is_the_ports(setting):
    obs, _, port, plan = setting
    assert np.array_equal(plan.dm_list, port.dm_list)
    assert np.array_equal(plan.delays, port.delays)
    assert plan.out_nsamps == port.out_nsamps and plan.size == port.size
    assert len(plan.accels) == len(port.accel_lists)
    for a, b in zip(plan.accels, port.accel_lists):
        assert np.array_equal(a, b)
    assert np.array_equal(plan.windows, np.asarray(port.windows))
    assert np.array_equal(plan.factors, np.asarray(port.factors, dtype=np.float32))
    assert np.array_equal(plan.zapmask, port.zapmask) and plan.zapmask.any()


def test_dedispersion_is_bitwise_the_ports(setting):
    from peasoup_tpu_torch.ops.dedisperse import dedisperse_block, fil_to_device, output_scale

    obs, _, port, plan = setting
    x = fil_to_device(obs.fil, CPU)
    want = dedisperse_block(x, port.delays, port.killmask, out_nsamps=port.out_nsamps,
                            scale=output_scale(2, 16))
    got = ref.dedisperse(ref.channel_major(obs.fil.raw, TINY_CONFIG["header"], CPU),
                         plan.delays, plan.out_nsamps, plan.scale)
    assert torch.equal(got, want)


def test_a_kill_mask_is_summed_as_the_port_sums_it(setting):
    from peasoup_tpu_torch.ops.dedisperse import dedisperse_block, fil_to_device, output_scale

    from portbench.cell import killmask

    obs, _, port, _ = setting
    cfg = dict(TINY_CONFIG, killed=[[0, 3], [9, 10]])
    keep = killmask(cfg)
    assert keep.sum() == 12 and keep[:3].sum() == 0 and keep[9] == 0
    plan = make_plan(TINY_CONFIG["header"], TINY_TRAFFIC["search"],
                     birdies(TINY_CONFIG, TINY_TRAFFIC), keep)
    want = dedisperse_block(fil_to_device(obs.fil, CPU), port.delays, keep,
                            out_nsamps=port.out_nsamps, scale=output_scale(2, 12))
    got = ref.dedisperse(ref.channel_major(obs.fil.raw, TINY_CONFIG["header"], CPU),
                         plan.delays, plan.out_nsamps, plan.scale, plan.chans)
    assert plan.scale == output_scale(2, 12) and torch.equal(got, want)


def test_every_level_of_a_row_agrees_with_the_ports_plain_chain(setting):
    from peasoup_tpu_torch.ops.fft import packed_dft_z, untwist_interbin_normalise_plain
    from peasoup_tpu_torch.ops.harmonics import harmonic_sums
    from peasoup_tpu_torch.ops.resample import accel_factor, resample_rows_plain
    from peasoup_tpu_torch.pipeline.accel_search import padded_bins, preprocess_block

    obs, search, port, plan = setting
    trials = ref.dedisperse(ref.channel_major(obs.fil.raw, TINY_CONFIG["header"], CPU),
                            plan.delays, plan.out_nsamps, plan.scale)
    size = plan.size
    geometry = dict(size=size, nsamps_valid=min(plan.out_nsamps, size), pos5=plan.pos5,
                    pos25=plan.pos25)
    zap = torch.from_numpy(port.zapmask)
    xd_p, mean_p, std_p = preprocess_block(trials, zap, **geometry)
    xd_r, mean_r, std_r = ref.whiten(trials, plan, ref.Rounding())
    assert torch.allclose(xd_r, xd_p, rtol=0, atol=1e-5 * float(xd_p.abs().max()))
    assert torch.allclose(mean_r, mean_p, rtol=1e-6) and torch.allclose(std_r, std_p, rtol=1e-6)
    d = 20
    for acc in plan.accels[d]:
        af = accel_factor(np.asarray([acc]), TINY_CONFIG["header"]["tsamp"]).astype(np.float32)
        x = resample_rows_plain(xd_p, torch.tensor([d], dtype=torch.int32), torch.from_numpy(af))
        s = untwist_interbin_normalise_plain(packed_dft_z(x), mean_p[d : d + 1], std_p[d : d + 1],
                                             npad=padded_bins(size))[:, : plan.nbins]
        sums = harmonic_sums(s, nharms=4)
        want = torch.cat([s, *sums])
        got = ref.levels(xd_p[d], float(af[0]), mean_p[d], std_p[d], 4, ref.Rounding())
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_the_cluster_walk_keeps_peasoups_quirk():
    from portbench.reference.check import _cluster_max

    row = np.zeros(200, dtype=np.float32)
    # a crossing 29 bins past a peak joins its cluster; the next, 31 past
    # that peak but only 2 past the last crossing, starts another, since
    # only a new maximum moves the walk's anchor
    row[[10, 39, 41, 100, 101]] = [20, 10, 12, 15, 16]
    crossings = np.flatnonzero(row > 9.0)
    peaks, values, owner = ref.clusters(row, crossings)
    assert list(peaks) == [10, 41, 101] and list(values) == [20, 12, 16]
    assert list(owner) == [0, 0, 1, 2, 2]
    assert [_cluster_max(row, crossings, b) for b in (39, 41, 100, 50)] == [20, 12, 16, None]


def test_a_whole_tiny_run_is_judged_correct(tiny_cell):
    import time

    from portbench.run import run_cell

    res = run_cell(tiny_cell, 2**31 + 77, 0.3, False, CPU, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["info"]["lists"] > 0 and res["info"]["rows"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["snr_gap"]["value"] < 1e-5
