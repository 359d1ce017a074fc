"""The port's single-pulse search end to end on the CPU
(peasoup_tpu_torch.pipeline.single_pulse.SinglePulseSearch with
device="cpu", and its `spsearch` CLI) against the JAX package's on the same
8-bit filterbank: chip_smoke.py's small single-pulse input, a narrow and a
broad dispersed pulse at the middle DM trial.

Every candidate field is held exactly but S/N, which is held to 1e-5
relative: the normalisation and the prefix sums add in another order than
XLA's. No event of this input lies close enough to the threshold for that
to change the event set. The dedispersed trials are integers, so boxcars
at different samples of one dec block can have equal sums; the two
packages' roundings then break the tie differently, and an event's sample
may move within its block. The candidates of the default run do not meet
such a tie; the overflow runs, whose first K events per trial include
weaker ones, do, and hold the sample fields to within one block.
"""

import numpy as np
import pytest

import chip_smoke
from peasoup_tpu.cli.spsearch import main as jax_cli_main
from peasoup_tpu.io import read_filterbank as jax_read_filterbank
from peasoup_tpu.pipeline.single_pulse import SinglePulseConfig as JaxConfig
from peasoup_tpu.pipeline.single_pulse import SinglePulseSearch as JaxSearch
from peasoup_tpu.tools.parsers import OverviewFile, read_singlepulse
from peasoup_tpu_torch.cli.spsearch import main as cli_main
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.pipeline.single_pulse import SinglePulseConfig, SinglePulseSearch

KW = dict(dm_end=60.0, min_snr=7.0, n_widths=8)
SNR_RTOL = 1e-5
FIELDS = ("dm", "dm_idx", "time_s", "sample", "width", "width_idx", "members",
          "dm_idx_lo", "dm_idx_hi", "sample_lo", "sample_hi", "width_lo", "width_hi")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_spsearch") / "sp_small.fil"
    idx, starts = chip_smoke.sp_small_fil(str(path))
    return path, idx, starts


def _run_both(path, **overrides):
    want = JaxSearch(JaxConfig(**KW, **overrides)).run(jax_read_filterbank(path))
    got = SinglePulseSearch(SinglePulseConfig(**KW, **overrides), device="cpu").run(
        read_filterbank(path)
    )
    return want, got


SAMPLE_FIELDS = ("time_s", "sample", "sample_lo", "sample_hi")


def _assert_same_candidates(want, got, dec=0):
    """Every field equal but S/N (within SNR_RTOL) and, with ``dec``, the
    sample fields (within one dec block: tied sums)."""
    assert len(got.candidates) == len(want.candidates)
    exact = [f for f in FIELDS if not (dec and f in SAMPLE_FIELDS)]
    for rank, (a, b) in enumerate(zip(want.candidates, got.candidates)):
        assert [getattr(b, f) for f in exact] == [getattr(a, f) for f in exact], rank
        assert abs(b.snr - a.snr) <= SNR_RTOL * a.snr, rank
        if dec:
            for f in ("sample", "sample_lo", "sample_hi"):
                assert abs(getattr(b, f) - getattr(a, f)) < dec, (rank, f)


@pytest.fixture(scope="module")
def results(small):
    return _run_both(small[0])


def test_candidates_match_jax(results):
    want, got = results
    assert len(want.candidates) >= 2
    _assert_same_candidates(want, got)
    np.testing.assert_array_equal(got.dm_list, want.dm_list)
    assert got.widths == want.widths
    assert (got.n_events, got.n_overflowed, got.nsamps) == (
        want.n_events, want.n_overflowed, want.nsamps)
    assert got.n_events > 100


def test_recovers_both_pulses(small, results):
    _, idx, starts = small
    _, got = results
    widths = {9000: 8, 20000: 64}
    for c, start in zip(sorted(got.candidates[:2], key=lambda c: c.sample), starts):
        assert (c.dm_idx, c.sample, c.width) == (idx, start, widths[start])
        assert c.members > 1


@pytest.mark.parametrize("max_events", [1, 4])
def test_event_overflow_matches_jax(small, max_events):
    # a few events per trial near the pulses: the first K of each trial
    # are kept in ascending time, the rest counted as overflow
    want, got = _run_both(small[0], max_events=max_events)
    assert want.n_overflowed > 0
    assert got.n_overflowed == want.n_overflowed
    assert got.n_events == want.n_events
    _assert_same_candidates(want, got, dec=SinglePulseConfig().decimate)


@pytest.mark.parametrize("overrides", [dict(dm_block=5), dict(hbm_bytes=1 << 24)])
def test_dm_blocks_give_the_same_candidates(small, results, overrides):
    _, ref = results
    got = SinglePulseSearch(SinglePulseConfig(**KW, **overrides), device="cpu").run(
        read_filterbank(small[0])
    )
    assert [vars(c) for c in got.candidates] == [vars(c) for c in ref.candidates]


def test_cli_output_parses_and_matches_jax(small, tmp_path):
    path = small[0]
    flags = ["--dm_end", "60", "-m", "7", "--n_widths", "8"]
    assert cli_main(["-i", str(path), "-o", str(tmp_path / "port"), "--device", "cpu",
                     *flags]) == 0
    assert jax_cli_main(["-i", str(path), "-o", str(tmp_path / "jax"), *flags]) == 0
    got = read_singlepulse(str(tmp_path / "port" / "candidates.singlepulse"))
    want = read_singlepulse(str(tmp_path / "jax" / "candidates.singlepulse"))
    assert len(got) == len(want) >= 2
    for name in got.dtype.names:
        if name == "snr":
            # written with 4 decimals: the last one may round the other way
            np.testing.assert_allclose(got[name], want[name], rtol=SNR_RTOL, atol=1e-4)
        else:
            np.testing.assert_array_equal(got[name], want[name])
    ov, ref = (OverviewFile(str(tmp_path / d / "overview.xml")) for d in ("port", "jax"))
    np.testing.assert_array_equal(ov.dm_list, ref.dm_list)
    np.testing.assert_array_equal(ov.sp_widths, ref.sp_widths)
    assert {k: v for k, v in ov.sp_parameters.items() if k != "outdir"} == {
        k: v for k, v in ref.sp_parameters.items() if k != "outdir"}
    assert ov.header == ref.header
    assert len(ov.sp_candidates) == len(got)
    for name in ("dm_idx", "sample", "width", "members"):
        np.testing.assert_array_equal(ov.sp_candidates[name], ref.sp_candidates[name])
    np.testing.assert_allclose(ov.sp_candidates["snr"], ref.sp_candidates["snr"],
                               rtol=SNR_RTOL)
    assert {"plan", "dedispersion", "searching", "clustering", "reading", "writing",
            "total"} <= set(ov.execution_times)
    assert ov.root.find("cuda_device_parameters/platform").text == "cpu"
    assert not (tmp_path / "port" / "telemetry.json").exists()


@pytest.mark.parametrize("case", ["cold", "warm", "host RAM"])
def test_tune_now_runs(small, results, tmp_path, case):
    # ROADMAP A.10's first item, ported: tune, refused before, resolves the
    # bucket's plan from the tuning cache (measured on a cold bucket, read
    # back with no measurement on a warm one); its dedisp_block sizes the
    # segments of trials in host RAM ("host RAM": a memory budget that
    # spills them), which the events do not depend on
    from peasoup_tpu_torch.perf import tuning

    _, got = results
    kw = dict(KW, tune=True, tuning_cache=str(tmp_path / "tuning.json"))
    if case == "host RAM":
        kw["hbm_bytes"] = 1 << 20
    fil = read_filterbank(small[0])
    if case == "warm":
        SinglePulseSearch(SinglePulseConfig(**kw), device="cpu").run(fil)
    n0 = tuning.measurement_count()
    search = SinglePulseSearch(SinglePulseConfig(**kw), device="cpu")
    res = search.run(fil)
    plan = search.dedisp_plan
    assert plan.source == ("cache" if case == "warm" else "tuned")
    assert (tuning.measurement_count() == n0) == (case == "warm")
    assert plan.dedisp_block > 0 and plan.dm_block > 0 and plan.accel_bucket == 0
    assert [vars(c) for c in res.candidates] == [vars(c) for c in got.candidates]


@pytest.mark.parametrize("nshards", [2, 3, 8])
def test_shard_devices_now_run(small, results, nshards):
    # ROADMAP A.9, ported: shard_devices, refused before, shards the DM
    # trials over that many shards of the CPU; each trial's events do not
    # depend on its block, so the candidates are the unsharded run's
    _, got = results
    search = SinglePulseSearch(SinglePulseConfig(**KW, shard_devices=nshards),
                               device="cpu")
    assert len(search.devices) == nshards
    res = search.run(read_filterbank(small[0]))
    assert [vars(c) for c in res.candidates] == [vars(c) for c in got.candidates]


def test_checkpoint_option_now_runs(small, results, tmp_path):
    # ROADMAP A.4, ported: the option the port refused now runs, writes its
    # store and gives the default run's candidates
    _, got = results
    ckpt = tmp_path / "sp.ckpt"
    res = SinglePulseSearch(
        SinglePulseConfig(**KW, checkpoint_file=str(ckpt)), device="cpu"
    ).run(read_filterbank(small[0]))
    assert [vars(c) for c in res.candidates] == [vars(c) for c in got.candidates]
    assert ckpt.stat().st_size > 0


@pytest.mark.parametrize("dec", [48, 2048])
def test_odd_decimations_match_jax(tmp_path_factory, dec):
    # decimations the spchain kernel does not take, which the JAX package
    # runs on its boxcar rung: the small input cut to 24,576 samples, whose
    # padded trials (24,576) both divide
    path = tmp_path_factory.mktemp("torch_spsearch_dec") / "sp_odd.fil"
    idx, starts = chip_smoke.sp_small_fil(str(path), nsamps=24_576)
    want, got = _run_both(path, decimate=dec)
    assert got.candidates and len(got.candidates) == len(want.candidates)
    _assert_same_candidates(want, got, dec=dec)
    assert (got.n_events, got.n_overflowed) == (want.n_events, want.n_overflowed)
    for s in starts:
        assert any(c.dm_idx == idx and abs(c.sample - s) < dec for c in got.candidates)


def test_config_defaults_match_jax():
    # the port's fields are the JAX package's without its TPU knobs
    want, got = vars(JaxConfig()), vars(SinglePulseConfig())
    assert set(want) - set(got) == {"dedisp_block", "use_pallas"}
    assert got == {k: want[k] for k in got}
