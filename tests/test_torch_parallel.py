"""The port's parallel/ package and the sliced searches on the CPU, against
the JAX package on the same seeded inputs.

The JAX package's tests run on 8 virtual CPU devices (tests/conftest.py);
the port's counterpart is an explicit device list that repeats the CPU,
``[cpu] * 8``. Standards, stated at each test:

- dedisperse_sharded and sharded_coincidence: bitwise JAX's;
- the distributed FFTs: tests/test_distributed_fft.py's tolerance;
- searches over DM slices or shards: the recall standard (the same
  candidates rank by rank, dm_idx, acc and nh exact, the frequency bit for
  bit, S/N within 1e-3 relative), because a slice changes the height of the
  CPU FFT batches, which round with it (ROADMAP §C); where each DM trial is
  a block of its own (``dm_block=1``) the split run is bitwise the whole.
"""

import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.io import read_filterbank as jax_read_filterbank
from peasoup_tpu.parallel import coincidence as jcoin
from peasoup_tpu.parallel import mesh as jmesh
from peasoup_tpu.parallel import multihost as jmh
from peasoup_tpu.parallel.sharded_dedisperse import dedisperse_sharded as jax_dd_sharded
from peasoup_tpu.pipeline import PeasoupSearch as JaxSearch
from peasoup_tpu.pipeline import SearchConfig as JaxConfig
from peasoup_tpu.pipeline.single_pulse import SinglePulseConfig as JaxSPConfig
from peasoup_tpu.pipeline.single_pulse import SinglePulseSearch as JaxSPSearch
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.ops.coincidence import coincidence_mask
from peasoup_tpu_torch.ops.dedisperse import dedisperse, output_scale
from peasoup_tpu_torch.parallel import coincidence as tcoin
from peasoup_tpu_torch.parallel import distributed_fft as tdfft
from peasoup_tpu_torch.parallel import mesh as tmesh
from peasoup_tpu_torch.parallel import multihost as tmh
from peasoup_tpu_torch.parallel.sharded_dedisperse import ShardedRows, dedisperse_sharded
from peasoup_tpu_torch.parallel.sharded_search import make_sharded_search_fn, place_trials
from peasoup_tpu_torch.pipeline.accel_search import preprocess_block, search_rows
from peasoup_tpu_torch.pipeline.search import (
    PartialSearchResult, PeasoupSearch, SearchConfig, _level_windows, _pick_devices,
)
from peasoup_tpu_torch.pipeline.single_pulse import (
    PartialSinglePulseResult, SinglePulseConfig, SinglePulseSearch,
)
from peasoup_tpu_torch.plan.dm_plan import DMPlan
from test_pipeline import make_synthetic_fil

# the module (the JAX package's parallel/__init__ binds its function's name)
jdfft = importlib.import_module("peasoup_tpu.parallel.distributed_fft")

CPU = torch.device("cpu")
SNR_RTOL = 1e-3  # the recall standard
KW = dict(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0)


def _mesh(n, axis="dm"):
    return tmesh.make_mesh({axis: n}, devices=[CPU] * n)


# --- meshes -------------------------------------------------------------------


@pytest.mark.parametrize("axes", [None, {"dm": 8}, {"beam": 2, "dm": -1},
                                  {"beam": 2, "dm": 2, "seq": 2}, {"dm": -1, "beam": 4}])
def test_make_mesh_shapes_match_jax(axes):
    want = jmesh.make_mesh(axes, devices=jax.devices()[:8])
    got = tmesh.make_mesh(axes, devices=[CPU] * 8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == want.axis_names
    assert got.devices.shape == want.devices.shape


@pytest.mark.parametrize("axes", [{"dm": 3}, {"beam": 3, "dm": -1}, {"dm": 16}])
def test_make_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError):
        jmesh.make_mesh(axes, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="do not cover 8 devices"):
        tmesh.make_mesh(axes, devices=[CPU] * 8)


def test_global_mesh_and_local_slice_single_process():
    # one process: the mesh covers its devices, the cross-process axis
    # leads, and the whole axis is local, as in the JAX package
    want = jmh.global_mesh({"dm": -1, "beam": 1}, dcn_axis="beam")
    got = tmh.global_mesh({"dm": -1, "beam": 1}, dcn_axis="beam", device="cpu")
    assert got.axis_names == want.axis_names == ("beam", "dm")
    assert got.shape == {"beam": 1, "dm": 1}
    for axis in ("beam", "dm"):
        assert jmh.process_local_slice(want, axis) == (0, want.shape[axis])
        assert tmh.process_local_slice(got, axis) == (0, got.shape[axis])
    with pytest.raises(ValueError):
        jmh.global_mesh({"beam": 3}, dcn_axis="beam")
    with pytest.raises(ValueError):
        tmh.global_mesh({"beam": 3}, dcn_axis="beam", device="cpu")


def test_process_local_slice_of_a_two_process_layout():
    # the leading axis crosses processes: this process (rank 0) owns its
    # first half; an axis laid out across the processes' devices is local
    # everywhere; a layout that interleaves the processes is refused
    mesh = tmesh.make_mesh({"beam": 2, "dm": 4}, devices=[CPU] * 8)
    mesh.processes = np.repeat([0, 1], 4).reshape(2, 4)
    assert tmh.process_local_slice(mesh, "beam") == (0, 1)
    assert tmh.process_local_slice(mesh, "dm") == (0, 4)
    mesh = tmesh.make_mesh({"dm": 8}, devices=[CPU] * 8)
    mesh.processes = np.asarray([0, 1, 0, 1, 0, 1, 0, 1])
    with pytest.raises(ValueError, match="not contiguous"):
        tmh.process_local_slice(mesh, "dm")


# --- sharded dedispersion ----------------------------------------------------


def _dd_input(ndm):
    rng = np.random.default_rng(ndm)
    nchans, nsamps, tsamp = 16, 700, 0.000256
    plan = DMPlan.create(nsamps=nsamps, nchans=nchans, tsamp=tsamp, fch1=1400.0,
                         foff=-8.0, dm_start=0.0, dm_end=400.0, pulse_width=64.0,
                         tol=1.10)
    dms = np.linspace(0.0, 60.0, ndm, dtype=np.float32)
    delays = np.rint(dms[:, None] * np.abs(plan.delays)[None, :]).astype(np.int32)
    out_nsamps = nsamps - int(delays.max())
    kill = np.ones(nchans, dtype=np.int32)
    kill[5] = 0
    x = rng.integers(0, 256, size=(nsamps, nchans), dtype=np.uint8)
    return x, delays, kill, out_nsamps, output_scale(8, int(kill.sum()))


@pytest.mark.parametrize("ndm", [5, 8, 13])
def test_dedisperse_sharded_is_bitwise_jax_and_single_device(ndm):
    x, delays, kill, out_n, scale = _dd_input(ndm)
    jmesh8 = jmesh.make_mesh({"dm": 8}, devices=jax.devices()[:8])
    want = np.asarray(jax_dd_sharded(jnp.asarray(x), delays, kill, out_n, jmesh8,
                                     scale=scale, use_pallas=False))
    got = dedisperse_sharded(torch.from_numpy(x), delays, kill, out_n, _mesh(8),
                             scale=scale)
    assert isinstance(got, ShardedRows) and len(got) == ndm
    # every shard's block, the padding rows (copies of the last trial) too
    assert got.per == -(-ndm // 8) and len(got.parts) == 8
    np.testing.assert_array_equal(got.gather(CPU).numpy(), want)
    single = dedisperse(torch.from_numpy(x), delays, kill, out_n, scale=scale)
    np.testing.assert_array_equal(got.rows(0, ndm, CPU).numpy(), single.numpy())
    for i in (0, ndm // 2, ndm - 1):
        np.testing.assert_array_equal(got[i].numpy(), single[i].numpy())


# --- sharded search ----------------------------------------------------------


def _search_inputs(ndm=8, size=4096, n_accs=4):
    # tests/test_parallel.py's TestShardedSearch input, a P = 16 ms pulsar
    rng = np.random.default_rng(3)
    t = np.arange(size)
    tims = []
    for _ in range(ndm):
        x = rng.normal(30, 3, size=size)
        x += 10.0 * (((t * 0.000256) / 0.016) % 1.0 < 0.1)
        tims.append(np.clip(np.rint(x), 0, 255))
    tims = np.asarray(tims, dtype=np.uint8)
    afs = np.zeros((ndm, n_accs), dtype=np.float32)
    afs[:, 1:] = np.float32(1e-9) * np.arange(1, n_accs)
    windows = _level_windows(size, 2, 0.1, 1100.0, 0.000256)
    return tims, afs, np.zeros(size // 2 + 1, dtype=bool), windows


@pytest.mark.parametrize("nshards", [2, 4, 8])
@pytest.mark.parametrize("mega_harm", [True, False])
def test_sharded_search_matches_the_unsharded_block(nshards, mega_harm):
    # each shard preprocesses its own trials and searches their rows; the
    # peaks come back in row order. A shard's FFT batch is shorter than
    # the whole block's, so S/N is held to 1e-5 relative, as the port's
    # block tests hold blocks of other heights
    tims, afs, zap, windows = _search_inputs()
    size = tims.shape[1]
    geo = dict(size=size, nsamps_valid=size, pos5=10, pos25=100)
    kw = dict(nharms=2, max_peaks=64)
    routes = dict(fused_dft=False, mega_harm=mega_harm)
    ndm, na = afs.shape
    zap_t = torch.from_numpy(zap)
    xd, mean, std = preprocess_block(torch.from_numpy(tims), zap_t, **geo)
    row_dm = torch.arange(ndm, dtype=torch.int32).repeat_interleave(na)
    want = search_rows(xd, row_dm, torch.from_numpy(afs.reshape(-1)), mean[row_dm],
                       std[row_dm], windows, threshold=6.0, **kw, **routes)
    mesh = _mesh(nshards)
    shards = place_trials(mesh, tims)
    jobs = []
    for s in range(nshards):
        lo, hi = s * shards.per, min((s + 1) * shards.per, ndm)
        xs, ms, ss = preprocess_block(shards.parts[s][: hi - lo], zap_t, **geo)
        r = torch.arange(hi - lo, dtype=torch.int32).repeat_interleave(na)
        jobs.append((xs, r, torch.from_numpy(afs[lo:hi].reshape(-1)), ms[r], ss[r]))
    got = make_sharded_search_fn(mesh, 6.0, **routes)(jobs, windows, **kw)
    np.testing.assert_array_equal(got.ccounts, want.ccounts.numpy())
    np.testing.assert_array_equal(got.counts, want.counts.numpy())
    np.testing.assert_array_equal(got.idxs, want.idxs.numpy())
    np.testing.assert_allclose(got.snrs, want.snrs.numpy(), rtol=1e-5)
    assert (got.ccounts.reshape(ndm, -1).sum(axis=1) > 0).all()  # every trial fired


def test_sharded_search_refuses_a_job_list_of_another_length():
    fn = make_sharded_search_fn(_mesh(4), 6.0)
    with pytest.raises(ValueError, match="3 jobs for 4 shards"):
        fn([None] * 3, np.zeros((3, 2), np.int32), nharms=2, max_peaks=8)


# --- sharded coincidence -----------------------------------------------------


def test_sharded_coincidence_is_jax_exactly():
    rng = np.random.default_rng(0)
    beams = rng.normal(size=(8, 512)).astype(np.float32)
    beams[:, 100] = 10.0  # all beams -> RFI
    beams[0, 200] = 10.0  # one beam -> keep
    beams[:5, 300] = 10.0  # five of eight: past beam_thresh 4
    want = np.asarray(jcoin.sharded_coincidence(
        jmesh.make_mesh({"beam": 8}, devices=jax.devices()[:8]), jnp.asarray(beams),
        4.0, 4))
    for n in (1, 2, 4, 8):
        got = tcoin.sharded_coincidence(_mesh(n, "beam"), torch.from_numpy(beams), 4.0, 4)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[100] == 0.0 and want[200] == 1.0 and want[300] == 0.0
    np.testing.assert_array_equal(
        coincidence_mask(torch.from_numpy(beams), 4.0, 4).numpy(), want)


def test_sharded_coincidence_beam_axis_smaller_than_the_mesh():
    # 6 real beams padded to 8 with -inf, which never fire
    rng = np.random.default_rng(1)
    beams = rng.normal(size=(6, 256)).astype(np.float32)
    beams[:, 50] = 99.0
    stacked = np.concatenate([beams, np.full((2, 256), -np.inf, dtype=np.float32)])
    want = np.asarray(jcoin.sharded_coincidence(
        jmesh.make_mesh({"beam": 8}, devices=jax.devices()[:8]), jnp.asarray(stacked),
        4.0, 4))
    got = tcoin.sharded_coincidence(_mesh(8, "beam"), torch.from_numpy(stacked), 4.0, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[50] == 0.0
    with pytest.raises(ValueError, match="do not split"):
        tcoin.sharded_coincidence(_mesh(4, "beam"), torch.from_numpy(beams), 4.0, 4)


# --- distributed FFT ---------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4, 8])
def test_distributed_fft_matches_jax(p):
    rng = np.random.default_rng(7)
    jm = jmesh.make_mesh({"seq": p}, devices=jax.devices()[:p])
    mesh = _mesh(p, "seq")
    n = 64 * p * p
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    want = jdfft.unshuffle_fft_order(np.asarray(jdfft.distributed_fft(jnp.asarray(x), jm, "seq")))
    got = tdfft.unshuffle_fft_order(tdfft.distributed_fft(torch.from_numpy(x), mesh, "seq").numpy())
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-2)
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=2e-4, atol=2e-2)
    n = 128 * p * p
    x = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jdfft.distributed_rfft(jnp.asarray(x), jm, "seq"))
    got = tdfft.distributed_rfft(torch.from_numpy(x), mesh, "seq").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-2)
    np.testing.assert_allclose(got, np.fft.rfft(x)[: n // 2], rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_distributed_fft_refuses_the_jax_packages_bad_lengths(p):
    jm = jmesh.make_mesh({"seq": p}, devices=jax.devices()[:p])
    mesh = _mesh(p, "seq")
    with pytest.raises(ValueError):
        jdfft.distributed_fft(jnp.zeros(p * p + 1, jnp.complex64), jm, "seq")
    with pytest.raises(ValueError, match="divisible"):
        tdfft.distributed_fft(torch.zeros(p * p + 1, dtype=torch.complex64), mesh, "seq")
    with pytest.raises(ValueError):
        jdfft.distributed_rfft(jnp.zeros(6, jnp.float32), jm, "seq")
    with pytest.raises(ValueError, match="divisible"):
        tdfft.distributed_rfft(torch.zeros(6), mesh, "seq")


# --- the periodicity search over DM slices -----------------------------------


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_fil(tmp_path_factory.mktemp("torch_parallel"))


def _assert_recall(want, got):
    assert len(got) == len(want) > 0
    for rank, (a, b) in enumerate(zip(want, got)):
        assert (b.dm_idx, b.acc, b.nh, np.float32(b.freq)) == (
            a.dm_idx, a.acc, a.nh, np.float32(a.freq)), f"rank {rank}"
        assert abs(b.snr - a.snr) <= SNR_RTOL * abs(a.snr), f"rank {rank}"


@pytest.mark.parametrize("pid", [0, 1])
def test_partial_slice_matches_jax(synthetic, pid):
    # run(dm_slice, finalize=False): the slice's per-DM candidates, global
    # dm_idx, at the recall standard against the JAX package's partial
    path = str(synthetic[0])
    jax_fil, fil = jax_read_filterbank(path), read_filterbank(path)
    ndm = len(PeasoupSearch(SearchConfig(**KW), device="cpu").build_dm_plan(fil).dm_list)
    lo, hi = tmh.dm_slice_for_process(ndm, 2, pid)
    want = JaxSearch(JaxConfig(**KW)).run(jax_fil, dm_slice=(lo, hi), finalize=False)
    got = PeasoupSearch(SearchConfig(**KW), device="cpu").run(
        fil, dm_slice=(lo, hi), finalize=False)
    assert isinstance(got, PartialSearchResult) and got.dm_offset == lo
    key = lambda c: (c.dm_idx, np.float32(c.freq), c.acc, c.nh)  # noqa: E731
    want_c, got_c = sorted(want.cands, key=key), sorted(got.cands, key=key)
    assert {c.dm_idx for c in got_c} <= set(range(lo, hi))
    _assert_recall(want_c, got_c)
    assert got.n_accel_trials == want.n_accel_trials
    np.testing.assert_array_equal(got.dm_list, want.dm_list)


def _merged(parts, full_dm_list):
    cands = [c for p in parts for c in p.cands]

    def make(part):
        import dataclasses

        return dataclasses.replace(
            part, cands=pickle.loads(pickle.dumps(cands)), dm_list=full_dm_list,
            n_accel_trials=sum(p.n_accel_trials for p in parts), timers=dict(part.timers))

    return make


@pytest.mark.parametrize("dm_block,bitwise", [(0, False), (1, True)])
def test_two_slices_merged_give_the_single_run(synthetic, dm_block, bitwise):
    # the multi-process flow, sequentially: two slices, their candidates
    # merged, each "process" finalizing with the pooled fold outcomes
    # (tests/test_pipeline.py's test_sliced_merge_matches_full_run). With a
    # block a DM trial the split run is bitwise the single one; otherwise
    # it holds the recall standard, against the port's and the JAX
    # package's single runs
    fil = read_filterbank(str(synthetic[0]))
    cfg = dict(KW, npdmp=4, dm_block=dm_block)
    full = PeasoupSearch(SearchConfig(**cfg), device="cpu").run(fil)
    ndm = len(full.dm_list)
    parts = []
    for pid in range(2):
        search = PeasoupSearch(SearchConfig(**cfg), device="cpu")
        parts.append((search, search.run(fil, dm_slice=tmh.dm_slice_for_process(ndm, 2, pid),
                                         finalize=False)))
    make = _merged([p for _, p in parts], full.dm_list)
    harvested = []
    for search, part in parts:
        search.finalize(fil, make(part), fold_exchange=lambda o: harvested.append(
            pickle.loads(pickle.dumps(o))) or o)
    pooled = [o for out in harvested for o in out]
    assert len(pooled) == 4  # the top 4, each folded by its trial's owner only
    results = [search.finalize(fil, make(part), fold_exchange=lambda o: pooled)
               for search, part in parts]
    assert [c.dm_idx for c in results[0].candidates] == [c.dm_idx for c in results[1].candidates]
    for res in results:
        assert res.n_accel_trials == full.n_accel_trials
        if bitwise:
            assert [(c.freq, c.snr, c.dm, c.dm_idx, c.acc, c.nh, c.folded_snr, c.opt_period)
                    for c in res.candidates] == [
                (c.freq, c.snr, c.dm, c.dm_idx, c.acc, c.nh, c.folded_snr, c.opt_period)
                for c in full.candidates]
        else:
            _assert_recall(full.candidates, res.candidates)
            for a, b in zip(full.candidates, res.candidates):
                assert abs(b.folded_snr - a.folded_snr) <= SNR_RTOL * max(1.0, a.folded_snr)
    jax_full = JaxSearch(JaxConfig(**dict(KW, npdmp=4))).run(
        jax_read_filterbank(str(synthetic[0])))
    _assert_recall(jax_full.candidates, results[0].candidates)


def test_empty_slice_behaves_as_jax(synthetic):
    # more processes than DM trials: an empty slice contributes nothing,
    # never dedisperses, and finalizes to no candidates
    path = str(synthetic[0])
    fil, jax_fil = read_filterbank(path), jax_read_filterbank(path)
    ndm = len(PeasoupSearch(SearchConfig(**KW), device="cpu").build_dm_plan(fil).dm_list)
    want = JaxSearch(JaxConfig(**KW)).run(jax_fil, dm_slice=(ndm, ndm), finalize=False)
    search = PeasoupSearch(SearchConfig(**KW), device="cpu")
    got = search.run(fil, dm_slice=(ndm, ndm), finalize=False)
    assert got.cands == want.cands == []
    assert got.n_accel_trials == want.n_accel_trials == 0
    assert got.dm_offset == want.dm_offset == ndm
    assert len(got.trials) == 0 and got.size == want.size
    np.testing.assert_array_equal(got.acc_list_dm0, want.acc_list_dm0)
    assert got.timers["dedispersion"] == want.timers["dedispersion"] == 0.0
    assert search.run(fil, dm_slice=(ndm, ndm)).candidates == []


@pytest.mark.parametrize("nshards", [3, 8])
def test_explicit_cpu_shards_give_the_unsharded_candidates(synthetic, nshards):
    # devices=[cpu] * n, the tests' counterpart of a mesh of n cards, with
    # folding: each shard dedisperses its 1/n of the trials; the folder
    # reads them where they are. dm_block=1 keeps every FFT batch the
    # unsharded run's, so the candidates are bitwise its
    fil = read_filterbank(str(synthetic[0]))
    cfg = SearchConfig(**KW, npdmp=3, dm_block=1)
    full = PeasoupSearch(cfg, device="cpu").run(fil)
    search = PeasoupSearch(cfg, devices=[CPU] * nshards)
    assert search.mesh.shape == {"dm": nshards}
    got = search.run(fil)
    assert [(c.freq, c.snr, c.dm_idx, c.acc, c.nh, c.folded_snr, c.opt_period)
            for c in got.candidates] == [
        (c.freq, c.snr, c.dm_idx, c.acc, c.nh, c.folded_snr, c.opt_period)
        for c in full.candidates]


# --- the single-pulse search over DM slices -----------------------------------


@pytest.fixture(scope="module")
def sp_small(tmp_path_factory):
    import chip_smoke

    path = tmp_path_factory.mktemp("torch_parallel_sp") / "sp_small.fil"
    chip_smoke.sp_small_fil(str(path))
    return str(path)


SP_KW = dict(dm_end=60.0, min_snr=7.0, n_widths=8)


def test_single_pulse_slices_merged_give_the_single_run(sp_small):
    # three slices' events (global dm_idx, inside each slice) merged and
    # clustered once (tests/test_singlepulse.py's sliced merge): each
    # slice's events are the whole run's events of its trials, so the
    # merge is the single run field for field; and it is the JAX
    # package's merge of its own slices at the port's spsearch standard
    # (every field but S/N exact, S/N within 1e-5 relative)
    import dataclasses

    fil, jfil = read_filterbank(sp_small), jax_read_filterbank(sp_small)
    search = SinglePulseSearch(SinglePulseConfig(**SP_KW), device="cpu")
    whole = search.run(fil, finalize=False)
    full = search.finalize(fil, dataclasses.replace(whole, timers={}))
    ndm = len(full.dm_list)
    jsearch = JaxSPSearch(JaxSPConfig(**SP_KW))
    parts, jparts = [], []
    for pid in range(3):
        lo, hi = tmh.dm_slice_for_process(ndm, 3, pid)
        part = search.run(fil, dm_slice=(lo, hi), finalize=False)
        assert isinstance(part, PartialSinglePulseResult)
        inside = (whole.events["dm_idx"] >= lo) & (whole.events["dm_idx"] < hi)
        np.testing.assert_array_equal(part.events, whole.events[inside])
        parts.append(part)
        jparts.append(jsearch.run(jfil, dm_slice=(lo, hi), finalize=False))
    merged = dataclasses.replace(
        parts[0], events=np.concatenate([p.events for p in parts]),
        n_overflowed=sum(p.n_overflowed for p in parts))
    got = search.finalize(fil, merged)
    assert [vars(c) for c in got.candidates] == [vars(c) for c in full.candidates]
    assert len(got.candidates) >= 2
    jmerged = dataclasses.replace(
        jparts[0], events=np.concatenate([p.events for p in jparts]),
        n_overflowed=sum(p.n_overflowed for p in jparts))
    want = jsearch.finalize(jfil, jmerged)
    assert len(want.candidates) == len(got.candidates)
    for a, b in zip(want.candidates, got.candidates):
        for name in ("dm_idx", "sample", "width", "members", "dm_idx_lo", "dm_idx_hi"):
            assert getattr(b, name) == getattr(a, name), name
        assert abs(b.snr - a.snr) <= 1e-5 * a.snr


def test_single_pulse_empty_slice_behaves_as_jax(sp_small):
    fil, jfil = read_filterbank(sp_small), jax_read_filterbank(sp_small)
    search = SinglePulseSearch(SinglePulseConfig(**SP_KW), device="cpu")
    ndm = search.build_dm_plan(fil).ndm
    got = search.run(fil, dm_slice=(ndm, ndm), finalize=False)
    want = JaxSPSearch(JaxSPConfig(**SP_KW)).run(jfil, dm_slice=(ndm, ndm), finalize=False)
    assert len(got.events) == len(want.events) == 0
    assert got.events.dtype == want.events.dtype
    np.testing.assert_array_equal(got.dm_list, want.dm_list)
    assert got.widths == want.widths and got.n_overflowed == want.n_overflowed == 0


def test_single_pulse_explicit_cpu_shards(sp_small):
    fil = read_filterbank(sp_small)
    full = SinglePulseSearch(SinglePulseConfig(**SP_KW), device="cpu").run(fil)
    got = SinglePulseSearch(SinglePulseConfig(**SP_KW), devices=[CPU] * 8).run(fil)
    assert [vars(c) for c in got.candidates] == [vars(c) for c in full.candidates]


# --- the devices a search shards over, on a mocked four-card host -------------


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("device,shard_devices,max_threads,want", [
    ("cuda", 0, 14, _cuda(0, 1, 2, 3)),  # every local card
    ("cuda", 0, 3, _cuda(0, 1, 2)),  # up to max_num_threads
    ("cuda", 2, 14, _cuda(0, 1)),  # forced, from the first card
    ("cuda:1", 0, 14, _cuda(1)),  # an indexed card alone
    ("cuda:1", 1, 14, _cuda(1)),  # forced to one: that card, not cuda:0
    ("cuda:3", 2, 14, _cuda(3, 0)),  # from the indexed card on, wrapping round
    ("cuda:2", 8, 14, _cuda(2, 3, 0, 1)),  # capped at the count
])
def test_pick_devices_starts_at_an_indexed_card(monkeypatch, device, shard_devices,
                                                max_threads, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = SearchConfig(shard_devices=shard_devices, max_num_threads=max_threads)
    assert _pick_devices(device, cfg) == want


@pytest.mark.parametrize("local_rank", [None, "0", "1", "3"])
def test_each_process_shards_from_its_own_card(monkeypatch, local_rank):
    # a process of a two-process run takes cuda:LOCAL_RANK (its rank where
    # LOCAL_RANK is unset); with shard_devices=1 it stays on that card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    for rank in (0, 1):
        card = rank if local_rank is None else int(local_rank)
        dev = tmh.process_device("cuda", 2, rank)
        assert dev == torch.device("cuda", card)
        assert _pick_devices(dev, SearchConfig(shard_devices=1)) == _cuda(card)
        assert _pick_devices(dev, SinglePulseConfig(shard_devices=2)) == _cuda(
            card, (card + 1) % 4)
