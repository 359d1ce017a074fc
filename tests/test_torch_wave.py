"""The wave fetch of the port's acceleration search on the CPU: the device
compaction (peasoup_tpu_torch.ops.peaks.compact_peaks_device and
pack_chunk_results) against the JAX package's, word for word, and
PeasoupSearch's rounds, each searched as one wave and read back in one
packed transfer a shard, against the JAX package's search on the same
synthetic filterbank.

The search's candidates are held to the recall standard against the JAX
package (ROADMAP.md: the same candidates rank by rank, dm_idx, acc, nh and
the frequency exact, S/N within 1e-3 relative) and bit for bit against the
port's default run, on one torch thread (the CPU FFT's bits then do not
follow the batch height, ROADMAP §C, C.3). Each DM trial's cluster stream
is also held bit for bit against the stream unpacked on the host from the
full slot arrays of one whole-block dispatch, the form the checkpoints
store and the distil reads."""

import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
from peasoup_tpu.io import read_filterbank as jax_read_filterbank
from peasoup_tpu.ops.peaks import compact_peaks_device as jax_compact
from peasoup_tpu.ops.peaks import pack_chunk_results as jax_pack
from peasoup_tpu.pipeline import PeasoupSearch as JaxSearch
from peasoup_tpu.pipeline import SearchConfig as JaxConfig
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.ops.peaks import compact_peaks_device, pack_chunk_results
from peasoup_tpu_torch.pipeline import search as search_mod
from peasoup_tpu_torch.pipeline.accel_search import preprocess_block, search_rows
from peasoup_tpu_torch.pipeline.checkpoint import SearchCheckpoint
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from peasoup_tpu_torch.ops.dedisperse import dedisperse, fil_to_device, output_scale
from peasoup_tpu_torch.ops.resample import accel_factor
from test_pipeline import make_synthetic_fil
from test_torch_search import one_thread

KW = dict(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0)


class Stop(Exception):
    """The interruption a test injects."""


# --- the compaction against the JAX package's --------------------------------

def _slots(seed: int, shape: tuple, mp: int, empty: float):
    """Seeded slot arrays of ``shape`` cells: counts up to mp + 2 (past the
    slots; the first cell's), a share ``empty`` of the cells with none (the
    last cell among them)."""
    rng = np.random.default_rng(seed)
    idxs = rng.integers(0, 1 << 20, size=(*shape, mp)).astype(np.int32)
    snrs = rng.normal(10.0, 3.0, size=(*shape, mp)).astype(np.float32)
    cc = rng.integers(1, mp + 3, size=shape).astype(np.int32)
    cc[rng.random(shape) < empty] = 0
    if empty < 1:
        cc.reshape(-1)[[0, -1]] = mp + 2, 0
    counts = (cc + rng.integers(0, 9, size=shape)).astype(np.int32)
    return idxs, snrs, counts, cc


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4)], ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("pad", ["total", "pow2", "larger"])
@pytest.mark.parametrize("mp", [1, 4, 8])
def test_compaction_matches_jax_word_for_word(shape, pad, mp):
    idxs, snrs, counts, cc = _slots(sum(shape) * 31 + mp, shape, mp, empty=0.3)
    total = int(np.minimum(cc, mp).sum())
    assert total > 0 and (cc > mp).any() and (cc == 0).any()
    total_pad = {"total": total, "pow2": search_mod._pow2(total),
                 "larger": 4 * search_mod._pow2(total)}[pad]
    t = [torch.from_numpy(a) for a in (idxs, snrs, counts, cc)]
    j = [jnp.asarray(a) for a in (idxs, snrs, counts, cc)]
    got = compact_peaks_device(t[0], t[1], t[3], total_pad=total_pad).numpy()
    want = np.asarray(jax_compact(j[0], j[1], j[3], total_pad=total_pad))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    got = pack_chunk_results(*t, total_pad=total_pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pack(*j, total_pad=total_pad)))
    # the smoke's host unpack of the full slot arrays gives the same words
    np.testing.assert_array_equal(got, chip_smoke.host_pack(idxs, snrs, counts, cc,
                                                            total_pad))


def test_compaction_of_empty_cells_is_zeros():
    idxs, snrs, counts, cc = _slots(3, (4, 6), 5, empty=1.0)
    assert not cc.any()
    got = compact_peaks_device(torch.from_numpy(idxs), torch.from_numpy(snrs),
                               torch.from_numpy(cc), total_pad=64).numpy()
    want = np.asarray(jax_compact(jnp.asarray(idxs), jnp.asarray(snrs), jnp.asarray(cc),
                                  total_pad=64))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (128,) and not got.any()


# --- the search's waves against the JAX package's search --------------------

@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_fil(tmp_path_factory.mktemp("torch_wave"))[0]


@pytest.fixture(scope="module")
def jax_result(synthetic):
    return JaxSearch(JaxConfig(**KW)).run(jax_read_filterbank(synthetic))


@pytest.fixture(scope="module")
def default_bits(synthetic):
    with one_thread():
        res = PeasoupSearch(SearchConfig(**KW), device="cpu").run(read_filterbank(synthetic))
    return _bits(res)


def _bits(res):
    return [(c.dm_idx, c.acc, c.nh, np.float32(c.freq), c.snr) for c in res.candidates]


def _assert_recall(jax_res, res):
    want, got = jax_res.candidates, res.candidates
    assert len(want) > 10 and len(got) == len(want)
    for rank, (a, b) in enumerate(zip(want, got)):
        assert (b.dm_idx, b.acc, b.nh, np.float32(b.freq)) == (
            a.dm_idx, a.acc, a.nh, np.float32(a.freq)), f"rank {rank}: {b} vs {a}"
        assert abs(b.snr - a.snr) <= 1e-3 * abs(a.snr), f"rank {rank}"


class _Fetches:
    """Counts the search's device-to-host transfers (search._fetch)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = search_mod._fetch

        def fetch(t):
            self.n += 1
            return real(t)

        monkeypatch.setattr(search_mod, "_fetch", fetch)


def _run(path, monkeypatch, blocks=None, learned_pad=None, budget=None, **kw):
    """One port search on one thread: (search, result, fetches).
    ``blocks`` fixes (DM trials a round, rows a batch)."""
    fetches = _Fetches(monkeypatch)
    search = PeasoupSearch(SearchConfig(**{**KW, **kw}), device="cpu")
    if blocks is not None:
        monkeypatch.setattr(search, "_blocks", lambda *a, **k: blocks)
    if learned_pad is not None:
        search._learned_total_pad = learned_pad
    if budget is not None:
        search.WAVE_BUDGET = budget
    with one_thread():
        res = search.run(read_filterbank(path))
    return search, res, fetches.n


# each case: (config and knobs, fetches it makes)
CASES = {
    # every accel trial dispatched: the one round's stream outgrows the
    # starting speculation (4096 entries), so it is compacted again
    "first round misses the speculation": (dict(dedupe_accel=False), 2),
    # every batch's clusters overflow one slot: fetched, re-dispatched
    # together at the next power of two, fetched again in one transfer
    "forced overflow": (dict(max_peaks=1), 2),
    # a learned speculation below the round's true total
    "learned pad below the total": (dict(learned_pad=64), 2),
    # batches of 2 rows over DM trials of 3 accel trials, each batch
    # fetched on its own (a budget that no two batches fit): a DM trial's
    # rows cut across batches and across fetches
    "DM trial cut across batches": (
        dict(dedupe_accel=False, blocks=(8, 2), budget=1), None),
    # two shards of the CPU: one packed fetch each a round
    "two shards": (dict(shard_devices=2), 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wave_cases_give_the_jax_candidates(synthetic, jax_result, default_bits,
                                            monkeypatch, case):
    kw, want_fetches = CASES[case]
    search, res, n = _run(synthetic, monkeypatch, **kw)
    _assert_recall(jax_result, res)
    assert _bits(res) == default_bits
    if want_fetches is not None:
        assert n == want_fetches
    if case == "first round misses the speculation":
        assert search._learned_total_pad > search_mod.TOTAL_PAD_START
    if case == "forced overflow":
        assert search._learned_max_peaks > 1
    if case == "DM trial cut across batches":
        plan = search.build_plan(read_filterbank(synthetic))
        rows = [sum(len(a) for a in plan.accel_lists[lo : lo + 8])
                for lo in range(0, plan.ndm, 8)]
        assert any(len(a) % 2 for a in plan.accel_lists)  # a DM trial is cut
        assert n == sum(-(-r // 2) for r in rows)  # one fetch a batch


def test_one_packed_fetch_per_round_and_shard(synthetic, monkeypatch):
    # DM blocks of 5 over two shards: each round fetches once a shard, and
    # nothing else is read back
    search, res, n = _run(synthetic, monkeypatch, dm_block=5, shard_devices=2)
    bounds = search_mod.shard_bounds(len(res.dm_list), 2)
    per_shard = [-(-(hi - lo) // 5) for lo, hi in bounds]
    assert n == sum(per_shard) > 2


def test_resumed_run_gives_the_jax_candidates(synthetic, jax_result, default_bits,
                                              tmp_path, monkeypatch):
    # a run stopped in its third round (DM blocks of 5) and resumed from
    # its checkpoint searches the rest in waves of its own
    ck = str(tmp_path / "wave.ckpt")
    calls = []
    real = search_mod.preprocess_block

    def stop_third(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise Stop("stopped")
        return real(*a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(search_mod, "preprocess_block", stop_third)
        with pytest.raises(Stop):
            _run(synthetic, mp, dm_block=5, checkpoint_file=ck)
    search, res, n = _run(synthetic, monkeypatch, dm_block=5, checkpoint_file=ck)
    ndm = len(res.dm_list)
    assert search.n_searched == ndm - 10
    assert n == -(-ndm // 5) - 2  # one fetch a round left
    _assert_recall(jax_result, res)
    assert _bits(res) == default_bits


def test_streams_are_the_host_unpack_of_whole_blocks(synthetic, tmp_path, monkeypatch):
    # the waves' per-DM streams (saved by the checkpoint, DM trials cut
    # across batches of 2 rows) against each DM trial's stream unpacked on
    # the host from one dispatch of the whole block at ample slots, in the
    # (level, accel) C order the JAX package packs: bit for bit
    ck = str(tmp_path / "cut.ckpt")
    search, res, _ = _run(synthetic, monkeypatch, blocks=(8, 2), dedupe_accel=False,
                          checkpoint_file=ck)
    cfg = SearchConfig(**KW, dedupe_accel=False, checkpoint_file=ck)
    fil = read_filterbank(synthetic)
    plan = search.build_plan(fil)
    per_dm = SearchCheckpoint(
        ck, SearchCheckpoint.make_key(cfg, fil, plan.size, plan.ndm)).load()
    assert sorted(per_dm) == list(range(plan.ndm))
    size = plan.size
    tobs = float(np.float32(size) * np.float32(fil.tsamp))
    bin_width = float(np.float32(1.0 / tobs))
    geometry = dict(size=size, nsamps_valid=min(plan.out_nsamps, size),
                    pos5=int(cfg.boundary_5_freq / bin_width),
                    pos25=int(cfg.boundary_25_freq / bin_width))
    scale = output_scale(fil.nbits, int(plan.killmask.sum()))
    with one_thread():
        trials = dedisperse(fil_to_device(fil, "cpu"), plan.delays, plan.killmask,
                            plan.out_nsamps, scale=scale)
        for lo in range(0, plan.ndm, 8):
            dms = range(lo, min(lo + 8, plan.ndm))
            xd, mean, std = preprocess_block(trials[lo : dms[-1] + 1, :size],
                                             torch.from_numpy(plan.zapmask), **geometry)
            row_dm = torch.tensor([d - lo for d in dms for _ in plan.accel_lists[d]],
                                  dtype=torch.int32)
            afs = torch.from_numpy(np.concatenate(
                [accel_factor(plan.accel_lists[d], fil.tsamp).astype(np.float32)
                 for d in dms]))
            peaks = search_rows(xd, row_dm, afs, mean[row_dm], std[row_dm], plan.windows,
                                threshold=float(np.float32(cfg.min_snr)),
                                nharms=cfg.nharmonics, max_peaks=512,
                                fused_dft=False, mega_harm=True)
            idxs, snrs, cc = (peaks.idxs.numpy(), peaks.snrs.numpy(),
                              peaks.ccounts.numpy())
            assert cc.max() <= 512
            r0 = 0
            for d in dms:
                r1 = r0 + len(plan.accel_lists[d])
                cells = cc[r0:r1].T
                keep = np.arange(512) < cells[..., None]
                want = (idxs[r0:r1].transpose(1, 0, 2)[keep],
                        snrs[r0:r1].transpose(1, 0, 2)[keep], cells)
                for got, ref in zip(per_dm[d], want):
                    assert got.dtype == ref.dtype
                    np.testing.assert_array_equal(got, ref)
                r0 = r1
