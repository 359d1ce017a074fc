"""Checkpoints, host-RAM trials and the memory ladder of the port's two
searches (peasoup_tpu_torch.pipeline.search.PeasoupSearch and
pipeline.single_pulse.SinglePulseSearch) on the CPU.

The CPU's FFTs and sums round differently with the size of the batch they
run over, so a run is held bit for bit only against a run whose DM blocks
and row batches are the same: a resumed run against an uninterrupted one
at the same block size (the store is saved after each whole block), a run
that met an out-of-memory error against a clean run at the block size the
ladder ended on. Candidates are compared field for field, S/N included.
The port's store is held against the JAX package's store for the same
search at the recall standard (ROADMAP.md): bins and counts equal, S/N
within a relative 1e-3."""

import logging
import os

import numpy as np
import pytest
import torch

import chip_smoke
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.parallel import sharded_search as sharded_mod
from peasoup_tpu_torch.pipeline import search as search_mod
from peasoup_tpu_torch.pipeline import single_pulse as sp_mod
from peasoup_tpu_torch.pipeline.checkpoint import SearchCheckpoint
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from peasoup_tpu_torch.pipeline.single_pulse import SinglePulseConfig, SinglePulseSearch
from test_pipeline import make_synthetic_fil

KW = dict(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0)
SP_KW = dict(dm_end=60.0, min_snr=7.0, n_widths=8)


class Stop(Exception):
    """The interruption a test injects."""


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_fil(tmp_path_factory.mktemp("torch_ckpt"))[0]


@pytest.fixture(scope="module")
def sp_small(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_ckpt_sp") / "sp_small.fil"
    chip_smoke.sp_small_fil(str(path))
    return path


def _cands(res):
    return [(c.dm_idx, c.acc, c.nh, c.freq, c.snr, c.opt_period, c.folded_snr)
            for c in res.candidates]


def _search(path, **kw):
    s = PeasoupSearch(SearchConfig(**{**KW, **kw}), device="cpu")
    return s, s.run(read_filterbank(path))


def _sp_search(path, **kw):
    s = SinglePulseSearch(SinglePulseConfig(**{**SP_KW, **kw}), device="cpu")
    return s, s.run(read_filterbank(path))


def _fail_on(monkeypatch, module, name, calls, exc):
    """Make module.name raise ``exc`` on the call numbers in ``calls``
    (1-based; True for every call). Returns the list of call numbers."""
    real = getattr(module, name)
    seen = []

    def wrapper(*a, **k):
        seen.append(len(seen) + 1)
        if calls is True or seen[-1] in calls:
            raise exc
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapper)
    return seen


@pytest.fixture(scope="module")
def clean(synthetic):
    return _cands(_search(synthetic, dm_block=5)[1])


@pytest.fixture(scope="module")
def sp_clean(sp_small):
    return _sp_search(sp_small, dm_block=5)[1].candidates


def test_resumed_search_equals_uninterrupted(synthetic, clean, tmp_path, monkeypatch):
    ck = str(tmp_path / "search.ckpt")
    with monkeypatch.context() as mp:
        _fail_on(mp, search_mod, "preprocess_block", {3}, Stop("interrupted"))
        with pytest.raises(Stop):
            _search(synthetic, dm_block=5, checkpoint_file=ck)
    s, res = _search(synthetic, dm_block=5, checkpoint_file=ck)
    ndm = len(res.dm_list)
    assert ndm > 10
    assert s.n_searched == ndm - 10  # two blocks of five were restored
    assert _cands(res) == clean


def test_resumed_spsearch_equals_uninterrupted(sp_small, sp_clean, tmp_path, monkeypatch):
    ck = str(tmp_path / "sp.ckpt")
    with monkeypatch.context() as mp:
        _fail_on(mp, sp_mod, "single_pulse_search_block", {3}, Stop("interrupted"))
        with pytest.raises(Stop):
            _sp_search(sp_small, dm_block=5, checkpoint_file=ck)
    s, res = _sp_search(sp_small, dm_block=5, checkpoint_file=ck)
    assert s.n_searched == len(res.dm_list) - 10
    assert [vars(c) for c in res.candidates] == [vars(c) for c in sp_clean]


@pytest.mark.parametrize("which", ["search", "spsearch"])
def test_fast_path_skips_dedispersion(synthetic, sp_small, clean, sp_clean, tmp_path,
                                      monkeypatch, which):
    ck = str(tmp_path / "full.ckpt")
    if which == "search":
        _search(synthetic, dm_block=5, checkpoint_file=ck)
        mod, run, want = search_mod, lambda: _search(synthetic, dm_block=5,
                                                       checkpoint_file=ck), clean
    else:
        _sp_search(sp_small, dm_block=5, checkpoint_file=ck)
        mod, run, want = sp_mod, lambda: _sp_search(sp_small, dm_block=5,
                                                     checkpoint_file=ck), sp_clean
    for name in ("dedisperse", "fil_to_device"):
        _fail_on(monkeypatch, mod, name, True, AssertionError(f"{name} ran"))
    s, res = run()
    assert s.n_searched == 0
    if which == "search":
        assert _cands(res) == want
    else:
        assert [vars(c) for c in res.candidates] == [vars(c) for c in want]


def test_folding_reads_the_trials_on_resume(synthetic, tmp_path):
    # with npdmp > 0 a fully restored run still dedisperses, for the folder
    ck = str(tmp_path / "fold.ckpt")
    _, first = _search(synthetic, dm_block=5, npdmp=3, checkpoint_file=ck)
    s, again = _search(synthetic, dm_block=5, npdmp=3, checkpoint_file=ck)
    assert s.n_searched == 0
    assert _cands(again) == _cands(first)
    assert sum(c.fold is not None for c in again.candidates) == 3


@pytest.mark.parametrize("damage", ["corrupt", "foreign"])
def test_damaged_or_foreign_store_restarts(synthetic, clean, tmp_path, caplog, damage):
    ck = tmp_path / "search.ckpt"
    if damage == "corrupt":
        ck.write_bytes(b"PK\x03\x04 torn mid-write")
    else:
        # a store for another search: another S/N threshold
        _search(synthetic, dm_block=5, checkpoint_file=str(ck), min_snr=7.0)
    with caplog.at_level(logging.WARNING, logger="peasoup_tpu_torch.checkpoint"):
        s, res = _search(synthetic, dm_block=5, checkpoint_file=str(ck))
    assert s.n_searched == len(res.dm_list)
    assert _cands(res) == clean
    if damage == "corrupt":
        assert (tmp_path / "search.ckpt.corrupt").exists()
        assert "discarding unreadable checkpoint" in caplog.text
    # the store now holds this search
    key = SearchCheckpoint.make_key(s.config, read_filterbank(synthetic), res.size,
                                    len(res.dm_list))
    assert len(SearchCheckpoint(str(ck), key).load()) == len(res.dm_list)


def test_store_holds_the_jax_packages_arrays(synthetic, tmp_path):
    from peasoup_tpu.io import read_filterbank as jax_read
    from peasoup_tpu.pipeline import PeasoupSearch as JaxSearch
    from peasoup_tpu.pipeline import SearchConfig as JaxConfig
    from peasoup_tpu.pipeline.checkpoint import SearchCheckpoint as JaxCheckpoint

    jck, pck = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jres = JaxSearch(JaxConfig(**KW, checkpoint_file=jck)).run(jax_read(str(synthetic)))
    _, pres = _search(synthetic, checkpoint_file=pck)
    jfil, pfil = jax_read(str(synthetic)), read_filterbank(synthetic)
    jkey = JaxCheckpoint.make_key(JaxConfig(**KW), jfil, jres.size, len(jres.dm_list))
    pkey = SearchCheckpoint.make_key(SearchConfig(**KW), pfil, pres.size,
                                     len(pres.dm_list))
    assert pkey == jkey  # the two packages key a search alike
    want = JaxCheckpoint(jck, jkey).load()
    got = SearchCheckpoint(pck, pkey).load()
    assert sorted(got) == sorted(want) == list(range(len(pres.dm_list)))
    for d in want:
        (wi, ws, wc), (gi, gs, gc) = want[d], got[d]
        n_acc = gc.shape[1]
        np.testing.assert_array_equal(gc, wc[:, :n_acc])
        assert not wc[:, n_acc:].any()
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, rtol=1e-3)


def test_load_unions_the_per_slice_stores(synthetic, clean, tmp_path):
    # the JAX package's processes each write a slice of the DM list to
    # base.dmLO-HI; the port's load() unions them (and the base file) under
    # global indices, and a resumed search finds every trial restored
    from peasoup_tpu.pipeline.checkpoint import SearchCheckpoint as JaxCheckpoint

    ck = str(tmp_path / "search.ckpt")
    s, full = _search(synthetic, dm_block=5, checkpoint_file=ck)
    key = SearchCheckpoint.make_key(s.config, read_filterbank(synthetic), full.size,
                                    len(full.dm_list))
    entries = SearchCheckpoint(ck, key).load()
    ndm = len(full.dm_list)
    cuts = (0, ndm // 3, 2 * ndm // 3, ndm)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        part = {d - lo: entries[d] for d in range(lo, hi)}
        JaxCheckpoint(ck, key, slice_bounds=(lo, hi)).save(part)
    os.remove(ck)
    got = SearchCheckpoint(ck, key).load()
    assert sorted(got) == list(range(ndm))
    for d in range(ndm):
        for a, b in zip(got[d], entries[d]):
            np.testing.assert_array_equal(a, b)
    s2, res = _search(synthetic, dm_block=5, checkpoint_file=ck)
    assert s2.n_searched == 0
    assert _cands(res) == clean


# --- the memory ladder and host-RAM trials ------------------------------

OOM = torch.OutOfMemoryError("CUDA out of memory (injected)")


def test_oom_shrink_rung(synthetic, monkeypatch, caplog):
    # the first search dispatch meets an OOM: every block runs at half size,
    # as a clean run at that size does
    want = _cands(_search(synthetic, dm_block=15, hbm_bytes=1 << 27)[1])
    seen = _fail_on(monkeypatch, sharded_mod, "search_rows", {1}, OOM)
    with caplog.at_level(logging.WARNING, logger="peasoup_tpu_torch.search"):
        _, res = _search(synthetic, dm_block=30, hbm_bytes=1 << 28)
    assert "device OOM at dm_block=30 (row batch 64)" in caplog.text
    assert "(dm_block=15, row batch 32)" in caplog.text
    assert len(seen) > 1
    assert _cands(res) == want


def test_oom_subband_rung(synthetic, clean, monkeypatch, caplog):
    # OOMs until the blocks reach one trial and one row; then the floor rung
    # (the JAX package's subband rung) frees the device-resident trials,
    # dedisperses again into host RAM through the dedisperse kernel's
    # wrapper, segment by segment, and sizing starts over
    fell = []
    real = search_mod.dedisperse_host

    def host(*a, **k):
        fell.append(1)
        out = real(*a, **k)
        assert isinstance(out, np.ndarray)
        return out

    monkeypatch.setattr(search_mod, "dedisperse_host", host)
    monkeypatch.setattr(search_mod, "dedisperse_subband", None)  # never reached
    real_rows = sharded_mod.search_rows

    def rows(*a, **k):
        if not fell:
            raise OOM
        return real_rows(*a, **k)

    monkeypatch.setattr(sharded_mod, "search_rows", rows)
    with caplog.at_level(logging.WARNING, logger="peasoup_tpu_torch.search"):
        _, res = _search(synthetic, dm_block=5)
    assert fell == [1]
    assert "dedispersing again into host RAM (dedisperse kernel" in caplog.text
    assert _cands(res) == clean


def test_oom_past_the_last_rung_raises(synthetic, monkeypatch):
    _fail_on(monkeypatch, sharded_mod, "search_rows", True, OOM)
    with pytest.raises(torch.OutOfMemoryError):
        _search(synthetic, dm_block=5, hbm_bytes=1 << 24)


@pytest.mark.parametrize("which", ["search", "spsearch"])
def test_other_errors_propagate(synthetic, sp_small, monkeypatch, which):
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    if which == "search":
        seen = _fail_on(monkeypatch, sharded_mod, "search_rows", {1}, err)
        run = lambda: _search(synthetic, dm_block=5)  # noqa: E731
    else:
        seen = _fail_on(monkeypatch, sp_mod, "single_pulse_search_block", {1}, err)
        run = lambda: _sp_search(sp_small, dm_block=5)  # noqa: E731
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run()
    assert seen == [1]


def test_is_oom():
    assert search_mod._is_oom(torch.OutOfMemoryError("CUDA out of memory"))
    assert search_mod._is_oom(RuntimeError("cuFFT error: CUFFT_ALLOC_FAILED"))
    assert not search_mod._is_oom(RuntimeError("CUDA error: misaligned address"))
    assert not search_mod._is_oom(MemoryError())


def test_sp_oom_shrink_rung(sp_small, monkeypatch, caplog):
    want = _sp_search(sp_small, dm_block=5)[1].candidates
    _fail_on(monkeypatch, sp_mod, "single_pulse_search_block", {1}, OOM)
    with caplog.at_level(logging.WARNING, logger="peasoup_tpu_torch.single_pulse"):
        _, res = _sp_search(sp_small, dm_block=10)
    assert "device OOM at dm_block=10; retrying with dm_block=5" in caplog.text
    assert [vars(c) for c in res.candidates] == [vars(c) for c in want]


def test_sp_oom_past_the_last_rung_raises(sp_small, monkeypatch):
    seen = _fail_on(monkeypatch, sp_mod, "single_pulse_search_block", True, OOM)
    with pytest.raises(torch.OutOfMemoryError):
        _sp_search(sp_small, dm_block=4)
    assert len(seen) == 3  # blocks of 4, 2, then 1 trial


@pytest.mark.parametrize("which", ["search", "spsearch"])
def test_host_ram_trials_give_the_same_candidates(synthetic, sp_small, monkeypatch,
                                                  which):
    if which == "search":
        want = _search(synthetic, dm_block=5, npdmp=3)[1]
        monkeypatch.setattr(PeasoupSearch, "TRIALS_DEVICE_LIMIT", 1)
        host = _fail_on(monkeypatch, search_mod, "dedisperse_host", set(), None)
        got = _search(synthetic, dm_block=5, npdmp=3)[1]
        assert _cands(got) == _cands(want)
        assert sum(c.fold is not None for c in got.candidates) == 3
    else:
        want = _sp_search(sp_small, dm_block=5)[1]
        monkeypatch.setattr(SinglePulseSearch, "TRIALS_DEVICE_LIMIT", 1)
        host = _fail_on(monkeypatch, sp_mod, "dedisperse_host", set(), None)
        got = _sp_search(sp_small, dm_block=5)[1]
        assert [vars(c) for c in got.candidates] == [vars(c) for c in want.candidates]
    assert host == [1]  # the trials went to host RAM
