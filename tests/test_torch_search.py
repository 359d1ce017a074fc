"""The port's acceleration search end to end on the CPU
(peasoup_tpu_torch.pipeline.search.PeasoupSearch with device="cpu", and
its CLI) against the JAX package's PeasoupSearch on the same 8-bit
synthetic filterbank.

Recall standard (ROADMAP.md): the same candidate count and, rank by
rank, the same dm_idx, acc and nh, the frequency bit for bit, and S/N
within a relative 1e-3. The two packages' CPU FFTs round differently,
which moves S/N in the sixth digit; no candidate of this input lies close enough to the threshold for that
to change the candidate set, so every candidate is compared.
"""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import peasoup_tpu.native
from peasoup_tpu.io import read_filterbank as jax_read_filterbank
from peasoup_tpu.pipeline import PeasoupSearch as JaxSearch
from peasoup_tpu.pipeline import SearchConfig as JaxConfig
from peasoup_tpu_torch.cli.peasoup import main as cli_main
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from test_pipeline import make_synthetic_fil

KW = dict(dm_start=0.0, dm_end=40.0, acc_start=-2.0, acc_end=2.0, min_snr=6.0)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return make_synthetic_fil(tmp_path_factory.mktemp("torch_search"))


@pytest.fixture(scope="module")
def jax_result(synthetic):
    # the JAX package's pure-Python host path, which the port carries:
    # its native C++ distiller orders S/N ties between accel trials with
    # bitwise-equal spectra differently, so another representative of
    # such a tie can head a candidate
    path, _, _ = synthetic
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(peasoup_tpu.native, "_load", lambda: None)
        return JaxSearch(JaxConfig(**KW)).run(jax_read_filterbank(path))


@pytest.fixture(scope="module")
def port_result(synthetic):
    path, _, _ = synthetic
    return PeasoupSearch(SearchConfig(**KW), device="cpu").run(read_filterbank(path))


def _identity(c):
    return (c.dm_idx, c.acc, c.nh, np.float32(c.freq))


def test_candidates_match_jax(jax_result, port_result):
    want, got = jax_result.candidates, port_result.candidates
    assert len(want) > 10
    assert len(got) == len(want)
    for rank, (a, b) in enumerate(zip(want, got)):
        assert _identity(b) == _identity(a), f"rank {rank}: {b} vs {a}"
        assert abs(b.snr - a.snr) <= 1e-3 * abs(a.snr), f"rank {rank}"
    np.testing.assert_array_equal(port_result.dm_list, jax_result.dm_list)
    np.testing.assert_array_equal(port_result.acc_list_dm0, jax_result.acc_list_dm0)
    assert port_result.n_accel_trials == jax_result.n_accel_trials
    assert (port_result.nsamps, port_result.size) == (jax_result.nsamps, jax_result.size)


def test_recovers_the_pulsar(synthetic, port_result):
    _, period, _ = synthetic
    top = port_result.candidates[0]
    assert abs(1.0 / top.freq - period) / period < 2e-3
    assert top.snr > 20.0


@pytest.mark.parametrize(
    "overrides",
    [
        dict(dedupe_accel=False),  # every accel trial dispatched
        dict(max_peaks=1),  # every row batch escalates its cluster slots
    ],
)
def test_dispatch_options_give_the_same_candidates(synthetic, port_result, overrides):
    path, _, _ = synthetic
    res = PeasoupSearch(SearchConfig(**KW, **overrides), device="cpu").run(
        read_filterbank(path)
    )
    assert [(_identity(c), c.snr) for c in res.candidates] == [
        (_identity(c), c.snr) for c in port_result.candidates
    ]


def test_small_blocks_give_the_same_candidates(synthetic, port_result):
    # many DM blocks and row batches; the CPU FFT of a smaller batch may
    # round differently, so S/N is held to 1e-5 relative
    path, _, _ = synthetic
    cfg = SearchConfig(**KW, hbm_bytes=1 << 22, dm_block=3)
    res = PeasoupSearch(cfg, device="cpu").run(read_filterbank(path))
    assert [_identity(c) for c in res.candidates] == [
        _identity(c) for c in port_result.candidates
    ]
    for a, b in zip(port_result.candidates, res.candidates):
        assert abs(b.snr - a.snr) <= 1e-5 * a.snr


def test_cli_writes_both_files(synthetic, tmp_path, port_result):
    path, period, _ = synthetic
    out = tmp_path / "out"
    argv = [
        "-i", str(path), "-o", str(out), "--dm_start", "0", "--dm_end", "40",
        "--acc_start", "-2", "--acc_end", "2", "-m", "6", "--device", "cpu",
    ]
    assert cli_main(argv) == 0
    assert os.path.getsize(out / "candidates.peasoup") > 0
    root = ET.parse(out / "overview.xml").getroot()
    cands = root.findall("candidates/candidate")
    assert len(cands) == len(port_result.candidates)
    assert abs(float(cands[0].find("period").text) - period) / period < 2e-3
    assert root.find("cuda_device_parameters/platform").text == "cpu"
    assert float(root.find("execution_times/searching").text) > 0


@pytest.mark.parametrize(
    "overrides,item",
    [
        (dict(npdmp=5), "A.9"),
        (dict(subbands=4), "A.3"),
        (dict(checkpoint_file="ck.json"), "A.8"),
        (dict(tune=True), "A.16"),
        (dict(shard_devices=2), "A.15"),
    ],
)
def test_unported_options_are_refused(overrides, item):
    with pytest.raises(NotImplementedError, match=item):
        PeasoupSearch(SearchConfig(**overrides), device="cpu")



@pytest.mark.parametrize("nbits", [2, 8])
def test_filterbank_files_cross_read(tmp_path, nbits):
    from peasoup_tpu.io import Filterbank as JaxFilterbank
    from peasoup_tpu.io import SigprocHeader as JaxHeader
    from peasoup_tpu.io import write_filterbank as jax_write_filterbank
    from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader, write_filterbank

    rng = np.random.default_rng(nbits)
    data = rng.integers(0, 1 << nbits, size=(1000, 16)).astype(np.uint8)
    hdr = dict(
        source_name="X", tsamp=6.4e-5, tstart=51000.5, fch1=1500.0, foff=-4.6875,
        nchans=16, nbits=nbits, nifs=1, data_type=1,
    )
    jax_write_filterbank(tmp_path / "j.fil", JaxFilterbank(header=JaxHeader(**hdr), data=data))
    write_filterbank(tmp_path / "t.fil", Filterbank(header=SigprocHeader(**hdr), data=data))
    assert (tmp_path / "j.fil").read_bytes() == (tmp_path / "t.fil").read_bytes()
    got = read_filterbank(tmp_path / "j.fil")
    want = jax_read_filterbank(tmp_path / "t.fil")
    np.testing.assert_array_equal(got.data, want.data)
    assert got.header.to_dict() == want.header.to_dict()
    assert (got.nsamps, got.cfreq) == (want.nsamps, want.cfreq)


def test_search_helpers_match_jax():
    from peasoup_tpu.pipeline import search as jax_search
    from peasoup_tpu_torch.pipeline import search as port_search

    rng = np.random.default_rng(5)
    nlev, nd = 3, 4
    cc = rng.integers(0, 4, size=(nlev, nd)).astype(np.int32)
    vi = rng.integers(0, 1000, size=int(cc.sum())).astype(np.int32)
    vs = rng.random(int(cc.sum())).astype(np.float32)
    emap = np.asarray([0, 0, 1, 2, 2, 3, 1])
    for name, args in (
        ("_expand_accel_results", (vi, vs, cc, emap, 16)),
        ("_densify_ragged", (vi, vs, cc)),
    ):
        got = getattr(port_search, name)(*args)
        want = getattr(jax_search, name)(*args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for n in (1, 4, 5, 16, 17, 45):
        assert port_search._accel_pad(n, 16) == jax_search._accel_pad(n, 16)
    # accel dedupe: an identity grid and one wide enough to split classes
    for accs, size in (([-2.0, 0.0, 2.0], 1 << 15), (np.linspace(-300, 300, 9), 1 << 17)):
        lists = [np.asarray(accs, np.float32)] * 2
        got = port_search._dedupe_identity_accels(lists, 0.000256, size)
        want = jax_search._dedupe_identity_accels(lists, 0.000256, size)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(g, w)
