"""The port's streaming search (peasoup_tpu_torch.io.dada, io.stream_source,
stream/, ops.streaming and cli.stream) against the JAX package's on the
CPU, the same numpy inputs from a seed (tests/test_stream.py's and
tests/test_dada.py's recipes: 4,096 8-bit samples in 8 channels with two
dispersed pulses, one inside a chunk's deferred zone).

Equality classes, test_torch_spsearch.py's: events and candidates exact
(DM trial, sample, width, members and the footprint), S/N within 1e-5
relative. The normalisation's masked sums run in row_sum's fixed order,
not XLA's; the dedispersed trials are integers, so boxcars in one dec
block can tie and the two packages break such a tie differently (ROADMAP
§C), which this input's events do not meet. The replay is also held
against the port's batch search (the JAX package's own standard: the same
candidates, S/N within 10%, the chunk-local moments).
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_stream as T
from peasoup_tpu.io import dada as jdada
from peasoup_tpu.io.sigproc import read_filterbank as jax_read_filterbank
from peasoup_tpu.io.stream_source import DadaStreamSource as JaxDadaSource
from peasoup_tpu.io.stream_source import ReplaySource as JaxReplay
from peasoup_tpu.ops import streaming as JS
from peasoup_tpu.stream import StreamConfig as JaxConfig
from peasoup_tpu.stream import StreamingSearch as JaxSearch
from peasoup_tpu.tools.parsers import read_singlepulse
from peasoup_tpu_torch.io import dada
from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.io.stream_source import (
    DadaStreamSource, FileTailSource, ReplaySource, StreamBlock, is_transient,
)
from peasoup_tpu_torch.ops import streaming as PS
from peasoup_tpu_torch.stream import BoundedBlockQueue, StreamConfig, StreamingSearch

SNR_RTOL = 1e-5
TOL = 1e-5  # test_torch_singlepulse.py's: normalised samples of order 10
CFG = dict(dm_end=20.0, min_snr=7.0, n_widths=6, decimate=8, chunk_samples=1024,
           latency_slo_s=30.0, warmup=False)
FIELDS = ("dm", "dm_idx", "time_s", "sample", "width", "width_idx", "members",
          "dm_idx_lo", "dm_idx_hi", "sample_lo", "sample_hi", "width_lo", "width_hi")


@pytest.fixture(scope="module")
def fil_path(tmp_path_factory):
    return T.stream_fil.__wrapped__(tmp_path_factory)


def _same_candidates(want, got):
    assert len(got) == len(want) > 0
    for rank, (a, b) in enumerate(zip(want, got)):
        assert [getattr(b, f) for f in FIELDS] == [getattr(a, f) for f in FIELDS], rank
        assert abs(b.snr - a.snr) <= SNR_RTOL * a.snr, rank


def _replay(fil_path, tmp, search_cls, config_cls, source_cls, read, source=None, **kw):
    cfg = config_cls(outdir=str(tmp), **dict(CFG, **kw))
    src = (source or source_cls)(read(fil_path), 256, rate=0.0)
    if search_cls is StreamingSearch:
        return StreamingSearch(cfg, device="cpu").run(src)
    return search_cls(cfg).run(src)


@pytest.fixture(scope="module")
def both(fil_path, tmp_path_factory):
    """(JAX result, port result, port outdir) of the replay."""
    jout, pout = tmp_path_factory.mktemp("jax_stream"), tmp_path_factory.mktemp("port_stream")
    want = _replay(fil_path, jout, JaxSearch, JaxConfig, JaxReplay, jax_read_filterbank)
    got = _replay(fil_path, pout, StreamingSearch, StreamConfig, ReplaySource,
                  read_filterbank)
    return want, got, pout


# --- geometry, normalisation and the chunk step ------------------------------


@pytest.mark.parametrize("widths,chunk,dec,hold", [
    ((1, 2, 4, 8), 1024, 8, 0), ((1, 2, 4, 8, 16, 32), 1024, 8, 0),
    ((1, 2, 4, 8), 1000, 16, 0), ((1, 64), 1024, 8, 8), ((1,), 8, 8, 16),
    ((1, 2, 4), 96, 48, 0),
])
def test_stream_geometry_matches_jax(widths, chunk, dec, hold):
    try:
        want = JS.stream_geometry(widths, chunk, dec, hold)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            PS.stream_geometry(widths, chunk, dec, hold)
        assert str(got.value) == str(exc)
    else:
        assert PS.stream_geometry(widths, chunk, dec, hold) == want


@pytest.mark.parametrize("valid_lo,nvalid", [(0, 1088), (64, 1088), (0, 700)])
def test_normalise_window_matches_jax(valid_lo, nvalid):
    rng = np.random.default_rng(valid_lo + nvalid)
    x = np.clip(np.rint(rng.normal(60, 6, size=(3, 1088))), 0, 255).astype(np.uint8)
    x[0, 500:508] = 200
    j = np.arange(1088)
    valid = (j >= valid_lo) & (j < nvalid)
    want = np.asarray(JS.normalise_window(jnp.asarray(x), jnp.asarray(valid)))
    got = PS.normalise_window(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got[:, ~valid] == 0).all()


def test_chunk_step_matches_jax():
    # tests/test_stream.py's tiled windows, through both packages' steps
    rng = np.random.default_rng(42)
    d, n, chunk, hold, dec = 3, 4096, 1024, 64, 8
    widths = (1, 2, 4, 8)
    x = rng.normal(30.0, 4.0, size=(d, n))
    for row, s, w, a in [(0, 500, 4, 22.0), (1, 2040, 8, 14.0), (2, 3500, 2, 28.0)]:
        x[row, s : s + w] += a
    x = np.clip(np.rint(x), 0, 255).astype(np.uint8)
    jfn = JS.make_stream_chunk_fn(widths, 7.0, 64, dec, hold, chunk)
    pfn = PS.make_stream_chunk_fn(widths, 7.0, 64, dec, hold, chunk)
    jtail = jnp.zeros((d, hold), jnp.uint8)
    ptail = torch.zeros((d, hold), dtype=torch.uint8)
    w = hold + chunk
    nchunks = n // chunk
    nev = 0
    for k in range(nchunks):
        new = x[:, k * chunk : (k + 1) * chunk]
        valid_lo = hold if k == 0 else 0
        emit = (valid_lo // dec, (w if k == nchunks - 1 else chunk) // dec)
        want = [np.asarray(v) for v in jfn(jtail, jnp.asarray(new), jnp.int32(valid_lo),
                                            jnp.int32(w), *(jnp.int32(e) for e in emit))]
        got = [v.numpy() for v in pfn(ptail, torch.from_numpy(new), valid_lo, w, *emit)]
        for i in (0, 1, 3):  # samples, widths, counts
            np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_allclose(got[2], want[2], rtol=SNR_RTOL)
        nev += int(got[3].sum())
        jtail = jnp.asarray(new[:, chunk - hold :])
        ptail = torch.from_numpy(np.ascontiguousarray(new[:, chunk - hold :]))
    assert nev >= 3  # the three pulses


def test_bad_window_decimation_is_refused():
    with pytest.raises(ValueError, match="divide the padded window"):
        PS.make_stream_chunk_fn((1, 2), 7.0, 16, 48, 48, 960)


# --- the driver --------------------------------------------------------------


def test_replay_matches_jax(both):
    want, got, _ = both
    _same_candidates(want.candidates, got.candidates)
    np.testing.assert_array_equal(got.dm_list, want.dm_list)
    assert got.widths == want.widths
    for f in ("n_chunks", "n_triggers", "n_events", "n_overflowed", "total_out_samples",
              "drops"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_chunks == 4 and got.drops == {"blocks": 0, "samples": 0, "gap_samples": 0}
    assert {s for s in T.PULSES} <= {c.sample for c in got.candidates}


def test_replay_matches_the_batch_search(both, fil_path):
    from peasoup_tpu_torch.pipeline.single_pulse import SinglePulseConfig, SinglePulseSearch

    _, got, _ = both
    batch = SinglePulseSearch(
        SinglePulseConfig(dm_end=20.0, min_snr=7.0, n_widths=6, decimate=8), device="cpu"
    ).run(read_filterbank(fil_path))
    key = lambda c: (c.dm_idx, c.sample, c.width)  # noqa: E731
    assert sorted(map(key, batch.candidates)) == sorted(map(key, got.candidates))
    bsnr = {key(c): c.snr for c in batch.candidates}
    for c in got.candidates:
        assert c.snr == pytest.approx(bsnr[key(c)], rel=0.1)


def test_latency_and_trigger_files(both):
    _, got, outdir = both
    lat = got.latency
    assert lat["slo"] == 30.0 and lat["misses"] == 0
    assert 0 < lat["p50"] <= lat["p95"] <= lat["max"]
    lines = [json.loads(ln) for ln in open(outdir / "triggers.jsonl")]
    assert len(lines) == got.n_triggers == len(got.candidates)
    assert [t["seq"] for t in lines] == list(range(1, len(lines) + 1))
    assert [t["sample"] for t in lines] == sorted(t["sample"] for t in lines)
    for t in lines:
        assert t["schema"] == "peasoup_tpu.trigger" and t["latency_s"] > 0
    table = read_singlepulse(str(outdir / "candidates.singlepulse"))
    assert len(table) == len(got.candidates)
    assert {"dedispersion", "searching", "clustering", "plan", "total"} <= set(got.timers)


class GappyPort(ReplaySource):
    def blocks(self):
        for blk in super().blocks():
            if blk.seq != 7:  # samples 1792..2047
                yield blk


class GappyJax(JaxReplay):
    def blocks(self):
        for blk in super().blocks():
            if blk.seq != 7:
                yield blk


@pytest.mark.parametrize("kw", [dict(), dict(max_chunks=2)])
def test_gaps_and_early_stops_match_jax(fil_path, tmp_path, kw):
    # a block lost upstream is zero-filled and counted; max_chunks cuts the
    # stream; both as the JAX package does it
    want = _replay(fil_path, tmp_path / "j", JaxSearch, JaxConfig, None,
                   jax_read_filterbank, source=GappyJax, **kw)
    got = _replay(fil_path, tmp_path / "p", StreamingSearch, StreamConfig, None,
                  read_filterbank, source=GappyPort, **kw)
    _same_candidates(want.candidates, got.candidates)
    assert got.drops == want.drops == {"blocks": 0, "samples": 0, "gap_samples": 256}
    assert got.n_chunks == want.n_chunks
    assert any(abs(c.sample - 900) <= 8 for c in got.candidates)


def test_config_defaults_match_jax():
    assert vars(StreamConfig()) == vars(JaxConfig())


def test_small_recipe_is_the_jax_tests(fil_path, tmp_path):
    # chip_smoke.py's card-against-CPU input is tests/test_stream.py's
    path = tmp_path / "small.fil"
    chip_smoke.stream_small_fil(str(path))
    assert path.read_bytes() == open(fil_path, "rb").read()


# --- sources, the queue and DADA ---------------------------------------------


def test_replay_blocks(fil_path):
    fil = read_filterbank(fil_path)
    blocks = list(ReplaySource(fil, block_samples=640, rate=0.0).blocks())
    want = list(JaxReplay(jax_read_filterbank(fil_path), 640, rate=0.0).blocks())
    assert [(b.seq, b.start_sample, b.nvalid, b.final) for b in blocks] == [
        (b.seq, b.start_sample, b.nvalid, b.final) for b in want]
    for a, b in zip(want, blocks):
        np.testing.assert_array_equal(b.data, a.data)


def test_replay_paces_release(fil_path):
    src = ReplaySource(read_filterbank(fil_path), block_samples=1024, rate=8.0)
    t0 = time.perf_counter()
    blocks = list(src.blocks())
    assert len(blocks) == 4
    assert time.perf_counter() - t0 >= 0.9 * (T.NSAMPS * T.TSAMP / 8.0)
    assert [b.t_arrival_s for b in blocks] == sorted(b.t_arrival_s for b in blocks)


def test_file_tail_follows_growth(fil_path, tmp_path):
    fil = read_filterbank(fil_path)
    path = tmp_path / "grow.fil"
    blob = open(fil_path, "rb").read()
    half = len(blob) - T.NSAMPS * T.NCHANS + (T.NSAMPS // 2) * T.NCHANS
    path.write_bytes(blob[:half])

    def finish():
        time.sleep(0.2)
        with open(path, "ab") as f:
            f.write(blob[half:])
        open(str(path) + ".complete", "w").close()

    t = threading.Thread(target=finish)
    t.start()
    blocks = list(FileTailSource(str(path), block_samples=768, poll_s=0.02).blocks())
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate([b.data[: b.nvalid] for b in blocks]),
                                  fil.data)
    assert blocks[-1].final


def test_dada_round_trip_and_segments_match_jax(tmp_path):
    # the port writes segments, both packages read them alike
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 255, size=(600, 16), dtype=np.uint8)
    common = dict(header_version=1.0, bw=64.0, freq=1382.0, nant=1, nchan=16, npol=1,
                  nbit=8, tsamp=256.0, source_name="J0000+00")
    dada.write_dada(tmp_path / "2020_0001.dada", payload[:256], **common)
    dada.write_dada(tmp_path / "2020_0002.dada", payload[256:], file_no=1, **common)
    open(tmp_path / "obs.complete", "w").close()
    for seg in ("2020_0001.dada", "2020_0002.dada"):
        assert vars(dada.DadaHeader.fromfile(tmp_path / seg)) == vars(
            jdada.DadaHeader.fromfile(tmp_path / seg))
    src = DadaStreamSource(str(tmp_path), block_samples=128)
    want = JaxDadaSource(str(tmp_path), block_samples=128)
    assert vars(src.format) == vars(want.format)
    assert src.format.fch1 == pytest.approx(1382.0 + 30.0) and src.format.foff == -4.0
    blocks = list(src.blocks())
    np.testing.assert_array_equal(np.concatenate([b.data[: b.nvalid] for b in blocks]),
                                  payload)
    assert [(b.start_sample, b.nvalid, b.final) for b in blocks] == [
        (b.start_sample, b.nvalid, b.final) for b in want.blocks()]
    # the two writers write the same bytes
    jdada.write_dada(tmp_path / "j.dada", payload, **common)
    dada.write_dada(tmp_path / "p.dada", payload, **common)
    assert (tmp_path / "j.dada").read_bytes() == (tmp_path / "p.dada").read_bytes()


def _blk(seq, n=64):
    return StreamBlock(seq=seq, start_sample=seq * n, data=np.zeros((n, 4), np.uint8),
                       nvalid=n)


def test_queue_block_policy_never_drops():
    q = BoundedBlockQueue(2, "block")
    q.put(_blk(0))
    q.put(_blk(1))
    got = []

    def drain():
        time.sleep(0.1)
        while (b := q.get(timeout=0.5)) is not None:
            got.append(b.seq)

    t = threading.Thread(target=drain)
    t.start()
    q.put(_blk(2))  # waits until the drainer frees a slot
    q.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == [0, 1, 2] and q.drops.blocks == 0


def test_queue_drop_oldest_accounts():
    q = BoundedBlockQueue(2, "drop_oldest")
    for seq in range(5):
        q.put(_blk(seq))
    q.close()
    kept = []
    while (b := q.get(timeout=0.1)) is not None:
        kept.append(b.seq)
    assert kept == [3, 4]
    assert (q.drops.blocks, q.drops.samples) == (3, 3 * 64)
    with pytest.raises(ValueError, match="policy"):
        BoundedBlockQueue(2, "drop_newest")


@pytest.mark.parametrize("exc,want", [
    (OSError(5, "EIO"), True), (TimeoutError(), True), (FileNotFoundError(2, "x"), False),
    (PermissionError(13, "x"), False), (OSError(22, "EINVAL"), False), (ValueError(), False),
])
def test_is_transient_matches_jax(exc, want):
    from peasoup_tpu.resilience import is_transient as jax_is_transient

    assert is_transient(exc) == jax_is_transient(exc) == want


# --- the CLI -----------------------------------------------------------------

FLAGS = ["--rate", "0", "--dm_end", "20", "-m", "7", "--n_widths", "6", "--chunk", "1024",
         "--decimate", "8", "--latency-slo", "30", "--no-warmup"]


@pytest.fixture
def jax_log_kept():
    """The JAX CLIs install their log handler on the stderr of the moment,
    here pytest's capture, which is closed after the test: put the JAX
    logger back as it was, so no later test in the process finds a handler
    on a closed stream."""
    from peasoup_tpu.obs import log as jax_log

    logger = jax_log.get_logger()
    handler, handlers, level = jax_log._handler, list(logger.handlers), logger.level
    yield
    jax_log._handler = handler
    logger.handlers[:] = handlers
    logger.setLevel(level)


def test_cli_replay_matches_jax(fil_path, tmp_path, capsys, jax_log_kept):
    from peasoup_tpu.cli.stream import main as jax_main
    from peasoup_tpu_torch.cli.stream import main

    assert main(["--replay", fil_path, "-o", str(tmp_path / "p"), "--device", "cpu",
                 "-v", *FLAGS]) == 0
    assert "Stream drained: 4 chunks, 2 triggers" in capsys.readouterr().out
    assert jax_main(["--replay", fil_path, "-o", str(tmp_path / "j"), *FLAGS]) == 0
    recs = [[json.loads(ln) for ln in open(tmp_path / d / "triggers.jsonl")]
            for d in ("j", "p")]
    assert len(recs[0]) == len(recs[1]) == 2
    skip = {"emitted_unix", "latency_s", "run_id", "snr"}
    for a, b in zip(*recs):
        assert {k: v for k, v in b.items() if k not in skip} == {
            k: v for k, v in a.items() if k not in skip}
        assert abs(b["snr"] - a["snr"]) <= 1e-4 + SNR_RTOL * a["snr"]
    want, got = (read_singlepulse(str(tmp_path / d / "candidates.singlepulse"))
                 for d in ("j", "p"))
    for name in want.dtype.names:
        if name != "snr":
            np.testing.assert_array_equal(got[name], want[name])
    # both write the run manifest with the streaming section (ROADMAP A.10's
    # telemetry, ported), each valid against its package's schema
    from peasoup_tpu.obs.schema import validate_manifest as jax_validate
    from peasoup_tpu_torch.obs.schema import validate_manifest

    for d, check in (("j", jax_validate), ("p", validate_manifest)):
        with open(tmp_path / d / "telemetry.json") as f:
            man = json.load(f)
        check(man)
        assert man["streaming"]["chunks_done"] == 4 and man["streaming"]["triggers"] == 2


@pytest.mark.parametrize("argv", [["--metrics-jsonl", "m.jsonl"], ["--status-json", "s.json"],
                                  ["--metrics-json", "t.json"]])
def test_cli_refuses_the_a10_flags(fil_path, tmp_path, argv):
    # ROADMAP A.10's telemetry, ported: the flags the CLI refused before now
    # run and write what they name: the metrics series (each sample valid
    # against the metrics schema), the final heartbeat with its streaming
    # section, or the manifest at the given path
    from peasoup_tpu_torch.cli.stream import main
    from peasoup_tpu_torch.obs.metrics import load_series
    from peasoup_tpu_torch.obs.schema import validate_manifest

    path = str(tmp_path / argv[1])
    assert main(["--replay", fil_path, "-o", str(tmp_path), "--device", "cpu", *FLAGS,
                 argv[0], path]) == 0
    if argv[0] == "--metrics-jsonl":
        series = load_series(path, validate=True)
        assert {r["name"] for r in series} >= {"chunk_latency_seconds", "chunks_total",
                                               "triggers_total"}
        assert max(r["value"] for r in series if r["name"] == "chunks_total") == 4
    else:
        with open(path) as f:
            doc = json.load(f)
        if argv[0] == "--status-json":
            assert doc["done"] is True and doc["streaming"]["chunks_done"] == 4
        else:
            validate_manifest(doc)
            assert [e["kind"] for e in doc["events"]].count("stream_trigger") == 2
