"""A survey node's search, its DM trials dealt over four shards, traced
(pipeline/search.py, parallel/sharded_dedisperse.py,
parallel/sharded_search.py): every shard fed in every round under the
span ``Shard-Feed``, each shard's rows counted under ``shard.rows.<i>``
and summing to ``rows.dispatched``, and the filterbank's copies to
devices other than its own under ``Shard-Copy`` with their bytes in
``shard.copy_bytes``; none of it recorded while no profiler records."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from peasoup_tpu_torch.io.sigproc import read_filterbank
from peasoup_tpu_torch.parallel import mesh as tmesh
from peasoup_tpu_torch.parallel.sharded_dedisperse import dedisperse_sharded
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from peasoup_tpu_torch.utils import trace
from peasoup_tpu_torch.utils.trace import trace_span
from test_torch_parallel import _dd_input
from test_torch_search import KW, _bits, one_thread, synthetic  # noqa: F401

NSHARDS = 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def node(synthetic):  # noqa: F811
    """The synthetic search on four shards of the CPU under a CPU profiler:
    (result, its table)."""
    with one_thread(), profile(activities=[ProfilerActivity.CPU]):
        res = PeasoupSearch(SearchConfig(**KW, shard_devices=NSHARDS), device="cpu").run(
            read_filterbank(synthetic[0]))
    return res, res.trace


def test_every_shard_is_fed_in_every_round(node):
    _, table = node
    rounds = table.calls("DM-Loop")
    assert rounds >= 1
    # each round: one feed of each shard's block, and one or more of each
    # shard's row batches
    assert table.spans["Shard-Feed", "DM-Loop"].calls >= 2 * NSHARDS * rounds
    assert table.calls("Whitening") == NSHARDS * rounds
    assert ("Whitening", "Shard-Feed") in table.spans
    assert ("Acceleration-Loop", "Shard-Feed") in table.spans
    assert table.wall_s("Shard-Feed") > 0 and table.device_s("Shard-Feed") is None


def test_the_shards_rows_sum_to_the_rows_dispatched(node):
    _, table = node
    rows = {k: v for k, v in table.counters().items() if k.startswith("shard.rows.")}
    assert sorted(rows) == [f"shard.rows.{i}" for i in range(NSHARDS)]
    assert all(v > 0 for v in rows.values())
    assert sum(rows.values()) == table.count("rows.dispatched")


def test_shards_on_the_filterbanks_own_device_copy_nothing(node):
    _, table = node
    assert table.count("shard.copy_bytes") == 0
    assert table.calls("Shard-Copy") == 0


def test_the_traced_node_finds_the_untraced_nodes_candidates(synthetic, node):  # noqa: F811
    with one_thread():
        res = PeasoupSearch(SearchConfig(**KW, shard_devices=NSHARDS), device="cpu").run(
            read_filterbank(synthetic[0]))
    assert res.trace is None
    assert _bits(res) == _bits(node[0])


# a CPU tensor moved to "cpu:1" is copied (torch.device("cpu", 1) is not
# torch.device("cpu")), so a mesh of such devices makes the copies that
# cards other than the filterbank's own receive
@pytest.mark.parametrize("devices,copied", [
    ([CPU] * 4, 0),
    ([CPU, torch.device("cpu", 1), torch.device("cpu", 1), torch.device("cpu", 2)], 2),
    ([torch.device("cpu", 1)] * 4, 1),
])
def test_each_device_other_than_the_sources_receives_one_copy(devices, copied):
    x, delays, kill, out_n, _ = _dd_input(13)
    fil = torch.from_numpy(x)
    mesh = tmesh.make_mesh({"dm": len(devices)}, devices=devices)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace_span("Search", root=True) as table:
            with trace_span("Dedisperse"):
                got = dedisperse_sharded(fil, delays, kill, out_n, mesh)
    assert table.calls("Shard-Copy") == copied
    assert table.count("shard.copy_bytes") == copied * fil.numel() * fil.element_size()
    if copied:
        assert set(table.spans) >= {("Shard-Copy", "Dedisperse")}
        assert table.wall_s("Shard-Copy") > 0 and table.device_s("Shard-Copy") is None
    want = dedisperse_sharded(fil, delays, kill, out_n, tmesh.make_mesh(
        {"dm": 1}, devices=[CPU]))
    np.testing.assert_array_equal(got.gather(CPU)[: got.nrows].numpy(),
                                  want.gather(CPU)[: want.nrows].numpy())


# a copy between cards runs on the source card's stream; events on the
# receiving card's idle stream would also time the source's earlier work
def test_a_copy_is_timed_on_the_filterbanks_own_device(monkeypatch):
    from peasoup_tpu_torch.parallel import sharded_dedisperse as sd

    opened = []
    real = sd.trace_span
    monkeypatch.setattr(sd, "trace_span", lambda name, *a, **k: opened.append(
        (name, k.get("device"))) or real(name, *a, **k))
    x, delays, kill, out_n, _ = _dd_input(8)
    devices = [CPU, torch.device("cpu", 1), torch.device("cpu", 2), torch.device("cpu", 3)]
    with profile(activities=[ProfilerActivity.CPU]):
        with trace_span("Search", root=True) as table:
            dedisperse_sharded(torch.from_numpy(x), delays, kill, out_n,
                               tmesh.make_mesh({"dm": 4}, devices=devices))
    assert opened == [("Shard-Copy", CPU)] * 3
    assert table.calls("Shard-Copy") == 3


def test_untraced_the_node_enters_no_span(monkeypatch):
    entered = []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function",
                        lambda name, *a, **k: entered.append(name) or real(name, *a, **k))
    x, delays, kill, out_n, _ = _dd_input(8)
    devices = [CPU, torch.device("cpu", 1), torch.device("cpu", 2), torch.device("cpu", 3)]
    with trace_span("Search", root=True) as table:
        dedisperse_sharded(torch.from_numpy(x), delays, kill, out_n,
                           tmesh.make_mesh({"dm": 4}, devices=devices))
    assert table is None and entered == []
