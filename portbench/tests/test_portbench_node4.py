"""The four-card survey node (``htru_hilat.accel.x4``): the cell loads with
its configuration, whose observation is ``htru_hilat``'s, and its three
metrics alone; the tiny cell on four shards of the CPU runs through the
harness, is judged correct and gives the one-shard lists bit for bit;
and the three readers (metrics/shard_*.py) read the mean over the
window's span tables, and nothing where there is nothing to read."""

import json
import time
from contextlib import contextmanager

import pytest
import torch

from portbench import metrics, run
from portbench.cell import ROOT, benchmark, load_cell
from portbench.run import Context

CELL = "htru_hilat.accel.x4"
NEW = {"shard_copy_s", "shard_feed_s", "shard_row_skew"}
SEED = 2**31 + 91
JUDGE = run.judge_run


@contextmanager
def one_thread():
    """torch's CPU work on one thread: a shard's shorter FFT batches then
    round as the whole block's do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_the_cell_runs_the_node_configuration_on_four_chips():
    cell = load_cell(CELL)
    assert cell.chips == 4
    assert {m["name"] for m in cell.per_layer} == NEW
    assert {m["name"] for m in cell.end_to_end} == {"obs_s", "setup_s"}
    assert cell.traffic == load_cell("htru_hilat.accel").traffic
    for m in benchmark()["per_layer"]:
        assert (m["name"] in NEW) == (CELL in m["workloads"])
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "obs_s"


def test_the_node_observes_what_one_card_observes():
    node = json.loads((ROOT / "portbench/configs/htru_hilat_node4.json").read_text())
    one = json.loads((ROOT / "portbench/configs/htru_hilat.json").read_text())
    for key in ("header", "killed", "quantiser", "mains_hz", "dm_max"):
        assert node[key] == one[key], key
    assert node["reduced"] == [] and "four H100s" in node["deployment"]


def _lists(monkeypatch, cell, chips, trace=False):
    """A run of ``cell`` on ``chips`` shards of the CPU: (its result, every
    distinct list's candidate keys)."""
    seen = []

    def judge(cell, obs, lists, seed, device, control=False):
        seen.extend([[a.key() for a in ans] for ls in lists for ans in ls])
        return JUDGE(cell, obs, lists, seed, device, control)

    monkeypatch.setattr(run, "judge_run", judge)
    cell.chips = chips
    with one_thread():
        res = run.run_cell(cell, SEED, 0.1, trace, torch.device("cpu"), time.perf_counter())
    return res, seen


def test_four_shards_of_the_tiny_cell_are_correct_and_give_one_shards_lists(monkeypatch,
                                                                            tiny_cell):
    one, want = _lists(monkeypatch, tiny_cell, 1)
    four, got = _lists(monkeypatch, tiny_cell, 4)
    assert four["correct"], four["checks"]
    assert one["correct"], one["checks"]
    assert want and all(want)
    assert got == want
    assert four["info"]["top"] == one["info"]["top"]


def test_a_traced_four_shard_run_reads_the_feed_and_the_skew(monkeypatch, tiny_cell):
    tiny_cell.per_layer = [m for m in benchmark()["per_layer"] if m["name"] in NEW]
    res, _ = _lists(monkeypatch, tiny_cell, 4, trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # the CPU's four shards share the filterbank's device: no copy to read
    assert set(got) == {"shard_feed_s", "shard_row_skew"}
    assert got["shard_feed_s"]["value"] > 0 and got["shard_feed_s"]["unit"] == "s"
    assert 0 <= got["shard_row_skew"]["value"] < 100


def _table(k: float, shards=(300, 300, 200, 200)):
    """A window table: its copies and feeds ``k`` times a base value, and
    each shard's rows."""
    from peasoup_tpu_torch.utils.trace import RunTable, SpanStats

    tab = RunTable("Search")
    rows = [("Shard-Copy", "Dedisperse", 0.01, 0.5, {"shard.copy_bytes": 3}),
            ("Shard-Feed", "DM-Loop", 1.5, 0.1, {"shard.rows.0": shards[0]}),
            ("Shard-Feed", "Wave-Fetch", 0.5, 0.1, {}),
            ("DM-Loop", "Search", 4.0, None,
             {f"shard.rows.{i}": n for i, n in enumerate(shards) if i and n})]
    for name, parent, wall, dev, counters in rows:
        st = tab.spans[name, parent] = SpanStats(name, parent)
        st.calls, st.wall_s, st.device_s = 1, wall * k, dev * k if dev else None
        st.counters = dict(counters)
    return tab


def _ctx(n_obs: int) -> Context:
    return Context(timers=[{}] * n_obs, trace=object(), launches={}, peak=None,
                   peak_mem_bytes=None)


@pytest.fixture
def tables(monkeypatch):
    from peasoup_tpu_torch.utils import trace

    held = []
    monkeypatch.setattr(trace, "run_tables", lambda: list(held))
    return held


def test_each_reader_takes_the_mean_over_the_window_tables(tables):
    # an older run's table, then the window's two
    tables.extend([_table(40.0, (9, 1, 1, 1)), _table(1.0), _table(3.0, (400, 200, 200, 200))])
    assert metrics.load("shard_copy_s").read(_ctx(2)) == pytest.approx(2.0 * 0.5)
    assert metrics.load("shard_feed_s").read(_ctx(2)) == pytest.approx(2.0 * 2.0)
    # 100 x (300 / 250 - 1) = 20, and 100 x (400 / 250 - 1) = 60
    assert metrics.load("shard_row_skew").read(_ctx(2)) == pytest.approx(40.0)


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_reads_nothing_where_there_is_nothing(name, tables):
    from peasoup_tpu_torch.utils.trace import RunTable

    reader = metrics.load(name)
    assert reader.read(Context(timers=[], trace=None, launches={}, peak=None,
                               peak_mem_bytes=None)) is None
    tables.append(_table(1.0))
    assert reader.read(_ctx(2)) is None  # fewer tables than observations
    tables[:] = [RunTable("Search"), RunTable("Search")]  # no span, no counter
    assert reader.read(_ctx(2)) is None


def test_one_shard_has_no_skew(tables):
    tables.append(_table(1.0, (300, 0, 0, 0)))
    assert metrics.load("shard_row_skew").read(_ctx(1)) is None
    tables[:] = [_table(1.0, (300, 300, 0, 0))]
    assert metrics.load("shard_row_skew").read(_ctx(1)) == 0.0
