"""A cell runs on as many cards as its ``chips`` says and reports the cards
it used: the trace reduced card by card, the card report read from each
card's allocator peak, a run that did work on fewer cards than it asks
for refused, and the search sharded over the cell's cards."""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import run
from portbench.trace import OBS_SPAN, WINDOW_SPAN, reduce_events

H100 = "NVIDIA H100 80GB HBM3"


class _Events:
    """FunctionEvents as ``reduce_events`` reads them, times in us."""

    def __init__(self):
        self.events = []

    def cpu(self, name, start, end):
        self.events.append(SimpleNamespace(
            id=len(self.events) + 1, name=name, device_type=DeviceType.CPU, cpu_parent=None,
            time_range=SimpleNamespace(start=start, end=end)))

    def kernel(self, name, start, end, card=0):
        self.events.append(SimpleNamespace(
            id=len(self.events) + 1, name=name, device_type=DeviceType.CUDA, device_index=card,
            linked_correlation_id=0, is_user_annotation=False,
            time_range=SimpleNamespace(start=start, end=end)))


def _window(ev):
    ev.cpu(WINDOW_SPAN, 100.0, 1100.0)
    ev.cpu(OBS_SPAN, 100.0, 1100.0)
    ev.cpu("Dedisperse", 150.0, 400.0)
    ev.cpu("DM-Loop", 400.0, 900.0)


def test_one_card_reads_what_one_pooled_union_read():
    """The parent's numbers, worked out by hand: one union of every
    interval, clipped to the window, and its gaps named by the host."""
    ev = _Events()
    _window(ev)
    ev.kernel("Memcpy HtoD", 50.0, 120.0)  # starts before the window
    ev.kernel("dedisperse_kernel", 300.0, 350.0)
    ev.kernel("sortKV", 320.0, 380.0)  # overlaps the one before
    ev.kernel("harm_mask", 500.0, 700.0)
    ev.kernel("Memcpy DtoH", 1000.0, 1200.0)  # ends after the window
    red = reduce_events(ev.events, {"dedisperse": ("dedisperse_kernel",)})
    assert red.window_s == 1000.0 / 1e6
    assert red.busy_s == (20.0 + 80.0 + 200.0 + 100.0) / 1e6
    assert red.by_name == {"Memcpy HtoD": 70.0 / 1e6, "dedisperse_kernel": 50.0 / 1e6,
                           "sortKV": 60.0 / 1e6, "harm_mask": 200.0 / 1e6,
                           "Memcpy DtoH": 200.0 / 1e6}
    assert red.port_seconds == {"dedisperse": 50.0 / 1e6}
    assert red.port_held == {"dedisperse": 1}
    # gaps 120-300 (in Dedisperse), 380-500 and 700-1000 (in DM-Loop)
    assert red.idle_by_host == {"Dedisperse": 180.0 / 1e6, "DM-Loop": 120.0 / 1e6 + 300.0 / 1e6}
    assert red.card_means() == {"busy_s": red.busy_s, "window_s": red.window_s}
    assert dataclasses.asdict(reduce_events(ev.events, {"dedisperse": ("dedisperse_kernel",)},
                                            cards=1)) == dataclasses.asdict(red)


def test_two_cards_sum_each_cards_union_and_count_the_window_twice():
    ev = _Events()
    _window(ev)
    # card 0: 200-600 and 500-800 overlap (600 us busy); card 1: 300-600 (300 us)
    ev.kernel("dedisperse_kernel", 200.0, 600.0, card=0)
    ev.kernel("harm_mask", 500.0, 800.0, card=0)
    ev.kernel("dedisperse_kernel", 300.0, 600.0, card=1)
    red = reduce_events(ev.events, {}, cards=2)
    assert red.window_s == 2 * 1000.0 / 1e6
    assert red.busy_s == pytest.approx((600.0 + 300.0) / 1e6)
    assert red.by_name["dedisperse_kernel"] == pytest.approx(700.0 / 1e6)
    assert sum(red.idle_by_host.values()) == pytest.approx((2000.0 - 900.0) / 1e6)
    # pooled, the two cards' work would read as one card busy 600 us of 1000
    assert 1 - red.busy_s / red.window_s == pytest.approx(0.55)
    # the result line's: a card's mean busy seconds over the window's length
    assert red.card_means() == pytest.approx({"busy_s": 450.0 / 1e6, "window_s": 1000.0 / 1e6})


def test_a_card_of_the_cell_with_no_work_is_idle_throughout():
    ev = _Events()
    _window(ev)
    ev.kernel("harm_mask", 200.0, 700.0, card=0)
    red = reduce_events(ev.events, {}, cards=4)
    assert red.window_s == 4 * 1000.0 / 1e6
    assert red.busy_s == pytest.approx(500.0 / 1e6)
    assert sum(red.idle_by_host.values()) == pytest.approx(3500.0 / 1e6)
    assert red.card_means() == pytest.approx({"busy_s": 125.0 / 1e6, "window_s": 1000.0 / 1e6})


def _card(i, peak, limit=700.0, name=H100):
    return {"index": i, "name": name, "peak_bytes": peak, "power_limit_w": limit}


def test_the_card_report_counts_the_cards_that_did_work():
    cards = [_card(0, 5 << 30, 700.0), _card(1, 7 << 30, 650.0), _card(2, 0, None),
             _card(3, 6 << 30, 690.0)]
    dev, used = run.card_report(cards)
    assert dev == {"platform": "gpu", "kind": H100, "count": 3, "memory_peak_bytes": 7 << 30,
                   "power_limit_w": 650.0}
    assert [c["index"] for c in used] == [0, 1, 3]


def test_the_card_report_of_one_card_has_the_one_card_keys():
    dev, used = run.card_report([_card(0, 123456789)])
    assert list(dev) == ["platform", "kind", "count", "memory_peak_bytes", "power_limit_w"]
    assert dev == {"platform": "gpu", "kind": H100, "count": 1, "memory_peak_bytes": 123456789,
                   "power_limit_w": 700.0}
    dev, _ = run.card_report([_card(0, 123456789, None)])
    assert "power_limit_w" not in dev


def test_the_card_report_refuses_cards_of_different_kinds():
    with pytest.raises(ValueError, match="differ"):
        run.card_report([_card(0, 1), _card(1, 1, name="NVIDIA A100-SXM4-80GB")])
    # a card that did no work does not count, whatever its kind
    assert run.card_report([_card(0, 1), _card(1, 0, name="NVIDIA A100-SXM4-80GB")])[0]["count"] == 1


def _four_card_main(monkeypatch, tiny_cell, peaks):
    """``main`` on a cell of four chips with four cards visible: the tiny
    cell run on the CPU (its search in four shards), the cards read from
    ``peaks``, each card's allocator peak after the window."""
    tiny_cell.chips = 4
    calls = {}
    monkeypatch.setattr(run, "load_cell", lambda name: tiny_cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: peaks[i])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: H100)
    monkeypatch.setattr("portbench.peaks.power_limit_w", lambda i: 700.0 - i)
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    real_run_cell = run.run_cell

    def run_cell(cell, seed, seconds, trace, device, t0):
        calls["device"] = device
        res = real_run_cell(cell, seed, seconds, trace, torch.device("cpu"), t0)
        res["device"], res["info"]["cards"] = run.card_report(run.read_cards())
        return res

    monkeypatch.setattr(run, "run_cell", run_cell)
    rc = run.main(["--workload", "tiny", "--seed", str(2**31 + 5), "--seconds", "0.1"])
    assert calls["device"] == torch.device("cuda", 0)
    return rc


def test_a_run_that_works_on_fewer_cards_than_its_cell_asks_exits_5(monkeypatch, tiny_cell,
                                                                    capsys):
    rc = _four_card_main(monkeypatch, tiny_cell, {0: 3 << 30, 1: 2 << 30, 2: 0, 3: 0})
    out, err = capsys.readouterr()
    assert rc == 5
    assert out.strip() == ""
    assert "asks for 4 cards and did work on 2" in err


def test_a_run_that_works_on_all_its_cards_prints_them(monkeypatch, tiny_cell, capsys):
    rc = _four_card_main(monkeypatch, tiny_cell, {0: 3 << 30, 1: 2 << 30, 2: 4 << 30, 3: 1})
    out, _ = capsys.readouterr()
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"] == {"platform": "gpu", "kind": H100, "count": 4,
                             "memory_peak_bytes": 4 << 30, "power_limit_w": 697.0}
    assert [c["index"] for c in res["info"]["cards"]] == [0, 1, 2, 3]


def test_the_cells_cards_are_its_chips_from_the_first(tiny_cell):
    tiny_cell.chips = 4
    assert run.cell_cards(tiny_cell, torch.device("cuda", 0)) == [
        torch.device("cuda", i) for i in range(4)]
    assert run.cell_cards(tiny_cell, torch.device("cpu")) == [torch.device("cpu")]


def test_the_wait_is_on_every_card_of_the_cell(monkeypatch, tiny_cell):
    tiny_cell.chips = 4
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    run._sync(run.cell_cards(tiny_cell, torch.device("cuda", 0)))
    assert waited == [torch.device("cuda", i) for i in range(4)]
    run._sync(run.cell_cards(tiny_cell, torch.device("cpu")))
    assert len(waited) == 4


def test_the_search_shards_over_the_cells_chips(tiny_cell, tmp_path):
    from peasoup_tpu_torch.pipeline.search import SearchConfig

    one = run.search_config(tiny_cell, tmp_path)
    assert one == SearchConfig(zapfilename=one.zapfilename, killfilename="",
                               **tiny_cell.traffic["search"])
    assert one.shard_devices == 0
    tiny_cell.chips = 4
    four = run.search_config(tiny_cell, tmp_path)
    assert four.shard_devices == 4
    assert dataclasses.replace(four, shard_devices=0) == one


def test_a_traffic_that_shards_the_search_itself_is_refused(tiny_cell, tmp_path):
    for chips in (1, 4):
        tiny_cell.chips = chips
        tiny_cell.traffic["search"]["shard_devices"] = 2
        with pytest.raises(ValueError, match="shard_devices"):
            run.search_config(tiny_cell, tmp_path)

