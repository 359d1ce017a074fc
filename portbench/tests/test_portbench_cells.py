"""Every configuration, traffic mix, metric reader and kernel count that
BENCHMARK.json names loads by its name, and the file keeps to the
benchmark's contract where a test can see it."""

import json
import re

import pytest

from portbench import metrics, roofline
from portbench.cell import BENCHMARK, ROOT, benchmark, load_cell
from portbench.reference.check import NUMBERS
from portbench.run import Context

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_the_file_has_the_contracts_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCHMARK.stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_loads_its_configuration_and_mix_by_name(name):
    cell = load_cell(name)
    h = cell.header
    assert {"nchans", "fch1", "foff", "tsamp", "nbits", "nsamps"} <= set(h)
    assert set(cell.traffic["limits"]) == set(NUMBERS)
    assert {"top", "sample", "box_dm", "family_tol"} <= set(cell.traffic["check"])
    assert cell.traffic["search"]["dm_end"] <= cell.config["dm_max"]
    assert {m["name"] for m in cell.end_to_end} == {"obs_s", "setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_configuration_file_lists_its_cuts_and_assumptions(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/configs/")
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert cfg["assumed"] and cfg["source"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    reader = metrics.load(metric["name"])
    empty = Context(timers=[], trace=None, launches={}, peak=None, peak_mem_bytes=None)
    assert reader.read(empty) is None


def test_every_roofline_metric_names_a_kernel_with_a_count():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["name"][: -len("_roofline")] in roofline.kernels()
