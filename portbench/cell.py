"""A cell of ``BENCHMARK.json`` and the files it names, loaded by name.

A cell (one entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file of its own under ``configs/`` and ``traffic/``,
so a later cell adds files and entries and edits none.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: list  # the cell's end-to-end metrics (BENCHMARK.json entries)
    per_layer: list  # the cell's per-layer metrics

    @property
    def header(self) -> dict:
        return self.config["header"]


def _for_cell(metrics: list, name: str, e2e_names: set | None = None) -> list:
    """The metrics that name this cell, or name no cells and move an
    end-to-end metric that the cell reports."""
    out = []
    for m in metrics:
        cells = m.get("workloads")
        if cells is not None:
            if name in cells:
                out.append(m)
        elif e2e_names is None or m.get("moves") in e2e_names:
            out.append(m)
    return out


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration and mix
    read from the files named after them."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = _for_cell(bench["end_to_end"], name)
    per_layer = _for_cell(bench["per_layer"], name, {m["name"] for m in e2e})
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def killmask(config: dict) -> np.ndarray | None:
    """1 for each channel the survey keeps, 0 for each it kills (the
    configuration's ``killed`` ranges [first, stop) of channel indices,
    channel 0 at ``fch1``), or None where it kills none."""
    killed = config.get("killed") or []
    if not killed:
        return None
    keep = np.ones(int(config["header"]["nchans"]), dtype=np.int32)
    for first, stop in killed:
        keep[int(first) : int(stop)] = 0
    return keep
