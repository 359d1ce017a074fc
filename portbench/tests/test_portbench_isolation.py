"""No module that portbench or a run imports has the top-level name of
JAX or the JAX package; the names are compared whole, so the port
(``peasoup_tpu_torch``) passes."""

import subprocess
import sys

from portbench.cell import ROOT
from portbench.run import FORBIDDEN, forbidden_modules


def test_names_are_compared_whole(monkeypatch):
    fake = {"peasoup_tpu_torch": object(), "peasoup_tpu_torch.ops": object(),
            "jaxtyping_like": object()}
    monkeypatch.setattr(sys, "modules", fake)
    assert forbidden_modules() == []
    fake["peasoup_tpu.ops"] = object()
    fake["jax"] = object()
    assert forbidden_modules() == ["jax", "peasoup_tpu"]


def test_a_run_and_every_portbench_module_load_none_of_them():
    """In a fresh process: import every module of portbench, then drive a
    tiny run on the CPU, and look at sys.modules."""
    code = f"""
import importlib, pkgutil, sys, time, torch
import portbench
for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from portbench.cell import Cell
from portbench.tests.conftest import TINY_CONFIG, TINY_TRAFFIC, E2E
from portbench.run import run_cell, forbidden_modules
cell = Cell("tiny", 1, TINY_CONFIG, TINY_TRAFFIC, E2E, [])
res = run_cell(cell, 3, 0.1, False, torch.device("cpu"), time.perf_counter())
assert res["correct"], res["checks"]
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({FORBIDDEN!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "htru_hilat.accel", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT)},
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
