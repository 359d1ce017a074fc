"""The port stands alone: peasoup_tpu_torch, chip_smoke.py and
ab_grids.py import neither JAX nor the JAX package, and a request for the card where there
is none raises instead of running on the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import peasoup_tpu_torch
from peasoup_tpu_torch.device import resolve_device
from peasoup_tpu_torch.pipeline.search import PeasoupSearch, SearchConfig
from peasoup_tpu_torch.pipeline.single_pulse import SinglePulseConfig, SinglePulseSearch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "peasoup_tpu_torch"


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(
            peasoup_tpu_torch.__path__, prefix="peasoup_tpu_torch."
        )
    )


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert len(mods) > 20
    for name in ("pipeline.search", "pipeline.folder", "ops.fold", "ops.fold_optimise",
                 "ops.resample", "ops.rednoise", "ops.singlepulse",
                 "pipeline.single_pulse", "cli.spsearch", "fdas.templates", "ops.fdas",
                 "pipeline.fdas", "cli.fdas", "io.dada", "io.stream_source",
                 "ops.streaming", "stream.driver", "stream.queue", "stream.triggers",
                 "cli.stream"):
        assert f"peasoup_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'peasoup_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "ab_grids.py",
                                  ROOT / "boxcar_probe.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_source(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "peasoup_tpu", "bench"}


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        PeasoupSearch(SearchConfig())  # the default device is the card
    with pytest.raises(RuntimeError, match="is_available"):
        SinglePulseSearch(SinglePulseConfig())
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("cli", ["ffa", "coincidencer", "accmap", "fdas", "stream"])
def test_smaller_searches_default_to_the_card(monkeypatch, tmp_path, cli):
    # the FFA, coincidencer, accmap, FDAS and streaming entry points run on
    # the card unless asked for the CPU: without one they raise before
    # reading any input
    import importlib

    from peasoup_tpu_torch.pipeline.fdas import FdasConfig, FdasSearch
    from peasoup_tpu_torch.pipeline.ffa import FFAConfig, FFASearch
    from peasoup_tpu_torch.stream import StreamConfig, StreamingSearch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for search, cfg in ((FFASearch, FFAConfig), (FdasSearch, FdasConfig),
                        (StreamingSearch, StreamConfig)):
        with pytest.raises(RuntimeError, match="is_available"):
            search(cfg())
    main = importlib.import_module(f"peasoup_tpu_torch.cli.{cli}").main
    missing = str(tmp_path / "missing.fil")
    argv = {"ffa": ["-i", missing], "coincidencer": [missing], "accmap": [missing],
            "fdas": ["-i", missing], "stream": ["--replay", missing]}[cli]
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)


def test_chip_smoke_fails_without_a_card():
    # with no card visible the script must exit non-zero and print no
    # result line
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_every_kernel_source_is_built_and_notes_what_it_replaces():
    from peasoup_tpu_torch import kernels

    sources = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert sources == sorted(kernels.KERNELS)
    assert set(kernels.launches) == set(kernels.launch_shapes) == set(sources)
    for name in sources:
        text = kernels.source(name).read_text()
        assert "peasoup_tpu/ops/pallas/" in text and "bounds it" in text, name
