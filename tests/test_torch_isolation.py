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
                 "cli.stream", "resilience.policy", "tools.parsers", "campaign.db",
                 "sift.crossmatch", "sift.dedup", "sift.repeats", "ops.survey_fold",
                 "sift.fold", "sift.service", "sift.report", "obs.schema",
                 "ops.candidate_features", "rank.model", "rank.score", "rank.train",
                 "cli.sift", "cli.rank", "parallel.mesh", "parallel.multihost",
                 "parallel.sharded_dedisperse", "parallel.sharded_search",
                 "parallel.coincidence", "parallel.distributed_fft",
                 "resilience.errors", "plan.dedisp_plan", "campaign.buckets",
                 "perf.measure", "perf.tuning", "perf.roofline", "perf.warmup",
                 "perf.microbench", "perf.ratchet", "ops.registry", "tools.perf",
                 "resilience.stats", "resilience.faults", "resilience.revoke",
                 "obs.log", "obs.telemetry", "obs.trace", "obs.heartbeat", "obs.flight",
                 "obs.metrics", "obs.profiler", "tools.scope_trace",
                 "tools.validate_manifest", "campaign.queue", "campaign.registry",
                 "campaign.tenants", "campaign.usage", "campaign.rollup",
                 "campaign.autoscale", "campaign.ingest", "campaign.runner",
                 "obs.alerts", "obs.health", "obs.portal", "tools.watch",
                 "cli.campaign", "utils", "utils.progress", "utils.trace",
                 "utils.debug", "tools.chaos", "tools.plotting", "tools.report",
                 "tools.as_text", "tools.recall", "tools.divergence", "tools.tie_mc",
                 "analysis", "analysis.findings", "analysis.astlint", "analysis.rules",
                 "analysis.protocol", "analysis.contracts", "analysis.kernels",
                 "analysis.runner", "analysis.mc", "analysis.mc.vfs",
                 "analysis.mc.scheduler", "analysis.mc.explorer", "analysis.mc.invariants",
                 "analysis.mc.crash", "analysis.mc.scenarios", "tools.audit"):
        assert f"peasoup_tpu_torch.{name}" in mods
    # the JAX package's utils/cache.py has no counterpart: it wires XLA's
    # persistent compilation cache, and the port compiles nothing per
    # shape (each kernel library is built once per source hash)
    assert "peasoup_tpu_torch.utils.cache" not in mods
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
                                  ROOT / "boxcar_probe.py", ROOT / "dedisp_probe.py"],
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


@pytest.mark.parametrize("cli", ["ffa", "coincidencer", "accmap", "fdas", "stream",
                                 "sift", "rank", "campaign"])
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
            "fdas": ["-i", missing], "stream": ["--replay", missing],
            "sift": ["run", "-w", str(tmp_path)], "rank": ["score", "-w", str(tmp_path)],
            "campaign": ["run", "-w", str(tmp_path), "--manifest", missing]}[cli]
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv)


@pytest.mark.parametrize("entry", ["multibeam_veto", "run_search", "run_single_pulse_search",
                                   "run_fdas_search", "resolve_plan_for_bucket",
                                   "warm_registry", "run_microbench", "CampaignRunner",
                                   "run_worker"])
def test_library_entry_points_default_to_the_card(monkeypatch, entry):
    # the sift's multibeam veto, the multi-process drivers and the tuning
    # and measurement layer run on the card unless asked for the CPU:
    # without one they raise before any work
    from peasoup_tpu_torch.campaign import runner
    from peasoup_tpu_torch.parallel import multihost
    from peasoup_tpu_torch.perf import microbench, tuning, warmup
    from peasoup_tpu_torch.pipeline.fdas import FdasConfig
    from peasoup_tpu_torch.sift.dedup import multibeam_veto

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "multibeam_veto": lambda: multibeam_veto([]),
        "run_search": lambda: multihost.run_search(None, SearchConfig()),
        "run_single_pulse_search": lambda: multihost.run_single_pulse_search(
            None, SinglePulseConfig()),
        "run_fdas_search": lambda: multihost.run_fdas_search(None, FdasConfig()),
        "resolve_plan_for_bucket": lambda: tuning.resolve_plan_for_bucket(
            (16, 8, 1024, 1e-3, 1400.0, -8.0), "search", {}, "unused.json"),
        "warm_registry": lambda: warmup.warm_registry(),
        "run_microbench": lambda: microbench.run_microbench(),
        "CampaignRunner": lambda: runner.CampaignRunner("unused"),
        "run_worker": lambda: runner.run_worker("unused"),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()


def _code_strings(path: Path) -> list[str]:
    """The string constants of a source file, docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_no_data_path_into_the_jax_package():
    # the import check alone would let a data file (the known-pulsar
    # catalogue, the rank model, a schema) be read from the JAX package's
    # folder: no string of the port's code names a path there, and loading
    # every data file the port ships opens nothing under it
    for path in sorted(PORT.rglob("*.py")):
        for text in _code_strings(path):
            parts = {p for p in text.replace("\\", "/").split("/")}
            assert "peasoup_tpu" not in parts, (path, text)
    code = (
        "import sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' else None)\n"
        "from peasoup_tpu_torch.sift.crossmatch import load_catalogue\n"
        "from peasoup_tpu_torch.rank.model import RankModel\n"
        "from peasoup_tpu_torch.sift import report\n"
        "from peasoup_tpu_torch.obs.schema import SchemaError\n"
        "from peasoup_tpu_torch.perf import microbench, ratchet, tuning\n"
        "from peasoup_tpu_torch.analysis import findings, runner\n"
        "findings.Baseline.load(runner.AUDIT_SCHEMA_PATH.replace('audit.schema.json', "
        "'audit_baseline.json')); open(runner.AUDIT_SCHEMA_PATH).close()\n"

        "load_catalogue(); RankModel.from_file()\n"
        "tuning.validate_cache(tuning._empty_cache()); ratchet.load_baseline(ratchet.BASELINE_PATH)\n"
        "for check in (report.validate_report, microbench.validate_perf):\n"
        "    try:\n"
        "        check({})\n"
        "    except SchemaError:\n"
        "        pass\n"
        "print('\\n'.join(opened))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    opened = [Path(p).resolve() for p in out.stdout.split() if p.endswith(".json")]
    assert {p.name for p in opened} >= {"known_pulsars.json", "model.json",
                                        "model.schema.json", "report.schema.json",
                                        "tuning_cache.schema.json", "perf.schema.json",
                                        "perf_baseline.json", "audit.schema.json",
                                        "audit_baseline.json"}
    for p in opened:
        assert PORT.resolve() in p.parents, p


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
