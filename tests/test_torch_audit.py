"""The port's static-analysis gate (peasoup_tpu_torch/analysis and
tools/audit.py) against the JAX package's, on the CPU.

- The rules the port keeps as they are (PSA004, PSA006-PSA009, PSP101-
  PSP107) give the JAX package's findings, rule, line, col and message,
  on the JAX package's own fixtures (tests/data/audit) with each relpath
  mapped from ``peasoup_tpu/`` to ``peasoup_tpu_torch/``; suppressions
  and the baseline ratchet behave alike.
- The torch counterparts (PSA001 host syncs in device-code loops, PSA003
  float64 in device code) each flag a positive fixture and pass a
  negative one; the excluded rules are listed with their reasons.
- Seeded faults give their contract ids: an f64 op, a ``.item()``, a
  2 MiB host-to-device copy and an undeclared in-place write (PSC101-
  PSC104), a failing program (PSC105), a program no ladder context
  builds (PSC106); a ``.cu`` with no registry entry (PSK201) and a
  wrapper that falls back to its plain version (PSK202).
- The CLI exits 0, 1 and 2 where it should, its ``--json`` report
  round-trips the port's schema, and ``--list-rules`` shows the
  exclusions. The run over the whole tree is tests/test_torch_mc.py's
  module fixture (it shares that run's model-checking pass).

The JAX package's contract, ladder and kernel engines fail on this tree
(their x64 context is missing from this JAX), so they are no oracle here.
"""

from __future__ import annotations

import json
import re
import shutil
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from peasoup_tpu.analysis import astlint as jax_astlint
from peasoup_tpu.analysis import findings as jax_findings
from peasoup_tpu_torch.analysis import contracts, kernels
from peasoup_tpu_torch.analysis.astlint import lint_source, rule_classes
from peasoup_tpu_torch.analysis.findings import Finding
from peasoup_tpu_torch.analysis.rules import EXCLUDED_RULES
from peasoup_tpu_torch.analysis.runner import AUDIT_SCHEMA_PATH, run_audit, write_report
from peasoup_tpu_torch.obs.schema import validate
from peasoup_tpu_torch.ops.registry import ProgramSpec, registered_programs
from peasoup_tpu_torch.tools.audit import main as audit_main

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = sorted((Path(__file__).parent / "data" / "audit").glob("ps[ap]*.py"))
_PATH_RE = re.compile(r"#\s*audit-path:\s*(\S+)")
# the JAX package's rules the port keeps as they are
KEPT = ("PSA004", "PSA006", "PSA007", "PSA008", "PSA009",
        "PSP101", "PSP102", "PSP103", "PSP104", "PSP105", "PSP106", "PSP107")
# the big grid's search (chip_smoke.py:GRID_CONFIG)
BIG_OVERRIDES = {"dm_end": 20.0, "acc_start": -0.5, "acc_end": 0.5, "acc_pulse_width": 0.064}


def _port_path(relpath: str) -> str:
    assert relpath.startswith("peasoup_tpu/")
    return "peasoup_tpu_torch/" + relpath[len("peasoup_tpu/"):]


def _key(findings):
    return sorted((f.rule, f.line, f.col, f.message) for f in findings)


def _both(source: str, relpath: str, rules=KEPT):
    jax = jax_astlint.lint_source(source, relpath, list(rules))
    port = lint_source(source, _port_path(relpath), list(rules))
    return jax, port


# --------------------------------------------------------------------------
# the kept rules, against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_kept_rules_match_jax_on_its_fixtures(fixture):
    source = fixture.read_text()
    relpath = _PATH_RE.search(source).group(1)
    (jf, jn), (pf, pn) = _both(source, relpath)
    assert _key(pf) == _key(jf)
    assert pn == jn
    rule = fixture.stem[:6].upper()
    if rule in KEPT:
        assert any(f.rule == rule for f in pf), "the fixture's own rule fires"


def test_every_kept_rule_has_a_fixture():
    stems = {p.stem[:6].upper() for p in FIXTURES}
    assert set(KEPT) <= stems
    assert set(KEPT) <= set(rule_classes())


_SUPPRESSION_SRC = "import time\ndef f():\n    t0 = time.time(){comment}\n    return t0\n"


@pytest.mark.parametrize("comment", [
    "  # audit: ignore[PSA006] -- epoch for the lease",  # active
    "  # audit: ignore[PSA006]",  # bare: inactive, reported as PSA000
    "  # audit: ignore[PSA001] -- wrong rule",  # inactive for PSA006
    "",
])
def test_suppressions_behave_as_the_jax_package_s(comment):
    src = _SUPPRESSION_SRC.format(comment=comment)
    (jf, jn), (pf, pn) = _both(src, "peasoup_tpu/obs/x.py")
    assert _key(pf) == _key(jf) and pn == jn


def test_own_line_suppression_covers_the_next_code_line():
    src = ("import time\ndef f():\n    # audit: ignore[PSA006] -- epoch timestamp\n"
           "    t0 = time.time()\n    return t0\n")
    (jf, jn), (pf, pn) = _both(src, "peasoup_tpu/obs/x.py")
    assert not pf and not jf and pn == jn == 1


def _findings(pkg, n, line=7):
    return [pkg.Finding(rule="PSA006", severity="warning", path="p/obs/x.py", line=line + i,
                        col=4, message="m", source_line=f"t{i} = time.time()")
            for i in range(n)]


def test_baseline_ratchet_matches_the_jax_package_s(tmp_path):
    for n_base, n_live in ((2, 2), (2, 1), (1, 3)):
        out = []
        for pkg in (jax_findings, __import__("peasoup_tpu_torch.analysis.findings",
                                             fromlist=["x"])):
            base = pkg.Baseline.from_findings(_findings(pkg, n_base))
            path = str(tmp_path / f"{pkg.__name__}.json")
            base.save(path)
            new, old, resolved = pkg.Baseline.load(path).apply(_findings(pkg, n_live))
            out.append((len(new), len(old), resolved, [f.baselined for f in old]))
        assert out[0] == out[1]
    doc = json.loads(Path(tmp_path / "peasoup_tpu_torch.analysis.findings.json").read_text())
    assert doc["schema"] == "peasoup_tpu_torch.audit_baseline"


# --------------------------------------------------------------------------
# the torch counterparts and the exclusions
# --------------------------------------------------------------------------

_SYNC = textwrap.dedent("""\
    import torch

    def f(xs, dev):
        total = xs[0].sum().item()  # ok: once, outside a loop
        for x in xs:
            n = x.sum().item()  # expect
            rows = x.tolist()  # expect
            host = x.cpu().numpy()  # expect x2
            torch.cuda.synchronize(dev)  # expect
            ys = [y.cpu() for y in xs]  # expect: once an iteration too
        zs = [y.cpu() for y in xs]  # ok: a comprehension alone gathers
        while total:
            total = xs[1].max().item()  # expect
        return total, ys, zs
""")


def test_psa001_flags_host_syncs_in_device_code_loops():
    found, _ = lint_source(_SYNC, "peasoup_tpu_torch/pipeline/x.py", ["PSA001"])
    assert [f.line for f in found] == [6, 7, 8, 8, 9, 10, 13]
    assert {f.rule for f in found} == {"PSA001"}
    # outside the device directories the same code is clean
    assert not lint_source(_SYNC, "peasoup_tpu_torch/tools/x.py", ["PSA001"])[0]
    assert not lint_source(_SYNC, "peasoup_tpu_torch/campaign/x.py", ["PSA001"])[0]


_F64 = textwrap.dedent("""\
    import numpy as np
    import torch

    def f(x):
        a = x.to(torch.float64)  # expect
        b = x.double()  # expect
        c = torch.zeros(3, dtype=torch.complex128)  # expect
        d = np.zeros(3, dtype=np.float64)  # ok: host staging
        e = x.to(torch.float32)  # ok
        return a, b, c, d, e
""")


def test_psa003_flags_float64_in_device_code():
    found, _ = lint_source(_F64, "peasoup_tpu_torch/ops/x.py", ["PSA003"])
    assert [f.line for f in found] == [5, 6, 7]
    assert not lint_source(_F64, "peasoup_tpu_torch/obs/x.py", ["PSA003"])[0]
    assert not lint_source(_F64.replace("torch.float64", "torch.float32").replace(
        "x.double()", "x.float()").replace("complex128", "complex64"),
        "peasoup_tpu_torch/ops/x.py", ["PSA003"])[0]


def test_excluded_rules_are_stated_not_registered(capsys):
    assert set(EXCLUDED_RULES) == {"PSA002", "PSA005", "PSA010"}
    assert set(kernels.EXCLUDED_RULES) == {"PSK204", "PSK205", "PSK206", "PSK207"}
    assert not (set(EXCLUDED_RULES) | set(kernels.EXCLUDED_RULES)) & set(rule_classes())
    assert audit_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule, why in {**EXCLUDED_RULES, **kernels.EXCLUDED_RULES}.items():
        assert f"{rule}  [excluded]  {why}" in out
    for rule in ("PSA001", "PSA003", "PSA009", "PSP107", "PSC106", "PSK208", "complete_vs_claim"):
        assert rule in out


# --------------------------------------------------------------------------
# the contract engine: seeded faults
# --------------------------------------------------------------------------

def _toy(name, fn, make_args, donate=(), param=None):
    return ProgramSpec(name, lambda dev, **kw: (fn, make_args(dev, **kw), {}), param=param,
                       donate=donate)


def _rules(findings):
    return sorted(f.rule for f in findings)


@pytest.mark.parametrize("fault,rule", [
    ("f64", "PSC101"), ("item", "PSC102"), ("h2d", "PSC103"), ("inplace", "PSC104"),
    ("raises", "PSC105"), ("clean", None),
])
def test_seeded_contract_faults_give_their_ids(fault, rule):
    big = np.zeros(2 << 20, np.uint8)  # 2 MiB

    def program(x):
        if fault == "f64":
            return (x.to(torch.float64) * 2).to(torch.float32)
        if fault == "item":
            return x * x.sum().item()
        if fault == "h2d":  # a table rebuilt and sent at every call
            return x.sum() + torch.from_numpy(big).to(x.device).sum()
        if fault == "inplace":
            return x.mul_(2.0)
        if fault == "raises":
            raise RuntimeError("shape drift")
        return x * 2.0

    # "meta" stands for the card: a copy there is a host-to-device copy
    dev = "meta" if fault == "h2d" else "cpu"
    spec = _toy(f"toy.{fault}", program, lambda d: (torch.ones(64, device=dev),))
    found = contracts.audit_program(spec)
    assert _rules(found) == ([rule] if rule else [])
    if fault == "h2d":
        cfg = contracts.ContractConfig(max_const_bytes=4 << 20)
        assert not contracts.audit_program(spec, cfg)


def test_a_table_cached_after_its_first_call_is_no_psc103():
    # the first call's upload fills a cache; a second call sends nothing
    from functools import lru_cache

    @lru_cache(maxsize=2)
    def table(device):
        return torch.from_numpy(np.zeros(1 << 19, np.float32)).to(device)  # 2 MiB

    cached = _toy("toy.cached", lambda x: x.sum() + table(x.device).sum(),
                  lambda d: (torch.ones(8, device="meta"),))
    assert not contracts.audit_program(cached)
    table.cache_clear()
    sent = _toy("toy.sent", lambda x: x.sum() + table.__wrapped__(x.device).sum(),
                lambda d: (torch.ones(8, device="meta"),))
    assert _rules(contracts.audit_program(sent)) == ["PSC103"]


def test_the_matmul_one_hot_made_on_the_device_is_the_jax_package_s():
    # the repair of the audit's PSC103 in ops/dedisperse.py:dedisperse_matmul
    from peasoup_tpu.ops.dedisperse import banded_onehot as jax_onehot
    from peasoup_tpu_torch.ops.dedisperse import banded_onehot

    d = np.random.default_rng(3).integers(0, 300, size=(64, 16))
    band = -(-int((d.max(0) - d.min(0)).max() + 1) // 8) * 8
    jb, jo = jax_onehot(d, band)
    pb, po = banded_onehot(d, band, torch.device("cpu"))
    np.testing.assert_array_equal(pb, np.asarray(jb))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))


def test_donation_declared_and_used_both_ways():
    writes = _toy("toy.donate", lambda x: x.add_(1.0), lambda d: (torch.zeros(8),), donate=(0,))
    assert not contracts.audit_program(writes)
    never = _toy("toy.never", lambda x: x + 1.0, lambda d: (torch.zeros(8),), donate=(0,))
    found = contracts.audit_program(never)
    assert _rules(found) == ["PSC104"] and found[0].severity == "warning"


def test_declared_syncs_pass_and_the_sanctioned_accumulator_is_exempt():
    from peasoup_tpu_torch.ops.spectrum import row_sum

    spec = ProgramSpec("toy.sync", lambda dev: (lambda x: x.sum().item(), (torch.ones(4),), {}),
                       allow_syncs=(("aten::_local_scalar_dense", "reads the total"),))
    assert not contracts.audit_program(spec)
    acc = _toy("toy.rowsum", row_sum, lambda d: (torch.rand(3, 100),))
    assert not contracts.audit_program(acc)
    leak = _toy("toy.leak", lambda x: x.to(torch.float64).sum(dim=-1).to(torch.float32),
                lambda d: (torch.rand(3, 100),))
    assert _rules(contracts.audit_program(leak)) == ["PSC101"]


def test_ladder_coverage_and_rung_tags():
    rungs = contracts.ladder_rungs()
    assert rungs == [49152, 65536]
    assert contracts.ladder_rungs(base_nsamps=2**21 + 8192) == [3 << 20, 1 << 22]

    def make(dev, n=16):
        return (torch.ones(n),)

    hooked = _toy("toy.hooked", lambda x: x.to(torch.float64) if x.numel() > 50000 else x, make,
                  param=lambda ctx: None if ctx.out_nsamps <= 0 else dict(n=ctx.out_nsamps))
    rep = contracts.audit_programs_ladder([hooked], rungs=rungs)
    assert rep.coverage["toy.hooked"] == rungs
    # an f64 leak only past a size threshold shows at the rung that crosses it
    assert [f.path for f in rep.findings] == ["ops-registry/toy.hooked@nsamps=65536"]
    assert _rules(rep.findings) == ["PSC101"]
    bare = _toy("toy.bare", lambda x: x, make)
    assert _rules(contracts.audit_programs_ladder([bare], rungs=rungs).findings) == ["PSC106"]
    raising = _toy("toy.raising", lambda x: x, make, param=lambda ctx: 1 / 0)
    got = _rules(contracts.audit_programs_ladder([raising], rungs=rungs).findings)
    assert got == ["PSC105", "PSC105", "PSC106"]


def test_every_registered_program_has_a_hook_at_every_default_rung():
    specs = registered_programs()
    assert len(specs) == 42 and sum(bool(s.kernel) for s in specs) == 9
    rungs = contracts.ladder_rungs()
    for spec in specs:
        assert [r for r, _ in contracts.ladder_builds(spec.param, rungs)] == rungs, spec.name
    # the big grid's bucket at full width: the rungs its jobs bucket to
    big = contracts.ladder_rungs(base_nsamps=2**21 + 8192)
    bucket = (64, 2, 6.4e-05, 1500.0, -300.0 / 64)
    for spec in specs:
        got = contracts.ladder_builds(spec.param, big, BIG_OVERRIDES, bucket)
        assert [r for r, _ in got] == big, spec.name


def test_the_card_leg_takes_the_bucket_s_own_rows():
    # the contract ladder caps a build's rows at 4; the kernel engine's card
    # leg launches at the big grid's own 77 DM trials and 616 resampled rows
    from peasoup_tpu_torch.ops.registry import _KERNEL_BUILDS

    big = contracts.ladder_rungs(base_nsamps=2**21 + 8192)
    bucket = (64, 2, 6.4e-05, 1500.0, -300.0 / 64)

    def rows(name, **kw):
        got = contracts.ladder_builds(_KERNEL_BUILDS[name][1], big, BIG_OVERRIDES, bucket, **kw)
        return {s.get("rows", s.get("ndm")) for _, s in got}

    for name in ("dedisperse", "specchain", "peaks", "boxcar", "spchain"):
        assert rows(name, ladder_rows=0) == {77}, name
    assert rows("spchain") == {4} and rows("dedisperse") == {16}  # 16: a host segment's
    assert rows("resample", ladder_rows=0) == {616}
    fn, args, kw = _KERNEL_BUILDS["boxcar"][0](torch.device("cpu"), nsamps=2048, rows=3)
    assert fn(*args, **kw)[0].shape[0] == 3


# --------------------------------------------------------------------------
# the kernel engine
# --------------------------------------------------------------------------

def test_kernel_engine_on_the_cpu_is_clean_and_leaves_the_card_leg_unattempted():
    rep = kernels.audit_kernels(device="cpu")
    assert not rep.findings, [f.render() for f in rep.findings]
    assert rep.kernels == sorted(kernels.KERNEL_WRAPPERS)
    for check in rep.checks.values():
        assert check["card"] == kernels.CARD_NOT_ATTEMPTED
        assert check["launches"] == 0 and check["matched"] == 0


def test_unregistered_source_is_psk201(tmp_path):
    from peasoup_tpu_torch import kernels as port_kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(port_kernels.CSRC, csrc)
    (csrc / "newkernel.cu").write_text('extern "C" int newkernel() { return 0; }\n')
    assert kernels.unregistered_kernels(csrc) == [("newkernel", "csrc/newkernel.cu")]
    entries = dict(port_kernels._ENTRIES, other=("other", []))
    rep = kernels.audit_kernels(names=[], csrc_dir=csrc, entries=entries)
    assert sorted((f.rule, f.path) for f in rep.findings) == [
        ("PSK201", "kernel-registry/newkernel"), ("PSK201", "kernel-registry/other")]


def _fake_module(tmp_path, monkeypatch, body):
    mod = tmp_path / "fake_kernel_mod.py"
    mod.write_text(textwrap.dedent(body))
    monkeypatch.syspath_prepend(str(tmp_path))
    import importlib

    return importlib.import_module("fake_kernel_mod")


def test_a_wrapper_with_a_fallback_is_psk202(tmp_path, monkeypatch):
    mod = _fake_module(tmp_path, monkeypatch, """
        import torch

        def plain(x):
            return x * 2

        def honest(x):
            if x.device.type == "cpu":
                return plain(x)
            raise RuntimeError("launch")

        def on_error(x):
            try:
                raise RuntimeError("launch")
            except RuntimeError:
                return plain(x)

        def no_card(x):
            if not torch.cuda.is_available():
                return plain(x)
            raise RuntimeError("launch")
    """)
    builds = {name: (lambda dev, f=getattr(mod, name): (f, (torch.ones(3),), {}), None)
              for name in ("honest", "on_error", "no_card")}
    wrappers = {name: ("fake_kernel_mod", name, "plain") for name in builds}
    assert not kernels.check_wrapper("honest", wrappers, builds)
    for name in ("on_error", "no_card"):
        found = kernels.check_wrapper(name, wrappers, builds)
        assert _rules(found) == ["PSK202"], name
        assert "falls back" in found[0].message
    # an entry that builds something else, and a missing plain version
    drift = {"honest": (lambda dev: (mod.plain, (torch.ones(3),), {}), None)}
    assert _rules(kernels.check_wrapper("honest", wrappers, drift)) == ["PSK202"]
    gone = {"honest": ("fake_kernel_mod", "honest", "deleted_plain")}
    assert _rules(kernels.check_wrapper("honest", gone, builds)) == ["PSK202"]


def test_the_real_wrappers_have_no_fallback():
    import importlib

    for name, (modname, wname, pname) in kernels.KERNEL_WRAPPERS.items():
        fn = getattr(importlib.import_module(modname), wname)
        assert kernels.fallback_sites(fn, pname) == [], name


def test_card_leg_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernels.audit_kernels(device="cuda")


# --------------------------------------------------------------------------
# the runner and the CLI
# --------------------------------------------------------------------------

def _tree(tmp_path, body="import logging\nlog = logging.getLogger(__name__)\n"):
    pkg = tmp_path / "peasoup_tpu_torch" / "obs"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text(body)
    return tmp_path


_LIGHT = ["--device", "cpu", "--no-contracts", "--no-kernels", "--no-mc"]


def test_cli_exit_codes(tmp_path, capsys):
    clean = _tree(tmp_path / "a")
    assert audit_main(["--root", str(clean), *_LIGHT]) == 0
    dirty = _tree(tmp_path / "b", "import time\n\ndef f():\n    t0 = time.time()\n    return t0\n")
    assert audit_main(["--root", str(dirty), *_LIGHT]) == 1
    assert "PSA006" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert audit_main(["--root", str(clean), *_LIGHT, "--baseline", str(bad)]) == 2
    assert audit_main(["--root", str(clean), *_LIGHT, "--rules", "PSA999"]) == 2


def test_cli_on_the_card_raises_without_one(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert audit_main(["--root", str(_tree(tmp_path)), "--no-mc"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_baseline_ratchet_and_strict_resolved(tmp_path, capsys):
    root = _tree(tmp_path, "import time\n\ndef f():\n    t0 = time.time()\n    return t0\n")
    base = str(tmp_path / "base.json")
    assert audit_main(["--root", str(root), *_LIGHT, "--baseline", base,
                       "--write-baseline"]) == 0
    assert audit_main(["--root", str(root), *_LIGHT, "--baseline", base]) == 0
    (root / "peasoup_tpu_torch" / "obs" / "x.py").write_text("x = 1\n")
    assert audit_main(["--root", str(root), *_LIGHT, "--baseline", base]) == 0
    assert audit_main(["--root", str(root), *_LIGHT, "--baseline", base,
                       "--strict-resolved"]) == 1
    assert "no longer match" in capsys.readouterr().out


def test_json_report_round_trips_the_port_schema(tmp_path):
    out = tmp_path / "audit.json"
    root = _tree(tmp_path)
    assert audit_main(["--root", str(root), "--device", "cpu", "--no-contracts", "--no-mc",
                       "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    validate(doc, json.loads(Path(AUDIT_SCHEMA_PATH).read_text()))
    assert doc["schema"] == "peasoup_tpu_torch.audit" and doc["device"] == "cpu"
    assert set(doc["kernel_checks"]) == set(kernels.KERNEL_WRAPPERS)
    # a report the schema refuses is never written
    result = run_audit(str(root), contracts=False, kernels=False)
    result.findings.append(Finding("PSA006", "fatal", "x", 1, 0, "m"))
    with pytest.raises(Exception):
        write_report(result, str(tmp_path / "refused.json"))
    assert not (tmp_path / "refused.json").exists()


def test_engine_toggles_silence_their_rules(tmp_path):
    src = ("import os, json\n\ndef save(d):\n"
           "    with open(os.path.join('queue', 'status.json'), 'w') as f:\n"
           "        json.dump(d, f)\n")
    root = _tree(tmp_path, src)
    on = {f.rule for f in run_audit(str(root), contracts=False, kernels=False).findings}
    off = {f.rule for f in run_audit(str(root), contracts=False, kernels=False,
                                     protocol=False).findings}
    assert "PSP101" in on and "PSA008" in on
    assert "PSP101" not in off and "PSA008" in off
