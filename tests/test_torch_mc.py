"""The port's protocol model checker (peasoup_tpu_torch/analysis/mc)
against the JAX package's, and the audit's run over the whole tree.

- The same op sequences through both virtual filesystems leave the same
  state, and a toy race explores to the same schedule count and replays
  to the same trace in both packages.
- Every scenario of the port's library passes at the default budget over
  the port's queue, registry, tenants and alerts (the whole-tree audit's
  model-checking pass, shared through a module fixture).
- ``complete_vs_claim`` (PSM301) finds the race of the JAX package's
  ``complete`` order (take the claim, then link the done record),
  seeded onto the port's queue by a monkeypatch, with a schedule that
  replays bit for bit; with the port's order it is clean.
- ``python -m peasoup_tpu_torch.tools.audit --device cpu --baseline
  peasoup_tpu_torch/analysis/audit_baseline.json`` exits 0 on the tree.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from peasoup_tpu.analysis.mc import explorer as jax_explorer
from peasoup_tpu.analysis.mc import invariants as jax_invariants
from peasoup_tpu.analysis.mc import vfs as jax_vfs
from peasoup_tpu_torch.analysis.mc import explorer, invariants, vfs
from peasoup_tpu_torch.analysis.mc.scenarios import (
    jax_order_complete,
    run_mc,
    scenario_names,
    scenarios,
)
from peasoup_tpu_torch.analysis.runner import AUDIT_SCHEMA_PATH
from peasoup_tpu_torch.campaign import queue as qmod
from peasoup_tpu_torch.obs.schema import validate

ROOT = Path(__file__).resolve().parents[1]
BASELINE = "peasoup_tpu_torch/analysis/audit_baseline.json"


@pytest.fixture(scope="module")
def whole_tree(tmp_path_factory):
    """The CLI over the whole tree on the CPU: (exit code, output, report)."""
    out = tmp_path_factory.mktemp("audit") / "audit.json"
    proc = subprocess.run(
        [sys.executable, "-m", "peasoup_tpu_torch.tools.audit", "--device", "cpu",
         "--baseline", BASELINE, "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    report = json.loads(out.read_text()) if out.exists() else None
    return proc.returncode, proc.stdout + proc.stderr, report


def test_the_whole_tree_is_clean_against_the_port_baseline(whole_tree):
    rc, output, report = whole_tree
    assert rc == 0, output
    validate(report, json.loads(Path(AUDIT_SCHEMA_PATH).read_text()))
    assert report["summary"]["new"] == 0 and report["summary"]["baselined"] == 0
    assert json.loads((ROOT / BASELINE).read_text())["fingerprints"] == {}
    # the package and the two scripts at the root
    n_files = len(list((ROOT / "peasoup_tpu_torch").rglob("*.py")))
    assert report["summary"]["files_scanned"] == n_files + 2


def test_every_program_is_audited_at_two_rungs_and_no_kernel_claims_the_card(whole_tree):
    _, _, report = whole_tree
    assert len(report["programs"]) == 42
    cov = report["ladder"]["coverage"]
    assert set(cov) == set(report["programs"])
    assert all(len(r) >= 2 for r in cov.values()), cov
    assert len(report["kernel_checks"]) == 9
    for check in report["kernel_checks"].values():
        assert check["card"] == "not attempted (cpu)" and check["launches"] == 0


def test_every_scenario_passes_at_the_default_budget(whole_tree):
    _, _, report = whole_tree
    mc = report["mc"]
    assert [p["name"] for p in mc["per_scenario"]] == scenario_names()
    assert len(scenario_names()) == 15 and "complete_vs_claim" in scenario_names()
    assert mc["violations"] == 0
    assert all(p["violations"] == 0 for p in mc["per_scenario"])
    assert mc["schedules"] > 3000 and mc["crash_points"] > 40


# --------------------------------------------------------------------------
# the virtual filesystem and the explorer, against the JAX package's
# --------------------------------------------------------------------------

def _ops(env):
    """One op sequence over the VFS's seams: O_EXCL create, buffered
    write, tmp + replace, link (twice), rename, unlink, fsync and a host
    crash."""
    flags = env.os.O_CREAT | env.os.O_EXCL | env.os.O_WRONLY
    fd = env.os.open("/camp/queue/claims/j1.json", flags)
    with env.os.fdopen(fd, "w") as f:
        f.write('{"worker_id": "w1"}')
    try:
        env.os.open("/camp/queue/claims/j1.json", flags)
    except FileExistsError:
        pass
    fd, tmp = env.tempfile.mkstemp(dir="/camp/queue/done", suffix=".tmp")
    with env.os.fdopen(fd, "w") as f:
        f.write('{"job_id": "j1"}')
        f.flush()
        env.os.fsync(f.fileno())
    env.os.link(tmp, "/camp/queue/done/j1.json")
    try:
        env.os.link(tmp, "/camp/queue/done/j1.json")
    except FileExistsError:
        pass
    env.os.unlink(tmp)
    f = env.open("/camp/status.json.tmp", "w")
    f.write('{"n": 1}')
    f.close()
    env.os.replace("/camp/status.json.tmp", "/camp/status.json")
    env.os.rename("/camp/queue/claims/j1.json", "/camp/queue/claims/j1.json.release.x")
    env.fs.host_crash()
    return env


def _state(env):
    return ({p: (f.content, f.durable) for p, f in env.fs.files.items()}, env.state_hash(),
            env.fs.listdir("/camp/queue"))


def test_both_virtual_filesystems_reach_the_same_state():
    assert _state(_ops(vfs.MCEnv())) == _state(_ops(jax_vfs.MCEnv()))


def _counter(pkg_explorer, pkg_invariants):
    path = "/camp/queue/counter.json"

    def setup(ctx):
        vf = ctx.env.fs.create(path, ctx.env.clock, excl=True)
        ctx.env.fs.publish(vf, json.dumps({"n": 0}), ctx.env.clock)

    def bump(name):
        def body(ctx):
            doc = json.loads(ctx.env.open(path).read())
            f = ctx.env.open(f"{path}.tmp.{name}", "w")
            f.write(json.dumps({"n": doc["n"] + 1}))
            f.close()
            ctx.env.os.replace(f"{path}.tmp.{name}", path)
        return body

    def invariant(ctx):
        n = (ctx.read_json(path) or {}).get("n")
        pkg_invariants.require(n == 2, f"lost update: n={n} after two increments")

    return pkg_explorer.Scenario(
        name="seeded_lost_update", rule="PSM301", module="tests/test_torch_mc.py",
        description="unsynchronized read-modify-write of one doc", setup=setup,
        tasks=(("w1", bump("w1"), False), ("w2", bump("w2"), False)),
        invariant=invariant, max_kills=0)


@pytest.mark.parametrize("por", [True, False])
def test_a_toy_race_explores_and_replays_as_in_the_jax_package(por):
    got = []
    for ex, inv in ((explorer, invariants), (jax_explorer, jax_invariants)):
        s = _counter(ex, inv)
        res = ex.explore(s, budget=200, por=por, stop_on_first=False)
        msg, chosen = res.violations[0]
        mini = ex.minimize(s, chosen, msg)
        run = ex.replay(s, ex.schedule_to_str(mini))
        got.append((res.schedules, res.reductions, [m for m, _ in res.violations],
                    ex.schedule_to_str(mini), run.trace, run.violation))
    assert got[0] == got[1]
    assert got[0][5] is not None


# --------------------------------------------------------------------------
# complete_vs_claim: the JAX order's race, and the port's order
# --------------------------------------------------------------------------

def _scenario(name):
    return {s.name: s for s in scenarios()}[name]


def test_the_jax_complete_order_is_caught_and_replays_bit_for_bit(monkeypatch):
    monkeypatch.setattr(qmod.JobQueue, "complete", jax_order_complete)
    rep = run_mc(names=["complete_vs_claim"])
    assert rep.violations >= 1
    f = rep.findings[0]
    assert (f.rule, f.severity, f.path) == ("PSM301", "error",
                                            "peasoup_tpu_torch/campaign/queue.py")
    assert "claimed twice" in f.message
    sched = f.source_line.split("schedule=", 1)[1].strip()
    s = _scenario("complete_vs_claim")
    r1, r2 = explorer.replay(s, sched), explorer.replay(s, sched)
    assert r1.violation is not None and r1.violation in f.message
    assert r1.trace == r2.trace and r1.violation == r2.violation


def test_the_port_complete_order_is_clean_and_exhausted():
    rep = run_mc(names=["complete_vs_claim"])
    assert rep.violations == 0 and not rep.findings
    assert rep.per_scenario[0]["exhausted"]


def test_the_jax_package_checker_misses_its_own_race():
    # its zombie_complete drill races a completer against its own reap,
    # never against a second claimer: the JAX order passes it
    from peasoup_tpu.analysis.mc.scenarios import scenario_names as jax_names

    assert "complete_vs_claim" not in jax_names()
