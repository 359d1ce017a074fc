"""The port's measurement layer beyond the tuner (peasoup_tpu_torch.perf
and ops/registry.py) on the CPU: the registry against the kernels and the
JAX package's registry, the warm pass, perf.json and its schema, the
ratchet's structural rules and the roofline's peaks. The card's legs are
marked ``cuda`` and skip here."""

import copy
import json

import pytest
import torch

from peasoup_tpu.ops.registry import registered_programs as jax_registered_programs
from peasoup_tpu_torch import kernels
from peasoup_tpu_torch.obs.schema import SchemaError
from peasoup_tpu_torch.ops import registry
from peasoup_tpu_torch.perf import measure, microbench, ratchet, roofline, warmup
from peasoup_tpu_torch.tools.perf import main as perf_main

SOME = ["kernels.dedisperse", "kernels.resample", "ops.spectrum.form_power",
        "ops.singlepulse.normalise_trials"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def test_registry_holds_every_kernel():
    specs = {s.name: s for s in registry.registered_programs()}
    for name in kernels.KERNELS:
        assert specs[f"kernels.{name}"].kernel == name
    assert registry.unregistered_programs() == []


def test_every_jax_program_has_a_counterpart_or_a_reason(capsys):
    names = {s.name for s in registry.registered_programs()}
    jax_names = {s.name for s in jax_registered_programs()}
    assert set(registry.JAX_COUNTERPARTS) == jax_names
    without = []
    for jax_name, port in sorted(registry.JAX_COUNTERPARTS.items()):
        if port.startswith(("ops.", "kernels.")):
            assert port in names, jax_name
        else:
            assert len(port) > 40, jax_name  # a reason, in words
            without.append((jax_name, port))
    print("JAX programs without a port counterpart:")
    for jax_name, why in without:
        print(f"  {jax_name}: {why}")
    assert [n for n, _ in without] == [
        "ops.resample.resample_select", "ops.resample.resample_select_packed",
        "ops.resample.resample_select_packed_planes",
    ]


def test_builds_are_seeded():
    for spec in registry.registered_programs():
        a = spec.build(torch.device("cpu"))[1]
        b = spec.build(torch.device("cpu"))[1]
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), spec.name


def test_warm_registry_on_the_cpu_builds_no_cuda_source(monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a CUDA source was built on the CPU")

    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "load", no_build)
    rep = warmup.warm_registry(device="cpu")
    assert rep.built == [] and rep.found == [] and rep.errors == []
    assert len(rep.programs) == len(registry.registered_programs())
    doc = rep.to_doc()
    assert doc["kernels_built"] == [] and doc["programs"] == len(rep.programs)


def test_warm_registry_records_a_failing_program():
    def broken(device):
        raise RuntimeError("no such shape")

    spec = registry.ProgramSpec("ops.broken", broken)
    rep = warmup.warm_registry(specs=[spec], device="cpu")
    assert rep.errors[0].error == "RuntimeError: no such shape"


def test_perf_json_validates_and_ratchets(tmp_path):
    doc = microbench.run_microbench(reps=2, programs=SOME, device="cpu")
    path = tmp_path / "perf.json"
    microbench.write_perf(doc, str(path))
    doc = microbench.load_perf(str(path))
    assert doc["backend"] == "cpu" and doc["power_limit"] is None
    assert doc["timer"] == "host_clock" and doc["totals"]["errors"] == 0
    assert doc["programs"]["kernels.dedisperse"]["stage"] == "dedisperse"
    assert doc["programs"]["kernels.dedisperse"]["kernel"] == "dedisperse"
    base = ratchet.baseline_from_perf(doc)
    problems, notices = ratchet.check_perf(doc, base)
    assert problems == [] and "structural rules only" in notices[-1]
    # a deleted program fails; a broken one fails; a new one is reported
    gone = copy.deepcopy(doc)
    del gone["programs"]["kernels.resample"]
    problems, _ = ratchet.check_perf(gone, base)
    assert [(p.kind, p.program) for p in problems] == [("missing_program", "kernels.resample")]
    broken = copy.deepcopy(doc)
    broken["programs"]["ops.spectrum.form_power"]["error"] = "RuntimeError: boom"
    problems, _ = ratchet.check_perf(broken, base)
    assert [p.kind for p in problems] == ["program_error"]
    grown = copy.deepcopy(doc)
    grown["programs"]["ops.new.program"] = dict(doc["programs"]["ops.spectrum.form_power"])
    problems, notices = ratchet.check_perf(grown, base)
    assert problems == [] and "ops.new.program" in notices[0]
    # the timing ratchet, where it applies
    slow = copy.deepcopy(doc)
    slow["programs"]["kernels.dedisperse"]["execute_median_s"] *= 10
    problems, _ = ratchet.check_perf(slow, base, timing="on")
    assert [(p.kind, p.program) for p in problems] == [("slower", "kernels.dedisperse")]
    with pytest.raises(SchemaError):
        microbench.validate_perf(dict(doc, backend="tpu"))


def test_check_subcommand_exit_codes(tmp_path, capsys):
    perf = str(tmp_path / "perf.json")
    base = str(tmp_path / "base.json")
    assert perf_main(["bench", "--device", "cpu", "--reps", "2", "-o", perf,
                      "--programs", ",".join(SOME)]) == 0
    assert perf_main(["check", "--device", "cpu", "--perf", perf, "--baseline", base,
                      "--write-baseline"]) == 0
    assert perf_main(["check", "--device", "cpu", "--perf", perf, "--baseline", base]) == 0
    assert "kernels built 0" in capsys.readouterr().out
    doc = json.loads(open(base).read())
    doc["programs"]["kernels.gone"] = dict(doc["programs"]["kernels.dedisperse"])
    with open(base, "w") as f:
        json.dump(doc, f)
    assert perf_main(["check", "--device", "cpu", "--perf", perf, "--baseline", base]) == 1
    assert "[missing_program]" in capsys.readouterr().out
    assert perf_main(["check", "--device", "cpu", "--perf", perf, "--baseline",
                      str(tmp_path / "none.json")]) == 2


def test_spread_table_and_its_subcommand(capsys):
    # each program's median, min and max over the passes, per timer; the
    # subcommand times the card only
    passes = [{"a": {"call": c, "run": r, "calls": 4}} for c, r in
              ((3e-6, 2e-6), (1e-6, 2e-6), (2e-6, 4e-6), (9e-6, 1e-6))]
    row = microbench.spread_table(passes)["a"]
    assert row["call"] == {"median": pytest.approx(2.5e-6), "min": 1e-6, "max": 9e-6,
                           "ratio": pytest.approx(9.0)}
    assert row["run"]["median"] == 2e-6 and row["run"]["ratio"] == pytest.approx(4.0)
    assert perf_main(["spread", "--device", "cpu"]) == 2
    assert "CUDA --device" in capsys.readouterr().err


def test_baseline_pinned_at_the_median_of_runs(tmp_path, capsys):
    # several benches of one card pin each program at the median of its
    # medians, so no single pass over the registry sets the baseline
    doc = microbench.run_microbench(reps=2, programs=SOME, device="cpu")
    runs = []
    for scale in (1.0, 3.0, 0.5, 1.2, 9.0):
        r = copy.deepcopy(doc)
        for rec in r["programs"].values():
            rec["execute_median_s"] = 1e-3 * scale
        runs.append(r)
    runs[1]["programs"]["kernels.resample"]["error"] = "RuntimeError: boom"
    base = ratchet.baseline_from_perf(runs[0], more=runs[1:])
    assert base["runs"] == 5
    assert base["programs"]["kernels.dedisperse"]["execute_median_s"] == pytest.approx(1.2e-3)
    # a broken run's program is pinned from the runs where it ran
    assert base["programs"]["kernels.resample"]["execute_median_s"] == pytest.approx(1.1e-3)
    with pytest.raises(ValueError, match="one kind of device"):
        ratchet.baseline_from_perf(runs[0], more=[dict(runs[1], device_kind="other")])
    paths = []
    for k, r in enumerate(runs[:3]):
        paths.append(str(tmp_path / f"perf{k}.json"))
        microbench.write_perf(r, paths[-1])
    out = str(tmp_path / "base.json")
    assert perf_main(["check", "--device", "cpu", "--perf", *paths, "--baseline", out,
                      "--write-baseline"]) == 0
    assert "from 3 run(s)" in capsys.readouterr().out
    pinned = ratchet.load_baseline(out)["programs"]["ops.spectrum.form_power"]
    assert pinned["execute_median_s"] == pytest.approx(1e-3)
    # check itself takes one run
    assert perf_main(["check", "--device", "cpu", "--perf", *paths, "--baseline",
                      out]) == 2


def test_the_ports_baseline_names_its_card():
    base = ratchet.load_baseline(ratchet.BASELINE_PATH)
    assert base["backend"] == "cuda" and "H100" in base["device_kind"]
    assert base["power_limit"].startswith(base["device_kind"])
    assert set(base["programs"]) == {s.name for s in registry.registered_programs()}


def test_roofline_peaks_and_stages():
    assert roofline.device_peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    assert roofline.device_peaks("cpu") is None
    stages = {s.name: roofline.stage_for_program(s.name)
              for s in registry.registered_programs()}
    assert stages["kernels.dedisperse"] == "dedisperse"
    assert stages["kernels.resample"] == "resample"
    assert stages["kernels.specchain"] == stages["kernels.dftspec"] == "spectrum_chain"
    assert stages["kernels.interbin"] == "spectrum_chain"
    assert stages["kernels.harmpeaks"] == stages["kernels.spchain"] == "peaks"
    assert stages["ops.dedisperse.subband_stage1"] == "dedisperse"
    assert stages["ops.harmonics.harmonic_sums"] == "harmonics"
    f = roofline.roofline_fields(1e-3, 67e9, 3.35e9, "NVIDIA H100 80GB HBM3")
    assert f["peak_fraction"] == 1.0 and f["bound"] == "compute"


def test_measure_primitives():
    assert measure.median([3.0, 1.0, 2.0, 10.0]) == 2.5
    assert measure.median([]) == 0.0
    samples = measure.timed_samples(lambda: None, 3, device="cpu")
    assert len(samples) == 3 and samples == sorted(samples)
    assert measure.summarize(samples)["reps"] == 3
    with pytest.raises(ValueError, match="CUDA events"):
        measure.event_samples(lambda: None, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA events"):
        measure.event_run_samples(lambda: None, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        measure.device_busy_seconds(lambda: None, "cpu")


def test_shape_ctx_and_dry_run():
    bucket = (16, 8, 1 << 15, 0.000256, 1400.0, -8.0)
    from peasoup_tpu.perf.warmup import shape_ctx_for_bucket as jax_shape_ctx

    ctx = warmup.shape_ctx_for_bucket(bucket, "search", dict(dm_end=40.0))
    want = jax_shape_ctx(bucket, "search", dict(dm_end=40.0))
    for f in ("nsamps", "nchans", "nbits", "ndm", "out_nsamps", "fft_size", "nharms",
              "accel_pad", "fold_nsamps"):
        assert getattr(ctx, f) == getattr(want, f), f
    assert ctx.fft_size == 1 << 14 and ctx.accel_pad == 4 and ctx.ndm > 1
    sp = warmup.shape_ctx_for_bucket(bucket, "spsearch", dict(dm_end=60.0, n_widths=8))
    assert sp.widths == (1, 2, 4, 8, 16, 32, 64, 128) and sp.tpad >= sp.out_nsamps
    stats = warmup.warm_bucket(bucket, device="cpu")
    assert stats["error"] is None and stats["kernels_built"] == []
    assert stats["mode"] == "dryrun" and stats["seconds"] > 0


@pytest.mark.cuda
def test_warm_pass_on_the_card(dev):
    warmup.warm_registry(device=dev)
    rep = warmup.warm_registry(device=dev)
    assert rep.built == [] and rep.errors == []
    assert set(rep.found) == set(kernels.KERNELS)


@pytest.mark.cuda
def test_bench_on_the_card(dev, tmp_path):
    doc = microbench.run_microbench(reps=3, device=dev)
    assert doc["timer"] == "cuda_events" and doc["totals"]["errors"] == 0
    assert "H100" in doc["power_limit"] or doc["device_kind"] in doc["power_limit"]
    microbench.write_perf(doc, str(tmp_path / "perf.json"))
