"""Per-program microbenchmarks over the port's registry (the JAX package's
perf/microbench.py).

Each registered program (ops/registry.py) is built at its representative
shape on the device, called once untimed (its first call, which loads a
kernel's library, is ``compile_s``), then timed: on the card the median of
k CUDA-event samples, each around a run of back-to-back calls after a
warm-up and divided by the run's length (perf/measure.py:event_run_samples;
a lone call's event pair held host stalls of several times the program's
time at these small shapes), host-clock samples on the CPU. The result is a ``perf.json`` keyed by program name, validated
against ``perf.schema.json`` beside this module, that names the device, and
on the card its power limit as ``nvidia-smi`` reports it: the document the
ratchet (perf/ratchet.py) holds against the port's baseline.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from ..device import resolve_device
from . import write_json_atomic
from .measure import event_run_samples, event_samples, median, summarize, timed_samples
from .roofline import stage_for_program

PERF_SCHEMA = "peasoup_tpu_torch.perf"
PERF_VERSION = 1
SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "perf.schema.json")

DEFAULT_REPS = 5


def power_limit(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them for ``device``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[device.index or 0].strip()


def _arg_sig(args) -> list[str]:
    """Compact shape/dtype signature of the tensor and array arguments,
    e.g. ``uint8[4296,64]`` (a list of them as ``5 x float32[4,8192]``)."""
    import numpy as np

    def sig(a):
        if isinstance(a, torch.Tensor):
            return f"{str(a.dtype).removeprefix('torch.')}[{','.join(map(str, a.shape))}]"
        if isinstance(a, np.ndarray):
            return f"{a.dtype}[{','.join(map(str, a.shape))}]"
        if isinstance(a, (list, tuple)) and a and all(
                isinstance(x, (torch.Tensor, np.ndarray)) for x in a):
            return f"{len(a)} x {sig(a[0])}"
        return None

    return [s for s in map(sig, args) if s is not None]


def bench_program(spec, reps: int, device: torch.device) -> dict:
    """Time one registered program on ``device``; a failure comes back as
    a record with ``error`` set."""
    rec: dict = {"error": None, "stage": stage_for_program(spec.name)}
    if spec.kernel:
        rec["kernel"] = spec.kernel
    try:
        fn, args, kwargs = spec.build(device)
        rec["args"] = _arg_sig(args)

        def call():
            fn(*args, **kwargs)

        t0 = time.perf_counter()
        call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["compile_s"] = round(time.perf_counter() - t0, 6)
        if device.type == "cuda":
            samples, rec["calls_per_sample"] = event_run_samples(call, reps, device)
        else:
            samples = timed_samples(call, reps, device=device)
        rec.update(summarize(samples))
    except Exception as exc:  # recorded; the ratchet fails a broken program
        rec["error"] = f"{type(exc).__name__}: {exc!s:.300}"
    return rec


def run_microbench(specs=None, reps: int = DEFAULT_REPS, programs: list[str] | None = None,
                   device: str | torch.device = "cuda") -> dict:
    """Benchmark the registry into a perf.json document. A program that
    fails keeps a record with its error, so the ratchet tells a vanished
    program from a broken one."""
    device = resolve_device(device)
    if specs is None:
        from ..ops.registry import registered_programs

        specs = registered_programs()
    if programs:
        wanted = set(programs)
        specs = [s for s in specs if s.name in wanted]
    t0 = time.perf_counter()
    recs = {spec.name: bench_program(spec, reps, device) for spec in specs}
    ok = [r for r in recs.values() if not r["error"]]
    stages: dict = {}
    for r in ok:
        st = stages.setdefault(r["stage"], {"programs": 0, "execute_s": 0.0})
        st["programs"] += 1
        st["execute_s"] += r["execute_median_s"]
    for st in stages.values():
        st["execute_s"] = round(st["execute_s"], 9)
    cuda = device.type == "cuda"
    return {
        "schema": PERF_SCHEMA,
        "version": PERF_VERSION,
        "created_unix": time.time(),
        "backend": device.type,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "power_limit": power_limit(device) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "timer": "cuda_events" if cuda else "host_clock",
        "reps": int(reps),
        "programs": recs,
        "stages": stages,
        "totals": {
            "programs": len(recs),
            "errors": len(recs) - len(ok),
            "compile_s": round(sum(r["compile_s"] for r in ok), 6),
            "execute_s": round(sum(r["execute_median_s"] for r in ok), 9),
            "wall_s": round(time.perf_counter() - t0, 3),
        },
    }


def validate_perf(doc: dict) -> None:
    """Validate a perf.json document against the schema; raises SchemaError."""
    from ..obs.schema import validate

    with open(SCHEMA_PATH) as f:
        validate(doc, json.load(f))


def load_perf(path: str) -> dict:
    """Load and validate a perf.json document."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != PERF_SCHEMA:
        raise ValueError(f"{path}: not a {PERF_SCHEMA} document (schema={doc.get('schema')!r})")
    validate_perf(doc)
    return doc


def write_perf(doc: dict, path: str) -> None:
    """Validate and atomically write a perf.json document."""
    validate_perf(doc)
    write_json_atomic(path, doc)


def spread_pass(device: str | torch.device = "cuda") -> dict:
    """One pass over the registry on the card under two timers, program by
    program: ``{name: {"call": s, "run": s, "calls": n}}``. ``call`` is the
    median of DEFAULT_REPS samples of one CUDA-event pair around a lone
    call (perf/measure.py:event_samples), ``run`` the microbenchmark's own:
    the median of DEFAULT_REPS back-to-back runs of ``calls`` calls, per
    call (event_run_samples)."""
    from ..ops.registry import registered_programs

    device = resolve_device(device)
    reps = DEFAULT_REPS
    out = {}
    for spec in registered_programs():
        fn, args, kwargs = spec.build(device)

        def call():
            fn(*args, **kwargs)

        call()
        torch.cuda.synchronize(device)
        lone = median(event_samples(call, reps, device))
        run, calls = event_run_samples(call, reps, device)
        out[spec.name] = {"call": lone, "run": median(run), "calls": calls}
    return out


def spread_table(passes: list[dict]) -> dict:
    """Each program's median, min and max over ``passes`` (of
    :func:`spread_pass`) under each timer, with the max/min ratio."""
    table = {}
    for name in sorted(passes[0]):
        row = {}
        for timer in ("call", "run"):
            xs = sorted(p[name][timer] for p in passes)
            row[timer] = {"median": median(xs), "min": xs[0], "max": xs[-1],
                          "ratio": xs[-1] / xs[0] if xs[0] > 0 else None}
        table[name] = row
    return table
