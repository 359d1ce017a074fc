"""Engine 4: the kernel contracts (PSK2xx) over ``kernels.py``, ``csrc/``
and ``ops/registry.py`` (the JAX package's analysis/kernels.py, which
lints Pallas kernels).

Every hand-written CUDA kernel of the port ships with a wrapper that
launches it for a CUDA tensor, a plain version in the same module that
the wrapper runs for a CPU tensor, and a registry entry
(``ops/registry.py:_KERNEL_BUILDS``) with its representative geometry
and its ShapeCtx hook. :func:`audit_kernels` checks that contract:

* **PSK201** — a ``csrc/*.cu`` source, or a kernel of ``kernels._ENTRIES``,
  with no ``_KERNEL_BUILDS`` entry: it escapes the registry, and with it
  warmup, the perf gate and these checks.
* **PSK202** — registry drift: the wrapper, its plain version and its
  registry entry must all resolve, and the entry must build the
  wrapper. The JAX package's fallback leg is reversed here: a wrapper
  that calls its plain version from an exception handler, or when the
  card or ``nvcc`` is absent, is a finding (on the card a kernel runs or
  raises).
* **PSK203** (CPU leg) — each kernel's registry build runs on the CPU,
  through its plain version, and the ``__host__ __device__`` map headers
  of ``csrc/`` compile under g++ as host code (their agreement with the
  plain versions is ``tests/test_torch_kernel_host.py``'s).
* **PSK208** (card leg, ``device="cuda"``) — each kernel builds with
  ``nvcc`` for ``sm_90a`` (``kernels.build``), launches at its registry
  geometry and at every ladder rung its hook accepts, and each launch is
  held against its plain version on the same inputs at the JAX
  package's equality class: bitwise (a zero's sign included), or for
  dftspec the accuracy gate and for specchain's s0 ``s0_envelope``.
  Under ``device="cpu"`` this leg is reported as not attempted, never
  as a pass.

PSK204-PSK207 read Pallas BlockSpecs, VMEM scratch, scalar prefetch and
Mosaic's lane retiles, which CUDA kernels do not have:
:data:`EXCLUDED_RULES` gives each one's reason.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import shutil
import subprocess
import tempfile
import textwrap
from dataclasses import dataclass, field
from pathlib import Path

from .astlint import dotted_name
from .findings import Finding, SEV_ERROR, SEV_WARNING

# kernel -> (module, wrapper, its plain version)
KERNEL_WRAPPERS = {
    "dedisperse": ("peasoup_tpu_torch.ops.dedisperse", "dedisperse", "dedisperse_block"),
    "resample": ("peasoup_tpu_torch.ops.resample", "resample_rows", "resample_rows_plain"),
    "specchain": ("peasoup_tpu_torch.ops.spectrum", "specchain", "interp_deredden_zap"),
    "interbin": ("peasoup_tpu_torch.ops.fft", "untwist_interbin_normalise",
                 "untwist_interbin_normalise_plain"),
    "dftspec": ("peasoup_tpu_torch.ops.dftspec", "dft_untwist_interbin",
                "dft_untwist_interbin_plain"),
    "peaks": ("peasoup_tpu_torch.ops.peaks", "find_cluster_peaks_multi",
              "find_cluster_peaks_multi_plain"),
    "harmpeaks": ("peasoup_tpu_torch.ops.peaks", "find_harmonic_cluster_peaks",
                  "find_harmonic_cluster_peaks_plain"),
    "boxcar": ("peasoup_tpu_torch.ops.singlepulse", "boxcar_best", "boxcar_best_plain"),
    "spchain": ("peasoup_tpu_torch.ops.singlepulse", "boxcar_dec_best",
                "boxcar_dec_best_plain"),
}

# the JAX package's kernel rules with no counterpart here, and why
EXCLUDED_RULES = {
    "PSK204": "BlockSpec tiles off the TPU's (8, 128) lane/sublane quanta: CUDA "
              "kernels have no BlockSpec; their tiling is checked by running them",
    "PSK205": "sub-f32 VMEM scratch below its sublane quantum: no VMEM on the "
              "card; shared memory is sized in each kernel's source",
    "PSK206": "num_scalar_prefetch against the kernel's arity: no scalar "
              "prefetch; kernels.py's ctypes argtypes fix each entry's arity",
    "PSK207": "a Mosaic lane retile without a fallback ladder: nvcc has no "
              "retile to refuse, and the port keeps no fallback",
}

# the headers of csrc/ whose maps are __host__ __device__ (host-compilable)
HOST_MAP_HEADERS = (
    "boxcar_map.cuh", "cluster_step.cuh", "dedisp_map.cuh", "dftmap.cuh",
    "interbin_map.cuh", "levels.cuh", "peaks_map.cuh", "spchain_map.cuh",
)

CARD_NOT_ATTEMPTED = "not attempted (cpu)"


def _kernel_finding(name, rule, message, severity=SEV_ERROR, hint="", tag=""):
    return Finding(
        rule=rule,
        severity=severity,
        path=f"kernel-registry/{name}{tag}",
        line=0,
        col=0,
        message=message,
        fix_hint=hint,
        source_line=f"{rule} {name}{tag}",
    )


# --------------------------------------------------------------------------
# PSK201: every source and entry registered
# --------------------------------------------------------------------------

def unregistered_kernels(csrc_dir=None, entries=None, builds=None) -> list[tuple[str, str]]:
    """(kernel, where it was found) for each ``csrc/*.cu`` source and each
    ``kernels._ENTRIES`` kernel without a ``_KERNEL_BUILDS`` entry."""
    from .. import kernels
    from ..ops import registry

    csrc = Path(csrc_dir) if csrc_dir is not None else kernels.CSRC
    entries = kernels._ENTRIES if entries is None else entries
    builds = registry._KERNEL_BUILDS if builds is None else builds
    out = [(p.stem, f"csrc/{p.name}") for p in sorted(csrc.glob("*.cu"))
           if p.stem not in builds]
    out += [(k, "kernels._ENTRIES") for k in sorted(entries) if k not in builds
            and k not in {name for name, _ in out}]
    return out


# --------------------------------------------------------------------------
# PSK202: wrapper, plain version and registry entry resolve; no fallback
# --------------------------------------------------------------------------

_ABSENCE_MARKERS = ("is_available", "device_count", "_nvcc", "which", "nvcc")


def _calls(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Call) and (dotted_name(n.func) or "").split(".")[-1] == name
               for n in ast.walk(node))


def fallback_sites(fn, plain: str) -> list[str]:
    """Where ``fn``'s source calls ``plain`` as a fallback: from an
    exception handler, or under a test of the card's or nvcc's presence.
    Dispatch on the tensor's device (``x.device.type == "cpu"``) is the
    contract, not a fallback."""
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError, SyntaxError):
        return []
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and _calls(node, plain):
            sites.append(f"line {node.lineno}: except handler calls {plain}()")
        elif isinstance(node, ast.If):
            test = ast.unparse(node.test)
            if any(m in test for m in _ABSENCE_MARKERS) and _calls(node, plain):
                sites.append(f"line {node.lineno}: `if {test}` calls {plain}()")
    return sites


def check_wrapper(name: str, wrappers=None, builds=None) -> list[Finding]:
    """PSK202 for one kernel."""
    import torch

    from ..ops import registry

    wrappers = KERNEL_WRAPPERS if wrappers is None else wrappers
    builds = registry._KERNEL_BUILDS if builds is None else builds
    if name not in wrappers:
        return [_kernel_finding(name, "PSK202", "kernel has no wrapper/plain-version "
                                "declaration in analysis/kernels.py:KERNEL_WRAPPERS")]
    modname, wname, pname = wrappers[name]
    try:
        mod = importlib.import_module(modname)
    except Exception as exc:
        return [_kernel_finding(name, "PSK202", f"module {modname} failed to import: "
                                f"{type(exc).__name__}: {exc!s:.200}")]
    wrapper, plain = getattr(mod, wname, None), getattr(mod, pname, None)
    findings = []
    if wrapper is None:
        findings.append(_kernel_finding(name, "PSK202", f"wrapper {wname!r} missing from {modname}"))
    if plain is None:
        findings.append(_kernel_finding(
            name, "PSK202", f"plain version {pname!r} missing from {modname}: the kernel "
            "has nothing to be held against"))
    if name in builds and wrapper is not None:
        try:
            fn = builds[name][0](torch.device("cpu"))[0]
        except Exception as exc:
            fn = None
            findings.append(_kernel_finding(
                name, "PSK203", f"registry build failed on the CPU: {type(exc).__name__}: "
                f"{exc!s:.200}"))
        if fn is not None and fn is not wrapper:
            findings.append(_kernel_finding(
                name, "PSK202", f"registry entry builds {getattr(fn, '__qualname__', fn)!r}, "
                f"not the wrapper {modname}.{wname}"))
    if wrapper is not None and plain is not None:
        for site in fallback_sites(wrapper, pname):
            findings.append(_kernel_finding(
                name, "PSK202", f"wrapper {wname} falls back to its plain version ({site}): "
                "on the card a kernel runs or raises",
                hint="dispatch on the tensor's device only; let a failed build or "
                     "launch raise"))
    return findings


# --------------------------------------------------------------------------
# PSK203: the CPU leg
# --------------------------------------------------------------------------

def compile_host_maps(csrc_dir=None) -> str | None:
    """Compile the host-compilable map headers together with g++ as one
    translation unit; None where they compile, else g++'s message."""
    from .. import kernels

    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found"
    csrc = Path(csrc_dir) if csrc_dir is not None else kernels.CSRC
    src = "".join(f'#include "{h}"\n' for h in HOST_MAP_HEADERS if (csrc / h).exists())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "maps.cpp"
        path.write_text("#include <cstddef>\n#include <cstdint>\n#include <algorithm>\n" + src)
        proc = subprocess.run(
            [gxx, "-std=c++17", "-ffp-contract=off", "-fsyntax-only", "-I", str(csrc),
             str(path)], capture_output=True, text=True)
    return None if proc.returncode == 0 else proc.stderr[-2000:]


def _run_plain_cpu(name: str, builds) -> str | None:
    import torch

    try:
        fn, args, kwargs = builds[name][0](torch.device("cpu"))
        fn(*args, **kwargs)
    except Exception as exc:
        return f"{type(exc).__name__}: {exc!s:.300}"
    return None


# --------------------------------------------------------------------------
# PSK208: the card leg
# --------------------------------------------------------------------------

def _call_plain(name: str, plain, args, kwargs):
    if name == "dedisperse":  # the block form takes out_nsamps by keyword
        fil, delays, killmask, out_nsamps = args
        return plain(fil, delays, killmask, out_nsamps=out_nsamps, **kwargs)
    return plain(*args, **kwargs)


def _bitwise(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def compare_outputs(name: str, got, ref, args, kwargs) -> tuple[bool, float, str]:
    """(agrees, max |err|, equality class) of one launch's outputs against
    its plain version's, at the JAX package's class for the kernel."""
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    if len(got) != len(ref):
        return False, float("inf"), "bitwise"

    def err(a, b):
        if a.shape != b.shape:
            return float("inf")
        if a.is_floating_point() and a.numel():
            return float((a - b).abs().max())
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0

    worst = max((err(a, b) for a, b in zip(got, ref)), default=0.0)
    if name == "dftspec":
        from ..ops.dftspec import ACC_MAX_REL, ACC_Q999_REL, accuracy

        x, mean, std = args[:3]
        m = x.shape[-1] // 2
        acc_max, q999 = accuracy(got[0], ref[0], mean, std, m)
        pad_zero = not bool(got[0][:, m + 1:].any())
        ok = acc_max <= ACC_MAX_REL and q999 <= ACC_Q999_REL and pad_zero
        return ok, worst, "accuracy gate (max 1e-3, q99.9 2e-4)"
    if name == "specchain":
        from ..ops.spectrum import s0_envelope

        ok = _bitwise(got[0], ref[0]) and _bitwise(got[1], ref[1]) and bool(
            ((got[2] - ref[2]).abs() <= s0_envelope(ref[2])).all())
        return ok, worst, "parts bitwise, s0 within s0_envelope"
    return all(_bitwise(a, b) for a, b in zip(got, ref)), worst, "bitwise"


def _card_leg(name: str, plain, builds, ladder, check: dict) -> list[Finding]:
    import torch

    from .. import kernels

    findings: list[Finding] = []
    dev = torch.device("cuda")
    build, hook = builds[name]
    cases = [("registry", {})] + [(f"@nsamps={rung}", sizes) for rung, sizes in ladder]
    for tag, sizes in cases:
        before = kernels.launches[name]
        try:
            fn, args, kwargs = build(dev, **sizes)
            got = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ref = _call_plain(name, plain, args, kwargs)
            torch.cuda.synchronize()
        except Exception as exc:
            findings.append(_kernel_finding(
                name, "PSK208", f"launch at {tag} failed: {type(exc).__name__}: {exc!s:.300}",
                tag="" if tag == "registry" else tag))
            continue
        launched = kernels.launches[name] - before
        ok, worst, klass = compare_outputs(name, got, ref, args, kwargs)
        check["launches"] += launched
        check["shapes"].append(tag)
        check["max_abs_err"] = max(check["max_abs_err"], worst)
        check["equality"] = klass
        del got, ref, args, kwargs
        if launched == 0:
            findings.append(_kernel_finding(
                name, "PSK208", f"the wrapper launched no kernel at {tag}: it ran "
                "something else on the card", tag="" if tag == "registry" else tag))
        elif not ok:
            findings.append(_kernel_finding(
                name, "PSK208", f"kernel disagrees with its plain version at {tag} "
                f"({klass}; max |err| {worst!r})", tag="" if tag == "registry" else tag))
        else:
            check["matched"] += 1
        torch.cuda.empty_cache()
    return findings


@dataclass
class KernelReport:
    findings: list[Finding] = field(default_factory=list)
    kernels: list[str] = field(default_factory=list)
    # kernel -> what the card leg did: built, launches, matched shapes
    checks: dict[str, dict] = field(default_factory=dict)


def audit_kernels(names=None, device: str = "cpu", rungs=None, bucket=None,
                  overrides=None, csrc_dir=None, entries=None, builds=None,
                  wrappers=None) -> KernelReport:
    """The kernel contracts over every registered kernel (or ``names``).
    ``device="cuda"`` adds the card leg, which raises where there is no
    card or no ``nvcc``; ``rungs``, ``bucket`` and ``overrides`` are the
    ladder it launches at (default: the contract engine's ladder), each
    launch at the bucket's own rows (DM trials, resampled rows).
    ``csrc_dir``, ``entries``, ``builds`` and ``wrappers`` replace the
    real sources and tables (tests seed faults through them)."""
    from .. import kernels
    from ..ops import registry
    from .contracts import ladder_builds, ladder_rungs

    builds = registry._KERNEL_BUILDS if builds is None else builds
    wrappers = KERNEL_WRAPPERS if wrappers is None else wrappers
    report = KernelReport()
    for kname, where in unregistered_kernels(csrc_dir, entries, builds):
        report.findings.append(_kernel_finding(
            kname, "PSK201", f"kernel {kname!r} ({where}) has no ops/registry.py "
            "_KERNEL_BUILDS entry: it escapes warmup, the perf gate and these checks",
            hint="add its build and ShapeCtx hook to ops/registry.py"))
    names = sorted(builds) if names is None else list(names)
    cuda = device.startswith("cuda")
    if cuda:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the kernel engine's card leg needs a CUDA device")
        kernels.build([n for n in names if n in kernels.KERNELS])
    msg = compile_host_maps(csrc_dir)
    if msg is not None:
        report.findings.append(_kernel_finding(
            "csrc", "PSK203", f"the map headers do not compile as host code: {msg}",
            severity=SEV_WARNING if msg == "g++ not found" else SEV_ERROR))
    rungs = ladder_rungs() if rungs is None else list(rungs)
    for name in names:
        report.kernels.append(name)
        check = dict(card=CARD_NOT_ATTEMPTED, launches=0, matched=0, shapes=[],
                     max_abs_err=0.0, equality="")
        report.checks[name] = check
        found = check_wrapper(name, wrappers, builds)
        report.findings.extend(found)
        if name not in builds or any(f.rule == "PSK202" for f in found):
            continue
        err = _run_plain_cpu(name, builds)
        if err is not None:
            report.findings.append(_kernel_finding(
                name, "PSK203", f"plain version fails at its registry geometry: {err}"))
            continue
        if not cuda:
            continue
        mod = importlib.import_module(wrappers[name][0])
        check["card"] = "sm_90a"
        # the card leg takes the bucket's own rows: its row grid too
        ladder = ladder_builds(builds[name][1], rungs, overrides, bucket, ladder_rows=0)
        report.findings.extend(_card_leg(name, getattr(mod, wrappers[name][2]), builds,
                                         ladder, check))
    return report

