"""Engine 2: contract checks over the port's registered programs (the JAX
package's analysis/contracts.py, which lints jaxprs and StableHLO).

The port traces nothing, so each :class:`~peasoup_tpu_torch.ops.registry
.ProgramSpec` is *run* at its shapes under a
``torch.utils._python_dispatch.TorchDispatchMode`` that records every
aten op it dispatches, and the record is linted:

* **PSC101 f64 op** — an op whose output is float64 or complex128. The
  fixed-order accumulator of ``ops/spectrum.py:row_sum`` (ROADMAP C.2)
  is the one sanctioned source (:data:`F64_ACCUMULATORS`).
* **PSC102 host sync** — ``aten._local_scalar_dense`` (``.item()``),
  ``aten.nonzero``, ``aten.masked_select`` or a copy from the card to
  the CPU inside the call, unless the program's ``allow_syncs`` names
  the op with its reason (a kernel program is checked on the card only:
  off it, its wrapper runs the plain version). On the card the program
  also runs under ``torch.cuda.set_sync_debug_mode("warn")``, and the
  synchronising operations it warns of are counted into the report
  (:attr:`ContractReport.sync_warnings`): that count mixes blocking
  host-to-device copies with read-backs, so it is no finding of its own.
* **PSC103 oversized host-to-device copy** — a tensor copied from the
  CPU to another device inside the call above ``max_const_bytes``, and
  again in a second call on the same inputs: the counterpart of a
  constant baked into an executable (a table rebuilt and re-sent at
  every call; one built once and cached passes).
* **PSC104 in-place write mismatch** — an op whose schema writes an
  argument (``alias_info.is_write``) that aliases a program input the
  registry does not declare in ``donate``, or a declared input never
  written.
* **PSC105 build/run failure** — a registered program that no longer
  runs at its registered (or hook-built) shapes.

**Bucket-ladder mode** (:func:`audit_programs_ladder`): the same checks
at the shapes a campaign runs — each rung of the padded-nsamps ladder
(``campaign/buckets.py:bucket_nsamps``) is turned into ShapeCtxs with
the pipelines' own plan machinery (``perf/warmup.py:shape_ctx_for_bucket``,
plus the subband, matmul, streaming, FDAS, fused-DFT and 2-bit variants,
so every hook family gets a context it accepts), and every program is
rebuilt through its ``param`` hook at every rung. **PSC106** flags a
program the ladder covers at fewer than the required rungs.

The kernels' own launches go through ctypes and are invisible to the
dispatch mode: for a kernel program this engine covers its wrapper's
torch ops, and the kernel engine (:mod:`.kernels`) covers the launch.
"""

from __future__ import annotations

import sys
import warnings
from dataclasses import dataclass, field, replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .findings import Finding, SEV_ERROR, SEV_WARNING

# aten ops that read a value back to the host
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense",
    "aten::nonzero",
    "aten::masked_select",
})
# the copy ops whose source and destination devices are compared
_COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_", "aten::to"})
# (file suffix, function) -> why its float64 ops are sanctioned
F64_ACCUMULATORS = {
    ("peasoup_tpu_torch/ops/spectrum.py", "row_sum"): (
        "the fixed-order row sum accumulates in f64 (ROADMAP C.2)"
    ),
}
_F64 = (torch.float64, torch.complex128)


@dataclass
class ContractConfig:
    max_const_bytes: int = 1 << 20  # 1 MiB
    device: str = "cpu"


def _program_finding(spec, rule, message, severity=SEV_ERROR, hint="", tag=""):
    return Finding(
        rule=rule,
        severity=severity,
        path=f"ops-registry/{spec.name}{tag}",
        line=0,
        col=0,
        message=message,
        fix_hint=hint,
        source_line=f"{rule} {spec.name}{tag}",
    )


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except Exception:  # a tensor with no storage (a functional wrapper)
        return None


def _in_accumulator() -> bool:
    """True where the op is dispatched from a sanctioned f64 accumulator."""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        path = code.co_filename.replace("\\", "/")
        for suffix, fn in F64_ACCUMULATORS:
            if code.co_name == fn and path.endswith(suffix):
                return True
        frame = frame.f_back
    return False


class OpRecorder(TorchDispatchMode):
    """Records every aten op a call dispatches: its name, whether it made
    f64 outside a sanctioned accumulator, host syncs, host-to-device
    copies and in-place writes to the program's inputs."""

    def __init__(self, inputs: dict):
        super().__init__()
        self.inputs = inputs  # storage key -> input index
        self.f64: list[str] = []
        self.syncs: list[str] = []
        self.h2d: list[tuple[str, int, tuple]] = []
        self.writes: dict[int, str] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name in SYNC_OPS:
            self.syncs.append(name)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if any(t.dtype in _F64 for t in outs) and not _in_accumulator():
            self.f64.append(name)
        if name in _COPY_OPS:
            src = next((a for a in args if isinstance(a, torch.Tensor)), None)
            dst = args[0] if name == "aten::copy_" else (outs[0] if outs else None)
            if name == "aten::copy_" and len(args) > 1:
                src = args[1]
            if src is not None and dst is not None:
                if src.device.type == "cpu" and dst.device.type != "cpu":
                    self.h2d.append((name, src.numel() * src.element_size(),
                                     tuple(src.shape)))
                elif src.device.type == "cuda" and dst.device.type == "cpu":
                    self.syncs.append(f"{name} (device to host)")
        for i, arg in enumerate(func._schema.arguments):
            alias = arg.alias_info
            if alias is None or not alias.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in tree_flatten(val)[0]:
                if isinstance(t, torch.Tensor):
                    idx = self.inputs.get(_storage_key(t))
                    if idx is not None:
                        self.writes.setdefault(idx, name)
        return out


def _input_storages(args, kwargs) -> dict:
    """storage key -> the program argument's index (keyword arguments by
    name) for every tensor among the arguments, nested lists included."""
    keys: dict = {}
    for i, a in enumerate(args):
        for t in tree_flatten(a)[0]:
            if isinstance(t, torch.Tensor):
                keys.setdefault(_storage_key(t), i)
    for k, a in kwargs.items():
        for t in tree_flatten(a)[0]:
            if isinstance(t, torch.Tensor):
                keys.setdefault(_storage_key(t), k)
    keys.pop(None, None)
    return keys


def _run_recorded(fn, args, kwargs, cuda: bool):
    rec = OpRecorder(_input_storages(args, kwargs))
    sync_warnings = 0
    if cuda:
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with rec:
                    fn(*args, **kwargs)
            sync_warnings = sum(
                "synchroniz" in str(w.message).lower() for w in caught)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
    else:
        with rec:
            fn(*args, **kwargs)
    return rec, sync_warnings


def audit_program(spec, cfg: ContractConfig | None = None) -> list[Finding]:
    """Contract-check one registered program at its representative shapes."""
    cfg = cfg or ContractConfig()
    return _audit_built(spec, lambda: spec.build_for(None, cfg.device), cfg)


def _audit_built(spec, build, cfg: ContractConfig, tag: str = "",
                 sync_counts: dict | None = None) -> list[Finding]:
    """Run and lint one build. ``tag`` marks ladder builds
    (``@nsamps=<rung>``) so findings carry their rung. On the card the
    count of synchronising operations ``set_sync_debug_mode("warn")``
    reported goes into ``sync_counts``: it counts blocking host-to-device
    copies (a ``torch.tensor`` made on the card) beside read-backs, so it
    is reported, and the findings come from the op record."""
    findings: list[Finding] = []
    try:
        fn, args, kwargs = build()
        cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
                   for t in tree_flatten((args, kwargs))[0])
        rec, sync_warnings = _run_recorded(fn, args, kwargs, cuda)
    except Exception as e:  # registry drift is a finding, not a crash
        return [_program_finding(
            spec, "PSC105",
            f"failed to run at {'ladder' if tag else 'registered'} shapes: "
            f"{type(e).__name__}: {e!s:.300}",
            hint="the registry build no longer matches the program; fix the "
                 "registration in ops/registry.py",
            tag=tag,
        )]

    if rec.f64:
        ops = sorted(set(rec.f64))
        findings.append(_program_finding(
            spec, "PSC101",
            f"float64 ops ({len(rec.f64)}: {', '.join(ops[:6])}): f64 arithmetic "
            "on the device outside a sanctioned accumulator",
            hint="pin the offending tensors to float32",
            tag=tag,
        ))

    allowed = {op for op, _ in spec.allow_syncs}
    # off the card a kernel program runs its plain version, which never
    # runs on the card: its syncs are checked where the wrapper launches
    syncs = set(rec.syncs) if (cuda or not spec.kernel) else set()
    for op in sorted(syncs - allowed):
        findings.append(_program_finding(
            spec, "PSC102",
            f"host sync inside the program: {op} ({rec.syncs.count(op)}x), a "
            "device-to-host round trip per call",
            hint="keep the value on the device, or declare it in the program's "
                 "allow_syncs with the reason",
            tag=tag,
        ))
    if sync_counts is not None and cuda:
        sync_counts[f"{spec.name}{tag}"] = sync_warnings

    big = [h for h in rec.h2d if h[1] > cfg.max_const_bytes]
    if big:
        # a table built once and cached is sent in the first call only:
        # what counts is what a second call sends again
        try:
            rec2, _ = _run_recorded(fn, args, kwargs, cuda)
            big = [h for h in rec2.h2d if h[1] > cfg.max_const_bytes]
        except Exception:  # the first call ran; a failing second is PSC105's
            pass
    for op, nbytes, shape in big:
        if nbytes > cfg.max_const_bytes:
            findings.append(_program_finding(
                spec, "PSC103",
                f"host-to-device copy {shape} ({nbytes / 1e6:.1f} MB > "
                f"{cfg.max_const_bytes / 1e6:.1f} MB) inside the call ({op}): a "
                "table rebuilt and re-sent at every call",
                hint="build the table once on the device and pass it in",
                tag=tag,
            ))

    donated = set(spec.donate)
    for idx, op in sorted(rec.writes.items(), key=lambda kv: str(kv[0])):
        if idx not in donated:
            findings.append(_program_finding(
                spec, "PSC104",
                f"program writes its input {idx!r} in place ({op}) but the "
                "registry does not declare it donated: callers may still read it",
                hint="declare donate=... in the registration, or write a copy",
                tag=tag,
            ))
    for idx in sorted(donated - set(rec.writes), key=str):
        findings.append(_program_finding(
            spec, "PSC104",
            f"registry declares input {idx!r} donated but the program never "
            "writes it: the search's memory budget assumes in-place reuse",
            severity=SEV_WARNING,
            hint="drop the declaration, or write the input in place",
            tag=tag,
        ))
    return findings


@dataclass
class ContractReport:
    findings: list[Finding] = field(default_factory=list)
    programs: list[str] = field(default_factory=list)
    # program (``@nsamps=<rung>`` on ladder builds) -> the synchronising
    # operations set_sync_debug_mode("warn") counted in its call (card only)
    sync_warnings: dict[str, int] = field(default_factory=dict)


def audit_programs(specs=None, cfg: ContractConfig | None = None) -> ContractReport:
    """Contract-check all (or the given) registered programs."""
    if specs is None:
        from ..ops.registry import registered_programs

        specs = registered_programs()
    cfg = cfg or ContractConfig()
    report = ContractReport()
    for spec in specs:
        report.programs.append(spec.name)
        report.findings.extend(_audit_built(
            spec, lambda s=spec: s.build_for(None, cfg.device), cfg,
            sync_counts=report.sync_warnings))
    return report


# --------------------------------------------------------------------------
# bucket-ladder contracts
# --------------------------------------------------------------------------

# the synthetic campaign bucket the ladder runs at: the JAX package's
# small band with a 10 ms sample time (the whitening boundaries land on
# non-zero bins). (nchans, nbits, tsamp, fch1, foff); nsamps is the rung.
LADDER_BASE_BUCKET = (8, 8, 0.01, 1400.0, -16.0)
# the JAX package starts at 2048; the port starts at the smallest rung
# where every kernel's geometry holds at both rungs (the fused DFT takes
# FFT sizes 2^15-2^18, and a rung's FFT is the power of two below it)
LADDER_BASE_NSAMPS = 3 << 14
LADDER_OVERRIDES = {"dm_end": 20.0, "n_widths": 6}
DEFAULT_LADDER_RUNGS = 2
# the largest FFT size the dftspec kernel takes (ops/dftspec.py:_MAX_M)
FUSED_DFT_MAX_SIZE = 1 << 18


def ladder_rungs(base_nsamps: int = LADDER_BASE_NSAMPS,
                 count: int = DEFAULT_LADDER_RUNGS) -> list[int]:
    """The first ``count`` rungs >= ``base_nsamps`` of the campaign's
    padded-nsamps ladder ({2^k, 3*2^(k-1)}, campaign/buckets.py
    :bucket_nsamps), so contracts walk the pad targets jobs bucket to."""
    from ..campaign.buckets import bucket_nsamps

    rungs: list[int] = []
    n = int(base_nsamps)
    while len(rungs) < count:
        r = bucket_nsamps(n)
        rungs.append(r)
        n = r + 1
    return rungs


def _fdas_variant(ctx, overrides: dict):
    """The FDAS search's template geometry at the search context's FFT
    size, from the FDAS search's own defaults (pipeline/fdas.py)."""
    from ..fdas.templates import auto_segment, build_template_bank
    from ..pipeline.fdas import FdasConfig

    names = FdasConfig.__dataclass_fields__
    cfg = FdasConfig(**{k: v for k, v in overrides.items() if k in names})
    bank = build_template_bank(cfg.zmax, cfg.wmax, cfg.zstep, cfg.wstep)
    return replace(ctx, fdas_templates=min(int(bank.ntemplates), 64),
                   fdas_width=int(bank.width),
                   fdas_segment=int(cfg.segment or auto_segment(bank.width)))


def ladder_shape_ctxs(rung: int, overrides: dict | None = None,
                      bucket: tuple | None = None) -> list:
    """ShapeCtx variants for one ladder rung: the spsearch and search
    pipelines through their own plans, plus the FDAS, fused-DFT
    (``size`` at the largest FFT the dftspec kernel takes, where the
    rung's own is larger), streaming, subband and subband-matmul and
    2-bit variants, one family per hook family. ``bucket`` is (nchans,
    nbits, tsamp, fch1, foff), default :data:`LADDER_BASE_BUCKET`."""
    from ..perf.warmup import shape_ctx_for_bucket

    nchans, nbits, tsamp, fch1, foff = bucket or LADDER_BASE_BUCKET
    key = (nchans, nbits, int(rung), tsamp, fch1, foff)
    ov = dict(LADDER_OVERRIDES if overrides is None else overrides)
    ctx_sp = shape_ctx_for_bucket(key, "spsearch", ov)
    ctx_search = shape_ctx_for_bucket(key, "search", ov)
    ctxs = [ctx_sp, ctx_search, _fdas_variant(ctx_search, ov)]
    if ctx_search.fft_size > FUSED_DFT_MAX_SIZE:
        ctxs.append(shape_ctx_for_bucket(key, "search", dict(ov, size=FUSED_DFT_MAX_SIZE)))
    ctxs += [
        replace(ctx_sp, stream_chunk=1024),
        replace(ctx_search, subbands=4),
        replace(ctx_search, subbands=4, subband_matmul=True),
        # the device unpacker declines byte data: a 2-bit variant
        replace(ctx_sp, nbits=2),
    ]
    return ctxs


@dataclass
class LadderReport:
    findings: list[Finding] = field(default_factory=list)
    rungs: list[int] = field(default_factory=list)
    # program name -> rungs at which a hook-built variant ran
    coverage: dict[str, list[int]] = field(default_factory=dict)
    sync_warnings: dict[str, int] = field(default_factory=dict)


def audit_programs_ladder(specs=None, rungs: list[int] | None = None,
                          cfg: ContractConfig | None = None,
                          min_rungs: int | None = None,
                          overrides: dict | None = None,
                          bucket: tuple | None = None) -> LadderReport:
    """Contract-check all (or the given) registered programs at every rung
    of the campaign bucket ladder, each rebuilt through its ``param`` hook
    with the first context variant that accepts it; PSC106 flags programs
    the ladder covers at fewer than ``min_rungs`` rungs (default: every
    rung)."""
    if specs is None:
        from ..ops.registry import registered_programs

        specs = registered_programs()
    cfg = cfg or ContractConfig()
    rungs = list(rungs) if rungs is not None else ladder_rungs()
    min_rungs = len(rungs) if min_rungs is None else min(min_rungs, len(rungs))
    report = LadderReport(rungs=rungs)
    ctxs_by_rung = {r: ladder_shape_ctxs(r, overrides, bucket) for r in rungs}
    for spec in specs:
        covered: list[int] = []
        for rung in rungs:
            tag = f"@nsamps={rung}"
            sizes = None
            for ctx in ctxs_by_rung[rung]:
                try:
                    sizes = spec.param(ctx) if spec.param is not None else None
                except Exception as exc:
                    report.findings.append(_program_finding(
                        spec, "PSC105",
                        f"ShapeCtx hook raised at rung {rung}: {type(exc).__name__}: {exc}",
                        hint="hooks must decline (return None) contexts they "
                             "cannot build, never raise",
                        tag=tag,
                    ))
                    sizes = None
                    break
                if sizes is not None:
                    break
            if sizes is None:
                continue
            covered.append(rung)
            report.findings.extend(_audit_built(
                spec, lambda s=sizes: spec.build(torch.device(cfg.device), **s), cfg, tag=tag,
                sync_counts=report.sync_warnings))
        report.coverage[spec.name] = covered
        if len(covered) < min_rungs:
            report.findings.append(_program_finding(
                spec, "PSC106",
                f"bucket-ladder coverage {len(covered)}/{min_rungs} rungs (rungs "
                f"{rungs}): the program has no ShapeCtx hook (or its hook declines "
                "every ladder context), so campaign-shape drift is invisible to "
                "the contract engine",
                hint="give the registration a ShapeCtx hook that builds at bucket "
                     "geometry (ops/registry.py)",
            ))
    return report


def ladder_builds(param, rungs, overrides=None, bucket=None, ladder_rows=None):
    """(rung, sizes) for each rung whose contexts the ShapeCtx hook
    ``param`` accepts (the first accepting context of each rung, as the
    ladder audit takes it): what the kernel engine launches at.
    ``ladder_rows`` replaces the contexts' cap on a build's rows (0: the
    bucket's own)."""
    out = []
    for rung in rungs:
        for ctx in ladder_shape_ctxs(rung, overrides, bucket):
            if ladder_rows is not None:
                ctx = replace(ctx, ladder_rows=ladder_rows)
            sizes = param(ctx) if param is not None else None
            if sizes is not None:
                out.append((rung, sizes))
                break
    return out


__all__ = [
    "ContractConfig",
    "ContractReport",
    "F64_ACCUMULATORS",
    "LadderReport",
    "OpRecorder",
    "audit_program",
    "audit_programs",
    "audit_programs_ladder",
    "ladder_builds",
    "ladder_rungs",
    "ladder_shape_ctxs",
]
