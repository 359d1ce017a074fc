"""Per-stage roofline accounting (the JAX package's perf/roofline.py): one
stage taxonomy, ``unpack / dedisperse / spectrum_chain / resample /
harmonics / peaks / fdas / fold / other``, classifies the registry's
programs (:func:`stage_for_program`), so that a microbenchmark report and
a ratchet failure name the same buckets.

Roofline fields: device seconds are measured; FLOPs and bytes are the
caller's analytic counts. Against the card's peak FLOP/s and memory rate
(:func:`device_peaks`) each stage gets achieved rates, arithmetic
intensity, the share of the roofline it reaches and the bound the model
assigns. The port knows one card, the H100, at NVIDIA's data-sheet
figures for the SXM part at its 700 W limit (67 TFLOP/s in float32
outside the tensor cores, 3.35 TB/s of HBM); chip_smoke.py divides by the
same two numbers. The JAX package's TPU rows do not apply here.
"""

from __future__ import annotations

STAGES = (
    "unpack",
    "dedisperse",
    "spectrum_chain",
    "resample",
    "harmonics",
    "peaks",
    "fdas",
    "fold",
    "other",
)

# program-name fragments -> stage, first match wins (checked against the
# full registered name, e.g. "ops.dedisperse.subband_stage1_matmul" or
# "kernels.harmpeaks")
_PROGRAM_STAGE_RULES = (
    ("unpack", "unpack"),
    ("dedisperse", "dedisp"),
    ("dedisperse", "subband_stage"),
    # before "harmonic"/"correlate": the FDAS programs book as their own
    # correlation stage
    ("fdas", "fdas"),
    ("harmonics", "harmonic_sums"),
    ("peaks", "peaks"),
    ("resample", "resample"),
    ("spectrum_chain", "spectrum."),
    ("spectrum_chain", "specchain"),
    ("spectrum_chain", "interbin"),
    ("spectrum_chain", "dftspec"),
    ("spectrum_chain", "rednoise"),
    ("spectrum_chain", "zap"),
    ("spectrum_chain", "fft"),
    ("fold", "fold"),
    ("peaks", "singlepulse"),  # the sp chain ends in the events' compaction
    ("peaks", "boxcar"),
    ("peaks", "spchain"),
    ("peaks", "streaming"),
    ("peaks", "coincidence"),
    ("peaks", "correlate"),
    ("peaks", "ffa"),
)


def stage_for_program(name: str) -> str:
    """The roofline stage a registered program's time books under."""
    low = name.lower()
    for stage, frag in _PROGRAM_STAGE_RULES:
        if frag in low:
            return stage
    return "other"


# (device name substring, peak f32 FLOP/s, peak memory bytes/s):
# NVIDIA's data sheet for the H100 SXM at its 700 W limit
_DEVICE_PEAKS = (
    ("H100", 67e12, 3.35e12),
)


def device_peaks(device_kind: str) -> tuple[float, float] | None:
    """(peak f32 FLOP/s, peak memory bytes/s) for a device name
    (``torch.cuda.get_device_name``), or None when unknown (the CPU,
    other cards): roofline ratios then stay null rather than inventing a
    denominator."""
    low = (device_kind or "").lower()
    for frag, flops, bw in _DEVICE_PEAKS:
        if frag.lower() in low:
            return flops, bw
    return None


def roofline_fields(
    seconds: float,
    flops: float | None,
    nbytes: float | None,
    device_kind: str,
) -> dict:
    """The per-stage roofline record: achieved rates, arithmetic
    intensity, fraction-of-peak against the device roofline, and the
    bound the roofline model assigns. ``flops``/``bytes`` of None (or
    zero seconds) leave the derived fields null — absent attribution
    is visible, never faked."""
    out: dict = {
        "device_s": round(float(seconds), 6),
        "flops": None if flops is None else float(flops),
        "bytes": None if nbytes is None else float(nbytes),
        "achieved_flops_per_s": None,
        "achieved_bytes_per_s": None,
        "intensity_flops_per_byte": None,
        "peak_fraction": None,
        "bound": None,
    }
    if seconds <= 0:
        return out
    if flops:
        out["achieved_flops_per_s"] = round(flops / seconds, 3)
    if nbytes:
        out["achieved_bytes_per_s"] = round(nbytes / seconds, 3)
    if flops and nbytes:
        out["intensity_flops_per_byte"] = round(flops / nbytes, 6)
    peaks = device_peaks(device_kind)
    if peaks is None:
        return out
    peak_flops, peak_bw = peaks
    # the roofline: attainable FLOP/s at this intensity is
    # min(peak_flops, intensity * peak_bw); the binding resource is
    # whichever limit is lower
    if flops and nbytes:
        intensity = flops / nbytes
        ridge = peak_flops / peak_bw
        out["bound"] = "compute" if intensity >= ridge else "memory"
        attainable = min(peak_flops, intensity * peak_bw)
        out["peak_fraction"] = round((flops / seconds) / attainable, 4)
    elif nbytes:
        out["bound"] = "memory"
        out["peak_fraction"] = round((nbytes / seconds) / peak_bw, 4)
    elif flops:
        out["bound"] = "compute"
        out["peak_fraction"] = round((flops / seconds) / peak_flops, 4)
    return out


def stage_roofline(
    stage_profile: dict,
    stage_flops: dict | None,
    device_kind: str,
) -> dict:
    """The ``stages`` section of a report: ``stage_profile`` maps stage ->
    (device seconds, bytes), ``stage_flops`` maps stage -> analytic FLOPs
    (missing stages stay null)."""
    out = {}
    for stage, (secs, nbytes) in sorted(stage_profile.items()):
        flops = (stage_flops or {}).get(stage)
        out[stage] = roofline_fields(
            secs, flops, nbytes if nbytes else None, device_kind
        )
    return out
