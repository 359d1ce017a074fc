"""Per-stage divergence harness: NumPy-f64 oracle of the reference chain,
and the port's own stages held against it (the port's copy of the JAX
package's tools/divergence.py; the oracle is that module's, unchanged).

Every ``oracle_*`` function re-derives one stage of the reference worker
(src/pipeline_multi.cu:144-243 of the reference) in float64 NumPy,
following the CUDA kernels' exact index math and operation order
(src/kernels.cu). The harness serves two purposes:

1. locate which stage a candidate's S/N delta enters (compare the port's
   f32 stages, on the card or the CPU, stage by stage against the
   oracle): :func:`compare_trial` runs ops/rednoise.py's running median
   and whitening, ops/spectrum.py's ``form_power``, ``form_interpolated``
   and ``spectrum_stats``, ``torch.fft``, the resample kernel through
   ops/resample.py's ``resample_rows`` and ops/harmonics.py's sums on
   ``device``;
2. bound the reference run's own f32 error (compare the oracle's final
   S/N against a golden overview.xml) — the residual that no f32
   implementation can close.

Run as a module for the report (the card unless ``--device cpu``):

    python -m peasoup_tpu_torch.tools.divergence --fil tutorial.fil \\
        [--dm 239.3756] [--acc 0.0] [--device cpu]

After the stage rows it prints each S/N level against the standard
:func:`level_standard` applies: the same S/N > 9 membership as the oracle
and max |dS/N| below 5e-3.
"""

from __future__ import annotations

import numpy as np

# dedisp's generate_delay_table constant (the library uses the rounded
# 4.15e3 with a comment noting the more precise 4.148741601e3; peasoup
# links against dedisp, so candidate parity REQUIRES the rounded value).
DEDISP_DELAY_CONSTANT = 4.15e3


def oracle_delay_table(
    f0: float, df: float, nchans: int, dt: float,
    constant: float = DEDISP_DELAY_CONSTANT,
) -> np.ndarray:
    """dedisp generate_delay_table, bit-faithful.

    The library computes ``a = 1.f/(f0+c*df); b = 1.f/f0`` and the
    difference of squares in f32, then scales by the f64 quotient
    ``constant/dt`` and rounds once to the f32 table entry.
    """
    f0 = np.float32(f0)
    df = np.float32(df)
    c = np.arange(nchans, dtype=np.float32)
    a = (np.float32(1.0) / (f0 + c * df)).astype(np.float32)
    b = np.float32(1.0) / f0
    diff2 = (a * a - b * b).astype(np.float32)
    return (
        np.float64(constant) / np.float64(np.float32(dt)) * diff2.astype(np.float64)
    ).astype(np.float32)


def oracle_delay_samples(dm_list: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Whole-sample delays: round-half-even of the F32 product
    ``dm * delay_table[c]`` (the kernel's __float2uint_rn)."""
    prod = (
        np.asarray(dm_list, np.float32)[:, None] * np.abs(table)[None, :]
    ).astype(np.float32)
    return np.rint(prod).astype(np.int32)


def oracle_max_delay(dm_max: float, table: np.ndarray) -> int:
    """dedisp plan max_delay: floor(dm_max * table[-1] + 0.5) with the
    product in f32 (both operands are f32 in the library)."""
    prod = np.float32(np.float32(dm_max) * np.abs(table)[-1])
    return int(np.floor(np.float64(prod) + 0.5))


def oracle_dedisperse(
    data: np.ndarray,  # (nsamps, nchans) unpacked u8
    delays: np.ndarray,  # (nchans,) int
    out_n: int,
    killmask: np.ndarray | None = None,
) -> np.ndarray:
    """Channel sum at integer per-channel delays, f64 (sums of 8-bit
    samples are exact in both f32 and f64)."""
    nsamps, nchans = data.shape
    out = np.zeros(out_n, dtype=np.float64)
    for c in range(nchans):
        if killmask is not None and not killmask[c]:
            continue
        d = int(delays[c])
        out += data[d : d + out_n, c].astype(np.float64)
    return out


# ---- rednoise (Heimdall median cascade, kernels.cu:860-1010) ----------


def oracle_median_scrunch5(x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    if n == 1:
        return x.copy()
    if n == 2:
        return np.array([0.5 * (x[0] + x[1])])
    if n in (3, 4):
        return np.array([np.median(x)])  # median4 = mean of central two
    m = n // 5
    return np.median(x[: m * 5].reshape(m, 5), axis=1)


def oracle_linear_stretch(x: np.ndarray, out_count: int) -> np.ndarray:
    """linear_stretch_functor: f32 step/position math, values in f64."""
    in_count = x.shape[0]
    step = np.float32(in_count - 1) / np.float32(out_count - 1)
    pos = (np.arange(out_count, dtype=np.float32) * step).astype(np.float32)
    j = pos.astype(np.int32)
    frac = (pos - j.astype(np.float32)).astype(np.float32)
    j1 = np.minimum(j + 1, in_count - 1)
    out = x[j].copy()
    m = frac > np.float32(1e-5)
    out[m] = x[j][m] + frac[m].astype(np.float64) * (x[j1][m] - x[j][m])
    return out


def oracle_running_median(amp: np.ndarray, pos5: int, pos25: int) -> np.ndarray:
    size = amp.shape[0]
    med5 = oracle_median_scrunch5(amp)
    med25 = oracle_median_scrunch5(med5)
    med125 = oracle_median_scrunch5(med25)
    s5 = oracle_linear_stretch(med5, size)
    s25 = oracle_linear_stretch(med25, size)
    s125 = oracle_linear_stretch(med125, size)
    idx = np.arange(size)
    return np.where(idx < pos5, s5, np.where(idx < pos25, s25, s125))


def oracle_whiten(x: np.ndarray, pos5: int, pos25: int) -> np.ndarray:
    """rfft -> |.| -> running median -> divide, bins 0-4 zeroed
    (pipeline_multi.cu:174-186, kernels.cu:1013-1034)."""
    fser = np.fft.rfft(x)
    med = oracle_running_median(np.abs(fser), pos5, pos25)
    out = fser / med
    out[:5] = 0.0
    return out


# ---- spectrum / stats / resample / harmonics --------------------------


def oracle_interbin(fser: np.ndarray) -> np.ndarray:
    """bin_interbin_series_kernel (kernels.cu:231-252)."""
    re = fser.real
    im = fser.imag
    re_l = np.concatenate([[0.0], re[:-1]])
    im_l = np.concatenate([[0.0], im[:-1]])
    ampsq = re * re + im * im
    ampsq_d = 0.5 * ((re - re_l) ** 2 + (im - im_l) ** 2)
    return np.sqrt(np.maximum(ampsq, ampsq_d))


def oracle_stats(s: np.ndarray) -> tuple[float, float, float]:
    mean = float(np.mean(s))
    rms = float(np.sqrt(np.mean(s * s)))
    return mean, rms, float(np.sqrt(rms * rms - mean * mean))


def oracle_resample(xd: np.ndarray, acc: float, tsamp: float) -> np.ndarray:
    """resample_kernelII (kernels.cu:314-346): gather at
    rn(idx + idx*af*(idx-size)), af = a*tsamp/2c in f64."""
    size = xd.shape[0]
    af = (np.float64(np.float32(acc)) * tsamp) / (2 * 299792458.0)
    idx = np.arange(size, dtype=np.float64)
    src = np.rint(idx + idx * af * (idx - size)).astype(np.int64)
    return xd[np.clip(src, 0, size - 1)]


def oracle_harm_levels(sn: np.ndarray, nharms: int = 4) -> list[np.ndarray]:
    """harmonic_sum_kernel (kernels.cu:34-100): cumulative gathers at
    (int)(idx*frac+0.5), level h scaled by rsqrt(2**h)."""
    size = sn.shape[0]
    idx = np.arange(size, dtype=np.float64)
    val = sn.copy()
    out = []
    for h in range(1, nharms + 1):
        denom = 2 << (h - 1)  # 2, 4, 8, 16
        for num in range(1, denom, 2):
            g = (idx * (num / denom) + 0.5).astype(np.int64)  # C trunc
            val = val + sn[g]
        out.append(val * (2.0 ** (-h / 2.0)))
    return out


def oracle_cluster_max(level: np.ndarray, bin_idx: int, gap: int = 31) -> float:
    lo = max(0, bin_idx - gap)
    return float(level[lo : bin_idx + gap + 1].max())


def oracle_search_trial(
    tim: np.ndarray,
    size: int,
    tsamp: float,
    accs: list[float],
    pos5: int,
    pos25: int,
    nharms: int = 4,
) -> dict:
    """The full per-DM-trial oracle; returns every stage for compare."""
    x = tim[:size].astype(np.float64)
    fser = oracle_whiten(x, pos5, pos25)
    s0 = oracle_interbin(fser)
    mean, rms, std = oracle_stats(s0)
    xd = np.fft.irfft(fser, n=size)
    per_acc = {}
    for a in accs:
        xr = oracle_resample(xd, a, tsamp)
        f = np.fft.rfft(xr)
        sn = (oracle_interbin(f) - mean) / std
        levels = [sn] + oracle_harm_levels(sn, nharms)
        per_acc[float(a)] = {"xr": xr, "sn": sn, "levels": levels}
    return {
        "fser": fser,
        "s0": s0,
        "mean": mean,
        "rms": rms,
        "std": std,
        "xd": xd,
        "acc": per_acc,
    }


# ---- report ----------------------------------------------------------


def _relerr(a: np.ndarray, b: np.ndarray, floor: float = 1e-3) -> float:
    """max |a-b| / max(|b|, floor*rms(b)) — per-bin relative error with
    tiny-denominator bins measured against the RMS scale instead."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    scale = np.maximum(np.abs(b), floor * np.sqrt(np.mean(b * b)) + 1e-30)
    return float(np.max(np.abs(a - b) / scale))


# the standard the port's S/N levels are held to against the oracle: the
# same membership above the threshold, and |dS/N| below the bound
STANDARD_SNR = 9.0
STANDARD_ABS = 5e-3


def compare_trial(
    fil_path: str, dm: float, accs: list[float] | None = None, device="cuda"
):
    """Stage-by-stage rel-err of the port's f32 stages on ``device`` vs the
    f64 oracle for one DM trial of ``fil_path`` searched with the golden
    flags. Returns (rows, oracle, meta); ``meta["levels"]`` maps each
    acceleration to the port's five S/N levels as f64 numpy arrays."""
    import torch

    from ..device import resolve_device
    from ..io.sigproc import read_filterbank
    from ..ops.harmonics import harmonic_sums
    from ..ops.rednoise import running_median, whiten_fseries
    from ..ops.resample import accel_factor, resample_rows
    from ..ops.spectrum import form_interpolated, form_power, spectrum_stats
    from ..plan.fft_plan import choose_fft_size

    dev = resolve_device(device)
    fil = read_filterbank(fil_path)
    h = fil.header
    table = oracle_delay_table(h.fch1, h.foff, h.nchans, h.tsamp)
    max_d = oracle_max_delay(dm, table)  # this trial's span for info
    delays = oracle_delay_samples(np.array([dm]), table)[0]
    out_n = h.nsamples - int(
        oracle_delay_samples(np.array([dm]), table).max()
    )
    tim = oracle_dedisperse(fil.data, delays, out_n)
    size = choose_fft_size(out_n)
    bw = 1.0 / (size * h.tsamp)
    pos5 = int(0.05 / bw)
    pos25 = int(0.5 / bw)
    accs = accs if accs is not None else [0.0]

    oracle = oracle_search_trial(tim, size, h.tsamp, accs, pos5, pos25)

    def host(t) -> np.ndarray:
        return t.cpu().numpy()

    # ours, stage by stage on the device (f32)
    x32 = torch.as_tensor(tim[:size].astype(np.float32), device=dev)
    fser = whiten_fseries(x32, pos5=pos5, pos25=pos25)
    med = running_median(form_power(torch.fft.rfft(x32)), pos5=pos5, pos25=pos25)
    s0 = form_interpolated(fser)
    mean, _, std = spectrum_stats(s0)
    xd = torch.fft.irfft(fser, n=size)

    o_med = oracle_running_median(
        np.abs(np.fft.rfft(tim[:size].astype(np.float64))), pos5, pos25
    )
    rows = [
        ("median", _relerr(host(med), o_med)),
        ("whiten.re", _relerr(host(fser.real), oracle["fser"].real)),
        ("interbin0", _relerr(host(s0), oracle["s0"])),
        ("mean", abs(float(mean) - oracle["mean"]) / abs(oracle["mean"])),
        ("std", abs(float(std) - oracle["std"]) / abs(oracle["std"])),
        ("irfft", _relerr(host(xd), oracle["xd"])),
    ]
    xd_rows = xd[None].contiguous()
    row_dm = torch.zeros(1, dtype=torch.int32, device=dev)
    levels_of = {}
    for a in accs:
        afs = torch.as_tensor(
            accel_factor(np.array([a]), h.tsamp).astype(np.float32), device=dev
        )
        xr = resample_rows(xd_rows, row_dm, afs)[0]
        f = torch.fft.rfft(xr)
        sn = (form_interpolated(f) - mean) / std
        levels = [sn, *harmonic_sums(sn, nharms=4)]
        oa = oracle["acc"][float(a)]
        rows.append((f"resample[{a}]", _relerr(host(xr), oa["xr"])))
        for lvl in range(5):
            rows.append(
                (
                    f"snr l{lvl}[{a}]",
                    _relerr(host(levels[lvl]), oa["levels"][lvl], floor=1.0),
                )
            )
        levels_of[float(a)] = [host(v).astype(np.float64) for v in levels]
    meta = {"size": size, "bw": bw, "max_delay": max_d, "levels": levels_of}
    return rows, oracle, meta


def level_standard(oracle: dict, meta: dict) -> list[tuple[str, float, bool]]:
    """(name, max |dS/N|, same S/N > 9 membership) of each acceleration's
    five S/N levels against the oracle's: a level meets the standard
    where the membership is the same and max |dS/N| < 5e-3."""
    out = []
    for a, levels in meta["levels"].items():
        for lvl, ours in enumerate(levels):
            ref = oracle["acc"][a]["levels"][lvl]
            out.append((
                f"snr l{lvl}[{a}]",
                float(np.max(np.abs(ours - ref))),
                bool(np.array_equal(ours > STANDARD_SNR, ref > STANDARD_SNR)),
            ))
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fil", required=True, help="the filterbank to search")
    p.add_argument("--dm", type=float, default=239.3756103515625)
    p.add_argument("--acc", type=float, nargs="*", default=[0.0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the port's stages run (default: the CUDA device)")
    args = p.parse_args(argv)
    rows, oracle, meta = compare_trial(args.fil, args.dm, args.acc, device=args.device)
    print(f"size={meta['size']} bw={meta['bw']:.6f} max_delay={meta['max_delay']}")
    for name, err in rows:
        print(f"  {name:>16s}  relerr {err:9.3e}")
    for name, dsnr, same in level_standard(oracle, meta):
        ok = same and dsnr < STANDARD_ABS
        print(f"  {name:>16s}  max|dS/N| {dsnr:9.3e}  S/N>{STANDARD_SNR:g} "
              f"membership {'same' if same else 'DIFFERS'}"
              f"{'' if ok else '  (outside the standard)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
