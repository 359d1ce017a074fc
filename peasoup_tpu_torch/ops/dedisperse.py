"""Incoherent dedispersion: out[d, t] = sum_c kill[c] * x[t + delay[d, c], c].

The reference delegates this to the external ``dedisp`` CUDA library
(reference: include/transforms/dedisperser.hpp:98-113); the JAX package
runs it as a channel scan (ops/dedisperse.py) or its Pallas kernel. Here
:func:`dedisperse` launches the hand-written kernel
(csrc/dedisperse.cu) for CUDA tensors and runs the plain version
:func:`dedisperse_block` for CPU tensors.

Output matches the reference's u8 trials: channel sums of <=8-bit
samples are exact integers in f32, so the summation order cannot change
them, then ``scale`` (:func:`output_scale`), round half to even and a
clip to [0, 255]. The kernel sums the same integers in integer lanes.

The delays and the kill mask are host arrays, the plan's: the wrapper
checks them and builds the kernel's per-block tables on the host
(:func:`_tables`), uploads them once for a plan and keeps them
(:func:`_device_tables`), so a call reads nothing back from the card.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..device import check, stream_ptr
from ..utils.trace import trace_count

# the kernel's block (csrc/dedisp_map.cuh): output samples, DM trials, the
# widest channel chunk as a power of two, and the shared memory it may take
TILE, TRIALS, MAX_LOG_CHUNK = 2048, 16, 4
SMEM_BYTES = 227 * 1024


def unpack_fil_device(
    raw: torch.Tensor, *, nbits: int, nsamps: int, nchans: int
) -> torch.Tensor:
    """Unpack sub-byte filterbank samples on the tensor's device
    (LSB-first within each byte, matching io.sigproc.unpack_bits and
    libdedisp's sub-word extraction): (nbytes,) u8 -> (nsamps, nchans)
    u8. The host uploads the packed bytes, 8/nbits times fewer than the
    samples."""
    per = 8 // nbits
    shifts = torch.arange(per, dtype=torch.uint8, device=raw.device) * nbits
    mask = (1 << nbits) - 1
    w = torch.bitwise_and(torch.bitwise_right_shift(raw[:, None], shifts), mask)
    return w.reshape(nsamps, nchans)


def fil_to_device(fil, device: torch.device) -> torch.Tensor:
    """A Filterbank's samples as a (nsamps, nchans) u8 tensor on
    ``device``, uploading packed bytes when the file had sub-byte
    samples."""
    raw = getattr(fil, "raw", None)
    if raw is not None and fil.nbits in (1, 2, 4):
        trace_count("upload.bytes", raw.nbytes)
        return unpack_fil_device(
            torch.from_numpy(raw).to(device), nbits=fil.nbits,
            nsamps=fil.nsamps, nchans=fil.nchans,
        )
    trace_count("upload.bytes", fil.data.nbytes)
    return torch.tensor(fil.data, device=device)


def output_scale(nbits: int, nchans_kept: int) -> float:
    """Data-independent factor keeping worst-case channel sums inside u8.

    1.0 whenever raw sums already fit (e.g. 2-bit x 64 channels = 192),
    else shrink so the maximum possible sum maps to 255.
    """
    max_sum = (2**nbits - 1) * max(1, nchans_kept)
    return 1.0 if max_sum <= 255 else 255.0 / max_sum


def _scaled(acc: torch.Tensor, scale: float) -> torch.Tensor:
    if scale != 1.0:
        acc = acc * torch.tensor(scale, dtype=torch.float32, device=acc.device)
    return acc


def _quantize(acc: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(_scaled(acc, scale)), 0, 255).to(torch.uint8)


def dedisperse_block(
    fil_tc: torch.Tensor,  # (T, C) u8 filterbank samples
    delays,  # (D, C) int per-trial per-channel delay in samples
    killmask,  # (C,) 1 = keep
    *,
    out_nsamps: int,
    scale: float = 1.0,
) -> torch.Tensor:
    """The plain version: for each trial, channel rows shifted by their
    delay are added in ascending channel order, then scaled, rounded and
    clipped to u8. Returns (D, out_nsamps) u8."""
    x_ct = fil_tc.t().to(torch.float32).contiguous()
    x_ct = x_ct * torch.as_tensor(killmask, device=fil_tc.device).to(torch.float32)[:, None]
    dl = np.asarray(delays)
    out = torch.zeros(
        (dl.shape[0], out_nsamps), dtype=torch.float32, device=fil_tc.device
    )
    for d in range(dl.shape[0]):
        for c in range(dl.shape[1]):
            s = int(dl[d, c])
            out[d] += x_ct[c, s : s + out_nsamps]
    return _quantize(out, scale)


def _host(a, name: str) -> np.ndarray:
    """A host array (numpy, or a CPU tensor) as numpy; the kernel's tables
    are built on the host, so a table on the card would stall it."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name} must be a host array (the plan's), not on {a.device}")
        return a.numpy()
    return np.asarray(a)


def _pitch_words(max_spread: int) -> int:
    """csrc/dedisp_map.cuh:pitch_words."""
    return ((TILE + max_spread + 4 + 3) // 4) | 1


def _tables(delays: np.ndarray, chans: np.ndarray, nchans: int) -> dict:
    """The kernel's per-block tables (csrc/dedisp_map.cuh). The band is cut
    into chunks of 2^log_chunk neighbouring channels from multiples of that
    width, and the chunks that hold a kept channel are the kernel's:
    ``chunks`` gives each one's first channel and the mask of its kept
    channels. For each tile of TRIALS DM trials and each chunk, the least
    delay ``lo`` over the chunk's kept channels and the spread of the rest
    above it, and each trial's delay on each channel less ``lo`` as 16 bits
    (0 on a killed channel, which the kernel never reads), a record of
    TRIALS per channel. Chunks are as wide as shared memory allows, up to
    16 channels."""
    ndm = delays.shape[0]
    ntiles = -(-ndm // TRIALS)
    kept = np.zeros(nchans, bool)
    kept[chans] = True
    # padding trials repeat the last one, which moves no tile's least or
    # largest delay; the kernel writes no padding trial
    d = delays.astype(np.int32, copy=False)
    d = np.concatenate([d, np.repeat(d[-1:], ntiles * TRIALS - ndm, axis=0)])
    for log_chunk in range(MAX_LOG_CHUNK, -1, -1):
        chunk = 1 << log_chunk
        nraw = -(-nchans // chunk)
        pad = nraw * chunk - nchans
        keep = np.pad(kept, (0, pad)).reshape(nraw, chunk)
        live = np.flatnonzero(keep.any(axis=1))
        keep = keep[live]
        nchunks = len(live)
        dk = np.pad(d, ((0, 0), (0, pad))).reshape(ntiles, TRIALS, nraw, chunk)[:, :, live]
        on = keep[None, None]
        lo = dk.min(axis=(1, 3), where=on, initial=np.iinfo(np.int32).max)
        spread = dk.max(axis=(1, 3), where=on, initial=0) - lo
        rel = np.where(on, dk - lo[:, None, :, None], 0).transpose(0, 2, 3, 1)
        max_spread = int(spread.max()) if spread.size else 0
        pitch = _pitch_words(max_spread)
        # the kernel's shared memory: the records, then the larger of the
        # window and the output tile
        smem = (2 << MAX_LOG_CHUNK) * TRIALS + max(chunk * pitch * 4, TRIALS * TILE + 4)
        if max_spread <= 0xFFFF and smem <= SMEM_BYTES:
            mask = (keep << np.arange(chunk)).sum(axis=1)
            return dict(
                chunks=np.stack([live * chunk, mask], axis=-1).astype(np.int32, order="C"),
                rel=np.ascontiguousarray(rel, dtype=np.uint16),
                lo_spread=np.stack([lo, spread], axis=-1).astype(np.int32, order="C"),
                log_chunk=log_chunk, nchunks=nchunks, pitch=pitch,
            )
    raise ValueError(
        f"the delays of one DM tile spread over {max_spread} samples on one "
        "channel: past what the dedisperse kernel stages"
    )


def _count_chunks(tab: dict, ndm: int, out_nsamps: int, wide: bool) -> None:
    """Counters ``dedisp.chunks``, the (DM tile, chunk, time tile) windows
    a launch on tables ``tab`` stages, and ``dedisp.chunks_wide``, those
    staged with 16-byte loads (all where ``wide``, as the kernel's entry
    decides it, else none)."""
    n = -(-ndm // TRIALS) * tab["nchunks"] * -(-out_nsamps // TILE)
    trace_count("dedisp.chunks", n)
    trace_count("dedisp.chunks_wide", n if wide else 0)


def dedisperse(
    fil_tc: torch.Tensor,
    delays,
    killmask,
    out_nsamps: int,
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    """All DM trials at once; bitwise equal to :func:`dedisperse_block`.
    ``delays`` (D, C) and ``killmask`` (C,) are host arrays (the plan's),
    checked and turned into the kernel's tables on the host. A CUDA
    ``fil_tc`` goes through the dedisperse kernel, a CPU one through the
    plain version. Under a profiler a launch counts the chunks it stages
    (:func:`_count_chunks`)."""
    delays = _host(delays, "delays")
    killmask = _host(killmask, "killmask")
    if fil_tc.device.type == "cpu":
        return dedisperse_block(
            fil_tc, delays, killmask, out_nsamps=out_nsamps, scale=scale
        )
    check(fil_tc, "fil_tc", torch.uint8, 2)
    t_in, nchans = fil_tc.shape
    ndm = delays.shape[0]
    if delays.ndim != 2 or delays.shape[1] != nchans or killmask.shape != (nchans,):
        raise ValueError(
            f"shape mismatch: fil {tuple(fil_tc.shape)}, delays "
            f"{delays.shape}, killmask {killmask.shape}"
        )
    if not ((killmask == 0) | (killmask == 1)).all():
        raise ValueError("killmask must hold 0 and 1 only")
    if ndm and (int(delays.min()) < 0 or int(delays.max()) + out_nsamps > t_in):
        raise ValueError("delays reach outside the filterbank")
    chans = np.flatnonzero(killmask).astype(np.int32)
    if len(chans) * 255 >= 1 << 24:
        raise ValueError("more kept channels than f32 sums hold exactly")
    out = torch.empty((ndm, out_nsamps), dtype=torch.uint8, device=fil_tc.device)
    if ndm == 0 or out_nsamps <= 0:
        return out
    tab, buf, geom = _device_tables(
        delays.astype(np.int32, copy=False).tobytes(), delays.shape, chans.tobytes(),
        fil_tc.device,
    )
    _count_chunks(tab, ndm, out_nsamps,
                  kernels.dedisperse_wide_staging(tab["log_chunk"], nchans, fil_tc.data_ptr()))
    base = buf.data_ptr()
    kernels.launch(
        "dedisperse", fil_tc.data_ptr(), t_in, nchans, base + geom["chunks_at"],
        len(chans), base, base + geom["lo_spread_at"], tab["log_chunk"],
        tab["nchunks"], tab["pitch"], out.data_ptr(), ndm, out_nsamps,
        float(scale), int(scale != 1.0), stream_ptr(fil_tc.device),
        shape=(t_in, nchans, ndm, out_nsamps),
    )
    return out


@lru_cache(maxsize=4)
def _device_tables(delay_bytes: bytes, shape: tuple, chan_bytes: bytes, device):
    """:func:`_tables` of the delays and kept channels (given as bytes, so
    a plan's tables are built and uploaded once a process), and one device
    buffer of them: the records (16-byte aligned), then lo/spread, then the
    chunks; and the byte offsets of the last two."""
    delays = np.frombuffer(delay_bytes, dtype=np.int32).reshape(shape)
    tab = _tables(delays, np.frombuffer(chan_bytes, dtype=np.int32), shape[1])
    rel32 = tab["rel"].reshape(-1).view(np.int32)
    lo_spread = tab["lo_spread"].reshape(-1)
    buf = torch.from_numpy(np.concatenate([rel32, lo_spread, tab["chunks"].reshape(-1)])).to(device)
    geom = dict(lo_spread_at=4 * rel32.size, chunks_at=4 * (rel32.size + lo_spread.size))
    return tab, buf, geom


def dedisperse_host(
    fil_tc: torch.Tensor,
    delays,
    killmask,
    out_nsamps: int,
    *,
    scale: float = 1.0,
    block: int = 16,
) -> np.ndarray:
    """Trials in host RAM, dedispersed segment by segment through
    :func:`dedisperse` (the kernel for a CUDA ``fil_tc``), so the device
    never holds more than one segment's outputs: the JAX package's
    host-resident ``dedisperse`` (its ops/dedisperse.py:843-871), for
    surveys whose trials do not fit the card. Returns (D, out_nsamps) u8."""
    delays = _host(delays, "delays")
    seg = -(-max(block, 1_000_000_000 // max(1, out_nsamps)) // block) * block
    out = np.empty((delays.shape[0], out_nsamps), dtype=np.uint8)
    for s0 in range(0, delays.shape[0], seg):
        # audit: ignore[PSA001] -- trials in host RAM: one copy a segment
        out[s0 : s0 + seg] = dedisperse(
            fil_tc, delays[s0 : s0 + seg], killmask, out_nsamps, scale=scale
        ).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# The banded-matmul engine and two-stage subband dedispersion: the JAX
# package's XLA programs (its ops/dedisperse.py:359-840) as plain torch.
#
# For a block of adjacent DM trials the per-channel delays decompose as
# delay[d, c] = base[c] + resid[d, c], base the block minimum, and with the
# one-hot operand W[d, c, v] = (resid[d, c] == v) the shift-and-sum is
#
#     out[d, t] = sum_{c, v} W[d, c, v] * x[c, t + base[c] + v],
#
# computed as ``band`` shifted products W[:, :, v] @ X[:, v:v+T] (X[:, v:v+T]
# is a strided view: nothing is copied) at f32 precision pinned to
# "highest", so neither TF32 nor a caller's setting rounds the operands.
# Products are x*1 or x*0 and channel sums of <=8-bit samples are exact
# integers in f32, so for integer inputs the result is bitwise the gather's
# whatever the order of the sum; f32 filterbanks may differ by association.
#
# Every window these functions slice starts where the JAX package's
# dynamic_slice would start without clamping (its pads guarantee it);
# :func:`_rows_at` asserts that rather than clamp quietly.
# ---------------------------------------------------------------------------

MATMUL_BAND_QUANT = 8  # the one-hot band rounds up to a multiple of this
MATMUL_BLOCK = 64  # DM trials per banded contraction


@contextmanager
def _exact_f32():
    """f32 matrix products at full precision for the duration."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def matmul_band(delays_block: np.ndarray, quant: int = MATMUL_BAND_QUANT) -> int:
    """The padded one-hot band of one DM-trial block: the largest
    per-channel delay spread across the block plus one, rounded up to
    ``quant``."""
    d = np.asarray(delays_block)
    spread = int((d.max(axis=0) - d.min(axis=0)).max()) + 1
    return -(-spread // quant) * quant


def banded_onehot(delays_block: np.ndarray, band: int,
                  device: torch.device) -> tuple[np.ndarray, torch.Tensor]:
    """(base (C,) i32, onehot (D, C, band) f32 on ``device``) for one trial
    block: the shift-selection operand of the banded contraction. The
    one-hot is made on ``device`` from the block's (D, C) residual delays,
    so the (D, C, band) operand is not sent from the host for every block."""
    d = np.asarray(delays_block, dtype=np.int64)
    base = d.min(axis=0)
    resid = torch.from_numpy(d - base[None, :]).to(device)
    onehot = (resid[:, :, None] == torch.arange(band, dtype=torch.int64, device=device)
              ).to(torch.float32)
    return base.astype(np.int32), onehot


def _rows_at(rows: torch.Tensor, starts, length: int) -> torch.Tensor:
    """rows[r, s_rj : s_rj + length] for each (r, j): rows (R, L) and
    ``starts`` (R, J) host ints -> (R, J, length). One gather over the
    unfolded (strided) view of ``rows``: no index array of the windows'
    size is built."""
    starts = np.asarray(starts, dtype=np.int64)
    assert starts.min(initial=0) >= 0 and starts.max(initial=0) + length <= rows.shape[-1], (
        "a window starts past what the pads cover"
    )
    view = rows.unfold(-1, length, 1)  # (R, L - length + 1, length)
    rix = torch.arange(rows.shape[0], device=rows.device)[:, None]
    return view[rix, torch.from_numpy(starts).to(rows.device)]


def banded_conv(xb: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """out[..., d, t] = sum_{c, v} onehot[..., d, c, v] * xb[..., c, t + v]:
    the valid correlation the JAX package runs as lax.conv_general_dilated,
    as ``band`` shifted products accumulated in f32 (leading axes batch).
    xb (..., C, T + band - 1) f32, onehot (..., D, C, band) f32."""
    band = onehot.shape[-1]
    t_out = xb.shape[-1] - band + 1
    w = onehot.movedim(-1, 0).contiguous()  # (band, ..., D, C)
    out = torch.zeros(
        (*onehot.shape[:-1][:-1], t_out), dtype=torch.float32, device=xb.device
    )
    acc = out.addmm_ if out.dim() == 2 else out.baddbmm_  # out += w[v] @ x_v
    with _exact_f32():
        for v in range(band):
            acc(w[v], xb[..., v : v + t_out])
    return out


def dedisperse_matmul(
    fil_tc: torch.Tensor,  # (T, C) u8/f32 filterbank on the device
    delays,  # (D, C) int per-trial per-channel delays
    killmask,
    out_nsamps: int,
    *,
    quantize: bool = True,
    scale: float = 1.0,
    block: int = MATMUL_BLOCK,
    band_quant: int = MATMUL_BAND_QUANT,
    chunk_bytes: int = 3_000_000_000,
) -> torch.Tensor:
    """All DM trials through the banded contraction, ``block`` trials at a
    time (the last block repeats its last trial, as the JAX package pads
    it); channels chunk when a block's f32 windows (C * (out + band) * 4
    bytes) would pass ``chunk_bytes``, with unquantized partials summed
    channel-ascending and quantized once. Returns (D, out_nsamps) u8
    (quantize) or f32, bitwise :func:`dedisperse_block` for integer
    inputs."""
    delays = np.asarray(_host(delays, "delays"), dtype=np.int32)
    killmask = np.asarray(_host(killmask, "killmask"))
    d, c = delays.shape
    blocks = []
    for lo in range(0, d, block):
        blk = delays[lo : lo + block]
        blocks.append((lo, lo + len(blk), matmul_band(blk, band_quant)))
    band_max = max(b for _, _, b in blocks)
    win_max = out_nsamps + band_max - 1
    cc = max(1, int(chunk_bytes // max(1, 4 * win_max)))
    if cc < c:
        acc = None
        for c0 in range(0, c, cc):
            part = dedisperse_matmul(
                fil_tc[:, c0 : c0 + cc], delays[:, c0 : c0 + cc],
                killmask[c0 : c0 + cc], out_nsamps, quantize=False, scale=1.0,
                block=block, band_quant=band_quant, chunk_bytes=chunk_bytes,
            )
            acc = part if acc is None else acc + part
        return _quantize(acc, scale) if quantize else _scaled(acc, scale)
    t_in = fil_tc.shape[0]
    t_need = int(delays.max()) + out_nsamps + band_max
    x_ct = fil_tc.t()
    if t_need > t_in:  # zero tail: only ever multiplied by one-hot zeros
        x_ct = torch.nn.functional.pad(x_ct, (0, t_need - t_in))
    kill = torch.from_numpy(killmask.astype(np.float32)).to(fil_tc.device)[:, None]
    outs = []
    for lo, hi, band in blocks:
        blk = delays[lo:hi]
        if hi - lo < block:  # repeat the last trial: one shape per band
            blk = np.concatenate([blk, np.repeat(blk[-1:], block - (hi - lo), axis=0)])
        base, onehot = banded_onehot(blk, band, fil_tc.device)
        xb = _rows_at(x_ct, base[:, None], out_nsamps + band - 1)[:, 0]
        xb = xb.to(torch.float32) * kill
        res = banded_conv(xb, onehot)[: hi - lo]
        outs.append(_quantize(res, scale) if quantize else _scaled(res, scale))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def subband_groups(
    delay_table: np.ndarray,  # (D, C) int per-trial per-channel delays
    nsub: int,
    max_smear: float,
    budgets: np.ndarray | None = None,
) -> list[tuple[int, int]]:
    """Greedy grouping of adjacent DM trials sharing one nominal DM for
    two-stage subband dedispersion (the dedisp library's scheme the
    reference links, dedisperser.hpp:25-31). Trial ``hi`` joins the group
    opened by trial ``lo`` while the worst-case intra-subband smear of
    substituting trial lo's channel shape, measured against each band's
    least delay, stays <= ``max_smear`` samples (or ``budgets[hi]``).
    ``max_smear=0`` gives singleton groups. Returns [lo, hi) spans."""
    D, C = delay_table.shape
    w = -(-C // nsub)
    groups = []
    lo = 0
    while lo < D:
        hi = lo + 1
        while hi < D:
            cap = max_smear if budgets is None else float(budgets[hi])
            err = 0
            for b in range(0, C, w):
                dl = delay_table[lo, b : b + w]
                dh = delay_table[hi, b : b + w]
                err = max(err, int(np.abs((dh - dh.min()) - (dl - dl.min())).max()))
                if err > cap:
                    break
            if err > cap:
                break
            hi += 1
        groups.append((lo, hi))
        lo = hi
    return groups


def subband_stage1(x_swt: torch.Tensor, kill_sw: np.ndarray, d1: np.ndarray,
                   out_len: int) -> torch.Tensor:
    """Stage 1 for G nominal DMs: s1[g, b, t] = sum_i kill[b, i] *
    x[b, i, t + d1[g, b, i]], channel-ascending in f32 within each band
    (the JAX package's _subband_stage1 scan, group-batched). x_swt
    (S, w, T) u8/f32, kill_sw (S, w) of 0 and 1, d1 (G, S, w) host ints
    -> (G, S, out_len) f32. A killed channel adds nothing (the scan adds
    x * 0)."""
    g = d1.shape[0]
    s_count, w, _ = x_swt.shape
    acc = torch.zeros((g, s_count, out_len), dtype=torch.float32, device=x_swt.device)
    for b in range(s_count):
        for i in range(w):
            if kill_sw[b, i]:
                acc[:, b] += _rows_at(x_swt[b, i][None], d1[:, b, i][None], out_len)[0]
    return acc


def subband_stage2(s1: torch.Tensor, rd: np.ndarray, out_nsamps: int) -> torch.Tensor:
    """Stage 2 for G groups of g_pad trials: out[g, j, t] = sum_b
    s1[g, b, t + rd[g, j, b]], band-ascending in f32 (the direct core with
    subbands as channels). s1 (G, S, L) f32, rd (G, g_pad, S) host ints ->
    (G, g_pad, out_nsamps) f32."""
    g, g_pad, s_count = rd.shape
    out = torch.zeros((g, g_pad, out_nsamps), dtype=torch.float32, device=s1.device)
    for b in range(s_count):
        out += _rows_at(s1[:, b], rd[:, :, b], out_nsamps)
    return out


def _band_of(resid: np.ndarray) -> int:
    """The one-hot band of a block of residual delays, rounded up to
    MATMUL_BAND_QUANT."""
    return -(-(int(resid.max()) + 1) // MATMUL_BAND_QUANT) * MATMUL_BAND_QUANT


def _onehot(resid: np.ndarray, band: int) -> np.ndarray:
    return (resid[..., None] == np.arange(band, dtype=resid.dtype)).astype(np.float32)


def subband_stage1_matmul(x_swt: torch.Tensor, kill_sw: np.ndarray, d1: np.ndarray,
                          out_len: int) -> torch.Tensor:
    """:func:`subband_stage1` as a banded contraction per band, the groups
    in the trial role (the JAX package's _stage1_matmul_batched): each
    band's rows, f32 and masked, are zero-padded by the band so every
    base-aligned window lies inside; bitwise the scan's for integer
    inputs."""
    g, s_count, w = d1.shape
    base1 = d1.min(axis=0)  # (S, w)
    r1 = d1 - base1[None]
    band = _band_of(r1)
    onehot = torch.from_numpy(_onehot(r1, band)).to(x_swt.device)  # (G, S, w, band)
    kill = torch.from_numpy(np.asarray(kill_sw, np.float32)).to(x_swt.device)
    out = torch.empty((g, s_count, out_len), dtype=torch.float32, device=x_swt.device)
    for b in range(s_count):
        rows = torch.nn.functional.pad(x_swt[b].to(torch.float32) * kill[b, :, None], (0, band))
        xb = _rows_at(rows, base1[b][:, None], out_len + band - 1)[:, 0]
        out[:, b] = banded_conv(xb, onehot[:, b])
    return out


def subband_stage2_matmul(s1: torch.Tensor, rd: np.ndarray, out_nsamps: int) -> torch.Tensor:
    """:func:`subband_stage2` as a banded contraction per group, the
    subbands in the channel role (the JAX package's
    _stage2_matmul_batched). ``rd``'s padding rows must repeat a real
    trial (edge padding): zero-delay rows would open the band."""
    g, g_pad, s_count = rd.shape
    base2 = rd.min(axis=1)  # (G, S)
    r2 = rd - base2[:, None, :]
    band = _band_of(r2)
    onehot = torch.from_numpy(_onehot(r2, band)).to(s1.device)  # (G, g_pad, S, band)
    rows = torch.nn.functional.pad(s1, (0, band)).reshape(g * s_count, -1)
    xb = _rows_at(rows, base2.reshape(-1, 1), out_nsamps + band - 1)[:, 0]
    return banded_conv(xb.reshape(g, s_count, -1), onehot)


def dedisperse_subband(
    fil_tc: torch.Tensor,  # (T, C) u8/f32 filterbank on the device
    delay_table,  # (D, C) int from DMPlan.delay_samples()
    killmask,
    out_nsamps: int,
    *,
    nsub: int,
    max_smear: float = 1.0,
    quantize: bool = True,
    scale: float = 1.0,
    to_host: bool = False,
    use_matmul: bool = False,
    budgets: np.ndarray | None = None,
):
    """Two-stage subband dedispersion of all trials (the JAX package's
    dedisperse_subband, its ops/dedisperse.py:662-840).

    Stage 1, once per nominal DM (the first trial of each group of
    :func:`subband_groups`), aligns the channels within each of ``nsub``
    bands to the band's least delay; stage 2 adds the nominal's bands at
    each trial's own band delays. The approximation replaces each trial's
    intra-band shape by its nominal's, which the grouping bounds to
    ``max_smear`` samples (0: bitwise the direct sum). ``use_matmul``
    runs both stages as banded contractions, bitwise the same for integer
    inputs. Groups are bucketed by their power-of-two padded height and
    batched so that a batch's stage-1 sums and stage-2 output stay near
    1 GB. Returns (D, out_nsamps) on the device, or numpy with
    ``to_host`` (one transfer a batch)."""
    delay_table = np.asarray(_host(delay_table, "delay_table"), dtype=np.int32)
    killmask = np.asarray(_host(killmask, "killmask"))
    if not ((killmask == 0) | (killmask == 1)).all():
        raise ValueError("killmask must hold 0 and 1 only")
    D, C = delay_table.shape
    # ceil(C / w) bands of w channels cover C for any nsub
    w = -(-C // max(1, min(nsub, C)))
    nsub = -(-C // w)
    cpad = w * nsub - C
    groups = subband_groups(delay_table, nsub, max_smear, budgets)

    # each band's reference is its least delay, so d1 >= 0
    band_of = np.minimum(np.arange(C) // w, nsub - 1)
    refdel = np.stack(
        [delay_table[:, b : b + w].min(axis=1) for b in range(0, C, w)], axis=1
    )  # (D, S)
    d1_all = delay_table - refdel[:, band_of]
    t1 = fil_tc.shape[0] - int(d1_all[[lo for lo, _ in groups]].max())
    # rint rounding can leave t1 a sample or two short of what stage 2
    # reads: pad the time axis with zeros to cover it (never read at
    # max_smear=0, where stage 2's index telescopes to t + delay < T)
    deficit = max(0, int(refdel.max()) + out_nsamps - t1)
    t1 += deficit
    nb1 = -(-t1 // 128) + 2
    t_need = fil_tc.shape[0] + deficit
    tpad = (-(-t_need // 128) + 3) * 128 - t_need
    x = torch.nn.functional.pad(fil_tc.t(), (0, deficit + tpad))
    if cpad:
        x = torch.nn.functional.pad(x, (0, 0, 0, cpad))
    x_swt = x.reshape(nsub, w, -1)  # (S, w, T)
    kill_sw = np.pad(killmask.astype(np.float32), (0, cpad)).reshape(nsub, w)
    out_len = nb1 * 128

    def g_pad_of(lo, hi):
        return 1 << (hi - lo - 1).bit_length() if hi - lo > 1 else 1

    outs = []
    i = 0
    while i < len(groups):
        g_pad = g_pad_of(*groups[i])
        j = i
        while j < len(groups) and g_pad_of(*groups[j]) == g_pad:
            j += 1
        per_group = 4 * nsub * out_len + 4 * g_pad * out_nsamps
        gb = max(1, min(j - i, 1_000_000_000 // max(1, per_group)))
        for b0 in range(i, j, gb):
            batch = groups[b0 : min(b0 + gb, j)]
            d1 = np.stack(
                [np.pad(d1_all[lo], (0, cpad)).reshape(nsub, w) for lo, _ in batch]
            )
            # stage 2's padding trials repeat the group's last (JAX: edge
            # mode for the contraction, zeros for the scan; the padding
            # rows are dropped either way)
            rd = np.stack([
                np.pad(refdel[lo:hi], ((0, g_pad - (hi - lo)), (0, 0)),
                       mode="edge" if use_matmul else "constant")
                for lo, hi in batch
            ])
            if use_matmul:
                s1 = subband_stage1_matmul(x_swt, kill_sw, d1, out_len)
                res = subband_stage2_matmul(s1, rd, out_nsamps)
            else:
                s1 = subband_stage1(x_swt, kill_sw, d1, out_len)
                res = subband_stage2(s1, rd, out_nsamps)
            del s1
            res = _quantize(res, scale) if quantize else _scaled(res, scale)
            if to_host:
                # audit: ignore[PSA001] -- trials in host RAM: one copy a batch
                res = res.cpu().numpy()
            outs.extend(res[bi, : hi - lo] for bi, (lo, hi) in enumerate(batch))
        i = j
    if to_host:
        return np.concatenate(outs, axis=0)
    return outs[0] if len(outs) == 1 else torch.cat(outs)
