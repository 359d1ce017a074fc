"""Filterbank observations made from a seed, on the device.

One general generator for every configuration and traffic mix: Gaussian
noise in every channel, the mix's pulsars dispersed across the band at
whole-sample delays (the textbook dispersion constant, not the search's
planning constant), each with a Gaussian pulse of the mix's duty cycle
and, for a binary, a constant line-of-sight acceleration, and mains
interference at zero DM with its harmonics. The sum is quantised to the
configuration's ``nbits`` and handed over as ``io/sigproc.py``'s reader
returns a file of that many bits: the packed bytes (``Filterbank.raw``)
below 8 bits, ``data`` at 8.

The seed fixes the pulsars' phases (``numpy``), the mains' phases and the
noise (``torch.Generator`` on the device, in fixed chunks); the mix fixes
the rest. The same seed gives the same bytes on the same device type.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .cell import killmask

SPEED_OF_LIGHT = 299792458.0
KDM = 4.148808e3  # s MHz^2 pc^-1 cm^3

# samples a chunk of the noise: fixed, so the bytes do not depend on memory
CHUNK = 1 << 16

# the 2-bit quantiser's thresholds (units of the noise's sigma): the
# levels' optimal spacing for Gaussian input
TWO_BIT_EDGE = 0.9816
# folded S/N kept by each quantiser, so the mix's S/N is what survives it
EFFICIENCY = {2: 0.88, 8: 1.0}


@dataclass
class Pulsar:
    period_s: float
    dm: float
    duty: float
    snr: float  # folded S/N over the observation, after quantisation
    accel: float  # m/s^2, line of sight; 0 for an isolated pulsar
    phase: float  # rotational phase at the first sample

    @property
    def freq(self) -> float:
        return 1.0 / self.period_s


def draw_pulsars(traffic: dict, seed: int) -> list[Pulsar]:
    """The mix's pulsars for ``seed``: each as the mix states it (period,
    DM, duty, S/N, signed acceleration), at a phase drawn from the seed.
    The parameters do not move with the seed, so every seed asks the
    search for the same work; the phases and the noise are the seed's."""
    rng = np.random.default_rng(seed)
    return [Pulsar(period_s=float(p["period_s"]), dm=float(p["dm"]), duty=float(p["duty"]),
                   snr=float(p["snr"]), accel=float(p["accel"]), phase=float(rng.uniform()))
            for p in traffic["pulsars"]]


def birdies(config: dict, traffic: dict) -> list[tuple[float, float]]:
    """(frequency, width) in Hz of the mains line and the harmonics the
    mix injects: the birdie list a survey keeps for its site."""
    mains = traffic["mains"]
    f0 = float(config["mains_hz"])
    width = float(mains["birdie_width_hz"])
    return [(f0 * (h + 1), width) for h in range(len(mains["harmonics"]))]


def write_birdies(path, config: dict, traffic: dict) -> None:
    with open(path, "w") as f:
        for freq, width in birdies(config, traffic):
            f.write(f"{freq!r} {width!r}\n")


def write_killfile(path, config: dict) -> bool:
    """The kill file (one 0 or 1 a channel, a line each) of the
    configuration's mask; False, and nothing written, where it has none."""
    keep = killmask(config)
    if keep is None:
        return False
    with open(path, "w") as f:
        f.write("".join(f"{int(v)}\n" for v in keep))
    return True


def channel_freqs(header: dict) -> np.ndarray:
    return header["fch1"] + header["foff"] * np.arange(header["nchans"], dtype=np.float64)


def channel_delays(header: dict, dm: float) -> np.ndarray:
    """Whole-sample delay of each channel against the band's top, at ``dm``."""
    f = channel_freqs(header)
    sec = KDM * dm * (f**-2 - f.max() ** -2)
    return np.rint(sec / header["tsamp"]).astype(np.int64)


def _profile(p: Pulsar, header: dict, nchans: int, nsamps: int, off: int, dev) -> torch.Tensor:
    """The pulsar's contribution per channel-sample, in noise sigmas, at
    emitted sample k in [-off, nsamps): index k + off."""
    eff = EFFICIENCY[int(header["nbits"])]
    sigma_phase = p.duty / (2.0 * math.sqrt(2.0 * math.log(2.0)))
    # folded S/N of a Gaussian pulse of height A: A * sqrt(N C sigma sqrt(pi))
    amp = p.snr / eff / math.sqrt(nsamps * nchans * sigma_phase * math.sqrt(math.pi))
    t = (torch.arange(-off, nsamps, dtype=torch.float64, device=dev)) * header["tsamp"]
    phase = p.phase + p.freq * (t - p.accel * t * t / (2.0 * SPEED_OF_LIGHT))
    d = torch.remainder(phase + 0.5, 1.0) - 0.5
    return (amp * torch.exp(-0.5 * (d / sigma_phase) ** 2)).to(torch.float32)


def _mains(config: dict, traffic: dict, t0: int, n: int, tsamp: float, phases, dev):
    t = torch.arange(t0, t0 + n, dtype=torch.float64, device=dev) * tsamp
    m = torch.zeros(n, dtype=torch.float64, device=dev)
    f0 = float(config["mains_hz"])
    amp = float(traffic["mains"]["amplitude"])
    for h, (rel, ph) in enumerate(zip(traffic["mains"]["harmonics"], phases)):
        m += amp * float(rel) * torch.cos(2 * math.pi * f0 * (h + 1) * t + ph)
    return m.to(torch.float32)


def _quantise(x: torch.Tensor, nbits: int, config: dict) -> torch.Tensor:
    """Samples (noise sigma units) to the levels of ``nbits`` bits, u8."""
    if nbits == 2:
        e = TWO_BIT_EDGE
        return ((x >= -e).to(torch.uint8) + (x >= 0).to(torch.uint8)
                + (x >= e).to(torch.uint8))
    if nbits == 8:
        sigma = float(config["quantiser"]["sigma_levels"])
        return torch.clamp(torch.round(x * sigma + 128.0), 0, 255).to(torch.uint8)
    raise ValueError(f"the generator makes 2- or 8-bit data, not {nbits}")


def _pack(q: torch.Tensor, nbits: int) -> torch.Tensor:
    """(T, C) u8 levels -> the sigproc bytes, LSB first, channel fastest."""
    if nbits == 8:
        return q.reshape(-1)
    per = 8 // nbits
    v = q.reshape(q.shape[0], -1, per).to(torch.int32)
    out = torch.zeros(v.shape[:2], dtype=torch.int32, device=q.device)
    for k in range(per):
        out |= v[..., k] << (nbits * k)
    return out.to(torch.uint8).reshape(-1)


@dataclass
class Observation:
    fil: object  # peasoup_tpu_torch.io.sigproc.Filterbank, in host RAM
    pulsars: list
    seed: int

    def describe(self) -> list[dict]:
        return [asdict(p) for p in self.pulsars]


def make_samples(config: dict, traffic: dict, seed: int, dev) -> tuple[np.ndarray, list]:
    """The observation's bytes in host RAM (packed below 8 bits, else (T, C))
    and its pulsars, made on ``dev``."""
    h = config["header"]
    nchans, nsamps, nbits = int(h["nchans"]), int(h["nsamps"]), int(h["nbits"])
    pulsars = draw_pulsars(traffic, seed)
    delays = [channel_delays(h, p.dm) for p in pulsars]
    off = max((int(d.max()) for d in delays), default=0)
    profs = [_profile(p, h, nchans, nsamps, off, dev) for p in pulsars]
    rng = np.random.default_rng(seed ^ 0x5EED)
    mains_phases = rng.uniform(0, 2 * math.pi, size=len(traffic["mains"]["harmonics"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    # the channel offsets of each pulsar's rows in its profile, on the device
    rows = [torch.from_numpy(off - d).to(dev) for d in delays]
    per_byte = 8 // nbits
    out = np.empty(nsamps * nchans // per_byte, dtype=np.uint8)
    host = torch.from_numpy(out)
    for t0 in range(0, nsamps, CHUNK):
        n = min(CHUNK, nsamps - t0)
        x = torch.randn((nchans, n), generator=gen, device=dev, dtype=torch.float32)
        for prof, r in zip(profs, rows):
            # row c is the profile from emitted sample t0 - delay_c
            x += prof.unfold(0, n, 1).index_select(0, r + t0)
        x += _mains(config, traffic, t0, n, h["tsamp"], mains_phases, dev)[None, :]
        q = _quantise(x, nbits, config).t().contiguous()
        del x
        packed = _pack(q, nbits)
        start = t0 * nchans // per_byte
        host[start : start + packed.numel()].copy_(packed)
    return out, pulsars


def make_observation(config: dict, traffic: dict, seed: int, dev) -> Observation:
    """The observation for ``seed`` as the port's Filterbank, as
    ``io/sigproc.py:read_filterbank`` returns a file of its ``nbits``."""
    from peasoup_tpu_torch.io.sigproc import Filterbank, SigprocHeader

    h = config["header"]
    hdr = SigprocHeader(
        source_name=f"{config['name']}.{seed}", tsamp=float(h["tsamp"]),
        fch1=float(h["fch1"]), foff=float(h["foff"]), nchans=int(h["nchans"]),
        nbits=int(h["nbits"]), nsamples=int(h["nsamps"]), nifs=1, data_type=1,
        telescope_id=int(h.get("telescope_id", 0)), machine_id=int(h.get("machine_id", 0)),
    )
    samples, pulsars = make_samples(config, traffic, seed, dev)
    if hdr.nbits == 8:
        fil = Filterbank(header=hdr, data=samples.reshape(hdr.nsamples, hdr.nchans))
    else:
        fil = Filterbank(header=hdr, raw=samples)
    return Observation(fil=fil, pulsars=pulsars, seed=seed)
