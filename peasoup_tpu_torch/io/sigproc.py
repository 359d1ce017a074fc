"""SIGPROC filterbank / time-series I/O.

Implements the keyword-tagged binary header format used by sigproc and
the reference pipeline (reference: include/data_types/header.hpp:339-403
for reading, header.hpp:222-308 for writing) plus bit unpacking of
1/2/4/8-bit filterbank data (done inside libdedisp in the reference).

All file I/O is host-side numpy; arrays are handed to torch later.
"""

from __future__ import annotations

import io as _io
import os
import struct
from dataclasses import asdict, dataclass
from typing import BinaryIO, Optional

import numpy as np

# Header keys -> struct format. Mirrors the keyword set understood by the
# reference reader (header.hpp:351-391).
_INT_KEYS = {
    "nchans", "telescope_id", "machine_id", "data_type", "ibeam",
    "nbeams", "nbits", "barycentric", "pulsarcentric", "nbins",
    "nsamples", "nifs", "npuls",
}
_DOUBLE_KEYS = {
    "az_start", "za_start", "src_raj", "src_dej", "tstart", "tsamp",
    "period", "fch1", "foff", "refdm",
}
_STRING_KEYS = {"source_name", "rawdatafile"}
_CHAR_KEYS = {"signed"}


@dataclass
class SigprocHeader:
    """Sigproc header values (reference: header.hpp:171-212)."""

    source_name: str = ""
    rawdatafile: str = ""
    az_start: float = 0.0
    za_start: float = 0.0
    src_raj: float = 0.0
    src_dej: float = 0.0
    tstart: float = 0.0
    tsamp: float = 0.0
    period: float = 0.0
    fch1: float = 0.0
    foff: float = 0.0
    nchans: int = 0
    telescope_id: int = 0
    machine_id: int = 0
    data_type: int = 0
    ibeam: int = 0
    nbeams: int = 0
    nbits: int = 0
    barycentric: int = 0
    pulsarcentric: int = 0
    nbins: int = 0
    nsamples: int = 0
    nifs: int = 0
    npuls: int = 0
    refdm: float = 0.0
    signed_data: int = 0
    size: int = 0  # header size in bytes (set on read)

    @property
    def cfreq(self) -> float:
        """Centre frequency (reference: filterbank.hpp:189-195).

        The reference treats fch1 as the band edge and always moves
        nchans/2 channels toward the band centre (the foff>0 branch
        subtracts, keeping the result below fch1 for ascending bands —
        preserved verbatim for trial-grid parity).
        """
        if self.foff < 0:
            return self.fch1 + self.foff * self.nchans / 2
        return self.fch1 - self.foff * self.nchans / 2

    @property
    def bandwidth(self) -> float:
        """Total (absolute) bandwidth in MHz."""
        return abs(self.foff) * self.nchans

    @property
    def tobs(self) -> float:
        return self.nsamples * self.tsamp

    def to_dict(self) -> dict:
        return asdict(self)


def _read_string(stream: BinaryIO) -> Optional[str]:
    raw = stream.read(4)
    if len(raw) < 4:
        return None
    (length,) = struct.unpack("<i", raw)
    if length <= 0 or length >= 80:
        return None
    return stream.read(length).decode("latin-1")


def read_sigproc_header(stream: BinaryIO) -> SigprocHeader:
    """Read a sigproc header from an open binary stream.

    Computes ``nsamples`` from the file size when the keyword is absent,
    like the reference (header.hpp:394-401).
    """
    hdr = SigprocHeader()
    start = _read_string(stream)
    if start != "HEADER_START":
        raise ValueError("not a sigproc file: missing HEADER_START")
    while True:
        key = _read_string(stream)
        if key is None:
            raise ValueError("unterminated sigproc header")
        if key == "HEADER_END":
            break
        if key in _STRING_KEYS:
            value = _read_string(stream)
            setattr(hdr, key, value or "")
        elif key in _INT_KEYS:
            (value,) = struct.unpack("<i", stream.read(4))
            setattr(hdr, key, value)
        elif key in _DOUBLE_KEYS:
            (value,) = struct.unpack("<d", stream.read(8))
            setattr(hdr, key, value)
        elif key in _CHAR_KEYS:
            (value,) = struct.unpack("<B", stream.read(1))
            hdr.signed_data = value
        else:
            # Unknown keyword: warn and continue, like the reference
            # (header.hpp:390-391). We cannot skip its value (length is
            # keyword-dependent), so the next string read resynchronises
            # or fails; warn either way.
            import warnings

            warnings.warn(f"read_sigproc_header: unknown parameter {key!r}")
    hdr.size = stream.tell()
    if hdr.nsamples == 0 and hdr.nchans > 0 and hdr.nbits > 0:
        pos = stream.tell()
        stream.seek(0, _io.SEEK_END)
        total = stream.tell()
        hdr.nsamples = (total - hdr.size) // hdr.nchans * 8 // hdr.nbits
        stream.seek(pos, _io.SEEK_SET)
    return hdr


def _write_string(stream: BinaryIO, s: str) -> None:
    b = s.encode("latin-1")
    stream.write(struct.pack("<i", len(b)))
    stream.write(b)


def write_sigproc_header(stream: BinaryIO, hdr: SigprocHeader) -> None:
    """Write a sigproc header (reference: header.hpp:222-308)."""
    _write_string(stream, "HEADER_START")
    if hdr.source_name:
        _write_string(stream, "source_name")
        _write_string(stream, hdr.source_name)
    if hdr.rawdatafile:
        _write_string(stream, "rawdatafile")
        _write_string(stream, hdr.rawdatafile)
    for key in sorted(_DOUBLE_KEYS):
        _write_string(stream, key)
        stream.write(struct.pack("<d", getattr(hdr, key)))
    for key in sorted(_INT_KEYS):
        if key == "nsamples":
            continue  # recomputed from file size on read, like sigproc
        _write_string(stream, key)
        stream.write(struct.pack("<i", getattr(hdr, key)))
    _write_string(stream, "signed")
    stream.write(struct.pack("<B", hdr.signed_data))
    _write_string(stream, "HEADER_END")


# ---------------------------------------------------------------------------
# Bit packing/unpacking.
#
# Sigproc packs sub-byte samples LSB-first within each byte, channel index
# running fastest. The reference delegates unpacking to libdedisp's
# sub-word extraction; we unpack to u8 on the host once and keep the
# (nsamps, nchans) array.
# ---------------------------------------------------------------------------

def unpack_bits(raw: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack a u8 byte array into individual samples (LSB-first).

    The host-side unpack; the search unpacks on the device instead
    (ops/dedisperse.py:unpack_fil_device).
    """
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if nbits == 8:
        return raw
    if nbits == 4:
        out = np.empty(raw.size * 2, dtype=np.uint8)
        out[0::2] = raw & 0x0F
        out[1::2] = raw >> 4
        return out
    if nbits == 2:
        out = np.empty(raw.size * 4, dtype=np.uint8)
        for k in range(4):
            out[k::4] = (raw >> (2 * k)) & 0x03
        return out
    if nbits == 1:
        out = np.empty(raw.size * 8, dtype=np.uint8)
        for k in range(8):
            out[k::8] = (raw >> k) & 0x01
        return out
    raise ValueError(f"unsupported nbits: {nbits}")


def pack_bits(samples: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of :func:`unpack_bits` (used for writing test fixtures)."""
    samples = np.ascontiguousarray(samples, dtype=np.uint8).ravel()
    if nbits == 8:
        return samples
    per_byte = 8 // nbits
    if samples.size % per_byte:
        raise ValueError("sample count not a multiple of samples-per-byte")
    out = np.zeros(samples.size // per_byte, dtype=np.uint8)
    mask = (1 << nbits) - 1
    for k in range(per_byte):
        out |= (samples[k::per_byte] & mask) << (nbits * k)
    return out


class Filterbank:
    """A filterbank in host RAM: header + samples.

    Like the reference (filterbank.hpp:207-250, whose dedisp call
    consumes the PACKED bytes and unpacks on the GPU), the packed
    ``raw`` bytes are the primary storage when the file had sub-byte
    samples: the search uploads them as-is and unpacks on the device
    — a 4x (2-bit) smaller host->device transfer. ``data``
    unpacks lazily for host-side consumers.
    """

    header: SigprocHeader
    _data: np.ndarray | None = None  # (nsamps, nchans) uint8, lazy
    raw: np.ndarray | None = None  # packed file bytes (None if 8-bit)

    def __init__(self, header, data=None, raw=None):
        self.header = header
        self._data = data
        self.raw = raw
        if data is None and raw is None:
            raise ValueError("Filterbank needs data or raw")

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._data = unpack_bits(self.raw, self.header.nbits).reshape(
                self.header.nsamples, self.header.nchans
            )
        return self._data

    @property
    def nsamps(self) -> int:
        return self.header.nsamples if self._data is None else self._data.shape[0]

    @property
    def nchans(self) -> int:
        return self.header.nchans

    @property
    def tsamp(self) -> float:
        return self.header.tsamp

    @property
    def cfreq(self) -> float:
        return self.header.cfreq

    @property
    def foff(self) -> float:
        return self.header.foff

    @property
    def fch1(self) -> float:
        return self.header.fch1

    @property
    def nbits(self) -> int:
        return self.header.nbits


def _read_filterbank_once(path: str | os.PathLike) -> Filterbank:
    from ..resilience import TransientIOError, faults

    faults.fire("fil.read", context=str(path))
    with open(path, "rb") as f:
        hdr = read_sigproc_header(f)
        nbytes = hdr.nsamples * hdr.nbits * hdr.nchans // 8
        f.seek(hdr.size, _io.SEEK_SET)
        raw = np.frombuffer(f.read(nbytes), dtype=np.uint8)
    if raw.size < nbytes:
        # a recorder still appending, a cache burp or a torn copy: transient
        # to the retry policy (a truly truncated file spends the budget)
        raise TransientIOError(
            None, f"{path}: short read ({raw.size}/{nbytes} payload bytes)"
        )
    if hdr.nbits == 8:
        return Filterbank(
            header=hdr, data=raw.reshape(hdr.nsamples, hdr.nchans)
        )
    return Filterbank(header=hdr, raw=raw.copy())


def read_filterbank(path: str | os.PathLike) -> Filterbank:
    """Read a sigproc filterbank file fully into host RAM. Transient
    failures (EIO/EAGAIN, short reads, injected ``fil.read`` faults) are
    retried under the shared bounded-backoff policy (resilience/policy.py,
    ``IO_RETRY``); a malformed header or another fatal error raises at
    once."""
    from ..resilience import IO_RETRY

    return IO_RETRY.call(_read_filterbank_once, path, site="fil.read", context=str(path))


def write_filterbank(path: str | os.PathLike, fil: Filterbank) -> None:
    with open(path, "wb") as f:
        write_sigproc_header(f, fil.header)
        f.write(pack_bits(fil.data.ravel(), fil.header.nbits).tobytes())


def read_timeseries(path: str | os.PathLike) -> tuple[SigprocHeader, np.ndarray]:
    """Read a sigproc .tim file: header + float32 samples
    (reference: timeseries.hpp:137-160)."""
    with open(path, "rb") as f:
        hdr = read_sigproc_header(f)
        f.seek(hdr.size, _io.SEEK_SET)
        data = np.frombuffer(f.read(), dtype=np.float32)
    return hdr, data
