"""PSRDADA header reader and writer: the port's copy of the JAX package's
peasoup_tpu/io/dada.py.

Reference: DadaHeader (include/data_types/header.hpp:52-161), a 4096-byte
text header of ``KEY value`` pairs at the start of a .dada file, parsed by
substring search. The streaming search's DADA source
(io/stream_source.py:DadaStreamSource) reads segments through it, and
:func:`write_dada` builds them.

Quirk preserved: the reference computes nsamples from the payload size as
filesize/nchan/nant/npol/2 (header.hpp:157); the /2 assumes 8-bit complex
(NDIM=2) sampling whatever NBIT and NDIM say.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

DADA_HDR_SIZE = 4096

# canonical ``KEY -> field`` mapping shared by the parser and the
# writer (order is the order keys are emitted by tofile/write_dada)
_DADA_KEYS: tuple[tuple[str, str], ...] = (
    ("HDR_VERSION", "header_version"),
    ("HDR_SIZE", "header_size"),
    ("BW", "bw"),
    ("FREQ", "freq"),
    ("NANT", "nant"),
    ("NCHAN", "nchan"),
    ("NDIM", "ndim"),
    ("NPOL", "npol"),
    ("NBIT", "nbit"),
    ("TSAMP", "tsamp"),
    ("OSAMP_RATIO", "osamp_ratio"),
    ("SOURCE", "source_name"),
    ("RA", "ra"),
    ("DEC", "dec"),
    ("PROC_FILE", "proc_file"),
    ("MODE", "mode"),
    ("OBSERVER", "observer"),
    ("PID", "pid"),
    ("OBS_OFFSET", "obs_offset"),
    ("TELESCOPE", "telescope"),
    ("INSTRUMENT", "instrument"),
    ("DSB", "dsb"),
    ("FILE_SIZE", "dada_filesize"),
    ("BYTES_PER_SECOND", "bytes_per_sec"),
    ("UTC_START", "utc_start"),
    ("ANT_ID", "ant_id"),
    ("FILE_NUMBER", "file_no"),
)


@dataclass
class DadaHeader:
    header_version: float = 0.0
    header_size: int = 0
    bw: float = 0.0
    freq: float = 0.0
    nant: int = 0
    nchan: int = 0
    ndim: int = 0
    npol: int = 0
    nbit: int = 0
    tsamp: float = 0.0
    osamp_ratio: float = 0.0
    source_name: str = ""
    ra: str = ""
    dec: str = ""
    proc_file: str = ""
    mode: str = ""
    observer: str = ""
    pid: str = ""
    obs_offset: int = 0
    telescope: str = ""
    instrument: str = ""
    dsb: int = 0
    filesize: int = 0
    dada_filesize: int = 0
    nsamples: int = 0
    bytes_per_sec: int = 0
    utc_start: str = ""
    ant_id: int = 0
    file_no: int = 0

    @classmethod
    def fromfile(cls, filename: str | os.PathLike) -> "DadaHeader":
        with open(filename, "rb") as f:
            raw = f.read(DADA_HDR_SIZE)
            f.seek(0, os.SEEK_END)
            payload = max(f.tell() - DADA_HDR_SIZE, 0)
        text = raw.decode("ascii", errors="replace")
        # PSRDADA headers allow '#'-prefixed comment lines; drop them
        # (and trailing NUL padding) before the substring search so a
        # commented-out key can never shadow the live one
        text = "\n".join(
            ln
            for ln in text.replace("\x00", "").splitlines()
            if not ln.lstrip().startswith("#")
        )

        def value(key: str) -> str:
            # substring search like the reference's get_value
            # (header.hpp:65-76): first occurrence, next whitespace token
            pos = text.find(key + " ")
            if pos < 0:
                return ""
            rest = text[pos + len(key) + 1 :]
            toks = rest.split()
            return toks[0] if toks else ""

        def fnum(key: str) -> float:
            v = value(key)
            try:
                return float(v)
            except ValueError:
                return 0.0

        def inum(key: str) -> int:
            v = value(key)
            try:
                return int(float(v))
            except ValueError:
                return 0

        h = cls(
            header_version=fnum("HDR_VERSION"),
            header_size=inum("HDR_SIZE"),
            bw=float(inum("BW")),  # reference uses atoi for BW (:132)
            freq=fnum("FREQ"),
            nant=inum("NANT"),
            nchan=inum("NCHAN"),
            ndim=inum("NDIM"),
            npol=inum("NPOL"),
            nbit=inum("NBIT"),
            tsamp=fnum("TSAMP"),
            osamp_ratio=fnum("OSAMP_RATIO"),
            source_name=value("SOURCE"),
            ra=value("RA"),
            dec=value("DEC"),
            proc_file=value("PROC_FILE"),
            mode=value("MODE"),
            observer=value("OBSERVER"),
            pid=value("PID"),
            obs_offset=inum("OBS_OFFSET"),
            telescope=value("TELESCOPE"),
            instrument=value("INSTRUMENT"),
            dsb=inum("DSB"),
            filesize=payload,
            dada_filesize=inum("FILE_SIZE"),
            bytes_per_sec=inum("BYTES_PER_SECOND"),
            utc_start=value("UTC_START"),
            ant_id=inum("ANT_ID"),
            file_no=inum("FILE_NUMBER"),
        )
        denom = max(h.nchan, 1) * max(h.nant, 1) * max(h.npol, 1) * 2
        h.nsamples = payload // denom
        return h

    def header_text(self) -> str:
        """The ``KEY value`` header block (no padding): every mapped
        field with a non-default value, in canonical key order.
        HDR_SIZE is always emitted (readers use it to find the
        payload)."""
        lines = []
        for key, field_name in _DADA_KEYS:
            v = getattr(self, field_name)
            if key == "HDR_SIZE":
                v = v or DADA_HDR_SIZE
            if v == 0 or v == 0.0 or v == "":
                if key != "HDR_SIZE":
                    continue
            if isinstance(v, float):
                v = f"{v:.12g}"
            lines.append(f"{key} {v}")
        return "\n".join(lines) + "\n"

    def tofile(
        self,
        filename: str | os.PathLike,
        payload: "np.ndarray | bytes | None" = None,
    ) -> None:
        """Write a .dada file: the header text NUL-padded to
        DADA_HDR_SIZE bytes, then the raw payload. Atomic
        (tmp + os.replace) so a tailing stream reader never sees a
        torn segment appear."""
        text = self.header_text().encode("ascii")
        if len(text) > DADA_HDR_SIZE:
            raise ValueError(
                f"header text ({len(text)} bytes) exceeds "
                f"DADA_HDR_SIZE={DADA_HDR_SIZE}"
            )
        body = b"" if payload is None else (
            payload if isinstance(payload, bytes)
            else np.ascontiguousarray(payload, dtype=np.uint8).tobytes()
        )
        tmp = os.fspath(filename) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(text.ljust(DADA_HDR_SIZE, b"\x00"))
            f.write(body)
        os.replace(tmp, os.fspath(filename))


def write_dada(
    filename: str | os.PathLike,
    payload: "np.ndarray | bytes",
    **fields,
) -> DadaHeader:
    """Synthesise a valid .dada stream segment from header ``fields``
    (DadaHeader field names) and payload samples."""
    h = DadaHeader(**fields)
    h.tofile(filename, payload)
    return h
