"""Parsers of the search outputs, the port's copy of the JAX package's
tools/parsers.py: :class:`OverviewFile` (overview.xml as arrays, with
:data:`CAND_FIELDS` and :data:`SP_CAND_FIELDS`; the periodicity
candidates, the FDAS extras and the ``<single_pulse_search>`` section of
the overview either package writes), :func:`read_singlepulse` (the
``.singlepulse`` text table) and :class:`CandidateFileParser`
(candidates.peasoup records by byte offset: the optional FOLD block and
the detection list).
"""

from __future__ import annotations

import re
import struct
import xml.etree.ElementTree as ET

import numpy as np

from ..core.candidates import CANDIDATE_POD_DTYPE

CAND_FIELDS = [
    ("period", "f8"),
    ("opt_period", "f8"),
    ("dm", "f4"),
    ("acc", "f4"),
    ("nh", "i4"),
    ("snr", "f4"),
    ("folded_snr", "f4"),
    ("is_adjacent", "i4"),
    ("is_physical", "i4"),
    ("ddm_count_ratio", "f4"),
    ("ddm_snr_ratio", "f4"),
    ("nassoc", "i4"),
    ("byte_offset", "i8"),
    # FDAS extras (io/output.py add_fdas_section); absent elements parse
    # as 0, so plain periodicity overviews are unaffected
    ("fdot", "f4"),
    ("fddot", "f4"),
]

# single-pulse candidate fields (io/output.py add_single_pulse_section):
# one row per cluster
SP_CAND_FIELDS = [
    ("dm", "f4"),
    ("snr", "f4"),
    ("time_s", "f8"),
    ("sample", "i8"),
    ("width", "i4"),
    ("width_idx", "i4"),
    ("dm_idx", "i4"),
    ("members", "i4"),
    ("sample_lo", "i8"),
    ("sample_hi", "i8"),
    ("dm_idx_lo", "i4"),
    ("dm_idx_hi", "i4"),
    ("width_lo", "i4"),
    ("width_hi", "i4"),
]


def _rows(nodes, fields) -> np.ndarray:
    rows = []
    for cand in nodes:
        vals = {c.tag: c.text for c in cand}
        rows.append(tuple(np.dtype(ftype).type(vals.get(fname, 0) or 0)
                          for fname, ftype in fields))
    return np.array(rows, dtype=fields)


def read_singlepulse(path: str) -> np.ndarray:
    """Parse a ``.singlepulse`` text table (io.output.write_singlepulse)
    into a record array with SP_CAND_FIELDS. The '#' header row names the
    columns, so extra or reordered columns parse by name (missing fields
    default to 0)."""
    with open(path, "r", encoding="ascii") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    names = None
    rows = []
    for ln in lines:
        if ln.startswith("#"):
            if names is None:
                names = ln.lstrip("# ").split()
            continue
        rows.append(ln.split())
    if names is None:
        names = [fname for fname, _ in SP_CAND_FIELDS]
    out = np.zeros(len(rows), dtype=SP_CAND_FIELDS)
    col_of = {n: i for i, n in enumerate(names)}
    for fname, ftype in SP_CAND_FIELDS:
        ci = col_of.get(fname)
        if ci is None:
            continue
        vals = [r[ci] if ci < len(r) else 0 for r in rows]
        out[fname] = np.asarray(vals, dtype=np.dtype(ftype))
    return out


class OverviewFile:
    """overview.xml as header/search dicts and candidate record arrays
    (plus, when a <single_pulse_search> section is present, its width list
    and candidates)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        # the reference writer can put invalid bytes in <username>
        raw = re.sub(rb"<username>.*?</username>", b"<username></username>", raw,
                     flags=re.S)
        self.root = ET.fromstring(raw.decode("latin-1"))
        self.header = self._section_dict("header_parameters")
        self.search_parameters = self._section_dict("search_parameters")
        self.execution_times = {
            k: float(v) for k, v in self._section_dict("execution_times").items()
        }
        self.dm_list = np.array(
            [float(t.text) for t in self.root.findall("dedispersion_trials/trial")]
        )
        self.acc_list = np.array(
            [float(t.text) for t in self.root.findall("acceleration_trials/trial")]
        )
        self.candidates = _rows(self.root.findall("candidates/candidate"), CAND_FIELDS)
        self.sp_parameters = self._section_dict("single_pulse_search/search_parameters")
        self.sp_widths = np.array(
            [int(t.text) for t in self.root.findall("single_pulse_search/width_trials/trial")],
            dtype=np.int64,
        )
        self.sp_candidates = _rows(
            self.root.findall("single_pulse_search/candidates/candidate"), SP_CAND_FIELDS
        )

    def _section_dict(self, name: str) -> dict:
        node = self.root.find(name)
        if node is None:
            return {}
        return {child.tag: (child.text or "") for child in node}


class CandidateFileParser:
    """Read candidates.peasoup records by byte offset
    (tools/peasoup_tools.py:46-80)."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_candidate(self, byte_offset: int) -> dict:
        self.f.seek(byte_offset)
        magic = self.f.read(4)
        fold = None
        nbins = nints = 0
        if magic == b"FOLD":
            nbins, nints = struct.unpack("<ii", self.f.read(8))
            fold = np.frombuffer(
                self.f.read(4 * nbins * nints), dtype="<f4"
            ).reshape(nints, nbins)
        else:
            self.f.seek(byte_offset)
        (ndets,) = struct.unpack("<i", self.f.read(4))
        hits = np.frombuffer(
            self.f.read(CANDIDATE_POD_DTYPE.itemsize * ndets),
            dtype=CANDIDATE_POD_DTYPE,
        )
        return {"fold": fold, "nbins": nbins, "nints": nints, "hits": hits}
