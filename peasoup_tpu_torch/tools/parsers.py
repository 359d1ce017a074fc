"""overview.xml as arrays: the part of the JAX package's tools/parsers.py
that the candidate database reads (:class:`OverviewFile`, with
:data:`CAND_FIELDS` and :data:`SP_CAND_FIELDS`). It parses the overview
either package writes: the periodicity candidates, the FDAS extras and the
``<single_pulse_search>`` section. The JAX module's ``read_singlepulse``
and ``CandidateFileParser`` belong to its tools (ROADMAP A.10).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

import numpy as np

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
