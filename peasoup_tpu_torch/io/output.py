"""Output writers: candidates.peasoup binary + overview.xml.

Reference: include/utils/output_stats.hpp. The binary format per
candidate (output_stats.hpp:237-270):
  [optional] b"FOLD" + nbins(i32) + nints(i32) + fold(f32 x nbins*nints)
  ndets(i32) + ndets x CandidatePOD(24 bytes)
with a byte-offset map recorded for the XML. The XML mirrors the
reference's section set: misc_info, header_parameters,
search_parameters, dedispersion_trials, acceleration_trials, device
info, candidates, execution_times.

The single-pulse search (no reference equivalent) writes the JAX
package's ``.singlepulse`` text table (PRESTO's first five columns, then
the cluster footprint) and a ``<single_pulse_search>`` overview.xml
section; the JAX package's tools.parsers read both. The FDAS search
writes the JAX package's ``.fdas`` table and ``<fdas_search>`` section,
and its candidates with their f-dot provenance. A campaign's FFA job
writes the JAX package's ``.ffa`` table and ``<ffa_search_parameters>``
section.
"""

from __future__ import annotations

import getpass
import os
import struct
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from ..core.candidates import Candidate
from .sigproc import SigprocHeader
from .xml_writer import Element


class CandidateFileWriter:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.byte_mapping: dict[int, int] = {}

    def write_binary(
        self, candidates: Sequence[Candidate], filename: str = "candidates.peasoup"
    ) -> str:
        path = os.path.join(self.output_dir, filename)
        with open(path, "wb") as fo:
            for ii, cand in enumerate(candidates):
                self.byte_mapping[ii] = fo.tell()
                self._write_one(fo, cand)
        return path

    @staticmethod
    def _write_one(fo, cand: Candidate) -> None:
        if cand.fold is not None and cand.fold.size > 0:
            nints, nbins = cand.fold.shape
            fo.write(b"FOLD")
            fo.write(struct.pack("<ii", nbins, nints))
            fo.write(np.asarray(cand.fold, dtype="<f4").tobytes())
        pods = cand.collect_pods()
        fo.write(struct.pack("<i", len(pods)))
        fo.write(pods.tobytes())



# .singlepulse column order: PRESTO's five, then the cluster footprint
SINGLEPULSE_COLUMNS = (
    "dm", "snr", "time_s", "sample", "width",
    "width_idx", "dm_idx", "members",
    "sample_lo", "sample_hi", "dm_idx_lo", "dm_idx_hi",
    "width_lo", "width_hi",
)


def write_singlepulse(path: str, candidates: Sequence) -> str:
    """Write SinglePulseCandidates as a whitespace-delimited text table
    (one row per cluster, in the order given) under a '#' header that
    names every column, the JAX package's ``.singlepulse`` format."""
    with open(path, "w", encoding="ascii") as f:
        f.write("# " + " ".join(SINGLEPULSE_COLUMNS) + "\n")
        for c in candidates:
            f.write(
                f"{c.dm:.6f} {c.snr:.4f} {c.time_s:.9f} {c.sample:d} "
                f"{c.width:d} {c.width_idx:d} {c.dm_idx:d} {c.members:d} "
                f"{c.sample_lo:d} {c.sample_hi:d} {c.dm_idx_lo:d} "
                f"{c.dm_idx_hi:d} {c.width_lo:d} {c.width_hi:d}\n"
            )
    return path


FFA_COLUMNS = ("period", "dm", "snr", "width", "duty_cycle")


def write_ffa_candidates(path: str, candidates: Sequence) -> str:
    """Write FFACandidates as a whitespace-delimited text table (one row
    per period-collapsed candidate, in the order given), the JAX
    package's ``.ffa`` format."""
    with open(path, "w", encoding="ascii") as f:
        f.write("# " + " ".join(FFA_COLUMNS) + "\n")
        for c in candidates:
            f.write(
                f"{c.period:.9f} {c.dm:.6f} {c.snr:.4f} {c.width:d} "
                f"{c.dc:.6f}\n"
            )
    return path


# .fdas column order: periodicity fields plus the Fourier-domain
# provenance, self-describing like the .singlepulse table
FDAS_COLUMNS = ("period", "dm", "acc", "fdot", "fddot", "z", "w", "nh", "snr")


def write_fdas_candidates(path: str, candidates: Sequence) -> str:
    """Write FdasCandidates as a whitespace-delimited text table (one row
    per distilled candidate, in the order given), the JAX package's
    ``.fdas`` format. ``acc`` is the equivalent line-of-sight acceleration
    -fdot*c/f."""
    with open(path, "w", encoding="ascii") as f:
        f.write("# " + " ".join(FDAS_COLUMNS) + "\n")
        for c in candidates:
            f.write(
                f"{c.period:.12g} {c.dm:.6f} {c.acc:.6f} "
                f"{c.fdot:.9g} {c.fddot:.9g} {c.z:.3f} {c.w:.3f} "
                f"{c.nh:d} {c.snr:.4f}\n"
            )
    return path


class OutputFileWriter:
    def __init__(self):
        self.root = Element("peasoup_search")

    def to_string(self) -> str:
        return self.root.to_string(header=True)

    def to_file(self, filename: str) -> None:
        with open(filename, "w", encoding="latin-1") as f:
            f.write(self.to_string())

    def add_misc_info(self) -> None:
        info = self.root.append(Element("misc_info"))
        try:
            user = getpass.getuser()
        except Exception:
            user = "unknown"
        info.append(Element("username", user))
        info.append(Element("local_datetime", time.strftime("%Y-%m-%d-%H:%M")))
        info.append(
            Element("utc_datetime", time.strftime("%Y-%m-%d-%H:%M", time.gmtime()))
        )

    def add_header(self, hdr: SigprocHeader) -> None:
        h = self.root.append(Element("header_parameters"))
        h.append(Element("source_name", hdr.source_name))
        h.append(Element("rawdatafile", hdr.rawdatafile))
        h.append(Element("az_start", hdr.az_start))
        h.append(Element("za_start", hdr.za_start))
        h.append(Element("src_raj", hdr.src_raj))
        h.append(Element("src_dej", hdr.src_dej))
        h.append(Element("tstart", hdr.tstart))
        h.append(Element("tsamp", hdr.tsamp))
        h.append(Element("period", hdr.period))
        h.append(Element("fch1", hdr.fch1))
        h.append(Element("foff", hdr.foff))
        h.append(Element("nchans", hdr.nchans))
        h.append(Element("telescope_id", hdr.telescope_id))
        h.append(Element("machine_id", hdr.machine_id))
        h.append(Element("data_type", hdr.data_type))
        h.append(Element("ibeam", hdr.ibeam))
        h.append(Element("nbeams", hdr.nbeams))
        h.append(Element("nbits", hdr.nbits))
        h.append(Element("barycentric", hdr.barycentric))
        h.append(Element("pulsarcentric", hdr.pulsarcentric))
        h.append(Element("nbins", hdr.nbins))
        h.append(Element("nsamples", hdr.nsamples))
        h.append(Element("nifs", hdr.nifs))
        h.append(Element("npuls", hdr.npuls))
        h.append(Element("refdm", hdr.refdm))
        h.append(Element("signed", int(hdr.signed_data)))

    def add_search_parameters(self, cfg, infilename: str) -> None:
        s = self.root.append(Element("search_parameters"))
        s.append(Element("infilename", infilename))
        s.append(Element("outdir", cfg.outdir))
        s.append(Element("killfilename", cfg.killfilename))
        s.append(Element("zapfilename", cfg.zapfilename))
        s.append(Element("max_num_threads", cfg.max_num_threads))
        s.append(Element("size", cfg.size))
        s.append(Element("dm_start", float(np.float32(cfg.dm_start))))
        s.append(Element("dm_end", float(np.float32(cfg.dm_end))))
        s.append(Element("dm_tol", float(np.float32(cfg.dm_tol))))
        s.append(Element("dm_pulse_width", float(np.float32(cfg.dm_pulse_width))))
        s.append(Element("acc_start", float(np.float32(cfg.acc_start))))
        s.append(Element("acc_end", float(np.float32(cfg.acc_end))))
        s.append(Element("acc_tol", float(np.float32(cfg.acc_tol))))
        s.append(Element("acc_pulse_width", float(np.float32(cfg.acc_pulse_width))))
        s.append(Element("boundary_5_freq", float(np.float32(cfg.boundary_5_freq))))
        s.append(Element("boundary_25_freq", float(np.float32(cfg.boundary_25_freq))))
        s.append(Element("nharmonics", cfg.nharmonics))
        s.append(Element("npdmp", cfg.npdmp))
        s.append(Element("min_snr", float(np.float32(cfg.min_snr))))
        s.append(Element("min_freq", float(np.float32(cfg.min_freq))))
        s.append(Element("max_freq", float(np.float32(cfg.max_freq))))
        s.append(Element("max_harm", cfg.max_harm))
        s.append(Element("freq_tol", float(np.float32(cfg.freq_tol))))
        s.append(Element("verbose", cfg.verbose))
        s.append(Element("progress_bar", cfg.progress_bar))

    def add_dm_list(self, dms: Iterable[float]) -> None:
        dms = list(dms)
        trials = self.root.append(Element("dedispersion_trials"))
        trials.add_attribute("count", len(dms))
        for ii, dm in enumerate(dms):
            t = Element("trial", float(dm))
            t.add_attribute("id", ii)
            trials.append(t)

    def add_acc_list(self, accs: Iterable[float], dm: float = 0) -> None:
        accs = list(accs)
        trials = self.root.append(Element("acceleration_trials"))
        trials.add_attribute("count", len(accs))
        trials.add_attribute("DM", int(dm))
        for ii, acc in enumerate(accs):
            t = Element("trial", float(acc))
            t.add_attribute("id", ii)
            trials.append(t)

    def add_device_info(self, device: torch.device) -> None:
        """The device section: the reference's cuda_device_parameters
        (output_stats.hpp:124-142), filled from the device the search
        ran on."""
        info = self.root.append(Element("cuda_device_parameters"))
        info.append(Element("platform", device.type))
        if device.type != "cuda":
            return
        idx = device.index if device.index is not None else 0
        props = torch.cuda.get_device_properties(idx)
        d = Element("cuda_device")
        d.add_attribute("id", idx)
        d.append(Element("name", props.name))
        d.append(Element("major", props.major))
        d.append(Element("minor", props.minor))
        d.append(Element("multiProcessorCount", props.multi_processor_count))
        d.append(Element("totalGlobalMem", props.total_memory))
        info.append(d)

    def add_candidates(
        self, candidates: Sequence[Candidate], byte_map: dict[int, int]
    ) -> None:
        cands = self.root.append(Element("candidates"))
        for ii, c in enumerate(candidates):
            e = Element("candidate")
            e.add_attribute("id", ii)
            e.append(Element("period", 1.0 / c.freq if c.freq else float("inf")))
            e.append(Element("opt_period", c.opt_period))
            e.append(Element("dm", float(np.float32(c.dm))))
            e.append(Element("acc", float(np.float32(c.acc))))
            e.append(Element("nh", c.nh))
            e.append(Element("snr", float(np.float32(c.snr))))
            e.append(Element("folded_snr", float(np.float32(c.folded_snr))))
            e.append(Element("is_adjacent", c.is_adjacent))
            e.append(Element("is_physical", c.is_physical))
            e.append(Element("ddm_count_ratio", float(np.float32(c.ddm_count_ratio))))
            e.append(Element("ddm_snr_ratio", float(np.float32(c.ddm_snr_ratio))))
            e.append(Element("nassoc", c.count_assoc()))
            e.append(Element("byte_offset", byte_map.get(ii, 0)))
            cands.append(e)

    def add_ffa_section(self, cfg, infilename: str, candidates: Sequence) -> None:
        """FFA search parameters and candidates, as the JAX package's
        campaign writes them: the ``<candidates>`` entries carry the
        periodicity field set (``acc`` and ``nh`` vacuous for an FFA
        detection) so tools.parsers.OverviewFile and the campaign
        database read FFA jobs through the periodicity path, plus the
        FFA's width and duty cycle."""
        s = self.root.append(Element("ffa_search_parameters"))
        s.append(Element("infilename", infilename))
        s.append(Element("outdir", cfg.outdir))
        s.append(Element("killfilename", cfg.killfilename))
        for name in ("dm_start", "dm_end", "dm_tol", "dm_pulse_width", "p_start",
                     "p_end", "min_dc", "min_snr"):
            s.append(Element(name, float(np.float32(getattr(cfg, name)))))
        cands = self.root.append(Element("candidates"))
        for ii, c in enumerate(candidates):
            e = Element("candidate")
            e.add_attribute("id", ii)
            e.append(Element("period", float(c.period)))
            e.append(Element("opt_period", float(c.period)))
            e.append(Element("dm", float(np.float32(c.dm))))
            e.append(Element("acc", 0.0))
            e.append(Element("nh", 0))
            e.append(Element("snr", float(np.float32(c.snr))))
            e.append(Element("folded_snr", 0.0))
            e.append(Element("width", int(c.width)))
            e.append(Element("duty_cycle", float(np.float32(c.dc))))
            cands.append(e)

    def add_fdas_section(self, cfg, zs: Iterable[float], ws: Iterable[float]) -> None:
        """The ``<fdas_search>`` element: the FDAS search parameters and
        the (z, w) template trial ladders, as the JAX package writes it."""
        sec = self.root.append(Element("fdas_search"))
        params = sec.append(Element("search_parameters"))
        params.append(Element("outdir", cfg.outdir))
        params.append(Element("killfilename", cfg.killfilename))
        params.append(Element("zapfilename", cfg.zapfilename))
        params.append(Element("size", cfg.size))
        for name in ("dm_start", "dm_end", "dm_tol", "dm_pulse_width", "zmax",
                     "zstep", "wmax", "wstep"):
            params.append(Element(name, float(np.float32(getattr(cfg, name)))))
        params.append(Element("nharmonics", cfg.nharmonics))
        for name in ("min_snr", "min_freq", "max_freq"):
            params.append(Element(name, float(np.float32(getattr(cfg, name)))))
        params.append(Element("max_harm", cfg.max_harm))
        params.append(Element("freq_tol", float(np.float32(cfg.freq_tol))))
        for tag, trials in (("fdot_trials", zs), ("fddot_trials", ws)):
            el = sec.append(Element(tag))
            trials = [float(v) for v in trials]
            el.add_attribute("count", len(trials))
            el.add_attribute("unit", "bins")
            for ii, v in enumerate(trials):
                t = Element("trial", v)
                t.add_attribute("id", ii)
                el.append(t)

    def add_candidates_fdas(
        self, candidates: Sequence[Candidate], byte_map: dict[int, int]
    ) -> None:
        """Top-level <candidates> in the periodicity layout plus the FDAS
        provenance (fdot Hz/s, fddot Hz/s^2, z and w in bins), as the JAX
        package writes them."""
        cands = self.root.append(Element("candidates"))
        for ii, c in enumerate(candidates):
            e = Element("candidate")
            e.add_attribute("id", ii)
            e.append(Element("period", 1.0 / c.freq if c.freq else float("inf")))
            e.append(Element("opt_period", c.opt_period))
            e.append(Element("dm", float(np.float32(c.dm))))
            e.append(Element("acc", float(np.float32(c.acc))))
            e.append(Element("nh", c.nh))
            e.append(Element("snr", float(np.float32(c.snr))))
            e.append(Element("folded_snr", float(np.float32(c.folded_snr))))
            for name in ("fdot", "fddot", "z", "w"):
                e.append(Element(name, float(np.float32(getattr(c, name, 0.0)))))
            e.append(Element("nassoc", c.count_assoc()))
            e.append(Element("byte_offset", byte_map.get(ii, 0)))
            cands.append(e)

    def add_single_pulse_section(
        self,
        cfg,
        infilename: str,
        widths: Iterable[int],
        candidates: Sequence,
    ) -> None:
        """The single-pulse search parameters, width trials and
        candidates, nested under one <single_pulse_search> element (the
        JAX package's layout)."""
        sp = self.root.append(Element("single_pulse_search"))
        params = sp.append(Element("search_parameters"))
        params.append(Element("infilename", infilename))
        params.append(Element("outdir", cfg.outdir))
        params.append(Element("killfilename", cfg.killfilename))
        params.append(Element("dm_start", float(np.float32(cfg.dm_start))))
        params.append(Element("dm_end", float(np.float32(cfg.dm_end))))
        params.append(Element("dm_tol", float(np.float32(cfg.dm_tol))))
        params.append(Element("dm_pulse_width", float(np.float32(cfg.dm_pulse_width))))
        params.append(Element("min_snr", float(np.float32(cfg.min_snr))))
        params.append(Element("n_widths", cfg.n_widths))
        params.append(Element("max_events", cfg.max_events))
        params.append(Element("decimate", cfg.decimate))
        params.append(Element("time_link", float(np.float32(cfg.time_link))))
        params.append(Element("dm_link", cfg.dm_link))
        widths = [int(w) for w in widths]
        trials = sp.append(Element("width_trials"))
        trials.add_attribute("count", len(widths))
        for ii, w in enumerate(widths):
            t = Element("trial", w)
            t.add_attribute("id", ii)
            trials.append(t)
        cands = sp.append(Element("candidates"))
        cands.add_attribute("count", len(candidates))
        for ii, c in enumerate(candidates):
            e = Element("candidate")
            e.add_attribute("id", ii)
            e.append(Element("dm", float(np.float32(c.dm))))
            e.append(Element("dm_idx", c.dm_idx))
            e.append(Element("snr", float(np.float32(c.snr))))
            e.append(Element("time_s", float(c.time_s)))
            e.append(Element("sample", c.sample))
            e.append(Element("width", c.width))
            e.append(Element("width_idx", c.width_idx))
            e.append(Element("members", c.members))
            e.append(Element("sample_lo", c.sample_lo))
            e.append(Element("sample_hi", c.sample_hi))
            e.append(Element("dm_idx_lo", c.dm_idx_lo))
            e.append(Element("dm_idx_hi", c.dm_idx_hi))
            e.append(Element("width_lo", c.width_lo))
            e.append(Element("width_hi", c.width_hi))
            cands.append(e)

    def add_timing_info(self, timers: dict[str, float]) -> None:
        times = self.root.append(Element("execution_times"))
        for key in sorted(timers):
            times.append(Element(key, float(timers[key])))
