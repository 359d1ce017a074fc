"""Checkpoint and resume of per-DM-trial search results: the port's copy
of the JAX package's pipeline/checkpoint.py.

The reference has no checkpointing (a crash mid-sweep loses everything).
After each DM block the searches persist the per-trial results already
searched, keyed by global DM-trial index, so a long sweep resumes where
it stopped. A key over every parameter that changes the results, the
observation's header included, invalidates a store written for another
search.

A search of the whole DM list writes one store file, the base path; a
process that searches a slice ``(lo, hi)`` of it writes the sibling
``<base>.dmLO-HI`` (no two processes write one file), as the JAX package's
processes do. :meth:`load` unions the base file and every sibling, so a
store written under one split of the DM list resumes under any other.
Entries are stored under their global DM-trial index and handed to a
sliced search with local keys (global - lo).

A damaged store (a process killed mid-write, a torn copy) never fails
the run: it is warned about, renamed to ``*.corrupt`` and treated as
absent, so the search starts those trials over. A missing store means
start over; a store whose key differs is ignored.
"""

from __future__ import annotations

import glob
import logging
import os
import tempfile

import numpy as np

log = logging.getLogger("peasoup_tpu_torch.checkpoint")

# the names an entry's three arrays are stored under, in order: the
# periodicity search's (idxs, snrs, counts) and, under the same names as in
# the JAX package, the single-pulse search's (positions and widths, snrs,
# count)
_NAMES = ("idxs", "snrs", "counts")


class SearchCheckpoint:
    """Atomic .npz store of {global dm_idx: (idxs, snrs, counts)}.
    ``slice_bounds=(lo, hi)``, the process's global DM slice, routes writes
    to its sibling file and filters loads to [lo, hi); keys in and out are
    then local (global - lo)."""

    def __init__(
        self, base_path: str, config_key: str,
        slice_bounds: tuple[int, int] | None = None,
    ) -> None:
        self.base_path = base_path
        self.config_key = config_key
        self.lo, self.hi = slice_bounds if slice_bounds else (0, None)
        self.write_path = (
            f"{base_path}.dm{self.lo}-{self.hi}" if slice_bounds else base_path
        )

    @staticmethod
    def make_key(cfg, fil, size: int, global_ndm: int) -> str:
        """The periodicity search's key: everything that changes its
        per-trial results, the observation's header included, so a store
        from one beam or file never resumes a search of another.
        ``global_ndm`` is the whole trial list's length. The same fields
        as the JAX package's key, so the two describe a search alike."""
        h = fil.header
        fields = (
            "v4-global-dm",  # per-trial payload format version
            fil.nsamps, fil.nchans, size, global_ndm,
            fil.tsamp, fil.fch1, fil.foff,
            getattr(h, "tstart", None), getattr(h, "source_name", None),
            getattr(h, "nbits", None),
            cfg.dm_start, cfg.dm_end, cfg.dm_tol, cfg.dm_pulse_width,
            cfg.acc_start, cfg.acc_end, cfg.acc_tol, cfg.acc_pulse_width,
            cfg.boundary_5_freq, cfg.boundary_25_freq, cfg.nharmonics,
            cfg.min_snr, cfg.min_freq, cfg.max_freq,
            cfg.killfilename, cfg.zapfilename,
        )
        return repr(fields)

    def _store_files(self) -> list[str]:
        """The base file and every per-slice sibling that exist, except
        quarantined ``*.corrupt`` ones."""
        paths = []
        if os.path.exists(self.base_path):
            paths.append(self.base_path)
        paths.extend(
            p for p in sorted(glob.glob(glob.escape(self.base_path) + ".dm*"))
            if not p.endswith(".corrupt")
        )
        return paths

    def _load_store(self, path: str) -> dict[int, tuple]:
        """One store file's entries in this slice, local keys; raises on
        damage."""
        out: dict[int, tuple] = {}
        with np.load(path, allow_pickle=False) as z:
            if str(z["config_key"]) != self.config_key:
                return out
            for d in z["dm_idxs"]:
                g = int(d)
                if g < self.lo or (self.hi is not None and g >= self.hi):
                    continue
                out[g - self.lo] = tuple(z[f"{n}_{g}"] for n in _NAMES)
        return out

    def load(self) -> dict[int, tuple]:
        """The union of every store file, filtered to this slice with local
        keys; {} where none exists or the key changed. A damaged file is
        warned about, renamed to ``*.corrupt`` and skipped."""
        if not self.base_path:
            return {}
        out: dict[int, tuple] = {}
        for path in self._store_files():
            try:
                part = self._load_store(path)
            except FileNotFoundError:
                continue
            except Exception as exc:
                qpath = path + ".corrupt"
                try:
                    os.replace(path, qpath)
                except OSError:
                    qpath = None
                log.warning(
                    "discarding unreadable checkpoint %s (%s: %.200s)%s; "
                    "restarting those trials", path, type(exc).__name__, exc,
                    f"; quarantined to {qpath}" if qpath else "",
                )
                continue
            out.update(part)
        return out

    def save(self, results: dict[int, tuple]) -> None:
        """Write every entry (local keys) under its global index and rename
        the file into place atomically, after an fsync, so the store
        survives a crash of the host as well as of the process."""
        if not self.base_path:
            return
        arrays: dict[str, np.ndarray] = {
            "config_key": np.asarray(self.config_key),
            "dm_idxs": np.asarray(sorted(k + self.lo for k in results), dtype=np.int64),
        }
        for d, entry in results.items():
            for n, a in zip(_NAMES, entry):
                arrays[f"{n}_{d + self.lo}"] = a
        dirname = os.path.dirname(os.path.abspath(self.write_path)) or "."
        os.makedirs(dirname, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.write_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

