"""Incremental trigger sink: confirmed candidates, as they happen (the
port's copy of the JAX package's peasoup_tpu/stream/triggers.py).

Two output forms, both updated while the stream runs (the batch
pipeline's write-at-the-end contract is exactly what a real-time
search cannot have):

* ``triggers.jsonl`` — one JSON object per confirmed candidate,
  appended and flushed as each cluster is confirmed. Line-oriented so
  a downstream consumer (``tail -f``, a VOEvent broker shim, a test)
  can react with no framing protocol; each record carries the full
  candidate plus emission metadata (monotonic trigger seq, wall-clock
  emission time, end-to-end latency from block arrival to emission).
* ``candidates.singlepulse`` — the rolling top-``limit`` (by S/N)
  confirmed so far, atomically rewritten (tmp + os.replace) in the
  batch ``.singlepulse`` column format, so the JAX package's parsers
  read a live run's output directory unchanged.
"""

from __future__ import annotations

import json
import os
import time

from ..io.output import write_singlepulse

TRIGGER_SCHEMA = "peasoup_tpu.trigger"
TRIGGER_VERSION = 1


class TriggerSink:
    """Append-only JSONL trigger stream + rolling .singlepulse table."""

    def __init__(self, outdir: str, limit: int = 1000, run_id: str = ""):
        self.outdir = outdir
        self.limit = int(limit)
        self.run_id = run_id
        os.makedirs(outdir, exist_ok=True)
        self.jsonl_path = os.path.join(outdir, "triggers.jsonl")
        self.table_path = os.path.join(outdir, "candidates.singlepulse")
        self._jsonl = open(self.jsonl_path, "a", encoding="ascii")
        self._best: list = []  # confirmed candidates, unsorted
        self.n_emitted = 0
        self._dirty = False

    def emit(self, cand, latency_s: float | None = None) -> dict:
        """Emit one confirmed SinglePulseCandidate as a trigger."""
        self.n_emitted += 1
        rec = {
            "schema": TRIGGER_SCHEMA,
            "version": TRIGGER_VERSION,
            "seq": self.n_emitted,
            "run_id": self.run_id,
            "emitted_unix": time.time(),
            "latency_s": (
                round(latency_s, 6) if latency_s is not None else None
            ),
            "dm": round(float(cand.dm), 6),
            "dm_idx": int(cand.dm_idx),
            "snr": round(float(cand.snr), 4),
            "time_s": round(float(cand.time_s), 9),
            "sample": int(cand.sample),
            "width": int(cand.width),
            "width_idx": int(cand.width_idx),
            "members": int(cand.members),
            "sample_lo": int(cand.sample_lo),
            "sample_hi": int(cand.sample_hi),
            "dm_idx_lo": int(cand.dm_idx_lo),
            "dm_idx_hi": int(cand.dm_idx_hi),
        }
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self._best.append(cand)
        if len(self._best) > 4 * max(1, self.limit):
            self._best = sorted(self._best, key=lambda c: -c.snr)[
                : self.limit
            ]
        self._dirty = True
        return rec

    def flush_table(self) -> None:
        """Atomically rewrite the rolling .singlepulse table."""
        if not self._dirty:
            return
        top = sorted(self._best, key=lambda c: -c.snr)[: self.limit]
        tmp = self.table_path + ".tmp"
        write_singlepulse(tmp, top)
        os.replace(tmp, self.table_path)
        self._dirty = False

    @property
    def candidates(self) -> list:
        """Confirmed candidates so far, S/N-descending, limited."""
        return sorted(self._best, key=lambda c: -c.snr)[: self.limit]

    def close(self) -> None:
        # always leave a table behind, even for a zero-trigger run
        self._dirty = self._dirty or not os.path.exists(self.table_path)
        self.flush_table()
        self._jsonl.close()
