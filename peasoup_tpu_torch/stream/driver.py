"""The streaming real-time single-pulse search on one CUDA device: the JAX
package's stream/driver.py.

A reader thread moves fixed-size blocks from a StreamSource
(io/stream_source.py) into a bounded queue with a backpressure policy
(stream/queue.py); the main loop assembles overlapping fixed-shape input
windows, dedisperses each through the dedisperse kernel (the plan's delay
tables are built and uploaded once a run), runs the streaming step
(ops/streaming.py: the boxcar kernel's width sweep over the carried tail
and the new chunk, the dec-fold and the event compaction in torch),
confirms the friends-of-friends clusters no later event can join (the
batch search's pipeline/single_pulse.py clustering) and emits them as
triggers (stream/triggers.py).

* Fixed shapes: input window ``(chunk + max_delay, nchans)``, dedispersed
  chunk ``(ndm, chunk)``, search window ``(ndm, hold + chunk)``; only the
  validity span and the emit range change from chunk to chunk.
* Boundary exactness: the carried ``hold`` tail (at least the widest
  boxcar) and the deferred emission give every event its full context, so
  a replayed recording gives the batch ``spsearch`` candidates (S/N differs
  by the chunk-local normalisation moments).
* Bounded lag, counted loss: under ``drop_oldest`` the queue drops the
  oldest block to admit a new one; the gap is zero-filled (keeping the
  stream's sample clock) and counted per block and sample.

Before ingest the kernels the stream launches are built and loaded
(``warmup``), so ``nvcc`` never lands in the first chunk's latency.

The run records the JAX driver's telemetry: the ``streaming`` status
section (heartbeat and manifest), the ``stream_*`` events and gauges, and,
with ``metrics_jsonl``, the chunk latency, queue depth and trigger series
(obs/metrics.py). The reader thread runs under the resilience crash guard.
The JAX package's counts of compiled programs are 0 here: torch compiles
no program per shape, so ``jit_programs_steady`` cannot grow and the JAX
driver's ``stream_steady_recompile`` event has no counterpart.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..io.masks import read_killfile
from ..obs.log import get_logger
from ..obs.metrics import MetricsRecorder
from ..obs.telemetry import current as current_telemetry
from ..ops.dedisperse import dedisperse, output_scale
from ..ops.singlepulse import default_widths
from ..ops.streaming import make_stream_chunk_fn, stream_geometry
from ..pipeline.single_pulse import _EVENT_DTYPE, candidates_from_clusters, cluster_events_fof
from ..plan.dm_plan import DMPlan
from .queue import BoundedBlockQueue
from .triggers import TriggerSink

log = get_logger("stream")

# the status section's schema version (the JAX driver's)
STREAM_STATUS_VERSION = 1

# the kernels a chunk launches on the card
STREAM_KERNELS = ("dedisperse", "boxcar")


@dataclass
class StreamConfig:
    """The JAX package's StreamConfig with its defaults. The DM, width and
    threshold knobs mirror SinglePulseConfig, so a replayed stream is
    comparable to a batch ``spsearch`` of the same recording.
    ``metrics_jsonl`` names the time-series metrics file ('' = none)."""

    outdir: str = "."
    killfilename: str = ""
    dm_start: float = 0.0
    dm_end: float = 100.0
    dm_tol: float = 1.10
    dm_pulse_width: float = 64.0
    min_snr: float = 6.0
    n_widths: int = 12
    max_width: int = 0
    max_events: int = 256
    decimate: int = 32
    time_link: float = 1.0
    dm_link: int = 2
    limit: int = 1000  # rolling .singlepulse table size
    chunk_samples: int = 16384  # dedispersed samples per chunk
    hold_samples: int = 0  # carried tail; 0 = auto from the widths
    queue_blocks: int = 8  # bounded queue capacity (source blocks)
    policy: str = "block"  # or "drop_oldest"
    latency_slo_s: float = 2.0  # per-chunk arrival -> events budget
    max_chunks: int = 0  # stop after N chunks (0 = at the stream's end)
    warmup: bool = True  # build and load the kernels before ingest
    flush_every: int = 1  # rolling-table rewrite cadence (chunks)
    metrics_jsonl: str = ""


@dataclass
class StreamResult:
    """What a drained stream leaves (beside the trigger files the sink
    wrote while it ran)."""

    candidates: list
    dm_list: np.ndarray
    widths: tuple[int, ...]
    n_chunks: int = 0
    n_triggers: int = 0
    n_events: int = 0
    n_overflowed: int = 0
    total_out_samples: int = 0
    drops: dict = field(default_factory=dict)
    latency: dict = field(default_factory=dict)
    timers: dict = field(default_factory=dict)


def _percentile(sorted_xs: list, frac: float) -> float | None:
    if not sorted_xs:
        return None
    return sorted_xs[min(len(sorted_xs) - 1, int(frac * len(sorted_xs)))]


class StreamingSearch:
    """Consume a StreamSource chunk by chunk and emit live triggers."""

    def __init__(self, config: StreamConfig, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # aggregates read by the status section (the heartbeat's thread)
        # while the main loop writes them
        self._latencies: list[float] = []
        self._slo_misses = 0
        self._gap_samples = 0
        self._chunks_done = 0
        self._n_events = 0
        self._n_overflowed = 0
        self._received_samples = 0
        self._first_arrival: float | None = None
        self._last_arrival: float | None = None
        self._pending = np.zeros(0, dtype=_EVENT_DTYPE)
        self._spans: list[tuple[int, int, float]] = []  # (lo, hi, t_ready)
        self._queue: BoundedBlockQueue | None = None
        self._sink: TriggerSink | None = None
        self._reader_error: BaseException | None = None

    def plan_for(self, fmt) -> DMPlan:
        cfg = self.config
        killmask = None
        if cfg.killfilename:
            killmask = read_killfile(cfg.killfilename, fmt.nchans)
        return DMPlan.create(
            nsamps=cfg.chunk_samples,  # out_nsamps is unused here
            nchans=fmt.nchans, tsamp=fmt.tsamp, fch1=fmt.fch1, foff=fmt.foff,
            dm_start=cfg.dm_start, dm_end=cfg.dm_end, pulse_width=cfg.dm_pulse_width,
            tol=cfg.dm_tol, killmask=killmask,
        )

    def widths_for(self) -> tuple[int, ...]:
        """The stream's boxcar bank: octave-spaced, capped at a quarter
        chunk (as the batch search caps at a quarter trial) and by
        cfg.max_width."""
        cfg = self.config
        cap = max(1, cfg.chunk_samples // 4)
        if cfg.max_width:
            cap = min(cap, cfg.max_width)
        return default_widths(cfg.n_widths, max_width=cap)

    def _read(self, source, q: BoundedBlockQueue, tel) -> None:
        """The reader thread: every block of the source into the queue,
        under the resilience crash guard (a crash emits
        ``thread_crashed``); an error is kept for the main loop, which
        raises it (a stream cannot go on without its source)."""
        from ..resilience import guard_thread

        def _pump() -> None:
            for blk in source.blocks():
                q.put(blk)

        try:
            exc = guard_thread("peasoup-stream-reader", _pump, telemetry=tel)
            if exc is not None:
                self._reader_error = exc
                tel.event("stream_reader_error", error=f"{exc!s:.300}")
        finally:
            q.close()

    def _status_section(self) -> dict:
        """The ``streaming`` status section (heartbeat and manifest): the
        JAX driver's keys; its compiled-program counts are 0 here."""
        cfg = self.config
        q = self._queue
        with self._lock:
            lats = sorted(self._latencies)
            doc = {
                "version": STREAM_STATUS_VERSION,
                "policy": cfg.policy,
                "chunk_samples": cfg.chunk_samples,
                "chunks_done": self._chunks_done,
                "events": self._n_events,
                "pending_events": len(self._pending),
                "input_samples": self._received_samples,
                "gap_samples": self._gap_samples,
                "jit_programs_first_chunk": 0,
                "jit_programs_steady": 0,
            }
            first, last = self._first_arrival, self._last_arrival
        if first is not None and last is not None and last > first:
            doc["input_rate_sps"] = round(self._received_samples / (last - first), 3)
        else:
            doc["input_rate_sps"] = None
        if q is not None:
            doc["queue_depth_blocks"] = q.depth
            doc["queue_capacity_blocks"] = q.capacity
            doc["chunks_behind"] = round(q.queued_samples / max(1, cfg.chunk_samples), 3)
            doc["drops"] = q.drops.to_doc()
        if self._sink is not None:
            doc["triggers"] = self._sink.n_emitted
        doc["latency_s"] = {
            "slo": cfg.latency_slo_s,
            "p50": _percentile(lats, 0.50),
            "p95": _percentile(lats, 0.95),
            "max": lats[-1] if lats else None,
            "misses": self._slo_misses,
        }
        return doc

    def _confirm(self, frontier: float, widths, dm_list, tsamp: float) -> list:
        """Confirm, and take from the pending events, every
        friends-of-friends cluster no later event can join: a new event's
        sample is >= ``frontier``, and a link reaches at most ``time_link
        * max(width) + decimate`` samples back."""
        cfg = self.config
        with self._lock:
            pending = self._pending
        if not len(pending):
            return []
        clusters = cluster_events_fof(
            pending, widths, time_link=cfg.time_link, dm_link=cfg.dm_link,
            dec=cfg.decimate,
        )
        horizon = frontier - (cfg.time_link * float(max(widths)) + cfg.decimate)
        done = [cl for cl in clusters if pending[cl]["sample"].max() < horizon]
        if not done:
            return []
        cands = candidates_from_clusters(pending, done, widths, dm_list, tsamp)
        keep = np.ones(len(pending), dtype=bool)
        keep[np.concatenate(done)] = False
        with self._lock:
            self._pending = pending[keep]
        return sorted(cands, key=lambda c: c.sample)

    def _latency_for_sample(self, sample: int, now: float) -> float | None:
        """A trigger's end-to-end latency: its emission time less the
        arrival of the newest block its chunk's search needed."""
        with self._lock:
            for lo, hi, t_ready in self._spans:
                if lo <= sample < hi:
                    return now - t_ready
        return None

    def _emit(self, sink: TriggerSink, cands: list, tel) -> None:
        now = time.perf_counter()
        for cand in cands:
            rec = sink.emit(cand, latency_s=self._latency_for_sample(cand.sample, now))
            tel.event("stream_trigger", seq=rec["seq"], dm=rec["dm"], snr=rec["snr"],
                      sample=rec["sample"], width=rec["width"],
                      latency_s=rec["latency_s"])

    def run(self, source) -> StreamResult:
        cfg = self.config
        dev = self.device
        tel = current_telemetry()
        timers = {"dedispersion": 0.0, "searching": 0.0, "clustering": 0.0}
        t_total = time.perf_counter()
        fmt = source.format

        tel.set_stage("plan")
        t0 = time.perf_counter()
        plan = self.plan_for(fmt)
        widths = self.widths_for()
        dec, chunk = cfg.decimate, cfg.chunk_samples
        hold = stream_geometry(widths, chunk, dec, cfg.hold_samples)
        md = plan.max_delay
        w_in, w = chunk + md, hold + chunk
        ndm = plan.ndm
        scale = output_scale(fmt.nbits, int(plan.killmask.sum()))
        delays = plan.delay_samples()
        chunk_fn = make_stream_chunk_fn(widths, float(cfg.min_snr), cfg.max_events, dec,
                                        hold, chunk)
        timers["plan"] = time.perf_counter() - t0
        tel.set_context(stream_chunk_samples=chunk, stream_hold_samples=hold,
                        stream_policy=cfg.policy, stream_slo_s=cfg.latency_slo_s)
        tel.gauge("stream.ndm", ndm)
        tel.gauge("stream.slo_s", cfg.latency_slo_s)
        tel.event("stream_plan", ndm=ndm, chunk=chunk, hold=hold, max_delay=md,
                  widths=[int(x) for x in widths],
                  block_samples=int(source.block_samples), policy=cfg.policy)
        log.info("streaming plan: %d DM trials, chunk %d (+%d hold), max delay %d, "
                 "widths %s", ndm, chunk, hold, md, list(widths))

        if cfg.warmup:
            tel.set_stage("warmup")
            t0 = time.perf_counter()
            if dev.type == "cuda":
                kernels.load(STREAM_KERNELS)
                torch.cuda.synchronize(dev)
            timers["warmup"] = time.perf_counter() - t0
            # the kernels' libraries are built once per source, so no
            # program is compiled per shape (the JAX event's counts are 0)
            tel.event("stream_warmup", seconds=round(timers["warmup"], 3), compiled=0,
                      cache_hits=0, errors=[])

        tail = torch.zeros((ndm, hold), dtype=torch.uint8, device=dev)
        metrics = MetricsRecorder(
            cfg.metrics_jsonl or os.path.join(cfg.outdir, "metrics.jsonl"),
            enabled=bool(cfg.metrics_jsonl),
        )
        sink = TriggerSink(cfg.outdir, limit=cfg.limit, run_id=tel.run_id)
        self._sink = sink
        q = BoundedBlockQueue(cfg.queue_blocks, cfg.policy)
        self._queue = q
        tel.set_status_section("streaming", self._status_section)
        # the reader runs in a copy of this thread's context, so the run's
        # ambient telemetry (and the resilience layer's retry and fault
        # events) cross into it
        ctx = contextvars.copy_context()
        reader = threading.Thread(target=lambda: ctx.run(self._read, source, q, tel),
                                  name="peasoup-stream-reader", daemon=True)
        reader.start()
        tel.set_stage("streaming")

        nchans = fmt.nchans
        buf = np.zeros((0, nchans), dtype=np.uint8)
        expected = 0  # next absolute input sample the reader owes
        valid_in = None  # total input samples, once the final block is in
        ended = False
        drop_reported = 0
        total_out = None
        t_last_status = 0.0
        k = 0
        while True:
            # the input window [k*chunk, k*chunk + w_in)
            t_ready = None
            while buf.shape[0] < w_in and not ended:
                blk = q.get(timeout=0.25)
                if blk is None:
                    ended = q.closed
                    continue
                with self._lock:
                    if self._first_arrival is None:
                        self._first_arrival = blk.t_arrival_s
                    self._last_arrival = blk.t_arrival_s
                    self._received_samples += int(blk.nvalid)
                t_ready = blk.t_arrival_s
                if blk.start_sample > expected:
                    gap = blk.start_sample - expected
                    with self._lock:
                        self._gap_samples += gap
                    tel.event("stream_gap_fill", samples=int(gap), at_sample=int(expected))
                    log.warning("gap of %d samples at %d (dropped upstream); "
                                "zero-filling", gap, expected)
                    buf = np.concatenate([buf, np.zeros((gap, nchans), np.uint8)])
                    expected += gap
                data = blk.data[: blk.nvalid]
                if blk.start_sample < expected:  # overlap: trim stale rows
                    data = data[expected - blk.start_sample :]
                if len(data):
                    buf = np.concatenate([buf, data])
                expected = max(expected, blk.start_sample + blk.nvalid)
                if blk.final:
                    valid_in = blk.start_sample + blk.nvalid
                drops = q.drops
                if drops.blocks > drop_reported:
                    tel.event("stream_drop", blocks=int(drops.blocks),
                              samples=int(drops.samples), policy=cfg.policy)
                    log.warning("%d blocks (%d samples) dropped under policy %s",
                                drops.blocks, drops.samples, cfg.policy)
                    drop_reported = drops.blocks
            if self._reader_error is not None:
                raise RuntimeError("stream reader failed") from self._reader_error
            if valid_in is None and ended:
                valid_in = expected
            final = ended and buf.shape[0] < w_in
            if valid_in is not None:
                total_out = max(0, valid_in - md)
            origin = k * chunk - hold  # absolute sample of window[0]
            valid_lo = hold if k == 0 else 0
            nvalid = w
            if final:
                if total_out is None or total_out - origin <= valid_lo:
                    break  # nothing valid left to emit
                nvalid = min(w, total_out - origin)
            if cfg.max_chunks and k + 1 >= cfg.max_chunks:
                final = True
            if t_ready is None:
                t_ready = time.perf_counter()

            window_in = buf[:w_in]
            if window_in.shape[0] < w_in:
                window_in = np.concatenate(
                    [window_in, np.zeros((w_in - window_in.shape[0], nchans), np.uint8)]
                )
            t0 = time.perf_counter()
            # the dispatch only: the card's time lands in "searching"
            with torch.profiler.record_function("Dedisperse"):
                new = dedisperse(torch.from_numpy(window_in).to(dev), delays,
                                 plan.killmask, chunk, scale=scale)
            t1 = time.perf_counter()
            timers["dedispersion"] += t1 - t0
            emit_lo = valid_lo // dec
            emit_hi = (w // dec) if final else (chunk // dec)
            with torch.profiler.record_function("SP-Chunk"):
                ss, sw, ssn, sc = (
                    a.cpu().numpy()
                    for a in chunk_fn(tail, new, valid_lo, nvalid, emit_lo, emit_hi)
                )
            timers["searching"] += time.perf_counter() - t1
            tail = new[:, chunk - hold :]
            buf = buf[chunk:]
            t_done = time.perf_counter()

            # events at absolute samples: the first K of each trial, in
            # ascending time, trials in order
            kmax = ss.shape[1]
            d_idx, i_idx = np.nonzero(np.arange(kmax)[None, :] < np.minimum(sc, kmax)[:, None])
            recs = np.zeros(len(d_idx), dtype=_EVENT_DTYPE)
            recs["dm_idx"] = d_idx
            recs["sample"] = origin + ss[d_idx, i_idx].astype(np.int64)
            recs["width_idx"] = sw[d_idx, i_idx]
            recs["snr"] = ssn[d_idx, i_idx]
            emit_hi_abs = origin + emit_hi * dec
            lat = t_done - t_ready
            with self._lock:
                self._n_overflowed += int((sc > kmax).sum())
                self._pending = np.concatenate([self._pending, recs])
                self._n_events += len(recs)
                self._chunks_done = k + 1
                self._spans = (self._spans + [(origin, emit_hi_abs, t_ready)])[-64:]
                self._latencies = (self._latencies + [lat])[-1024:]
                miss = 0
                if lat > cfg.latency_slo_s:
                    self._slo_misses += 1
                    miss = self._slo_misses
            if miss:
                tel.event("stream_slo_miss", chunk=k, latency_s=round(lat, 4),
                          slo_s=cfg.latency_slo_s, misses=miss)
                log.warning("chunk %d missed the latency budget: %.4f s > %.4f s", k,
                            lat, cfg.latency_slo_s)
            metrics.observe("chunk_latency_seconds", lat)
            metrics.counter("chunks_total")
            if miss:
                metrics.counter("chunk_slo_miss_total")

            t0 = time.perf_counter()
            frontier = float("inf") if final else float(emit_hi_abs)
            confirmed = self._confirm(frontier, widths, plan.dm_list, fmt.tsamp)
            self._emit(sink, confirmed, tel)
            if confirmed:
                metrics.counter("triggers_total", len(confirmed))
            if confirmed or k % max(1, cfg.flush_every) == 0:
                sink.flush_table()
            timers["clustering"] += time.perf_counter() - t0
            tel.set_progress(k + 1, unit="chunks")
            if t_done - t_last_status > 1.0:
                t_last_status = t_done
                st = self._status_section()
                metrics.gauge("queue_depth_blocks", st.get("queue_depth_blocks", 0) or 0)
                tel.gauge("stream.queue_depth", st.get("queue_depth_blocks", 0))
                tel.gauge("stream.triggers", sink.n_emitted)
                tel.gauge("stream.drop_samples", st["drops"]["samples"] + st["gap_samples"])
            k += 1
            if final:
                break

        tel.set_stage("drain")
        self._emit(sink, self._confirm(float("inf"), widths, plan.dm_list, fmt.tsamp), tel)
        sink.close()
        source.close()
        reader.join(timeout=5.0)
        timers["total"] = time.perf_counter() - t_total
        drops = q.drops
        tel.gauge("stream.chunks", self._chunks_done)
        tel.gauge("stream.triggers", sink.n_emitted)
        tel.gauge("stream.events", self._n_events)
        tel.gauge("stream.drop_blocks", drops.blocks)
        tel.gauge("stream.drop_samples", drops.samples)
        tel.gauge("stream.gap_samples", self._gap_samples)
        tel.gauge("stream.slo_misses", self._slo_misses)
        tel.gauge("stream.jit_programs_steady", 0)
        if self._n_overflowed:
            log.warning("%d chunk-trials overflowed the %d-event compaction",
                        self._n_overflowed, cfg.max_events)
            tel.event("sp_event_overflow", trials=self._n_overflowed,
                      max_events=cfg.max_events)
        tel.event("stream_drained", chunks=self._chunks_done, triggers=sink.n_emitted,
                  events=self._n_events, drops=drops.to_doc(),
                  gap_samples=self._gap_samples, slo_misses=self._slo_misses,
                  jit_programs_steady=0)
        lats = sorted(self._latencies)
        log.info("stream drained: %d chunks, %d events, %d triggers, %d dropped blocks",
                 k, self._n_events, sink.n_emitted, drops.blocks)
        return StreamResult(
            candidates=sink.candidates, dm_list=plan.dm_list, widths=widths,
            n_chunks=k, n_triggers=sink.n_emitted, n_events=self._n_events,
            n_overflowed=self._n_overflowed, total_out_samples=int(total_out or 0),
            drops={**drops.to_doc(), "gap_samples": self._gap_samples},
            latency={
                "slo": cfg.latency_slo_s, "p50": _percentile(lats, 0.50),
                "p95": _percentile(lats, 0.95), "max": lats[-1] if lats else None,
                "misses": self._slo_misses,
            },
            timers=timers,
        )
