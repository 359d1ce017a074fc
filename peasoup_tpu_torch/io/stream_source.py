"""Streaming block sources: fixed-shape ingest for the real-time search,
the port's copy of the JAX package's peasoup_tpu/io/stream_source.py.

The streaming driver (peasoup_tpu_torch/stream/) consumes an endless
filterbank stream as a sequence of fixed-size StreamBlock objects, every
one (block_samples, nchans). Three sources implement the same
iterator protocol:

* :class:`ReplaySource` replays a recorded, fully read filterbank at a
  real-time factor (``rate=2`` releases data twice as fast as the
  observation's sampling clock; ``rate=0`` as fast as the consumer drains).
  The deterministic source for tests and benchmarks, and the CLI's
  ``--replay``.
* :class:`FileTailSource` tails a growing sigproc filterbank on disk. The
  stream ends at a ``<path>.complete`` marker file or after the file has
  been idle for ``idle_timeout_s``.
* :class:`DadaStreamSource` reads the numbered ``*.dada`` segment files a
  PSRDADA file writer dumps (each a 4096-byte ``KEY value`` header and a
  payload) in name order, tailing the directory until an ``obs.complete``
  marker or the idle timeout. TSAMP follows PSRDADA (microseconds); the
  band is rebuilt from FREQ (centre) and BW as a descending-frequency
  filterbank.

All sources zero-pad the final partial block to the fixed shape and mark
it with ``nvalid < block_samples`` and ``final=True``; the driver masks the
padding out of the search. A read that fails with a transient error
(:func:`is_transient`) is polled again, bounded by the idle timeout. Each
source carries the JAX package's ``fil.read`` fault seam; the replay's is
absorbed by the shared retry policy (``IO_RETRY``), the tail's and the
DADA reader's by the polling.
"""

from __future__ import annotations

import glob
import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..obs.log import get_logger
from ..resilience import IO_RETRY, faults, is_transient
from .dada import DADA_HDR_SIZE, DadaHeader
from .sigproc import read_sigproc_header, unpack_bits

log = get_logger("stream_source")


@dataclass(frozen=True)
class StreamFormat:
    """The per-stream metadata a DM plan needs (one source = one
    contiguous band/sampling configuration)."""

    nchans: int
    nbits: int
    tsamp: float  # seconds
    fch1: float  # MHz, first channel centre
    foff: float  # MHz, channel step (negative = descending band)
    source_name: str = ""
    tstart: float = 0.0  # MJD where known


@dataclass
class StreamBlock:
    """One fixed-shape slab of the stream."""

    seq: int
    start_sample: int  # absolute sample index of row 0
    data: np.ndarray  # (block_samples, nchans) uint8, zero-padded tail
    nvalid: int  # leading valid rows (== block_samples mid-stream)
    t_arrival_s: float = field(
        default_factory=time.perf_counter
    )  # host receipt time (perf_counter clock)
    final: bool = False  # no further blocks will follow


class StreamSource:
    """Iterator protocol shared by every source: ``format`` metadata
    plus a ``blocks()`` generator of :class:`StreamBlock`."""

    format: StreamFormat
    block_samples: int

    def blocks(self):
        raise NotImplementedError

    def close(self) -> None:
        pass


def _blocks_from_array(
    data: np.ndarray, block_samples: int, start_seq: int = 0
):
    """Chop an (nsamps, nchans) array into fixed StreamBlocks (the
    final partial block zero-padded + flagged)."""
    nsamps = data.shape[0]
    nblocks = max(1, -(-nsamps // block_samples))
    for k in range(nblocks):
        lo = k * block_samples
        chunk = data[lo : lo + block_samples]
        nvalid = chunk.shape[0]
        if nvalid < block_samples:
            chunk = np.concatenate(
                [
                    chunk,
                    np.zeros(
                        (block_samples - nvalid, data.shape[1]),
                        dtype=data.dtype,
                    ),
                ]
            )
        yield StreamBlock(
            seq=start_seq + k,
            start_sample=lo,
            data=np.ascontiguousarray(chunk, dtype=np.uint8),
            nvalid=nvalid,
            final=(k == nblocks - 1),
        )


class ReplaySource(StreamSource):
    """Replay a recorded filterbank at ``rate`` x real time.

    ``rate > 0`` paces block k's release to
    ``t0 + (k+1) * block_samples * tsamp / rate`` — the wall-clock a
    live recorder running ``rate`` times faster than the observation
    would deliver it; ``rate = 0`` releases blocks as fast as the
    consumer drains them (bounded-queue backpressure still applies).
    """

    def __init__(self, fil, block_samples: int, rate: float = 0.0):
        self.fil = fil
        self.block_samples = int(block_samples)
        self.rate = float(rate)
        h = fil.header
        self.format = StreamFormat(
            nchans=fil.nchans, nbits=fil.nbits, tsamp=fil.tsamp,
            fch1=fil.fch1, foff=fil.foff,
            source_name=h.source_name, tstart=h.tstart,
        )

    def blocks(self):
        t0 = time.perf_counter()
        data = self.fil.data  # unpacks sub-byte payloads once
        for blk in _blocks_from_array(data, self.block_samples):
            # the fault seam: a replayed recording is in RAM, so a flaky
            # read costs nothing to redo and the retry policy absorbs it
            IO_RETRY.call(faults.fire, "fil.read", f"replay:seq{blk.seq}",
                          site="fil.read", context=f"replay:seq{blk.seq}")
            if self.rate > 0:
                release = t0 + (
                    (blk.seq + 1) * self.block_samples * self.fil.tsamp
                ) / self.rate
                delay = release - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            blk.t_arrival_s = time.perf_counter()
            yield blk


class FileTailSource(StreamSource):
    """Tail a growing sigproc filterbank file.

    The header must be complete on disk before ``blocks()`` yields
    anything (we poll for it); payload bytes are then consumed as they
    are appended. The stream ends when ``<path>.complete`` exists and
    every remaining byte has been read, or when the file stops growing
    for ``idle_timeout_s`` seconds.
    """

    def __init__(
        self,
        path: str,
        block_samples: int,
        poll_s: float = 0.05,
        idle_timeout_s: float = 10.0,
        complete_marker: str | None = None,
    ):
        self.path = path
        self.block_samples = int(block_samples)
        self.poll_s = float(poll_s)
        self.idle_timeout_s = float(idle_timeout_s)
        self.complete_marker = complete_marker or (path + ".complete")
        self._hdr = self._wait_for_header()
        h = self._hdr
        self.format = StreamFormat(
            nchans=h.nchans, nbits=h.nbits, tsamp=h.tsamp,
            fch1=h.fch1, foff=h.foff,
            source_name=h.source_name, tstart=h.tstart,
        )

    def _wait_for_header(self):
        deadline = time.perf_counter() + self.idle_timeout_s
        while True:
            try:
                with open(self.path, "rb") as f:
                    return read_sigproc_header(f)
            except Exception:  # truncated header mid-write, or absent
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"no complete sigproc header at {self.path} "
                        f"after {self.idle_timeout_s}s"
                    )
                time.sleep(self.poll_s)

    def _ended(self) -> bool:
        return os.path.exists(self.complete_marker)

    def blocks(self):
        h = self._hdr
        row_bits = h.nchans * h.nbits
        # consume whole bit-packing groups so unpack_bits sees complete
        # bytes: with sub-byte samples a row is still whole bytes when
        # nchans*nbits % 8 == 0 (every real filterbank we read)
        row_bytes = row_bits // 8
        if row_bits % 8:
            raise ValueError(
                f"cannot tail {self.path}: nchans*nbits={row_bits} is "
                "not byte-aligned"
            )
        blk_bytes = row_bytes * self.block_samples
        offset = h.size
        seq = 0
        start = 0
        last_growth = time.perf_counter()
        pending = b""
        while True:
            try:
                faults.fire("fil.read", context=f"tail:{self.path}@{offset}")
                size = os.path.getsize(self.path)
                avail = size - offset
                if avail > 0:
                    take = min(avail, 4 * blk_bytes)
                    with open(self.path, "rb") as f:
                        f.seek(offset)
                        pending += f.read(take)
                    offset += take
                    last_growth = time.perf_counter()
            except OSError as exc:
                # a tailed file can vanish briefly (recorder rotating /
                # re-linking) or throw EIO on a flaky mount; both are
                # transient AT THIS SEAM — keep polling, bounded by the
                # idle timeout (last_growth stops advancing). Anything
                # else is a real error.
                if not (
                    is_transient(exc) or isinstance(exc, FileNotFoundError)
                ):
                    raise
                log.warning(
                    "transient tail-read failure on %s (%s: %.200s); "
                    "retrying", self.path, type(exc).__name__, exc,
                )
                time.sleep(self.poll_s)
            if self._ended():
                # re-stat: the final append may have landed between our
                # read and the completion marker (stat failure defers
                # the decision to the next poll)
                try:
                    ended = offset >= os.path.getsize(self.path)
                except OSError:
                    ended = False
            else:
                ended = False
            idle = (
                time.perf_counter() - last_growth > self.idle_timeout_s
            )
            while len(pending) >= blk_bytes:
                raw = np.frombuffer(pending[:blk_bytes], dtype=np.uint8)
                pending = pending[blk_bytes:]
                data = unpack_bits(raw, h.nbits).reshape(
                    self.block_samples, h.nchans
                )
                more = len(pending) >= blk_bytes or not (ended or idle)
                yield StreamBlock(
                    seq=seq, start_sample=start, data=data,
                    nvalid=self.block_samples,
                    final=not more and not pending,
                )
                seq += 1
                start += self.block_samples
            if ended or idle:
                if idle and not ended:
                    log.warning(
                        "%s idle for %.1fs without a completion marker; "
                        "ending the stream", self.path, self.idle_timeout_s,
                    )
                break
            time.sleep(self.poll_s)
        nrows = len(pending) // row_bytes
        if nrows:
            raw = np.frombuffer(
                pending[: nrows * row_bytes], dtype=np.uint8
            )
            data = unpack_bits(raw, h.nbits).reshape(nrows, h.nchans)
            for blk in _blocks_from_array(
                data, self.block_samples, start_seq=seq
            ):
                blk.start_sample += start
                blk.t_arrival_s = time.perf_counter()
                yield blk


class DadaStreamSource(StreamSource):
    """Read a PSRDADA-style segment stream: ``*.dada`` files in one
    directory (or a single file), each DADA_HDR_SIZE header bytes +
    an 8-bit (nsamps, nchan) payload, consumed in name order and
    tailed for new segments."""

    def __init__(
        self,
        path: str,
        block_samples: int,
        poll_s: float = 0.05,
        idle_timeout_s: float = 10.0,
        complete_marker: str | None = None,
    ):
        self.path = path
        self.block_samples = int(block_samples)
        self.poll_s = float(poll_s)
        self.idle_timeout_s = float(idle_timeout_s)
        self._dir = path if os.path.isdir(path) else None
        self.complete_marker = complete_marker or (
            os.path.join(path, "obs.complete")
            if self._dir
            else path + ".complete"
        )
        first = self._segments()
        deadline = time.perf_counter() + idle_timeout_s
        while not first:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"no .dada segments under {path}")
            time.sleep(poll_s)
            first = self._segments()
        h = DadaHeader.fromfile(first[0])
        if h.nbit not in (0, 8):
            raise ValueError(
                f"DadaStreamSource reads 8-bit payloads; {first[0]} "
                f"has NBIT {h.nbit}"
            )
        nchan = max(1, h.nchan)
        bw = abs(h.bw)
        foff = -(bw / nchan) if bw else -1.0
        # FREQ is the band centre: channel 0 sits half the band above
        # it (descending-frequency convention, like our filterbanks)
        fch1 = h.freq + (bw - abs(foff)) / 2.0 if bw else h.freq
        self.header = h
        self.format = StreamFormat(
            nchans=nchan, nbits=8,
            tsamp=h.tsamp * 1e-6,  # PSRDADA TSAMP is microseconds
            fch1=fch1, foff=foff, source_name=h.source_name,
        )

    def _segments(self) -> list[str]:
        if self._dir is None:
            return [self.path] if os.path.exists(self.path) else []
        return sorted(glob.glob(os.path.join(self._dir, "*.dada")))

    def _ended(self) -> bool:
        return os.path.exists(self.complete_marker)

    def blocks(self):
        nchan = self.format.nchans
        blk_bytes = nchan * self.block_samples
        consumed: set[str] = set()
        pending = b""
        seq = 0
        start = 0
        last_growth = time.perf_counter()
        while True:
            segs = [s for s in self._segments() if s not in consumed]
            for seg in segs:
                try:
                    faults.fire("fil.read", context=f"dada:{seg}")
                    with open(seg, "rb") as f:
                        f.seek(DADA_HDR_SIZE)
                        pending += f.read()
                except OSError as exc:
                    # a segment mid-rename or a flaky mount: leave it
                    # unconsumed and re-poll (idle timeout bounds this)
                    if not (
                        is_transient(exc)
                        or isinstance(exc, FileNotFoundError)
                    ):
                        raise
                    log.warning(
                        "transient segment read failure on %s "
                        "(%s: %.200s); retrying", seg,
                        type(exc).__name__, exc,
                    )
                    break
                consumed.add(seg)
                last_growth = time.perf_counter()
            ended = self._ended() and not [
                s for s in self._segments() if s not in consumed
            ]
            idle = (
                time.perf_counter() - last_growth > self.idle_timeout_s
            )
            while len(pending) >= blk_bytes:
                raw = np.frombuffer(pending[:blk_bytes], dtype=np.uint8)
                pending = pending[blk_bytes:]
                more = len(pending) >= blk_bytes or not (ended or idle)
                yield StreamBlock(
                    seq=seq, start_sample=start,
                    data=raw.reshape(self.block_samples, nchan),
                    nvalid=self.block_samples,
                    final=not more and not pending,
                )
                seq += 1
                start += self.block_samples
            if ended or idle:
                if idle and not ended:
                    log.warning(
                        "%s idle for %.1fs without a completion marker; "
                        "ending the stream", self.path,
                        self.idle_timeout_s,
                    )
                break
            time.sleep(self.poll_s)
        nrows = len(pending) // nchan
        if nrows:
            raw = np.frombuffer(pending[: nrows * nchan], dtype=np.uint8)
            for blk in _blocks_from_array(
                raw.reshape(nrows, nchan), self.block_samples,
                start_seq=seq,
            ):
                blk.start_sample += start
                blk.t_arrival_s = time.perf_counter()
                yield blk
