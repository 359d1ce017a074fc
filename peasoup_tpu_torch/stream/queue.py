"""Bounded ingest queue with explicit backpressure policy: the port's copy
of the JAX package's peasoup_tpu/stream/queue.py.

The reader thread (source -> queue) and the search loop (queue ->
device) are decoupled by a bounded FIFO of StreamBlock objects.
When the search falls behind and the queue fills, the configured
policy decides what gives:

* ``"block"`` — the reader blocks until the search drains a slot.
  Backpressure propagates to the source: a replay source simply
  pauses; a live ring-buffer source falls behind real time (visible
  in the chunks' latency) and may overrun upstream of us, which is the
  operator's capacity signal.
* ``"drop_oldest"`` — the OLDEST queued block is dropped to admit the
  new one, keeping latency bounded at the cost of sensitivity: the
  search loop zero-fills the gap (the drop is accounted per block and
  per sample, and logged by the driver). This is the live-trigger posture: stale data is worth less than fresh
  data when the point is catching a pulse as it arrives.

Drop accounting lives here (``drops`` property); gap *repair* (zero
filling) lives in the driver, which knows the sample geometry.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

POLICIES = ("block", "drop_oldest")


@dataclass
class DropStats:
    blocks: int = 0
    samples: int = 0

    def to_doc(self) -> dict:
        return {"blocks": self.blocks, "samples": self.samples}


class BoundedBlockQueue:
    """Thread-safe bounded FIFO of StreamBlocks with a drop policy."""

    def __init__(self, capacity: int, policy: str = "block"):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown backpressure policy {policy!r} "
                f"(expected one of {POLICIES})"
            )
        self.capacity = max(1, int(capacity))
        self.policy = policy
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._drops = DropStats()
        self._put_total = 0

    # --- producer side ------------------------------------------------
    def put(self, block) -> bool:
        """Enqueue a block under the policy. Returns False when the
        block (or an older one) was dropped to admit it."""
        with self._lock:
            self._put_total += 1
            if self.policy == "block":
                while len(self._q) >= self.capacity and not self._closed:
                    self._not_full.wait(0.1)
                if self._closed:
                    return False
                self._q.append(block)
                self._not_empty.notify()
                return True
            dropped = False
            while len(self._q) >= self.capacity:
                old = self._q.popleft()
                self._drops.blocks += 1
                self._drops.samples += int(old.nvalid)
                dropped = True
            self._q.append(block)
            self._not_empty.notify()
            return not dropped

    def close(self) -> None:
        """No more blocks will be put (source exhausted or reader
        died); wakes any waiting consumer."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    # --- consumer side ------------------------------------------------
    def get(self, timeout: float | None = None):
        """Dequeue the next block, or None when the queue is closed
        and drained (or ``timeout`` elapsed)."""
        with self._lock:
            if timeout is None:
                while not self._q and not self._closed:
                    self._not_empty.wait(0.1)
            elif not self._q and not self._closed:
                self._not_empty.wait(timeout)
            if not self._q:
                return None
            block = self._q.popleft()
            self._not_full.notify()
            return block

    # --- introspection ------------------------------------------------
    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def queued_samples(self) -> int:
        with self._lock:
            return sum(int(b.nvalid) for b in self._q)

    @property
    def drops(self) -> DropStats:
        with self._lock:
            return DropStats(self._drops.blocks, self._drops.samples)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed and not self._q
