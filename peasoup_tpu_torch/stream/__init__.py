"""The streaming real-time single-pulse search: bounded-latency chunked
ingest with backpressure, drop accounting and live triggers (the port's
copy of the JAX package's peasoup_tpu/stream).

:mod:`peasoup_tpu_torch.stream.driver` holds the service loop,
:mod:`peasoup_tpu_torch.io.stream_source` the block sources.
"""

from .driver import StreamConfig, StreamingSearch, StreamResult
from .queue import BoundedBlockQueue, DropStats
from .triggers import TRIGGER_SCHEMA, TriggerSink

__all__ = [
    "TRIGGER_SCHEMA",
    "BoundedBlockQueue",
    "DropStats",
    "StreamConfig",
    "StreamResult",
    "StreamingSearch",
    "TriggerSink",
]
