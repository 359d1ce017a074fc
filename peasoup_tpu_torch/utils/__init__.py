"""Search progress, phase timing and debug dumps: the port's copy of the
JAX package's ``utils/``. Its ``cache.py`` has no counterpart here: it
wires XLA's persistent compilation cache, and the port compiles nothing
per shape (each kernel library is built once per source hash, kernels.py).
"""

from .trace import Stopwatch, trace_count, trace_span
from .progress import ProgressBar
from .debug import dump_buffer
