"""The port's tuning and measurement layer (the JAX package's perf/):

- :mod:`.measure`, the measurement primitives (host clock with a
  synchronise, CUDA events, torch.profiler device time);
- :mod:`.tuning`, the per-device tuner of the dedispersion and search
  knobs and its tuning cache (``--tune`` on ``peasoup`` and ``spsearch``);
- :mod:`.roofline`, the stage taxonomy and the card's peaks;
- :mod:`.warmup`, every kernel built and every registered program run
  once (ops/registry.py), and a campaign bucket's dry run;
- :mod:`.microbench`, the registry's programs timed into ``perf.json``;
- :mod:`.ratchet`, ``perf.json`` against ``perf_baseline.json``.

CLI: ``python -m peasoup_tpu_torch.tools.perf warmup|bench|check|tune``.
"""

import json
import os
import tempfile


def write_json_atomic(path: str, doc: dict, *, sort_keys: bool = False) -> None:
    """Write ``doc`` as JSON through a temporary file beside ``path`` and
    an atomic replace: a reader never sees half a file, and concurrent
    writers leave the last one's whole."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=sort_keys)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
