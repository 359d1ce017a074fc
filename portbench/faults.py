"""Faults planted under the timed path, for the checks that the comparison
fails them (tests/test_portbench_faults.py on the CPU, ``control.py
--fault`` on the card at a cell's own size). Each takes the peaks of
every row batch as the search chain returns them (ops:
``AccelSearchPeaks`` on the device) and breaks them in place:

- ``half_batch``: the rows past the middle of each batch find nothing,
  as if never searched: their crossing and cluster counts read 0 and
  their peaks' S/N 0;
- ``stronger``: the strongest peak of each batch comes back 1% stronger,
  an answer altered where it is produced.

The benchmark's own runs never plant one.
"""

from __future__ import annotations

import contextlib


def half_batch(p) -> None:
    h = p.ccounts.shape[0] // 2
    p.ccounts[h:] = 0
    p.counts[h:] = 0
    p.snrs[h:] = 0


def stronger(p) -> None:
    import torch

    flat = p.snrs.view(-1)
    flat[int(torch.argmax(flat))] *= 1.01


FAULTS = {"half_batch": half_batch, "stronger": stronger}


@contextlib.contextmanager
def planted(name: str):
    """Within the block, every search the port makes has fault ``name``."""
    import peasoup_tpu_torch.parallel.sharded_search as ss

    fault = FAULTS[name]
    real = ss.make_sharded_search_fn

    def broken(*args, **kwargs):
        fn = real(*args, **kwargs)

        def search(jobs, *a, **k):
            out = fn(jobs, *a, **k)
            for p in out:
                if p is not None:
                    fault(p)
            return out

        return search

    ss.make_sharded_search_fn = broken
    try:
        yield
    finally:
        ss.make_sharded_search_fn = real
