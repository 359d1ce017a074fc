"""The campaign's shape buckets (the JAX package's campaign/runner.py:177-223):
the key that observations of one geometry share, so that a CLI run with
``--tune`` and a later campaign worker read and write the same tuning-cache
entries (perf/tuning.py)."""

from __future__ import annotations

import struct


def bucket_nsamps(n: int, ladder: list[int] | None = None) -> int:
    """Pad target for ``n`` samples: the smallest rung >= n of the
    geometric ladder {2^k, 3*2^(k-1)}, two rungs an octave, so padding
    stays under 50% (and under 10% for observations just short of a
    power of two). An explicit campaign ladder overrides it; past the
    ladder's top the default rungs apply."""
    if ladder:
        above = [int(x) for x in ladder if int(x) >= n]
        if above:
            return min(above)
    p = 1 << max(0, (int(n) - 1).bit_length())
    if 3 * p // 4 >= n:
        return 3 * p // 4
    return p


def bucket_for_header(hdr, ladder: list[int] | None = None) -> tuple:
    """The shape-bucket key: (nchans, nbits, padded nsamps, tsamp, fch1,
    foff). The plan scalars enter because they set the DM trial count and
    with it every shape downstream."""
    return (
        int(hdr.nchans),
        int(hdr.nbits),
        bucket_nsamps(int(hdr.nsamples), ladder),
        round(float(hdr.tsamp), 12),
        round(float(hdr.fch1), 6),
        round(float(hdr.foff), 6),
    )


def bucket_for_input(path: str, ladder: list[int] | None = None) -> tuple | None:
    """The bucket key from the file's header alone (cheap at enqueue time);
    None when the header is unreadable or empty, as the JAX package
    returns it (the job then fails at run time, where the reader raises)."""
    from ..io.sigproc import read_sigproc_header

    try:
        with open(path, "rb") as f:
            hdr = read_sigproc_header(f)
    except (OSError, ValueError, struct.error):
        return None
    if hdr.nsamples <= 0 or hdr.nchans <= 0:
        return None
    return bucket_for_header(hdr, ladder)
