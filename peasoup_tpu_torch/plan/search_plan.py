"""The search plan: every array the search derives from the header and
the configuration before it touches the data.

The search has no weights; what it carries from one run (or one
package) to another is this plan. :func:`from_arrays` builds it from
plain arrays, for example the JAX package's own, so that both packages
can be run on one plan.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class SearchPlan:
    dm_list: np.ndarray  # (D,) f32 DM trials
    delays: np.ndarray  # (D, C) int32 delay of each channel, in samples
    killmask: np.ndarray  # (C,) int32, 1 = keep the channel
    out_nsamps: int  # samples per dedispersed trial
    size: int  # FFT length of the search
    accel_lists: tuple  # per DM trial, (A_d,) f32 accelerations (m/s^2)
    zapmask: np.ndarray  # (size//2 + 1,) bool birdie mask
    windows: np.ndarray  # (nharms+1, 2) int32 [start, limit) per level
    factors: np.ndarray  # (nharms+1,) f32 bin index -> frequency per level

    @property
    def ndm(self) -> int:
        return len(self.dm_list)

    @property
    def nharms(self) -> int:
        return len(self.windows) - 1

    def subset(self, lo: int, hi: int) -> "SearchPlan":
        """The DM trials [lo, hi) of this plan; every other field is the
        whole plan's (out_nsamps among them, so every slice's trials have
        one length, as DMPlan.subset keeps it)."""
        return replace(
            self, dm_list=self.dm_list[lo:hi], delays=self.delays[lo:hi],
            accel_lists=self.accel_lists[lo:hi],
        )


def from_arrays(
    *,
    dm_list,
    delays,
    killmask,
    out_nsamps: int,
    size: int,
    accel_lists,
    zapmask,
    windows,
    factors,
) -> SearchPlan:
    """A SearchPlan from plain (numpy-convertible) arrays, checked for
    shape and converted to the dtypes the search uses."""
    dm_list = np.asarray(dm_list, dtype=np.float32)
    delays = np.asarray(delays, dtype=np.int32)
    killmask = np.asarray(killmask, dtype=np.int32)
    accel_lists = tuple(np.asarray(a, dtype=np.float32) for a in accel_lists)
    zapmask = np.asarray(zapmask, dtype=bool)
    windows = np.asarray(windows, dtype=np.int32)
    factors = np.asarray(factors, dtype=np.float32)
    ndm = len(dm_list)
    if delays.shape != (ndm, len(killmask)):
        raise ValueError(f"delays {delays.shape} != (ndm, nchans)")
    if len(accel_lists) != ndm:
        raise ValueError("one acceleration list per DM trial")
    if zapmask.shape != (size // 2 + 1,):
        raise ValueError(f"zapmask {zapmask.shape} != (size//2 + 1,)")
    if windows.ndim != 2 or windows.shape[1] != 2 or factors.shape != windows.shape[:1]:
        raise ValueError("windows (nlev, 2) and factors (nlev,) must agree")
    return SearchPlan(
        dm_list=dm_list, delays=delays, killmask=killmask,
        out_nsamps=int(out_nsamps), size=int(size), accel_lists=accel_lists,
        zapmask=zapmask, windows=windows, factors=factors,
    )
