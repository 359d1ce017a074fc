// One step of the cluster walk: PeakFinder::identify_unique_peaks
// (include/transforms/peakfinder.hpp:27-56) fed one threshold crossing at
// a time, in ascending bin order, with its quirk that lastidx advances only
// on a new maximum. mask_walk.cuh (the walk of peaks.cu and harmpeaks.cu)
// and the CPU tests' host build (tests/test_torch_kernel_host.py) compile
// this one copy.

#pragma once

#include "hd.cuh"

namespace cluster {

struct State {
  int cursor = 0;    // clusters closed so far
  int raw = 0;       // crossings seen
  int open = 0;      // a cluster is open
  int cpeakidx = 0;  // the open cluster's peak bin
  int lastidx = 0;   // the bin min_gap is measured from
  float cpeak = 0.f; // the open cluster's peak value
};

// Feeds crossing (idx, snr). Where it closes the open cluster, it first
// hands that cluster to emit(slot, peak idx, peak snr), slot being the
// cluster's rank (the caller stores it where slot < its slot count).
template <class Emit>
PEASOUP_HD void step(State& st, int idx, float snr, int min_gap, const Emit& emit) {
  ++st.raw;
  const bool close = st.open && (idx - st.lastidx >= min_gap);
  if (close) {
    emit(st.cursor, st.cpeakidx, st.cpeak);
    ++st.cursor;
  }
  if (!st.open || close || snr > st.cpeak) {
    st.cpeak = snr;
    st.cpeakidx = idx;
    st.lastidx = idx;
  }
  st.open = 1;
}

// After the last crossing: whether the open cluster takes slot st.cursor
// (below mx), and the count of clusters, the dropped ones included.
PEASOUP_HD bool last_fits(const State& st, int mx) { return st.open && st.cursor < mx; }
PEASOUP_HD int clusters(const State& st) { return st.cursor + st.open; }

}  // namespace cluster
