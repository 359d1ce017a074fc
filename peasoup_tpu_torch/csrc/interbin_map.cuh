// Who writes which bin in interbin.cu's kernel (interbin.cuh). interbin.cuh
// and the CPU tests' host build (tests/test_torch_kernel_host.py, which
// checks that every bin 0..npad-1 of a row has exactly one writer) compile
// this one copy.
//
// A row of the spectrum has the m + 1 true bins 0..m and zero pads past m.
// The blocks of a row split in two kinds, so each warp takes one branch:
//  - pair threads, j in [0, m/4): thread j owns the low bins k = 2j and
//    k + 1 and their mirrors m - k and m - k - 1, whose untwists read the
//    same two Z values swapped; the last pair thread also owns the middle
//    bin m/2, its own mirror. k runs over 0, 2, .., m/2 - 2, so the low bins
//    cover 0..m/2-1, the high bins m/2+1..m, and bin 0's mirror is the
//    Nyquist bin m;
//  - pad threads, p in [0, ceil((npad - m - 1) / 4)): thread p zeroes the
//    pads m + 1 + 4p .. m + 4p + 4 below npad.
// m is a multiple of 4 (the port's m is a power of two), so the low pair's
// two Z values are one aligned 16-byte load.

#pragma once

#include <cstdint>

#include "hd.cuh"

namespace ibmap {

constexpr int kThreads = 256;

PEASOUP_HD int pair_threads(int m) { return m / 4; }

PEASOUP_HD int pad_threads(int m, int npad) { return (npad - m - 1 + 3) / 4; }

PEASOUP_HD int pair_blocks(int m) { return (pair_threads(m) + kThreads - 1) / kThreads; }

PEASOUP_HD int pad_blocks(int m, int npad) {
  return (pad_threads(m, npad) + kThreads - 1) / kThreads;
}

// The bins pair thread j writes: bins[0..1] the low pair k, k + 1; bins[2..3]
// their mirrors m - k, m - k - 1; bins[4] the middle bin m/2 for the last
// pair thread, else -1.
PEASOUP_HD void pair_bins(int m, int j, int bins[5]) {
  const int k = 2 * j;
  bins[0] = k;
  bins[1] = k + 1;
  bins[2] = m - k;
  bins[3] = m - k - 1;
  bins[4] = j == pair_threads(m) - 1 ? m / 2 : -1;
}

// The first pad pad thread p zeroes; it zeroes [first, min(first + 4, npad)).
PEASOUP_HD int pad_first(int m, int p) { return m + 1 + 4 * p; }

// The Z values the untwist of bin k reads: Z[k] (Z[0] for the Nyquist bin
// m) and its mirror Z[m - k] (Z[0] for bin 0).
PEASOUP_HD void untwist_sources(int m, int k, int& zk, int& zm) {
  zk = k == m ? 0 : k;
  zm = k == 0 ? 0 : m - k;
}

}  // namespace ibmap
