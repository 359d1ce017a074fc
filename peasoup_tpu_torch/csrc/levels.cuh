// The harmonic level values of one spectrum bin, the slots of a span's
// crossings, and the window of a level's threshold mask: harmpeaks.cu's
// two phases, and the CPU tests' host build
// (tests/test_torch_kernel_host.py), compile this one copy.
//
// Level h of bin i (h = 0 the spectrum itself):
//   val_0 = s[i];  val_h = val_{h-1} + sum_{k odd < 2^h} s[(i*k + 2^(h-1)) >> h]
// added one `+` at a time in the reference order (levels ascending, odd k
// ascending), so that with FMA contraction off (-fmad=false for nvcc,
// -ffp-contract=off for g++) every value is bitwise the plain version's
// (ops/harmonics.py:harmonic_sums(scaled=False)). Indices stay in int:
// callers keep bins below 2^26, so i*k + 2^(h-1) < 2^31.

#pragma once

#include <cstdint>

#include "hd.cuh"

namespace harm {

constexpr int kMaxLevels = 6;  // nharms <= 5

// The bin that bin i's gather for odd k at level h reads.
PEASOUP_HD int gather_bin(int i, int h, int k) { return (i * k + (1 << (h - 1))) >> h; }

// The number of gathers of levels 1..NLEV-1 (the odd k of each level).
template <int NLEV>
constexpr int kGathers = (1 << (NLEV - 1)) - 1;

// Gather n's level h and odd k: level h holds gathers 2^(h-1) - 1 ..
// 2^h - 2, k ascending. Both fold to constants in an unrolled loop.
PEASOUP_HD int gather_level(int n) {
  int h = 1;
  while ((1 << h) - 1 <= n) ++h;
  return h;
}
PEASOUP_HD int gather_k(int n) { return 2 * (n + 1 - (1 << (gather_level(n) - 1))) + 1; }

// A row read where each gather names: row(n, j) is bin j, read for gather
// n (n = -1: level 0's own bin).
struct RowPtr {
  const float* p;
  PEASOUP_HD float operator()(int, int j) const { return p[j]; }
};

// val[h] for h <= upto (< NLEV); the levels above upto are left unread.
// Every gather is issued before the first add, so a card keeps all of them
// (up to kGathers<NLEV>, plus bin i) in flight together; the loops run over
// constant counts, so they unroll and g stays in registers. `row` is a
// RowPtr, or on the card a loader of its own.
template <int NLEV, class Row>
PEASOUP_HD void levels(const Row& row, int i, float (&val)[NLEV], int upto = NLEV - 1) {
  float g[kGathers<NLEV> > 0 ? kGathers<NLEV> : 1];
  PEASOUP_UNROLL
  for (int n = 0; n < kGathers<NLEV>; ++n) {
    const int h = gather_level(n);
    g[n] = h <= upto ? row(n, gather_bin(i, h, gather_k(n))) : 0.f;
  }
  float v = row(-1, i);
  val[0] = v;
  PEASOUP_UNROLL
  for (int n = 0; n < kGathers<NLEV>; ++n) {
    v = v + g[n];
    if (((n + 2) & (n + 1)) == 0) val[gather_level(n)] = v;  // level's last
  }
}

// Phase A of harmpeaks.cu takes a tile of kTile bins a block and a span of
// kSpan consecutive bins (kSpan / 32 mask words a level) a warp, and hands
// phase B the scaled values of the first kSpanSlots crossings of each
// level in each span, in bin order, at the span's slots.
constexpr int kTile = 1024;
constexpr int kSpan = 128;
constexpr int kSpanSlots = 8;

// The rank of bit b of word u among the set bits of a span's words
// (u < kSpan / 32), counted in bin order.
PEASOUP_HD int span_rank(const uint32_t* words, int u, int b) {
  int rank = 0;
  for (int v = 0; v < u; ++v) rank += popcount32(words[v]);
  return rank + popcount32(words[u] & ((1u << b) - 1u));
}

// Mask word w (bit b is bin 32 w + b) with the bits outside [lo, hi)
// cleared: a word wholly outside the window, never written, reads as 0.
PEASOUP_HD uint32_t clip_word(uint32_t bits, int w, int lo, int hi) {
  const int b0 = w * 32;
  if (b0 + 32 <= lo || b0 >= hi) return 0u;
  if (lo > b0) bits &= ~0u << (lo - b0);
  if (hi < b0 + 32) bits &= ~0u >> (b0 + 32 - hi);
  return bits;
}

}  // namespace harm
