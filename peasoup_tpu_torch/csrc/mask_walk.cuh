// The cluster walk over a crossing mask, for one (row, level) a warp: the
// second phase of harmpeaks.cu and of peaks.cu, which differ only in how a
// crossing's value is obtained (the Src policy below).
//
// The mask holds one bit a bin, 32 bins a u32 word (bit b of word w is bin
// 32 w + b), ldm words a (row, level), written by the kernel's first phase
// over every word that meets the level's window [lo, hi); bits outside the
// window are cleared here (harm::clip_word), so the first phase may leave
// them set. The warp reads the words over the window in 16-byte loads, a
// span of kSpan = 128 bins a lane and 4,096 bins a warp at a time, the next
// chunk's loads in flight while it walks this one, and skips the empty
// chunks. The crossings of a chunk are ranked by a warp scan and handed out
// 32 at a time through shared memory; each lane obtains one crossing's
// value from the Src, and the warp steps through the 32 in order
// (cluster_step.cuh's identify_unique_peaks step), every lane holding the
// same state, lane 0 storing the closed clusters.
//
// Src provides:
//   Span                 what a lane loads beside its span's mask words
//   Span load(q, in)     span q's payload (in: q lies in the window)
//   int publish(sp, cnt, vals)   puts the lane's payload in the warp's
//                        shared `vals` (32 kSpanSlots floats) and returns
//                        where its span's values start there, -1 if the
//                        crossing values are to come from value()
//   float value(idx, at, vals)   crossing idx's scaled value: vals[at] if
//                        at >= 0, else obtained by the Src itself

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_step.cuh"
#include "levels.cuh"

namespace mwalk {

using harm::kSpan;
using harm::kSpanSlots;

static_assert(kSpan == 128, "a lane reads a span's mask as one uint4");

// the lowest set bit of the four words (bins 0..127 of the span), cleared
__device__ __forceinline__ int pop_lowest(uint32_t& w0, uint32_t& w1, uint32_t& w2,
                                          uint32_t& w3) {
  int b;
  if (w0) {
    b = __ffs(w0) - 1;
    w0 &= w0 - 1;
  } else if (w1) {
    b = 32 + __ffs(w1) - 1;
    w1 &= w1 - 1;
  } else if (w2) {
    b = 64 + __ffs(w2) - 1;
    w2 &= w2 - 1;
  } else {
    b = 96 + __ffs(w3) - 1;
    w3 &= w3 - 1;
  }
  return b;
}

// Walks the crossings of one chunk of 4,096 bins in ascending order. This
// lane holds span q: its mask words 4q .. 4q+3 and its payload.
template <class Src>
__device__ __forceinline__ void walk_chunk(const Src& src, uint4 m4, const typename Src::Span& sp,
                                           int q, int lo, int hi, int* slot, int* vslot,
                                           float* vals, int min_gap, int mx, cluster::State& st,
                                           int32_t* oi, float* os) {
  const int lane = threadIdx.x & 31;
  uint32_t w0 = harm::clip_word(m4.x, 4 * q, lo, hi);
  uint32_t w1 = harm::clip_word(m4.y, 4 * q + 1, lo, hi);
  uint32_t w2 = harm::clip_word(m4.z, 4 * q + 2, lo, hi);
  uint32_t w3 = harm::clip_word(m4.w, 4 * q + 3, lo, hi);
  const int cnt = __popc(w0) + __popc(w1) + __popc(w2) + __popc(w3);
  if (!__any_sync(0xffffffffu, cnt)) return;
  const int vbase = src.publish(sp, cnt, vals);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int rank = incl - cnt;  // this lane's first crossing's rank in the chunk
  int own = 0;            // and the next one's among its span's
  for (int gb = 0; gb < total; gb += 32) {
    // the crossings ranked gb .. gb+31, in ascending bin order
    while (rank < incl && rank < gb + 32) {
      slot[rank - gb] = q * kSpan + pop_lowest(w0, w1, w2, w3);
      if (Src::kSlots) vslot[rank - gb] = vbase < 0 ? -1 : vbase + own;
      ++rank;
      ++own;
    }
    __syncwarp();
    const int n = min(32, total - gb);
    int idx = 0;
    float snr = 0.f;
    if (lane < n) {
      idx = slot[lane];
      snr = src.value(idx, Src::kSlots ? vslot[lane] : -1, vals);
    }
    __syncwarp();
    for (int e = 0; e < n; ++e) {
      const int ie = __shfl_sync(0xffffffffu, idx, e);
      const float se = __shfl_sync(0xffffffffu, snr, e);
      cluster::step(st, ie, se, min_gap, [&](int slot, int ci, float cs) {
        if (lane == 0 && slot < mx) {
          oi[slot] = ci;
          os[slot] = cs;
        }
      });
    }
  }
  __syncwarp();  // `vals` is the next chunk's after this
}

// The whole walk of one (row, level): its window [lo, hi) (lo >= 0, hi
// clamped to nbins), its ldm mask words m, its outputs oi, os (mx slots,
// padded with nbins and 0), count and ccount (the raw crossings and the
// clusters, dropped ones included). slot, vslot: 32 ints of the warp's
// shared memory each; vals: 32 kSpanSlots floats (unused where the Src has
// no slots).
template <class Src>
__device__ __forceinline__ void walk_level(const Src& src, const uint32_t* __restrict__ m,
                                           int lo, int hi, int nbins, int min_gap, int mx,
                                           int* slot, int* vslot, float* vals, int32_t* oi,
                                           float* os, int32_t* count, int32_t* ccount) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < mx; e += 32) {
    oi[e] = nbins;
    os[e] = 0.f;
  }
  __syncwarp();
  cluster::State st;
  if (lo < hi) {
    // a span a lane (4 mask words, one uint4, and its payload), 4,096 bins
    // a warp; the next chunk's loads go out before this one is walked
    const uint4* mq = reinterpret_cast<const uint4*>(m);
    const int q0 = lo / kSpan, q1 = (hi + kSpan - 1) / kSpan;
    const auto load = [&](int q, uint4& m4, typename Src::Span& sp) {
      const bool in = q < q1;
      m4 = in ? mq[q] : make_uint4(0u, 0u, 0u, 0u);
      sp = src.load(q, in);
    };
    uint4 m4;
    typename Src::Span sp;
    load(q0 + lane, m4, sp);
    for (int qb = q0; qb < q1; qb += 32) {
      const uint4 cm = m4;
      const typename Src::Span cs = sp;
      load(qb + 32 + lane, m4, sp);
      walk_chunk(src, cm, cs, qb + lane, lo, hi, slot, vslot, vals, min_gap, mx, st, oi, os);
    }
  }
  if (lane == 0) {
    if (cluster::last_fits(st, mx)) {
      oi[st.cursor] = st.cpeakidx;
      os[st.cursor] = st.cpeak;
    }
    *count = st.raw;
    *ccount = cluster::clusters(st);
  }
}

}  // namespace mwalk
