// Threshold + cluster walk of every level of one spectrum row, the level
// rows given: the body of peaks.cu. (harmpeaks.cu, which forms the levels
// itself, spreads its rows over the whole card in two phases instead.)
//
// Per row and level h < nlev: v_h = val_h[i] * scales[h], a crossing is
// lo_h <= i < hi_h with v_h > thr, and the crossings of each level feed, in
// ascending bin order, the identify_unique_peaks state machine
// (cluster_step.cuh: min_gap, the lastidx quirk). Outputs: cluster idxs
// padded with nbins, cluster snrs padded with 0 (both (nlev, mx) for the
// row), raw crossing counts and cluster counts (nlev); clusters past mx are
// counted and dropped.
//
// Design: one block per row. The TPU kernels walk row stripes in 4096-bin
// blocks with the machine state in VMEM scratch; here the block walks its
// row left to right in tiles of kTile bins (kPerThread bins a thread,
// coalesced). For each bin the thread forms the nlev level values in
// ascending level order, and each warp publishes a ballot of its crossings
// per level, with the scaled values, to shared memory. After a barrier,
// lane 0 of warp h walks level h's crossings of the tile in ascending order
// (ffs over the ballot words) through that level's state machine, which
// lives in its registers across tiles. Only the bins between the lowest
// window start and the highest window end are visited; bins past nbins
// (garbage padding) never cross because the caller clamps every window to
// nbins.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_step.cuh"

namespace walk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWords = kTile / 32;
constexpr int kMaxLevels = 6;  // nharms <= 5

// Walks this block's row. level(h, i, prev) is bin i's unscaled value at
// level h, given prev, the value it gave at level h - 1 (0 for h = 0); it
// is called for h ascending and only for bins below the highest window end.
// oi, os: the row's (nlev, mx) outputs; count, ccount: its (nlev) counts.
template <class Level>
__device__ __forceinline__ void cluster_walk(
    const Level& level, int nlev, int nbins, const int32_t* __restrict__ windows,
    const float* __restrict__ scales, float thr, int min_gap, int mx,
    int32_t* __restrict__ oi, float* __restrict__ os, int32_t* __restrict__ count,
    int32_t* __restrict__ ccount) {
  __shared__ unsigned masks[kMaxLevels][kWords];
  __shared__ float vals[kMaxLevels][kTile];
  __shared__ int lo_s[kMaxLevels], hi_s[kMaxLevels];
  __shared__ float sc_s[kMaxLevels];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < nlev * mx; i += kThreads) {
    oi[i] = nbins;
    os[i] = 0.f;
  }
  if (threadIdx.x < nlev) {
    lo_s[threadIdx.x] = windows[2 * threadIdx.x];
    hi_s[threadIdx.x] = windows[2 * threadIdx.x + 1];
    sc_s[threadIdx.x] = scales[threadIdx.x];
  }
  __syncthreads();
  int bin_lo = lo_s[0], bin_hi = hi_s[0];
  for (int h = 1; h < nlev; ++h) {
    bin_lo = min(bin_lo, lo_s[h]);
    bin_hi = max(bin_hi, hi_s[h]);
  }
  bin_lo = max(bin_lo, 0);

  // level (warp)'s identify_unique_peaks state, held by lane 0 of that warp
  const bool walker = lane == 0 && warp < nlev;
  cluster::State st;

  for (int64_t base = static_cast<int64_t>(bin_lo / kTile) * kTile;
       base < bin_hi; base += kTile) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int pos = j * kThreads + threadIdx.x;
      const int64_t i = base + pos;
      const bool in = i < bin_hi;
      float val = 0.f;
      for (int h = 0; h < nlev; ++h) {
        if (in) val = level(h, i, val);
        const float v = val * sc_s[h];
        const bool cross = in && i >= lo_s[h] && i < hi_s[h] && v > thr;
        const unsigned ballot = __ballot_sync(0xffffffffu, cross);
        if (lane == 0) masks[h][j * kWarps + warp] = ballot;
        vals[h][pos] = v;
      }
    }
    __syncthreads();
    if (walker) {
      const int h = warp;
      for (int w = 0; w < kWords; ++w) {
        unsigned bits = masks[h][w];
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int p = w * 32 + b;
          const int idx = static_cast<int>(base + p);
          const float snr = vals[h][p];
          cluster::step(st, idx, snr, min_gap, [&](int slot, int ci, float cs) {
            if (slot < mx) {
              oi[h * mx + slot] = ci;
              os[h * mx + slot] = cs;
            }
          });
        }
      }
    }
    __syncthreads();
  }
  if (walker) {
    const int h = warp;
    if (cluster::last_fits(st, mx)) {
      oi[h * mx + st.cursor] = st.cpeakidx;
      os[h * mx + st.cursor] = st.cpeak;
    }
    count[h] = st.raw;
    ccount[h] = cluster::clusters(st);
  }
}

}  // namespace walk
