// Harmonic summing fused with the threshold + cluster walk, spread over the
// whole card.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/harmpeaks.py:find_harmonic_cluster_peaks (its
// plain twin is ops/harmonics.py:harmonic_sums(method="take") followed by
// ops/peaks.py:find_peaks_device + cluster_peaks_device).
//
// Per spectrum row and harmonic level h in 0..nharms, val_h is levels.cuh's
// level function (the reference's add order, bitwise the plain version's);
// v_h = val_h * scales[h] crosses where it lies inside level h's window
// [lo_h, hi_h) and above thr, and each level's crossings feed, in ascending
// bin order, cluster_step.cuh's identify_unique_peaks step. Outputs: cluster
// idxs padded with nbins, cluster snrs padded with 0 (both (rows, nlev,
// mx)), raw crossing counts and cluster counts (rows, nlev); clusters past
// mx are counted and dropped.
//
// What bounds it on the H100: the gathers. The row is read once from
// device memory (4 B a bin), but each bin gathers 2^nharms - 1 more bins,
// a warp's 32 neighbouring bins at one ratio r / 2^nharms touching one or
// two 128-byte lines: ~49 B a bin of L2 sectors at nharms 4 (a row's tiles
// run together, so they hit there). Staging the gathered segments in
// shared memory moves fewer sectors but costs more load/store wavefronts,
// and measured slower (PERF.md). Crossings are sparse.
//
// Design: two kernels behind the one C entry, so that neither the harmonic
// sums nor the walk is held back by the other.
//  A. Sums, mask and values. The grid is (tiles of kTile bins, rows), tiles
//     fastest, over the tiles between the lowest window start and the
//     highest window end; each warp takes a span of kSpan neighbouring bins,
//     32 to a mask word. A thread forms the levels of its kSpan / 32 bins
//     with every gather issued before the first add, and the warp ballots
//     each level's threshold test into one 32-bit word, clears the bits
//     outside the level's window where the word is not wholly inside every
//     window, and lane h stores level h's word to a (rows, nlev, ldm) u32
//     mask. The first kSpanSlots crossings of each level in the span hand
//     their scaled values, in bin order, to a (rows, nlev, spans,
//     kSpanSlots) f32 buffer. Windows and scales come by value. No barrier,
//     no shared memory, no serial work.
//  B. Walk. One warp per (row, level), the highest levels first, reads
//     that level's mask words and values over its window in 16-byte loads,
//     a span a lane and 4,096 bins a warp at a time, the next chunk's loads
//     in flight while it walks this one, and skips the empty chunks. The
//     crossings of a chunk are ranked by a warp scan and handed out 32 at a
//     time through shared memory; each lane takes one crossing's value from
//     its span's slots, or, where the span held more than kSpanSlots
//     crossings, recomputes it (the same level function, so bitwise what A
//     thresholded); the warp steps through the 32 in order
//     (cluster_step.cuh), each lane holding the same state, lane 0 storing
//     the closed clusters. Walking reads no spectrum but for those spans.
//     The walk is csrc/mask_walk.cuh's, which peaks.cu shares; only the
//     crossing values (SlotValues below) are harmpeaks' own.
// The mask holds only bits inside each level's window: B clears the bits
// of words it reads past the window's edges, which A may not have written.

#include <cstdint>
#include <cuda_runtime.h>

#include "levels.cuh"
#include "mask_walk.cuh"

namespace {

using harm::kSpan;
using harm::kSpanSlots;
using harm::kTile;

constexpr int kThreadsA = 32 * kTile / kSpan;  // a warp a span
constexpr int kBinsA = kSpan / 32;             // bins a thread of phase A, 32 apart
constexpr int kThreadsB = 256;
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kMaxRowsA = 65535;  // gridDim.y
constexpr int kMaxBins = 1 << 26; // keeps the level function's indices in int

static_assert(kSpan == 128 && kSpanSlots == 8,
              "B reads a span's mask as one uint4 and its slots as two float4");

// every level's window [lo, hi) (clamped to nbins) and scale, passed by
// value: no loads
struct Windows {
  int lo[harm::kMaxLevels], hi[harm::kMaxLevels];
  float sc[harm::kMaxLevels];
};

// a spectrum row read through the read-only path (bins are non-negative
// ints: unsigned offsets keep the address one multiply-add from the base)
struct Row {
  const float* p;
  __device__ __forceinline__ float operator()(int, int j) const {
    return __ldg(p + static_cast<unsigned>(j));
  }
};

// Block (tile, row); warp w takes the span from b0 = tile kTile + kSpan w,
// lane l its bins b0 + 32 u + l. The warp ballots each level's threshold
// test into the span's words, clears the bits outside the level's window
// (and past the last bin: every window ends by bin_hi), and lane h stores
// level h's words; then each crossing among the first kSpanSlots of its
// level in the span stores its value.
template <int NLEV>
__global__ void __launch_bounds__(kThreadsA)
harm_mask(const float* __restrict__ spec, int64_t npad, int row0, int tile0, int bin_hi,
          Windows w, float thr, uint32_t* __restrict__ mask, int64_t ldm,
          float* __restrict__ vals, int64_t ldv) {
  const int64_t row = row0 + static_cast<int64_t>(blockIdx.y);
  const Row s{spec + row * npad};
  const int lane = threadIdx.x & 31;
  const int span = (tile0 + static_cast<int>(blockIdx.x)) * (kTile / kSpan) +
                   static_cast<int>(threadIdx.x >> 5);
  const int b0 = span * kSpan;
  float val[kBinsA][NLEV];
#pragma unroll
  for (int u = 0; u < kBinsA; ++u) {
    const int i = b0 + 32 * u + lane;
    if (i < bin_hi) {
      harm::levels<NLEV>(s, i, val[u]);
    } else {
#pragma unroll
      for (int h = 0; h < NLEV; ++h) val[u][h] = 0.f;
    }
  }
  // the bins inside every level's window
  int in_lo = w.lo[0], in_hi = w.hi[0];
#pragma unroll
  for (int h = 1; h < NLEV; ++h) {
    in_lo = max(in_lo, w.lo[h]);
    in_hi = min(in_hi, w.hi[h]);
  }
  uint32_t words[NLEV][kBinsA];
  uint32_t* mrow = mask + row * NLEV * ldm;
#pragma unroll
  for (int u = 0; u < kBinsA; ++u) {
    const int first = b0 + 32 * u;  // the word's first bin
    const bool inside = first >= in_lo && first + 32 <= in_hi;
    uint32_t mine = 0;
#pragma unroll
    for (int h = 0; h < NLEV; ++h) {
      uint32_t word = __ballot_sync(0xffffffffu, val[u][h] * w.sc[h] > thr);
      if (!inside) word = harm::clip_word(word, first >> 5, w.lo[h], w.hi[h]);
      words[h][u] = word;
      if (lane == h) mine = word;
    }
    if (lane < NLEV && first < bin_hi) mrow[lane * ldm + (first >> 5)] = mine;
  }
  float* vrow = vals + row * NLEV * ldv + static_cast<int64_t>(span) * kSpanSlots;
#pragma unroll
  for (int h = 0; h < NLEV; ++h) {
#pragma unroll
    for (int u = 0; u < kBinsA; ++u) {
      if ((words[h][u] >> lane) & 1u) {
        const int rank = harm::span_rank(words[h], u, lane);
        if (rank < kSpanSlots) vrow[h * ldv + rank] = val[u][h] * w.sc[h];
      }
    }
  }
}

// Phase B's crossing values: from the span's kSpanSlots slots, which each
// lane loads beside its mask words, or, where the span held more crossings,
// recomputed (the same level function, so bitwise what A thresholded).
template <int NLEV>
struct SlotValues {
  static constexpr bool kSlots = true;
  struct Span {
    float4 va, vb;
  };
  const float4* vq;  // the task's value slots, two float4 a span
  Row s;
  int h;
  float sc;
  __device__ __forceinline__ Span load(int q, bool in) const {
    return in ? Span{vq[2 * q], vq[2 * q + 1]}
              : Span{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  __device__ __forceinline__ int publish(const Span& sp, int cnt, float* vals) const {
    const int lane = threadIdx.x & 31;
    reinterpret_cast<float4*>(vals)[2 * lane] = sp.va;
    reinterpret_cast<float4*>(vals)[2 * lane + 1] = sp.vb;
    return cnt <= kSpanSlots ? lane * kSpanSlots : -1;
  }
  __device__ __forceinline__ float value(int idx, int at, const float* vals) const {
    if (at >= 0) return vals[at];
    float val[NLEV];
    harm::levels<NLEV>(s, idx, val, h);  // the gathers of levels 0..h only
    float x = val[0];
#pragma unroll
    for (int l = 1; l < NLEV; ++l) x = l == h ? val[l] : x;
    return x * sc;
  }
};

template <int NLEV>
__global__ void __launch_bounds__(kThreadsB)
harm_walk(const float* __restrict__ spec, int64_t npad, int64_t rows, int nbins,
          Windows w, int min_gap, int mx, const uint32_t* __restrict__ mask, int64_t ldm,
          const float* __restrict__ vals, int64_t ldv, int32_t* __restrict__ idxs,
          float* __restrict__ snrs, int32_t* __restrict__ counts,
          int32_t* __restrict__ ccounts) {
  __shared__ int ranked[kWarpsB][32];
  __shared__ int vslots[kWarpsB][32];
  __shared__ float4 chunk_vals[kWarpsB][32 * kSpanSlots / 4];
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarpsB + warp;
  if (t >= rows * NLEV) return;  // the whole warp
  // level by level, the highest (most crossings, so the longest walks)
  // first, so that a block's warps finish together; the last rows first:
  // phase A swept them last, so their mask and values are still in L2
  const int h = NLEV - 1 - static_cast<int>(t / rows);
  const int64_t row = rows - 1 - t % rows;
  const int64_t task = row * NLEV + h;
  int lo = 0, hi = 0;
  float sc = 0.f;
#pragma unroll
  for (int l = 0; l < NLEV; ++l) {  // w's arrays indexed by constants only
    if (l == h) {
      lo = max(w.lo[l], 0);
      hi = w.hi[l];
      sc = w.sc[l];
    }
  }
  const SlotValues<NLEV> src{reinterpret_cast<const float4*>(vals + task * ldv),
                             Row{spec + row * npad}, h, sc};
  mwalk::walk_level(src, mask + task * ldm, lo, hi, nbins, min_gap, mx, ranked[warp],
                    vslots[warp], reinterpret_cast<float*>(chunk_vals[warp]), idxs + task * mx,
                    snrs + task * mx, counts + task, ccounts + task);
}

template <int NLEV>
int launch(const float* spec, int64_t rows, int64_t npad, int nbins, const Windows& w,
           float thr, int min_gap, int mx, uint32_t* mask, int64_t ldm, float* vals,
           int64_t ldv, int32_t* idxs, float* snrs, int32_t* counts, int32_t* ccounts,
           cudaStream_t s) {
  int bin_lo = w.lo[0], bin_hi = w.hi[0];
  for (int h = 1; h < NLEV; ++h) {
    bin_lo = min(bin_lo, w.lo[h]);
    bin_hi = max(bin_hi, w.hi[h]);
  }
  const int tile0 = max(bin_lo, 0) / kTile;
  if (bin_hi > tile0 * kTile) {
    const unsigned tiles = static_cast<unsigned>((bin_hi - 1) / kTile - tile0 + 1);
    for (int64_t r0 = 0; r0 < rows; r0 += kMaxRowsA) {
      const unsigned nr = static_cast<unsigned>(rows - r0 < kMaxRowsA ? rows - r0 : kMaxRowsA);
      harm_mask<NLEV><<<dim3(tiles, nr), kThreadsA, 0, s>>>(
          spec, npad, static_cast<int>(r0), tile0, bin_hi, w, thr, mask, ldm, vals, ldv);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int64_t warps = rows * NLEV;
  harm_walk<NLEV><<<static_cast<unsigned>((warps + kWarpsB - 1) / kWarpsB), kThreadsB,
                    0, s>>>(spec, npad, rows, nbins, w, min_gap, mx, mask, ldm, vals, ldv,
                            idxs, snrs, counts, ccounts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// spec (rows, npad) f32 on the card; windows (nlev, 2) i32, clamped to
// nbins, and scales (nlev,) f32 in host memory; mask (rows, nlev, ldm) u32
// and vals (rows, nlev, 2 ldm) f32 scratch, 16-byte aligned, ldm = 32 x
// the tiles of 1,024 bins that cover npad (a mask word and two value slots
// a 32 bins); idxs, snrs (rows, nlev, mx); counts, ccounts (rows, nlev).
// Two launches on `stream`.
extern "C" int harmpeaks(const void* spec, long long rows, long long npad,
                         int nbins, int nharms, const void* windows,
                         const void* scales, float thr, int min_gap, int mx,
                         void* mask, void* vals, long long ldm, void* idxs, void* snrs,
                         void* counts, void* ccounts, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const int nlev = nharms + 1;
  if (nharms < 0 || nlev > harm::kMaxLevels || nbins <= 0 || nbins > npad ||
      npad >= kMaxBins || ldm != (npad + kTile - 1) / kTile * (kTile / 32) ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0 || reinterpret_cast<uintptr_t>(vals) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Windows w = {};
  for (int h = 0; h < nlev; ++h) {
    w.lo[h] = static_cast<const int32_t*>(windows)[2 * h];
    w.hi[h] = static_cast<const int32_t*>(windows)[2 * h + 1];
    w.sc[h] = static_cast<const float*>(scales)[h];
    if (w.hi[h] > nbins) return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* sp = static_cast<const float*>(spec);
  auto* mk = static_cast<uint32_t*>(mask);
  auto* vs = static_cast<float*>(vals);
  // kSpanSlots values a span of 4 mask words
  const int64_t ldv = ldm / (kSpan / 32) * kSpanSlots;
  auto* oi = static_cast<int32_t*>(idxs);
  auto* os = static_cast<float*>(snrs);
  auto* cn = static_cast<int32_t*>(counts);
  auto* cc = static_cast<int32_t*>(ccounts);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (nlev) {
    case 1: return launch<1>(sp, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, vs, ldv, oi, os, cn, cc, s);
    case 2: return launch<2>(sp, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, vs, ldv, oi, os, cn, cc, s);
    case 3: return launch<3>(sp, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, vs, ldv, oi, os, cn, cc, s);
    case 4: return launch<4>(sp, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, vs, ldv, oi, os, cn, cc, s);
    case 5: return launch<5>(sp, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, vs, ldv, oi, os, cn, cc, s);
    default: return launch<6>(sp, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, vs, ldv, oi, os, cn, cc, s);
  }
}
