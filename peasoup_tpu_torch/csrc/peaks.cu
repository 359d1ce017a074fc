// Threshold + cluster walk of every harmonic level, the levels given,
// spread over the whole card in two phases.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/peaks.py:find_cluster_peaks_multi (its plain twin
// is ops/peaks.py:find_peaks_device + cluster_peaks_device per scaled
// level). The search takes it when the harmonic sums are formed apart
// (PEASOUP_MEGA_HARM=0).
//
// Per spectrum row and level h < nlev: v_h = level_h[i] * scales[h] crosses
// where lo_h <= i < hi_h and v_h > thr, and each level's crossings feed, in
// ascending bin order, cluster_step.cuh's identify_unique_peaks step.
// Outputs: cluster idxs padded with nbins, cluster snrs padded with 0 (both
// (rows, nlev, mx)), raw crossing counts and cluster counts (rows, nlev);
// clusters past mx are counted and dropped. Bitwise the plain version's.
//
// What bounds it on the H100: bytes. Each level's row is read once inside
// its window, 4 B a bin; the outputs are tiny, and the crossing mask the
// two phases share is 1/32 of the levels' bytes. Crossings are sparse.
//
// Design: harmpeaks.cu's shape, with the levels read instead of formed.
//  A. Mask. The grid is (tiles of 1,024 bins, rows), tiles fastest, over
//     the tiles between the lowest window start and the highest window
//     end; a warp takes a span of 128 bins, a lane 4 of them, and reads
//     each level whose window the lane's bins meet as one 16-byte load,
//     all levels' loads in flight together. A lane's four threshold tests
//     make a nibble, eight lanes' nibbles one 32-bit word (three xor
//     shuffles), and the word's first lane stores it, its bits outside the
//     level's window cleared, to a (rows, nlev, ldm) u32 mask: every word
//     that meets the window, no other (peaks_map.cuh). No barrier, no
//     shared memory, no serial work, no values stored.
//  B. Walk: csrc/mask_walk.cuh's, a warp per (row, level), the highest
//     levels and the last rows first (their mask words are the freshest in
//     L2); a crossing's value is one load of level_h[i] * scales[h].

#include <cstdint>
#include <cuda_runtime.h>

#include "mask_walk.cuh"
#include "peaks_map.cuh"

namespace {

using harm::kSpan;
using harm::kTile;

constexpr int kMaxLevels = harm::kMaxLevels;
constexpr int kThreadsA = 32 * kTile / kSpan;  // a warp a span
constexpr int kThreadsB = 256;
constexpr int kWarpsB = kThreadsB / 32;
constexpr int kMaxRowsA = 65535;  // gridDim.y
constexpr int64_t kMaxBins = int64_t{1} << 30;

// the level rows, and every level's window [lo, hi) (lo >= 0, hi clamped
// to nbins) and scale, passed by value
struct Levels {
  const float* p[kMaxLevels];
};
struct Windows {
  int lo[kMaxLevels], hi[kMaxLevels];
  float sc[kMaxLevels];
};

// Block (tile, row); warp w takes span q = tile (kTile / kSpan) + w.
template <int NLEV>
__global__ void __launch_bounds__(kThreadsA)
peaks_mask(Levels lv, int64_t npad, int row0, int tile0, Windows w, float thr,
           uint32_t* __restrict__ mask, int64_t ldm) {
  const int64_t row = row0 + static_cast<int64_t>(blockIdx.y);
  const int lane = threadIdx.x & 31;
  const int q = (tile0 + static_cast<int>(blockIdx.x)) * (kTile / kSpan) +
                static_cast<int>(threadIdx.x >> 5);
  const int b = pkmap::lane_bin(q, lane);
  float4 x[NLEV];
#pragma unroll
  for (int h = 0; h < NLEV; ++h) {
    x[h] = pkmap::lane_reads(b, w.lo[h], w.hi[h])
               ? __ldg(reinterpret_cast<const float4*>(lv.p[h] + row * npad + b))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  uint32_t* mrow = mask + row * NLEV * ldm;
  const int wi = pkmap::lane_word(q, lane);
#pragma unroll
  for (int h = 0; h < NLEV; ++h) {
    const uint32_t nib = pkmap::lane_reads(b, w.lo[h], w.hi[h])
                             ? pkmap::nibble(x[h].x, x[h].y, x[h].z, x[h].w, w.sc[h], thr)
                             : 0u;
    uint32_t word = pkmap::word_bits(nib, lane);
    word |= __shfl_xor_sync(0xffffffffu, word, 1);
    word |= __shfl_xor_sync(0xffffffffu, word, 2);
    word |= __shfl_xor_sync(0xffffffffu, word, 4);
    if ((lane & 7) == 0 && pkmap::word_meets(wi, w.lo[h], w.hi[h]))
      mrow[h * ldm + wi] = harm::clip_word(word, wi, w.lo[h], w.hi[h]);
  }
}

// Phase B's crossing values: one load of the level's row, scaled.
struct LoadValues {
  static constexpr bool kSlots = false;
  struct Span {};
  const float* p;
  float sc;
  __device__ __forceinline__ Span load(int, bool) const { return {}; }
  __device__ __forceinline__ int publish(const Span&, int, float*) const { return -1; }
  __device__ __forceinline__ float value(int idx, int, const float*) const {
    return __ldg(p + idx) * sc;
  }
};

template <int NLEV>
__global__ void __launch_bounds__(kThreadsB)
peaks_walk(Levels lv, int64_t npad, int64_t rows, int nbins, Windows w, int min_gap, int mx,
           const uint32_t* __restrict__ mask, int64_t ldm, int32_t* __restrict__ idxs,
           float* __restrict__ snrs, int32_t* __restrict__ counts,
           int32_t* __restrict__ ccounts) {
  __shared__ int ranked[kWarpsB][32];
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarpsB + warp;
  if (t >= rows * NLEV) return;  // the whole warp
  const int h = NLEV - 1 - static_cast<int>(t / rows);
  const int64_t row = rows - 1 - t % rows;
  const int64_t task = row * NLEV + h;
  int lo = 0, hi = 0;
  float sc = 0.f;
  const float* p = nullptr;
#pragma unroll
  for (int l = 0; l < NLEV; ++l) {  // w's and lv's arrays indexed by constants only
    if (l == h) {
      lo = w.lo[l];
      hi = w.hi[l];
      sc = w.sc[l];
      p = lv.p[l];
    }
  }
  const LoadValues src{p + row * npad, sc};
  mwalk::walk_level(src, mask + task * ldm, lo, hi, nbins, min_gap, mx, ranked[warp], nullptr,
                    nullptr, idxs + task * mx, snrs + task * mx, counts + task,
                    ccounts + task);
}

template <int NLEV>
int launch(const Levels& lv, int64_t rows, int64_t npad, int nbins, const Windows& w,
           float thr, int min_gap, int mx, uint32_t* mask, int64_t ldm, int32_t* idxs,
           float* snrs, int32_t* counts, int32_t* ccounts, cudaStream_t s) {
  int bin_lo = w.lo[0], bin_hi = w.hi[0];
  for (int h = 1; h < NLEV; ++h) {
    bin_lo = min(bin_lo, w.lo[h]);
    bin_hi = max(bin_hi, w.hi[h]);
  }
  const int tile0 = bin_lo / kTile;
  if (bin_hi > tile0 * kTile) {
    const unsigned tiles = static_cast<unsigned>((bin_hi - 1) / kTile - tile0 + 1);
    for (int64_t r0 = 0; r0 < rows; r0 += kMaxRowsA) {
      const unsigned nr = static_cast<unsigned>(rows - r0 < kMaxRowsA ? rows - r0 : kMaxRowsA);
      peaks_mask<NLEV><<<dim3(tiles, nr), kThreadsA, 0, s>>>(
          lv, npad, static_cast<int>(r0), tile0, w, thr, mask, ldm);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  const int64_t warps = rows * NLEV;
  peaks_walk<NLEV><<<static_cast<unsigned>((warps + kWarpsB - 1) / kWarpsB), kThreadsB, 0, s>>>(
      lv, npad, rows, nbins, w, min_gap, mx, mask, ldm, idxs, snrs, counts, ccounts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// l0..l5: the (rows, npad) f32 level rows on the card, the first nlev of
// them used, each 16-byte aligned, npad a multiple of 4; windows (nlev, 2)
// i32, clamped to nbins, and scales (nlev,) f32 in host memory; mask
// (rows, nlev, ldm) u32 scratch, 16-byte aligned, ldm = 32 x the tiles of
// 1,024 bins that cover npad; idxs, snrs (rows, nlev, mx); counts, ccounts
// (rows, nlev). Two launches on `stream`.
extern "C" int cluster_peaks_multi(const void* l0, const void* l1, const void* l2,
                                   const void* l3, const void* l4, const void* l5,
                                   long long rows, long long npad, int nbins, int nlev,
                                   const void* windows, const void* scales, float thr,
                                   int min_gap, int mx, void* mask, long long ldm, void* idxs,
                                   void* snrs, void* counts, void* ccounts, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const Levels lv{{static_cast<const float*>(l0), static_cast<const float*>(l1),
                   static_cast<const float*>(l2), static_cast<const float*>(l3),
                   static_cast<const float*>(l4), static_cast<const float*>(l5)}};
  if (nlev < 1 || nlev > kMaxLevels || nbins <= 0 || nbins > npad || npad >= kMaxBins ||
      npad % 4 != 0 || ldm != (npad + kTile - 1) / kTile * (kTile / 32) ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Windows w = {};
  for (int h = 0; h < nlev; ++h) {
    if (reinterpret_cast<uintptr_t>(lv.p[h]) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int lo = static_cast<const int32_t*>(windows)[2 * h];
    w.lo[h] = lo > 0 ? lo : 0;
    w.hi[h] = static_cast<const int32_t*>(windows)[2 * h + 1];
    w.sc[h] = static_cast<const float*>(scales)[h];
    if (w.hi[h] > nbins) return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* mk = static_cast<uint32_t*>(mask);
  auto* oi = static_cast<int32_t*>(idxs);
  auto* os = static_cast<float*>(snrs);
  auto* cn = static_cast<int32_t*>(counts);
  auto* cc = static_cast<int32_t*>(ccounts);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (nlev) {
    case 1: return launch<1>(lv, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, oi, os, cn, cc, s);
    case 2: return launch<2>(lv, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, oi, os, cn, cc, s);
    case 3: return launch<3>(lv, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, oi, os, cn, cc, s);
    case 4: return launch<4>(lv, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, oi, os, cn, cc, s);
    case 5: return launch<5>(lv, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, oi, os, cn, cc, s);
    default: return launch<6>(lv, rows, npad, nbins, w, thr, min_gap, mx, mk, ldm, oi, os, cn, cc, s);
  }
}
