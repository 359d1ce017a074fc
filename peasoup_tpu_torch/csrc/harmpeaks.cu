// Harmonic summing fused into the threshold + cluster walk.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/harmpeaks.py:find_harmonic_cluster_peaks (its
// plain twin is ops/harmonics.py:harmonic_sums(method="take") followed by
// ops/peaks.py:find_peaks_device + cluster_peaks_device).
//
// Per spectrum row and harmonic level h in 0..nharms:
//   val_0 = s[i];  val_h = val_{h-1} + sum_{k odd < 2^h} s[(i*k + 2^(h-1)) >> h]
// accumulated one `+` at a time in the reference order (levels ascending,
// odd k ascending), v_h = val_h * scales[h], a crossing is lo_h <= i < hi_h
// with v_h > thr, and the crossings of each level feed, in ascending bin
// order, the identify_unique_peaks state machine (min_gap, the lastidx
// quirk). Outputs: cluster idxs padded with nbins, cluster snrs padded with
// 0 (both (rows, nlev, mx)), raw crossing counts and cluster counts (rows,
// nlev); clusters past mx are counted and dropped.
//
// What bounds it on the H100: bytes. Every level's gathers read the same
// row (4 B per bin, at most one pass over the row per level from L1/L2),
// the outputs are tiny. Crossings are sparse, so the sequential walk costs
// little as long as it does not stall the gathers.
//
// Design: one block per row. The block walks the row left to right in
// tiles of kTile bins (kPerThread bins a thread, coalesced). For each bin
// the thread computes the nharms + 1 level values in the reference order,
// and each warp publishes a ballot of its crossings per level, with the
// scaled values, to shared memory. After a barrier, lane 0 of warp h walks
// level h's crossings of the tile in ascending order (ffs over the ballot
// words) through that level's state machine, which lives in its registers
// across tiles. Only the bins between the lowest window start and the
// highest window end are visited; bins past nbins (garbage padding) never
// cross because the caller clamps every window to nbins. The adds stay
// separate (-fmad=false), so level values are bitwise those of the plain
// version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWords = kTile / 32;
constexpr int kMaxLevels = 6;  // nharms <= 5

__global__ void harmpeaks_kernel(const float* __restrict__ spec, int64_t npad,
                                 int nbins, int nharms,
                                 const int32_t* __restrict__ windows,
                                 const float* __restrict__ scales, float thr,
                                 int min_gap, int mx, int32_t* __restrict__ idxs,
                                 float* __restrict__ snrs,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ ccounts) {
  __shared__ unsigned masks[kMaxLevels][kWords];
  __shared__ float vals[kMaxLevels][kTile];
  __shared__ int lo_s[kMaxLevels], hi_s[kMaxLevels];
  __shared__ float sc_s[kMaxLevels];

  const int nlev = nharms + 1;
  const int64_t row = blockIdx.x;
  const float* s = spec + row * npad;
  int32_t* oi = idxs + row * nlev * mx;
  float* os = snrs + row * nlev * mx;
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
  int cursor = 0, raw = 0, open = 0, cpeakidx = 0, lastidx = 0;
  float cpeak = 0.f;

  for (int64_t base = static_cast<int64_t>(bin_lo / kTile) * kTile;
       base < bin_hi; base += kTile) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int pos = j * kThreads + threadIdx.x;
      const int64_t i = base + pos;
      const bool in = i < bin_hi;
      float val = in ? s[i] : 0.f;
      for (int h = 0; h < nlev; ++h) {
        if (h > 0 && in) {
          const int64_t half = int64_t{1} << (h - 1);
          for (int64_t k = 1; k < (int64_t{1} << h); k += 2) {
            val = val + s[(i * k + half) >> h];
          }
        }
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
          ++raw;
          const bool close = open && (idx - lastidx >= min_gap);
          if (close) {
            if (cursor < mx) {
              oi[h * mx + cursor] = cpeakidx;
              os[h * mx + cursor] = cpeak;
            }
            ++cursor;
          }
          if (!open || close || snr > cpeak) {
            cpeak = snr;
            cpeakidx = idx;
            lastidx = idx;
          }
          open = 1;
        }
      }
    }
    __syncthreads();
  }
  if (walker) {
    const int h = warp;
    if (open && cursor < mx) {
      oi[h * mx + cursor] = cpeakidx;
      os[h * mx + cursor] = cpeak;
    }
    counts[row * nlev + h] = raw;
    ccounts[row * nlev + h] = cursor + open;
  }
}

}  // namespace

extern "C" int harmpeaks(const void* spec, long long rows, long long npad,
                         int nbins, int nharms, const void* windows,
                         const void* scales, float thr, int min_gap, int mx,
                         void* idxs, void* snrs, void* counts, void* ccounts,
                         void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (nharms < 0 || nharms + 1 > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  harmpeaks_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spec), npad, nbins, nharms,
      static_cast<const int32_t*>(windows), static_cast<const float*>(scales),
      thr, min_gap, mx, static_cast<int32_t*>(idxs), static_cast<float*>(snrs),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(ccounts));
  return static_cast<int>(cudaGetLastError());
}
