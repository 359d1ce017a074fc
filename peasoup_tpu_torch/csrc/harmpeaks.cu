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
// odd k ascending); the levels then go through walk.cuh's threshold +
// cluster walk. Outputs: cluster idxs padded with nbins, cluster snrs padded
// with 0 (both (rows, nlev, mx)), raw crossing counts and cluster counts
// (rows, nlev); clusters past mx are counted and dropped.
//
// What bounds it on the H100: bytes. Every level's gathers read the same
// row (4 B per bin, at most one pass over the row per level from L1/L2),
// the outputs are tiny. Crossings are sparse, so the sequential walk costs
// little as long as it does not stall the gathers.
//
// Design: one block per row (walk.cuh); the thread forms each bin's level
// values with its gathers as the walk asks for them, level by level. The
// adds stay separate (-fmad=false), so level values are bitwise those of
// the plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

// level h of bin i from level h - 1: the odd-k gathers of the row
struct HarmonicSums {
  const float* s;  // this block's spectrum row

  __device__ __forceinline__ float operator()(int h, int64_t i, float prev) const {
    if (h == 0) return s[i];
    float val = prev;
    const int64_t half = int64_t{1} << (h - 1);
    for (int64_t k = 1; k < (int64_t{1} << h); k += 2) {
      val = val + s[(i * k + half) >> h];
    }
    return val;
  }
};

__global__ void harmpeaks_kernel(const float* __restrict__ spec, int64_t npad,
                                 int nbins, int nharms,
                                 const int32_t* __restrict__ windows,
                                 const float* __restrict__ scales, float thr,
                                 int min_gap, int mx, int32_t* __restrict__ idxs,
                                 float* __restrict__ snrs,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ ccounts) {
  const int nlev = nharms + 1;
  const int64_t row = blockIdx.x;
  walk::cluster_walk(HarmonicSums{spec + row * npad}, nlev, nbins, windows,
                     scales, thr, min_gap, mx, idxs + row * nlev * mx,
                     snrs + row * nlev * mx, counts + row * nlev,
                     ccounts + row * nlev);
}

}  // namespace

extern "C" int harmpeaks(const void* spec, long long rows, long long npad,
                         int nbins, int nharms, const void* windows,
                         const void* scales, float thr, int min_gap, int mx,
                         void* idxs, void* snrs, void* counts, void* ccounts,
                         void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (nharms < 0 || nharms + 1 > walk::kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  harmpeaks_kernel<<<static_cast<unsigned>(rows), walk::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spec), npad, nbins, nharms,
      static_cast<const int32_t*>(windows), static_cast<const float*>(scales),
      thr, min_gap, mx, static_cast<int32_t*>(idxs), static_cast<float*>(snrs),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(ccounts));
  return static_cast<int>(cudaGetLastError());
}
