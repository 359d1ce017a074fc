// Threshold + cluster walk of every harmonic level, the levels given.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/peaks.py:find_cluster_peaks_multi (its plain twin
// is ops/peaks.py:find_peaks_device + cluster_peaks_device per scaled
// level). The search takes it when the harmonic sums are formed apart
// (PEASOUP_MEGA_HARM=0); its walk (walk.cuh) takes each crossing through
// the step that harmpeaks.cu's walk shares (cluster_step.cuh).
//
// Per spectrum row and level h < nlev: v_h = level_h[i] * scales[h], then
// walk.cuh's threshold + cluster walk. Outputs: cluster idxs padded with
// nbins, cluster snrs padded with 0 (both (rows, nlev, mx)), raw crossing
// counts and cluster counts (rows, nlev); clusters past mx are counted and
// dropped.
//
// What bounds it on the H100: bytes. Each level's row is read once, 4 B a
// bin inside its window; the outputs are tiny. Crossings are sparse, so
// the sequential walk costs little as long as it does not stall the loads.
//
// Design: one block per row (walk.cuh); the thread reads each bin's level
// values from the nlev level rows as the walk asks for them.

#include <cstdint>
#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

struct Levels {
  const float* p[walk::kMaxLevels];
};

// this block's row of each level. A shared array of its own, not a pointer
// handed to the walk: the compiler then knows that the walk's shared stores
// cannot overwrite it and keeps the levels' loads in flight together.
__shared__ const float* lv_s[walk::kMaxLevels];

// level h of bin i, read from level h's row
struct LevelRows {
  __device__ __forceinline__ float operator()(int h, int64_t i, float) const {
    return lv_s[h][i];
  }
};

__global__ void peaks_kernel(Levels levels, int64_t npad, int nbins, int nlev,
                             const int32_t* __restrict__ windows,
                             const float* __restrict__ scales, float thr,
                             int min_gap, int mx, int32_t* __restrict__ idxs,
                             float* __restrict__ snrs,
                             int32_t* __restrict__ counts,
                             int32_t* __restrict__ ccounts) {
  const int64_t row = blockIdx.x;
  // the walk's first barrier publishes these
  if (threadIdx.x < nlev) lv_s[threadIdx.x] = levels.p[threadIdx.x] + row * npad;
  walk::cluster_walk(LevelRows{}, nlev, nbins, windows, scales, thr,
                     min_gap, mx, idxs + row * nlev * mx, snrs + row * nlev * mx,
                     counts + row * nlev, ccounts + row * nlev);
}

}  // namespace

// l0..l5: the (rows, npad) f32 level rows, the first nlev of them used.
extern "C" int cluster_peaks_multi(const void* l0, const void* l1,
                                   const void* l2, const void* l3,
                                   const void* l4, const void* l5,
                                   long long rows, long long npad, int nbins,
                                   int nlev, const void* windows,
                                   const void* scales, float thr, int min_gap,
                                   int mx, void* idxs, void* snrs,
                                   void* counts, void* ccounts, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (nlev < 1 || nlev > walk::kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels levels{{static_cast<const float*>(l0), static_cast<const float*>(l1),
                       static_cast<const float*>(l2), static_cast<const float*>(l3),
                       static_cast<const float*>(l4), static_cast<const float*>(l5)}};
  peaks_kernel<<<static_cast<unsigned>(rows), walk::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      levels, npad, nbins, nlev, static_cast<const int32_t*>(windows),
      static_cast<const float*>(scales), thr, min_gap, mx,
      static_cast<int32_t*>(idxs), static_cast<float*>(snrs),
      static_cast<int32_t*>(counts), static_cast<int32_t*>(ccounts));
  return static_cast<int>(cudaGetLastError());
}
