// The once-per-DM-trial spectrum-chain tail in one pass: deredden (divide
// by the running median, zero bins 0-4), zap birdies to 1+0i, and the
// interbinned amplitude s0 = sqrt(max(|X_k|^2, 0.5|X_k - X_{k-1}|^2)).
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/specchain.py:interp_deredden_zap_pallas (its
// plain twin is ops/spectrum.py:interp_deredden_zap).
//
// What bounds it on the H100: bytes. Each bin reads re, im, med (12 B) and
// the mask byte and writes three f32 (12 B), about 24 B for a dozen flops,
// far below the card's 20 flop/B balance point.
//
// Design: one thread per (row, bin), grid-stride over the flat batch. The
// TPU kernel carried the left neighbour across sequential column tiles;
// here each thread simply recomputes bin k-1's dereddened and zapped value
// (two extra loads that hit L1/L2), so blocks stay independent. The
// arithmetic replays the plain version's f32 expressions term for term
// with IEEE division and square root (no fast math) and no FMA
// contraction (-fmad=false), so the parts are bitwise those of the plain
// version and s0 agrees to rounding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void deredden_zap(const float* __restrict__ re,
                                             const float* __restrict__ im,
                                             const float* __restrict__ med,
                                             const uint8_t* __restrict__ zap,
                                             int64_t off, int64_t j, float& rd,
                                             float& id) {
  if (j < 5) {
    rd = 0.f;
    id = 0.f;
  } else {
    rd = re[off] / med[off];
    id = im[off] / med[off];
  }
  if (zap[j]) {
    rd = 1.f;
    id = 0.f;
  }
}

__global__ void specchain_kernel(const float* __restrict__ re,
                                 const float* __restrict__ im,
                                 const float* __restrict__ med,
                                 const uint8_t* __restrict__ zap,
                                 float* __restrict__ re_out,
                                 float* __restrict__ im_out,
                                 float* __restrict__ s0, int64_t total,
                                 int64_t nbins) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < total; g += stride) {
    const int64_t j = g % nbins;
    float rd, id;
    deredden_zap(re, im, med, zap, g, j, rd, id);
    float rl = 0.f, il = 0.f;
    if (j > 0) deredden_zap(re, im, med, zap, g - 1, j - 1, rl, il);
    const float ampsq = rd * rd + id * id;
    const float dr = rd - rl;
    const float di = id - il;
    const float diff = 0.5f * (dr * dr + di * di);
    re_out[g] = rd;
    im_out[g] = id;
    s0[g] = sqrtf(fmaxf(ampsq, diff));
  }
}

}  // namespace

extern "C" int specchain(const void* re, const void* im, const void* med,
                         const void* zap, void* re_out, void* im_out,
                         void* s0, long long rows, long long nbins,
                         void* stream) {
  const int64_t total = rows * nbins;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  specchain_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(med), static_cast<const uint8_t*>(zap),
      static_cast<float*>(re_out), static_cast<float*>(im_out),
      static_cast<float*>(s0), total, nbins);
  return static_cast<int>(cudaGetLastError());
}
