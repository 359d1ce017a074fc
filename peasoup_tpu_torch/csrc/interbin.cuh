// Packed half-length DFT Z -> real-input spectrum X (untwist) -> interbin
// amplitude -> (s - mean) / std, zero past the Nyquist bin m.
//
// The epilogue of two kernels: interbin.cu runs it on cuFFT's Z, dftspec.cu
// on the Z of its own DFT passes. Included by both; kernels.py hashes every
// header into each library's name, so an edit here rebuilds both.
//
// Input: Z = DFT_m(x[0::2] + i x[1::2]) as interleaved complex64 rows
// (R, m). Output (R, npad) f32.
//
// What bounds it on the H100: bytes. Each output bin reads one complex Z
// twice over (Z[k] and the mirror Z[m-k]; the k-1 neighbours come from
// L1/L2) and writes one f32: about 12 B for some thirty flops.
//
// Design: one thread per output bin. The TPU kernel fetched the mirrored
// block, reversed it in VMEM with an anti-identity matmul and carried the
// k-1 lane across sequential blocks; here a thread reads Z[k], Z[m-k] and
// the k-1 pair directly and recomputes X[k-1], so there is no carry and no
// reversal. Special bins follow the untwist identities: the mirror of k = 0
// is Z[0] itself and the Nyquist k = m reads Z[0]; X[-1] = 0. Expressions
// replay the plain version term for term without FMA contraction
// (-fmad=false) and with IEEE division and square root.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace interbin {

constexpr int kThreads = 256;

__device__ __forceinline__ void untwist(const float2* __restrict__ z,
                                        const float* __restrict__ unc,
                                        const float* __restrict__ uns,
                                        int64_t m, int64_t k, float& xr,
                                        float& xi) {
  const float2 zk = z[k == m ? 0 : k];
  const float2 zm = z[k == 0 ? 0 : m - k];
  const float arr = 0.5f * (zk.x + zm.x);
  const float aii = 0.5f * (zk.y - zm.y);
  const float br = zk.x - zm.x;
  const float bi = zk.y + zm.y;
  const float c = unc[k];
  const float s = uns[k];
  xr = arr + 0.5f * (c * bi - s * br);
  xi = aii - 0.5f * (c * br + s * bi);
}

__global__ void interbin_kernel(const float2* __restrict__ z,
                                const float* __restrict__ unc,
                                const float* __restrict__ uns,
                                const float* __restrict__ mean,
                                const float* __restrict__ stdev,
                                float* __restrict__ out, int64_t rows,
                                int64_t m, int64_t npad) {
  const int64_t total = rows * npad;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < total; g += stride) {
    const int64_t r = g / npad;
    const int64_t k = g - r * npad;
    if (k > m) {
      out[g] = 0.f;
      continue;
    }
    const float2* zr = z + r * m;
    float xr, xi;
    untwist(zr, unc, uns, m, k, xr, xi);
    float xl = 0.f, il = 0.f;
    if (k > 0) untwist(zr, unc, uns, m, k - 1, xl, il);
    const float ampsq = xr * xr + xi * xi;
    const float dr = xr - xl;
    const float di = xi - il;
    const float dsq = 0.5f * (dr * dr + di * di);
    const float amp = sqrtf(fmaxf(ampsq, dsq));
    out[g] = (amp - mean[r]) / stdev[r];
  }
}

// Launches the epilogue on ``stream``; returns cudaGetLastError().
inline int launch(const float2* z, const float* unc, const float* uns,
                  const float* mean, const float* stdev, float* out,
                  int64_t rows, int64_t m, int64_t npad, cudaStream_t stream) {
  const int64_t total = rows * npad;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  interbin_kernel<<<blocks, kThreads, 0, stream>>>(z, unc, uns, mean, stdev,
                                                   out, rows, m, npad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace interbin
