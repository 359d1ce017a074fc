// Packed half-length DFT Z -> real-input spectrum X (untwist) -> interbin
// amplitude -> (s - mean) / std, zero past the Nyquist bin m.
//
// The epilogue of two kernels: interbin.cu runs this kernel on cuFFT's Z;
// dftspec.cu runs its arithmetic (untwist_values, interbin_value) on the Z
// of its own DFT, held in its cluster's shared memory. Included by both;
// kernels.py hashes every header into each library's name, so an edit here
// rebuilds both.
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

// The rfft bin X[k] from Z[k], the mirror Z[m-k] and the untwist phasor
// (c, s) = (unc[k], uns[k]). dftspec.cu runs the same terms on the Z its
// cluster holds in shared memory.
__device__ __forceinline__ float2 untwist_values(float2 zk, float2 zm, float c,
                                                 float s) {
  const float arr = 0.5f * (zk.x + zm.x);
  const float aii = 0.5f * (zk.y - zm.y);
  const float br = zk.x - zm.x;
  const float bi = zk.y + zm.y;
  return make_float2(arr + 0.5f * (c * bi - s * br), aii - 0.5f * (c * br + s * bi));
}

// The normalised interbin amplitude of bin k from X[k] and X[k-1].
__device__ __forceinline__ float interbin_value(float2 x, float2 xl, float mean,
                                                float stdev) {
  const float ampsq = x.x * x.x + x.y * x.y;
  const float dr = x.x - xl.x;
  const float di = x.y - xl.y;
  const float dsq = 0.5f * (dr * dr + di * di);
  const float amp = sqrtf(fmaxf(ampsq, dsq));
  return (amp - mean) / stdev;
}

__device__ __forceinline__ float2 untwist(const float2* __restrict__ z,
                                          const float* __restrict__ unc,
                                          const float* __restrict__ uns,
                                          int64_t m, int64_t k) {
  return untwist_values(z[k == m ? 0 : k], z[k == 0 ? 0 : m - k], unc[k], uns[k]);
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
    const float2 x = untwist(zr, unc, uns, m, k);
    const float2 xl = k > 0 ? untwist(zr, unc, uns, m, k - 1) : make_float2(0.f, 0.f);
    out[g] = interbin_value(x, xl, mean[r], stdev[r]);
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
