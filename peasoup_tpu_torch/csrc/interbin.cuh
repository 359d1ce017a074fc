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
// and writes one f32: 12 B for some thirty flops.
//
// Design (interbin_map.cuh has the map): the untwists of bin k and of its
// mirror m - k read the same two values, Z[k] and Z[m - k], swapped, so one
// thread owns two neighbouring mirror pairs, (k, k + 1) and (m - k,
// m - k - 1), and reads their four Z values in two aligned 16-byte loads:
// Z[k..k+1] and Z[m-k-2..m-k-1]. The fifth value it needs, Z[m - k], is the
// previous thread's Z[m - k'- 2] and comes by __shfl_up_sync. Interbin
// needs X[k - 1] beside X[k]: the low pair takes X[k - 1] from the previous
// thread (shfl up) and the high pair X[m - k - 2] from the next (shfl
// down); only the first lane of a warp untwists its low halo and only the
// last its high one. A thread reads its bins' untwist phasors once and
// walks four rows (blockIdx.y strides them), so the tables cost a quarter
// of a row's bytes from L2; every in-row index is 32-bit.
// Pad threads, in blocks of their own, zero the bins past m. The TPU kernel
// fetched the mirrored block, reversed it in VMEM with an anti-identity
// matmul and carried the k-1 lane across sequential blocks. Special bins
// follow the untwist identities: the mirror of k = 0 is Z[0] itself, the
// Nyquist k = m reads Z[0] and is bin 0's mirror, bin m/2 is its own
// mirror, X[-1] = 0. Each X is untwist_values' expression on the plain
// version's arguments (X[m - k] from (Z[m - k], Z[k]), not from a reflected
// X[k]), without FMA contraction (-fmad=false) and with IEEE division and
// square root.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "interbin_map.cuh"

namespace interbin {

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

__global__ void __launch_bounds__(ibmap::kThreads)
    interbin_kernel(const float2* __restrict__ z, const float* __restrict__ unc,
                    const float* __restrict__ uns, const float* __restrict__ mean,
                    const float* __restrict__ stdev, float* __restrict__ out,
                    int rows, int m, int npad) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int npairs = ibmap::pair_threads(m);
  const int pblocks = ibmap::pair_blocks(m);
  if (static_cast<int>(blockIdx.x) >= pblocks) {
    const int p = (blockIdx.x - pblocks) * ibmap::kThreads + threadIdx.x;
    const int b0 = ibmap::pad_first(m, p);
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
      float* orow = out + static_cast<int64_t>(r) * npad;
      for (int b = b0; b < b0 + 4 && b < npad; ++b) orow[b] = 0.f;
    }
    return;
  }
  // lanes past the last pair thread repeat its loads and take part in the
  // shuffles, but write nothing
  const int jr = blockIdx.x * ibmap::kThreads + threadIdx.x;
  const bool active = jr < npairs;
  const int j = active ? jr : npairs - 1;
  int bins[5];
  ibmap::pair_bins(m, j, bins);
  const int k = bins[0], h = bins[2];  // h = m - k
  const int mid = bins[4];
  const bool first = lane == 0;
  const bool last = lane == 31 || j == npairs - 1;
  // the untwist phasors of the thread's bins (and halos), read once for
  // every row it walks
  const float2 uc = *reinterpret_cast<const float2*>(unc + k);
  const float2 us = *reinterpret_cast<const float2*>(uns + k);
  const float ch0 = unc[h], sh0 = uns[h], ch1 = unc[h - 1], sh1 = uns[h - 1];
  const float cl = first && k > 0 ? unc[k - 1] : 0.f;
  const float sl = first && k > 0 ? uns[k - 1] : 0.f;
  const float ch2 = last ? unc[h - 2] : 0.f;
  const float sh2 = last ? uns[h - 2] : 0.f;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float2* zr = z + static_cast<int64_t>(r) * m;
    const float4 lo = *reinterpret_cast<const float4*>(zr + k);      // Z[k], Z[k+1]
    const float4 hi = *reinterpret_cast<const float4*>(zr + h - 2);  // Z[m-k-2], Z[m-k-1]
    const float2 zk = make_float2(lo.x, lo.y), zk1 = make_float2(lo.z, lo.w);
    const float2 zh2 = make_float2(hi.x, hi.y), zh1 = make_float2(hi.z, hi.w);
    float2 zh;  // Z[m-k]: the previous thread's Z[m-k-2]; Z[0] for k = 0
    zh.x = __shfl_up_sync(kAll, zh2.x, 1);
    zh.y = __shfl_up_sync(kAll, zh2.y, 1);
    if (first) zh = k == 0 ? zk : zr[h];
    const float2 xk = untwist_values(zk, zh, uc.x, us.x);
    const float2 xk1 = untwist_values(zk1, zh1, uc.y, us.y);
    const float2 xh = untwist_values(zh, zk, ch0, sh0);  // X[m-k]; X[m] for k = 0
    const float2 xh1 = untwist_values(zh1, zk1, ch1, sh1);
    float2 xl;  // X[k-1]: the previous thread's X[k'+1]
    xl.x = __shfl_up_sync(kAll, xk1.x, 1);
    xl.y = __shfl_up_sync(kAll, xk1.y, 1);
    if (first) {
      xl = k == 0 ? make_float2(0.f, 0.f) : untwist_values(zr[k - 1], zr[h + 1], cl, sl);
    }
    float2 xh2;  // X[m-k-2]: the next thread's X[m-k']; X[m/2] for the last
    xh2.x = __shfl_down_sync(kAll, xh.x, 1);
    xh2.y = __shfl_down_sync(kAll, xh.y, 1);
    if (last) xh2 = untwist_values(zh2, zr[k + 2], ch2, sh2);
    if (!active) continue;
    const float mu = mean[r], sd = stdev[r];
    float* orow = out + static_cast<int64_t>(r) * npad;
    *reinterpret_cast<float2*>(orow + k) =
        make_float2(interbin_value(xk, xl, mu, sd), interbin_value(xk1, xk, mu, sd));
    orow[h] = interbin_value(xh, xh1, mu, sd);
    orow[h - 1] = interbin_value(xh1, xh2, mu, sd);
    if (mid >= 0) orow[mid] = interbin_value(xh2, xk1, mu, sd);
  }
}

// rows a thread walks, reusing its untwist phasors
constexpr int kRowsPerThread = 4;

// Launches the epilogue on ``stream``; returns cudaGetLastError(). Needs m a
// multiple of 4, npad > m even, and Z, the tables and the output aligned to
// 16, 8 and 8 bytes (the wrapper checks).
inline int launch(const float2* z, const float* unc, const float* uns,
                  const float* mean, const float* stdev, float* out,
                  int64_t rows, int64_t m, int64_t npad, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const int mi = static_cast<int>(m), ni = static_cast<int>(npad);
  const int64_t ys = (rows + kRowsPerThread - 1) / kRowsPerThread;
  const dim3 grid(ibmap::pair_blocks(mi) + ibmap::pad_blocks(mi, ni),
                  static_cast<unsigned>(ys < 65535 ? ys : 65535));
  interbin_kernel<<<grid, ibmap::kThreads, 0, stream>>>(
      z, unc, uns, mean, stdev, out, static_cast<int>(rows), mi, ni);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace interbin
