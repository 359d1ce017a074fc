// Single-pulse boxcar width sweep over padded prefix-sum rows:
//   snr_k[d, t] = (csum[d, t + w_k] - csum[d, t]) * scale_k   if t + w_k <= nvalid
//                 -inf                                         otherwise
//   best[d, t]  = max_k snr_k[d, t],   bw[d, t] = the first k reaching it
// for t < tpad, with csum rows of tpad + wext samples (wext > max w_k). The
// f32 steps are the plain version's: subtract, then multiply (no FMA:
// -fmad=false), then a strict > running max from -inf over the widths in
// order, so the narrowest width wins a tie and the output is bitwise the
// plain version's (ops/singlepulse.py:boxcar_best_plain).
//
// Replaces the TPU kernel peasoup_tpu/ops/pallas/boxcar.py:boxcar_best_pallas
// (its twin is peasoup_tpu/ops/singlepulse.py:boxcar_best_twin).
//
// What bounds it on the H100: bytes. Each prefix sum is read once from
// device memory and each output (4 + 4 bytes a sample) written once: at the
// single-pulse grid's 179 rows of 2,105,344 samples that is 1.5 GB in and
// 3.0 GB out, ~1.35 ms at 3.35 TB/s, against ~5 operations per sample and
// width (2.3e10 at 12 widths, ~0.34 ms at the f32 rate).
//
// Design: the TPU kernel DMA'd a tile's window into VMEM once and made each
// width a lane roll of it, with the width list in scalar-prefetch memory.
// Here one block covers a tile of kTile samples of one row: its threads
// load the tile's kTile + wext prefix sums into shared memory with
// coalesced loads, and each thread then sweeps the widths for samples
// tid, tid + kThreads, ..., reading lo and every hi from shared memory
// (neighbouring threads read neighbouring words, so no bank conflicts) and
// writing best and bw with coalesced stores. Widths and scales sit in
// shared memory; the validity test is one integer compare per width
// against nvalid - t, computed once per sample.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 8192;
constexpr int kMaxWidths = 32;

__global__ void boxcar_best_kernel(const float* __restrict__ csum,
                                   const int32_t* __restrict__ widths,
                                   const float* __restrict__ scales,
                                   int n_widths, int64_t row_len, int64_t tpad,
                                   int64_t nvalid, int64_t tiles_per_row,
                                   float* __restrict__ best_out,
                                   int32_t* __restrict__ bw_out) {
  extern __shared__ float win[];
  __shared__ int s_w[kMaxWidths];
  __shared__ float s_sc[kMaxWidths];
  const int64_t d = static_cast<int64_t>(blockIdx.x) / tiles_per_row;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.x) % tiles_per_row) * kTile;
  const int64_t wext = row_len - tpad;
  const int64_t win_len =
      (kTile + wext < row_len - t0) ? kTile + wext : row_len - t0;
  const float* __restrict__ src = csum + d * row_len + t0;
  for (int64_t i = threadIdx.x; i < win_len; i += kThreads) win[i] = src[i];
  if (threadIdx.x < n_widths) {
    s_w[threadIdx.x] = widths[threadIdx.x];
    s_sc[threadIdx.x] = scales[threadIdx.x];
  }
  __syncthreads();
  const int tile_n = static_cast<int>((tpad - t0 < kTile) ? tpad - t0 : kTile);
  float* __restrict__ best_row = best_out + d * tpad + t0;
  int32_t* __restrict__ bw_row = bw_out + d * tpad + t0;
  const float neg_inf = __int_as_float(0xff800000);
  for (int i = threadIdx.x; i < tile_n; i += kThreads) {
    // widths w with t + w <= nvalid, i.e. w <= room
    const int64_t room64 = nvalid - (t0 + i);
    const int room = room64 < 0 ? -1 : (room64 > 0x7fffffff ? 0x7fffffff
                                                            : static_cast<int>(room64));
    const float lo = win[i];
    float best = neg_inf;
    int bw = 0;
    for (int k = 0; k < n_widths; ++k) {
      const int w = s_w[k];
      const float snr = (w <= room) ? (win[i + w] - lo) * s_sc[k] : neg_inf;
      if (snr > best) {
        best = snr;
        bw = k;
      }
    }
    best_row[i] = best;
    bw_row[i] = bw;
  }
}

}  // namespace

extern "C" int boxcar_best(const void* csum, const void* widths,
                           const void* scales, int n_widths, long long rows,
                           long long row_len, long long tpad, long long nvalid,
                           void* best, void* bw, void* stream) {
  if (rows <= 0 || tpad <= 0) return static_cast<int>(cudaSuccess);
  if (n_widths < 1 || n_widths > kMaxWidths || row_len <= tpad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_per_row = (tpad + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTile + (row_len - tpad)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      boxcar_best_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  boxcar_best_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(csum), static_cast<const int32_t*>(widths),
      static_cast<const float*>(scales), n_widths, row_len, tpad, nvalid,
      tiles_per_row, static_cast<float*>(best), static_cast<int32_t*>(bw));
  return static_cast<int>(cudaGetLastError());
}
