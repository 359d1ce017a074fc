// Time-domain acceleration resampling of a batch of (DM, accel) rows:
//   out[r, i] = x[row_dm[r], clamp(i + rint(af[r] * f32(i * (i - N))), 0, N-1)]
// with the index arithmetic in f32 as the plain version does it: quad =
// f32(i) * (f32(i) - f32(N)) rounded once (i and i - N are exact for
// N < 2^24), the product af * quad rounded once (no FMA: -fmad=false),
// and the shift rounded half to even (__float2int_rn, as torch.round), so
// the output is bitwise the plain version's.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/resample.py:resample_block_pallas (its plain twin
// is ops/resample.py:resample_rows_plain).
//
// What bounds it on the H100: bytes. Each output sample is one f32 store;
// the reads of one DM trial's series are shared by every row of that trial
// in the batch. At the main path's batch (187 rows of 2^21 samples over
// about five DM trials) that is ~1.6 GB, ~0.5 ms at 3.35 TB/s, for a few
// integer and f32 operations per sample.
//
// Design: the TPU kernel DMA'd a window per 8 sub-blocks and selected
// among four shifted copies with lane rolls, because Mosaic has no vector
// gather; that bounded the shift slope per block (choose_block). Here each
// thread gathers its samples directly. A block covers kPerBlock consecutive
// samples of one row, and loads the row's af and DM trial once. The shift's
// slope |af (2i - N)| is far below one sample per sample, so neighbouring
// threads read neighbouring addresses and both loads and stores coalesce;
// rows of one DM trial sit next to each other in a batch, so their reads
// hit L2. Every shift span is served, including those the TPU kernel
// refused. Offsets are 64-bit: r * N passes 2^31 at 1,024 rows of 2^21.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

__global__ void resample_rows_kernel(const float* __restrict__ x,
                                     const int32_t* __restrict__ row_dm,
                                     const float* __restrict__ afs,
                                     float* __restrict__ out, int64_t n,
                                     int64_t blocks_per_row) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) / blocks_per_row;
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) % blocks_per_row) * kPerBlock;
  const float af = afs[r];
  const float* __restrict__ src = x + static_cast<int64_t>(row_dm[r]) * n;
  float* __restrict__ dst = out + r * n;
  const float nf = static_cast<float>(n);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = i0 + k * kThreads + threadIdx.x;
    if (i < n) {
      const float fi = static_cast<float>(i);
      const float quad = fi * (fi - nf);
      const int64_t shift = __float2int_rn(af * quad);
      int64_t s = i + shift;
      s = s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
      dst[i] = src[s];
    }
  }
}

}  // namespace

extern "C" int resample_rows(const void* x, const void* row_dm,
                             const void* afs, void* out, long long rows,
                             long long n, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks_per_row = (n + kPerBlock - 1) / kPerBlock;
  const int64_t blocks = rows * blocks_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  resample_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(row_dm),
      static_cast<const float*>(afs), static_cast<float*>(out), n,
      blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}
