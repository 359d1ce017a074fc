// The single-pulse chain tail in one pass: the boxcar width sweep over
// padded prefix-sum rows (csrc/boxcar.cu's), then its dec-fold. For each
// block b of dec samples of row d:
//   bmax[d, b]  = max over the block of best[d, t]
//   barg[d, b]  = the first t - b*dec in the block where best reaches it
//   bwidx[d, b] = bw[d, b*dec + barg[d, b]]
// The sweep's f32 steps are the plain version's (subtract, then multiply,
// no FMA: -fmad=false; strict > over the widths in order), and the fold
// keeps the first maximum as torch.argmax and jnp.argmax do, so the output
// is bitwise the plain version's (ops/singlepulse.py:boxcar_dec_best_plain).
// A block that is all -inf gives -inf, 0 and 0.
//
// Replaces the TPU kernel peasoup_tpu/ops/pallas/spchain.py:boxcar_dec_best_pallas
// (its twin is peasoup_tpu/ops/singlepulse.py:boxcar_dec_best_twin).
//
// What bounds it on the H100: bytes. The prefix sums are read once and the
// three planes written dec times smaller than the sweep: at the
// single-pulse grid's 179 rows of 2,105,344 samples and dec 32 that is
// 1.5 GB in and 0.14 GB out, ~0.49 ms at 3.35 TB/s, against ~5 operations
// per sample and width (2.3e10 at 12 widths, ~0.34 ms at the f32 rate).
//
// Design: the TPU kernel ran the sweep as lane rolls of a VMEM window and
// folded the tile in VMEM with an iota-min argmax and a one-hot sum. Here
// one block covers a tile of kTile samples of one row. Its threads load the
// tile's kTile + wext prefix sums into shared memory with coalesced loads
// and sweep the widths for samples tid, tid + kThreads, ..., so that each
// warp holds 32 consecutive samples at a time (conflict-free shared-memory
// reads). The fold runs in registers over segments of min(dec, 32) lanes:
// the values map to integer keys in the same order (-0 taken as +0, as the
// plain comparisons do), one warp reduction (__reduce_max_sync, or a
// butterfly of shuffles for dec < 32) finds the segment's maximum, a ballot
// its first lane, and two shuffles that lane's value and width: four warp
// operations per 32 samples, where a butterfly carrying (value, index,
// width) took fifteen. For dec <= 32 the segment is the whole dec block and
// its first lane writes the result; for dec > 32 each warp leaves its
// 32-sample result in shared memory, and after a barrier one thread per dec
// block combines its dec/32 chunks in ascending order (strict >, so the
// first maximum stays). Only the fold's three planes reach device memory,
// and shared memory holds little beyond the window. dec is a power of two
// <= 1024 and tpad a multiple of max(dec, 32), so every warp runs the sweep
// loop the same number of times and no block straddles a tile. On the H100
// it still runs ~1.3x the unfused sweep's time (PERF.md): the fold, not the
// occupancy, is the cost left.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kTile = 8192;
constexpr int kChunks = kTile / 32;
constexpr int kMaxWidths = 32;

// an int whose signed order is the float order (a bijection on bit
// patterns: negative floats have their magnitude bits flipped)
__device__ __forceinline__ int ordered_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__global__ void spchain_kernel(const float* __restrict__ csum,
                               const int32_t* __restrict__ widths,
                               const float* __restrict__ scales,
                               int n_widths, int64_t row_len, int64_t tpad,
                               int64_t nvalid, int dec, int64_t tiles_per_row,
                               float* __restrict__ bmax,
                               int32_t* __restrict__ barg,
                               int32_t* __restrict__ bwidx) {
  extern __shared__ float win[];  // kTile + wext prefix sums
  __shared__ int s_w[kMaxWidths];
  __shared__ float s_sc[kMaxWidths];
  __shared__ float c_v[kChunks];  // per 32-sample chunk, for dec > 32
  __shared__ int c_i[kChunks];
  __shared__ int c_w[kChunks];
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
  const float neg_inf = __int_as_float(0xff800000);
  const int lane = threadIdx.x & 31;
  const int seg = dec < 32 ? dec : 32;  // lanes that share one dec block
  const int64_t nbd = tpad / dec;
  const int64_t out0 = d * nbd + t0 / dec;  // the tile's first dec block
  for (int i = threadIdx.x; i < tile_n; i += kThreads) {
    const int64_t room64 = nvalid - (t0 + i);
    const int room = room64 < 0 ? -1 : (room64 > 0x7fffffff ? 0x7fffffff
                                                            : static_cast<int>(room64));
    const float lo = win[i];
    float v = neg_inf;
    int wv = 0;
    for (int k = 0; k < n_widths; ++k) {
      const int w = s_w[k];
      const float snr = (w <= room) ? (win[i + w] - lo) * s_sc[k] : neg_inf;
      if (snr > v) {
        v = snr;
        wv = k;
      }
    }
    // the segment's maximum, on keys that order like the values (with -0
    // as +0), then its first lane reaching it, whose value and width are
    // the block's (or, for dec > 32, the 32-sample chunk's)
    const int key = ordered_key(v + 0.0f);
    int kmax = key;
    if (seg == 32) {
      kmax = __reduce_max_sync(0xffffffffu, key);
    } else {
      for (int off = seg >> 1; off > 0; off >>= 1)
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, off));
    }
    const int base = lane & ~(seg - 1);
    const unsigned hit = (__ballot_sync(0xffffffffu, key == kmax) >> base) &
                         (seg == 32 ? 0xffffffffu : (1u << seg) - 1u);
    const int first = base + __ffs(hit) - 1;
    const int idx = i - lane + first;
    v = __shfl_sync(0xffffffffu, v, first);
    wv = __shfl_sync(0xffffffffu, wv, first);
    if (dec <= 32) {
      if (lane == base) {
        const int64_t b = out0 + i / dec;
        bmax[b] = v;
        barg[b] = idx & (dec - 1);
        bwidx[b] = wv;
      }
    } else if (lane == 0) {
      c_v[i >> 5] = v;
      c_i[i >> 5] = idx;
      c_w[i >> 5] = wv;
    }
  }
  if (dec > 32) {
    __syncthreads();
    const int per = dec >> 5;
    for (int b = threadIdx.x; b * dec < tile_n; b += kThreads) {
      const int c0 = b * per;
      float v = c_v[c0];
      int idx = c_i[c0];
      int wv = c_w[c0];
      for (int p = 1; p < per; ++p) {
        if (c_v[c0 + p] > v) {
          v = c_v[c0 + p];
          idx = c_i[c0 + p];
          wv = c_w[c0 + p];
        }
      }
      bmax[out0 + b] = v;
      barg[out0 + b] = idx & (dec - 1);
      bwidx[out0 + b] = wv;
    }
  }
}

}  // namespace

extern "C" int boxcar_dec_best(const void* csum, const void* widths,
                               const void* scales, int n_widths, long long rows,
                               long long row_len, long long tpad,
                               long long nvalid, int dec, void* bmax,
                               void* barg, void* bwidx, void* stream) {
  if (rows <= 0 || tpad <= 0) return static_cast<int>(cudaSuccess);
  const int unit = dec > 32 ? dec : 32;
  if (n_widths < 1 || n_widths > kMaxWidths || row_len <= tpad || dec < 1 ||
      dec > 1024 || (dec & (dec - 1)) != 0 || tpad % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles_per_row = (tpad + kTile - 1) / kTile;
  const int64_t blocks = rows * tiles_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTile + (row_len - tpad)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spchain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  spchain_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(csum), static_cast<const int32_t*>(widths),
      static_cast<const float*>(scales), n_widths, row_len, tpad, nvalid, dec,
      tiles_per_row, static_cast<float*>(bmax), static_cast<int32_t*>(barg),
      static_cast<int32_t*>(bwidx));
  return static_cast<int>(cudaGetLastError());
}
