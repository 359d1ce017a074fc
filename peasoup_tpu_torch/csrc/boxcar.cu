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
// 3.0 GB out, ~1.35 ms at 3.35 TB/s. The instructions come close behind:
// the tracking sweep costs ~5 a sample and width (subtract, multiply,
// compare, two selects), ~0.8 ms of issue at 12 widths on 132 SMs, so the
// loads, the sweep and the stores must overlap.
//
// Design (boxcar_map.cuh holds the geometry and the per-thread arithmetic,
// which the CPU tests run; the ring is spchain's, spchain_map.cuh and
// tma_ring.cuh):
//  - The bank (widths, scales, count) comes by value as a kernel parameter;
//    the C entry takes it from host memory, so a call makes no device
//    tensor and no copy. The shared-memory attribute is set once per
//    process and device, and the resident block count computed once.
//  - Persistent blocks, as many as the card holds at once (one wave), each
//    walking a strip of consecutive tiles of kTile samples of the
//    flattened (row, tile) space, the strips of near equal work (tiles
//    past nvalid count only their stores). A loading warp streams the
//    strip's prefix sums into a ring of kChunk-sample slots with TMA bulk
//    copies (cp.async.bulk, an mbarrier a slot), a few loads ahead of the
//    tile being swept, and none past csum[nvalid], which no boxcar reads;
//    a tile's halo (the widest boxcar's reach) stays in the ring as the
//    next tile's, so each prefix sum is read about once. Each sweeping
//    warp releases a slot once it has swept the last tile reading it.
//  - A thread takes four consecutive samples in each of four groups: lo
//    one 16-byte shared read a group, a width that is a multiple of 4 one
//    aligned 16-byte read of hi, any other width two reads and a register
//    shift; best and bw go out as one 16-byte streaming store each a
//    group (a warp's store one 512-byte run; evict-first, measured 3-10%
//    faster than plain stores, PERF.md).
//  - A tile whose every boxcar ends by nvalid (checked once a tile) sweeps
//    with no validity test; only the tiles reaching nvalid take the masked
//    sweep, and a warp whose samples all start at or past nvalid (a
//    quarter of the stream's window) writes -inf and 0 without one.
//  - Only lo stays in registers across the widths (boxcar_map.cuh:sweep),
//    so the 16 samples' running best and width fit a thread's registers
//    at two blocks an SM.
//
// boxcar_probe.py builds variants that each change one thing, by defining
// one of: BOXCAR_PLAIN_STORES (st.global for the streaming stores),
// BOXCAR_SPCHAIN_SWEEP (spchain's tracking sweep, which keeps each
// group's eight prefix sums in registers), BOXCAR_NO_SKIP (warps past
// nvalid sweep too) and BOXCAR_MEMORY_ONLY (tiles that fit store lo as
// their best with no sweep: not the kernel's function). kernels.py
// defines none.

#include <cstdint>
#include <cuda_runtime.h>

#include "boxcar_map.cuh"
#include "tma_ring.cuh"

namespace {

using spmap::kChunk;
using spmap::kGroups;
using spmap::kMaxRing;
using spmap::kMaxWidths;
using spmap::kPer;
using spmap::kThreads;
using spmap::kTile;
using spmap::kWarpSamples;
using spmap::Width;

constexpr int kWarps = kThreads / 32;         // the sweeping warps
constexpr int kBlockThreads = kThreads + 32;  // and one loading warp
constexpr int kMinBlocks = 2;  // blocks an SM (each a 80 KB ring at 12 widths; a
                               // wrapping ring of 128-224 KB leaves room for one)
constexpr int kMaxDevices = 64;

// the width bank, in its own order (the tie order)
struct Bank {
  int n, wmax;
  Width ord[kMaxWidths];
};

template <class T>
__device__ __forceinline__ void store16(T* p, T x) {
#if defined(BOXCAR_PLAIN_STORES)
  *p = x;
#else
  __stcs(p, x);
#endif
}

template <bool MASKED, bool WRAP>
__device__ __forceinline__ void sweep(const tma::Window<WRAP>& win, int o, const tma::BankAt& ord,
                                      int n, int room, float (&v)[kPer], int (&wv)[kPer]) {
#if defined(BOXCAR_SPCHAIN_SWEEP)
  spmap::sweep_track<MASKED>(win, o, ord, n, room, v, wv);
#else
#if defined(BOXCAR_MEMORY_ONLY)
  if (!MASKED) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = win(o + (j >> 2) * spmap::kGroupStride).x;
      wv[j] = 0;
    }
    return;
  }
#endif
  bxmap::sweep<MASKED>(win, o, ord, n, room, v, wv);
#endif
}

template <bool WRAP>
__global__ void __launch_bounds__(kBlockThreads, WRAP ? 1 : kMinBlocks)
boxcar_kernel(const float* __restrict__ csum, const __grid_constant__ Bank bank,
              const spmap::Plan plan, int64_t rows, int64_t row_len, int64_t tpad,
              int64_t nvalid, float* __restrict__ best, int32_t* __restrict__ bw) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kMaxRing], empty[kMaxRing];
  __shared__ Width s_bank[kMaxWidths];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int64_t g0, g1;
  bxmap::block_strip(plan, rows, tpad, nvalid, bank.n, gridDim.x, blockIdx.x, g0, g1);
  if (g0 >= g1) return;
  if (tid < bank.n) s_bank[tid] = bank.ord[tid];
  const int slots = plan.slots;
  const int lslots = __ffs(slots) - 1;  // a power of two unless WRAP
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // the loading warp: load n into slot n % slots once every sweeping warp
    // has released load n - slots (and, unless WRAP, slots 0 .. nwin - 2
    // again past the last slot), then leave
    if (lane == 0) {
      const int64_t nloads = spmap::total_loads(plan, g0, g1);
      spmap::Loader ld;
      int s = 0;
      uint32_t ph = 0;
      for (spmap::loader_start(plan, g0, g1, ld); ld.n < nloads;
           spmap::loader_next(plan, g0, g1, ld), spmap::ring_next(slots, s, ph)) {
        if (ld.n >= slots) tma::bar_wait(&empty[s], ph ^ 1u);  // load n - slots released
        const int64_t len = bxmap::chunk_floats(row_len, nvalid, ld.c);
        const uint32_t bytes = static_cast<uint32_t>(len * sizeof(float));
        const float* src = csum + ld.row * row_len + ld.c * kChunk;
        const bool copy = !WRAP && s < plan.nwin - 1;
        tma::expect_bytes(&full[s], copy ? 2 * bytes : bytes);
        if (bytes == 0) continue;  // past csum[nvalid]: the slot completes empty
        tma::bulk_load(ring + s * kChunk, src, bytes, &full[s]);
        if (copy) tma::bulk_load(ring + (slots + s) * kChunk, src, bytes, &full[s]);
      }
    }
    return;
  }

  const tma::BankAt ord{s_bank};
  const int o = spmap::sample_of(tid, 0);  // the thread's first sample
  spmap::Cursor cur;
  spmap::cursor_start(plan, g0, cur);
  while (cur.g < g1) {
    const int64_t t0 = cur.k * kTile;
    const int tile_n = static_cast<int>(tpad - t0 < kTile ? tpad - t0 : kTile);
    const int64_t have = bxmap::tile_chunks(plan, cur.k);
    int s0;  // the slot of the tile's first chunk
    uint32_t ph0;
    spmap::ring_pos(cur.n0, slots, lslots, WRAP, s0, ph0);
    {
      int s = s0;
      uint32_t ph = ph0;
      for (int64_t j = 0; j < have; ++j, spmap::ring_next(slots, s, ph)) tma::bar_wait(&full[s], ph);
    }
    if (bxmap::warp_active(tid, tile_n)) {
      const tma::Window<WRAP> win(ring, s0, slots);
      float v[kPer];
      int wv[kPer];
#if defined(BOXCAR_NO_SKIP)
      if (false) {
#else
      if (bxmap::none_fit(nvalid, t0 + warp * kWarpSamples)) {
#endif
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          v[j] = spmap::neg_inf();
          wv[j] = 0;
        }
      } else if (bxmap::tile_fits(nvalid, t0, bank.wmax)) {
        sweep<false>(win, o, ord, bank.n, 0, v, wv);
      } else {
        sweep<true>(win, o, ord, bank.n, bxmap::room_of(nvalid, t0 + o), v, wv);
      }
      float* __restrict__ brow = best + cur.row * tpad + t0;
      int32_t* __restrict__ wrow = bw + cur.row * tpad + t0;
#pragma unroll
      for (int G = 0; G < kGroups; ++G) {
        const int at = bxmap::group_offset(tid, G);
        store16(reinterpret_cast<float4*>(brow + at),
                make_float4(v[4 * G], v[4 * G + 1], v[4 * G + 2], v[4 * G + 3]));
        store16(reinterpret_cast<int4*>(wrow + at),
                make_int4(wv[4 * G], wv[4 * G + 1], wv[4 * G + 2], wv[4 * G + 3]));
      }
    }
    // the loads no later tile reads (those before the next tile's first)
    // are this warp's to release
    const int64_t n_done = cur.n0;
    spmap::cursor_next(plan, g0, g1, cur);
    __syncwarp();
    if (lane == 0) {
      int s = s0;
      uint32_t ph = ph0;
      for (int64_t n = n_done; n < cur.n0; ++n, spmap::ring_next(slots, s, ph))
        tma::bar_arrive(&empty[s]);
    }
  }
}

template <bool WRAP>
int launch(const float* csum, const Bank& bank, const spmap::Plan& plan, int64_t rows,
           int64_t row_len, int64_t tpad, int64_t nvalid, float* best, int32_t* bw,
           cudaStream_t stream) {
  const int nring = spmap::ring_chunks(plan.slots, plan.nwin, WRAP);
  const int smem_bytes = nring * kChunk * static_cast<int>(sizeof(float));
  // once per process and device: the attribute (for the largest ring), and
  // the blocks the card holds at once for each ring size
  static bool attr_set[kMaxDevices] = {};
  static int resident[kMaxDevices][kMaxRing + 1] = {};
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(boxcar_kernel<WRAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxRing * kChunk * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set[dev] = true;
  }
  if (resident[dev][nring] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boxcar_kernel<WRAP>,
                                                             kBlockThreads, smem_bytes)) != cudaSuccess)
      return static_cast<int>(err);
    resident[dev][nring] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = rows * plan.tpr;
  const int64_t blocks = tiles < resident[dev][nring] ? tiles : resident[dev][nring];
  boxcar_kernel<WRAP><<<static_cast<unsigned>(blocks), kBlockThreads, smem_bytes, stream>>>(
      csum, bank, plan, rows, row_len, tpad, nvalid, best, bw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// csum (rows, row_len) f32 on the card, 16-byte aligned, row_len a multiple
// of 4; widths (n_widths,) i32 and scales (n_widths,) f32 in host memory;
// tpad a multiple of kWarpSamples (512); best and bw (rows, tpad). One
// launch on `stream`. Returns a CUDA error, or kRefusedLayout where tpad,
// row_len or csum break the above, kRefusedBank where the widest boxcar's
// window does not fit the ring (kernels.py words both).
constexpr int kRefusedBank = -1;
constexpr int kRefusedLayout = -2;

extern "C" int boxcar_best(const void* csum, const void* widths, const void* scales,
                           int n_widths, long long rows, long long row_len, long long tpad,
                           long long nvalid, void* best, void* bw, void* stream) {
  if (rows <= 0 || tpad <= 0) return static_cast<int>(cudaSuccess);
  if (n_widths < 1 || n_widths > kMaxWidths || row_len <= tpad)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_len % 4 != 0 || tpad % kWarpSamples != 0 ||
      reinterpret_cast<uintptr_t>(csum) % 16 != 0)
    return kRefusedLayout;
  Bank bank = {};
  bank.n = n_widths;
  const auto* w = static_cast<const int32_t*>(widths);
  const auto* sc = static_cast<const float*>(scales);
  for (int k = 0; k < n_widths; ++k) {
    if (w[k] < 1 || w[k] >= row_len - tpad) return static_cast<int>(cudaErrorInvalidValue);
    bank.ord[k] = Width{w[k], sc[k]};
    bank.wmax = w[k] > bank.wmax ? w[k] : bank.wmax;
  }
  spmap::Plan plan;
  if (!bxmap::make_plan(tpad, row_len, w, n_widths, plan)) return kRefusedBank;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(csum);
  auto* b = static_cast<float*>(best);
  auto* x = static_cast<int32_t*>(bw);
  if (plan.wrap) return launch<true>(c, bank, plan, rows, row_len, tpad, nvalid, b, x, s);
  return launch<false>(c, bank, plan, rows, row_len, tpad, nvalid, b, x, s);
}

// The loaded kernel's resources, as the runtime reports them
// (cudaFuncGetAttributes), for the contiguous ring (wrap 0) and the
// wrapping one (wrap 1): registers a thread, local memory a thread
// (spills), static shared memory a block. Returns a CUDA error.
extern "C" int boxcar_attributes(int wrap, int* regs, int* local_bytes, int* shared_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = wrap ? cudaFuncGetAttributes(&a, boxcar_kernel<true>)
                               : cudaFuncGetAttributes(&a, boxcar_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *shared_bytes = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
