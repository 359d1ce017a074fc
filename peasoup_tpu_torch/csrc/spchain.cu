// The single-pulse chain tail in one pass: the boxcar width sweep over
// padded prefix-sum rows (csrc/boxcar.cu's), then its dec-fold. For each
// block b of dec samples of row d:
//   bmax[d, b]  = max over the block of best[d, t]
//   barg[d, b]  = the first t - b*dec in the block where best reaches it
//   bwidx[d, b] = bw[d, b*dec + barg[d, b]]
// with best, bw the strict > sweep over the widths in the bank's order
// (ties keep the earlier width; boxcars past nvalid are -inf). A block that
// is all -inf gives -inf, 0 and 0. The output is bitwise the plain
// version's (ops/singlepulse.py:boxcar_dec_best_plain): every S/N is the
// plain version's f32 subtract then multiply (-fmad=false).
//
// Replaces the TPU kernel peasoup_tpu/ops/pallas/spchain.py:boxcar_dec_best_pallas
// (its twin is peasoup_tpu/ops/singlepulse.py:boxcar_dec_best_twin).
//
// What bounds it on the H100: bytes, in principle. The prefix sums are
// read once and the three planes written dec times smaller than the sweep:
// at the single-pulse grid's 179 rows of 2,108,416 prefix sums and dec 32
// that is 1.5 GB in and 0.14 GB out, ~0.49 ms at 3.35 TB/s. In practice the
// instructions hold it (PERF.md): on an H100 the stream alone runs near
// that bound, and the sweep (a subtract, a multiply and a max for each of
// 4.5e9 samples and widths, and the 16-byte shared reads that feed them)
// and the fold add to it rather than hide behind it.
//
// Design (spchain_map.cuh holds the geometry and the per-thread
// arithmetic, which the CPU tests run):
//  - Persistent blocks, about as many as the card holds at once, each
//    walking an equal run of consecutive tiles of kTile samples of the
//    flattened (row, tile) space. The block streams the run's prefix sums
//    into a ring of kChunk-sample slots in shared memory with TMA bulk
//    copies (cp.async.bulk, completion on one mbarrier a slot), loads ahead
//    of the tile being swept; a tile's halo (the widest boxcar's reach)
//    stays in the ring for the next tile, so the prefix sums are read about
//    once. The first slots are copied again past the last, so a tile's
//    window is contiguous and every read is one offset from one base; a
//    bank too wide for the copies (widths past ~20k samples, up to the
//    ~53k a 14-chunk ring holds) takes a ring whose windows wrap round its
//    end, each read one compare-and-subtract dearer. A
//    loading warp of its own issues the copies; each sweeping warp releases
//    a slot (an mbarrier arrival) once it has swept the last tile reading
//    it, so the warps never wait for one another.
//  - A warp sweeps 512 samples as four groups of 128, a lane 4 samples of
//    each (16 a thread: more independent work a warp measured faster than
//    8), so each 16-byte shared read is one contiguous 512-byte run of the
//    warp (no bank conflicts): widths 1..4 from the group's own eight
//    prefix sums, a multiple of 4 from one aligned float4 a group, any
//    other width from two. For dec >= 8 it keeps the running maximum only
//    (fmaxf: one instruction a sample and width, NaN boxcars skipped as the
//    plain version's strict > skips them); tiles whose every boxcar fits
//    before nvalid take a loop with no validity test.
//  - The fold: a first maximum over a lane's 4 samples of a group, then
//    over the dec/4 lanes of a dec block (shuffles and one ballot; the four
//    groups' blocks side by side), over whole groups for dec = 256 or 512,
//    or over the block's warps through shared memory for dec > 512. Values
//    compare as values (-0 equals +0), as torch.argmax and jnp.argmax
//    compare them.
//  - The width, and the value's exact bits, come from the winning sample
//    alone: the first width (in the bank's order) whose boxcar there equals
//    the block's maximum, tested by the block's lanes a width each. That
//    is the plain sweep's strict > result (spchain_map.cuh:boxcar_at), at
//    1/dec of the sweep's cost. A block whose maximum is zero also looks
//    at the sign of each of its zero samples' best, as jnp.max's IEEE
//    maximum does (spchain_map.cuh:block_value).
//  - dec < 8 (a block inside one lane) takes the plain version's tracking
//    sweep instead, width by width in the bank's order, strict >.

#include <cstdint>
#include <cuda_runtime.h>

#include "spchain_map.cuh"
#include "tma_ring.cuh"

namespace {

using spmap::kChunk;
using spmap::kGroups;
using spmap::kGroupStride;
using spmap::kMaxRing;
using spmap::kMaxWidths;
using spmap::kPer;
using spmap::kThreads;
using spmap::kTile;
using spmap::kWarpSamples;
using spmap::Width;

constexpr int kWarps = kThreads / 32;            // the sweeping warps
constexpr int kBlockThreads = kThreads + 32;     // and one loading warp
constexpr int kMinBlocks = 2;  // blocks an SM (each a 80 KB ring at 12 widths; a
                               // wrapping ring of 128-224 KB leaves room for one)

// the bank in its own order (the tie order) and sorted into sweep classes
struct Banks {
  int n, nsmall, naligned, wmax;
  Width ord[kMaxWidths];
  Width sorted[kMaxWidths];
};

using tma::BankAt;
using tma::bar_arrive;
using tma::bar_init;
using tma::bar_wait;
using tma::bulk_load;
using tma::expect_bytes;
using tma::Window;

// the sweeping warps alone (the loading warp has left)
__device__ __forceinline__ void sweepers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Whether any of this lane's samples of group G whose best is a zero has
// +0 there (the best taken by the bank-order rule at that sample).
template <class Win>
__device__ __forceinline__ bool any_positive_zero(const Win& win, const float (&v)[kPer],
                                                  int G, int o, int64_t room, const BankAt& ord,
                                                  int nw) {
  bool pz = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (v[4 * G + i] == 0.f) {
      int f;
      const int t = o + G * kGroupStride + i;
      const float b = spmap::best_at([&](int x) { return win.at(x); }, t, 0.f,
                                     room - G * kGroupStride - i, ord, nw, f);
      pz |= spmap::positive_zero(b);
    }
  }
  return pz;
}

// The widths of N blocks at their winning samples ts[i] (tile offsets),
// each tested by the g lanes from lane g0 a width each, the N blocks' tests
// side by side. found[i]: the first width in the bank's order whose boxcar
// equals m[i] (0 for an empty block), val[i]: that boxcar.
template <int N, class Win>
__device__ __forceinline__ void resolve(const Win& win, const int (&ts)[N],
                                        const float (&m)[N], const int64_t (&room)[N],
                                        const BankAt& ord, int n, int g, int g0,
                                        int (&found)[N], float (&val)[N]) {
  const int lane = threadIdx.x & 31;
  const unsigned gmask = (g == 32 ? 0xffffffffu : (1u << g) - 1u) << g0;
  float lo[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    lo[i] = win.at(ts[i]);
    found[i] = spmap::block_is_empty(m[i]) ? 0 : -1;
    val[i] = spmap::neg_inf();
  }
  // no test waits for an earlier round's outcome
#pragma unroll 1
  for (int r0 = 0; r0 < n; r0 += g) {
    const int k = r0 + lane - g0;
    const Width e = ord(k < n ? k : 0);
    float s[N];
    unsigned bits[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = spmap::boxcar_at(lo[i], win.at(ts[i] + e.w), e.w, e.sc, room[i]);
      bits[i] = __ballot_sync(0xffffffffu, k < n && s[i] == m[i]) & gmask;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int f = bits[i] ? __ffs(bits[i]) - 1 : g0;
      const float sv = __shfl_sync(0xffffffffu, s[i], f);
      if (found[i] < 0 && bits[i]) {
        found[i] = r0 + f - g0;
        val[i] = sv;
      }
    }
  }
}

// The first maxima of N groups over the g lanes from g0 (gmask): their
// values, and their samples' tile offsets. m[i], j[i]: this lane's.
template <int N>
__device__ __forceinline__ void group_max(const float (&m)[N], const int (&j)[N], int g,
                                          unsigned gmask, float (&mx)[N], int (&ts)[N]) {
  const int wbase = (threadIdx.x >> 5) * kWarpSamples;
#pragma unroll
  for (int i = 0; i < N; ++i) mx[i] = m[i];
  for (int o = 1; o < g; o <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) mx[i] = spmap::max2(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int lead = __ffs(__ballot_sync(0xffffffffu, m[i] == mx[i]) & gmask) - 1;
    // j[i] indexes v: group j >> 2, sample j & 3
    const int jl = __shfl_sync(0xffffffffu, j[i], lead);
    ts[i] = wbase + (jl >> 2) * kGroupStride + 4 * lead + (jl & 3);
  }
}

// TD = 0: the value sweep and the fold across lanes (dec >= 8); TD = dec
// (1, 2 or 4): the tracking sweep, every block inside one lane's group.
// WRAP: the ring holds no copies, and a window wraps round its end.
template <int TD, bool WRAP>
__global__ void __launch_bounds__(kBlockThreads, WRAP ? 1 : kMinBlocks)
spchain_kernel(const float* __restrict__ csum, const Banks bank, spmap::Plan plan, int64_t tiles,
               int64_t row_len, int64_t tpad, int64_t nvalid, int dec,
               float* __restrict__ bmax, int32_t* __restrict__ barg,
               int32_t* __restrict__ bwidx) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kMaxRing], empty[kMaxRing];
  __shared__ Width s_ord[kMaxWidths], s_sorted[kMaxWidths];
  __shared__ float s_m[kWarps];
  __shared__ int s_t[kWarps];
  __shared__ bool s_pz[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int64_t g0, g1;
  spmap::block_tiles(tiles, gridDim.x, blockIdx.x, g0, g1);
  if (g0 >= g1) return;
  if (tid < bank.n) {
    s_ord[tid] = bank.ord[tid];
    s_sorted[tid] = bank.sorted[tid];
  }
  const int slots = plan.slots;
  const int lslots = __ffs(slots) - 1;  // a power of two unless WRAP
  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kWarps);
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
        if (ld.n >= slots) bar_wait(&empty[s], ph ^ 1u);  // load n - slots released
        const int64_t len = row_len - ld.c * kChunk < kChunk ? row_len - ld.c * kChunk : kChunk;
        const uint32_t bytes = static_cast<uint32_t>(len * sizeof(float));
        const float* src = csum + ld.row * row_len + ld.c * kChunk;
        const bool copy = !WRAP && s < plan.nwin - 1;
        expect_bytes(&full[s], copy ? 2 * bytes : bytes);
        bulk_load(ring + s * kChunk, src, bytes, &full[s]);
        if (copy) bulk_load(ring + (slots + s) * kChunk, src, bytes, &full[s]);
      }
    }
    return;
  }

  const BankAt ord{s_ord}, sorted{s_sorted};
  const int64_t nbd = tpad / dec;
  const int ldec = __ffs(dec) - 1;  // a power of two
  const int o = spmap::sample_of(tid, 0);  // the thread's first sample
  spmap::Cursor cur;
  spmap::cursor_start(plan, g0, cur);
  while (cur.g < g1) {
    const int64_t t0 = cur.k * kTile;
    const int tile_n = static_cast<int>(tpad - t0 < kTile ? tpad - t0 : kTile);
    const int64_t have = plan.nch - cur.k < plan.nwin ? plan.nch - cur.k : plan.nwin;
    int s0;  // the slot of the tile's first chunk
    uint32_t ph0;
    spmap::ring_pos(cur.n0, slots, lslots, WRAP, s0, ph0);
    {
      int s = s0;
      uint32_t ph = ph0;
      for (int64_t j = 0; j < have; ++j, spmap::ring_next(slots, s, ph)) bar_wait(&full[s], ph);
    }
    const Window<WRAP> win(ring, s0, slots);
    const bool active = warp * kWarpSamples < tile_n;  // tile_n: a multiple of kWarpSamples
    const int64_t room64 = nvalid - (t0 + o);
    const int room = static_cast<int>(room64 < -(1 << 20) ? -(1 << 20)
                                      : (room64 > (1 << 30) ? (1 << 30) : room64));
    const bool fits = nvalid - t0 - (kTile - 1) >= bank.wmax;  // every boxcar
    const int64_t out0 = cur.row * nbd + (t0 >> ldec);  // the tile's first block
    float v[kPer];

    if (TD > 0) {
      int wv[kPer];
      if (active) {
        if (fits) spmap::sweep_track<false>(win, o, ord, bank.n, 0, v, wv);
        else spmap::sweep_track<true>(win, o, ord, bank.n, room, v, wv);
#pragma unroll
        for (int b0 = 0; b0 < kPer; b0 += TD) {
          int j = b0;
          bool pz = spmap::positive_zero(v[b0]);
#pragma unroll
          for (int i = b0 + 1; i < b0 + TD; ++i) {
            if (v[i] > v[j]) j = i;
            pz |= spmap::positive_zero(v[i]);
          }
          const int64_t b = out0 + spmap::sample_of(tid, b0) / TD;
          bmax[b] = spmap::block_value(v[j], v[j], pz);
          barg[b] = spmap::sample_of(tid, j) & (TD - 1);
          bwidx[b] = wv[j];
        }
      }
    } else {
      if (!active) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[j] = spmap::neg_inf();
      } else if (fits) {
        spmap::sweep<false>(win, o, sorted, bank.nsmall, bank.naligned, bank.n, 0, v);
      } else {
        spmap::sweep<true>(win, o, sorted, bank.nsmall, bank.naligned, bank.n, room, v);
      }
      float m[kGroups];
      int j[kGroups];
#pragma unroll
      for (int G = 0; G < kGroups; ++G) spmap::first_max4(v, G, m[G], j[G]);
      // a block is dec / 4 lanes of one group (all groups side by side), or
      // for dec > 128 whole groups
      const int g = dec / 4 < 32 ? dec / 4 : 32;
      const int gl0 = lane & ~(g - 1);
      const unsigned gmask = (g == 32 ? 0xffffffffu : (1u << g) - 1u) << gl0;
      float mx[kGroups];
      int ts[kGroups];
      group_max(m, j, g, gmask, mx, ts);
      bool pz[kGroups];
#pragma unroll
      for (int G = 0; G < kGroups; ++G) pz[G] = false;
      bool zero = false;
#pragma unroll
      for (int G = 0; G < kGroups; ++G) zero |= mx[G] == 0.f;
      if (__any_sync(0xffffffffu, zero)) {  // rare: a zero maximum
#pragma unroll
        for (int G = 0; G < kGroups; ++G) {
          pz[G] = (__ballot_sync(0xffffffffu,
                                 mx[G] == 0.f && active &&
                                     any_positive_zero(win, v, G, o, room64, ord, bank.n)) &
                   gmask) != 0;
        }
      }
      if (dec <= kGroupStride) {
        int64_t rooms[kGroups];
#pragma unroll
        for (int G = 0; G < kGroups; ++G) rooms[G] = nvalid - (t0 + ts[G]);
        int found[kGroups];
        float val[kGroups];
        resolve(win, ts, mx, rooms, ord, bank.n, g, gl0, found, val);
        if (lane == gl0 && active) {
#pragma unroll
          for (int G = 0; G < kGroups; ++G) {
            const int64_t b = out0 + (ts[G] >> ldec);
            bmax[b] = spmap::block_value(mx[G], val[G], pz[G]);
            barg[b] = ts[G] & (dec - 1);
            bwidx[b] = found[G];
          }
        }
      } else {
        // blocks of dec / 128 whole groups, or of whole warps
        const int gpb = dec / kGroupStride < kGroups ? dec / kGroupStride : kGroups;
        for (int G0 = 0; G0 < kGroups; G0 += gpb) {
          float wm[1] = {mx[G0]};
          int wt[1] = {ts[G0]};
          bool wpz = pz[G0];
#pragma unroll
          for (int G = 1; G < kGroups; ++G) {
            if (G < gpb) {
              if (mx[G0 + G] > wm[0]) {
                wm[0] = mx[G0 + G];
                wt[0] = ts[G0 + G];
              }
              wpz |= pz[G0 + G];
            }
          }
          bool owner = active;  // the warp resolves its own block
          if (dec > kWarpSamples) {
            if (lane == 0) {
              s_m[warp] = wm[0];
              s_t[warp] = wt[0];
              s_pz[warp] = wpz;
            }
            sweepers_sync();
            const int per = dec / kWarpSamples;  // warps a block
            owner = warp * dec < tile_n;
            if (owner) {
              wm[0] = s_m[warp * per];
              wt[0] = s_t[warp * per];
              wpz = s_pz[warp * per];
              for (int p = 1; p < per; ++p) {
                if (s_m[warp * per + p] > wm[0]) {
                  wm[0] = s_m[warp * per + p];
                  wt[0] = s_t[warp * per + p];
                }
                wpz |= s_pz[warp * per + p];
              }
            }
          }
          if (owner) {
            const int64_t rooms[1] = {nvalid - (t0 + wt[0])};
            int found[1];
            float val[1];
            resolve(win, wt, wm, rooms, ord, bank.n, 32, 0, found, val);
            if (lane == 0) {
              const int64_t b = out0 + (wt[0] >> ldec);
              bmax[b] = spmap::block_value(wm[0], val[0], wpz);
              barg[b] = wt[0] & (dec - 1);
              bwidx[b] = found[0];
            }
          }
        }
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
      for (int64_t n = n_done; n < cur.n0; ++n, spmap::ring_next(slots, s, ph)) bar_arrive(&empty[s]);
    }
    if (dec > kWarpSamples) sweepers_sync();  // s_m, s_t, s_pz are read
  }
}

template <int TD, bool WRAP>
int launch(const float* csum, const Banks& bank, const spmap::Plan& plan, int64_t rows,
           int64_t row_len, int64_t tpad, int64_t nvalid, int dec, float* bmax, int32_t* barg,
           int32_t* bwidx, cudaStream_t stream) {
  const int smem_bytes =
      spmap::ring_chunks(plan.slots, plan.nwin, WRAP) * kChunk * static_cast<int>(sizeof(float));
  // as many blocks as the card holds at once (cached per shared-memory size)
  static int attr_set = 0;
  static int resident[kMaxRing + 1] = {};
  const int key = smem_bytes / (kChunk * static_cast<int>(sizeof(float)));
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(spchain_kernel<TD, WRAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxRing * kChunk * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = 1;
  }
  if (resident[key] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spchain_kernel<TD, WRAP>,
                                                             kBlockThreads, smem_bytes)) != cudaSuccess)
      return static_cast<int>(err);
    resident[key] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = rows * plan.tpr;
  const int64_t blocks = tiles < resident[key] ? tiles : resident[key];
  spchain_kernel<TD, WRAP><<<static_cast<unsigned>(blocks), kBlockThreads, smem_bytes, stream>>>(
      csum, bank, plan, tiles, row_len, tpad, nvalid, dec, bmax, barg, bwidx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// csum (rows, row_len) f32 on the card, 16-byte aligned, row_len a multiple
// of 4; widths (n_widths,) i32 and scales (n_widths,) f32 in host memory;
// tpad a multiple of kWarpSamples (512) and of dec; bmax, barg, bwidx (rows, tpad / dec).
// One launch on `stream`. Returns a CUDA error, or kRefusedLayout where
// tpad, row_len or csum break the above, kRefusedBank where the widest
// boxcar's window does not fit the ring (kernels.py words both).
constexpr int kRefusedBank = -1;
constexpr int kRefusedLayout = -2;

extern "C" int boxcar_dec_best(const void* csum, const void* widths, const void* scales,
                               int n_widths, long long rows, long long row_len,
                               long long tpad, long long nvalid, int dec, void* bmax,
                               void* barg, void* bwidx, void* stream) {
  if (rows <= 0 || tpad <= 0) return static_cast<int>(cudaSuccess);
  if (n_widths < 1 || n_widths > kMaxWidths || row_len <= tpad || dec < 1 || dec > 1024 ||
      (dec & (dec - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_len % 4 != 0 || tpad % kWarpSamples != 0 || tpad % dec != 0 ||
      reinterpret_cast<uintptr_t>(csum) % 16 != 0)
    return kRefusedLayout;
  Banks bank = {};
  bank.n = n_widths;
  const auto* w = static_cast<const int32_t*>(widths);
  const auto* sc = static_cast<const float*>(scales);
  for (int k = 0; k < n_widths; ++k) {
    if (w[k] < 1 || w[k] >= row_len - tpad) return static_cast<int>(cudaErrorInvalidValue);
    bank.ord[k] = Width{w[k], sc[k]};
    bank.wmax = w[k] > bank.wmax ? w[k] : bank.wmax;
  }
  spmap::Bank sorted;
  spmap::sort_bank(w, sc, n_widths, sorted);
  bank.nsmall = sorted.nsmall;
  bank.naligned = sorted.naligned;
  for (int k = 0; k < n_widths; ++k) bank.sorted[k] = sorted.sorted[k];
  spmap::Plan plan;
  plan.tpr = (tpad + kTile - 1) / kTile;
  plan.nch = (row_len + kChunk - 1) / kChunk;
  plan.nwin = spmap::window_chunks(spmap::reach(w, n_widths));
  spmap::plan_ring(plan.nwin, plan.slots, plan.wrap);
  if (plan.slots == 0) return kRefusedBank;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(csum);
  auto* m = static_cast<float*>(bmax);
  auto* a = static_cast<int32_t*>(barg);
  auto* x = static_cast<int32_t*>(bwidx);
  if (plan.wrap) {
    switch (dec) {
      case 1: return launch<1, true>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
      case 2: return launch<2, true>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
      case 4: return launch<4, true>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
      default: return launch<0, true>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
    }
  }
  switch (dec) {
    case 1: return launch<1, false>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
    case 2: return launch<2, false>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
    case 4: return launch<4, false>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
    default: return launch<0, false>(c, bank, plan, rows, row_len, tpad, nvalid, dec, m, a, x, s);
  }
}
