// Incoherent dedispersion: out[d, t] = q(scale * sum_c kill[c] * x[t + delay[d, c], c]).
//
// Replaces the TPU kernel peasoup_tpu/ops/pallas/dedisperse.py:dedisperse_pallas
// (its plain twin is ops/dedisperse.py:dedisperse_block).
//
// What bounds it on the H100: each output sample sums every kept channel,
// so at 64 channels the adds, not the bytes (one in per (sample, channel),
// one out per (trial, sample)), set the floor.
//
// Design (dedisp_map.cuh has the maps). The filterbank is read as it lies,
// time-major (T, C) u8: no transposed copy. A block owns 16 DM trials and
// 2,048 output samples and walks the band in chunks of up to 16
// neighbouring channels, cut on multiples of the chunk's width, skipping
// the chunks that hold no kept channel. For each chunk it stages the input
// rows its trials reach (the time window plus the spread of the chunk's
// kept channels' delays) channel-major in shared memory, one byte per
// sample, together with each trial's delay on each channel, 16 bits
// relative to the chunk's least delay. Where rows are 16-byte aligned (a
// multiple of 16 channels and an aligned input: every chunk of the main
// path's filterbanks, whatever the kill mask) a 16-channel chunk is staged
// with one 16-byte load a row and a 4x4 byte transpose in registers, its
// killed channels with the rest; any other chunk a byte at a time, its kept
// channels only. The sums walk the chunk's kept channels only (a mask, the
// same for the whole block, so no warp diverges).
// Each thread then sums 8 samples (two groups of 4) for each of the 16
// trials: per trial and channel it reads two neighbouring words, shifts
// the four samples it needs out of them and adds them as two pairs of
// 16-bit lanes, bytes 0 and 2 in one 32-bit add and bytes 1 and 3 in
// another. A lane holds 256 channels of 8-bit samples; past 256 kept
// channels the lanes are flushed to 32-bit sums every 256. Every term is a
// small non-negative integer (the kill mask is 0/1 and killed channels are
// skipped), so the sums are exact and equal the plain version's f32 sums
// (exact below 2^24); each is scaled, rounded half to even and clipped as
// the plain version does, so the output is its bit for bit. The output
// tile goes through shared memory and out in aligned 32-bit words.
// Multiply and add stay separate (the build passes -fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

#include "dedisp_map.cuh"

namespace {

using ddmap::kGroups;
using ddmap::kRecs;
using ddmap::kThreads;
using ddmap::kTile;
using ddmap::kTrials;

constexpr int kStageLoads = 8;

struct Args {
  const uint8_t* x;        // (t_in, nchans) u8
  const int2* chunks;      // (nchunks,) a chunk's first channel, mask of its kept channels
  const uint4* rel;        // (ntiles, nchunks, 2^log_chunk) records of 8 u16
  const int2* lo_spread;   // (ntiles, nchunks) least delay, spread
  uint8_t* out;            // (ndm, out_n) u8
  int64_t t_in, out_n;
  int nchans, ndm, log_chunk, nchunks, pitch, ntime;
  float scale;
  int apply_scale;
  bool wide;               // ddmap::wide_staging
};

#ifdef DEDISP_STAMPS
// A measuring build (dedisp_probe.py): each warp's clock64() cycles by
// phase (staging, waiting at a barrier, summing, the output tile), summed
// over the launch's warps, and the number of warps. Not the main path's
// build.
enum { kStage, kBarrier, kSums, kOut, kWarps, kStamps };
__device__ unsigned long long* g_stamps;
#define STAMP(k)                               \
  do {                                         \
    const long long now = clock64();           \
    cyc[k] += static_cast<unsigned long long>(now - t_mark); \
    t_mark = now;                              \
  } while (0)
#else
#define STAMP(k) \
  do {           \
  } while (0)
#endif

__device__ __forceinline__ uint32_t word(const uint4& v, int g) {
  return g == 0 ? v.x : g == 1 ? v.y : g == 2 ? v.z : v.w;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads) dedisperse_kernel(const Args a) {
  extern __shared__ uint4 smem[];
  uint4* srel = smem;  // the chunk's channels' records
  uint32_t* win = reinterpret_cast<uint32_t*>(smem + (kRecs << ddmap::kMaxLogChunk));
  uint8_t* winb = reinterpret_cast<uint8_t*>(win);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int d0 = tile * kTrials;
  const int nd = min(kTrials, a.ndm - d0);
  const int chunk = 1 << a.log_chunk;
#ifdef DEDISP_STAMPS
  unsigned long long cyc[kStamps] = {};
  long long t_mark = clock64();
#endif

  for (int tt = blockIdx.y; tt < a.ntime; tt += gridDim.y) {
    const int64_t t0 = static_cast<int64_t>(tt) * kTile;
    uint32_t lanes[kTrials][kGroups][2];  // even, odd 16-bit lane pairs
    uint32_t wide[kWide ? kTrials : 1][kGroups][4];
#pragma unroll
    for (int i = 0; i < kTrials; ++i) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        lanes[i][g][0] = lanes[i][g][1] = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) wide[kWide ? i : 0][g][q] = 0u;
      }
    }
    int in_lanes = 0;  // channels summed into the 16-bit lanes
    for (int ck = 0; ck < a.nchunks; ++ck) {
      const int2 cm = a.chunks[ck];  // first channel, kept mask
      const uint32_t kept = static_cast<uint32_t>(cm.y);
      const int2 ls = a.lo_spread[tile * a.nchunks + ck];
      const int rows = ddmap::window_rows(ls.y);
      if (tid < chunk * kRecs) {
        srel[tid] = a.rel[(static_cast<int64_t>(tile) * a.nchunks + ck) * chunk * kRecs + tid];
      }
      const int64_t row0 = t0 + ls.x;  // the window's first input row
      if (a.wide) {
        // a quad of rows a thread: four 16-byte loads, a byte transpose,
        // one word a channel
        const uint8_t* src = a.x + row0 * a.nchans + cm.x;
        for (int q = tid; 4 * q < rows; q += kThreads) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = row0 + 4 * q + u < a.t_in
                       ? __ldg(reinterpret_cast<const uint4*>(src + (4 * q + u) * static_cast<int64_t>(a.nchans)))
                       : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            uint32_t cw[4];
            ddmap::transpose4(word(v[0], g), word(v[1], g), word(v[2], g), word(v[3], g), cw);
#pragma unroll
            for (int i = 0; i < 4; ++i) win[(4 * g + i) * a.pitch + q] = cw[i];
          }
        }
      } else {
        // one byte a load: each thread keeps one channel (256 is a
        // multiple of the chunk) and keeps kStageLoads loads in flight
        // before their stores, or the staging waits on each in turn
        int cl, r;
        ddmap::stage_coords(tid, a.log_chunk, cl, r);
        const int step = kThreads >> a.log_chunk;
        const bool live = (kept >> cl) & 1u;
        const uint8_t* src = a.x + row0 * a.nchans + (live ? cm.x + cl : 0);
        uint8_t* dst = winb + static_cast<int64_t>(cl) * a.pitch * 4;
        for (; live && r < rows; r += kStageLoads * step) {
          uint8_t v[kStageLoads];
#pragma unroll
          for (int u = 0; u < kStageLoads; ++u) {
            const int ru = r + u * step;
            const bool ok = ru < rows && row0 + ru < a.t_in;
            v[u] = ok ? __ldg(src + static_cast<int64_t>(ru) * a.nchans) : uint8_t{0};
          }
#pragma unroll
          for (int u = 0; u < kStageLoads; ++u) {
            if (r + u * step < rows) dst[r + u * step] = v[u];
          }
        }
      }
      STAMP(kStage);
      __syncthreads();
      STAMP(kBarrier);
      for (uint32_t m = kept; m != 0u; m &= m - 1u) {
        const int c = ddmap::low_bit(m);
        uint32_t rec[kTrials / 2];
#pragma unroll
        for (int e = 0; e < kRecs; ++e) {
          const uint4 rv = srel[c * kRecs + e];
          rec[4 * e] = rv.x;
          rec[4 * e + 1] = rv.y;
          rec[4 * e + 2] = rv.z;
          rec[4 * e + 3] = rv.w;
        }
        const uint32_t* row = win + c * a.pitch;
#pragma unroll
        for (int i = 0; i < kTrials; ++i) {
          const int rel = ddmap::rel_of(rec, i);
          const int shift = ddmap::read_shift(rel);
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const int w = ddmap::read_word(tid, g, rel);
            const uint32_t b = ddmap::funnel(row[w], row[w + 1], shift);
            lanes[i][g][0] += ddmap::even_lanes(b);
            lanes[i][g][1] += ddmap::odd_lanes(b);
          }
        }
      }
      in_lanes += popcount32(kept);
      if (kWide && (in_lanes + chunk > ddmap::kLaneChannels || ck + 1 == a.nchunks)) {
#pragma unroll
        for (int i = 0; i < kTrials; ++i) {
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            wide[kWide ? i : 0][g][0] += lanes[i][g][0] & 0xFFFFu;
            wide[kWide ? i : 0][g][1] += lanes[i][g][1] & 0xFFFFu;
            wide[kWide ? i : 0][g][2] += lanes[i][g][0] >> 16;
            wide[kWide ? i : 0][g][3] += lanes[i][g][1] >> 16;
            lanes[i][g][0] = lanes[i][g][1] = 0u;
          }
        }
        in_lanes = 0;
      }
      STAMP(kSums);
      __syncthreads();
      STAMP(kBarrier);
    }
    // the output tile through shared memory (the window is free after the
    // last chunk's barrier), so a row goes out in aligned 32-bit words
#pragma unroll
    for (int i = 0; i < kTrials; ++i) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        uint32_t s[4];
        if (kWide) {
#pragma unroll
          for (int q = 0; q < 4; ++q) s[q] = wide[kWide ? i : 0][g][q];
        } else {
          s[0] = lanes[i][g][0] & 0xFFFFu;
          s[1] = lanes[i][g][1] & 0xFFFFu;
          s[2] = lanes[i][g][0] >> 16;
          s[3] = lanes[i][g][1] >> 16;
        }
        uint32_t packed = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          packed |= static_cast<uint32_t>(ddmap::quantise(s[q], a.scale, a.apply_scale)) << (8 * q);
        }
        win[i * ddmap::kTileWords + ddmap::out_word(tid, g)] = packed;
      }
    }
    __syncthreads();
    const int n = static_cast<int>(min(static_cast<int64_t>(kTile), a.out_n - t0));
    for (int i = 0; i < nd; ++i) {
      const int64_t g_addr = static_cast<int64_t>(d0 + i) * a.out_n + t0;
      uint8_t* orow = a.out + g_addr;
      const uint32_t* trow = win + i * ddmap::kTileWords;
      const int head = min(ddmap::head_bytes(g_addr), n);
      const int nwords = (n - head) / 4;
      const int tail = head + 4 * nwords;
      if (tid < head) orow[tid] = winb[i * kTile + tid];
      if (tail + tid < n) orow[tail + tid] = winb[i * kTile + tail + tid];
      const int shift = 8 * (head & 3);
      for (int j = tid; j < nwords; j += kThreads) {
        const int o = head + 4 * j;
        *reinterpret_cast<uint32_t*>(orow + o) = ddmap::funnel(trow[o >> 2], trow[(o >> 2) + 1], shift);
      }
    }
    __syncthreads();
    STAMP(kOut);
  }
#ifdef DEDISP_STAMPS
  if ((tid & 31) == 0) {
    cyc[kWarps] = 1;
    for (int k = 0; k < kStamps; ++k) atomicAdd(g_stamps + k, cyc[k]);
  }
#endif
}

template <bool kWide>
int launch(const Args& a, cudaStream_t stream) {
  // the records, then the larger of the window and the output tile (and
  // the word past the tile its last funnel reads)
  const int window = (1 << a.log_chunk) * a.pitch * 4;
  const int tile = kTrials * kTile + 4;
  const int smem = (kRecs << ddmap::kMaxLogChunk) * 16 + (window > tile ? window : tile);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dedisperse_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.ndm + kTrials - 1) / kTrials, a.ntime < 65535 ? a.ntime : 65535);
  dedisperse_kernel<kWide><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tables (chunks, rel, lo_spread) come from ops/dedisperse.py:_tables.
extern "C" int dedisperse_u8(const void* x, long long t_in, int nchans,
                             const void* chunks, int nkept, const void* rel,
                             const void* lo_spread, int log_chunk, int nchunks,
                             int pitch, void* out, int ndm, long long out_nsamps,
                             float scale, int apply_scale, void* stream) {
  if (out_nsamps <= 0 || ndm <= 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.chunks = static_cast<const int2*>(chunks);
  a.rel = static_cast<const uint4*>(rel);
  a.lo_spread = static_cast<const int2*>(lo_spread);
  a.out = static_cast<uint8_t*>(out);
  a.t_in = t_in;
  a.out_n = out_nsamps;
  a.nchans = nchans;
  a.ndm = ndm;
  a.log_chunk = log_chunk;
  a.nchunks = nchunks;
  a.pitch = pitch;
  a.ntime = static_cast<int>((out_nsamps + kTile - 1) / kTile);
  a.scale = scale;
  a.apply_scale = apply_scale;
  a.wide = ddmap::wide_staging(log_chunk, nchans, reinterpret_cast<uintptr_t>(x));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nkept > ddmap::kLaneChannels ? launch<true>(a, s) : launch<false>(a, s);
}

// Whether dedisperse_u8 stages the chunks of an input at x with 16-byte
// loads (ddmap::wide_staging), for the wrapper's counters: 1 or 0.
extern "C" int dedisperse_wide_staging(int log_chunk, int nchans, const void* x) {
  return ddmap::wide_staging(log_chunk, nchans, reinterpret_cast<uintptr_t>(x)) ? 1 : 0;
}

// The kernel's resources as the runtime reports them for the loaded binary
// (cudaFuncGetAttributes), for the variant past 256 kept channels (wide 1)
// and the one below (wide 0): registers a thread, local memory a thread
// (spills), static shared memory a block. Returns a CUDA error.
extern "C" int dedisperse_attributes(int wide, int* regs, int* local_bytes, int* shared_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = wide ? cudaFuncGetAttributes(&f, dedisperse_kernel<true>)
                               : cudaFuncGetAttributes(&f, dedisperse_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = f.numRegs;
  *local_bytes = static_cast<int>(f.localSizeBytes);
  *shared_bytes = static_cast<int>(f.sharedSizeBytes);
  return 0;
}

#ifdef DEDISP_STAMPS
// Where the measuring build sums its cycles: kStamps u64 counters on the card.
extern "C" int dedisperse_stamps_to(void* counters) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &counters, sizeof(counters)));
}
#endif
