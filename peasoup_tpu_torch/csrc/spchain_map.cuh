// spchain.cu's geometry and per-thread arithmetic, compiled for the card
// and, by the CPU tests (tests/test_torch_kernel_host.py), for the host:
// the width bank's sweep classes, the ring of prefix-sum chunks a block
// streams through, the order in which a block loads those chunks and
// walks its tiles, which samples a thread sweeps, its sweep, and the rule
// that recovers a dec block's width at its winning sample.
//
// A block walks a run of consecutive tiles (kTile samples) of the
// flattened (row, tile) space. Row r's samples arrive in chunks of kChunk
// prefix sums, one load each, in the order the block needs them; load n
// lands in ring slot n % slots. Tile k of a row reads chunks k ..
// k + nwin - 1 (its samples and the widest boxcar's reach past them), so
// once tile k is done the chunks before k + 1 are free. The ring holds the
// load a tile starts at and the slots - 1 after it. Where the space allows
// (plan_ring), slots 0 .. nwin - 2 are also copied past the last slot, so
// a tile's window is contiguous from its first chunk's slot, whichever
// slot that is; a wider bank's window wraps round the ring's end instead
// (ring_at).
//
// A warp sweeps kWarpSamples consecutive samples of a tile as kGroups
// groups of 128, lane l taking samples 4l .. 4l + 3 of each (one float4 a
// group), so that every 16-byte shared read of a warp is one contiguous
// 512-byte run.

#pragma once

#include <cstdint>

#include "hd.cuh"

namespace spmap {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                      // groups of 4 samples a thread
constexpr int kPer = 4 * kGroups;               // samples a thread
constexpr int kGroupStride = 128;               // from one group to the next
constexpr int kWarpSamples = kGroupStride * kGroups;
constexpr int kTile = kThreads * kPer;          // samples a tile
constexpr int kChunk = kTile;                   // prefix sums a load
constexpr int kMinSlots = 4;
constexpr int kMaxRing = 14;  // ring chunks, copies included: 224 KB of a block's 227 KB
constexpr int kMaxWidths = 32;

// the tile offset of thread tid's sample j (group j / 4)
PEASOUP_HD int sample_of(int tid, int j) {
  return (tid >> 5) * kWarpSamples + (j >> 2) * kGroupStride + 4 * (tid & 31) + (j & 3);
}

PEASOUP_HD float neg_inf() {
#if defined(__CUDA_ARCH__)
  return __int_as_float(0xff800000);
#else
  return -__builtin_huge_valf();
#endif
}
PEASOUP_HD float max2(float a, float b) {
#if defined(__CUDA_ARCH__)
  return fmaxf(a, b);
#else
  return __builtin_fmaxf(a, b);
#endif
}

// A width and its scale, read together (one 8-byte shared load).
struct alignas(8) Width {
  int w;
  float sc;
};

// The width bank in the sweep's order: widths 1..4 (read from the group's
// own eight prefix sums), then multiples of 4 (one aligned float4 a group),
// then the rest (two aligned float4 a group). The value sweep keeps only a
// running maximum, so its order does not matter; the bank's own order
// decides ties, at the winner.
struct Bank {
  int n, nsmall, naligned;
  Width sorted[kMaxWidths];
};

PEASOUP_HD int width_class(int w) { return w <= 4 ? 0 : (w % 4 == 0 ? 1 : 2); }

PEASOUP_HD void sort_bank(const int* w, const float* sc, int n, Bank& b) {
  b.n = n;
  int at = 0;
  for (int cls = 0; cls < 3; ++cls) {
    for (int k = 0; k < n; ++k) {
      if (width_class(w[k]) != cls) continue;
      b.sorted[at].w = w[k];
      b.sorted[at].sc = sc[k];
      ++at;
    }
    if (cls == 0) b.nsmall = at;
    if (cls == 1) b.naligned = at - b.nsmall;
  }
}

// The last prefix sum a group's sweep reads, counted from its first
// sample: its own eight (lo and widths 1..4), one float4 from t + w for a
// multiple of 4, two from t + (w & ~3) for any other width.
PEASOUP_HD int reach(const int* w, int n) {
  int r = 7;
  for (int k = 0; k < n; ++k) {
    const int e = width_class(w[k]) == 0 ? 7 : (w[k] % 4 == 0 ? w[k] + 3 : (w[k] & ~3) + 7);
    r = e > r ? e : r;
  }
  return r;
}

// The chunks a tile reads: from its last group's first sample, kTile - 4,
// to that plus the reach.
PEASOUP_HD int window_chunks(int reach_) { return (kTile - 4 + reach_ + 1 + kChunk - 1) / kChunk; }

// The ring for a tile's nwin chunks. Where it fits kMaxRing, a power of
// two of slots holding them and at least two loads ahead (at least
// kMinSlots), with the first nwin - 1 copied past the last so that every
// window is contiguous (wrap false). A wider window takes nwin + 2 slots,
// at most kMaxRing, at least nwin, with no copies, and wraps round the
// ring's end (wrap true). slots = 0 where even nwin slots pass kMaxRing.
PEASOUP_HD void plan_ring(int nwin, int& slots, bool& wrap) {
  int s = kMinSlots;
  while (s < nwin + 2) s <<= 1;
  wrap = s + nwin - 1 > kMaxRing;
  if (!wrap) {
    slots = s;
    return;
  }
  slots = nwin + 2 < kMaxRing ? nwin + 2 : kMaxRing;
  if (slots < nwin) slots = 0;
}
PEASOUP_HD int ring_chunks(int slots, int nwin, bool wrap) { return wrap ? slots : slots + nwin - 1; }

// Where offset o of a window whose first chunk is in slot s lies in the
// ring, in floats: o < nwin kChunk, so it wraps at most once.
PEASOUP_HD int ring_at(int s, int o, int slots, bool wrap) {
  const int i = s * kChunk + o;
  return wrap && i >= slots * kChunk ? i - slots * kChunk : i;
}

// Load n's slot, and the parity of that slot's phase it completes (its
// use of the slot, counted from 0, mod 2); lslots = log2(slots) where the
// ring does not wrap (a power of two of slots).
PEASOUP_HD void ring_pos(int64_t n, int slots, int lslots, bool wrap, int& s, uint32_t& ph) {
  if (wrap) {
    const uint32_t u = static_cast<uint32_t>(n);  // a block's loads: far below 2^32
    s = static_cast<int>(u % static_cast<uint32_t>(slots));
    ph = (u / static_cast<uint32_t>(slots)) & 1u;
  } else {
    s = static_cast<int>(n & (slots - 1));
    ph = static_cast<uint32_t>(n >> lslots) & 1u;
  }
}

// The next load's slot and parity.
PEASOUP_HD void ring_next(int slots, int& s, uint32_t& ph) {
  if (++s == slots) {
    s = 0;
    ph ^= 1u;
  }
}

struct Plan {
  int64_t tpr;  // tiles a row: ceil(tpad / kTile)
  int64_t nch;  // chunks a row: ceil(row_len / kChunk)
  int nwin;     // chunks a tile reads
  int slots;    // ring slots
  bool wrap;    // a window wraps round the ring (no copies)
};

// Block b of nblocks takes tiles [g0, g1) of rows x tpr.
PEASOUP_HD void block_tiles(int64_t tiles, int64_t nblocks, int64_t b, int64_t& g0, int64_t& g1) {
  g0 = tiles * b / nblocks;
  g1 = tiles * (b + 1) / nblocks;
}

// The chunks [a, e) of row r that the block with tiles [g0, g1) loads.
PEASOUP_HD void row_loads(const Plan& p, int64_t g0, int64_t g1, int64_t r, int64_t& a,
                          int64_t& e) {
  a = r == g0 / p.tpr ? g0 % p.tpr : 0;
  const int64_t b = r == (g1 - 1) / p.tpr ? (g1 - 1) % p.tpr + 1 : p.tpr;
  e = b - 1 + p.nwin < p.nch ? b - 1 + p.nwin : p.nch;
}

// The block's tile walk: tile g is tile k of row `row`; its first chunk
// (chunk k) is load n0.
struct Cursor {
  int64_t g, row, k, n0, row_base;
};

PEASOUP_HD void cursor_start(const Plan& p, int64_t g0, Cursor& c) {
  c.g = g0;
  c.row = g0 / p.tpr;
  c.k = g0 % p.tpr;
  c.n0 = 0;
  c.row_base = 0;
}

PEASOUP_HD void cursor_next(const Plan& p, int64_t g0, int64_t g1, Cursor& c) {
  ++c.g;
  ++c.k;
  if (c.k == p.tpr) {
    int64_t a, e;
    row_loads(p, g0, g1, c.row, a, e);
    c.row_base += e - a;
    c.n0 = c.row_base;
    ++c.row;
    c.k = 0;
  } else {
    ++c.n0;
  }
}

// The block's loads in order: load n is chunk c of row `row`; the row's
// loads end at chunk e.
struct Loader {
  int64_t n, row, c, e;
};

PEASOUP_HD void loader_start(const Plan& p, int64_t g0, int64_t g1, Loader& l) {
  int64_t a;
  l.n = 0;
  l.row = g0 / p.tpr;
  row_loads(p, g0, g1, l.row, a, l.e);
  l.c = a;
}

PEASOUP_HD void loader_next(const Plan& p, int64_t g0, int64_t g1, Loader& l) {
  ++l.n;
  if (++l.c == l.e) {
    int64_t a;
    ++l.row;
    row_loads(p, g0, g1, l.row, a, l.e);
    l.c = a;
  }
}

PEASOUP_HD int64_t total_loads(const Plan& p, int64_t g0, int64_t g1) {
  int64_t n = 0;
  for (int64_t r = g0 / p.tpr; r <= (g1 - 1) / p.tpr; ++r) {
    int64_t a, e;
    row_loads(p, g0, g1, r, a, e);
    n += e - a;
  }
  return n;
}

// One width applied to a thread's groups: hi[j] = x[G][i + S], lo[j] =
// own[G][i] for sample j = 4 G + i, snr = (hi - lo) * sc as the plain
// version rounds it. MASKED: sample j counts the boxcar only where
// w <= room - G kGroupStride - i (room: nvalid less the thread's first
// sample). Value sweep: into the running maxima v. Tracking sweep (wv
// given): strict >, v and wv taking the boxcar and its bank index k.
template <bool MASKED, int S, int N>
PEASOUP_HD void apply(const float (&x)[kGroups][N], const float (&own)[kGroups][8], int w,
                      float sc, int room, float (&v)[kPer], int (*wv)[kPer] = nullptr,
                      int k = 0) {
  PEASOUP_UNROLL
  for (int j = 0; j < kPer; ++j) {
    const int G = j >> 2, i = j & 3;
    const float s = (x[G][i + S] - own[G][i]) * sc;
    const bool fits = !MASKED || w <= room - G * kGroupStride - i;
    if (wv == nullptr) {
      if (fits) v[j] = max2(v[j], s);
    } else if (fits && s > v[j]) {
      v[j] = s;
      (*wv)[j] = k;
    }
  }
}

template <class F4>
PEASOUP_HD void unpack(const F4& a, float* x) {
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

// One width k for every group, reading what its class needs: group G at
// tile offset o + G kGroupStride. rd(x) is the float4 of prefix sums at
// tile offset x (a multiple of 4).
template <bool MASKED, class Read4>
PEASOUP_HD void apply_width(const Read4& rd, int o, const float (&own)[kGroups][8], int w,
                            float sc, int room, float (&v)[kPer], int (*wv)[kPer], int k) {
  const int cls = width_class(w);
  if (cls == 0) {
    switch (w) {
      case 1: apply<MASKED, 1>(own, own, w, sc, room, v, wv, k); break;
      case 2: apply<MASKED, 2>(own, own, w, sc, room, v, wv, k); break;
      case 3: apply<MASKED, 3>(own, own, w, sc, room, v, wv, k); break;
      default: apply<MASKED, 4>(own, own, w, sc, room, v, wv, k); break;
    }
  } else if (cls == 1) {
    float x[kGroups][4];
    PEASOUP_UNROLL
    for (int G = 0; G < kGroups; ++G) unpack(rd(o + G * kGroupStride + w), x[G]);
    apply<MASKED, 0>(x, own, w, sc, room, v, wv, k);
  } else {
    const int b = w & ~3;
    float x[kGroups][8];
    PEASOUP_UNROLL
    for (int G = 0; G < kGroups; ++G) {
      unpack(rd(o + G * kGroupStride + b), x[G]);
      unpack(rd(o + G * kGroupStride + b + 4), x[G] + 4);
    }
    switch (w & 3) {
      case 1: apply<MASKED, 1>(x, own, w, sc, room, v, wv, k); break;
      case 2: apply<MASKED, 2>(x, own, w, sc, room, v, wv, k); break;
      default: apply<MASKED, 3>(x, own, w, sc, room, v, wv, k); break;
    }
  }
}

// Each group's own eight prefix sums (its samples and the four after).
template <class Read4>
PEASOUP_HD void own8(const Read4& rd, int o, float (&own)[kGroups][8]) {
  PEASOUP_UNROLL
  for (int G = 0; G < kGroups; ++G) {
    unpack(rd(o + G * kGroupStride), own[G]);
    unpack(rd(o + G * kGroupStride + 4), own[G] + 4);
  }
}

// One thread's value sweep: v[j] = the largest boxcar S/N of its sample j
// (sample_of) over the bank (up to the sign of a zero, and with NaN S/N
// skipped, as the plain version's strict > skips them), -inf where no
// boxcar fits. o: the thread's first sample's tile offset; room = nvalid
// less that sample, clamped to int (MASKED only). The bank in sweep order.
template <bool MASKED, class Read4, class WidthAt>
PEASOUP_HD void sweep(const Read4& rd, int o, const WidthAt& bank, int nsmall, int naligned,
                      int n, int room, float (&v)[kPer]) {
  float own[kGroups][8];
  own8(rd, o, own);
  PEASOUP_UNROLL
  for (int j = 0; j < kPer; ++j) v[j] = neg_inf();
  for (int k = 0; k < nsmall; ++k) {
    const Width e = bank(k);
    apply_width<MASKED>(rd, o, own, e.w, e.sc, room, v, nullptr, 0);
  }
  const int a_end = nsmall + naligned;
#if defined(__CUDACC__)
  _Pragma("unroll 1")  // measured faster than 2 or 4 (PERF.md)
#endif
  for (int k = nsmall; k < a_end; ++k) {
    const Width e = bank(k);
    float x[kGroups][4];
    PEASOUP_UNROLL
    for (int G = 0; G < kGroups; ++G) unpack(rd(o + G * kGroupStride + e.w), x[G]);
    apply<MASKED, 0>(x, own, e.w, e.sc, room, v);
  }
  for (int k = a_end; k < n; ++k) {
    const Width e = bank(k);
    apply_width<MASKED>(rd, o, own, e.w, e.sc, room, v, nullptr, 0);
  }
}

// The tracking sweep, for dec < 8 where every sample's width is wanted:
// the plain version's strict > over the bank in its own order, bit for
// bit (v the best S/N, wv its width).
template <bool MASKED, class Read4, class WidthAt>
PEASOUP_HD void sweep_track(const Read4& rd, int o, const WidthAt& bank, int n, int room,
                            float (&v)[kPer], int (&wv)[kPer]) {
  float own[kGroups][8];
  own8(rd, o, own);
  PEASOUP_UNROLL
  for (int j = 0; j < kPer; ++j) {
    v[j] = neg_inf();
    wv[j] = 0;
  }
  for (int k = 0; k < n; ++k) {
    const Width e = bank(k);
    apply_width<MASKED>(rd, o, own, e.w, e.sc, room, v, &wv, k);
  }
}

// The first of group G's four samples reaching their
// maximum (compared as values: -0 equals +0), as an index into v.
PEASOUP_HD void first_max4(const float (&v)[kPer], int G, float& m, int& j) {
  m = v[4 * G];
  j = 4 * G;
  PEASOUP_UNROLL
  for (int i = 1; i < 4; ++i) {
    if (v[4 * G + i] > m) {
      m = v[4 * G + i];
      j = 4 * G + i;
    }
  }
}

// Width k's boxcar at the winning sample: (hi - lo) * sc, -inf where it
// does not fit (w > room). The block's width is the first k (in the bank's
// own order) whose boxcar equals the block's maximum m, and the winner's
// best S/N that boxcar; a block whose maximum is -inf takes width 0. That
// is the plain version's strict > sweep at that sample, bit for bit: the
// running maximum only moves to a strictly larger value, so it stops at
// the first width reaching the final one, and NaN boxcars never equal m.
PEASOUP_HD float boxcar_at(float lo, float hi, int w, float sc, int64_t room) {
  return w <= room ? (hi - lo) * sc : neg_inf();
}
PEASOUP_HD bool block_is_empty(float m) { return m == neg_inf(); }

// That rule at sample ts, one width after another: the best S/N there, bit
// for bit, given its maximum m (found: its width). at(o) is the prefix sum
// at tile offset o; room = nvalid - t.
template <class At, class WidthAt>
PEASOUP_HD float best_at(const At& at, int ts, float m, int64_t room, const WidthAt& bank,
                         int n, int& found) {
  const float lo = at(ts);
  found = block_is_empty(m) ? 0 : -1;
  float val = neg_inf();
  for (int k = 0; k < n && found < 0; ++k) {
    const Width e = bank(k);
    const float s = boxcar_at(lo, at(ts + e.w), e.w, e.sc, room);
    if (s == m) {
      found = k;
      val = s;
    }
  }
  return val;
}

// The block max is jnp.max's, IEEE maximum: where the maximum is zero it
// is +0 if any sample's best is +0, else -0 (the winner's own best may
// carry the other sign). Only blocks whose maximum is zero look at their
// samples' signs.
PEASOUP_HD bool positive_zero(float x) {
#if defined(__CUDA_ARCH__)
  return x == 0.f && copysignf(1.f, x) > 0.f;
#else
  return x == 0.f && __builtin_copysignf(1.f, x) > 0.f;
#endif
}
PEASOUP_HD float block_value(float m, float val, bool any_positive_zero) {
  return m == 0.f ? (any_positive_zero ? 0.f : -0.f) : val;
}

}  // namespace spmap
