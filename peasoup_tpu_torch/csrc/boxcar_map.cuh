// boxcar.cu's geometry and per-thread arithmetic, compiled for the card
// and, by the CPU tests (tests/test_torch_kernel_host.py), for the host.
//
// The ring and its load order are spchain's (spchain_map.cuh), since both
// kernels stream the same prefix-sum rows: a block owns a strip of
// consecutive tiles (kTile samples) of the flattened (row, tile) space
// (block_strip, below) and loads each row's prefix sums into its ring
// once, in chunks of kChunk; tile k of a row reads chunks k .. k + nwin -
// 1 (spmap::ring_at: where a sample lies in the ring), and all but the
// first stay in the ring as the next tile's halo. A thread takes kPer
// samples, four consecutive ones in each of kGroups groups
// (spmap::sample_of: a warp's 16-byte reads and stores are 512-byte
// runs). What is boxcar's own is below: the plan, the strips of equal
// work, the prefix sums a load brings in, the carried halo, the
// per-tile validity predicate, its sweep (the plain version's strict >
// over the bank in its own order, with only lo held in registers: a
// float4 a group; a width that is a multiple of 4 one aligned float4 of
// hi, any other width two float4s and a register shift), and where a
// thread's groups go in the two outputs (one float4 of best and one int4
// of bw a group).

#pragma once

#include <cstdint>

#include "hd.cuh"
#include "spchain_map.cuh"

namespace bxmap {

using spmap::kChunk;
using spmap::kGroups;
using spmap::kGroupStride;
using spmap::kPer;
using spmap::kThreads;
using spmap::kTile;
using spmap::kWarpSamples;
using spmap::Plan;

// The plan of a launch over rows of row_len prefix sums, tpad outputs a
// row, for the bank w[0..n): tiles and chunks a row, the chunks a tile
// reads and the ring. False where even a wrapping ring cannot hold a
// tile's window (widths past ~53k samples).
PEASOUP_HD bool make_plan(int64_t tpad, int64_t row_len, const int* w, int n, Plan& p) {
  p.tpr = (tpad + kTile - 1) / kTile;
  p.nch = (row_len + kChunk - 1) / kChunk;
  p.nwin = spmap::window_chunks(spmap::reach(w, n));
  spmap::plan_ring(p.nwin, p.slots, p.wrap);
  return p.slots != 0;
}

// The work of tiles 0 .. k - 1 of a row, in width steps of a warp: each
// warp with samples stores them (kStoreWork, about its loads and stores),
// and each warp with a sample before nvalid also sweeps the n widths. A
// row's tiles past nvalid hold no sweep, so equal strips of tiles would
// not be equal work: at the stream's window (a quarter of it past nvalid,
// ~4 tiles a block) the block whose strip missed that quarter set the
// launch's time.
constexpr int kStoreWork = 4;
constexpr int kWarpsPerTile = kTile / kWarpSamples;

PEASOUP_HD int64_t row_work(int64_t tpad, int64_t nvalid, int n, int64_t k) {
  const int64_t all = tpad / kWarpSamples;
  const int64_t warps = k * kWarpsPerTile < all ? k * kWarpsPerTile : all;
  const int64_t live = nvalid > 0 ? (nvalid + kWarpSamples - 1) / kWarpSamples : 0;
  return kStoreWork * warps + n * (live < warps ? live : warps);
}

// Block b of nblocks takes tiles [g0, g1) of rows x p.tpr: consecutive
// strips of near equal work (g0: the tile boundary nearest b / nblocks of
// the whole work, so a strip holds at most its share and one tile).
PEASOUP_HD int64_t strip_start(const Plan& p, int64_t rows, int64_t tpad, int64_t nvalid, int n,
                               int64_t nblocks, int64_t b) {
  const int64_t per_row = row_work(tpad, nvalid, n, p.tpr);
  const int64_t target = rows * per_row * b / nblocks;
  const int64_t row = target / per_row;
  const int64_t rest = target - row * per_row;
  int64_t lo = 0, hi = p.tpr;  // the first k with row_work(k) >= rest
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (row_work(tpad, nvalid, n, mid) >= rest) hi = mid;
    else lo = mid + 1;
  }
  if (lo > 0 && rest - row_work(tpad, nvalid, n, lo - 1) < row_work(tpad, nvalid, n, lo) - rest)
    --lo;  // the boundary before is the nearer
  return row * p.tpr + lo;
}

PEASOUP_HD void block_strip(const Plan& p, int64_t rows, int64_t tpad, int64_t nvalid, int n,
                            int64_t nblocks, int64_t b, int64_t& g0, int64_t& g1) {
  g0 = strip_start(p, rows, tpad, nvalid, n, nblocks, b);
  g1 = strip_start(p, rows, tpad, nvalid, n, nblocks, b + 1);
}

// The chunks tile k of a row reads: k .. k + tile_chunks - 1.
PEASOUP_HD int64_t tile_chunks(const Plan& p, int64_t k) {
  return p.nch - k < p.nwin ? p.nch - k : p.nwin;
}

// The prefix sums of a row's chunk c that its load brings in: those up to
// csum[nvalid], the last any boxcar reads, rounded up to a 16-byte copy,
// and none in a chunk wholly past it (the load then only completes its
// slot). No sweep reads the rest of a slot: a sample t < nvalid reads lo at
// t and hi at t + w <= nvalid, and any other is masked or not swept.
PEASOUP_HD int64_t chunk_floats(int64_t row_len, int64_t nvalid, int64_t c) {
  int64_t end = (nvalid + 4) & ~int64_t(3);  // nvalid + 1 rounded up to a multiple of 4
  if (end > row_len) end = row_len;
  const int64_t len = end - c * kChunk;
  return len < 0 ? 0 : (len < kChunk ? len : kChunk);
}

// The carried halo: of tile k's chunks, those the row's next tile reads
// again from the ring rather than from device memory (none after a row's
// last tile).
PEASOUP_HD int64_t carried_chunks(const Plan& p, int64_t k) {
  return k + 1 < p.tpr ? tile_chunks(p, k) - 1 : 0;
}

// The per-tile validity predicate: every boxcar of the tile (from t0, up
// to the widest, wmax) ends by nvalid, so its sweep tests no width.
PEASOUP_HD bool tile_fits(int64_t nvalid, int64_t t0, int wmax) {
  return nvalid - t0 - (kTile - 1) >= wmax;
}

// nvalid less sample t, clamped into int for the masked sweep's tests
// (w <= room - G kGroupStride - i with 0 <= i < 4, G < kGroups).
PEASOUP_HD int room_of(int64_t nvalid, int64_t t) {
  const int64_t r = nvalid - t;
  return static_cast<int>(r < -(1 << 20) ? -(1 << 20) : (r > (1 << 30) ? (1 << 30) : r));
}

// The tile offset of thread tid's group G: its four samples, stored as one
// float4 of best and one int4 of bw.
PEASOUP_HD int group_offset(int tid, int G) { return spmap::sample_of(tid, 4 * G); }

// Whether thread tid's warp has samples in a tile of tile_n samples (a
// multiple of kWarpSamples): a warp sweeps and stores all or none.
PEASOUP_HD bool warp_active(int tid, int tile_n) { return (tid >> 5) * kWarpSamples < tile_n; }

// Whether no boxcar starting at sample t or later fits (t >= nvalid):
// then every later sample's best is -inf and its width 0, with no sweep.
PEASOUP_HD bool none_fit(int64_t nvalid, int64_t t) { return t >= nvalid; }

// One width on one group's four samples: hi[i] = x[i + S], lo[i] its lo;
// snr = (hi - lo) * sc as the plain version rounds it, taken where it is
// strictly larger (v[i], wv[i] the group's running best and its width
// index k). MASKED: sample i counts the boxcar only where w <= room - i
// (room: nvalid less the group's first sample).
template <bool MASKED, int S, int N>
PEASOUP_HD void track4(const float (&x)[N], const float* lo, int w, float sc, int room, int k,
                       float* v, int* wv) {
  PEASOUP_UNROLL
  for (int i = 0; i < 4; ++i) {
    const float s = (x[i + S] - lo[i]) * sc;
    if ((!MASKED || w <= room - i) && s > v[i]) {
      v[i] = s;
      wv[i] = k;
    }
  }
}

// Width w (index k) on every group of a thread: group G at tile offset
// o + G kGroupStride. A multiple of 4 reads one aligned float4 of hi at
// o + w; any other width (1, 2, 3 included) the two float4s from
// o + (w & ~3) and takes hi by a register shift of w & 3. rd(x): the
// float4 of prefix sums at tile offset x (a multiple of 4).
template <bool MASKED, class Read4>
PEASOUP_HD void track_width(const Read4& rd, int o, const float (&lo)[kPer], int w, float sc,
                            int room, int k, float (&v)[kPer], int (&wv)[kPer]) {
  const int S = w & 3;
  const int b = o + (w & ~3);
  PEASOUP_UNROLL
  for (int G = 0; G < kGroups; ++G) {
    const int g = G * kGroupStride;
    const int r = room - g;
    if (S == 0) {
      float x[4];
      spmap::unpack(rd(b + g), x);
      track4<MASKED, 0>(x, lo + 4 * G, w, sc, r, k, v + 4 * G, wv + 4 * G);
    } else {
      float x[8];
      spmap::unpack(rd(b + g), x);
      spmap::unpack(rd(b + g + 4), x + 4);
      if (S == 1) track4<MASKED, 1>(x, lo + 4 * G, w, sc, r, k, v + 4 * G, wv + 4 * G);
      else if (S == 2) track4<MASKED, 2>(x, lo + 4 * G, w, sc, r, k, v + 4 * G, wv + 4 * G);
      else track4<MASKED, 3>(x, lo + 4 * G, w, sc, r, k, v + 4 * G, wv + 4 * G);
    }
  }
}

// One thread's sweep: v[j] and wv[j] the best S/N and its width index of
// its sample j (spmap::sample_of), bit for bit the plain version's: the
// widths in the bank's own order, a strict > from -inf (-inf and 0 where
// no boxcar fits). Only lo (one float4 a group) stays in registers across
// the widths; each width reads its hi from the ring. bank(k): width k;
// room = room_of(nvalid, t0 + o) where the tile does not fit.
template <bool MASKED, class Read4, class WidthAt>
PEASOUP_HD void sweep(const Read4& rd, int o, const WidthAt& bank, int n, int room,
                      float (&v)[kPer], int (&wv)[kPer]) {
  float lo[kPer];
  PEASOUP_UNROLL
  for (int G = 0; G < kGroups; ++G) spmap::unpack(rd(o + G * kGroupStride), lo + 4 * G);
  PEASOUP_UNROLL
  for (int j = 0; j < kPer; ++j) {
    v[j] = spmap::neg_inf();
    wv[j] = 0;
  }
  for (int k = 0; k < n; ++k) {
    const spmap::Width e = bank(k);
    track_width<MASKED>(rd, o, lo, e.w, e.sc, room, k, v, wv);
  }
}

}  // namespace bxmap
