"""The parts of the port's CUDA kernels that compile for the host, on the
CPU: csrc/levels.cuh (harmpeaks' level function and crossing mask),
csrc/cluster_step.cuh (the cluster walk's step, shared by harmpeaks and
peaks), csrc/dftmap.cuh (who holds what in dftspec's cluster),
csrc/interbin_map.cuh (interbin's mirror pairs), csrc/dedisp_map.cuh
(dedisperse's staged windows and packed sums), csrc/spchain_map.cuh
(spchain's ring of prefix-sum chunks, its sweep and its winner rule),
csrc/boxcar_map.cuh (boxcar's strips and stores on that ring) and
csrc/peaks_map.cuh (peaks' mask lanes).

A small C++ shim that includes those headers is compiled with g++ into a
shared library (``-ffp-contract=off``, so no add or multiply is fused, as
``-fmad=false`` keeps them apart on the card) and loaded with ctypes. It
holds:
- the level function bitwise against both packages' harmonic sums in the
  reference's take order, nharms 1..5;
- the walk's step, fed crossing lists, bitwise against both packages'
  cluster_peaks_device (the lastidx quirk, gaps at min_gap, cluster
  overflow);
- harmpeaks' two phases emulated on the host (mask words and the values
  of the first crossings of each level in each 128-bin span from the
  level function, then the walk over clipped words, taking those values
  or recomputing them where a span held more) bitwise against the port's
  plain version, with crossings on bits 0 and 31 of mask words, on window
  edges, in dense runs, at and past a span's slots and past max_peaks;
- dftspec's maps: every bin 0..m has exactly one writer, every T and Z
  value one home, the mirror and neighbour maps name bins m-k and k-1, and
  the four-step DFT routed through the maps (numpy for the sub-DFTs) gives
  the plain version's spectrum within the JAX package's accuracy gate;
- interbin's mirror-pair map (csrc/interbin_map.cuh): every bin 0..m has
  exactly one writer, every pad one zeroing thread, and each bin's untwist
  the plain version's Z values;
- dedisperse's windows (csrc/dedisp_map.cuh): the kernel's blocks
  emulated on the wrapper's tables (staging, reads, 16-bit lane sums and
  their flushes), every read inside the window its chunk staged and equal
  to x[t + delay, c], the sums the plain channel sums, each chunk staged
  by 16-byte loads exactly where its rows are 16-byte aligned, with one
  channel, past 256 channels of 255s, 4,096 channels, a spread past a
  16-channel window, htru_hilat's band (channels 154-1023 kept), a
  scattered kill mask, 1,000 channels and an unaligned view;
- spchain's blocks emulated through csrc/spchain_map.cuh (each block's
  loads into a poisoned ring as its loading warp issues them, every read
  checked to lie in its tile's chunks and to come from the load that
  holds it, the value sweep or, for dec < 8, the tracking sweep, and each
  dec block's maximum, first argmax and width at the winner) bitwise
  against the port's plain version and the JAX package's twin: dec 1 to
  1024, nvalid inside a tile and at 0, a bank that is not powers of two,
  ties between widths and samples, signed zeros (a zero maximum is +0
  where any sample's best is +0, as jnp.max gives it), runs that cross
  rows and rows longer than a run, and banks to 48,126 samples whose
  windows wrap round the ring's end; the ring's geometry (it holds a
  tile's window, wraps only where copies do not fit, and takes every
  bank the one-window design before it took);
- boxcar's blocks emulated through csrc/boxcar_map.cuh on spchain's
  ring (the strips, the carried halo, the per-tile validity predicate,
  the sweep and each group's aligned 16-byte store, every output written
  once) bitwise against the port's plain version and the JAX package's
  twin: a reduced stream window, nvalid inside a tile and at 0, widths
  that are not multiples of 4, ties, signed zeros, the widest bank that
  fits and tpad below a tile;
- peaks' two phases emulated (16-byte reads inside each level's window,
  nibbles into mask words clipped at the window's edges, then the shared
  walk with one load a crossing's value) bitwise against the port's plain
  version and the JAX package's Pallas kernel in interpret mode, with
  crossings on bits 0 and 31 of mask words, on window edges, in dense
  runs, past max_peaks and in empty windows.
Skips only where there is no g++.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.harmonics import harmonic_sums as jax_harmonic_sums
from peasoup_tpu.ops.pallas.dftspec import plane_factors as jax_plane_factors
from peasoup_tpu.ops.peaks import cluster_peaks_device as jax_cluster
from peasoup_tpu_torch.ops import dftspec, harmonics, peaks
from peasoup_tpu_torch.ops.fft import untwist_tables

CSRC = Path(__file__).resolve().parent.parent / "peasoup_tpu_torch" / "csrc"

SHIM = r"""
#include <cstddef>
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <vector>

#include "boxcar_map.cuh"
#include "cluster_step.cuh"
#include "dedisp_map.cuh"
#include "dftmap.cuh"
#include "interbin_map.cuh"
#include "levels.cuh"
#include "peaks_map.cuh"
#include "spchain_map.cuh"

struct F4 {
  float x, y, z, w;
};

// spchain.cu's blocks run on the host through spchain_map.cuh: each block's
// loads copied into a ring of poisoned slots (and, where the ring does not
// wrap, the first nwin - 1 again past the last) as its one producer
// thread issues them, a slot refilled
// only once the tiles reading it are done, each tile's chunks checked
// present before it is swept, every float4 a thread reads checked to lie
// in the tile's chunks and to come from the load that holds it, each
// thread's samples (sample_of) swept as the kernel sweeps them, and each
// dec block's maximum, first argmax, width and value taken by the
// kernel's rules. Returns 1 if a tile's chunk is not in its slot (or the
// slot walk disagrees with ring_pos), 2 if a read falls outside the tile's
// chunks, 3 if it finds another load's data, 4 if loads are left
// unconsumed, 5 if the bank fits no ring; stats gets the tiles swept
// unmasked and masked, and whether the ring wraps.
struct SpRing {
  const float* p;
  const int64_t* tag;
  int64_t n0;
  int s0, slots;
  bool wrap;
  int limit;
  int* err;
  F4 operator()(int at) const {
    if (at < 0 || at + 3 >= limit) *err = 2;
    const int pos = spmap::ring_at(s0, at, slots, wrap);
    if (tag[pos / spmap::kChunk] != n0 + at / spmap::kChunk) *err = 3;
    return F4{p[pos], p[pos + 1], p[pos + 2], p[pos + 3]};
  }
};

// one prefix sum at tile offset o, through the checked float4 reads
struct SpAt {
  const SpRing& r;
  float operator()(int o) const {
    const F4 q = r(o & ~3);
    return (&q.x)[o & 3];
  }
};

struct SpBank {
  const spmap::Width* b;
  spmap::Width operator()(int k) const { return b[k]; }
};

template <int NLEV>
static void levels_all(const float* s, int nbins, float* out) {
  for (int i = 0; i < nbins; ++i) {
    float v[NLEV];
    harm::levels<NLEV>(harm::RowPtr{s}, i, v);
    for (int h = 0; h < NLEV; ++h) out[int64_t{h} * nbins + i] = v[h];
  }
}

template <int NLEV>
static void harmpeaks_rows(const float* spec, int rows, int npad, int nbins,
                           const int* win, const float* sc, float thr, int min_gap,
                           int mx, int* idxs, float* snrs, int* counts, int* ccounts) {
  constexpr int T = harm::kTile, S = harm::kSpan, W = harm::kSpan / 32;
  const int ldm = 32 * ((npad + T - 1) / T);  // mask words a level
  const int ldv = ldm / W * harm::kSpanSlots;  // value slots a level
  int bin_lo = win[0], bin_hi = win[1];
  for (int h = 1; h < NLEV; ++h) {
    bin_lo = win[2 * h] < bin_lo ? win[2 * h] : bin_lo;
    bin_hi = win[2 * h + 1] > bin_hi ? win[2 * h + 1] : bin_hi;
  }
  std::vector<uint32_t> mask(std::size_t{NLEV} * ldm);
  std::vector<float> vals(std::size_t{NLEV} * ldv);
  for (int r = 0; r < rows; ++r) {
    const float* s = spec + int64_t{r} * npad;
    // phase A, span by span (a warp's) over whole tiles: every word it
    // writes (threshold bits, clipped to the level's window) and the values
    // of the first kSpanSlots crossings of each level in the span; the rest
    // stays garbage
    for (auto& w : mask) w = 0xdeadbeefu;
    for (auto& v : vals) v = 1e30f;
    for (int b0 = ((bin_lo > 0 ? bin_lo : 0) / T) * T; b0 < bin_hi; b0 += S) {
      uint32_t words[NLEV][W] = {};
      float v[W][32][NLEV];
      for (int u = 0; u < W; ++u) {
        for (int b = 0; b < 32; ++b) {
          const int i = b0 + 32 * u + b;
          if (i >= bin_hi) break;
          harm::levels<NLEV>(harm::RowPtr{s}, i, v[u][b]);
          for (int h = 0; h < NLEV; ++h) {
            if (v[u][b][h] * sc[h] > thr) words[h][u] |= 1u << b;
          }
        }
        const int w = b0 / 32 + u;
        for (int h = 0; h < NLEV; ++h) {
          words[h][u] = harm::clip_word(words[h][u], w, win[2 * h], win[2 * h + 1]);
          if (w * 32 < bin_hi) mask[std::size_t{h} * ldm + w] = words[h][u];
        }
      }
      for (int h = 0; h < NLEV; ++h) {
        for (int u = 0; u < W; ++u) {
          for (int b = 0; b < 32; ++b) {
            if (!((words[h][u] >> b) & 1u)) continue;
            const int rank = harm::span_rank(words[h], u, b);
            if (rank < harm::kSpanSlots) {
              vals[std::size_t{h} * ldv + b0 / S * harm::kSpanSlots + rank] = v[u][b][h] * sc[h];
            }
          }
        }
      }
    }
    // phase B: each level's spans over its window; a crossing's value from
    // A's slots, recomputed where its span held more than kSpanSlots
    for (int h = 0; h < NLEV; ++h) {
      const int64_t task = int64_t{r} * NLEV + h;
      int* oi = idxs + task * mx;
      float* os = snrs + task * mx;
      for (int e = 0; e < mx; ++e) {
        oi[e] = nbins;
        os[e] = 0.f;
      }
      const int lo = win[2 * h] > 0 ? win[2 * h] : 0, hi = win[2 * h + 1];
      cluster::State st;
      for (int q = lo / S; lo < hi && q < (hi + S - 1) / S; ++q) {
        uint32_t bits[W];
        int in_span = 0;
        for (int u = 0; u < W; ++u) {
          bits[u] = harm::clip_word(mask[std::size_t{h} * ldm + W * q + u], W * q + u, lo, hi);
          in_span += __builtin_popcount(bits[u]);
        }
        int own = 0;
        for (int u = 0; u < W; ++u) {
          while (bits[u]) {
            const int i = (W * q + u) * 32 + __builtin_ctz(bits[u]);
            bits[u] &= bits[u] - 1;
            float snr;
            if (in_span <= harm::kSpanSlots) {
              snr = vals[std::size_t{h} * ldv + q * harm::kSpanSlots + own];
            } else {
              float v[NLEV];
              harm::levels<NLEV>(harm::RowPtr{s}, i, v, h);
              snr = v[h] * sc[h];
            }
            ++own;
            cluster::step(st, i, snr, min_gap, [&](int slot, int ci, float cs) {
              if (slot < mx) {
                oi[slot] = ci;
                os[slot] = cs;
              }
            });
          }
        }
      }
      if (cluster::last_fits(st, mx)) {
        oi[st.cursor] = st.cpeakidx;
        os[st.cursor] = st.cpeak;
      }
      counts[task] = st.raw;
      ccounts[task] = cluster::clusters(st);
    }
  }
}

template <int NLEV>
static void peaks_rows(const float* const* lv, int rows, int npad, int nbins, const int* win,
                       const float* sc, float thr, int min_gap, int mx, int* idxs, float* snrs,
                       int* counts, int* ccounts) {
  constexpr int T = harm::kTile, S = harm::kSpan, W = harm::kSpan / 32;
  const int ldm = 32 * ((npad + T - 1) / T);
  int lo[NLEV], hi[NLEV];
  int bin_lo = 1 << 30, bin_hi = 0;
  for (int h = 0; h < NLEV; ++h) {
    lo[h] = win[2 * h] > 0 ? win[2 * h] : 0;
    hi[h] = win[2 * h + 1];
    bin_lo = lo[h] < bin_lo ? lo[h] : bin_lo;
    bin_hi = hi[h] > bin_hi ? hi[h] : bin_hi;
  }
  std::vector<uint32_t> mask(std::size_t{NLEV} * ldm);
  for (int r = 0; r < rows; ++r) {
    // phase A over whole tiles, warp by warp (a span each) and lane by lane
    for (auto& m : mask) m = 0xdeadbeefu;
    for (int t0 = bin_lo / T * T; t0 < bin_hi; t0 += T) {
      for (int q = t0 / S; q < (t0 + T) / S; ++q) {
        for (int h = 0; h < NLEV; ++h) {
          uint32_t words[W] = {};
          const float* row = lv[h] + int64_t{r} * npad;
          for (int lane = 0; lane < 32; ++lane) {
            const int b = pkmap::lane_bin(q, lane);
            const uint32_t nib = pkmap::lane_reads(b, lo[h], hi[h])
                ? pkmap::nibble(row[b], row[b + 1], row[b + 2], row[b + 3], sc[h], thr)
                : 0u;
            words[lane >> 3] |= pkmap::word_bits(nib, lane);
          }
          for (int lane = 0; lane < 32; lane += 8) {
            const int wi = pkmap::lane_word(q, lane);
            if (pkmap::word_meets(wi, lo[h], hi[h]))
              mask[std::size_t{h} * ldm + wi] = harm::clip_word(words[lane >> 3], wi, lo[h], hi[h]);
          }
        }
      }
    }
    // phase B: each level's spans over its window, a crossing's value one
    // load of its level
    for (int h = 0; h < NLEV; ++h) {
      const int64_t task = int64_t{r} * NLEV + h;
      int* oi = idxs + task * mx;
      float* os = snrs + task * mx;
      for (int e = 0; e < mx; ++e) {
        oi[e] = nbins;
        os[e] = 0.f;
      }
      cluster::State st;
      for (int q = lo[h] / S; lo[h] < hi[h] && q < (hi[h] + S - 1) / S; ++q) {
        for (int u = 0; u < W; ++u) {
          uint32_t bits = harm::clip_word(mask[std::size_t{h} * ldm + W * q + u], W * q + u,
                                          lo[h], hi[h]);
          while (bits) {
            const int i = (W * q + u) * 32 + __builtin_ctz(bits);
            bits &= bits - 1;
            const float snr = lv[h][int64_t{r} * npad + i] * sc[h];
            cluster::step(st, i, snr, min_gap, [&](int slot, int ci, float cs) {
              if (slot < mx) {
                oi[slot] = ci;
                os[slot] = cs;
              }
            });
          }
        }
      }
      if (cluster::last_fits(st, mx)) {
        oi[st.cursor] = st.cpeakidx;
        os[st.cursor] = st.cpeak;
      }
      counts[task] = st.raw;
      ccounts[task] = cluster::clusters(st);
    }
  }
}

extern "C" {

int peaks(const float* l0, const float* l1, const float* l2, const float* l3,
          const float* l4, const float* l5, int rows, int npad, int nbins, int nlev,
          const int* win, const float* sc, float thr, int min_gap, int mx, int* idxs,
          float* snrs, int* counts, int* ccounts) {
  const float* lv[6] = {l0, l1, l2, l3, l4, l5};
  switch (nlev) {
    case 1: peaks_rows<1>(lv, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 2: peaks_rows<2>(lv, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 3: peaks_rows<3>(lv, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 4: peaks_rows<4>(lv, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 5: peaks_rows<5>(lv, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 6: peaks_rows<6>(lv, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    default: return 1;
  }
  return 0;
}

// a bank's ring: reach, chunks a tile reads, slots, whether a window
// wraps, the ring's chunks; and the tile and chunk sizes
int spchain_geometry(const int* w, int n, int* out) {
  out[0] = spmap::reach(w, n);
  out[1] = spmap::window_chunks(out[0]);
  bool wrap;
  spmap::plan_ring(out[1], out[2], wrap);
  out[3] = wrap;
  out[4] = spmap::ring_chunks(out[2], out[1], wrap);
  out[5] = spmap::kTile;
  out[6] = spmap::kChunk;
  return 0;
}

int spchain_emulate(const float* csum, const int* w, const float* sc, int nw, long long rows,
                    long long row_len, long long tpad, long long nvalid, int dec,
                    long long nblocks, float* bmax, int* barg, int* bwidx, long long* stats) {
  using namespace spmap;
  Bank sorted;
  sort_bank(w, sc, nw, sorted);
  std::vector<Width> ord(nw);
  int wmax = 0;
  for (int k = 0; k < nw; ++k) {
    ord[k] = Width{w[k], sc[k]};
    wmax = w[k] > wmax ? w[k] : wmax;
  }
  const SpBank by_sorted{sorted.sorted}, by_ord{ord.data()};
  Plan plan;
  plan.tpr = (tpad + kTile - 1) / kTile;
  plan.nch = (row_len + kChunk - 1) / kChunk;
  plan.nwin = window_chunks(reach(w, nw));
  plan_ring(plan.nwin, plan.slots, plan.wrap);
  if (plan.slots == 0) return 5;
  const int lslots = __builtin_ctz(plan.slots);
  const int64_t tiles = rows * plan.tpr;
  const int64_t nbd = tpad / dec;
  const int nring = ring_chunks(plan.slots, plan.nwin, plan.wrap);
  std::vector<float> ring(std::size_t(nring) * kChunk);
  std::vector<int64_t> tag(nring);
  std::vector<float> v(kTile);
  std::vector<int> wv(kTile);
  stats[0] = stats[1] = 0;
  stats[2] = plan.wrap;
  for (int64_t blk = 0; blk < nblocks; ++blk) {
    int64_t g0, g1;
    block_tiles(tiles, nblocks, blk, g0, g1);
    if (g0 >= g1) continue;
    std::fill(ring.begin(), ring.end(), 1e30f);
    std::fill(tag.begin(), tag.end(), -1);
    const int64_t nloads = total_loads(plan, g0, g1);
    Loader ld;
    loader_start(plan, g0, g1, ld);
    const auto issue = [&](int64_t upto) {
      for (; ld.n < nloads && ld.n < upto; loader_next(plan, g0, g1, ld)) {
        const int64_t len = row_len - ld.c * kChunk < kChunk ? row_len - ld.c * kChunk : kChunk;
        int s;
        uint32_t ph;
        ring_pos(ld.n, plan.slots, lslots, plan.wrap, s, ph);
        const float* src = csum + ld.row * row_len + ld.c * kChunk;
        std::copy(src, src + len, ring.begin() + s * kChunk);
        tag[s] = ld.n;
        if (!plan.wrap && s < plan.nwin - 1) {
          std::copy(src, src + len, ring.begin() + (plan.slots + s) * kChunk);
          tag[plan.slots + s] = ld.n;
        }
      }
    };
    issue(plan.slots);
    Cursor cur;
    cursor_start(plan, g0, cur);
    int err = 0;
    while (cur.g < g1) {
      const int64_t t0 = cur.k * kTile;
      const int tile_n = int(tpad - t0 < kTile ? tpad - t0 : kTile);
      const int64_t have = plan.nch - cur.k < plan.nwin ? plan.nch - cur.k : plan.nwin;
      int s0;
      uint32_t ph0;
      ring_pos(cur.n0, plan.slots, lslots, plan.wrap, s0, ph0);
      {
        int s = s0;
        uint32_t ph = ph0;
        for (int64_t j = 0; j < have; ++j, ring_next(plan.slots, s, ph)) {
          int s_j;
          uint32_t ph_j;
          ring_pos(cur.n0 + j, plan.slots, lslots, plan.wrap, s_j, ph_j);
          if (s != s_j || ph != ph_j || tag[s] != cur.n0 + j) return 1;
        }
      }
      const SpRing rd{ring.data(), tag.data(), cur.n0, s0, plan.slots, plan.wrap,
                      int(have * kChunk), &err};
      const bool full = nvalid - t0 - (kTile - 1) >= wmax;
      ++stats[full ? 0 : 1];
      // every thread's samples, into v (and wv) at their tile offsets
      for (int tid = 0; tid < kThreads; ++tid) {
        float vt[kPer];
        int wt[kPer];
        const int o = sample_of(tid, 0);
        const int64_t r = nvalid - (t0 + o);
        const int room = int(r < -(1 << 20) ? -(1 << 20) : (r > (1 << 30) ? (1 << 30) : r));
        if ((tid >> 5) * kWarpSamples >= tile_n) {
          for (int j = 0; j < kPer; ++j) {
            vt[j] = neg_inf();
            wt[j] = 0;
          }
        } else if (dec < 8) {
          if (full) sweep_track<false>(rd, o, by_ord, nw, 0, vt, wt);
          else sweep_track<true>(rd, o, by_ord, nw, room, vt, wt);
        } else {
          if (full) sweep<false>(rd, o, by_sorted, sorted.nsmall, sorted.naligned, nw, 0, vt);
          else sweep<true>(rd, o, by_sorted, sorted.nsmall, sorted.naligned, nw, room, vt);
        }
        for (int j = 0; j < kPer; ++j) {
          v[sample_of(tid, j)] = vt[j];
          wv[sample_of(tid, j)] = wt[j];
        }
      }
      // each block: its first maximum, and its width and value there
      const SpAt one{rd};
      for (int b0 = 0; b0 < tile_n; b0 += dec) {
        int ts = b0;
        bool pz = false;
        for (int t = b0; t < b0 + dec; ++t) {
          if (v[t] > v[ts]) ts = t;
        }
        const float m = v[ts];
        const int64_t b = cur.row * nbd + (t0 + b0) / dec;
        for (int t = b0; m == 0.f && t < b0 + dec; ++t) {
          if (v[t] != 0.f) continue;
          int f;
          pz |= positive_zero(dec < 8 ? v[t] : best_at(one, t, 0.f, nvalid - (t0 + t), by_ord, nw, f));
        }
        int found = wv[ts];
        const float val = dec < 8 ? m : best_at(one, ts, m, nvalid - (t0 + ts), by_ord, nw, found);
        bmax[b] = block_value(m, val, pz);
        barg[b] = ts - b0;
        bwidx[b] = found;
      }
      if (err) return err;
      cursor_next(plan, g0, g1, cur);
      issue(cur.n0 + plan.slots);
    }
    if (ld.n != nloads) return 4;
  }
  return 0;
}

// boxcar.cu's blocks run on the host through boxcar_map.cuh, on the same
// poisoned ring and checked reads as spchain's: each block's strip of
// tiles (block_tiles), its loads in order, each tile's chunks checked present,
// the tile's validity predicate choosing the sweep, each warp's threads
// swept (sweep) where the warp is active, and each group's four samples
// stored as one aligned run at group_offset. Returns 1-5 as spchain_emulate
// does, 6 if an output sample is written other than once, 7 if a group's
// store is not 16-byte aligned; stats gets the tiles swept unmasked and
// masked, whether the ring wraps, the loads issued, the chunks the tiles
// read, the chunks carried from a tile to the next of its strip, the
// warps that skip their sweep (every sample at or past nvalid), the
// prefix sums loaded (chunk_floats a load; the rest of its slot
// poisoned), and the most work (row_work's units) a block's strip holds
// and the work of all strips. Returns 8 if the strips do not start at
// tile 0 and end at the last.
// bxmap::block_strip's strips of rows x ceil(tpad / kTile) tiles for
// nblocks blocks: g[b] block b's first tile, g[nblocks] the end.
void boxcar_strips(long long rows, long long tpad, long long nvalid, int n, long long nblocks,
                   long long* g) {
  spmap::Plan plan{};
  plan.tpr = (tpad + spmap::kTile - 1) / spmap::kTile;
  for (long long b = 0; b < nblocks; ++b) {
    int64_t g0, g1;
    bxmap::block_strip(plan, rows, tpad, nvalid, n, nblocks, b, g0, g1);
    g[b] = g0;
    g[b + 1] = g1;
  }
}

int boxcar_emulate(const float* csum, const int* w, const float* sc, int nw, long long rows,
                   long long row_len, long long tpad, long long nvalid, long long nblocks,
                   float* best, int* bw, long long* stats) {
  using namespace spmap;
  std::vector<Width> ord(nw);
  int wmax = 0;
  for (int k = 0; k < nw; ++k) {
    ord[k] = Width{w[k], sc[k]};
    wmax = w[k] > wmax ? w[k] : wmax;
  }
  const SpBank by_ord{ord.data()};
  Plan plan;
  if (!bxmap::make_plan(tpad, row_len, w, nw, plan)) return 5;
  const int lslots = __builtin_ctz(plan.slots);
  const int64_t tiles = rows * plan.tpr;
  const int nring = ring_chunks(plan.slots, plan.nwin, plan.wrap);
  std::vector<float> ring(std::size_t(nring) * kChunk);
  std::vector<int64_t> tag(nring);
  std::vector<int> writes(std::size_t(rows * tpad), 0);
  for (int i = 0; i < 10; ++i) stats[i] = 0;
  stats[2] = plan.wrap;
  for (int64_t blk = 0; blk < nblocks; ++blk) {
    int64_t g0, g1;
    bxmap::block_strip(plan, rows, tpad, nvalid, nw, nblocks, blk, g0, g1);
    if (blk == 0 && g0 != 0) return 8;
    if (blk == nblocks - 1 && g1 != tiles) return 8;
    const int64_t work = (g1 / plan.tpr - g0 / plan.tpr) * bxmap::row_work(tpad, nvalid, nw, plan.tpr) +
                         bxmap::row_work(tpad, nvalid, nw, g1 % plan.tpr) -
                         bxmap::row_work(tpad, nvalid, nw, g0 % plan.tpr);
    stats[8] = work > stats[8] ? work : stats[8];
    stats[9] += work;
    if (g0 >= g1) continue;
    std::fill(ring.begin(), ring.end(), 1e30f);
    std::fill(tag.begin(), tag.end(), -1);
    const int64_t nloads = total_loads(plan, g0, g1);
    stats[3] += nloads;
    Loader ld;
    loader_start(plan, g0, g1, ld);
    const auto issue = [&](int64_t upto) {
      for (; ld.n < nloads && ld.n < upto; loader_next(plan, g0, g1, ld)) {
        const int64_t len = bxmap::chunk_floats(row_len, nvalid, ld.c);
        stats[7] += len;
        int s;
        uint32_t ph;
        ring_pos(ld.n, plan.slots, lslots, plan.wrap, s, ph);
        const float* src = csum + ld.row * row_len + ld.c * kChunk;
        const auto fill = [&](int slot) {
          std::copy(src, src + len, ring.begin() + slot * kChunk);
          std::fill(ring.begin() + slot * kChunk + len, ring.begin() + (slot + 1) * kChunk, 1e30f);
          tag[slot] = ld.n;
        };
        fill(s);
        if (!plan.wrap && s < plan.nwin - 1) fill(plan.slots + s);
      }
    };
    issue(plan.slots);
    Cursor cur;
    cursor_start(plan, g0, cur);
    int err = 0;
    while (cur.g < g1) {
      const int64_t t0 = cur.k * kTile;
      const int tile_n = int(tpad - t0 < kTile ? tpad - t0 : kTile);
      const int64_t have = bxmap::tile_chunks(plan, cur.k);
      stats[4] += have;
      if (cur.g + 1 < g1) stats[5] += bxmap::carried_chunks(plan, cur.k);
      int s0;
      uint32_t ph0;
      ring_pos(cur.n0, plan.slots, lslots, plan.wrap, s0, ph0);
      for (int64_t j = 0; j < have; ++j) {
        if (tag[ring_at(s0, int(j * kChunk), plan.slots, plan.wrap) / kChunk] != cur.n0 + j) return 1;
      }
      const SpRing rd{ring.data(), tag.data(), cur.n0, s0, plan.slots, plan.wrap,
                      int(have * kChunk), &err};
      const bool fits = bxmap::tile_fits(nvalid, t0, wmax);
      ++stats[fits ? 0 : 1];
      for (int tid = 0; tid < kThreads; ++tid) {
        if (!bxmap::warp_active(tid, tile_n)) continue;
        float v[kPer];
        int wv[kPer];
        const int o = sample_of(tid, 0);
        if (bxmap::none_fit(nvalid, t0 + (tid >> 5) * kWarpSamples)) {
          stats[6] += (tid & 31) == 0;
          for (int j = 0; j < kPer; ++j) {
            v[j] = neg_inf();
            wv[j] = 0;
          }
        } else if (fits) {
          bxmap::sweep<false>(rd, o, by_ord, nw, 0, v, wv);
        } else {
          bxmap::sweep<true>(rd, o, by_ord, nw, bxmap::room_of(nvalid, t0 + o), v, wv);
        }
        for (int G = 0; G < kGroups; ++G) {
          const int at = bxmap::group_offset(tid, G);
          const int64_t q = cur.row * tpad + t0 + at;
          if (q % 4 != 0 || at + 4 > tile_n) return 7;
          for (int i = 0; i < 4; ++i) {
            best[q + i] = v[4 * G + i];
            bw[q + i] = wv[4 * G + i];
            ++writes[q + i];
          }
        }
      }
      if (err) return err;
      cursor_next(plan, g0, g1, cur);
      issue(cur.n0 + plan.slots);
    }
    if (ld.n != nloads) return 4;
  }
  for (const int n : writes) {
    if (n != 1) return 6;
  }
  return 0;
}

int levels(const float* s, int nbins, int nharms, float* out) {
  switch (nharms + 1) {
    case 2: levels_all<2>(s, nbins, out); break;
    case 3: levels_all<3>(s, nbins, out); break;
    case 4: levels_all<4>(s, nbins, out); break;
    case 5: levels_all<5>(s, nbins, out); break;
    case 6: levels_all<6>(s, nbins, out); break;
    default: return 1;
  }
  return 0;
}

int walk(const int* idx, const float* snr, int n, int min_gap, int mx, int* oi,
         float* os, int* raw) {
  cluster::State st;
  for (int e = 0; e < n; ++e) {
    cluster::step(st, idx[e], snr[e], min_gap, [&](int slot, int ci, float cs) {
      if (slot < mx) {
        oi[slot] = ci;
        os[slot] = cs;
      }
    });
  }
  if (cluster::last_fits(st, mx)) {
    oi[st.cursor] = st.cpeakidx;
    os[st.cursor] = st.cpeak;
  }
  *raw = st.raw;
  return cluster::clusters(st);
}

int harmpeaks(const float* spec, int rows, int npad, int nbins, int nharms,
              const int* win, const float* sc, float thr, int min_gap, int mx,
              int* idxs, float* snrs, int* counts, int* ccounts) {
  switch (nharms + 1) {
    case 2: harmpeaks_rows<2>(spec, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 3: harmpeaks_rows<3>(spec, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 4: harmpeaks_rows<4>(spec, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 5: harmpeaks_rows<5>(spec, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    case 6: harmpeaks_rows<6>(spec, rows, npad, nbins, win, sc, thr, min_gap, mx, idxs, snrs, counts, ccounts); break;
    default: return 1;
  }
  return 0;
}

// n1 n2 g e c h ldb threads smem_bytes nyquist_rank; returns supported()
int dft_plan(int log_m, long long* out) {
  const dftmap::Plan p = dftmap::plan(log_m);
  const long long v[10] = {p.n1, p.n2, p.g, p.e, p.c, p.h, p.ldb,
                           dftmap::threads(p), dftmap::smem_bytes(p),
                           dftmap::nyquist_rank(p)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return dftmap::supported(log_m);
}

// per (rank, e): the epilogue's (k1, k2), and the exchange's T[k1, j2],
// its home (rank, slot) and the slot of B it lands in
void dft_elems(int log_m, int* ok1, int* ok2, int* gk1, int* gj2, int* gdst,
               int* grank, int* goff) {
  const dftmap::Plan p = dftmap::plan(log_m);
  for (int r = 0; r < p.g; ++r) {
    for (int e = 0; e < p.e; ++e) {
      const int64_t at = int64_t{r} * p.e + e;
      dftmap::out_elem(p, r, e, ok1[at], ok2[at]);
      dftmap::gather(p, r, e, gk1[at], gj2[at], gdst[at]);
      dftmap::t_home(p, gk1[at], gj2[at], grank[at], goff[at]);
    }
  }
}

// per (k1, k2): Z's home, the mirror and the neighbour below
void dft_bins(int log_m, const int* k1, const int* k2, int n, int* zrank, int* zoff,
              int* k1m, int* k2m, int* k1p, int* k2p) {
  const dftmap::Plan p = dftmap::plan(log_m);
  for (int i = 0; i < n; ++i) {
    dftmap::z_home(p, k1[i], k2[i], zrank[i], zoff[i]);
    dftmap::mirror(p, k1[i], k2[i], k1m[i], k2m[i]);
    dftmap::prev(p, k1[i], k2[i], k1p[i], k2p[i]);
  }
}

// interbin's map over one row: the writes each bin gets from pair threads
// and from pad threads, the threads the launch's blocks hold, and the Z
// values each bin's untwist reads
int interbin_map(int m, int npad, int* pair_writes, int* pad_writes, int* zk, int* zm,
                 int* threads) {
  for (int j = 0; j < ibmap::pair_threads(m); ++j) {
    int b[5];
    ibmap::pair_bins(m, j, b);
    for (int i = 0; i < 5; ++i) {
      if (b[i] < 0) continue;
      if (b[i] >= npad) return 1;
      ++pair_writes[b[i]];
    }
  }
  for (int p = 0; p < ibmap::pad_threads(m, npad); ++p) {
    const int b0 = ibmap::pad_first(m, p);
    for (int b = b0; b < b0 + 4 && b < npad; ++b) ++pad_writes[b];
  }
  for (int k = 0; k <= m; ++k) ibmap::untwist_sources(m, k, zk[k], zm[k]);
  threads[0] = ibmap::pair_blocks(m) * ibmap::kThreads - ibmap::pair_threads(m);
  threads[1] = ibmap::pad_blocks(m, npad) * ibmap::kThreads - ibmap::pad_threads(m, npad);
  return 0;
}

// dedisperse.cu's blocks run on the host through dedisp_map.cuh: each
// chunk's window staged as the kernel's threads stage it (16 bytes a row
// where wide_staging holds for x, else a byte a kept channel), each
// thread's reads of the chunk's kept channels taken through read_word /
// read_shift / funnel and added in 16-bit lanes, flushed every
// kLaneChannels as the kernel flushes them, then the output tile packed
// and copied out as the kernel does. Writes the channel sums (ndm, out_n),
// the u8 output and the number of chunks staged by 16-byte loads; returns
// 1 if a staged row falls outside the window's pitch, 2 if a read word
// does, 3 if a byte a sum takes was not staged by this chunk, 4 if it is
// not x[t + delay, c], 5 if a word store is unaligned, 6 if a chunk's mask
// names a channel past the row.
int dedisp_emulate(const uint8_t* x, long long t_in, int nchans, const int* chunks,
                   int nkept, const uint16_t* rel, const int* lo_spread, int log_chunk,
                   int nchunks, int pitch, int ndm, long long out_n, uint32_t* sums,
                   long long* dense_out, float scale, int apply_scale, uint8_t* out) {
  using namespace ddmap;
  long long dense = 0;
  const int chunk = 1 << log_chunk;
  const int ntiles = (ndm + kTrials - 1) / kTrials;
  const long long ntime = (out_n + kTile - 1) / kTile;
  const bool wide = nkept > kLaneChannels;
  const bool wide_rows = wide_staging(log_chunk, nchans, reinterpret_cast<uintptr_t>(x));
  std::vector<uint32_t> win(std::size_t(chunk) * pitch);
  std::vector<int> stamp(std::size_t(chunk) * pitch * 4);
  std::vector<uint32_t> lanes(std::size_t(kThreads) * kTrials * kGroups * 2);
  std::vector<uint32_t> total(std::size_t(kThreads) * kTrials * kGroups * 4);
  int stage_no = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    for (long long tt = 0; tt < ntime; ++tt) {
      const long long t0 = tt * kTile;
      std::fill(lanes.begin(), lanes.end(), 0u);
      std::fill(total.begin(), total.end(), 0u);
      int in_lanes = 0;
      for (int ck = 0; ck < nchunks; ++ck) {
        ++stage_no;
        const int first = chunks[2 * ck];
        const uint32_t kept = static_cast<uint32_t>(chunks[2 * ck + 1]);
        for (int cl = 0; cl < chunk; ++cl) {
          if (((kept >> cl) & 1u) && first + cl >= nchans) return 6;
        }
        const int lo = lo_spread[2 * (tile * nchunks + ck)];
        const int rows = window_rows(lo_spread[2 * (tile * nchunks + ck) + 1]);
        uint8_t* winb = reinterpret_cast<uint8_t*>(win.data());
        if (wide_rows) {
          ++dense;
          for (int q = 0; 4 * q < rows; ++q) {
            if (q >= pitch) return 1;
            uint32_t a[4][4];
            for (int u = 0; u < 4; ++u) {
              const long long row = t0 + lo + 4 * q + u;
              for (int g = 0; g < 4; ++g) {
                a[u][g] = 0u;
                if (row < t_in) std::memcpy(&a[u][g], x + row * nchans + first + 4 * g, 4);
              }
            }
            for (int g = 0; g < 4; ++g) {
              uint32_t cw[4];
              transpose4(a[0][g], a[1][g], a[2][g], a[3][g], cw);
              for (int i = 0; i < 4; ++i) {
                const std::size_t at = std::size_t(4 * g + i) * pitch + q;
                win[at] = cw[i];
                for (int b = 0; b < 4; ++b) stamp[at * 4 + b] = stage_no;
              }
            }
          }
        } else {
          for (int tid = 0; tid < kThreads; ++tid) {
            int cl, r;
            stage_coords(tid, log_chunk, cl, r);
            if (!((kept >> cl) & 1u)) continue;
            for (; r < rows; r += kThreads >> log_chunk) {
              if (r >= pitch * 4) return 1;
              const bool ok = t0 + lo + r < t_in;
              const long long at = (long long)cl * pitch * 4 + r;
              winb[at] = ok ? x[(t0 + lo + r) * nchans + first + cl] : 0;
              stamp[at] = stage_no;
            }
          }
        }
        for (uint32_t m = kept; m != 0u; m &= m - 1u) {
          const int c = low_bit(m);
          const uint16_t* rec16 = rel + (std::size_t(tile) * nchunks + ck) * chunk * kTrials
                                  + std::size_t(c) * kTrials;
          uint32_t rec[kTrials / 2];
          for (int q = 0; q < kTrials / 2; ++q) {
            rec[q] = rec16[2 * q] | (uint32_t(rec16[2 * q + 1]) << 16);
          }
          const uint32_t* row = win.data() + std::size_t(c) * pitch;
          for (int tid = 0; tid < kThreads; ++tid) {
            for (int i = 0; i < kTrials; ++i) {
              const int rl = rel_of(rec, i);
              const int shift = read_shift(rl);
              for (int g = 0; g < kGroups; ++g) {
                const int w = read_word(tid, g, rl);
                if (w + 1 >= pitch) return 2;
                const uint32_t b = funnel(row[w], row[w + 1], shift);
                const int d = tile * kTrials + i;
                for (int q = 0; q < 4; ++q) {
                  const long long t = t0 + group_sample(tid, g) + q;
                  const int at = c * pitch * 4 + group_sample(tid, g) + rl + q;
                  if (stamp[at] != stage_no) return 3;
                  if (d < ndm && t < out_n &&
                      ((b >> (8 * q)) & 0xFFu) != x[(t + lo + rl) * nchans + first + c])
                    return 4;
                }
                uint32_t* ln = &lanes[((std::size_t(tid) * kTrials + i) * kGroups + g) * 2];
                ln[0] += even_lanes(b);
                ln[1] += odd_lanes(b);
              }
            }
          }
        }
        in_lanes += popcount32(kept);
        if (wide && (in_lanes + chunk > kLaneChannels || ck + 1 == nchunks)) {
          for (std::size_t e = 0; e < std::size_t(kThreads) * kTrials * kGroups; ++e) {
            total[4 * e + 0] += lanes[2 * e] & 0xFFFFu;
            total[4 * e + 1] += lanes[2 * e + 1] & 0xFFFFu;
            total[4 * e + 2] += lanes[2 * e] >> 16;
            total[4 * e + 3] += lanes[2 * e + 1] >> 16;
            lanes[2 * e] = lanes[2 * e + 1] = 0u;
          }
          in_lanes = 0;
        }
      }
      std::vector<uint32_t> otile(std::size_t(kTrials) * kTileWords + 1, 0xdeadbeefu);
      for (int tid = 0; tid < kThreads; ++tid) {
        for (int i = 0; i < kTrials; ++i) {
          const int d = tile * kTrials + i;
          for (int g = 0; g < kGroups; ++g) {
            const std::size_t e = (std::size_t(tid) * kTrials + i) * kGroups + g;
            uint32_t v[4];
            if (wide) {
              for (int q = 0; q < 4; ++q) v[q] = total[4 * e + q];
            } else {
              v[0] = lanes[2 * e] & 0xFFFFu;
              v[1] = lanes[2 * e + 1] & 0xFFFFu;
              v[2] = lanes[2 * e] >> 16;
              v[3] = lanes[2 * e + 1] >> 16;
            }
            uint32_t packed = 0u;
            for (int q = 0; q < 4; ++q) {
              const long long t = t0 + group_sample(tid, g) + q;
              if (d < ndm && t < out_n) sums[d * out_n + t] = v[q];
              packed |= uint32_t(quantise(v[q], scale, apply_scale)) << (8 * q);
            }
            otile[std::size_t(i) * kTileWords + out_word(tid, g)] = packed;
          }
        }
      }
      // the copy-out: head and tail bytes, aligned words between
      const uint8_t* ob = reinterpret_cast<const uint8_t*>(otile.data());
      const int n = int(kTile < out_n - t0 ? kTile : out_n - t0);
      for (int i = 0; i < kTrials && tile * kTrials + i < ndm; ++i) {
        const long long g_addr = (long long)(tile * kTrials + i) * out_n + t0;
        const int head = head_bytes(g_addr) < n ? head_bytes(g_addr) : n;
        const int nwords = (n - head) / 4;
        const int tail = head + 4 * nwords;
        for (int tid = 0; tid < kThreads; ++tid) {
          if (tid < head) out[g_addr + tid] = ob[i * kTile + tid];
          if (tail + tid < n) out[g_addr + tail + tid] = ob[i * kTile + tail + tid];
          for (int j = tid; j < nwords; j += kThreads) {
            const int o = head + 4 * j;
            if ((g_addr + o) % 4 != 0) return 5;
            const uint32_t w = funnel(otile[i * kTileWords + (o >> 2)],
                                      otile[i * kTileWords + (o >> 2) + 1], 8 * (head & 3));
            std::memcpy(out + g_addr + o, &w, 4);
          }
        }
      }
    }
  }
  *dense_out = dense;
  return 0;
}

}  // extern "C"
"""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    "levels": [_P, _I, _I, _P],
    "walk": [_P, _P, _I, _I, _I, _P, _P, _P],
    "harmpeaks": [_P, _I, _I, _I, _I, _P, _P, _F, _I, _I, _P, _P, _P, _P],
    "dft_plan": [_I, _P],
    "dft_elems": [_I] + [_P] * 7,
    "dft_bins": [_I, _P, _P, _I] + [_P] * 6,
    "interbin_map": [_I, _I] + [_P] * 5,
    "peaks": [_P] * 6 + [_I, _I, _I, _I, _P, _P, _F, _I, _I, _P, _P, _P, _P],
    "spchain_geometry": [_P, _I, _P],
    "boxcar_strips": [ctypes.c_longlong] * 3 + [_I, ctypes.c_longlong, _P],
    "boxcar_emulate": [_P, _P, _P, _I, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       _P, _P, _P],
    "spchain_emulate": [_P, _P, _P, _I, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_longlong, _I, ctypes.c_longlong,
                        _P, _P, _P, _P],
    "dedisp_emulate": [_P, ctypes.c_longlong, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                       ctypes.c_longlong, _P, _P, _F, _I, _P],
}


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host shim")
    d = tmp_path_factory.mktemp("kernel_host")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    lib_path = d / "libshim.so"
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", str(CSRC), "-o", str(lib_path), str(src)],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _spectrum(seed, rows, nbins, npad):
    """|noise| with tones every 61 bins on every third row, a comb of
    close crossings on row 1, and garbage (1e9) in the pad past nbins."""
    rng = np.random.default_rng(seed)
    s = np.abs(rng.normal(size=(rows, nbins))).astype(np.float32)
    s[::3, ::61] += 30.0
    s[min(1, rows - 1), nbins // 2 : nbins // 2 + 400 : 4] += 20.0
    return np.pad(s, ((0, 0), (0, npad - nbins)), constant_values=1e9)


@pytest.mark.parametrize("nharms", [1, 2, 3, 4, 5])
def test_level_function_matches_harmonic_sums(shim, nharms):
    nbins = 5003
    s = _spectrum(nharms, 1, nbins, nbins)[0]
    nlev = nharms + 1
    got = np.empty((nlev, nbins), np.float32)
    assert shim.levels(_ptr(s), nbins, nharms, _ptr(got)) == 0
    port = harmonics.harmonic_sums(torch.from_numpy(s), nharms=nharms, scaled=False)
    jaxs = jax_harmonic_sums(jnp.asarray(s), nharms=nharms, method="take", scaled=False)
    np.testing.assert_array_equal(got[0], s)
    for h in range(1, nlev):
        np.testing.assert_array_equal(got[h], port[h - 1].numpy())
        np.testing.assert_array_equal(got[h], np.asarray(jaxs[h - 1]))


def _walk_cases():
    rng = np.random.default_rng(21)
    # a falling ramp of crossings 20 apart: lastidx stays at each
    # cluster's first crossing (no higher one comes), so a cluster closes
    # 40 bins after it opens
    ramp = (np.arange(0, 200, 20), np.linspace(12.0, 9.5, 10))
    # gaps of exactly min_gap and min_gap - 1, falling and rising values
    gaps = (np.cumsum([5, 30, 29, 30, 1, 29, 30, 30, 31]), [12, 11, 13, 10, 14, 9, 15, 15, 15])
    # many clusters, for the max_peaks overflow
    many = (np.arange(0, 4000, 37), rng.uniform(9, 40, 109))
    # random crossings with runs of neighbours
    idx = np.unique(np.concatenate([rng.integers(0, 20000, 150),
                                    np.arange(5000, 5080, 2)]))
    rand = (idx, rng.uniform(9, 50, idx.size))
    return {"lastidx_quirk": (ramp, 64), "min_gap_edges": (gaps, 64),
            "overflow": (many, 8), "random": (rand, 256)}


@pytest.mark.parametrize("case", ["lastidx_quirk", "min_gap_edges", "overflow", "random"])
def test_walk_step_matches_cluster_peaks_device(shim, case):
    (idx, snr), mx = _walk_cases()[case]
    idx = np.ascontiguousarray(idx, np.int32)
    snr = np.ascontiguousarray(snr, np.float32)
    n, nbins, min_gap = idx.size, 30000, 30
    oi = np.full(mx, -1, np.int32)
    os = np.full(mx, -1.0, np.float32)
    raw = np.zeros(1, np.int32)
    ncl = shim.walk(_ptr(idx), _ptr(snr), n, min_gap, mx, _ptr(oi), _ptr(os), _ptr(raw))
    assert raw[0] == n
    # the port's walk over the same crossings
    ci, cs, cc = peaks.cluster_peaks_device(
        torch.from_numpy(idx.astype(np.int64))[None], torch.from_numpy(snr)[None],
        torch.tensor([n]), nbins=nbins, min_gap=min_gap,
    )
    assert ncl == int(cc[0])
    k = min(ncl, mx)
    np.testing.assert_array_equal(oi[:k], ci[0, :k].numpy())
    np.testing.assert_array_equal(os[:k], cs[0, :k].numpy())
    # the JAX package's
    ji, js, jc = (np.asarray(a) for a in jax_cluster(
        jnp.asarray(idx)[None], jnp.asarray(snr)[None], jnp.int32(nbins), min_gap=min_gap))
    assert ncl == int(jc[0])
    np.testing.assert_array_equal(oi[:k], ji[0, :k])
    np.testing.assert_array_equal(os[:k], js[0, :k])
    if case == "overflow":
        assert ncl > mx
    if case == "lastidx_quirk":
        # the quirk splits the ramp in five: a walk that moved lastidx on
        # every crossing would keep it as one cluster
        assert ncl == 5


def _harmpeaks_case(case):
    """(spectrum (rows, npad), nbins, windows (nlev, 2), nharms, mx)."""
    nbins, npad = 9000, 12288
    if case == "word_bits":
        # tones on bits 0 and 31 of mask words, windows starting and ending
        # at word edges and one bin inside them
        sp = _spectrum(3, 4, nbins, npad)
        sp[:, :nbins] *= 0.1
        for b in (1024, 1055, 2048, 2079, 4095, 4096, 6143, 6144):
            sp[:, b] = 40.0
        w = np.asarray([[1024, 6144], [1025, 6145], [1055, 4096], [1056, 4095],
                        [0, nbins + 700]], np.int32)
        return sp, nbins, w, 4, 32
    if case == "dense_runs":
        # a run of crossings across many words and past phase A's tiles
        sp = _spectrum(5, 3, nbins, npad)
        sp[1, 1000:3100] += 15.0
        sp[2, 4000:4300:3] += 25.0
        w = np.tile(np.asarray([[900, 8000]], np.int32), (5, 1))
        w[2] = [1001, 3099]
        return sp, nbins, w, 4, 64
    if case == "span_slots":
        # level 0 crossing exactly kSpanSlots (8) times in one span of 128
        # bins (values handed over) and 9 times in the next (recomputed)
        sp = _spectrum(11, 2, nbins, npad)
        sp[:, :nbins] *= 0.1
        sp[:, 2048 + 16 * np.arange(8)] = 20.0
        sp[:, 2176 + 14 * np.arange(9)] = 20.0
        w = np.asarray([[0, nbins], [2048, 4096], [100, 8000]], np.int32)
        return sp, nbins, w, 2, 128
    if case == "nharms5_overflow":
        sp = _spectrum(7, 5, nbins, npad)
        w = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (6, 1))
        w[0] = [37, 8191]
        return sp, nbins, w, 5, 4
    # "empty_levels": a window that holds no bin, one past nbins
    sp = _spectrum(9, 2, nbins, npad)
    w = np.asarray([[500, 500], [8000, 7000], [300, 8999]], np.int32)
    return sp, nbins, w, 2, 16


@pytest.mark.parametrize("case", ["word_bits", "dense_runs", "span_slots",
                                  "nharms5_overflow", "empty_levels"])
def test_harmpeaks_phases_match_plain(shim, case):
    sp, nbins, windows, nharms, mx = _harmpeaks_case(case)
    sp = np.ascontiguousarray(sp, np.float32)
    rows, npad = sp.shape
    nlev = nharms + 1
    scales = harmonics.level_scales(nharms)
    want = peaks.find_harmonic_cluster_peaks_plain(
        torch.from_numpy(sp), windows, nharms=nharms, threshold=9.0,
        max_peaks=mx, scales=scales, nbins=nbins,
    )
    w = np.ascontiguousarray(peaks._clamped_windows(windows, nbins, nlev))
    sc = np.asarray(scales, np.float32)
    got = [np.empty((rows, nlev, mx), np.int32), np.empty((rows, nlev, mx), np.float32),
           np.empty((rows, nlev), np.int32), np.empty((rows, nlev), np.int32)]
    assert shim.harmpeaks(
        _ptr(sp), rows, npad, nbins, nharms, _ptr(w), _ptr(sc),
        float(np.float32(9.0)), 30, mx, *(_ptr(g) for g in got)) == 0
    for g, t, name in zip(got, want, ("idxs", "snrs", "counts", "ccounts")):
        np.testing.assert_array_equal(g, t.numpy(), err_msg=name)
    assert got[3].max() > 0
    if case == "nharms5_overflow":
        assert got[3].max() > mx
    if case == "span_slots":
        assert (got[2][:, 0] == 17).all()
    if case == "word_bits":
        # level 0's window [1024, 6144): 4095 and 4096 are one cluster, 6144
        # lies outside
        assert {1024, 1055, 2048, 2079, 4095, 6143} == set(got[0][:, 0].ravel().tolist()) - {nbins}


def _plan(shim, log_m):
    out = np.zeros(10, np.int64)
    assert shim.dft_plan(log_m, _ptr(out)) == 1
    keys = ("n1", "n2", "g", "e", "c", "h", "ldb", "threads", "smem", "nyquist_rank")
    return dict(zip(keys, (int(v) for v in out)))


def _maps(shim, log_m):
    p = _plan(shim, log_m)
    total = p["g"] * p["e"]
    elems = [np.empty(total, np.int32) for _ in range(7)]
    shim.dft_elems(log_m, *(_ptr(a) for a in elems))
    m = 1 << log_m
    k = np.arange(m, dtype=np.int32)
    k1 = np.ascontiguousarray(k % p["n1"])
    k2 = np.ascontiguousarray(k // p["n1"])
    bins = [np.empty(m, np.int32) for _ in range(6)]
    shim.dft_bins(log_m, _ptr(k1), _ptr(k2), m, *(_ptr(a) for a in bins))
    return p, elems, bins


@pytest.mark.parametrize("log_m", [14, 15, 16, 17])
def test_dft_maps_one_writer_one_owner(shim, log_m):
    m = 1 << log_m
    p, elems, (zr, zo, k1m, k2m, k1p, k2p) = _maps(shim, log_m)
    ok1, ok2, gk1, gj2, gdst, grank, goff = elems
    n1, n2, g, e, c, h, ldb = (p[x] for x in ("n1", "n2", "g", "e", "c", "h", "ldb"))
    assert (n1, n2) == dftspec.plane_factors(m) == jax_plane_factors(m)
    assert g <= 16 and n1 % g == 0 and n2 % g == 0 and g * e == m and h >= 2
    assert p["threads"] % 32 == 0 and n2 <= p["threads"] <= 1024
    assert p["smem"] <= 227 * 1024
    rank = np.repeat(np.arange(g), e)
    slot = np.tile(np.arange(e), g)
    # every bin 0..m has exactly one writer: the epilogue's elements, and
    # the Nyquist bin on one CTA
    out_bins = ok1.astype(np.int64) + n1 * ok2
    written = np.bincount(np.append(out_bins, m), minlength=m + 1)
    assert written.shape == (m + 1,) and (written == 1).all()
    # the writer holds its bin's Z, at the B slot where pass 2 leaves it
    # (row k2, column k1 - rank h); the Nyquist writer holds X[m-1]
    order = np.argsort(out_bins)
    np.testing.assert_array_equal(zr, rank[order])
    np.testing.assert_array_equal(zo, (ok2 * ldb + slot % h)[order])
    assert out_bins[p["nyquist_rank"] * e + e - 1] == m - 1
    # the mirror and neighbour maps; the bin below each element but the
    # first of a k2 row (the halo) is the element before it
    kk = np.arange(m)
    np.testing.assert_array_equal(k1m + n1 * k2m.astype(np.int64), (m - kk) % m)
    np.testing.assert_array_equal((k1p + n1 * k2p.astype(np.int64))[1:], kk[1:] - 1)
    inner = slot % h > 0
    np.testing.assert_array_equal(out_bins[np.flatnonzero(inner) - 1], out_bins[inner] - 1)
    # the exchange: every T[k1, j2] read exactly once, from the CTA whose
    # pass-1 columns hold j2, into a distinct B slot of the CTA owning k1
    t_index = gk1.astype(np.int64) * n2 + gj2
    assert (np.bincount(t_index, minlength=m) == 1).all()
    np.testing.assert_array_equal(grank, gj2 // c)
    np.testing.assert_array_equal(goff, gk1 * c + gj2 % c)
    np.testing.assert_array_equal(gk1 // h, rank)
    np.testing.assert_array_equal(gdst, gj2 * ldb + (gk1 - rank * h))
    for r in range(g):
        sl = slice(r * e, (r + 1) * e)
        assert np.unique(gdst[sl]).size == e and gdst[sl].max() < n2 * ldb


@pytest.mark.parametrize("log_m", [14, 15, 16, 17])
def test_dft_maps_route_the_spectrum(shim, log_m):
    """The four-step DFT through the maps, rank by rank (numpy FFTs for the
    sub-DFTs, f64), gives the plain version's spectrum within the JAX
    package's accuracy gate, pad bins zero."""
    m = 1 << log_m
    p, elems, (zr, zo, k1m, k2m, k1p, k2p) = _maps(shim, log_m)
    gk1, gj2, gdst, grank, goff = elems[2:7]
    n1, n2, g, e, c, h, ldb = (p[x] for x in ("n1", "n2", "g", "e", "c", "h", "ldb"))
    x, _, _, mean, std = dftspec.oracle_data(2 * m, r=1, seed=log_m)
    z = (x[0, 0::2] + 1j * x[0, 1::2]).astype(np.complex128)
    # pass 1, CTA r: its columns, each DFT'd over j1, times W_m^(j2 k1)
    zz = z.reshape(n1, n2)
    a = np.empty((g, e), np.complex128)
    kk1 = np.arange(n1)[:, None]
    for r in range(g):
        cols = np.arange(r * c, (r + 1) * c)
        t = np.fft.fft(zz[:, cols], axis=0) * np.exp(-2j * np.pi * kk1 * cols / m)
        a[r] = t.reshape(-1)  # slot k1 * c + (j2 - r c)
    # the exchange, then pass 2 over each CTA's rows of B
    b = np.zeros((g, n2 * ldb), np.complex128)
    rank = np.repeat(np.arange(g), e)
    b[rank, gdst] = a[grank, goff]
    for r in range(g):
        rows_ = b[r].reshape(n2, ldb)
        rows_[:, :h] = np.fft.fft(rows_[:, :h], axis=0)
    # the epilogue: X[k] from the Z homes of k and its mirror, X[k-1]
    # from the neighbour map
    unc, uns = (t.numpy().astype(np.float64) for t in untwist_tables(m, torch.device("cpu")))
    zk = b[zr, zo]
    mirror_bin = k1m + n1 * k2m.astype(np.int64)
    zm = zk[mirror_bin]
    xk = np.empty(m + 1, np.complex128)
    arr, aii = 0.5 * (zk.real + zm.real), 0.5 * (zk.imag - zm.imag)
    br, bi = zk.real - zm.real, zk.imag + zm.imag
    xk[:m] = (arr + 0.5 * (unc[:m] * bi - uns[:m] * br)) + 1j * (
        aii - 0.5 * (unc[:m] * br + uns[:m] * bi))
    z0 = zk[0]
    xk[m] = (z0.real + unc[m] * z0.imag) - 1j * uns[m] * z0.imag  # Z[m] = Z[0]
    prev_bin = np.append(-1, (k1p + n1 * k2p.astype(np.int64))[1:])
    xl = np.where(np.arange(m + 1) > 0, xk[np.append(prev_bin, m - 1)], 0)
    amp = np.sqrt(np.maximum(np.abs(xk) ** 2, 0.5 * np.abs(xk - xl) ** 2))
    npad = m + 1 + 4095 - m % 4096
    got = np.zeros((1, npad), np.float32)
    got[0, : m + 1] = (amp - mean[0]) / std[0]
    xt, mt, st = (torch.from_numpy(v) for v in (x, mean, std))
    want = dftspec.dft_untwist_interbin_plain(xt, mt, st, npad=npad)
    acc_max, q999 = dftspec.accuracy(torch.from_numpy(got), want, mt, st, m)
    assert acc_max <= dftspec.ACC_MAX_REL and q999 <= dftspec.ACC_Q999_REL
    assert not want[0, m + 1 :].any()


@pytest.mark.parametrize(
    "m,npad",
    [(4, 5), (4, 16), (64, 4096), (1 << 10, (1 << 10) + 2), (1 << 10, 4096),
     (1 << 16, (1 << 16) + 4096), (1 << 20, (1 << 20) + 1024)],
)
def test_interbin_map_one_writer_per_bin(shim, m, npad):
    # every bin 0..m written once by a pair thread, every pad once by a pad
    # thread, the blocks hold every thread (the spare ones idle), and each
    # bin's untwist reads the plain version's Z[k] and Z[m-k]
    pair_w = np.zeros(npad, np.int32)
    pad_w = np.zeros(npad, np.int32)
    zk = np.empty(m + 1, np.int32)
    zm = np.empty(m + 1, np.int32)
    spare = np.empty(2, np.int32)
    assert shim.interbin_map(m, npad, *map(_ptr, (pair_w, pad_w, zk, zm, spare))) == 0
    np.testing.assert_array_equal(pair_w, np.arange(npad) <= m)
    np.testing.assert_array_equal(pad_w, np.arange(npad) > m)
    assert (0 <= spare).all() and (spare < 256).all()
    # the plain version's gathers (ops/fft.py:untwist_parts) on an index ramp
    z = torch.complex(torch.arange(m, dtype=torch.float32), torch.zeros(m))
    zkr = torch.cat([z.real, z.real[:1]])
    zmr = torch.cat([z.real[:1], z.real.flip(-1)])
    np.testing.assert_array_equal(zk, zkr.numpy().astype(np.int32))
    np.testing.assert_array_equal(zm, zmr.numpy().astype(np.int32))


def _dedisp_case(c, d, t, spread, full, killed):
    """Ascending delays, u8 samples, the kept channels and the filterbank
    placed 16-byte aligned, or one byte past that where ``killed`` is
    "unaligned" (a view into a larger buffer, as a stream chunk's is).
    ``killed``: the share of channels killed at random (channel 0 kept),
    or "band"/"unaligned", htru_hilat's kill file (channels 0-153)."""
    rng = np.random.default_rng(c + d)
    fil = (np.full((t, c), 255) if full else rng.integers(0, 256, size=(t, c))).astype(np.uint8)
    k = np.linspace(1.0, 0.0, c) ** 2  # lowest frequency first: largest delay
    dms = np.sort(rng.uniform(0, 1, d))
    dms[-1] = 1.0
    delays = np.rint(dms[:, None] * k * spread).astype(np.int32)
    if isinstance(killed, str):
        kill = (np.arange(c) >= 154).astype(np.int32)
    else:
        kill = (rng.random(c) >= killed).astype(np.int32)
        kill[0] = 1
    buf = np.empty(fil.nbytes + 32, np.uint8)
    at = (-buf.ctypes.data) % 16 + (killed == "unaligned")
    x = buf[at : at + fil.nbytes].reshape(fil.shape)
    x[...] = fil
    return x, delays, kill


@pytest.mark.parametrize(
    "c,d,t,spread,full,killed",
    [
        (1, 5, 3000, 40, False, 0.15),  # one channel
        (64, 77, 4500, 320, False, 0.0),  # the big grid's: every chunk wide
        (64, 21, 4500, 320, False, 0.15),  # killed channels inside wide chunks
        (300, 9, 2600, 90, True, 0.15),  # past one 16-bit lane, every sample 255
        (4096, 10, 2300, 700, False, 0.002),  # many chunks, flushes
        (16, 12, 26000, 20000, False, 0.0),  # a spread past 16-channel windows
        (1024, 20, 2600, 700, False, "band"),  # htru_hilat's band: 6 channels in the first
        (1024, 18, 2400, 500, False, 0.3),  # a scattered kill mask
        (1000, 9, 2500, 300, False, 0.1),  # rows off 16-byte boundaries: byte staging
        (1024, 7, 2500, 400, False, "unaligned"),  # an unaligned view: byte staging
    ],
)
def test_dedisperse_window_holds_every_read(shim, c, d, t, spread, full, killed):
    # the kernel's blocks emulated through csrc/dedisp_map.cuh on the
    # wrapper's tables: every read lands in the window its chunk staged and
    # is x[t + delay, c], the lane sums are the plain channel sums, and the
    # packed, copied-out bytes are the plain version's output
    from peasoup_tpu_torch.ops import dedisperse as tdd

    fil, delays, kill = _dedisp_case(c, d, t, spread, full, killed)
    chans = np.flatnonzero(kill).astype(np.int32)
    out_n = t - int(delays.max())
    tab = tdd._tables(delays, chans, c)
    sums = np.zeros((d, out_n), np.uint32)
    dense = np.zeros(1, np.int64)
    out = np.full((d, out_n), 77, np.uint8)
    scale = tdd.output_scale(8, len(chans))
    rc = shim.dedisp_emulate(
        _ptr(fil), t, c, _ptr(tab["chunks"]), len(chans), _ptr(tab["rel"]),
        _ptr(tab["lo_spread"]), tab["log_chunk"], tab["nchunks"], tab["pitch"],
        d, out_n, _ptr(sums), _ptr(dense), scale, int(scale != 1.0), _ptr(out),
    )
    assert rc == 0
    plain = tdd.dedisperse_block(
        torch.from_numpy(fil), delays, kill, out_nsamps=out_n, scale=scale
    )
    np.testing.assert_array_equal(out, plain.numpy())
    # the chunks are cut on multiples of their width and their masks name
    # the kept channels, each once
    w = 1 << tab["log_chunk"]
    first, mask = tab["chunks"].T
    assert (first % w == 0).all() and (mask > 0).all()
    named = [f + b for f, m in zip(first, mask) for b in range(w) if m >> b & 1]
    np.testing.assert_array_equal(named, chans)
    if killed in ("band", "unaligned"):
        assert first[0] == 144 and bin(mask[0]).count("1") == 6
    # every chunk is staged by 16-byte loads where 16-channel chunks have
    # rows on 16-byte boundaries, whatever the kill mask; none elsewhere
    staged = tab["nchunks"] * -(-out_n // tdd.TILE) * -(-d // tdd.TRIALS)
    aligned = w == 16 and c % 16 == 0 and fil.ctypes.data % 16 == 0
    assert aligned == (c % 16 == 0 and spread <= 10000 and killed != "unaligned")
    assert dense[0] == (staged if aligned else 0)
    want = np.zeros((d, out_n), np.int64)
    for ch in chans:
        for i in range(d):
            want[i] += fil[delays[i, ch] : delays[i, ch] + out_n, ch]
    np.testing.assert_array_equal(sums, want)
    # chunks narrow only where the widest window would not fit
    assert (tab["log_chunk"] < tdd.MAX_LOG_CHUNK) == (spread > 10000)


def _sp_inputs(case):
    """(csum (rows, tpad + wext) f32, widths, scales, nvalid, tpad) for the
    spchain emulation: normalised noise with a bright pulse, prefix sums as
    the search forms them, and the case's edges."""
    from peasoup_tpu_torch.ops import singlepulse as sp

    rng = np.random.default_rng(len(case))
    rows, nsamps = 5, 20000
    widths = sp.default_widths(12)
    if case == "odd_bank":  # a bank that is not powers of two, out of order
        widths = (3, 1, 5, 6, 7, 2, 10, 13, 100, 4, 257, 1000, 1001, 1023)
    if case == "long_rows":
        rows, nsamps = 3, 70001
    if case == "wide_bank":  # spsearch --n_widths 16: widths to 32,768
        rows, nsamps, widths = 3, 70001, sp.default_widths(16)
    if case == "widest_bank":  # the widest boxcar a 14-chunk ring holds a tile of
        rows, nsamps, widths = 2, 70001, (1, 2, 5, 4099, 48126)
    x = rng.normal(size=(rows, nsamps)).astype(np.float32)
    x[1, nsamps // 3 : nsamps // 3 + 40] += 8.0
    if case == "ties":
        # flat stretches: every width's boxcar is 0 (ties between widths),
        # and equal across the samples of a block; a comb of equal pulses
        x[:, 100:5000] = 0.0
        x[2, 6000:9000:64] = 3.0
        x[3] = np.round(x[3])
    norm = sp.normalise_trials(torch.from_numpy(x))
    if case == "ties":
        norm[:, 100:5000] = 0.0
    tpad, _ = sp.plan_pad(nsamps)
    wext = sp.width_extent(widths)
    csum = sp.prefix_sum_padded(norm, tpad, wext).numpy()
    nvalid = nsamps
    if case == "signed_zeros":
        # -0 and +0 prefix sums side by side: (-0 - +0) * s = -0, (+0 - -0)
        # * s = +0, and tiny differences that round to a signed zero
        csum[:, 200:6000] = np.where(np.arange(5800) % 3 == 0, -0.0, 0.0)
        csum[1, 7000:9000] = np.where(np.arange(2000) % 2, -1e-45, 1e-45)
        csum[2, 3000:3100] = -0.0
    if case == "nvalid_mid_tile":
        nvalid = nsamps - 1500  # inside the row's last tiles of 2,048
    if case == "all_neg_inf":
        nvalid = 0  # no boxcar fits: every block -inf, 0, 0
    return np.ascontiguousarray(csum, np.float32), widths, sp.width_scales(widths), nvalid, tpad


def _sp_emulate(shim, csum, widths, scales, nvalid, tpad, dec, nblocks):
    rows, row_len = csum.shape
    nbd = tpad // dec
    out = [np.full((rows, nbd), 7.5, np.float32), np.full((rows, nbd), -9, np.int32),
           np.full((rows, nbd), -9, np.int32)]
    stats = np.zeros(3, np.int64)
    w = np.asarray(widths, np.int32)
    sc = np.asarray(scales, np.float32)
    rc = shim.spchain_emulate(_ptr(csum), _ptr(w), _ptr(sc), len(widths), rows, row_len, tpad,
                              nvalid, dec, nblocks, *(_ptr(a) for a in out), _ptr(stats))
    assert rc == 0
    return out, stats


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize(
    "case,dec,nblocks",
    [
        ("base", 1, 13), ("base", 2, 13), ("base", 8, 13), ("base", 32, 13),
        ("base", 64, 13), ("base", 1024, 13),
        ("base", 32, 1),  # one block walks every row
        ("base", 32, 1000),  # more blocks than tiles: a tile each, some idle
        ("nvalid_mid_tile", 32, 7), ("nvalid_mid_tile", 4, 7),
        ("odd_bank", 32, 9), ("odd_bank", 1, 9), ("odd_bank", 512, 9),
        ("ties", 32, 11), ("ties", 256, 11), ("ties", 2, 11),
        ("signed_zeros", 32, 5), ("signed_zeros", 1, 5), ("signed_zeros", 16, 5),
        ("all_neg_inf", 32, 4), ("all_neg_inf", 1024, 4),
        ("long_rows", 32, 5),  # rows of 35 tiles over runs of 21 or 22
        # windows that wrap round the ring's end
        ("wide_bank", 32, 5), ("wide_bank", 1, 5), ("wide_bank", 1024, 7),
        ("widest_bank", 32, 3), ("widest_bank", 4, 3),
    ],
)
def test_spchain_blocks_match_plain(shim, case, dec, nblocks):
    # spchain.cu's blocks emulated through csrc/spchain_map.cuh, bitwise
    # against the port's plain version and the JAX package's twin
    from peasoup_tpu.ops import singlepulse as jsp
    from peasoup_tpu_torch.ops import singlepulse as sp

    csum, widths, scales, nvalid, tpad = _sp_inputs(case)
    got, stats = _sp_emulate(shim, csum, widths, scales, nvalid, tpad, dec, nblocks)
    want = sp.boxcar_dec_best_plain(torch.from_numpy(csum), widths, scales, nvalid, tpad, dec)
    twin = jsp.boxcar_dec_best_twin(jnp.asarray(csum), widths, scales, nvalid, tpad, dec)
    for g, p, j, name in zip(got, want, twin, ("bmax", "barg", "bwidx")):
        np.testing.assert_array_equal(_bits(g), _bits(p.numpy()), err_msg=name)
        np.testing.assert_array_equal(_bits(g), _bits(np.asarray(j)), err_msg=name)
    rows = csum.shape[0]
    geo = _sp_geometry(shim, widths)
    tiles = rows * -(-tpad // geo["tile"])
    assert stats[:2].sum() == tiles  # every tile swept once
    # only the banks past ~20k samples take the wrapping ring
    assert stats[2] == geo["wrap"] == (case in ("wide_bank", "widest_bank"))
    assert stats[1] >= rows  # each row's last tiles take the masked loop
    if case == "all_neg_inf":
        assert np.isneginf(got[0]).all() and not got[1].any() and not got[2].any()
    if case == "signed_zeros":
        # blocks whose maximum is a zero: +0 where any sample's best is +0,
        # though the first maximum (the winner) may be -0
        best, _ = sp.boxcar_best_plain(torch.from_numpy(csum), widths, scales, nvalid, tpad)
        at = np.arange(got[1].shape[1]) * dec + got[1]
        winner = np.take_along_axis(best.numpy(), at, axis=1)
        zero = got[0] == 0
        assert zero.any() and not np.signbit(got[0][zero]).all()
        if dec > 1:
            assert (np.signbit(winner[zero]) & ~np.signbit(got[0][zero])).any()
    if case == "ties":
        assert (got[0][:, -(-200 // dec) : 2900 // dec] == 0).all()  # past every width
    if case == "odd_bank":
        assert len(set(got[2].ravel().tolist())) > 4


def _sp_geometry(shim, widths) -> dict:
    w = np.asarray(widths, np.int32)
    out = np.zeros(7, np.int32)
    shim.spchain_geometry(_ptr(w), len(widths), _ptr(out))
    keys = ("reach", "nwin", "slots", "wrap", "chunks", "tile", "chunk")
    return dict(zip(keys, (int(v) for v in out)))


@pytest.mark.parametrize(
    "widths",
    [(1, 2, 4), (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048), (5, 9, 4099),
     (3, 2047), (2048,), (16000,), (17000,), (30000,), tuple(1 << k for k in range(16)),
     (48126,), (48900,), (60000,)],
)
def test_spchain_ring_geometry(shim, widths):
    # the ring holds a tile's chunks and a load ahead; it takes every bank
    # the one-window design before it took (a window of 8,192 samples and
    # the width extent in 228,352 B of shared memory), and refuses only
    # where even a wrapping ring would pass 14 chunks
    from peasoup_tpu_torch.ops import singlepulse as sp

    g = _sp_geometry(shim, widths)
    assert g["chunk"] == g["tile"] and g["tile"] % 512 == 0
    assert g["reach"] >= max(widths) + 3 if max(widths) > 4 else g["reach"] == 7
    assert g["nwin"] * g["tile"] >= g["tile"] - 4 + g["reach"] + 1
    assert g["chunks"] * g["chunk"] * 4 <= 14 * 16384  # and the barriers and bank
    old_design = (8192 + sp.width_extent(widths)) * 4 <= 228_352
    assert bool(g["slots"]) == (g["nwin"] <= 14)
    assert g["slots"] or not old_design
    if g["slots"] and not g["wrap"]:
        s = g["slots"]
        assert s >= g["nwin"] + 2 and s >= 4 and s & (s - 1) == 0
        assert g["chunks"] == s + g["nwin"] - 1 <= 14
    if g["slots"] and g["wrap"]:
        assert g["nwin"] <= g["slots"] == g["chunks"] == min(g["nwin"] + 2, 14)
        copy = 4
        while copy < g["nwin"] + 2:
            copy *= 2
        assert copy + g["nwin"] - 1 > 14  # wraps only where copies do not fit
    if max(widths) <= 2048:
        assert not g["wrap"]  # the default bank keeps its contiguous windows


def _bx_emulate(shim, csum, widths, scales, nvalid, tpad, nblocks):
    rows, row_len = csum.shape
    best = np.full((rows, tpad), 7.5, np.float32)
    bw = np.full((rows, tpad), -9, np.int32)
    stats = np.zeros(10, np.int64)
    w = np.asarray(widths, np.int32)
    sc = np.asarray(scales, np.float32)
    rc = shim.boxcar_emulate(_ptr(csum), _ptr(w), _ptr(sc), len(widths), rows, row_len, tpad,
                             nvalid, nblocks, _ptr(best), _ptr(bw), _ptr(stats))
    assert rc == 0
    return best, bw, stats


@pytest.mark.parametrize(
    "case,nblocks",
    [
        ("stream_window", 13), ("stream_window", 1),  # one block walks every row
        ("stream_window", 1000),  # more blocks than tiles: a tile each, some idle
        ("nvalid_mid_tile", 7), ("nvalid_zero", 4), ("odd_widths", 9), ("ties", 11),
        ("signed_zeros", 5), ("widest_bank", 3), ("short_tpad", 3), ("short_tpad", 1),
    ],
)
def test_boxcar_blocks_match_plain(shim, case, nblocks):
    # boxcar.cu's blocks emulated through csrc/boxcar_map.cuh, bitwise
    # against the port's plain version and the JAX package's twin
    from peasoup_tpu.ops import singlepulse as jsp
    from peasoup_tpu_torch.ops import singlepulse as sp
    from torch_boxcar_cases import boxcar_case

    csum, widths, scales, nvalid, tpad = boxcar_case(case)
    best, bw, stats = _bx_emulate(shim, csum, widths, scales, nvalid, tpad, nblocks)
    want = sp.boxcar_best_plain(torch.from_numpy(csum), widths, scales, nvalid, tpad)
    twin = jsp.boxcar_best_twin(jnp.asarray(csum), widths, scales, nvalid, tpad)
    # XLA:CPU flushes subnormals to zero, the card and torch keep them: the
    # twin is held bit for bit wherever no boxcar reads a subnormal
    sub = (csum != 0) & (np.abs(csum) < np.finfo(np.float32).tiny)
    reach = np.cumsum(np.pad(sub, ((0, 0), (1, 0))), axis=1)
    wmax = max(widths)
    clean = reach[:, wmax + 1 : tpad + wmax + 1] == reach[:, :tpad]
    assert clean.mean() > 0.9
    for g, p, j, name in zip((best, bw), want, twin, ("best", "bw")):
        np.testing.assert_array_equal(_bits(g), _bits(p.numpy()), err_msg=name)
        np.testing.assert_array_equal(_bits(g)[clean], _bits(np.asarray(j))[clean],
                                      err_msg=name)
    rows, row_len = csum.shape
    geo = _sp_geometry(shim, widths)
    tile, tpr = geo["tile"], -(-tpad // geo["tile"])
    assert stats[:2].sum() == rows * tpr  # every tile swept once
    # the per-tile predicate: the masked sweep takes exactly the tiles
    # where some boxcar passes nvalid
    t0 = np.arange(tpr) * tile
    assert stats[1] == rows * int((t0 + tile - 1 + max(widths) > nvalid).sum())
    assert stats[2] == (case == "widest_bank")  # only a bank past ~20k samples wraps
    # the halo is carried: a load for each chunk the tiles read less those
    # the previous tile of the strip left in the ring, so a row's prefix
    # sums are read once, and again only at a strip's first tile in it
    assert stats[3] == stats[4] - stats[5]
    once = rows * min(tpr - 1 + geo["nwin"], -(-row_len // geo["chunk"]))
    assert once <= stats[3] <= once + min(nblocks, rows * tpr) * (geo["nwin"] - 1)
    if nblocks == 1:
        assert stats[3] == once
    # a load brings in no prefix sum past csum[nvalid] (the last a boxcar
    # reads, rounded up to a 16-byte copy): a row's first min(nvalid + 1,
    # row_len) once, with the rest of each slot poisoned, and the output
    # still bitwise the plain version's
    need = min(-(-(nvalid + 1) // 4) * 4, row_len)
    if nblocks == 1:
        assert stats[7] == rows * need
    halo = min(nblocks, rows * tpr) * (geo["nwin"] - 1) * geo["chunk"]
    assert rows * need <= stats[7] <= rows * need + halo
    # strips of near equal work: a warp's stores count 4, its sweep one a
    # width, and no block takes more than its share and one tile
    warps = np.arange(0, tpad, 512)
    work = rows * (4 * len(warps) + len(widths) * int((warps < nvalid).sum()))
    assert stats[9] == work
    assert stats[8] <= work / min(nblocks, rows * tpr) + 8 * (4 + len(widths))
    # the warps whose samples all start at or past nvalid skip the sweep
    assert stats[6] == rows * int((warps >= nvalid).sum())
    if case == "nvalid_zero":
        assert np.isneginf(best).all() and not bw.any()
    if case == "ties":
        assert (best[:, 200:2900] == 0).all()  # past every width
    if case == "signed_zeros":
        zero = best == 0
        assert np.signbit(best[zero]).any() and not np.signbit(best[zero]).all()
    if case == "odd_widths":
        assert len(set(bw.ravel().tolist())) == len(widths)


@pytest.mark.parametrize(
    "rows,nvalid,tpad,nblocks",
    [(179, 18_432, 24_576, 264),  # the stream's window on an H100's 264 blocks
     (179, 2_101_288, 2_105_344, 264),  # the single-pulse grid's block
     (3, 0, 8192, 5), (7, 5000, 5120, 32), (5, 20_000, 24_576, 7)],
)
def test_boxcar_strips_balance_work(shim, rows, nvalid, tpad, nblocks):
    # each block's strip of consecutive tiles holds near its share of the
    # work (a warp's stores 4, its sweep one a width): at most one tile more
    n = 12
    g = np.zeros(nblocks + 1, np.int64)
    shim.boxcar_strips(rows, tpad, nvalid, n, nblocks, _ptr(g))
    tpr = -(-tpad // 4096)
    assert g[0] == 0 and g[-1] == rows * tpr and (np.diff(g) >= 0).all()
    warp0 = np.arange(0, tpr * 4096, 512).reshape(tpr, 8)
    tile_work = np.where(warp0 < tpad, 4 + n * (warp0 < nvalid), 0).sum(axis=1)
    cum = np.concatenate([[0], np.cumsum(np.tile(tile_work, rows))])
    work = cum[g[1:]] - cum[g[:-1]]
    assert work.max() <= cum[-1] / nblocks + tile_work.max()
    if (nvalid, nblocks) == (18_432, 264):
        # no block sweeps more than 4 tiles, where equal strips of tiles
        # (4-5 a block) would put 4.5 tiles' sweeps on some
        eq = rows * tpr * np.arange(nblocks + 1) // nblocks
        eq_work = cum[eq[1:]] - cum[eq[:-1]]
        assert work.max() <= 4 * tile_work.max() < eq_work.max()


def _peaks_case(case):
    """(levels, nbins, windows (nlev, 2), mx) for the peaks emulation."""
    nbins, npad, rows = 9000, 12288, 4
    rng = np.random.default_rng(len(case))
    nlev = 5

    def noise():
        s = 0.1 * np.abs(rng.normal(size=(rows, npad))).astype(np.float32)
        s[:, nbins:] = 1e9  # garbage past nbins, as block-aligned sums hold
        return s

    levels = [noise() for _ in range(nlev)]
    w = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (nlev, 1))
    mx = 32
    if case == "word_bits":
        # crossings on bits 0 and 31 of mask words, windows starting and
        # ending at word edges and one bin inside them
        for lv in levels:
            lv[:, [1024, 1055, 2048, 2079, 4095, 4096, 6143, 6144]] = 40.0
        w = np.asarray([[1024, 6144], [1025, 6145], [1055, 4096], [1056, 4095],
                        [0, nbins + 700]], np.int32)
    elif case == "dense_runs":
        # runs of crossings across words, spans and phase A's tiles
        for h, lv in enumerate(levels):
            lv[1, 1000 + h : 3100] += 25.0
            lv[2, 4000:4300:3] += 25.0
        w[2] = [1001, 3099]
        mx = 64
    elif case == "overflow":
        for lv in levels:
            lv[:, 1000:8000:61] += 30.0
        mx = 4
    elif case == "empty_windows":
        # a window that holds no bin, one inverted, one from a negative start
        for lv in levels:
            lv[:, ::97] += 30.0
        w = np.asarray([[500, 500], [8000, 7000], [-40, 8999], [300, 301], [0, 0]], np.int32)
    else:  # "comb": distinct combs a level
        for h, lv in enumerate(levels):
            lv[::2, h :: 61] += 30.0
            lv[1, nbins // 2 + h : nbins // 2 + 400 : 4] += 20.0
    return [np.ascontiguousarray(lv) for lv in levels], nbins, w, mx


@pytest.mark.parametrize("case", ["comb", "word_bits", "dense_runs", "overflow",
                                  "empty_windows"])
def test_peaks_phases_match_plain(shim, case):
    # peaks.cu's phase A (16-byte reads inside each level's window, nibbles
    # to mask words, clipped at the window's edges) and the shared walk,
    # with each crossing's value one load of its level, emulated through
    # csrc/peaks_map.cuh and levels.cuh: bitwise against the port's plain
    # version and the JAX package's Pallas kernel in interpret mode
    from peasoup_tpu.ops.pallas.peaks import find_cluster_peaks_multi as jax_kernel

    levels, nbins, windows, mx = _peaks_case(case)
    rows, npad = levels[0].shape
    nlev = len(levels)
    scales = harmonics.level_scales(nlev - 1)
    kw = dict(threshold=9.0, max_peaks=mx, scales=scales, nbins=nbins)
    want = peaks.find_cluster_peaks_multi_plain(
        [torch.from_numpy(lv) for lv in levels], windows, **kw)
    jx = jax_kernel([jnp.asarray(lv) for lv in levels], jnp.asarray(windows), interpret=True,
                    **kw)
    w = np.ascontiguousarray(peaks._clamped_windows(windows, nbins, nlev))
    sc = np.asarray(scales, np.float32)
    got = [np.empty((rows, nlev, mx), np.int32), np.empty((rows, nlev, mx), np.float32),
           np.empty((rows, nlev), np.int32), np.empty((rows, nlev), np.int32)]
    ptrs = [_ptr(lv) for lv in levels] + [None] * (6 - nlev)
    assert shim.peaks(*ptrs, rows, npad, nbins, nlev, _ptr(w), _ptr(sc),
                      float(np.float32(9.0)), 30, mx, *(_ptr(g) for g in got)) == 0
    for g, t, j, name in zip(got, want, jx, ("idxs", "snrs", "counts", "ccounts")):
        np.testing.assert_array_equal(_bits(g), _bits(t.numpy()), err_msg=name)
        np.testing.assert_array_equal(_bits(g), _bits(np.asarray(j)), err_msg=name)
    assert got[3].max() > 0
    if case == "overflow":
        assert got[3].max() > mx
    if case == "word_bits":
        # level 0's window [1024, 6144): 4095 and 4096 are one cluster, 6144
        # lies outside
        assert {1024, 1055, 2048, 2079, 4095, 6143} == set(got[0][:, 0].ravel().tolist()) - {nbins}
    if case == "empty_windows":
        assert not got[2][:, [0, 1, 4]].any()
