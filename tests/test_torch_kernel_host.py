"""The parts of the port's CUDA kernels that compile for the host, on the
CPU: csrc/levels.cuh (harmpeaks' level function and crossing mask),
csrc/cluster_step.cuh (the cluster walk's step, shared by harmpeaks and
peaks), csrc/dftmap.cuh (who holds what in dftspec's cluster),
csrc/interbin_map.cuh (interbin's mirror pairs) and csrc/dedisp_map.cuh
(dedisperse's staged windows and packed sums).

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
  to x[t + delay, c], the sums the plain channel sums, with one channel,
  past 256 channels of 255s, 4,096 channels and a spread past a
  16-channel window.
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

#include "cluster_step.cuh"
#include "dedisp_map.cuh"
#include "dftmap.cuh"
#include "interbin_map.cuh"
#include "levels.cuh"

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

extern "C" {

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
// chunk's window staged as the kernel's threads stage it, each thread's
// reads taken through read_word / read_shift / funnel and added in 16-bit
// lanes, flushed every kLaneChannels as the kernel flushes them, then the
// output tile packed and copied out as the kernel does. Writes the channel
// sums (ndm, out_n), the u8 output and the number of chunks staged by the
// dense path; returns 1 if a staged row falls outside the window's pitch,
// 2 if a read word does, 3 if a byte a sum takes was not staged by this
// chunk, 4 if it is not x[t + delay, c], 5 if a word store is unaligned.
int dedisp_emulate(const uint8_t* x, long long t_in, int nchans, const int* chans,
                   int nkept, const uint16_t* rel, const int* lo_spread, int log_chunk,
                   int nchunks, int pitch, int ndm, long long out_n, uint32_t* sums,
                   long long* dense_out, float scale, int apply_scale, uint8_t* out) {
  using namespace ddmap;
  long long dense = 0;
  const int chunk = 1 << log_chunk;
  const int ntiles = (ndm + kTrials - 1) / kTrials;
  const long long ntime = (out_n + kTile - 1) / kTile;
  const bool wide = nkept > kLaneChannels;
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
        const int c0 = ck << log_chunk;
        const int kc = chunk < nkept - c0 ? chunk : nkept - c0;
        const int lo = lo_spread[2 * (tile * nchunks + ck)];
        const int rows = window_rows(lo_spread[2 * (tile * nchunks + ck) + 1]);
        uint8_t* winb = reinterpret_cast<uint8_t*>(win.data());
        if (dense_chunk(chans, c0, kc, log_chunk, nchans)) {
          ++dense;
          for (int q = 0; 4 * q < rows; ++q) {
            if (q >= pitch) return 1;
            uint32_t a[4][4];
            for (int u = 0; u < 4; ++u) {
              const long long row = t0 + lo + 4 * q + u;
              for (int g = 0; g < 4; ++g) {
                a[u][g] = 0u;
                if (row < t_in) std::memcpy(&a[u][g], x + row * nchans + chans[c0] + 4 * g, 4);
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
            for (; r < rows; r += kThreads >> log_chunk) {
              if (r >= pitch * 4) return 1;
              const bool ok = cl < kc && t0 + lo + r < t_in;
              const long long at = (long long)cl * pitch * 4 + r;
              winb[at] = ok ? x[(t0 + lo + r) * nchans + chans[c0 + cl]] : 0;
              stamp[at] = stage_no;
            }
          }
        }
        for (int c = 0; c < kc; ++c) {
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
                      ((b >> (8 * q)) & 0xFFu) != x[(t + lo + rl) * nchans + chans[c0 + c]])
                    return 4;
                }
                uint32_t* ln = &lanes[((std::size_t(tid) * kTrials + i) * kGroups + g) * 2];
                ln[0] += even_lanes(b);
                ln[1] += odd_lanes(b);
              }
            }
          }
        }
        in_lanes += kc;
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


@pytest.mark.parametrize(
    "c,d,t,spread,full,killed",
    [
        (1, 5, 3000, 40, False, 0.15),  # one channel
        (64, 77, 4500, 320, False, 0.0),  # the big grid's: every chunk dense
        (64, 21, 4500, 320, False, 0.15),  # killed channels: byte staging
        (300, 9, 2600, 90, True, 0.15),  # past one 16-bit lane, every sample 255
        (4096, 10, 2300, 700, False, 0.002),  # many chunks, flushes, both stagings
        (16, 12, 26000, 20000, False, 0.0),  # a spread past 16-channel windows
    ],
)
def test_dedisperse_window_holds_every_read(shim, c, d, t, spread, full, killed):
    # the kernel's blocks emulated through csrc/dedisp_map.cuh on the
    # wrapper's tables: every read lands in the window its chunk staged and
    # is x[t + delay, c], the lane sums are the plain channel sums, and the
    # packed, copied-out bytes are the plain version's output
    from peasoup_tpu_torch.ops import dedisperse as tdd

    rng = np.random.default_rng(c + d)
    fil = (np.full((t, c), 255) if full else rng.integers(0, 256, size=(t, c))).astype(np.uint8)
    k = np.linspace(1.0, 0.0, c) ** 2  # lowest frequency first: largest delay
    dms = np.sort(rng.uniform(0, 1, d))
    dms[-1] = 1.0
    delays = np.rint(dms[:, None] * k * spread).astype(np.int32)
    kill = (rng.random(c) >= killed).astype(np.int32)
    kill[0] = 1
    chans = np.flatnonzero(kill).astype(np.int32)
    out_n = t - int(delays.max())
    tab = tdd._tables(delays, chans)
    sums = np.zeros((d, out_n), np.uint32)
    dense = np.zeros(1, np.int64)
    out = np.full((d, out_n), 77, np.uint8)
    scale = tdd.output_scale(8, len(chans))
    rc = shim.dedisp_emulate(
        _ptr(fil), t, c, _ptr(chans), len(chans), _ptr(tab["rel"]),
        _ptr(tab["lo_spread"]), tab["log_chunk"], tab["nchunks"], tab["pitch"],
        d, out_n, _ptr(sums), _ptr(dense), scale, int(scale != 1.0), _ptr(out),
    )
    assert rc == 0
    plain = tdd.dedisperse_block(
        torch.from_numpy(fil), delays, kill, out_nsamps=out_n, scale=scale
    )
    np.testing.assert_array_equal(out, plain.numpy())
    # the 16-byte staging runs exactly where a chunk's 16 kept channels are
    # neighbours from a 16-byte boundary
    w = 1 << tab["log_chunk"]
    nd = sum(
        w == 16 and c % 16 == 0 and len(g) == 16 and g[0] % 16 == 0 and g[-1] == g[0] + 15
        for g in np.split(chans, range(w, len(chans), w))
    )
    ntime = -(-out_n // tdd.TILE)
    assert dense[0] == nd * ntime * -(-d // tdd.TRIALS)
    assert (dense[0] > 0) == (killed == 0.0 and c % 16 == 0 and w == 16 or c == 4096)
    want = np.zeros((d, out_n), np.int64)
    for ch in chans:
        for i in range(d):
            want[i] += fil[delays[i, ch] : delays[i, ch] + out_n, ch]
    np.testing.assert_array_equal(sums, want)
    # chunks narrow only where the widest window would not fit
    assert (tab["log_chunk"] < tdd.MAX_LOG_CHUNK) == (spread > 10000)
