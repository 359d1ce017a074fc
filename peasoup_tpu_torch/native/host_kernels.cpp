// The host-side candidate distillers of peasoup_tpu_torch, in C++.
//
// The reference keeps its distillers in C++ (include/transforms/
// distiller.hpp); this library holds the same loops behind a plain C ABI
// that peasoup_tpu_torch/native/__init__.py loads with ctypes. It also
// replays the reference's S/N sort, std::sort on (snr, index) pairs, so
// that exact S/N ties crown the member the reference crowns.
//
// Semantics mirror the pure-Python distillers of
// peasoup_tpu_torch/pipeline/distill.py exactly; PEASOUP_NO_NATIVE=1
// selects those instead.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Distillers. Inputs are candidate columns ALREADY sorted by S/N
// descending. Outputs: unique mask (1 = survivor) and an edge list
// (fundamental index, absorbed index) with one entry PER MATCHING
// HARMONIC PAIR (multiplicity feeds nassoc / ddm ratios).
// Returns the number of edges written (capped at max_edges; the caller
// retries with a larger buffer if the return value exceeds it).
// ---------------------------------------------------------------------------

struct EdgeSink {
  int32_t* src;
  int32_t* dst;
  int64_t cap;
  int64_t n = 0;
  void add(int64_t s, int64_t d) {
    if (n < cap) {
      src[n] = static_cast<int32_t>(s);
      dst[n] = static_cast<int32_t>(d);
    }
    ++n;
  }
};

// Harmonic-ratio matcher shared by the per-trial and segmented
// distills. Counts matching (jj, kk) pairs; with early_exit it stops
// at the first match (valid only when pair multiplicity is unused,
// i.e. keep_related is false).
static inline int harmonic_hits(double fundi, double freq, int32_t nh,
                                double lo, double hi, int32_t max_harm,
                                int32_t fractional, bool early_exit) {
  const int32_t max_denom = fractional ? (int32_t{1} << nh) : int32_t{1};
  if (early_exit) {
    // Existence check only.  For fixed jj the ratio kk*freq/(jj*fundi)
    // is strictly increasing in kk, so at most a couple of kk values
    // can land inside (lo, hi): locate the window with one divide and
    // verify those candidates with the EXACT original predicate (the
    // located bounds are approximate in double, the decision is not).
    for (int32_t jj = 1; jj <= max_harm; ++jj) {
      const double denom = jj * fundi;
      const double k0 = lo * denom / freq;  // ratio(kk) > lo ~ kk > k0
      int32_t kk = static_cast<int32_t>(k0);  // trunc; candidates k0 +- 1
      if (kk < 1) kk = 1;
      const int32_t kk_end = kk + 2 < max_denom ? kk + 2 : max_denom;
      for (; kk <= kk_end; ++kk) {
        const double ratio = kk * freq / denom;
        if (ratio > lo && ratio < hi) return 1;
        if (ratio >= hi) break;  // increasing in kk: no later hit
      }
    }
    return 0;
  }
  int hits = 0;
  for (int32_t jj = 1; jj <= max_harm; ++jj) {
    for (int32_t kk = 1; kk <= max_denom; ++kk) {
      const double ratio = kk * freq / (jj * fundi);
      if (ratio > lo && ratio < hi) {
        ++hits;
      }
    }
  }
  return hits;
}

int64_t ps_harmonic_distill(const double* freqs, const int32_t* nhs, int64_t n,
                            double tol, int32_t max_harm, int32_t fractional,
                            int32_t keep_related, uint8_t* unique,
                            int32_t* edge_src, int32_t* edge_dst,
                            int64_t max_edges) {
  std::fill(unique, unique + n, uint8_t{1});
  EdgeSink edges{edge_src, edge_dst, max_edges};
  const double lo = 1.0 - tol, hi = 1.0 + tol;
  for (int64_t idx = 0; idx < n; ++idx) {
    if (!unique[idx]) continue;
    const double fundi = freqs[idx];
    for (int64_t jjt = idx + 1; jjt < n; ++jjt) {
      const int hits = harmonic_hits(fundi, freqs[jjt], nhs[jjt], lo, hi,
                                     max_harm, fractional,
                                     /*early_exit=*/!keep_related);
      if (keep_related)
        for (int h = 0; h < hits; ++h) edges.add(idx, jjt);
      if (hits) unique[jjt] = 0;
    }
  }
  return edges.n;
}

// Segmented variant: one call distills EVERY accel trial of a run
// (segment s = rows [seg_off[s], seg_off[s+1])), replacing one
// ctypes round trip per trial. Rows arrive pre-sorted by S/N
// descending within each segment; unique flags are written in that
// same row order. keep_related is always false on this path (the
// per-accel-trial distill discards non-survivors,
// src/pipeline_multi.cu:238).
void ps_harmonic_distill_seg(const double* freqs, const int32_t* nhs,
                             const int64_t* seg_off, int64_t nseg, double tol,
                             int32_t max_harm, int32_t fractional,
                             uint8_t* unique) {
  const double lo = 1.0 - tol, hi = 1.0 + tol;
  for (int64_t s = 0; s < nseg; ++s) {
    const int64_t b = seg_off[s], e = seg_off[s + 1];
    std::fill(unique + b, unique + e, uint8_t{1});
    for (int64_t idx = b; idx < e; ++idx) {
      if (!unique[idx]) continue;
      const double fundi = freqs[idx];
      for (int64_t jjt = idx + 1; jjt < e; ++jjt) {
        if (!unique[jjt]) continue;
        if (harmonic_hits(fundi, freqs[jjt], nhs[jjt], lo, hi, max_harm,
                          fractional, /*early_exit=*/true))
          unique[jjt] = 0;
      }
    }
  }
}

int64_t ps_accel_distill(const double* freqs, const double* accs, int64_t n,
                         double tobs_over_c, double tol, int32_t keep_related,
                         uint8_t* unique, int32_t* edge_src, int32_t* edge_dst,
                         int64_t max_edges) {
  std::fill(unique, unique + n, uint8_t{1});
  EdgeSink edges{edge_src, edge_dst, max_edges};
  for (int64_t idx = 0; idx < n; ++idx) {
    if (!unique[idx]) continue;
    const double fundi_freq = freqs[idx];
    const double fundi_acc = accs[idx];
    const double edge = fundi_freq * tol;
    for (int64_t jj = idx + 1; jj < n; ++jj) {
      const double delta_acc = fundi_acc - accs[jj];
      const double acc_freq =
          fundi_freq + delta_acc * fundi_freq * tobs_over_c;
      bool hit;
      if (acc_freq > fundi_freq) {
        hit = freqs[jj] > fundi_freq - edge && freqs[jj] < acc_freq + edge;
      } else {
        hit = freqs[jj] < fundi_freq + edge && freqs[jj] > acc_freq - edge;
      }
      if (hit) {
        if (keep_related) edges.add(idx, jj);
        unique[jj] = 0;
      }
    }
  }
  return edges.n;
}

// Segmented variant: one call runs the acceleration distill of EVERY
// DM trial (segment s = rows [seg_off[s], seg_off[s+1]), pre-sorted
// S/N-descending within each segment), recording winner->loser edges
// with GLOBAL row ids so the caller can build the assoc tree for the
// survivors only once.  Same pairwise window test as ps_accel_distill
// (reference distiller.hpp:115-164).
int64_t ps_accel_distill_seg(const double* freqs, const double* accs,
                             const int64_t* seg_off, int64_t nseg,
                             double tobs_over_c, double tol, uint8_t* unique,
                             int32_t* edge_src, int32_t* edge_dst,
                             int64_t max_edges) {
  EdgeSink edges{edge_src, edge_dst, max_edges};
  for (int64_t s = 0; s < nseg; ++s) {
    const int64_t b = seg_off[s], e = seg_off[s + 1];
    std::fill(unique + b, unique + e, uint8_t{1});
    for (int64_t idx = b; idx < e; ++idx) {
      if (!unique[idx]) continue;
      const double fundi_freq = freqs[idx];
      const double fundi_acc = accs[idx];
      const double edge = fundi_freq * tol;
      for (int64_t jj = idx + 1; jj < e; ++jj) {
        const double delta_acc = fundi_acc - accs[jj];
        const double acc_freq =
            fundi_freq + delta_acc * fundi_freq * tobs_over_c;
        bool hit;
        if (acc_freq > fundi_freq) {
          hit = freqs[jj] > fundi_freq - edge && freqs[jj] < acc_freq + edge;
        } else {
          hit = freqs[jj] < fundi_freq + edge && freqs[jj] > acc_freq - edge;
        }
        if (hit) {
          edges.add(idx, jj);
          unique[jj] = 0;
        }
      }
    }
  }
  return edges.n;
}

// ---------------------------------------------------------------------------
// The reference's !IMPORTANT S/N sort (distiller.hpp:31) is std::sort —
// an UNSTABLE introsort whose permutation of equal-S/N candidates is
// deterministic but not input-order-preserving.  Real searches contain
// EXACT S/N ties (accel trials whose resample shift never reaches half a
// sample produce bitwise-identical spectra), and the distiller crowns
// whichever tied member the sort leaves first — so matching the golden
// winners requires replaying the same algorithm, not a stable sort.
// Sorting (snr, original-index) pairs with the same comparator yields the
// exact permutation: introsort's compare/move sequence depends only on
// comparator outcomes, never on element payload.
// ---------------------------------------------------------------------------
struct PsSnrTag {
  float snr;
  int32_t idx;
};

void ps_snr_sort_perm(const float* snr, int64_t n, int32_t* perm) {
  std::vector<PsSnrTag> v(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    v[static_cast<size_t>(i)] = {snr[i], static_cast<int32_t>(i)};
  std::sort(v.begin(), v.end(),
            [](const PsSnrTag& x, const PsSnrTag& y) { return x.snr > y.snr; });
  for (int64_t i = 0; i < n; ++i) perm[i] = v[static_cast<size_t>(i)].idx;
}

// Segmented variant: independent std::sort per [seg_off[s], seg_off[s+1])
// slice (the reference sorts each trial's candidate list separately);
// perm entries are GLOBAL row ids.
void ps_snr_sort_perm_seg(const float* snr, const int64_t* seg_off,
                          int64_t nseg, int32_t* perm) {
  std::vector<PsSnrTag> v;
  for (int64_t s = 0; s < nseg; ++s) {
    const int64_t b = seg_off[s], e = seg_off[s + 1];
    v.resize(static_cast<size_t>(e - b));
    for (int64_t i = b; i < e; ++i)
      v[static_cast<size_t>(i - b)] = {snr[i], static_cast<int32_t>(i)};
    std::sort(v.begin(), v.end(), [](const PsSnrTag& x, const PsSnrTag& y) {
      return x.snr > y.snr;
    });
    for (int64_t i = b; i < e; ++i)
      perm[i] = v[static_cast<size_t>(i - b)].idx;
  }
}

int64_t ps_dm_distill(const double* freqs, int64_t n, double tol,
                      int32_t keep_related, uint8_t* unique, int32_t* edge_src,
                      int32_t* edge_dst, int64_t max_edges) {
  std::fill(unique, unique + n, uint8_t{1});
  EdgeSink edges{edge_src, edge_dst, max_edges};
  const double lo = 1.0 - tol, hi = 1.0 + tol;
  for (int64_t idx = 0; idx < n; ++idx) {
    if (!unique[idx]) continue;
    const double fundi = freqs[idx];
    for (int64_t jj = idx + 1; jj < n; ++jj) {
      const double ratio = freqs[jj] / fundi;
      if (ratio > lo && ratio < hi) {
        if (keep_related) edges.add(idx, jj);
        unique[jj] = 0;
      }
    }
  }
  return edges.n;
}

}  // extern "C"
