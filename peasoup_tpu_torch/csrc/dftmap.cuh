// Who holds what in dftspec.cu's cluster: the four-step DFT's shape for a
// half length m, and the maps from a bin to the CTA (cluster rank) and the
// shared-memory slot that hold it. dftspec.cu and the CPU tests' host build
// (tests/test_torch_kernel_host.py, which checks that every bin 0..m has
// exactly one writer and the right owner) compile this one copy.
//
// m = n1 * n2 (n1 the power of two at or below sqrt(m)); sample j = j1 n2 +
// j2, bin k = k1 + n1 k2. One cluster of g CTAs holds one row:
//  - pass 1: CTA r owns the c = n2/g columns j2 in [r c, (r+1) c) and
//    leaves T[k1, j2] in its buffer A at k1 * c + (j2 - r c);
//  - pass 2: CTA r owns the h = n1/g rows k1 in [r h, (r+1) h), gathers
//    them from every CTA's A into its buffer B (j2 * ldb + k1 - r h, ldb =
//    h + 1, odd, so the gather's stores do not collide in banks) and leaves
//    Z[k1, k2] there at k2 * ldb + (k1 - r h);
//  - epilogue: CTA r writes the bins of its k1 rows, h neighbouring bins
//    for each k2 (the mirror m - k of each is another CTA's, read through
//    distributed shared memory), and CTA g - 1 also the Nyquist bin m.
// Every size is a power of two, so the maps shift and mask.

#pragma once

#include <cstdint>

#include "hd.cuh"

namespace dftmap {

constexpr int kPer = 16;     // complex values a thread holds in an FFT stage
constexpr int kMinLog = 14;  // m = 2^14 .. 2^17, the JAX kernel's gate
constexpr int kMaxLog = 17;
constexpr int kMaxLogCluster = 4;  // 16 CTAs: the H100's non-portable limit

struct Plan {
  int log_m, log_n1, log_n2, log_g, log_c, log_h;
  int n1, n2;
  int g;    // CTAs a row (the cluster size)
  int e;    // complex values a CTA holds: m / g
  int c;    // j2 columns a CTA owns in pass 1
  int h;    // k1 rows a CTA owns in pass 2 and the epilogue
  int ldb;  // row stride of buffer B: h + 1
};

// Whether dftspec.cu serves the half length m = 2^log_m.
PEASOUP_HD constexpr bool supported(int log_m) { return log_m >= kMinLog && log_m <= kMaxLog; }

// The shape for a supported half length 2^log_m: 4,096 values a CTA (two
// 32 KB buffers), except at 2^17, where the 16-CTA limit makes it 8,192.
PEASOUP_HD constexpr Plan plan(int log_m) {
  Plan p{};
  p.log_m = log_m;
  p.log_n1 = log_m / 2;
  p.log_n2 = log_m - p.log_n1;
  p.log_g = log_m - 12 < kMaxLogCluster ? log_m - 12 : kMaxLogCluster;
  p.log_c = p.log_n2 - p.log_g;
  p.log_h = p.log_n1 - p.log_g;
  p.n1 = 1 << p.log_n1;
  p.n2 = 1 << p.log_n2;
  p.g = 1 << p.log_g;
  p.e = 1 << (log_m - p.log_g);
  p.c = 1 << p.log_c;
  p.h = 1 << p.log_h;
  p.ldb = p.h + 1;
  return p;
}

// Threads a CTA: kPer values each.
PEASOUP_HD constexpr int threads(const Plan& p) { return p.e / kPer; }

// Shared memory a CTA: A (e float2), B (n2 ldb; after the last cluster
// barrier it holds the halos, n2), and the twiddle tables W_m^q for q < n1
// and W_m^(q n1) = W_n2^q for q < n2 (every twiddle of both passes is one
// entry or the product of two). At m = 2^16 that is 71,680 bytes, so three
// CTAs share an SM.
PEASOUP_HD constexpr int64_t smem_bytes(const Plan& p) {
  return 8 * (p.e + int64_t{p.n2} * p.ldb + p.n1 + p.n2);
}

// Pass 1's T[k1, j2]: its CTA and its slot in that CTA's A.
PEASOUP_HD void t_home(const Plan& p, int k1, int j2, int& rank, int& off) {
  rank = j2 >> p.log_c;
  off = (k1 << p.log_c) + (j2 & (p.c - 1));
}

// The exchange's element e of CTA `rank` (e < p.e): the T[k1, j2] it reads
// and the slot of B it stores to. Neighbouring e read neighbouring slots of
// one CTA's A.
PEASOUP_HD void gather(const Plan& p, int rank, int e, int& k1, int& j2, int& dst) {
  const int jl = e & (p.c - 1);
  const int rest = e >> p.log_c;
  const int owner = rest & (p.g - 1);
  const int kl = rest >> p.log_g;
  k1 = (rank << p.log_h) + kl;
  j2 = (owner << p.log_c) + jl;
  dst = j2 * p.ldb + kl;
}

// Z[k1, k2] after pass 2: its CTA and its slot in that CTA's B.
PEASOUP_HD void z_home(const Plan& p, int k1, int k2, int& rank, int& off) {
  rank = k1 >> p.log_h;
  off = k2 * p.ldb + (k1 & (p.h - 1));
}

// The mirror m - k of bin k = k1 + n1 k2 (0 for k = 0), as (k1, k2).
PEASOUP_HD void mirror(const Plan& p, int k1, int k2, int& k1m, int& k2m) {
  if (k1 > 0) {
    k1m = p.n1 - k1;
    k2m = p.n2 - 1 - k2;
  } else {
    k1m = 0;
    k2m = (p.n2 - k2) & (p.n2 - 1);
  }
}

// The neighbour k - 1 of bin k = k1 + n1 k2 > 0, as (k1, k2).
PEASOUP_HD void prev(const Plan& p, int k1, int k2, int& k1p, int& k2p) {
  if (k1 > 0) {
    k1p = k1 - 1;
    k2p = k2;
  } else {
    k1p = p.n1 - 1;
    k2p = k2 - 1;
  }
}

// The epilogue's element e of CTA `rank` (e < p.e): its k1 and k2; its
// X lands at slot e = k2 h + (k1 - rank h) of A, and its bin is k1 + n1 k2.
// The bin below it is slot e - 1's, but for the first of each k2 row
// (k1 = rank h), whose X the CTA computes apart (its halo).
PEASOUP_HD void out_elem(const Plan& p, int rank, int e, int& k1, int& k2) {
  k1 = (rank << p.log_h) + (e & (p.h - 1));
  k2 = e >> p.log_h;
}

// The CTA that writes the Nyquist bin m (its X[m-1] is that CTA's last).
PEASOUP_HD int nyquist_rank(const Plan& p) { return p.g - 1; }

}  // namespace dftmap
