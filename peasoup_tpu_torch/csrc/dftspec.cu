// Four-step DFT of the packed real series, then untwist + interbin +
// normalise: the normalised interbin spectrum of each row, computed from the
// time series with no FFT library, in one launch.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/dftspec.py:dft_untwist_interbin (the JAX package
// holds it to the exact einsum chain ops/fft.py:rfft_pow2_matmul_parts ->
// ops/spectrum.py:form_interpolated_parts -> normalise; the plain version
// here is ops/fft.py:packed_dft_z + untwist_interbin_normalise_plain).
//
// Input: x (R, n) f32 rows. z[j] = x[2j] + i x[2j+1], the packed complex
// series of length m = n/2 = n1*n2, is read in place as interleaved complex.
// With j = j1*n2 + j2 and bin k = k1 + n1*k2:
//   pass 1:   T[k1, j2] = W_m^(j2 k1) sum_j1 z[j1*n2 + j2] W_n1^(j1 k1)
//   pass 2:   Z[k1 + n1*k2] = sum_j2 T[k1, j2] W_n2^(j2 k2)
//   epilogue: interbin.cuh's arithmetic on Z (untwist, interbin,
//             (s - mean) / std).
// W_L = e^(-2 pi i / L). Output (R, npad) f32: bins 0..m, zero past m.
//
// What bounds it on the H100: bytes, 8 B read a complex sample and 4 B
// written an output bin. The TPU kernel keeps T and Z in VMEM; so does this
// one, in shared memory: one thread-block cluster of g CTAs holds one row
// (dftmap.cuh says who holds what), so x is read once and the spectrum
// written once, and T and Z never reach device memory. A DFT stage as a
// matrix product (the TPU kernel's MXU form) would cost n1 complex
// multiply-adds a sample, far above the bytes; the FFT here does ~5 log2(m)
// flops a sample, far below the card's f32 rate.
//
// Design, per CTA r of the row's cluster:
//  1. load: the j2 columns [r c, (r+1) c) of every j1, coalesced, straight
//     into the first radix-16 stage's registers;
//  2. pass 1: length-n1 FFTs of those columns, radix 16 then n1/16,
//     Stockham order in registers with one shared-memory round trip a stage;
//     the last stage multiplies by W_m^(j2 k1), the product of two shared
//     tables (W_m^q, q < n1, and W_m^(q n1), q < n2; sincospif of exact
//     arguments);
//  3. cluster barrier; gather the k1 rows [r h, (r+1) h) from every CTA's
//     shared memory (distributed shared memory);
//  4. pass 2: length-n2 FFTs of those rows, radix 16, then 16 or n2/16,
//     then 2 at n2 = 512;
//  5. cluster barrier; X[k] = untwist(Z[k], Z[m-k]) for the CTA's bins, the
//     mirror read from the CTA that holds it, and X of the bin below each k2
//     row's first (the halo); the Nyquist bin's X on CTA g - 1;
//  6. cluster barrier (after it no CTA reads another's shared memory, so
//     each may finish and exit); the interbin amplitudes from X[k] and
//     X[k-1], normalised, written h neighbouring bins at a time; the pad
//     bins past m written 0, spread over the cluster.
// Every shape is a compile-time constant of one instantiation per m, so
// index arithmetic folds into immediates. Complex products use fused
// multiply-adds (the epilogue's arithmetic, shared with interbin.cu, does
// not). The TPU kernel ran both stages as 3-pass
// bf16 matmuls on its matrix unit (XLA's Precision.HIGH class, ~1.5e-5
// relative); the f32 FFT is more accurate (~1e-6), inside the JAX package's
// accuracy gate.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "dftmap.cuh"
#include "interbin.cuh"

namespace cg = cooperative_groups;

namespace {

using dftmap::kPer;
using dftmap::Plan;

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -a.y * b.y), __fmaf_rn(a.x, b.y, a.y * b.x));
}
// -i a
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }

// In-register DFTs of 2, 4, 8 and 16 points, natural order in and out.
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = mul_mi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  dft4(v[0], v[2], v[4], v[6]);  // even samples: E[0..3]
  dft4(v[1], v[3], v[5], v[7]);  // odd samples: O[0..3]
  constexpr float r = 0.70710678118654752f;
  const float2 o1 = make_float2(r * (v[3].x + v[3].y), r * (v[3].y - v[3].x));   // W8 O1
  const float2 o2 = mul_mi(v[5]);                                                 // W8^2 O2
  const float2 o3 = make_float2(r * (v[7].y - v[7].x), -r * (v[7].x + v[7].y));  // W8^3 O3
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// 16 = 4 x 4: with n = b + 4a and k = c + 4d, DFT4s over a, twiddles
// W16^(bc), DFT4s over b; X[k] lands at v[4 (k % 4) + k / 4] and is moved
// to v[k] (a renaming of registers).
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) dft4(v[b], v[b + 4], v[b + 8], v[b + 12]);
  const float2 w1 = make_float2(0.92387953f, -0.38268343f);
  const float2 w2 = make_float2(0.70710678f, -0.70710678f);
  const float2 w3 = make_float2(0.38268343f, -0.92387953f);
  const float2 w6 = make_float2(-0.70710678f, -0.70710678f);
  const float2 w9 = make_float2(-0.92387953f, 0.38268343f);
  v[5] = cmul(v[5], w1);
  v[9] = cmul(v[9], w2);
  v[13] = cmul(v[13], w3);
  v[6] = cmul(v[6], w2);
  v[10] = mul_mi(v[10]);
  v[14] = cmul(v[14], w6);
  v[7] = cmul(v[7], w3);
  v[11] = cmul(v[11], w6);
  v[15] = cmul(v[15], w9);
#pragma unroll
  for (int c = 0; c < 4; ++c) dft4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  float2 t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = v[4 * (k & 3) + (k >> 2)];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = t[k];
}

template <int R>
__device__ __forceinline__ void dft_r(float2 (&v)[R]);
template <>
__device__ __forceinline__ void dft_r<2>(float2 (&v)[2]) { dft2(v[0], v[1]); }
template <>
__device__ __forceinline__ void dft_r<8>(float2 (&v)[8]) { dft8(v); }
template <>
__device__ __forceinline__ void dft_r<16>(float2 (&v)[16]) { dft16(v); }

__host__ __device__ constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }

struct NoPost {
  __device__ __forceinline__ float2 operator()(float2 v, int, int) const { return v; }
};

// pass 1's step between the passes: T[k1, j2] *= W_m^(j2 k1), j2 k1 < m
template <int LOG_N1>
struct StepTwiddle {
  const float2* lo;  // W_m^q, q < n1
  const float2* hi;  // W_m^(q n1), q < n2
  int j2_0;
  __device__ __forceinline__ float2 operator()(float2 v, int k1, int col) const {
    const int p = (j2_0 + col) * k1;
    return cmul(v, cmul(hi[p >> LOG_N1], lo[p & ((1 << LOG_N1) - 1)]));
  }
};

// One Stockham radix-R stage (Ns = 2^LOG_NS) of the length-2^LOG_LEN DFTs
// of the 2^LOG_COLS columns held in buf, element i of column col at
// buf[i * LD + col], in place: each thread reads its kPer values, and after
// a barrier writes them back transformed. tw[q] = W_n2^q (2^LOG_N2 entries;
// every stage length divides n2). post(v, k, col) maps each output.
// Neighbouring threads take neighbouring columns.
template <int kThreads, int R, int LOG_COLS, int LD, int LOG_LEN, int LOG_NS, int LOG_N2,
          class Post>
__device__ __forceinline__ void stage(float2* buf, const float2* tw, const Post& post) {
  constexpr int kSlots = kPer / R;
  constexpr int kLogR = log2_of(R);
  constexpr int kSpan = 1 << (LOG_LEN - kLogR);
  constexpr int kNsMask = (1 << LOG_NS) - 1;
  constexpr int kColsMask = (1 << LOG_COLS) - 1;
  float2 v[kSlots][R];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int slot = static_cast<int>(threadIdx.x) + s * kThreads;
    const int col = slot & kColsMask;
    const int j = slot >> LOG_COLS;
#pragma unroll
    for (int r = 0; r < R; ++r) v[s][r] = buf[(j + r * kSpan) * LD + col];
    if (LOG_NS > 0) {
      const int p = j & kNsMask;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[s][r] = cmul(v[s][r], tw[(p * r) << (LOG_N2 - LOG_NS - kLogR)]);
      }
    }
    dft_r<R>(v[s]);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int slot = static_cast<int>(threadIdx.x) + s * kThreads;
    const int col = slot & kColsMask;
    const int j = slot >> LOG_COLS;
    const int base = ((j >> LOG_NS) << (LOG_NS + kLogR)) + (j & kNsMask);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = base + (r << LOG_NS);
      buf[k * LD + col] = post(v[s][r], k, col);
    }
  }
  __syncthreads();
}

// The stages of a length-2^LOG_LEN FFT after its first, radix-16 one:
// radix 2^(LOG_LEN-4) (<= 16), or 16 and then 2 at 512 points.
template <int kThreads, int LOG_COLS, int LD, int LOG_LEN, int LOG_N2, class Post>
__device__ __forceinline__ void later_stages(float2* buf, const float2* tw, const Post& post) {
  if constexpr (LOG_LEN <= 8) {
    stage<kThreads, (1 << (LOG_LEN - 4)), LOG_COLS, LD, LOG_LEN, 4, LOG_N2>(buf, tw, post);
  } else {
    stage<kThreads, 16, LOG_COLS, LD, LOG_LEN, 4, LOG_N2>(buf, tw, NoPost{});
    stage<kThreads, (1 << (LOG_LEN - 8)), LOG_COLS, LD, LOG_LEN, 8, LOG_N2>(buf, tw, post);
  }
}

// Threads and the blocks an SM must hold, per half length 2^LOG_M.
template <int LOG_M>
struct Shape {
  static constexpr Plan p = dftmap::plan(LOG_M);
  static constexpr int kThreads = dftmap::threads(p);
  static constexpr int kMinBlocks = kThreads == 256 ? 3 : 1;
};

template <int LOG_M>
__global__ void __launch_bounds__(Shape<LOG_M>::kThreads, Shape<LOG_M>::kMinBlocks)
dftspec_kernel(const float* __restrict__ x, const float* __restrict__ unc,
               const float* __restrict__ uns, const float* __restrict__ mean,
               const float* __restrict__ stdev, float* __restrict__ out, int64_t npad) {
  constexpr Plan p = Shape<LOG_M>::p;
  constexpr int kThreads = Shape<LOG_M>::kThreads;
  static_assert(p.n1 >= 128 && p.n1 <= 256 && p.n2 <= 512 && p.n2 <= kThreads,
                "stage plan and halo need 128 <= n1 <= 256, n2 <= 512 and n2 <= threads");
  extern __shared__ float4 smem_raw[];
  float2* const a = reinterpret_cast<float2*>(smem_raw);  // p.e: T, then X
  float2* const b = a + p.e;                              // n2 ldb: Z
  float2* const tlo = b + p.n2 * p.ldb;                   // W_m^q, q < n1
  float2* const thi = tlo + p.n1;                         // W_n2^q, q < n2

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row = blockIdx.x >> p.log_g;
  const int tid = threadIdx.x;
  constexpr int64_t m = int64_t{1} << LOG_M;

  // 1 + pass 1's first radix-16 stage: thread = (column, slot j < n1/16),
  // its 16 loads straight from device memory; the twiddle tables are formed
  // while they are in flight
  {
    const int col = tid & (p.c - 1);
    const int j = tid >> p.log_c;
    const float2* xr = reinterpret_cast<const float2*>(x) + row * m;
    const int j2 = (rank << p.log_c) + col;
    float2 v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      v[r] = __ldg(xr + (((j + r * (p.n1 / 16)) << p.log_n2) + j2));
    }
    constexpr float inv_m = 1.f / static_cast<float>(m);  // powers of two: exact
    for (int t = tid; t < p.n1; t += kThreads) {
      float sn, cs;
      sincospif(static_cast<float>(2 * t) * inv_m, &sn, &cs);
      tlo[t] = make_float2(cs, -sn);
    }
    constexpr float inv_n2 = 1.f / static_cast<float>(p.n2);
    for (int t = tid; t < p.n2; t += kThreads) {
      float sn, cs;
      sincospif(static_cast<float>(2 * t) * inv_n2, &sn, &cs);
      thi[t] = make_float2(cs, -sn);
    }
    dft16(v);
#pragma unroll
    for (int r = 0; r < 16; ++r) a[((j * 16 + r) << p.log_c) + col] = v[r];
  }
  __syncthreads();
  // 2. pass 1's other stages; the last one applies W_m^(j2 k1)
  later_stages<kThreads, p.log_c, p.c, p.log_n1, p.log_n2>(
      a, thi, StepTwiddle<p.log_n1>{tlo, thi, rank << p.log_c});

  // 3. every CTA's T is complete: gather this CTA's k1 rows
  cluster.sync();
  {
    // every remote load issued before the first store (the compiler cannot
    // tell A and B apart, so it would not move a load above a store)
    float2 v[kPer];
    int dst[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int k1, j2, src, off;
      dftmap::gather(p, rank, tid + i * kThreads, k1, j2, dst[i]);
      dftmap::t_home(p, k1, j2, src, off);
      v[i] = *cluster.map_shared_rank(a + off, src);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) b[dst[i]] = v[i];
  }
  __syncthreads();

  // 4. pass 2
  stage<kThreads, 16, p.log_h, p.ldb, p.log_n2, 0, p.log_n2>(b, thi, NoPost{});
  later_stages<kThreads, p.log_h, p.ldb, p.log_n2, p.log_n2>(b, thi, NoPost{});

  // 5. every CTA's Z is complete (and nobody reads A any more): X[k] =
  // untwist(Z[k], Z[m-k]) into A, the mirror from the CTA that holds it.
  // The halo (X of the bin below each k2 row's first, one a thread: n2 <=
  // threads) and the Nyquist bin's Z: their loads go out with the first
  // batch's, and their X waits in registers until B is free.
  cluster.sync();
  const auto z_at = [&](int k1, int k2) {
    int r, off;
    dftmap::z_home(p, k1, k2, r, off);
    return *cluster.map_shared_rank(b + off, r);
  };
  const int k1_0 = rank << p.log_h;
  const bool has_halo = tid < p.n2 && (k1_0 > 0 || tid > 0);  // X[-1] = 0
  float2 hz = make_float2(0.f, 0.f), hzm = hz;
  float hc = 0.f, hs = 0.f;
  if (has_halo) {
    int k1p, k2p, k1m, k2m;
    dftmap::prev(p, k1_0, tid, k1p, k2p);
    dftmap::mirror(p, k1p, k2p, k1m, k2m);
    const int k = k1p + (k2p << p.log_n1);
    hz = z_at(k1p, k2p);
    hzm = z_at(k1m, k2m);
    hc = __ldg(unc + k);
    hs = __ldg(uns + k);
  }
  const bool has_nyq = rank == dftmap::nyquist_rank(p) && tid == 0;
  float2 z0 = make_float2(0.f, 0.f);
  if (has_nyq) z0 = z_at(0, 0);
  // kBatch elements at a time, their loads issued before their stores
  constexpr int kBatch = kPer / 2;
#pragma unroll
  for (int i0 = 0; i0 < kPer; i0 += kBatch) {
    float2 zk[kBatch], zm[kBatch];
    float c[kBatch], s[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = tid + (i0 + i) * kThreads;
      int k1, k2, k1m, k2m;
      dftmap::out_elem(p, rank, e, k1, k2);
      dftmap::mirror(p, k1, k2, k1m, k2m);
      const int k = k1 + (k2 << p.log_n1);
      zk[i] = b[k2 * p.ldb + (e & (p.h - 1))];
      zm[i] = z_at(k1m, k2m);
      c[i] = __ldg(unc + k);
      s[i] = __ldg(uns + k);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      a[tid + (i0 + i) * kThreads] = interbin::untwist_values(zk[i], zm[i], c[i], s[i]);
    }
  }
  const float2 hx = has_halo ? interbin::untwist_values(hz, hzm, hc, hs) : make_float2(0.f, 0.f);
  float2 xnyq = make_float2(0.f, 0.f);
  if (has_nyq) xnyq = interbin::untwist_values(z0, z0, __ldg(unc + m), __ldg(uns + m));

  // 6. no CTA reads another's shared memory past this barrier, so each may
  // finish and exit; B takes the halos
  cluster.sync();
  float2* const halo = b;
  if (tid < p.n2) halo[tid] = hx;
  __syncthreads();
  const float mu = mean[row], sd = stdev[row];
  float* orow = out + row * npad;
#pragma unroll 4
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    int k1, k2;
    dftmap::out_elem(p, rank, e, k1, k2);
    const float2 xl = (e & (p.h - 1)) ? a[e - 1] : halo[k2];
    orow[k1 + (k2 << p.log_n1)] = interbin::interbin_value(a[e], xl, mu, sd);
  }
  if (has_nyq) {
    orow[m] = interbin::interbin_value(xnyq, a[p.e - 1], mu, sd);
  }
  for (int64_t k = m + 1 + rank * kThreads + tid; k < npad; k += p.g * kThreads) {
    orow[k] = 0.f;
  }
}

template <int LOG_M>
int launch(const float* x, const float* unc, const float* uns, const float* mean,
           const float* stdev, float* out, int64_t rows, int64_t npad,
           cudaStream_t stream) {
  constexpr Plan p = Shape<LOG_M>::p;
  const auto kernel = dftspec_kernel<LOG_M>;
  const int smem = static_cast<int>(dftmap::smem_bytes(p));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && p.g > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * p.g));
  cfg.blockDim = dim3(Shape<LOG_M>::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.g);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, unc, uns, mean, stdev, out, npad);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, 2 m) f32, 8-byte aligned; unc, uns (m+1,) the untwist tables;
// mean, stdev (rows,); out (rows, npad) f32, npad > m. One launch on
// `stream`: a cluster of dftmap::plan(log2 m).g CTAs a row.
extern "C" int dft_untwist_interbin(const void* x, const void* unc, const void* uns,
                                    const void* mean, const void* stdev, void* out,
                                    long long rows, int m, long long npad,
                                    void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  int log_m = 0;
  while ((1 << log_m) < m) ++log_m;
  if ((1 << log_m) != m || !dftmap::supported(log_m) || npad <= m ||
      rows * dftmap::plan(log_m).g > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const float*>(x);
  const auto* c = static_cast<const float*>(unc);
  const auto* s = static_cast<const float*>(uns);
  const auto* mu = static_cast<const float*>(mean);
  const auto* sd = static_cast<const float*>(stdev);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (log_m) {
    case 14: return launch<14>(xs, c, s, mu, sd, o, rows, npad, st);
    case 15: return launch<15>(xs, c, s, mu, sd, o, rows, npad, st);
    case 16: return launch<16>(xs, c, s, mu, sd, o, rows, npad, st);
    default: return launch<17>(xs, c, s, mu, sd, o, rows, npad, st);
  }
}
