// Four-step DFT of the packed real series, then untwist + interbin +
// normalise: the normalised interbin spectrum of each row, computed from the
// time series with no FFT library.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/dftspec.py:dft_untwist_interbin (the JAX package
// holds it to the exact einsum chain ops/fft.py:rfft_pow2_matmul_parts ->
// ops/spectrum.py:form_interpolated_parts -> normalise; the plain version
// here is ops/fft.py:packed_dft_z + untwist_interbin_normalise_plain).
//
// Input: x (R, n) f32 rows. z[j] = x[2j] + i x[2j+1], the packed complex
// series of length m = n/2 = n1*n2 (n1 the power of two at or below
// sqrt(m)), is read in place as interleaved complex. With j = j1*n2 + j2 and
// bin k = k1 + n1*k2:
//   pass 1:   T[k1, j2] = W_m^(j2 k1) sum_j1 z[j1*n2 + j2] W_n1^(j1 k1)
//   pass 2:   Z[k1 + n1*k2] = sum_j2 T[k1, j2] W_n2^(j2 k2)
//   epilogue: interbin.cuh on Z (untwist, interbin, (s - mean) / std).
// W_L = e^(-2 pi i / L). Output (R, npad) f32: bins 0..m, zero past m.
//
// What bounds it on the H100: bytes. The TPU kernel keeps T and Z in VMEM;
// here both go through device memory: pass 1 reads x and writes T, pass 2
// reads T and writes Z, the epilogue reads Z and writes the spectrum, about
// 40 B a complex sample and 4 B an output bin, against 8 B and 4 B for a
// kernel that kept them on chip (fusing pass 2 with the epilogue is later
// work). The radix-2 FFTs do 5 log2(m) flops a sample, far below the card's
// f32 rate.
//
// Design: each sub-DFT is a radix-2 decimation-in-time FFT in shared memory,
// in f32 without FMA contraction, with twiddles from a table that the
// wrapper computes in f64 and rounds once. A block holds kTile complex
// values as C = kTile / L columns of length L, interleaved (element i of
// column c at a[i*C + c]), so that neighbouring threads touch neighbouring
// columns, in shared memory and in device memory alike. A pass-1 block takes
// C neighbouring j2 columns of one row, a pass-2 block C neighbouring k1 rows
// of that row's T; the bit reversal is applied as the block loads. The TPU
// kernel ran both stages as 3-pass bf16 matmuls on its matrix unit (XLA's
// Precision.HIGH class, ~1.5e-5 relative); the f32 FFT is more accurate
// (~1e-6), inside the JAX package's accuracy gate.

#include <cstdint>
#include <cuda_runtime.h>

#include "interbin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;   // complex values a block holds: 32 KB
constexpr int kMaxLen = 1024;  // longest sub-DFT (the wrapper gates m <= 2^17)

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int ilog2(int v) { return 31 - __clz(v); }

__device__ __forceinline__ int bitrev(int v, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// Radix-2 FFT of the `cols` interleaved columns of length `len` held in `a`
// in bit-reversed order; leaves them in natural order. wl[p] = W_len^p for
// p < len/2. Ends with a barrier.
__device__ void fft_columns(float2* a, const float2* wl, int len, int cols) {
  const int log_cols = ilog2(cols);
  const int log_len = ilog2(len);
  const int nbf = (len >> 1) << log_cols;
  for (int log_half = 0; log_half < log_len; ++log_half) {
    const int half = 1 << log_half;
    const int wshift = log_len - 1 - log_half;  // W_(2 half)^p = W_len^(p len / (2 half))
    for (int b = threadIdx.x; b < nbf; b += kThreads) {
      const int c = b & (cols - 1);
      const int q = b >> log_cols;
      const int p = q & (half - 1);
      const int i0 = ((q >> log_half) << (log_half + 1)) + p;
      const float2 w = wl[p << wshift];
      float2* lo = a + (i0 << log_cols) + c;
      float2* hi = lo + (half << log_cols);
      const float2 u = *lo;
      const float2 v = cmul(*hi, w);
      *lo = make_float2(u.x + v.x, u.y + v.y);
      *hi = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

// Block (row, column tile): C = kTile / n1 neighbouring j2 columns.
__global__ void __launch_bounds__(kThreads)
dft_pass1(const float2* __restrict__ z, const float2* __restrict__ tw,
          float2* __restrict__ t, int n1, int n2) {
  __shared__ float2 a[kTile];
  __shared__ float2 wl[kMaxLen / 2];
  const int cols = kTile / n1;
  const int log_cols = ilog2(cols);
  const int log_n1 = ilog2(n1);
  const int64_t m = static_cast<int64_t>(n1) * n2;
  const int64_t row = blockIdx.x;
  const int j2_0 = blockIdx.y * cols;
  const float2* zr = z + row * m;
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int c = e & (cols - 1);
    const int j1 = e >> log_cols;
    a[(bitrev(j1, log_n1) << log_cols) + c] =
        zr[static_cast<int64_t>(j1) * n2 + j2_0 + c];
  }
  for (int p = threadIdx.x; p < n1 / 2; p += kThreads) {
    wl[p] = tw[static_cast<int64_t>(p) * n2];  // W_n1^p = W_m^(p n2)
  }
  __syncthreads();
  fft_columns(a, wl, n1, cols);
  float2* tr = t + row * m;
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int c = e & (cols - 1);
    const int k1 = e >> log_cols;
    const int j2 = j2_0 + c;
    tr[static_cast<int64_t>(k1) * n2 + j2] =
        cmul(a[e], tw[static_cast<int64_t>(j2) * k1]);  // j2 k1 < m
  }
}

// Block (row, k1 tile): C = kTile / n2 neighbouring rows k1 of T.
__global__ void __launch_bounds__(kThreads)
dft_pass2(const float2* __restrict__ t, const float2* __restrict__ tw,
          float2* __restrict__ zout, int n1, int n2) {
  __shared__ float2 a[kTile];
  __shared__ float2 wl[kMaxLen / 2];
  const int cols = kTile / n2;
  const int log_cols = ilog2(cols);
  const int log_n2 = ilog2(n2);
  const int64_t m = static_cast<int64_t>(n1) * n2;
  const int64_t row = blockIdx.x;
  const int k1_0 = blockIdx.y * cols;
  const float2* tr = t + row * m + static_cast<int64_t>(k1_0) * n2;
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int j2 = e & (n2 - 1);
    const int c = e >> log_n2;
    a[(bitrev(j2, log_n2) << log_cols) + c] = tr[e];  // tr[c*n2 + j2]
  }
  for (int p = threadIdx.x; p < n2 / 2; p += kThreads) {
    wl[p] = tw[static_cast<int64_t>(p) * n1];  // W_n2^p = W_m^(p n1)
  }
  __syncthreads();
  fft_columns(a, wl, n2, cols);
  float2* zr = zout + row * m;
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    const int c = e & (cols - 1);
    const int k2 = e >> log_cols;
    zr[k1_0 + c + static_cast<int64_t>(n1) * k2] = a[e];
  }
}

bool pow2(int v) { return v > 1 && (v & (v - 1)) == 0; }

}  // namespace

// x (rows, 2 n1 n2) f32; tw (n1 n2,) complex64 W_m^p; unc, uns (m+1,) the
// untwist tables; mean, stdev (rows,); t, z (rows, n1 n2) complex64 scratch;
// out (rows, npad) f32. Three launches on `stream`.
extern "C" int dft_untwist_interbin(const void* x, const void* tw,
                                    const void* unc, const void* uns,
                                    const void* mean, const void* stdev,
                                    void* t, void* z, void* out,
                                    long long rows, int n1, int n2,
                                    long long npad, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (!pow2(n1) || !pow2(n2) || n1 > kMaxLen || n2 > kMaxLen ||
      n2 % (kTile / n1) != 0 || n1 % (kTile / n2) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t m = static_cast<int64_t>(n1) * n2;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* twc = static_cast<const float2*>(tw);
  auto* tc = static_cast<float2*>(t);
  auto* zc = static_cast<float2*>(z);
  dft_pass1<<<dim3(static_cast<unsigned>(rows), n2 / (kTile / n1)), kThreads, 0, s>>>(
      static_cast<const float2*>(x), twc, tc, n1, n2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dft_pass2<<<dim3(static_cast<unsigned>(rows), n1 / (kTile / n2)), kThreads, 0, s>>>(
      tc, twc, zc, n1, n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return interbin::launch(zc, static_cast<const float*>(unc),
                          static_cast<const float*>(uns),
                          static_cast<const float*>(mean),
                          static_cast<const float*>(stdev),
                          static_cast<float*>(out), rows, m, npad, s);
}
