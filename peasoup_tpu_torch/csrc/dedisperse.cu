// Incoherent dedispersion: out[d, t] = q(scale * sum_c kill[c] * x[c, t + delay[d, c]]).
//
// Replaces the TPU kernel peasoup_tpu/ops/pallas/dedisperse.py:dedisperse_pallas
// (its plain twin is ops/dedisperse.py:dedisperse_block).
//
// What bounds it on the H100: each output sample sums every channel, so at
// 2-bit survey input the work is 2*D*C operations per output sample against
// one byte in per (channel, sample) and one byte out per (trial, sample):
// at 64 channels the f32 adds, not the bytes, set the floor. The input rows
// are re-read once per DM trial tile, and L2 (50 MB) holds a channel's
// window across neighbouring trials.
//
// Design: one thread owns one output sample for kTrials DM trials, loops over
// the channels in ascending order (the reference's summation order, so the
// f32 sums of small integers are bitwise those of the plain version) and
// keeps the kTrials accumulators in registers. The filterbank arrives
// channel-major, so neighbouring threads read neighbouring times. Ragged
// edges (trials past D, samples past out_nsamps) are masked, not padded.
// Multiply and add stay separate (the build passes -fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTrials = 8;

__global__ void dedisperse_kernel(const uint8_t* __restrict__ x_ct,
                                  const int32_t* __restrict__ delays,
                                  const float* __restrict__ kill,
                                  uint8_t* __restrict__ out, int64_t t_in,
                                  int nchans, int ndm, int64_t out_nsamps,
                                  float scale, int apply_scale) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int d0 = blockIdx.y * kTrials;
  if (t >= out_nsamps) return;
  const int nd = min(kTrials, ndm - d0);
  float acc[kTrials];
#pragma unroll
  for (int i = 0; i < kTrials; ++i) acc[i] = 0.f;
  for (int c = 0; c < nchans; ++c) {
    const uint8_t* row = x_ct + static_cast<int64_t>(c) * t_in + t;
    const float k = kill[c];
#pragma unroll
    for (int i = 0; i < kTrials; ++i) {
      if (i < nd) {
        const int dl = delays[static_cast<int64_t>(d0 + i) * nchans + c];
        acc[i] = acc[i] + static_cast<float>(row[dl]) * k;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTrials; ++i) {
    if (i < nd) {
      float v = acc[i];
      if (apply_scale) v = v * scale;
      v = fminf(fmaxf(rintf(v), 0.f), 255.f);
      out[static_cast<int64_t>(d0 + i) * out_nsamps + t] = static_cast<uint8_t>(v);
    }
  }
}

}  // namespace

extern "C" int dedisperse_u8(const void* x_ct, const void* delays,
                             const void* kill, void* out, long long t_in,
                             int nchans, int ndm, long long out_nsamps,
                             float scale, int apply_scale, void* stream) {
  if (out_nsamps <= 0 || ndm <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((out_nsamps + kThreads - 1) / kThreads),
                  static_cast<unsigned>((ndm + kTrials - 1) / kTrials));
  dedisperse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x_ct), static_cast<const int32_t*>(delays),
      static_cast<const float*>(kill), static_cast<uint8_t*>(out), t_in,
      nchans, ndm, out_nsamps, scale, apply_scale);
  return static_cast<int>(cudaGetLastError());
}
