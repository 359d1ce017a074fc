// Packed half-length DFT Z (from cuFFT) -> untwist -> interbin amplitude ->
// (s - mean) / std, zero past the Nyquist bin m.
//
// Replaces the TPU kernel
// peasoup_tpu/ops/pallas/interbin.py:untwist_interbin_normalise (its plain
// twin is ops/fft.py:rfft_pow2_matmul_parts + ops/spectrum.py:
// form_interpolated_parts + normalise).
//
// What bounds it on the H100: bytes (about 12 B a bin for some thirty
// flops). The kernel and its design are in interbin.cuh, which dftspec.cu
// shares as its epilogue.

#include "interbin.cuh"

extern "C" int untwist_interbin_normalise(const void* z, const void* unc,
                                          const void* uns, const void* mean,
                                          const void* stdev, void* out,
                                          long long rows, long long m,
                                          long long npad, void* stream) {
  return interbin::launch(
      static_cast<const float2*>(z), static_cast<const float*>(unc),
      static_cast<const float*>(uns), static_cast<const float*>(mean),
      static_cast<const float*>(stdev), static_cast<float*>(out), rows, m,
      npad, static_cast<cudaStream_t>(stream));
}
