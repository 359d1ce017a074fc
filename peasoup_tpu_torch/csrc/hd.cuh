// Marks the functions that nvcc compiles for the card and for the host
// alike, and that a plain C++ compiler (g++) compiles for the host: the
// level function, the cluster walk's step, the DFT's ownership maps,
// interbin's mirror pairs, dedisperse's windows and packed sums, spchain's
// ring, sweep and winner rule and peaks' mask lanes, which the CPU tests
// build into a small shared library of their own.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define PEASOUP_HD __host__ __device__ __forceinline__
#define PEASOUP_UNROLL _Pragma("unroll")
#else
#define PEASOUP_HD inline
#define PEASOUP_UNROLL
#endif

// the set bits of a word, on the card and on the host
PEASOUP_HD int popcount32(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}
