// The device side of the prefix-sum ring that spchain.cu and boxcar.cu
// stream their rows through (the geometry is spchain_map.cuh's): the
// mbarriers a slot completes and is released on, the TMA bulk copy that
// fills a slot, and a tile's window into the ring. Card only.

#pragma once

#include <cstdint>

#include "spchain_map.cuh"

namespace tma {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` from global src into shared dst, completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// a tile's window: prefix sum t0 + o at ring[ring_at(s, o)]; contiguous
// (p = the first chunk's slot) or wrapping round the ring's end
template <bool WRAP>
struct Window;

template <>
struct Window<false> {
  const float* p;
  __device__ Window(const float* ring, int s, int) : p(ring + s * spmap::kChunk) {}
  __device__ __forceinline__ float4 operator()(int o) const {
    return *reinterpret_cast<const float4*>(p + o);
  }
  __device__ __forceinline__ float at(int o) const { return p[o]; }
};

template <>
struct Window<true> {
  const float* ring;
  int s, slots;
  __device__ Window(const float* r, int s_, int n) : ring(r), s(s_), slots(n) {}
  // a float4 never straddles the end: the ring and o are multiples of 4
  __device__ __forceinline__ float4 operator()(int o) const {
    return *reinterpret_cast<const float4*>(ring + spmap::ring_at(s, o, slots, true));
  }
  __device__ __forceinline__ float at(int o) const { return ring[spmap::ring_at(s, o, slots, true)]; }
};

// a width bank in shared memory, read a width and its scale at a time
struct BankAt {
  const spmap::Width* b;
  __device__ __forceinline__ spmap::Width operator()(int k) const { return b[k]; }
};

}  // namespace tma
