// peaks.cu's first phase, lane by lane: which bins a lane reads of a level
// and where its crossings land in the mask. peaks.cu and the CPU tests'
// host build (tests/test_torch_kernel_host.py) compile this one copy.
//
// A warp takes a span of kSpan = 128 neighbouring bins (harmpeaks' span, so
// the two kernels' masks and walks are one), lane l its bins 4l .. 4l + 3
// as one float4 of each level whose window they meet. Bit j of the lane's
// nibble is bin 4l + j's crossing, v * scale > thr, the plain version's
// f32 product. Word w of the span's four is the nibbles of lanes 8w ..
// 8w + 7, lane 8w + i's at bits 4i .. 4i + 3: mask word 4q + w (bit b is bin
// 32 (4q + w) + b), as harmpeaks.cu lays it out.

#pragma once

#include <cstdint>

#include "hd.cuh"
#include "levels.cuh"

namespace pkmap {

using harm::kSpan;

PEASOUP_HD int lane_bin(int q, int lane) { return q * kSpan + 4 * lane; }
PEASOUP_HD bool lane_reads(int b, int lo, int hi) { return b + 4 > lo && b < hi; }
PEASOUP_HD uint32_t nibble(float v0, float v1, float v2, float v3, float sc, float thr) {
  return static_cast<uint32_t>(v0 * sc > thr) | static_cast<uint32_t>(v1 * sc > thr) << 1 |
         static_cast<uint32_t>(v2 * sc > thr) << 2 | static_cast<uint32_t>(v3 * sc > thr) << 3;
}
PEASOUP_HD uint32_t word_bits(uint32_t nib, int lane) { return nib << (4 * (lane & 7)); }
PEASOUP_HD int lane_word(int q, int lane) { return 4 * q + (lane >> 3); }
// whether word wi holds a bin of [lo, hi): phase A stores exactly those
PEASOUP_HD bool word_meets(int wi, int lo, int hi) { return wi * 32 < hi && wi * 32 + 32 > lo; }

}  // namespace pkmap
