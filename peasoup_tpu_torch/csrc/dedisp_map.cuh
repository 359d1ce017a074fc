// The index maps and the packed-integer arithmetic of dedisperse.cu.
// dedisperse.cu and the CPU tests' host build (tests/test_torch_kernel_host.py,
// which stages and sums every block of a launch on the host and checks that
// each (trial, sample, channel) read lands inside the staged window and
// reads x[t + delay, c]) compile this one copy.
//
// A block owns kTrials DM trials and kTile output samples t0 .. t0+kTile-1.
// The channels go in chunks of 2^log_chunk (at most 16) neighbouring
// channels of the row, each starting on a multiple of its width; only the
// chunks that hold a kept channel are walked, and each carries the mask of
// its kept channels. For a chunk the host gives lo, the least delay of the
// block's trials over the chunk's kept channels, and spread, the largest
// less lo; each trial's delay on each kept channel of the chunk arrives as
// rel = delay - lo, 16 bits. The block stages the input rows t0 + lo .. t0
// + lo + window_rows(spread) - 1 of the chunk's channels channel-major in
// shared memory (one row of bytes a channel, pitch_words 32-bit words
// apart; a killed channel's row is staged where that costs nothing and is
// never read), so the samples t .. t+3 of one channel for one trial are the
// four bytes at window offset (t - t0) + rel. Thread tid sums the samples
// group_sample(tid, g) .. + 3 of each group g: consecutive lanes read
// consecutive words, and a warp's rel, hence its byte shift, is one value.

#pragma once

#include <cmath>
#include <cstdint>

#include "hd.cuh"

namespace ddmap {

constexpr int kThreads = 256;
constexpr int kGroups = 2;                        // groups of 4 samples a thread
constexpr int kTile = 4 * kThreads * kGroups;     // output samples a block
constexpr int kTrials = 16;                       // DM trials a block
constexpr int kRecs = kTrials / 8;                // 16-byte records a channel
constexpr int kMaxLogChunk = 4;                   // at most 16 channels a chunk
constexpr int kLaneChannels = 256;  // channels a 16-bit lane holds: 256 * 255 < 2^16

// input rows a chunk's window stages: every sample a thread reads, and the
// word after its last
PEASOUP_HD int window_rows(int spread) { return kTile + spread + 4; }

// 32-bit words from one channel's row of the window to the next: odd, so
// the staging's byte stores of one input row (one channel a lane) fall in
// distinct banks
PEASOUP_HD int pitch_words(int max_spread) { return ((window_rows(max_spread) + 3) / 4) | 1; }

// the staging loop's element idx -> (channel in the chunk, window row)
PEASOUP_HD void stage_coords(int idx, int log_chunk, int& cl, int& r) {
  cl = idx & ((1 << log_chunk) - 1);
  r = idx >> log_chunk;
}

// the first of the four output samples of thread tid's group g, from t0
PEASOUP_HD int group_sample(int tid, int g) { return 4 * tid + 4 * kThreads * g; }

// the window word holding the first of those samples at relative delay
// rel, (group_sample(tid, g) + rel) / 4 written so that the groups of one
// trial differ by a constant, and the right shift (taken mod 32 by funnel)
// that brings that sample to the low byte of the word pair
PEASOUP_HD int read_word(int tid, int g, int rel) { return tid + kThreads * g + (rel >> 2); }
PEASOUP_HD int read_shift(int rel) { return rel << 3; }

// the 4 bytes starting (shift mod 32) bits into the word pair (lo, hi)
PEASOUP_HD uint32_t funnel(uint32_t lo, uint32_t hi, int shift) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, shift);
#else
  return static_cast<uint32_t>(((static_cast<uint64_t>(hi) << 32) | lo) >> (shift & 31));
#endif
}

// bytes 0 and 2 (samples t, t+2), and bytes 1 and 3 (t+1, t+3), each in a
// 16-bit lane, so one 32-bit add sums two samples
PEASOUP_HD uint32_t even_lanes(uint32_t b) { return b & 0x00FF00FFu; }
PEASOUP_HD uint32_t odd_lanes(uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(b, 0u, 0x4341);  // bytes 1, 3 of b, zeros from the second word
#else
  return (b >> 8) & 0x00FF00FFu;
#endif
}

// relative delay i (0..kTrials-1) of a channel's record of kTrials u16
PEASOUP_HD int rel_of(const uint32_t* rec, int i) {
  return static_cast<int>((rec[i >> 1] >> (16 * (i & 1))) & 0xFFFFu);
}

// __byte_perm: byte n of the result is byte (s >> 4n) & 7 of the pair
// (x, y), x bytes 0-3 and y bytes 4-7
PEASOUP_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, y, s);
#else
  const uint64_t xy = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) r |= static_cast<uint32_t>((xy >> (8 * ((s >> (4 * n)) & 7))) & 0xFFu) << (8 * n);
  return r;
#endif
}

// A chunk staged by 16-byte loads (wide_staging) is staged a quad of rows
// at a time: one 16-byte load per row, then the 4x4
// byte transpose of each 4-channel word of the four rows gives, per
// channel, one window word of four consecutive samples. a_u holds channels
// 4g..4g+3 of row u; out[i] the rows 0..3 of channel 4g+i.
PEASOUP_HD void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t out[4]) {
  const uint32_t t0 = byte_perm(a0, a1, 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
  const uint32_t t1 = byte_perm(a2, a3, 0x5140);
  const uint32_t t2 = byte_perm(a0, a1, 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
  const uint32_t t3 = byte_perm(a2, a3, 0x7362);
  out[0] = byte_perm(t0, t1, 0x5410);
  out[1] = byte_perm(t0, t1, 0x7632);
  out[2] = byte_perm(t2, t3, 0x5410);
  out[3] = byte_perm(t2, t3, 0x7632);
}

// The sums of one output sample, scaled, rounded half to even and clipped
// to u8 as the plain version does.
PEASOUP_HD uint8_t quantise(uint32_t sum, float scale, int apply_scale) {
  float v = static_cast<float>(sum);
  if (apply_scale) v = v * scale;
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

// The output tile. Thread tid packs the four samples of its group g of
// trial i into word i * kTileWords + out_word(tid, g) of shared memory; a
// trial's row then goes out as aligned 32-bit words: with G the global
// byte address of the row's first sample, its first head_bytes(G) bytes
// and the bytes past the last whole word one byte a thread, the words
// between one word a thread.
constexpr int kTileWords = kTile / 4;
PEASOUP_HD int out_word(int tid, int g) { return group_sample(tid, g) / 4; }
PEASOUP_HD int head_bytes(int64_t g_addr) { return static_cast<int>((4 - (g_addr & 3)) & 3); }

// a chunk staged by 16-byte loads: 16 channels wide, each row of nchans
// (a multiple of 16) bytes starting on a 16-byte boundary of the input at
// x; any other chunk is staged a byte at a time
PEASOUP_HD bool wide_staging(int log_chunk, int nchans, uintptr_t x) {
  return log_chunk == kMaxLogChunk && nchans % 16 == 0 && (x & 15u) == 0;
}

// the lowest set bit of a non-zero mask: the next kept channel of a chunk
PEASOUP_HD int low_bit(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

}  // namespace ddmap
