// Counter-based dropout keep bits shared by every attention kernel and the
// mask kernel.
//
// Replaces the TPU's tile-keyed PRNG (`_keep_mask`,
// interactron_tpu/ops/flash_attention.py:71), which seeds the hardware
// generator per (seed, head, q-block, k-block) tile and so forces one block
// size on every pass. Here the bit of element (row, col) of head bh
// (= b*H + h) is a pure function of (seed, bh, row, col): three rounds of
// murmur3's 32-bit finaliser, which uses only multiply-low, xor and shift,
// so ops/flash_attention.py::_hash_bits computes the same bits in int64
// torch arithmetic. The row part is hashed once per row; an element costs
// one multiply and one finaliser. Kept iff bits >= threshold, with
// threshold = min(int(rate * 2^32), 2^32 - 1): P(keep) = 1 - rate to 2^-32.
#pragma once

#include <cstdint>

namespace ipt {

constexpr uint32_t kSeedSalt = 0x6A09E667u;
constexpr uint32_t kMixBh = 0x9E3779B9u;
constexpr uint32_t kMixRow = 0x85EBCA77u;
constexpr uint32_t kMixCol = 0xC2B2AE3Du;

// murmur3's 32-bit finaliser after its first xor-shift
__host__ __device__ __forceinline__ uint32_t fmix32_tail(uint32_t h) {
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  return fmix32_tail(h ^ (h >> 16));
}

// the per-(head, row) part of the hash
__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t bh, uint32_t row) {
  return fmix32(fmix32((seed ^ kSeedSalt) + bh * kMixBh) ^ (row * kMixRow));
}

__device__ __forceinline__ uint32_t keep_bits(uint32_t rkey, uint32_t col) {
  return fmix32(rkey ^ (col * kMixCol));
}

// keep_bits with fmix32's first xor-shift split over the xor (a logical
// shift distributes over it): keep_bits(rkey, col) ==
// keep_bits_mixed(rkey ^ (rkey >> 16), col * kMixCol). A caller that holds
// the row's part saves one op an element (the mask kernel).
__device__ __forceinline__ uint32_t keep_bits_mixed(uint32_t rmix, uint32_t cm) {
  return fmix32_tail(rmix ^ cm ^ (cm >> 16));
}

// The dropout arguments every attention kernel takes.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv;  // 1 / (1 - rate)
  int on;     // rate > 0

  __device__ __forceinline__ bool keep(uint32_t rkey, uint32_t col) const {
    return keep_bits(rkey, col) >= threshold;
  }
  // x * keep / (1 - rate), or x when dropout is off
  __device__ __forceinline__ float apply(float x, uint32_t rkey, uint32_t col) const {
    return on ? (keep(rkey, col) ? x * inv : 0.f) : x;
  }
};

}  // namespace ipt
