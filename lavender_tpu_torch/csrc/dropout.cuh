// Counter-based dropout bits: bits = H(seed, stream, index), one uint32 per
// element, the same function as lavender_tpu_torch/ops/dropout.py computes
// in PyTorch (so a kernel and its plain version draw the same mask).
//
// The TPU kernels drew their bits from the core's own generator
// (pltpu.prng_random_bits, seeded per grid step), which the card has no
// counterpart of.  Here every element's bits are a hash of its coordinates,
// so a backward pass regenerates the forward's mask from the seed alone and
// any thread may draw any element in any order:
//
//   key(seed, stream) = fmix32(fmix32(seed ^ kSeedSalt) ^ stream * kStreamMul)
//   bits(key, index)  = fmix32(key ^ index * kIndexMul)
//
// fmix32 is MurmurHash3's 32-bit finaliser (a bijection with full avalanche);
// products wrap modulo 2^32.  The stream is (sequence, head) for attention
// probabilities and the row for hidden activations; the index is the
// position inside it.  Keep rule (the JAX kernels'): keep iff
// bits >= min(floor(rate * 2^32), 2^32 - 1), kept values scaled by
// 1 / (1 - rate).
#pragma once

#include <stdint.h>

namespace lvt {

constexpr uint32_t kSeedSalt = 0x3C6EF372u;
constexpr uint32_t kStreamMul = 0x85EBCA77u;
constexpr uint32_t kIndexMul = 0x9E3779B9u;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The key of one stream; ``seed`` is the low 32 bits of the int64 seed.
__host__ __device__ __forceinline__ uint32_t dropout_key(uint32_t seed, uint32_t stream) {
  return fmix32(fmix32(seed ^ kSeedSalt) ^ (stream * kStreamMul));
}

__host__ __device__ __forceinline__ uint32_t dropout_bits(uint32_t key, uint32_t index) {
  return fmix32(key ^ (index * kIndexMul));
}

// The attention stream of head h of sequence seq on a call that holds heads
// head0 .. head0 + nH - 1 of heads_total (a tensor-parallel rank's own
// heads): seq * heads_total + head0 + h, so that each rank draws what one
// process draws for those heads.  With head0 = 0 and heads_total = nH it is
// seq * nH + h.
__host__ __device__ __forceinline__ uint32_t attention_stream(int seq, int h, int head0,
                                                              int heads_total) {
  return (uint32_t)seq * (uint32_t)heads_total + (uint32_t)(head0 + h);
}

}  // namespace lvt
