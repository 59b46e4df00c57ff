// threefry2x32 and the walk's counter-based words, on the card.
//
// Device twin of repro_torch/core/prng.py (threefry2x32, fold_in, bits),
// which reproduces jax.random's threefry2x32 in its partitionable mode bit
// for bit; here in native uint32 arithmetic, where prng.py holds each word
// in int64 masked to 32 bits.  Shared by walk_bits.cu (the chunk's whole
// word table, the card's counterpart of core/walk._chunk_rbits) and
// walk_steps_fused.cu (the words drawn in registers, per walker).
//
// The walk's words: step s of the chunk, walker element i, column c draws
//   walk_word(fold_in(key, step_base + s), 4 * i + c)
// which is bits(fold_in(key, step_base + s), (w, 4))[i, c]: jax's bits
// hashes each element's row-major flat index (hi, lo) and returns y0 ^ y1.

#pragma once

#include <stdint.h>

namespace pixie {

constexpr uint32_t kThreefryParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One round: x0 += x1; x1 = rotl(x1, r) ^ x0.
template <int R>
__device__ __forceinline__ void threefry_mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = rotl32(x1, R) ^ x0;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1) {
  threefry_mix<R0>(x0, x1);
  threefry_mix<R1>(x0, x1);
  threefry_mix<R2>(x0, x1);
  threefry_mix<R3>(x0, x1);
}

// The 20-round threefry2x32 block function of key k on (x0, x1): five
// groups of four rounds, rotations (13, 15, 26, 6) and (17, 29, 16, 24) in
// turn, key schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA), after group i
// x0 += ks[(i + 1) % 3] and x1 += ks[(i + 2) % 3] + (i + 1).
__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t ks0 = k.x;
  const uint32_t ks1 = k.y;
  const uint32_t ks2 = k.x ^ k.y ^ kThreefryParity;
  x0 += ks0;
  x1 += ks1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += ks1;
  x1 += ks2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += ks2;
  x1 += ks0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += ks0;
  x1 += ks1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += ks1;
  x1 += ks2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += ks2;
  x1 += ks0 + 5u;
  return make_uint2(x0, x1);
}

// jax.random.fold_in(k, d): threefry2x32(k, (0, d)) is the new key.
__device__ __forceinline__ uint2 fold_in(uint2 k, uint32_t d) {
  return threefry2x32(k, 0u, d);
}

// Element idx of jax.random.bits(step_key, shape) (row-major flat index):
// y0 ^ y1 of threefry2x32(step_key, (idx >> 32, idx & 0xFFFFFFFF)).
__device__ __forceinline__ uint32_t walk_word(uint2 step_key, uint64_t idx) {
  const uint2 y = threefry2x32(step_key, static_cast<uint32_t>(idx >> 32),
                               static_cast<uint32_t>(idx));
  return y.x ^ y.y;
}

// The four words of walker element i at one step (columns 0..3: restart,
// bias, board pick, pin pick), as one uint4.
__device__ __forceinline__ uint4 walk_words(uint2 step_key, uint32_t i) {
  const uint64_t base = 4ull * i;
  return make_uint4(walk_word(step_key, base), walk_word(step_key, base + 1),
                    walk_word(step_key, base + 2),
                    walk_word(step_key, base + 3));
}

}  // namespace pixie
