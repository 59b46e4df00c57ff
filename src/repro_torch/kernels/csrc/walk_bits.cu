// walk_bits: one walk chunk's counter-based random words, in one launch.
//
// The card's counterpart of core/walk._chunk_rbits (the reference's
// src/repro/core/walk.py :: _chunk_rbits, which draws them with
// jax.random; no Pallas kernel): out[s, g, c] = walk_word(fold_in(keys[q],
// step_base + s), 4 * i + c) with q = g / walkers_per_key and
// i = g - q * walkers_per_key, the uint32 words as int32 bit patterns.
// One key (per-query mode) is walkers_per_key = n; per-query keys
// (batch-native mode) lay their walkers out query-major.  Plain twin:
// repro_torch/core/walk.py :: _chunk_rbits.
//
// The sharded engine draws its chunk's table here: it needs the restart
// column in torch for its kill and inject logic, and its hop kernel
// (walk_hop.cu) reads each hop's word from the table.  The dense and event
// walks draw their words inside walk_steps_fused.cu instead.
//
// What bounds it on an H100: integer issue.  Each (step, walker) costs
// five threefry2x32 blocks (the step key and four words, ~80 32-bit
// operations each) against 16 bytes written; the table of a chunk is a
// megabyte.  Design: one thread per (walker, step), the four words stored
// as one 16-byte store, neighbouring threads on neighbouring walkers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__global__ void walk_bits_kernel(const uint2* __restrict__ keys,
                                 int walkers_per_key, uint32_t step_base,
                                 int n, uint4* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int s = blockIdx.y;
  const int q = g / walkers_per_key;
  const uint32_t i = static_cast<uint32_t>(g - q * walkers_per_key);
  const uint2 step_key = pixie::fold_in(keys[q], step_base + s);
  out[static_cast<size_t>(s) * n + g] = pixie::walk_words(step_key, i);
}

}  // namespace

// keys: (n / walkers_per_key, 2) uint32 words; out: (chunk_steps, n, 4)
// int32, 16-byte aligned.  step_base is already wrapped to uint32.
// Returns cudaGetLastError().
extern "C" int walk_bits_launch(const void* keys, int walkers_per_key,
                                uint32_t step_base, int chunk_steps, int n,
                                void* out, void* stream) {
  constexpr int kBlock = 128;
  if (n > 0 && chunk_steps > 0) {
    const dim3 grid((n + kBlock - 1) / kBlock, chunk_steps);
    walk_bits_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(keys), walkers_per_key, step_base, n,
        static_cast<uint4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
