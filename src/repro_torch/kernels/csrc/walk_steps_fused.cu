// walk_steps_fused: chunk_steps Pixie walk supersteps for every walker,
// with the walk's random words drawn in the kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/walk_step.py
// :: walk_steps_fused (body _walk_steps_fused_kernel; the edge pick
// _pick_edge lives in pick_edge.cuh, shared with walk_hop.cu).
// Plain twins: repro_torch/kernels/walk_step.py :: walk_chunk_plain and
// walk_chunk_batched_plain (ports of kernels/ref.py walk_chunk_ref and
// walk_chunk_batched_ref), fed the table of core/walk._chunk_rbits for
// the same keys.
//
// Each superstep s, per walker g, with the uint32 words r0..r3 of
// walk_words(fold_in(key, step_base + s), i) (threefry.cuh; the key and
// element index i of walker g as walk_bits.cu gives them): restart at the
// query pin if r0 < alpha (unsigned); hop pin -> board -> pin, each hop
// picking start + (word & 0x7FFFFFFF) % span, where the span is the
// personalized feature subrange when r1 < beta (unsigned) and the
// subrange is non-empty, else the whole adjacency slice (r2 picks the
// board, r3 the pin); a dead end (degree 0 on either hop) sends the
// walker back to its query pin and emits an invalid event.  Emitted lanes,
// each (chunk_steps, w) int32, written coalesced along w: slot (sentinel
// n_slots), pin (0 when invalid), and optionally query (sentinel
// n_queries, batch-native mode) and local board (0 when invalid).
//
// What bounds it on an H100: the chain of dependent reads.  A step reads
// an offset pair, then a board target, then the board's offset pair, then
// a pin target, each waiting for the one before, each a random 32-byte
// sector of a multi-gigabyte CSR; the distinct bytes of a chunk are tiny
// next to 3.35 TB/s, so a walker's time is its chain length times the
// latency of one dependent read, and the card runs the walkers' chains
// side by side.  Design: one thread per walker, state in registers for
// the whole chunk, and a chain cut to what the data forces:
//   * no word table: the words are threefry2x32 in registers
//     (threefry.cuh).  A threefry block is a chain of ~70 dependent integer
//     operations, about as long as an L2 hit, so the draws are spread over
//     the reads every step makes: this step's pin word and the key two
//     steps on while the board is read, the next step's restart and bias
//     words while the board's row is read, its board word while the pin is
//     read.  The restart and bias decisions never wait, and no read waits
//     on more than about one block's chain (drawn all at once after the
//     step's first read, the draws sat on the chain whole: on restart
//     steps that read comes from registers);
//   * the query pin's offset pair (and its feature bounds) read once,
//     beside the lane loads: a restart step, or the step after a dead
//     end, starts from registers, three dependent reads instead of four;
//   * a hop's feature bounds are read beside its offset pair, not after.
// The TPU kernel's DMA double-buffering (the "dma" gather mode) has no
// counterpart: the GPU hides latency by running many walkers at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pick_edge.cuh"
#include "threefry.cuh"

namespace {

using pixie::kRMask;
using pixie::pick_edge_in;

// Threads per block: 32, 64 and 128 timed within 2% of each other on an
// H100 (PERF.md); 64 kept.
constexpr int kBlock = 64;

// Word c of walker element elem under step key sk (threefry.cuh).
__device__ __forceinline__ uint32_t word(uint2 sk, uint32_t elem, uint32_t c) {
  return pixie::walk_word(sk, 4ull * elem + c);
}

template <bool kBiased>
__global__ void walk_steps_fused_kernel(
    const int* __restrict__ curr, const int* __restrict__ query,
    const int* __restrict__ feat, const int* __restrict__ slot,
    const int* __restrict__ qid, const uint2* __restrict__ keys,
    int walkers_per_key, uint32_t step_base, int chunk_steps, int w,
    const int* __restrict__ p2b_off, const int* __restrict__ p2b_tgt,
    const int* __restrict__ b2p_off, const int* __restrict__ b2p_tgt,
    const int* __restrict__ p2b_fb, const int* __restrict__ b2p_fb,
    int fb_stride, int n_pins, int n_slots, int n_queries,
    uint32_t alpha_u32, uint32_t beta_u32,
    int* __restrict__ next, int* __restrict__ qev, int* __restrict__ sev,
    int* __restrict__ pev, int* __restrict__ bev) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= w) return;
  // the lane loads, all independent of each other
  int cur = curr[g];
  const int q = query[g];
  const int f = kBiased ? feat[g] : 0;
  const int sl = slot[g];
  const int qi = qid != nullptr ? qid[g] : 0;
  const int kq = g / walkers_per_key;
  const uint2 key = keys[kq];
  const uint32_t elem = static_cast<uint32_t>(g - kq * walkers_per_key);
  // the query pin's row, the same for this walker all chunk
  const int q_start = p2b_off[q];
  const int q_end = p2b_off[q + 1];
  int q_lo = 0, q_hi = 0;
  if (kBiased) {
    const int* fb = p2b_fb + static_cast<size_t>(q) * fb_stride + f;
    q_lo = fb[0];
    q_hi = fb[1];
  }
  // step 0's restart, bias and board words and the keys of steps 0 and 1,
  // drawn while those loads are in flight
  uint2 sk = pixie::fold_in(key, step_base);
  uint2 sk1 = pixie::fold_in(key, step_base + 1u);
  uint32_t r0 = word(sk, elem, 0), r1 = word(sk, elem, 1), r2 = word(sk, elem, 2);

  for (int s = 0; s < chunk_steps; ++s) {
    const size_t o = static_cast<size_t>(s) * w + g;
    const bool use_b = kBiased && r1 < beta_u32;
    const int pos = r0 < alpha_u32 ? q : cur;
    // hop 1: the row's offset pair (and feature bounds), from registers at
    // the query pin
    int start = q_start, end = q_end, lo = q_lo, hi = q_hi;
    if (pos != q) {
      start = p2b_off[pos];
      end = p2b_off[pos + 1];
      if (use_b) {
        const int* fb = p2b_fb + static_cast<size_t>(pos) * fb_stride + f;
        lo = fb[0];
        hi = fb[1];
      }
    }
    const int deg = end - start;
    const bool has_board = deg > 0;
    int board = n_pins;
    if (has_board) {
      board = p2b_tgt[pick_edge_in(start, deg, static_cast<int>(r2 & kRMask),
                                   use_b, lo, hi)];
    }
    // while the board is in flight: this step's pin word and the key two
    // steps on (straight-line code on every path, so the two chains
    // interleave)
    const uint32_t r3 = word(sk, elem, 3);
    const uint2 sk2 =
        pixie::fold_in(key, step_base + static_cast<uint32_t>(s + 2));
    // hop 2: the board's offset pair (and feature bounds)
    const int b_local = board - n_pins;
    int bstart = 0, bend = 0, blo = 0, bhi = 0;
    if (has_board) {
      bstart = b2p_off[b_local];
      bend = b2p_off[b_local + 1];
      if (use_b) {
        const int* fb = b2p_fb + static_cast<size_t>(b_local) * fb_stride + f;
        blo = fb[0];
        bhi = fb[1];
      }
    }
    // while that row is in flight: the next step's restart and bias words
    r0 = word(sk1, elem, 0);
    r1 = word(sk1, elem, 1);
    const int bdeg = bend - bstart;
    const bool ok = has_board && bdeg > 0;
    int pin = 0;
    if (ok) {
      pin = b2p_tgt[pick_edge_in(bstart, bdeg, static_cast<int>(r3 & kRMask),
                                 use_b, blo, bhi)];
    }
    // while the pin is in flight: the next step's board word
    r2 = word(sk1, elem, 2);
    sk = sk1;
    sk1 = sk2;
    cur = ok ? pin : q;
    sev[o] = ok ? sl : n_slots;
    pev[o] = ok ? pin : 0;
    if (qev != nullptr) qev[o] = ok ? qi : n_queries;
    if (bev != nullptr) bev[o] = ok ? b_local : 0;
  }
  next[g] = cur;
}

}  // namespace

// keys: (w / walkers_per_key, 2) uint32 words; step_base already wrapped to
// uint32.  qid/qev (batch-native mode), the two feature-bound tables
// (biased walk) and bev (board counting) may each be null.  Returns
// cudaGetLastError().
extern "C" int walk_steps_fused_launch(
    const int* curr, const int* query, const int* feat, const int* slot,
    const int* qid, const void* keys, int walkers_per_key,
    uint32_t step_base, int chunk_steps, int w, const int* p2b_off,
    const int* p2b_tgt, const int* b2p_off, const int* b2p_tgt,
    const int* p2b_fb, const int* b2p_fb, int fb_stride, int n_pins,
    int n_slots, int n_queries, uint32_t alpha_u32, uint32_t beta_u32,
    int* next, int* qev, int* sev, int* pev, int* bev, void* stream) {
  if (w > 0) {
    const int grid = (w + kBlock - 1) / kBlock;
    const auto* k = static_cast<const uint2*>(keys);
    auto* s = static_cast<cudaStream_t>(stream);
    if (p2b_fb != nullptr) {
      walk_steps_fused_kernel<true><<<grid, kBlock, 0, s>>>(
          curr, query, feat, slot, qid, k, walkers_per_key, step_base,
          chunk_steps, w, p2b_off, p2b_tgt, b2p_off, b2p_tgt, p2b_fb, b2p_fb,
          fb_stride, n_pins, n_slots, n_queries, alpha_u32, beta_u32, next,
          qev, sev, pev, bev);
    } else {
      walk_steps_fused_kernel<false><<<grid, kBlock, 0, s>>>(
          curr, query, feat, slot, qid, k, walkers_per_key, step_base,
          chunk_steps, w, p2b_off, p2b_tgt, b2p_off, b2p_tgt, p2b_fb, b2p_fb,
          fb_stride, n_pins, n_slots, n_queries, alpha_u32, beta_u32, next,
          qev, sev, pev, bev);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
