// walk_steps_fused: chunk_steps Pixie walk supersteps for every walker.
//
// Replaces the Pallas TPU kernel src/repro/kernels/walk_step.py
// :: walk_steps_fused (body _walk_steps_fused_kernel; the edge pick
// _pick_edge lives in pick_edge.cuh, shared with walk_hop.cu).
// Plain twins: repro_torch/kernels/walk_step.py :: walk_chunk_plain and
// walk_chunk_batched_plain (ports of kernels/ref.py walk_chunk_ref and
// walk_chunk_batched_ref).
//
// Each superstep, per walker: restart at the query pin if bits0 < alpha
// (unsigned); hop pin -> board -> pin, each hop picking
// start + (bits & 0x7FFFFFFF) % span, where the span is the personalized
// feature subrange when bits1 < beta (unsigned) and the subrange is
// non-empty, else the whole adjacency slice; a dead end (degree 0 on either
// hop) sends the walker back to its query pin and emits an invalid event.
// Emitted lanes, each (chunk_steps, w) int32, written coalesced along w:
// slot (sentinel n_slots), pin (0 when invalid), and optionally query
// (sentinel n_queries, batch-native mode) and local board (0 when invalid).
//
// What bounds it on an H100: memory latency.  Every hop is a chain of
// dependent random reads (offset row -> [feature bounds] -> target), four to
// six 32-byte sectors per walker-step.  Walkers that restart reread their
// query pin's rows, so many of those reads hit L2; the distinct bytes are
// tiny next to 3.35 TB/s, and the time is the length of the dependency
// chain times the number of chains in flight.  Design: one thread per walker, the
// walker's state (current pin, query pin, feature, slot, query id) in
// registers for the whole chunk, the step's four random words read as one
// 16-byte load, and small blocks so the few thousand walkers of a serving
// batch spread over many SMs.  The TPU kernel's DMA double-buffering (the
// "dma" gather mode) has no counterpart: the GPU hides latency by running
// many walkers' chains at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pick_edge.cuh"

namespace {

using pixie::kRMask;
using pixie::pick_edge;

__global__ void walk_steps_fused_kernel(
    const int* __restrict__ curr, const int* __restrict__ query,
    const int* __restrict__ feat, const int* __restrict__ slot,
    const int* __restrict__ qid, const uint4* __restrict__ rbits,
    int chunk_steps, int w,
    const int* __restrict__ p2b_off, const int* __restrict__ p2b_tgt,
    const int* __restrict__ b2p_off, const int* __restrict__ b2p_tgt,
    const int* __restrict__ p2b_fb, const int* __restrict__ b2p_fb,
    int fb_stride, int n_pins, int n_slots, int n_queries,
    uint32_t alpha_u32, uint32_t beta_u32,
    int* __restrict__ next, int* __restrict__ qev, int* __restrict__ sev,
    int* __restrict__ pev, int* __restrict__ bev) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  int cur = curr[i];
  const int q = query[i];
  const int f = feat[i];
  const int sl = slot[i];
  const int qi = qid != nullptr ? qid[i] : 0;

  for (int s = 0; s < chunk_steps; ++s) {
    const size_t o = static_cast<size_t>(s) * w + i;
    const uint4 r = rbits[o];
    const bool restart = r.x < alpha_u32;
    const bool use_b = r.y < beta_u32;
    const int r_board = static_cast<int>(r.z & kRMask);
    const int r_pin = static_cast<int>(r.w & kRMask);
    const int pos = restart ? q : cur;

    bool ok = false;
    int pin = 0;
    int b_local = 0;
    const int start = p2b_off[pos];
    const int deg = p2b_off[pos + 1] - start;
    if (deg > 0) {
      const int* fb = p2b_fb != nullptr
          ? p2b_fb + static_cast<size_t>(pos) * fb_stride : nullptr;
      const int board = p2b_tgt[pick_edge(start, deg, r_board, use_b, fb, f)];
      b_local = board - n_pins;
      const int bstart = b2p_off[b_local];
      const int bdeg = b2p_off[b_local + 1] - bstart;
      if (bdeg > 0) {
        const int* bfb = b2p_fb != nullptr
            ? b2p_fb + static_cast<size_t>(b_local) * fb_stride : nullptr;
        pin = b2p_tgt[pick_edge(bstart, bdeg, r_pin, use_b, bfb, f)];
        ok = true;
      }
    }
    cur = ok ? pin : q;
    sev[o] = ok ? sl : n_slots;
    pev[o] = ok ? pin : 0;
    if (qev != nullptr) qev[o] = ok ? qi : n_queries;
    if (bev != nullptr) bev[o] = ok ? b_local : 0;
  }
  next[i] = cur;
}

}  // namespace

// qid/qev (batch-native mode), the two feature-bound tables (biased walk)
// and bev (board counting) may each be null.  Returns cudaGetLastError().
extern "C" int walk_steps_fused_launch(
    const int* curr, const int* query, const int* feat, const int* slot,
    const int* qid, const void* rbits, int chunk_steps, int w,
    const int* p2b_off, const int* p2b_tgt, const int* b2p_off,
    const int* b2p_tgt, const int* p2b_fb, const int* b2p_fb, int fb_stride,
    int n_pins, int n_slots, int n_queries, uint32_t alpha_u32,
    uint32_t beta_u32, int* next, int* qev, int* sev, int* pev, int* bev,
    void* stream) {
  constexpr int kBlock = 64;
  if (w > 0) {
    const int grid = (w + kBlock - 1) / kBlock;
    walk_steps_fused_kernel<<<grid, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        curr, query, feat, slot, qid, static_cast<const uint4*>(rbits),
        chunk_steps, w, p2b_off, p2b_tgt, b2p_off, b2p_tgt, p2b_fb, b2p_fb,
        fb_stride, n_pins, n_slots, n_queries, alpha_u32, beta_u32, next, qev,
        sev, pev, bev);
  }
  return static_cast<int>(cudaGetLastError());
}
