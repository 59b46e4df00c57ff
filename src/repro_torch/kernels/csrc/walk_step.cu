// walk_step: the legacy unbiased one-superstep walk, one pin -> board ->
// pin step for every walker.
//
// Replaces the Pallas TPU kernel src/repro/kernels/walk_step.py
// :: walk_step (body _walk_step_kernel).  Plain twin:
// repro_torch/kernels/walk_step.py :: walk_step_plain (port of
// kernels/ref.py walk_step_ref).
//
// Per walker i, with the uint32 words r = rbits[i, 0:3]:
//   pos     = query[i] if r[0] < alpha_u32 (unsigned compare) else curr[i];
//   board   = p2b_targets[start + (r[1] & 0x7FFFFFFF) % deg] (global id,
//             >= n_pins) where pos has deg > 0 boards;
//   pin     = b2p_targets[bstart + (r[2] & 0x7FFFFFFF) % bdeg] where that
//             board has bdeg > 0 pins;
//   ok      = both hops found an edge;
//   next    = pin where ok, else query[i] (a dead end restarts);
//   visited = pin where ok, else 0.
// A dead end reads no target: the last pin or board of a CSR with degree
// 0 has start == len(targets), which the reference's gather fills or
// clamps and a plain load here would read past the array.
//
// What bounds it on an H100: memory latency.  Each walker makes four
// dependent random reads (offset pair, board, offset pair, pin), each a
// 32-byte sector of a gigabyte CSR, and reads and writes its own lanes
// coalesced.  Design: one thread per walker, blocks of 128 (any walker
// count: the TPU kernel's 256-walker block has no counterpart here), the
// edge picked by pick_edge.cuh as in the fused walk kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pick_edge.cuh"

namespace {

__global__ void walk_step_kernel(
    const int* __restrict__ curr, const int* __restrict__ query,
    const uint32_t* __restrict__ rbits, const int* __restrict__ p2b_off,
    const int* __restrict__ p2b_tgt, const int* __restrict__ b2p_off,
    const int* __restrict__ b2p_tgt, int w, int n_pins, uint32_t alpha_u32,
    int* __restrict__ next, int* __restrict__ visited,
    uint8_t* __restrict__ ok) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const size_t r = static_cast<size_t>(i) * 3;
  const int q = query[i];
  const int pos = rbits[r] < alpha_u32 ? q : curr[i];
  const int start = p2b_off[pos];
  const int deg = p2b_off[pos + 1] - start;
  int pin = 0;
  bool hop = false;
  if (deg > 0) {
    const int pick = static_cast<int>(rbits[r + 1] & pixie::kRMask);
    const int board =
        p2b_tgt[pixie::pick_edge(start, deg, pick, false, nullptr, 0)] -
        n_pins;
    const int bstart = b2p_off[board];
    const int bdeg = b2p_off[board + 1] - bstart;
    if (bdeg > 0) {
      const int bpick = static_cast<int>(rbits[r + 2] & pixie::kRMask);
      pin = b2p_tgt[pixie::pick_edge(bstart, bdeg, bpick, false, nullptr, 0)];
      hop = true;
    }
  }
  next[i] = hop ? pin : q;
  visited[i] = pin;
  ok[i] = hop ? 1 : 0;
}

}  // namespace

// curr/query/next/visited (w,) int32, rbits (w, 3) uint32 row-major, ok (w,)
// bool; CSR offsets (rows + 1,) and targets int32.  curr and query must lie
// in [0, n_pins).  Returns cudaGetLastError().
extern "C" int walk_step_launch(
    const int* curr, const int* query, const void* rbits, const int* p2b_off,
    const int* p2b_tgt, const int* b2p_off, const int* b2p_tgt, int w,
    int n_pins, uint32_t alpha_u32, int* next, int* visited, void* ok,
    void* stream) {
  constexpr int kBlock = 128;
  if (w > 0) {
    walk_step_kernel<<<(w + kBlock - 1) / kBlock, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        curr, query, static_cast<const uint32_t*>(rbits), p2b_off, p2b_tgt,
        b2p_off, b2p_tgt, w, n_pins, alpha_u32, next, visited,
        static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
