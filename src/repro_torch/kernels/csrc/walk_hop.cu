// walk_hop_fused: one CSR hop for the routed walkers of every co-located
// shard, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/walk_step.py
// :: walk_hop_fused (body _walk_hop_kernel).  Plain twin:
// repro_torch/kernels/walk_step.py :: walk_hop_ref (port of kernels/ref.py
// walk_hop_ref).
//
// Per walker lane i of shard s, with row_base = row_base[s]:
//   local = pos - row_base where gate, else 0 (a gated-off lane may hold a
//           node another shard owns, or garbage);
//   ok    = gate and deg(local) > 0 (a degree-0 ghost row is a dead end);
//   tgt   = targets[start + (r & 0x7FFFFFFF) % deg] where ok, else 0.
// The sharded engine runs it twice per superstep: pin -> board on the p2b
// slices, then, after routing walkers to the board's owner, board -> pin
// on the b2p slices.
//
// Layout: the walker buffers of all S co-located shards are stacked as
// (S, L) and the CSR slices as (S, rows + 1) offsets and (S, E_max)
// targets; the grid runs over walker blocks (x) and shards (y).  row_base
// is data read from device memory, never a compile-time constant.
//
// What bounds it on an H100: memory latency.  A lane that hops makes two
// dependent random reads (its offset pair, then its target), each a 32-byte
// sector, and the lanes' own reads and writes are coalesced; the distinct
// sectors are a few megabytes at most, far below what 3.35 TB/s moves in
// the time the dependency chain takes.  Design: one thread per walker,
// blocks of 128, and gated-off lanes issue no graph load at all, so a
// half-empty routed buffer costs only its coalesced lane traffic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pick_edge.cuh"

namespace {

__global__ void walk_hop_kernel(
    const int* __restrict__ pos, const uint8_t* __restrict__ gate,
    const uint32_t* __restrict__ r, const int* __restrict__ row_base,
    const int* __restrict__ offsets, long long off_stride,
    const int* __restrict__ targets, long long tgt_stride, int l,
    int* __restrict__ out, uint8_t* __restrict__ ok) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= l) return;
  const int s = blockIdx.y;
  const size_t lane = static_cast<size_t>(s) * l + i;
  int tgt = 0;
  bool hop = false;
  if (gate[lane] != 0) {
    const int local = pos[lane] - row_base[s];
    const int* off = offsets + static_cast<size_t>(s) * off_stride;
    const int start = off[local];
    const int deg = off[local + 1] - start;
    if (deg > 0) {
      const int pick = static_cast<int>(r[lane] & pixie::kRMask);
      const int e = pixie::pick_edge(start, deg, pick, false, nullptr, 0);
      tgt = targets[static_cast<size_t>(s) * tgt_stride + e];
      hop = true;
    }
  }
  out[lane] = tgt;
  ok[lane] = hop ? 1 : 0;
}

}  // namespace

// pos/gate/r/out/ok are (n_shards, l); offsets (n_shards, off_stride) and
// targets (n_shards, tgt_stride) row-major; row_base (n_shards,).  Returns
// cudaGetLastError().
extern "C" int walk_hop_fused_launch(
    const int* pos, const void* gate, const void* r, const int* row_base,
    const int* offsets, long long off_stride, const int* targets,
    long long tgt_stride, int n_shards, int l, int* out, void* ok,
    void* stream) {
  constexpr int kBlock = 128;
  if (l > 0 && n_shards > 0) {
    const dim3 grid((l + kBlock - 1) / kBlock, n_shards);
    walk_hop_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        pos, static_cast<const uint8_t*>(gate),
        static_cast<const uint32_t*>(r), row_base, offsets, off_stride,
        targets, tgt_stride, l, out, static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
