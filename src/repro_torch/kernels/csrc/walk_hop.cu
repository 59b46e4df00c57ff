// walk_hop_fused: one CSR hop for the routed walkers of every co-located
// shard, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/walk_step.py
// :: walk_hop_fused (body _walk_hop_kernel).  Plain twin:
// repro_torch/kernels/walk_step.py :: walk_hop_ref (port of kernels/ref.py
// walk_hop_ref, which takes the words r pre-gathered), on the words that
// kernels/ops.py :: walk_hop gathers from the table.
//
// Per walker lane i of shard s, with row_base = row_base[s] and the lane's
// walker id g = walker[s, i]:
//   local = pos - row_base where gate, else 0 (a gated-off lane may hold a
//           node another shard owns, or garbage, in pos and in g);
//   ok    = gate and deg(local) > 0 (a degree-0 ghost row is a dead end);
//   tgt   = targets[start + (r & 0x7FFFFFFF) % deg] where ok, else 0, with
//           r = table[step, g, column]: the walker's word of this hop, read
//           from the chunk's (chunk_steps, n, 4) word table (walk_bits.cu)
//           by the kernel itself, on gated lanes only.
// The sharded engine runs it twice per superstep: pin -> board on the p2b
// slices (column 2), then, after routing walkers to the board's owner,
// board -> pin on the b2p slices (column 3).
//
// Layout: the walker buffers of all S co-located shards are stacked as
// (S, L) and the CSR slices as (S, rows + 1) offsets and (S, E_max)
// targets; the grid runs over walker blocks (x) and shards (y).  row_base
// is data read from device memory, never a compile-time constant.
//
// What bounds it on an H100: the chain of dependent reads and the launch.
// A lane that hops reads its lanes (coalesced), then its offset pair and
// its word (both random 32-byte sectors, independent of each other), then
// its target; the distinct sectors are a few megabytes at most, far below
// what 3.35 TB/s moves in the time that chain takes.  Design: one thread
// per walker, blocks of 128; gate, pos, the walker id and row_base are
// loaded unconditionally (they are in bounds for every lane), so the lane
// loads issue together and the chain is lane loads -> (offset pair, word)
// -> target; gated-off lanes issue no graph or table load at all, so a
// half-empty routed buffer costs only its coalesced lane traffic.  Reading
// the word here replaces a gather of each hop's words into a fresh (S, L)
// lane before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pick_edge.cuh"

namespace {

__global__ void walk_hop_kernel(
    const int* __restrict__ pos, const uint8_t* __restrict__ gate,
    const uint32_t* __restrict__ words, const int* __restrict__ walker,
    const int* __restrict__ row_base, const int* __restrict__ offsets,
    long long off_stride, const int* __restrict__ targets,
    long long tgt_stride, int l, int* __restrict__ out,
    uint8_t* __restrict__ ok) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= l) return;
  const int s = blockIdx.y;
  const size_t lane = static_cast<size_t>(s) * l + i;
  // the lane loads, unconditional and independent of each other
  const bool gated = gate[lane] != 0;
  const int p = pos[lane];
  const int g = walker[lane];
  const int base = row_base[s];
  int tgt = 0;
  bool hop = false;
  if (gated) {
    const int* off = offsets + static_cast<size_t>(s) * off_stride;
    const int local = p - base;
    const int start = off[local];
    const int end = off[local + 1];
    const uint32_t r = words[static_cast<size_t>(g) * 4];
    const int deg = end - start;
    // the pick on every gated lane (a dead end's is never read), so the
    // word's read issues beside the offset pair and is not sunk into the
    // branch below
    const int e = pixie::pick_edge(start, max(deg, 1),
                                   static_cast<int>(r & pixie::kRMask), false,
                                   nullptr, 0);
    if (deg > 0) {
      tgt = targets[static_cast<size_t>(s) * tgt_stride + e];
      hop = true;
    }
  }
  out[lane] = tgt;
  ok[lane] = hop ? 1 : 0;
}

}  // namespace

// pos/gate/walker/out/ok are (n_shards, l); offsets (n_shards, off_stride)
// and targets (n_shards, tgt_stride) row-major; row_base (n_shards,).
// words points at table[step, 0, column] of a (chunk_steps, n, 4) uint32
// table, so walker g's word is words[4 * g].  Returns cudaGetLastError().
extern "C" int walk_hop_fused_launch(
    const int* pos, const void* gate, const void* words, const int* walker,
    const int* row_base, const int* offsets, long long off_stride,
    const int* targets, long long tgt_stride, int n_shards, int l, int* out,
    void* ok, void* stream) {
  constexpr int kBlock = 128;
  if (l > 0 && n_shards > 0) {
    const dim3 grid((l + kBlock - 1) / kBlock, n_shards);
    walk_hop_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        pos, static_cast<const uint8_t*>(gate),
        static_cast<const uint32_t*>(words), walker, row_base, offsets,
        off_stride, targets, tgt_stride, l, out, static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
