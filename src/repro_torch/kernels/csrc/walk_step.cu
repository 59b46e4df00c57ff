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
// dependent random reads after its lanes (offset pair, board, offset pair,
// pin), each a 32-byte sector of a gigabyte CSR, and reads and writes its
// own lanes coalesced; the bytes take 0.1 us at the phase-23 shape (8,192
// walkers), the chain of 4-5 dependent reads 0.7-0.9 us at L2 latency,
// after a launch that costs 1.75 us reading nothing.  Design: one thread
// per walker (any walker count: the TPU kernel's 256-walker block has no
// counterpart here), and
//   * blocks sized to the card: the largest power of two from 32 to
//     kMaxBlock threads that still gives every SM a block, so 8,192
//     walkers run as 256 blocks of 32 on all 132 SMs (blocks of 128
//     would leave 68 of them idle);
//   * the lanes read unconditionally, all before the first CSR read;
//   * the CSR read through the read-only path (__ldg), each offset pair
//     issued back to back.  Non-allocating loads
//     (ld.global.nc.L1::no_allocate in inline PTX) measured slower on the
//     card at every block size (kernel_sweep.py, PERF.md section 6);
//   * the edge picked by pick_edge.cuh, as in the fused walk kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pick_edge.cuh"

namespace {

constexpr int kMaxBlock = 256;

// one int of the read-only CSR
__device__ __forceinline__ int load_csr(const int* p) { return __ldg(p); }

__global__ void walk_step_kernel(
    const int* __restrict__ curr, const int* __restrict__ query,
    const uint32_t* __restrict__ rbits, const int* __restrict__ p2b_off,
    const int* __restrict__ p2b_tgt, const int* __restrict__ b2p_off,
    const int* __restrict__ b2p_tgt, int w, int n_pins, uint32_t alpha_u32,
    int* __restrict__ next, int* __restrict__ visited,
    uint8_t* __restrict__ ok) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  // the lanes, every load issued before the chain starts
  const size_t r = static_cast<size_t>(i) * 3;
  const int q = query[i];
  const int c = curr[i];
  const uint32_t r0 = rbits[r];
  const uint32_t r1 = rbits[r + 1];
  const uint32_t r2 = rbits[r + 2];
  const int pos = r0 < alpha_u32 ? q : c;
  const int start = load_csr(p2b_off + pos);
  const int end = load_csr(p2b_off + pos + 1);
  const int deg = end - start;
  int pin = 0;
  bool hop = false;
  if (deg > 0) {
    const int pick = static_cast<int>(r1 & pixie::kRMask);
    const int board =
        load_csr(p2b_tgt + pixie::pick_edge(start, deg, pick, false, nullptr,
                                            0)) -
        n_pins;
    const int bstart = load_csr(b2p_off + board);
    const int bend = load_csr(b2p_off + board + 1);
    const int bdeg = bend - bstart;
    if (bdeg > 0) {
      const int bpick = static_cast<int>(r2 & pixie::kRMask);
      pin = load_csr(b2p_tgt + pixie::pick_edge(bstart, bdeg, bpick, false,
                                                nullptr, 0));
      hop = true;
    }
  }
  next[i] = hop ? pin : q;
  visited[i] = pin;
  ok[i] = hop ? 1 : 0;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

}  // namespace

// curr/query/next/visited (w,) int32, rbits (w, 3) uint32 row-major, ok (w,)
// bool; CSR offsets (rows + 1,) and targets int32.  curr and query must lie
// in [0, n_pins).  One launch; none when w is 0.  Returns
// cudaGetLastError().
extern "C" int walk_step_launch(
    const int* curr, const int* query, const void* rbits, const int* p2b_off,
    const int* p2b_tgt, const int* b2p_off, const int* b2p_tgt, int w,
    int n_pins, uint32_t alpha_u32, int* next, int* visited, void* ok,
    void* stream) {
  if (w > 0) {
    // the largest block that still leaves no SM without one
    const long long sms = sm_count();
    int block = 32;
    while (block < kMaxBlock &&
           (static_cast<long long>(w) + 2 * block - 1) / (2 * block) >= sms)
      block *= 2;
    walk_step_kernel<<<(w + block - 1) / block, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        curr, query, static_cast<const uint32_t*>(rbits), p2b_off, p2b_tgt,
        b2p_off, b2p_tgt, w, n_pins, alpha_u32, next, visited,
        static_cast<uint8_t*>(ok));
  }
  return static_cast<int>(cudaGetLastError());
}
