// visit_counter: dense visit counting over wide event lanes, in place.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/visit_counter.py:
//   * visit_counter_update_high (body _visit_counter_high_kernel): counts +=
//     histogram of the valid (query, slot, pin) events over query-major bins
//     (q * n_slots + s) * n_pins + p, and per row the number of bins whose
//     count crossed from below n_v to >= n_v;
//   * visit_counter_wide (body _visit_counter_wide_kernel): counts +=
//     histogram of (slot, id) or (query, slot, id) lanes.
// Plain twins: repro_torch/kernels/visit_counter.py :: *_plain (ports of
// kernels/ref.py visit_counter_update_high_ref and visit_counter_wide_ref).
//
// An event counts iff 0 <= slot < n_slots, 0 <= id < n_dim and, with a query
// lane, 0 <= query < n_queries; invalid lanes are masked before the flat bin
// id is formed, and the dense-bin rule (n_rows * n_dim < 2**31, checked by
// the wrapper) keeps every valid bin id inside int32.
//
// What bounds it on an H100: one random read-modify-write of a 32-byte
// sector per valid event (the count buffer is gigabytes, so the sectors miss
// L2), plus the lanes read once, coalesced.  Design: one thread per event and
// one atomicAdd on the running buffer, which never leaves device memory and
// is never copied.  The TPU's one-hot tile scan existed to avoid scatters
// and has no place here.  Crossings need no second pass: every increment is
// 1, so for each bin that crosses exactly one thread's atomicAdd returns
// n_v - 1, whatever the order of the atomics, and that thread adds 1 to its
// row's tally.  Integer results are therefore bit-identical to the twin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void visit_counter_kernel(
    const int* __restrict__ qev, const int* __restrict__ sev,
    const int* __restrict__ iev, long long m, int n_slots, int n_dim,
    int n_queries, int n_v, int* __restrict__ counts,
    int* __restrict__ delta) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < m; e += stride) {
    const int s = sev[e];
    const int id = iev[e];
    bool valid = s >= 0 && s < n_slots && id >= 0 && id < n_dim;
    int row = s;
    if (qev != nullptr) {
      const int q = qev[e];
      valid = valid && q >= 0 && q < n_queries;
      row = q * n_slots + s;
    }
    if (!valid) continue;
    const int old = atomicAdd(&counts[row * n_dim + id], 1);
    if (delta != nullptr && old == n_v - 1) atomicAdd(&delta[row], 1);
  }
}

int launch(const int* qev, const int* sev, const int* iev, long long m,
           int n_slots, int n_dim, int n_queries, int n_v, int* counts,
           int* delta, void* stream) {
  constexpr int kBlock = 256;
  if (m > 0) {
    long long blocks = (m + kBlock - 1) / kBlock;
    const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
    visit_counter_kernel<<<grid, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        qev, sev, iev, m, n_slots, n_dim, n_queries, n_v, counts, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// counts (n_rows * n_pins,) is updated in place; delta (n_rows,) must be
// zeroed by the caller and receives the per-row crossings.  qev may be null
// (per-query mode).  Returns cudaGetLastError().
extern "C" int visit_counter_update_high_launch(
    const int* qev, const int* sev, const int* pev, long long m, int n_slots,
    int n_pins, int n_queries, int n_v, int* counts, int* delta,
    void* stream) {
  return launch(qev, sev, pev, m, n_slots, n_pins, n_queries, n_v, counts,
                delta, stream);
}

// counts (n_rows * n_dim,) += histogram of the lanes, in place.
extern "C" int visit_counter_wide_launch(
    const int* qev, const int* sev, const int* iev, long long m, int n_slots,
    int n_dim, int n_queries, int* counts, void* stream) {
  return launch(qev, sev, iev, m, n_slots, n_dim, n_queries, 0, counts,
                nullptr, stream);
}
