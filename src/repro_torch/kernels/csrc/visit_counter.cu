// visit_counter: dense visit counting over event lanes.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/visit_counter.py:
//   * visit_counter (body _visit_counter_kernel): a fresh (n_bins,) histogram
//     of flat int32 ids; ids outside [0, n_bins), negatives included, are
//     dropped;
//   * visit_counter_update_high (body _visit_counter_high_kernel): counts +=
//     histogram of the valid (query, slot, pin) events over query-major bins
//     (q * n_slots + s) * n_pins + p, and per row the number of bins whose
//     count crossed from below n_v to >= n_v;
//   * visit_counter_wide (body _visit_counter_wide_kernel): counts +=
//     histogram of (slot, id) or (query, slot, id) lanes.
// Plain twins: repro_torch/kernels/visit_counter.py :: *_plain (ports of
// kernels/ref.py visit_counter_ref, visit_counter_update_high_ref and
// visit_counter_wide_ref).
//
// An event counts iff 0 <= slot < n_slots, 0 <= id < n_dim and, with a query
// lane, 0 <= query < n_queries; invalid lanes are masked before the flat bin
// id is formed, and the dense-bin rule (n_rows * n_dim < 2**31, checked by
// the wrapper) keeps every valid bin id inside int32.
//
// What bounds it on an H100: one random read-modify-write of a 32-byte
// sector per distinct bin (the count buffer is gigabytes, so the sectors
// miss L2), plus the lanes read once, coalesced.  The TPU's one-hot tile
// scan existed to avoid scatters and has no place here.
//
// visit_counter_update_high runs once per walk chunk on every Pixie path,
// on about 65k events, so its time is launches and round trips more than
// bytes.  Design: one launch per counting call, one event per thread
// (four events a thread, their loads issued ahead of the atomics, measured
// slower on the retrieval chunk: fewer warps in flight).  Same-bin events of a warp are combined with __match_any_sync
// on the flat bin: the lowest lane of each group adds the group's size c
// with one atomicAdd (the walk's lanes repeat bins: 65,536 events hit
// 10,628 bins there).  The bin crossed n_v iff that add took it from
// old < n_v to old + c >= n_v, and exactly one add of a crossing bin sees
// that, whatever the order of the atomics, so integer results are
// bit-identical to the twin.  Crossings go to a per-block tally in shared
// memory (n_rows <= kMaxRows), which bounds the contention on a few tally
// words when most bins cross (n_v = 1); at the end each block adds its
// non-zero rows straight into the caller's tally, in place, so no zeroed
// delta buffer and no add on the host side are needed.
//
// visit_counter_wide and the flat histogram (visit_counter) keep the first
// design: one thread per event and one atomicAdd on the running buffer,
// which never leaves device memory and is never copied.  The TPU kernels'
// tile and chunk sizes shaped their one-hot scans and have no counterpart
// here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHighBlock = 256;
constexpr int kMaxRows = 12288;  // 48 KB of per-block tally

__global__ void __launch_bounds__(kHighBlock) update_high_kernel(
    const int* __restrict__ qev, const int* __restrict__ sev,
    const int* __restrict__ pev, long long m, int n_slots, int n_pins,
    int n_queries, int n_rows, int n_v, int* __restrict__ counts,
    int* __restrict__ high) {
  extern __shared__ int tally[];
  for (int r = threadIdx.x; r < n_rows; r += kHighBlock) tally[r] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // block-uniform loop: every lane reaches __match_any_sync
  for (long long base = static_cast<long long>(blockIdx.x) * kHighBlock;
       base < m; base += static_cast<long long>(gridDim.x) * kHighBlock) {
    const long long e = base + threadIdx.x;
    int bin = -1, row = 0;
    if (e < m) {
      const int s = sev[e];
      const int p = pev[e];
      bool valid = s >= 0 && s < n_slots && p >= 0 && p < n_pins;
      row = s;
      if (qev != nullptr) {
        const int q = qev[e];
        valid = valid && q >= 0 && q < n_queries;
        row = q * n_slots + s;
      }
      if (valid) bin = row * n_pins + p;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) {
      const int c = __popc(peers);
      const int old = atomicAdd(&counts[bin], c);
      if (old < n_v && n_v - old <= c) atomicAdd(&tally[row], 1);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_rows; r += kHighBlock) {
    const int t = tally[r];
    if (t) atomicAdd(&high[r], t);
  }
}

__global__ void visit_counter_kernel(
    const int* __restrict__ qev, const int* __restrict__ sev,
    const int* __restrict__ iev, long long m, int n_slots, int n_dim,
    int n_queries, int* __restrict__ counts) {
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
    atomicAdd(&counts[row * n_dim + id], 1);
  }
}

int launch(const int* qev, const int* sev, const int* iev, long long m,
           int n_slots, int n_dim, int n_queries, int* counts, void* stream) {
  constexpr int kBlock = 256;
  if (m > 0) {
    long long blocks = (m + kBlock - 1) / kBlock;
    const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
    visit_counter_kernel<<<grid, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        qev, sev, iev, m, n_slots, n_dim, n_queries, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void histogram_kernel(const int* __restrict__ ev, long long m,
                                 int n_bins, int* __restrict__ counts) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < m; e += stride) {
    const int id = ev[e];
    if (id >= 0 && id < n_bins) atomicAdd(&counts[id], 1);
  }
}

}  // namespace

// counts (n_rows * n_pins,) is updated in place, and high (n_rows,) gains
// per row the bins that crossed n_v, in place (n_rows is n_queries *
// n_slots with a query lane, else n_slots, and at most kMaxRows, the
// wrapper's MAX_HIGH_ROWS).  qev may be null (per-query mode).
// One launch; none when m is 0.  Returns cudaGetLastError().
extern "C" int visit_counter_update_high_launch(
    const int* qev, const int* sev, const int* pev, long long m, int n_slots,
    int n_pins, int n_queries, int n_v, int* counts, int* high,
    void* stream) {
  const int n_rows = qev != nullptr ? n_queries * n_slots : n_slots;
  if (n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    const long long blocks = (m + kHighBlock - 1) / kHighBlock;
    const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
    update_high_kernel<<<grid, kHighBlock, n_rows * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(
        qev, sev, pev, m, n_slots, n_pins, n_queries, n_rows, n_v, counts,
        high);
  }
  return static_cast<int>(cudaGetLastError());
}

// counts (n_rows * n_dim,) += histogram of the lanes, in place.
extern "C" int visit_counter_wide_launch(
    const int* qev, const int* sev, const int* iev, long long m, int n_slots,
    int n_dim, int n_queries, int* counts, void* stream) {
  return launch(qev, sev, iev, m, n_slots, n_dim, n_queries, counts, stream);
}

// counts (n_bins,) must be zeroed by the caller and receives the histogram
// of ev (m,); ids outside [0, n_bins) are skipped.  Launches nothing when
// m or n_bins is 0.  Returns cudaGetLastError().
extern "C" int visit_counter_launch(const int* ev, long long m, int n_bins,
                                    int* counts, void* stream) {
  constexpr int kBlock = 256;
  if (m > 0 && n_bins > 0) {
    long long blocks = (m + kBlock - 1) / kBlock;
    const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
    histogram_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        ev, m, n_bins, counts);
  }
  return static_cast<int>(cudaGetLastError());
}
