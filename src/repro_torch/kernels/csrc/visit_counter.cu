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
// bit-identical to the twin.  Each crossing goes straight into the
// caller's tally, high[row], with a global atomic, the crossings of a warp
// to one row combined first (a warp's events are consecutive walkers, so
// they share a row or two): no zeroed delta buffer, no add on the host
// side, and no row cap, as the reference's kernel has none.  A per-block
// tally in shared memory, flushed at the end, caps the rows at 12,288 (48
// KB) and measured as slow or slower on the card at every row count, also
// when every bin crosses (n_v = 1), and 1.7 us slower at 12,288 rows,
// where each block zeroes and flushes more tally words than its events
// touch (kernel_sweep.py, 8 to 16,384 rows; PERF.md section 6).
//
// visit_counter_wide runs once per chunk on the board-rec path, on ~10^6
// events whose (query, slot, board) bins repeat heavily (the board-rec
// bucket: 1,048,576 events into 128,000 bins).  Design (wide_kernel): a
// grid sized to the card (at most 4 blocks of 512 per SM); each block takes
// tiles of up to 4,096 consecutive events, 8 a thread, loads every lane of
// the tile before its first atomic, and finds the tile's bin range.  The
// walk's lanes are query-major, so a tile of one step's walkers falls in
// one query's n_slots * n_dim window; where the range fits the block's
// 48 KB shared window (and costs at most 4 window bins an event), the block
// counts into the window (one shared atomic an event) and then adds each
// non-zero bin to counts with one global atomic.  Elsewhere (a full-width
// window of 8 x 60M bins) it adds to counts directly, same-bin events of a
// warp combined with __match_any_sync first: one global atomic per
// distinct bin per warp.  On the card the match costs more than it saves
// before shared atomics and saves more than it costs before global ones
// (kernel_sweep.py, PERF.md section 6).  Integer adds commute, so any order of atomics gives the twin's bits.
// The tile is a power of two, so it aligns with power-of-two walker
// blocks.
//
// The flat histogram (visit_counter) keeps the first design: one thread
// per event and one atomicAdd on the count buffer, which never leaves
// device memory and is never copied (87% of its byte bound).  The TPU
// kernels' tile and chunk sizes shaped their one-hot scans and have no
// counterpart here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kHighBlock = 256;

__global__ void __launch_bounds__(kHighBlock) update_high_kernel(
    const int* __restrict__ qev, const int* __restrict__ sev,
    const int* __restrict__ pev, long long m, int n_slots, int n_pins,
    int n_queries, int n_v, int* __restrict__ counts,
    int* __restrict__ high) {
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
    bool crossed = false;
    if (bin >= 0 && lane == __ffs(peers) - 1) {
      const int c = __popc(peers);
      const int old = atomicAdd(&counts[bin], c);
      crossed = old < n_v && n_v - old <= c;
    }
    if (__any_sync(0xffffffffu, crossed)) {
      const unsigned same = __match_any_sync(0xffffffffu, crossed ? row : -1);
      if (crossed && lane == __ffs(same) - 1) atomicAdd(&high[row], __popc(same));
    }
  }
}

constexpr int kWideBlock = 512;
constexpr int kWidePer = 8;         // events a thread holds, at most
constexpr int kWindow = 12256;      // the block's shared bins: 48 KB with the
                                    // range words
constexpr int kWindowPerEvent = 4;  // window bins a tile event may cost

// One tile = kWideBlock * per consecutive events, `per` a power of two
// (<= kWidePer) chosen by the launcher; a block strides over tiles.
__global__ void __launch_bounds__(kWideBlock) wide_kernel(
    const int* __restrict__ qev, const int* __restrict__ sev,
    const int* __restrict__ iev, long long m, int n_slots, int n_dim,
    int n_queries, int per, int* __restrict__ counts) {
  __shared__ int window[kWindow];
  __shared__ int warp_lo[kWideBlock / 32], warp_hi[kWideBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = static_cast<long long>(kWideBlock) * per;
  for (long long base = blockIdx.x * tile; base < m;
       base += static_cast<long long>(gridDim.x) * tile) {
    // the tile's lanes, read coalesced, all loads issued before any atomic
    int bins[kWidePer];
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int j = 0; j < kWidePer; ++j) {
      bins[j] = -1;
      const long long e = base + static_cast<long long>(j) * kWideBlock +
                          threadIdx.x;
      if (j < per && e < m) {
        const int s = sev[e];
        const int id = iev[e];
        bool valid = s >= 0 && s < n_slots && id >= 0 && id < n_dim;
        int row = s;
        if (qev != nullptr) {
          const int q = qev[e];
          valid = valid && q >= 0 && q < n_queries;
          row = q * n_slots + s;
        }
        if (valid) {
          bins[j] = row * n_dim + id;
          lo = min(lo, bins[j]);
          hi = max(hi, bins[j]);
        }
      }
    }
    // the tile's bin range, and whether it fits the block's window
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      warp_lo[warp] = lo;
      warp_hi[warp] = hi;
    }
    __syncthreads();
    lo = INT_MAX;
    hi = -1;
    for (int w = 0; w < kWideBlock / 32; ++w) {
      lo = min(lo, warp_lo[w]);
      hi = max(hi, warp_hi[w]);
    }
    const long long span = hi >= 0 ? static_cast<long long>(hi) - lo + 1 : 0;
    const bool windowed =
        span > 0 && span <= kWindow && span <= kWindowPerEvent * tile;
    if (windowed)
      for (int i = threadIdx.x; i < span; i += kWideBlock) window[i] = 0;
    __syncthreads();
    // into the window, one shared atomic an event; to counts, same-bin
    // events of a warp combined first: one global atomic per distinct bin
#pragma unroll
    for (int j = 0; j < kWidePer; ++j) {
      if (j >= per) break;  // block-uniform: every lane reaches the match
      const int bin = bins[j];
      if (windowed) {
        if (bin >= 0) atomicAdd(&window[bin - lo], 1);
      } else {
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&counts[bin], __popc(peers));
      }
    }
    if (windowed) {
      __syncthreads();
      for (int i = threadIdx.x; i < span; i += kWideBlock) {
        const int c = window[i];
        if (c) atomicAdd(&counts[lo + i], c);
      }
    }
    __syncthreads();  // the window and the range words are free again
  }
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
// n_slots with a query lane, else n_slots; any count whose bins fit
// int32).  qev may be null (per-query mode).  One launch; none when m is
// 0.  Returns cudaGetLastError().
extern "C" int visit_counter_update_high_launch(
    const int* qev, const int* sev, const int* pev, long long m, int n_slots,
    int n_pins, int n_queries, int n_v, int* counts, int* high,
    void* stream) {
  if (m > 0) {
    const long long blocks = (m + kHighBlock - 1) / kHighBlock;
    const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
    update_high_kernel<<<grid, kHighBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        qev, sev, pev, m, n_slots, n_pins, n_queries, n_v, counts, high);
  }
  return static_cast<int>(cudaGetLastError());
}

// counts (n_rows * n_dim,) += histogram of the lanes, in place (qev may be
// null: no query lane).  One launch, of at most 4 blocks per SM; none when
// m is 0.  Returns cudaGetLastError().
extern "C" int visit_counter_wide_launch(
    const int* qev, const int* sev, const int* iev, long long m, int n_slots,
    int n_dim, int n_queries, int* counts, void* stream) {
  if (m > 0) {
    const long long sms = sm_count();
    // events a thread: enough for 2 tiles per SM, a power of two <= 8
    int per = 1;
    while (per < kWidePer && m > 2 * sms * kWideBlock * per) per *= 2;
    const long long tile = static_cast<long long>(kWideBlock) * per;
    const long long tiles = (m + tile - 1) / tile;
    const int grid = static_cast<int>(tiles < 4 * sms ? tiles : 4 * sms);
    wide_kernel<<<grid, kWideBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        qev, sev, iev, m, n_slots, n_dim, n_queries, per, counts);
  }
  return static_cast<int>(cudaGetLastError());
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
