// embedding_bag: fixed-size bags of table rows pooled by weight, sum or mean.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/embedding_bag.py: the
// one body _embedding_bag_kernel, launched by _bag_pallas_call for both
// entry points, embedding_bag ((n, l) bags) and embedding_bag_batched
// ((b, k, l) bags, flattened to (b * k, l) by the wrapper).  One launch may
// also pool two bag sets over the same table and mode (embedding_bag_pair:
// the ranked request's neighbor and query bags, which the reference pools
// with two pallas_calls).
// Plain twin: repro_torch/kernels/embedding_bag.py :: _bag_plain (the port
// of kernels/ref.py embedding_bag_batched_ref).
//
// Per bag, in ascending element order j = 0 .. l-1:
//   valid = 0 <= id < v;  w = weight * (valid ? 1 : 0)
//   acc  = acc + row(valid ? id : 0) * w;   wsum = wsum + w
// then, in mean mode, acc = acc / (wsum < 1 ? 1 : wsum); the output is acc
// rounded to the table's dtype.  Every multiply, add and divide is written
// with its _rn intrinsic so nvcc cannot contract a multiply and an add into
// an FMA: the kernel then rounds exactly where the twin's separate torch ops
// round, and the two agree bit for bit.
//
// What bounds it on an H100: one random row of d elements read per bag
// element (the table is up to 140M x 32 float32, far past L2), plus the ids
// and weights read once and the output written once.  At the serving path's
// shapes (a 64 x 8 neighbor bag and a 1 x 64 query bag per request) that is
// a few tens of kilobytes, so the time is the launch and the chain of
// dependent reads: a bag's ids, then its rows.  Design: every row read of a
// bag is issued before the first add.
//   * A team of 1, 2 or 8 warps takes a bag (more warps for longer bags:
//     the ranked query bag's 64 reads go out 8 a warp).
//     Each warp loads its share of the bag's ids and weights cooperatively,
//     lane j element j (one coalesced load per 32 elements), and passes each
//     row index to the warp with __shfl_sync.
//   * The warp then copies its rows into shared memory with cp.async, one
//     4-byte word a lane (a 128-byte slice of a row per warp instruction:
//     32 float32 or 64 bf16 columns), all in flight together; a bf16 table
//     of odd width, whose rows are not 4-byte aligned, is copied through
//     registers.  A team stages up to 32 rows a warp (256 rows, 32 KB of
//     float32 at d = 32, for a bag of 8 warps); a longer bag runs in tiles
//     of that capacity.
//   * After cp.async.wait_all and the team's barrier, the team's first warp
//     runs the in-order chain from shared memory, lanes across columns.
// The TPU's block of bags per grid cell was a VMEM tile; here blocks of 8
// warps hold 8, 4 or 1 teams and carry nothing from one to the next.
// Of teams of 2, 4, 8 and 16 warps for the ranked 64-element bag, 8 was the
// fastest on the card, 16 close behind (kernel_sweep.py, PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps per block
constexpr int kRowsPerWarp = 32;   // staged rows per warp and tile
constexpr int kMaxBlocks = 32768;  // per bag set; the kernel strides past it

struct BagSet {
  const int* ids;        // (n, l) int32
  const float* weights;  // (n, l) float32
  void* out;             // (n, d), the table's dtype
  long long n;
  int l;
  int team;              // warps per bag: 1, 2 or 4
  int blocks;            // blocks given to this set
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the team's warps only (named barrier 1 + team; 0 is __syncthreads)
__device__ __forceinline__ void team_sync(int team, int warps) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(32 * warps)
               : "memory");
}

// a table element's bits, and a staged word's k-th element as float32
__device__ __forceinline__ uint32_t bits_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
template <typename T>
__device__ __forceinline__ float element(uint32_t word, int k);
template <>
__device__ __forceinline__ float element<float>(uint32_t word, int) {
  return __uint_as_float(word);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(uint32_t word, int k) {
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(word >> (16 * k))));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copy the 128-byte slice `group` of table row `row` into one staged row
// (32 words): lane i takes word i.  `aligned`: the rows start on 4-byte
// boundaries, so the word is one cp.async; else it is built in registers.
template <typename T>
__device__ __forceinline__ void stage_row(uint32_t* dst, const T* table,
                                          long long row, int d, int group,
                                          bool aligned, int lane) {
  constexpr int kPer = 4 / sizeof(T);  // columns per word
  const int c = group * 32 * kPer + lane * kPer;
  const T* src = table + row * d + c;
  if (aligned) {
    if (c < d) cp_async4(dst + lane, src);
  } else {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (c + k < d) word |= bits_of(src[k]) << (16 * k);
    dst[lane] = word;
  }
}

// (no __launch_bounds__: with 256 threads ptxas then holds the bf16 form to
// 40 registers and spills)
template <typename T>
__global__ void embedding_bag_kernel(BagSet a, BagSet b,
                                     const T* __restrict__ table, long long v,
                                     int d, int mean, int aligned) {
  constexpr int kPer = 4 / sizeof(T);
  __shared__ uint32_t stage[kWarps * kRowsPerWarp][32];
  __shared__ float wts[kWarps * kRowsPerWarp];

  // this block's set, field by field (selecting a whole parameter struct
  // by a runtime flag would copy it to the stack)
  const bool first = static_cast<int>(blockIdx.x) < a.blocks;
  const int* ids = first ? a.ids : b.ids;
  const float* weights = first ? a.weights : b.weights;
  T* out = static_cast<T*>(first ? a.out : b.out);
  const long long n = first ? a.n : b.n;
  const int l = first ? a.l : b.l;
  const int t = first ? a.team : b.team;
  const int blocks = first ? a.blocks : b.blocks;
  const int block = first ? blockIdx.x : blockIdx.x - a.blocks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int teams = kWarps / t;
  const int team = warp / t;
  const int rank = warp % t;
  const int cap = t * kRowsPerWarp;  // staged rows per team and tile
  uint32_t(*tstage)[32] = stage + team * cap;
  float* twts = wts + team * cap;
  const int groups = (d + 32 * kPer - 1) / (32 * kPer);

  for (long long bag = static_cast<long long>(block) * teams + team;
       bag < n; bag += static_cast<long long>(blocks) * teams) {
    const int* bag_ids = ids + bag * l;
    const float* bag_w = weights + bag * l;
    for (int g = 0; g < groups; ++g) {
      float acc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] = 0.0f;
      float wsum = 0.0f;
      for (int tile = 0; tile < l; tile += cap) {
        const int rows = min(cap, l - tile);
        const int share = (rows + t - 1) / t;
        const int begin = min(rank * share, rows);
        const int end = min(begin + share, rows);
        for (int s0 = begin; s0 < end; s0 += 32) {
          const int e = s0 + lane;
          int row = 0;
          if (e < end) {
            const int id = bag_ids[tile + e];
            const bool valid = id >= 0 && id < v;
            row = valid ? id : 0;
            twts[e] = __fmul_rn(bag_w[tile + e], valid ? 1.0f : 0.0f);
          }
          const int cnt = min(32, end - s0);
#pragma unroll 8
          for (int k = 0; k < cnt; ++k) {
            const int r = __shfl_sync(0xffffffffu, row, k);
            stage_row(tstage[s0 + k], table, r, d, g, aligned != 0, lane);
          }
        }
        cp_async_wait_all();
        team_sync(team, t);
        if (rank == 0) {
#pragma unroll 8
          for (int e = 0; e < rows; ++e) {
            const float w = twts[e];
            const uint32_t word = tstage[e][lane];
#pragma unroll
            for (int k = 0; k < kPer; ++k)
              acc[k] = __fadd_rn(acc[k], __fmul_rn(element<T>(word, k), w));
            wsum = __fadd_rn(wsum, w);
          }
        }
        team_sync(team, t);  // the tile's rows are read before the next
      }
      if (rank == 0) {
        const float div = wsum < 1.0f ? 1.0f : wsum;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int c = g * 32 * kPer + lane * kPer + k;
          if (c < d)
            store(out + bag * d + c, mean ? __fdiv_rn(acc[k], div) : acc[k]);
        }
      }
    }
  }
}

// warps per bag: one for short bags, more to spread a long bag's reads
int team_for(int l) { return l <= 16 ? 1 : (l <= 48 ? 2 : kWarps); }

BagSet bag_set(const int* ids, const float* weights, void* out, long long n,
               int l) {
  BagSet s{ids, weights, out, n, l, team_for(l), 0};
  const long long teams = kWarps / s.team;
  const long long blocks = (n + teams - 1) / teams;
  s.blocks = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  return s;
}

}  // namespace

// Pools one or two bag sets over one table in ONE launch: set a (ids_a,
// weights_a (n_a, l_a) -> out_a (n_a, d)) and, when n_b > 0, set b.  ids are
// int32, weights float32; table (v, d) and the outputs are float32, or bf16
// when bf16 != 0.  Every pointer is to contiguous device memory.  Launches
// nothing when both sets are empty or d is 0.  Returns cudaGetLastError().
extern "C" int embedding_bag_launch(
    const int* ids_a, const float* weights_a, void* out_a, long long n_a,
    int l_a, const int* ids_b, const float* weights_b, void* out_b,
    long long n_b, int l_b, const void* table, long long v, int d, int mean,
    int bf16, void* stream) {
  const BagSet a = bag_set(ids_a, weights_a, out_a, n_a, l_a);
  const BagSet b = bag_set(ids_b, weights_b, out_b, n_b, l_b);
  const int grid = a.blocks + b.blocks;
  if (grid > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int elem = bf16 ? 2 : 4;
    const int aligned = (static_cast<long long>(d) * elem) % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(table) % 4 == 0;
    if (bf16) {
      embedding_bag_kernel<__nv_bfloat16><<<grid, 32 * kWarps, 0, s>>>(
          a, b, static_cast<const __nv_bfloat16*>(table), v, d, mean,
          aligned);
    } else {
      embedding_bag_kernel<float><<<grid, 32 * kWarps, 0, s>>>(
          a, b, static_cast<const float*>(table), v, d, mean, aligned);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
