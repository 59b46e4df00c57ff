// topk_select: the selection step of the exact top-k, ties to the lower index.
//
// Replaces no Pallas kernel: the reference's top-k is lax.top_k.  The port
// finds each row's k-th key with torch.topk (counter._topk); this kernel then
// writes, for each row, exactly k indices in ascending order: every index
// whose key is above the row's k-th key, plus the first `need = k - above`
// indices, in index order, whose key equals it.  Plain twin:
// repro_torch/core/counter.py :: topk_select_plain (masks, a cumsum of
// the ties and a nonzero, which waits on the host for its size).
//
// Why a kernel: the twin's cumsum over a multi-row tensor scans each row with
// one block row, so the walk's 8 rows of 140M keys ran on a handful of the
// H100's 132 SMs (~37 ms a row, PERF.md), and its nonzero waits on the host.
// Here the output is (rows, k), known without the data, so nothing waits.
//
// What bounds it on an H100: bytes.  The keys are read once in full (pass 1)
// and again only in the units that hold a chosen index (pass 3: at most k
// units a row, of kUnit keys each); the (rows, k) indices are written once.
// At 8 x 140M float32 keys that is 4.48 GB, ~1.34 ms at 3.35 TB/s.
//
// Design: a row is cut into units of kUnit consecutive keys, and one warp
// takes one unit at a time, over a grid sized to the card; the (row, unit)
// pairs are numbered row-major, so any row count fills every SM.
//   1. count_kernel: per unit, the keys above the k-th key and the ties, with
//      16-byte loads (8 in flight a lane) and a warp reduction; no shared
//      memory and no block barrier;
//   2. scan_kernel: per row (one block), the exclusive prefix of both counts
//      over the row's units, and `need`;
//   3. select_kernel: a unit with no chosen key (no key above, and no tie or
//      every tie past `need`) is skipped without reading its keys; the others
//      are read again, 32 x V keys a step, a lane's above and tie counts
//      scanned across the warp, and each chosen key's index written at
//      above_before + min(ties_before, need), its rank among the chosen.
// Integer counts and positions only, so the output is the twin's bit for bit.
// Units of 4,096 keys and 8 loads in flight: at 8 x 140M keys, units of 1,024
// and 16,384 measured 17% and 13% slower, 4 loads in flight the same
// (kernel_sweep.py topk, PERF.md section 6).
//
// Keys: float32, float64, float16 and bfloat16 compare as floats (-0.0 ties
// +0.0); int16, int32 and int64 (order_keys' keys) as integers.  A NaN key
// compares above every number and equal to every NaN, torch.topk's order, so
// a row always yields exactly k indices (the twin fails on such a row, which
// topk_dense's contract excludes).  16-byte loads need the keys 16-byte
// aligned and the row length a multiple of the keys a load holds; otherwise
// one key a lane a step (the same algorithm, V = 1).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnit = 4096;      // keys a unit: 128 a lane
constexpr int kBlock = 256;      // threads a block of pass 1 and 3
constexpr int kWarps = kBlock / 32;
constexpr int kBatch = 8;        // loads a lane keeps in flight in pass 1
constexpr unsigned kFull = 0xffffffffu;

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

// Each key type: its bits as stored and the value it compares as.
struct F32 {
  using Bits = unsigned;
  using C = float;
  static __device__ __forceinline__ C get(Bits b) { return __uint_as_float(b); }
};
struct F64 {
  using Bits = unsigned long long;
  using C = double;
  static __device__ __forceinline__ C get(Bits b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
};
struct F16 {
  using Bits = unsigned short;
  using C = float;
  static __device__ __forceinline__ C get(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
};
struct BF16 {
  using Bits = unsigned short;
  using C = float;
  static __device__ __forceinline__ C get(Bits b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
};
struct I16 {
  using Bits = unsigned short;
  using C = short;
  static __device__ __forceinline__ C get(Bits b) { return static_cast<short>(b); }
};
struct I32 {
  using Bits = unsigned;
  using C = int;
  static __device__ __forceinline__ C get(Bits b) { return static_cast<int>(b); }
};
struct I64 {
  using Bits = unsigned long long;
  using C = long long;
  static __device__ __forceinline__ C get(Bits b) {
    return static_cast<long long>(b);
  }
};

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
}

// The j-th key of a 16-byte load (little-endian: key 0 in u.x's low bits).
template <typename Bits>
__device__ __forceinline__ Bits piece(const uint4& u, int j) {
  if constexpr (sizeof(Bits) == 2) {
    return static_cast<Bits>(word(u, j >> 1) >> (16 * (j & 1)));
  } else if constexpr (sizeof(Bits) == 4) {
    return word(u, j);
  } else {
    return static_cast<Bits>(word(u, 2 * j)) |
           (static_cast<Bits>(word(u, 2 * j + 1)) << 32);
  }
}

// V consecutive keys from p (16-byte aligned when V > 1).
template <class K, int V>
__device__ __forceinline__ void load(const typename K::Bits* p,
                                     typename K::C (&c)[V]) {
  if constexpr (V == 1) {
    c[0] = K::get(p[0]);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < V; ++j) c[j] = K::get(piece<typename K::Bits>(u, j));
  }
}

// x above kth / x tied with kth; NaN above every number, equal to NaN
// (x != x is false for integers, and the compiler drops it).
template <typename C>
__device__ __forceinline__ bool above(C x, C kth) {
  return x != x ? kth == kth : x > kth;
}
template <typename C>
__device__ __forceinline__ bool tied(C x, C kth) {
  return x != x ? kth != kth : x == kth;
}

// Pass 1: cnt[r * units + u] = (keys above, ties) of unit u of row r.
template <class K, int V>
__global__ void __launch_bounds__(kBlock)
    count_kernel(const typename K::Bits* __restrict__ keys,
                 const typename K::Bits* __restrict__ kth, long long kth_stride,
                 long long rows, long long n, long long units,
                 int2* __restrict__ cnt) {
  using C = typename K::C;
  constexpr int kSteps = kUnit / (32 * V);
  constexpr int kB = kBatch < kSteps ? kBatch : kSteps;
  const int lane = threadIdx.x & 31;
  const long long first = (blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x) >> 5;
  const long long stride = (gridDim.x * static_cast<long long>(kBlock)) >> 5;
  for (long long g = first; g < rows * units; g += stride) {
    const long long r = g / units;
    const long long base = (g - r * units) * kUnit;
    const typename K::Bits* row = keys + r * n;
    const C t = K::get(kth[r * kth_stride]);
    int na = 0, nt = 0;
    if (base + kUnit <= n) {
#pragma unroll 1
      for (int s0 = 0; s0 < kSteps; s0 += kB) {
        C c[kB][V];
#pragma unroll
        for (int b = 0; b < kB; ++b)
          load<K, V>(row + base + static_cast<long long>((s0 + b) * 32 + lane) * V, c[b]);
#pragma unroll
        for (int b = 0; b < kB; ++b) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            na += above(c[b][j], t);
            nt += tied(c[b][j], t);
          }
        }
      }
    } else {                      // the row's last, partial unit
      for (int s = 0; s < kSteps; ++s) {
        const long long e = base + static_cast<long long>(s * 32 + lane) * V;
        if (e < n) {              // n % V == 0: the whole load is in the row
          C c[V];
          load<K, V>(row + e, c);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            na += above(c[j], t);
            nt += tied(c[j], t);
          }
        }
      }
    }
    na = __reduce_add_sync(kFull, na);
    nt = __reduce_add_sync(kFull, nt);
    if (lane == 0) cnt[g] = make_int2(na, nt);
  }
}

// Inclusive scan of (a, b) across the block; returns the block's totals in
// ta, tb and leaves each thread's exclusive prefix in a, b.
__device__ void block_exclusive_scan(long long& a, long long& b, long long& ta,
                                     long long& tb) {
  __shared__ long long wa[32], wb[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long ia = a, ib = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long xa = __shfl_up_sync(kFull, ia, d);
    const long long xb = __shfl_up_sync(kFull, ib, d);
    if (lane >= d) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    wa[warp] = ia;
    wb[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    long long va = lane < n_warps ? wa[lane] : 0;
    long long vb = lane < n_warps ? wb[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long xa = __shfl_up_sync(kFull, va, d);
      const long long xb = __shfl_up_sync(kFull, vb, d);
      if (lane >= d) {
        va += xa;
        vb += xb;
      }
    }
    wa[lane] = va;
    wb[lane] = vb;
  }
  __syncthreads();
  ta = wa[n_warps - 1];
  tb = wb[n_warps - 1];
  a = (warp ? wa[warp - 1] : 0) + ia - a;
  b = (warp ? wb[warp - 1] : 0) + ib - b;
}

// Pass 2, one block a row: pre_above / pre_tie[r * units + u] = the keys
// above / tied before unit u of row r; need[r] = k - the row's keys above.
__global__ void scan_kernel(const int2* __restrict__ cnt, long long units,
                            long long k, long long* __restrict__ pre_above,
                            long long* __restrict__ pre_tie,
                            long long* __restrict__ need) {
  const long long r = blockIdx.x;
  const int2* c = cnt + r * units;
  const long long per = (units + blockDim.x - 1) / blockDim.x;
  const long long lo = min(units, threadIdx.x * per);
  const long long hi = min(units, lo + per);
  long long a = 0, t = 0;
  for (long long u = lo; u < hi; ++u) {
    a += c[u].x;
    t += c[u].y;
  }
  long long total_above, total_tie;
  block_exclusive_scan(a, t, total_above, total_tie);
  for (long long u = lo; u < hi; ++u) {
    pre_above[r * units + u] = a;
    pre_tie[r * units + u] = t;
    a += c[u].x;
    t += c[u].y;
  }
  if (threadIdx.x == 0) need[r] = k - total_above;
}

// Pass 3: out[r, :] = the chosen indices of row r, ascending.
template <class K, int V>
__global__ void __launch_bounds__(kBlock)
    select_kernel(const typename K::Bits* __restrict__ keys,
                  const typename K::Bits* __restrict__ kth, long long kth_stride,
                  long long rows, long long n, long long k, long long units,
                  const int2* __restrict__ cnt,
                  const long long* __restrict__ pre_above,
                  const long long* __restrict__ pre_tie,
                  const long long* __restrict__ need,
                  long long* __restrict__ out) {
  using C = typename K::C;
  constexpr int kSteps = kUnit / (32 * V);
  const int lane = threadIdx.x & 31;
  const long long first = (blockIdx.x * static_cast<long long>(kBlock) + threadIdx.x) >> 5;
  const long long stride = (gridDim.x * static_cast<long long>(kBlock)) >> 5;
  for (long long g = first; g < rows * units; g += stride) {
    const long long r = g / units;
    const int2 c = cnt[g];
    const long long nd = need[r];
    long long ra = pre_above[g], rt = pre_tie[g];
    if (c.x == 0 && (c.y == 0 || rt >= nd)) continue;   // nothing chosen here
    const long long base = (g - r * units) * kUnit;
    const typename K::Bits* row = keys + r * n;
    long long* o = out + r * k;
    const C t = K::get(kth[r * kth_stride]);
    for (int s = 0; s < kSteps; ++s) {
      const long long e = base + static_cast<long long>(s * 32 + lane) * V;
      unsigned am = 0, tm = 0;          // bit j: key e + j above / tied
      if (e < n) {
        C x[V];
        load<K, V>(row + e, x);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          am |= static_cast<unsigned>(above(x[j], t)) << j;
          tm |= static_cast<unsigned>(tied(x[j], t)) << j;
        }
      }
      if (!__any_sync(kFull, (am | tm) != 0)) continue;
      // a lane's counts (at most 8 each) packed, scanned across the warp
      const int mine = __popc(am) | (__popc(tm) << 16);
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      const int excl = incl - mine;
      long long a_before = ra + (excl & 0xffff);
      long long t_before = rt + (excl >> 16);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool a = (am >> j) & 1u, ti = (tm >> j) & 1u;
        if (a || (ti && t_before < nd))
          o[a_before + (t_before < nd ? t_before : nd)] = e + j;
        a_before += a;
        t_before += ti;
      }
      ra += total & 0xffff;
      rt += total >> 16;
    }
  }
}

template <class K, int V>
int run(const void* keys, const void* kth, long long kth_stride, long long rows,
        long long n, long long k, long long* scratch, long long* out,
        cudaStream_t stream) {
  using Bits = typename K::Bits;
  const long long units = (n + kUnit - 1) / kUnit;
  const long long pairs = rows * units;
  int2* cnt = reinterpret_cast<int2*>(scratch);
  long long* pre_above = scratch + pairs;
  long long* pre_tie = pre_above + pairs;
  long long* need = pre_tie + pairs;
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  const long long cap = 8LL * sm_count();
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  const Bits* kp = static_cast<const Bits*>(keys);
  const Bits* tp = static_cast<const Bits*>(kth);
  count_kernel<K, V><<<grid, kBlock, 0, stream>>>(kp, tp, kth_stride, rows, n,
                                                  units, cnt);
  const int scan_block =
      units >= 1024 ? 1024 : static_cast<int>((units + 31) / 32 * 32);
  scan_kernel<<<static_cast<unsigned>(rows), scan_block, 0, stream>>>(
      cnt, units, k, pre_above, pre_tie, need);
  select_kernel<K, V><<<grid, kBlock, 0, stream>>>(
      kp, tp, kth_stride, rows, n, k, units, cnt, pre_above, pre_tie, need, out);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int dispatch(const void* keys, const void* kth, long long kth_stride,
             long long rows, long long n, long long k, long long* scratch,
             long long* out, cudaStream_t stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(typename K::Bits));
  if (reinterpret_cast<uintptr_t>(keys) % 16 == 0 && n % V == 0)
    return run<K, V>(keys, kth, kth_stride, rows, n, k, scratch, out, stream);
  return run<K, 1>(keys, kth, kth_stride, rows, n, k, scratch, out, stream);
}

}  // namespace

// int64 words of scratch the launch needs for a (rows, n) key tensor.
extern "C" long long topk_select_scratch_words(long long rows, long long n) {
  return rows * (3 * ((n + kUnit - 1) / kUnit) + 1);
}

// out (rows, k) int64 = each row's chosen indices, ascending.  keys is a
// contiguous (rows, n) tensor of the type `dtype` names (0 float32, 1
// float64, 2 float16, 3 bfloat16, 4 int16, 5 int32, 6 int64); kth[r *
// kth_stride] is row r's k-th key, of the same type; scratch holds
// topk_select_scratch_words(rows, n) int64 words.  Three launches, none when
// rows or n is 0.  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// an unknown dtype.
extern "C" int topk_select_launch(int dtype, const void* keys, const void* kth,
                                  long long kth_stride, long long rows,
                                  long long n, long long k, long long* scratch,
                                  long long* out, void* stream) {
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<F32>(keys, kth, kth_stride, rows, n, k, scratch, out, s);
    case 1: return dispatch<F64>(keys, kth, kth_stride, rows, n, k, scratch, out, s);
    case 2: return dispatch<F16>(keys, kth, kth_stride, rows, n, k, scratch, out, s);
    case 3: return dispatch<BF16>(keys, kth, kth_stride, rows, n, k, scratch, out, s);
    case 4: return dispatch<I16>(keys, kth, kth_stride, rows, n, k, scratch, out, s);
    case 5: return dispatch<I32>(keys, kth, kth_stride, rows, n, k, scratch, out, s);
    case 6: return dispatch<I64>(keys, kth, kth_stride, rows, n, k, scratch, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
