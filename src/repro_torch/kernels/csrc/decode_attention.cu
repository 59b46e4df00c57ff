// decode_attention: single-token GQA attention over a KV cache, with a
// length mask and an online softmax.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py:
// decode_attention (body _decode_attn_kernel), which the JAX package's LM
// decode step computes through its jnp oracle _decode_attention_ref
// (src/repro/models/transformer.py).  Plain twin:
// repro_torch/kernels/decode_attention.py :: decode_attention_plain.
//
// For batch row b and query head i (kv head i / (h / kh)):
//   out[b, i] = softmax_s(q[b, i] . k[b, s, kv] * dh^-0.5, s < length[b])
//               @ v[b, s, kv]
// in float32 whatever the input types (q float32 or bf16, k/v float32 or
// bf16), (b, h, dh) float32 out.  Positions at or past the length are never
// read: a masked score would contribute exp(-1e30 - m) = 0, so skipping
// them is exact.  Full-precision expf (no fast math); the result differs
// from the twin's two-pass softmax only by the order of float32 sums.
//
// What bounds it on an H100: each K and V element up to the length is read
// once (bytes: 2 * length * kh * dh * sizeof(kv) per batch row) and used
// for 2 * group multiply-adds, far below the card's balance point, so the
// bound is bytes.  Design (simple first): one CTA per (kv head, batch row)
// holds the group's query heads and their (m, l, acc) state in shared
// memory and walks the cache in tiles of 64 positions (32 where shared
// memory is short).  Per tile: (1) all threads stage the K and V tile in
// shared memory as float32, with 16-byte loads where rows are 16-byte
// multiples, so the tile's DRAM reads are all in flight at once; (2) one
// warp per query head computes the tile's scores (lanes across positions,
// K rows padded by one word against bank conflicts) and folds them into
// the head's running max and sum with warp reductions; (3) each thread
// rescales and accumulates up to four heads' p @ V for one dh column,
// reading each V element once.  The TPU's sequential s grid with VMEM
// scratch carried across it becomes this in-CTA loop.  b * kh CTAs (8 at
// batch 4 on Qwen2.5-3B, 32 at the decode_32k cut) leave most of the 132
// SMs idle, and a tile's loads are not overlapped with the previous tile's
// arithmetic: splitting s across CTAs (flash-decoding split-K), a
// cp.async/TMA pipeline and wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadsPerThread = 4;     // query heads one thread accumulates
constexpr long long kSmemLimit = 232448;  // bytes one H100 block can use
constexpr float kNegInf = -1e30f;      // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t bits) {  // bf16 bit pattern
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// 16 bytes -> 4 float32 or 8 bf16 values, as float32.
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f, uint16_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Rows [0, n) of a (rows, dh) tile whose rows are pos_stride elements
// apart, into dst as float32 with rows dst_stride apart.
template <typename KV, bool kVec>
__device__ __forceinline__ void stage(const KV* __restrict__ src,
                                      long long pos_stride, int n, int dh,
                                      float* dst, int dst_stride) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(KV);
    const int per_row = dh / kPer;
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int j = i / per_row;
      const int c = (i - j * per_row) * kPer;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + j * pos_stride + c);
      float f[kPer];
      unpack(raw, f, KV());
      float* o = dst + j * dst_stride + c;
#pragma unroll
      for (int e = 0; e < kPer; ++e) o[e] = f[e];
    }
  } else {
    for (int i = threadIdx.x; i < n * dh; i += kThreads) {
      const int j = i / dh;
      const int d = i - j * dh;
      dst[j * dst_stride + d] = to_f32(src[j * pos_stride + d]);
    }
  }
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline long long smem_bytes(int group, int dh, int tile) {
  const long long gd = static_cast<long long>(group) * dh;
  return 4LL * (2 * gd + static_cast<long long>(tile) * (dh + 1) +
                static_cast<long long>(tile) * dh +
                static_cast<long long>(round_up(group, kHeadsPerThread)) * tile +
                3LL * group);
}

// 64 positions a tile where shared memory allows, else 32, else 0 (refused).
inline int pick_tile(int group, int dh) {
  if (smem_bytes(group, dh, 64) <= kSmemLimit) return 64;
  if (smem_bytes(group, dh, 32) <= kSmemLimit) return 32;
  return 0;
}

template <typename Q, typename KV, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const int* __restrict__ lengths, int uniform_len,
                        float* __restrict__ out, int s, int h, int kh, int dh,
                        int tile, float scale) {
  extern __shared__ float smem[];
  const int group = h / kh;
  const int gd = group * dh;
  const int kv_head = blockIdx.x;
  const int row_b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k_stride = dh + 1;       // padded: lanes read different rows
  float* q_s = smem;                 // (group, dh) query heads
  float* acc_s = q_s + gd;           // (group, dh) running p @ V
  float* k_s = acc_s + gd;           // (tile, dh + 1) K tile
  float* v_s = k_s + tile * k_stride;  // (tile, dh) V tile
  float* p_s = v_s + tile * dh;      // (group rounded up to 4, tile) exp
  float* m_s = p_s + round_up(group, kHeadsPerThread) * tile;  // running max
  float* l_s = m_s + group;          // running sum
  float* corr_s = l_s + group;       // this tile's rescale

  const int len = lengths != nullptr ? lengths[row_b] : uniform_len;
  const long long head0 =
      (static_cast<long long>(row_b) * h + static_cast<long long>(kv_head) * group) * dh;
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = to_f32(q[head0 + i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }

  const long long pos_stride = static_cast<long long>(kh) * dh;
  const long long base =
      static_cast<long long>(row_b) * s * pos_stride + static_cast<long long>(kv_head) * dh;
  const int rows_per_lane = tile / 32;
  const int chunks = round_up(group, kHeadsPerThread) / kHeadsPerThread;

  for (int t0 = 0; t0 < len; t0 += tile) {
    const int n = min(tile, len - t0);
    __syncthreads();  // the previous tile's readers are done
    // 1. stage the tile
    stage<KV, kVec>(k + base + t0 * pos_stride, pos_stride, n, dh, k_s, k_stride);
    stage<KV, kVec>(v + base + t0 * pos_stride, pos_stride, n, dh, v_s, dh);
    __syncthreads();
    // 2. scores and the online softmax: one warp per query head
    for (int g = warp; g < group; g += kWarps) {
      const float* qg = q_s + g * dh;
      float sc[2] = {0.0f, 0.0f};
      for (int d = 0; d < dh; ++d) {
        const float qd = qg[d];
        sc[0] += qd * k_s[lane * k_stride + d];
        if (rows_per_lane > 1) sc[1] += qd * k_s[(lane + 32) * k_stride + d];
      }
      float mx = kNegInf;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lane + 32 * r;
        sc[r] = (r < rows_per_lane && j < n) ? sc[r] * scale : kNegInf;
        mx = fmaxf(mx, sc[r]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r < rows_per_lane) {
          const float e = expf(sc[r] - m_new);
          p_s[g * tile + lane + 32 * r] = e;
          sum += e;
        }
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + p @ V: one dh column and up to four heads a
    // thread, each V element read once
    for (int item = tid; item < chunks * dh; item += kThreads) {
      const int g0 = (item / dh) * kHeadsPerThread;
      const int d = item - (item / dh) * dh;
      const int ng = min(kHeadsPerThread, group - g0);
      float a[kHeadsPerThread];
#pragma unroll
      for (int u = 0; u < kHeadsPerThread; ++u)
        a[u] = u < ng ? acc_s[(g0 + u) * dh + d] * corr_s[g0 + u] : 0.0f;
      const float* pg = p_s + g0 * tile;
      for (int j = 0; j < n; ++j) {
        const float x = v_s[j * dh + d];
#pragma unroll
        for (int u = 0; u < kHeadsPerThread; ++u) a[u] += pg[u * tile + j] * x;
      }
#pragma unroll
      for (int u = 0; u < kHeadsPerThread; ++u)
        if (u < ng) acc_s[(g0 + u) * dh + d] = a[u];
    }
  }
  __syncthreads();
  for (int i = tid; i < gd; i += kThreads) {
    out[head0 + i] = acc_s[i] / fmaxf(l_s[i / dh], 1e-30f);
  }
}

template <typename Q, typename KV, bool kVec>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           int uniform_len, float* out, int b, int s, int h, int kh, int dh,
           float scale, cudaStream_t stream) {
  const int group = h / kh;
  const int tile = pick_tile(group, dh);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_bytes(group, dh, tile));
  auto kernel = decode_attention_kernel<Q, KV, kVec>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(kh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), lengths, uniform_len, out, s, h, kh, dh,
      tile, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q, typename KV>
int launch_kv(const void* q, const void* k, const void* v, const int* lengths,
              int uniform_len, float* out, int b, int s, int h, int kh, int dh,
              float scale, cudaStream_t stream) {
  // 16-byte loads when every row of the tile starts 16-byte aligned
  const bool vec = (dh * sizeof(KV)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return vec ? launch<Q, KV, true>(q, k, v, lengths, uniform_len, out, b, s,
                                   h, kh, dh, scale, stream)
             : launch<Q, KV, false>(q, k, v, lengths, uniform_len, out, b, s,
                                    h, kh, dh, scale, stream);
}

}  // namespace

// Shared memory one CTA needs, in bytes, at the tile it would use; the
// wrapper refuses shapes past the card's 227 KB.
extern "C" long long decode_attention_smem_bytes(int group, int dh) {
  const int tile = pick_tile(group, dh);
  return smem_bytes(group, dh, tile == 0 ? 32 : tile);
}

// out (b, h, dh) float32 = decode attention of q (b, h, dh) over k, v
// (b, s, kh, dh), all contiguous device memory, scores scaled by scale
// (the wrapper passes dh^-0.5 rounded to float32); q is bf16 when
// q_bf16 != 0 (else float32), k and v bf16 when kv_bf16 != 0.  Batch row r
// attends to positions [0, lengths[r]) or, with lengths == nullptr,
// [0, uniform_len); every length must lie in [1, s] and h % kh == 0,
// dh <= 256 (the wrapper checks).  Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       int uniform_len, float* out, int b,
                                       int s, int h, int kh, int dh,
                                       float scale, int q_bf16, int kv_bf16,
                                       void* stream) {
  if (b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return kv_bf16 ? launch_kv<uint16_t, uint16_t>(q, k, v, lengths, uniform_len,
                                                   out, b, s, h, kh, dh, scale, st)
                   : launch_kv<uint16_t, float>(q, k, v, lengths, uniform_len,
                                                out, b, s, h, kh, dh, scale, st);
  }
  return kv_bf16 ? launch_kv<float, uint16_t>(q, k, v, lengths, uniform_len,
                                              out, b, s, h, kh, dh, scale, st)
                 : launch_kv<float, float>(q, k, v, lengths, uniform_len, out,
                                           b, s, h, kh, dh, scale, st);
}
