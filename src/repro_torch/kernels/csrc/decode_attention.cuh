// The decode-attention kernel in both its forms (the whole cache, and one
// block of a sequence-split cache) and its host-side plan, shared by
// decode_attention.cu (the whole-cache form's entry points) and
// decode_attention_partial.cu (the partial form's), each built by its own
// nvcc so that the two sets of instantiations compile side by side.  The
// design and its bound are described in decode_attention.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;         // positions a warp owns in a tile
constexpr int kSms = 132;               // H100 SXM
constexpr int kWaveCtas = 2 * kSms;     // two CTAs an SM: one wave
constexpr int kMinSplit = 128;          // positions: shorter splits cost more to merge
constexpr int kMaxSplits = 64;
constexpr long long kSmemLimit = 232448;  // bytes one H100 block can use
constexpr float kNegInf = -1e30f;       // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t bits) {  // bf16 bit pattern
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ void bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// DPL consecutive elements of shared memory, aligned to DPL elements
// (16 bytes at most per load), as float32.
template <int DPL>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  if constexpr (DPL == 1) {
    f[0] = p[0];
  } else if constexpr (DPL == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x;
    f[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < DPL; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      f[i] = x.x;
      f[i + 1] = x.y;
      f[i + 2] = x.z;
      f[i + 3] = x.w;
    }
  }
}
template <int DPL>
__device__ __forceinline__ void load_vec(const uint16_t* p, float* f) {
  if constexpr (DPL == 1) {
    f[0] = to_f32(p[0]);
  } else if constexpr (DPL == 2) {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), f);
  } else if constexpr (DPL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    bf16x2(w.x, f);
    bf16x2(w.y, f + 2);
    bf16x2(w.z, f + 4);
    bf16x2(w.w, f + 6);
  }
}

// HC consecutive floats of shared memory (16-byte aligned).
template <int HC>
__device__ __forceinline__ void load_heads(const float* p, float* f) {
#pragma unroll
  for (int i = 0; i < HC; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    f[i] = x.x;
    f[i + 1] = x.y;
    f[i + 2] = x.z;
    f[i + 3] = x.w;
  }
}

// v[i] holds this lane's partial of pair i (i < 32); on return v[0] holds
// the warp's full sum of pair `lane`.  At level O a lane keeps the half of
// its pairs that its lane bit O selects and adds its partner's partials of
// that half.
template <int O>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) reduce_scatter<O / 2>(v, lane);
}

// d += a (16 x 16 bf16, rows 8-15 zero) @ b (16 x 8 bf16), float32 sums:
// a0 / a2 hold row groupID's columns 2t, 2t + 1 and 2t + 8, 2t + 9 (t =
// lane % 4), b0 / b1 column groupID's rows 2t, 2t + 1 and 2t + 8, 2t + 9;
// d[0], d[1] are row groupID's columns 2t and 2t + 1 (d[2], d[3] rows 8-15).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(N));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename KV, int CPB>
__device__ __forceinline__ void copy_one(KV* dst, const KV* src) {
  if constexpr (CPB == 16) {
    cp_async16(dst, src);
  } else if constexpr (CPB == 2) {
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  } else {
    cp_async_ca<CPB>(dst, src);
  }
}

// Rows [0, n) of K and V (rows pos_stride elements apart in global memory)
// into shared rows rw elements apart, CPB bytes a copy (cp.async), or
// element by element (CPB 2: a bf16 row that is no multiple of 4 bytes).
template <typename KV, int CPB>
__device__ __forceinline__ void copy_rows(KV* dk, KV* dv, const KV* sk,
                                          const KV* sv, long long pos_stride,
                                          int n, int dh, int rw) {
  constexpr int kPer = CPB / static_cast<int>(sizeof(KV));  // elements a copy
  const int per_row = dh / kPer;
  if (kThreads % per_row == 0) {
    // a thread copies the same column of every (kThreads / per_row)-th row
    const int c = (threadIdx.x % per_row) * kPer;
    const int step = kThreads / per_row;
    for (int j = threadIdx.x / per_row; j < n; j += step) {
      copy_one<KV, CPB>(dk + j * rw + c, sk + j * pos_stride + c);
      copy_one<KV, CPB>(dv + j * rw + c, sv + j * pos_stride + c);
    }
    return;
  }
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int j = i / per_row;
    const int c = (i - j * per_row) * kPer;
    copy_one<KV, CPB>(dk + j * rw + c, sk + j * pos_stride + c);
    copy_one<KV, CPB>(dv + j * rw + c, sv + j * pos_stride + c);
  }
}

template <typename KV>
__device__ __forceinline__ void copy_tile(KV* dk, KV* dv, const KV* sk,
                                          const KV* sv, long long pos_stride,
                                          int n, int dh, int rw, int cpb) {
  switch (cpb) {
    case 16: copy_rows<KV, 16>(dk, dv, sk, sv, pos_stride, n, dh, rw); break;
    case 8: copy_rows<KV, 8>(dk, dv, sk, sv, pos_stride, n, dh, rw); break;
    case 4: copy_rows<KV, 4>(dk, dv, sk, sv, pos_stride, n, dh, rw); break;
    default: copy_rows<KV, 2>(dk, dv, sk, sv, pos_stride, n, dh, rw); break;
  }
}

// The kernel's configuration for a head dim and a cache element size.
struct Config {
  int dpl;     // dims a lane holds: 32 * dpl >= dh
  int hc;      // query heads a CTA holds (a head chunk)
  int tile;    // positions a stage holds
  int stages;  // cp.async ring depth
  long long smem;
};

long long smem_bytes(int dpl, int hc, int tile, int stages, int kv_bytes) {
  const long long rw = 32LL * dpl;
  const long long rs = rw + 16 / kv_bytes;  // a K or V row, padded
  const long long ring = 2LL * stages * tile * rs * kv_bytes;
  const long long merge = 4LL * kWarps * hc * rw;  // reuses the ring
  return (ring > merge ? ring : merge) +
         4LL * (kWarps * kRowsPerWarp * hc  // p
                + kWarps * hc               // the tile's rescale
                + 3LL * kWarps * hc         // per-warp m, l, merge weight
                + 2LL * hc                  // the CTA's m, l
                + static_cast<long long>(kMaxSplits) * hc);  // split weights
}

Config make_config(int dh, int kv_bytes) {
  Config c;
  c.dpl = dh <= 32 ? 1 : dh <= 64 ? 2 : dh <= 128 ? 4 : 8;
  c.hc = c.dpl == 8 ? 4 : 8;  // hc * dpl <= 32 keeps q and acc in registers
  const int choices[3][2] = {{64, 3}, {64, 2}, {32, 2}};
  for (const auto& ch : choices) {
    c.tile = ch[0];
    c.stages = ch[1];
    c.smem = smem_bytes(c.dpl, c.hc, c.tile, c.stages, kv_bytes);
    if (c.smem <= kSmemLimit) break;
  }
  return c;
}

// Splits of the sequence: n_splits * split_len >= max_len, split_len a
// multiple of the tile; one split when rows (b * kh * head chunks) CTAs
// already fill the card or the length is short.
void make_splits(long long rows, int max_len, int tile, int* n_splits,
                 int* split_len) {
  int len = max_len;
  if (rows < kSms && max_len > kMinSplit) {
    const long long want = kWaveCtas / rows;  // CTAs that fit one wave
    long long per = (max_len + want - 1) / want;
    const long long min_per = (max_len + kMaxSplits - 1) / kMaxSplits;
    if (per < min_per) per = min_per;
    if (per < kMinSplit) per = kMinSplit;
    len = static_cast<int>((per + tile - 1) / tile * tile);
    if (len > max_len) len = max_len;
  }
  *split_len = len;
  *n_splits = (max_len + len - 1) / len;
}

// MMA: bf16 q and K, scores on the tensor cores (mma.sync); else float32
// FMAs and a reduce-scatter.  p @ V is float32 FMAs either way.  PARTIAL:
// the partial form (its block's length from lo; m and l written out), a
// template argument so the whole-cache form compiles without either.
template <typename Q, typename KV, int DPL, int HC, bool MMA, bool PARTIAL>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const int* __restrict__ lengths, int uniform_len,
                        int lo, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ ws,
                        int* __restrict__ tickets, int s, int h, int kh,
                        int dh, int n_chunks, int split_len, int tile,
                        int stages, int cpb, float scale) {
  constexpr int RW = 32 * DPL;          // dims the lanes hold
  // a K or V row in shared memory, padded by 16 bytes: the mma path's
  // 8 rows x 4 words per load then fall in 32 distinct banks
  constexpr int RS = RW + 16 / static_cast<int>(sizeof(KV));
  constexpr int NPB = 32 / HC;          // positions of a head per lane group
  constexpr int NSB = kRowsPerWarp / NPB;  // scores a lane holds per tile
  constexpr int KSTEPS = RW / 16;       // mma k-steps over the dims
  static_assert(!MMA || HC == 8, "the mma path holds 8 heads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int kv_head = blockIdx.y / n_chunks;
  const int chunk = blockIdx.y - kv_head * n_chunks;
  const int row_b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = h / kh;
  const int heads = min(HC, group - chunk * HC);  // live heads of the chunk
  const long long head0 =
      static_cast<long long>(row_b) * h + kv_head * group + chunk * HC;

  // shared memory: the K and V ring (reused by the warp merge), then the
  // small arrays
  const int ring_elems = stages * tile * RS;
  KV* kbuf = reinterpret_cast<KV*>(smem_raw);
  KV* vbuf = kbuf + ring_elems;
  const long long ring_bytes = 2LL * ring_elems * sizeof(KV);
  const long long merge_bytes = 4LL * kWarps * HC * RW;
  float* small = reinterpret_cast<float*>(
      smem_raw + (ring_bytes > merge_bytes ? ring_bytes : merge_bytes));
  float* pbuf = small;                                 // (warps, 8, HC)
  float* cbuf = pbuf + kWarps * kRowsPerWarp * HC;     // (warps, HC)
  float* mbuf = cbuf + kWarps * HC;                    // (warps, HC)
  float* lbuf = mbuf + kWarps * HC;                    // (warps, HC)
  float* wbuf = lbuf + kWarps * HC;                    // (warps, HC)
  float* cta_m = wbuf + kWarps * HC;                   // (HC,)
  float* cta_l = cta_m + HC;                           // (HC,)
  float* split_w = cta_l + HC;                         // (kMaxSplits, HC)

  // the block's own length: positions [lo, lo + s) of the row's cache
  const int raw = lengths != nullptr ? lengths[row_b] : uniform_len;
  const int len = PARTIAL ? min(max(raw - lo, 0), s) : raw;
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  const int n_tiles = end > start ? (end - start + tile - 1) / tile : 0;

  // K's columns past dh meet q = 0: zero them once (cp.async never
  // writes them), so no stale NaN can reach a score
  if (dh < RW) {
    const int pad = RW - dh;
    for (int i = tid; i < ring_elems / RS * pad; i += kThreads)
      kbuf[(i / pad) * RS + dh + i % pad] = KV(0);
  }

  // this lane's head, and its running state for that head: lanes
  // my_head * NPB .. + NPB - 1 hold the head's scores, NSB each
  const int my_head = lane / NPB;
  const int my_pos = lane % NPB;
  // the position (within the warp's 8) of this lane's score sb
  auto pos_of = [&](int sb) { return MMA ? 2 * my_pos + sb : sb * NPB + my_pos; };
  float m_run = kNegInf, l_run = 0.0f;
  float qr[HC][DPL], acc[HC][DPL];
  uint32_t qa[KSTEPS][2];  // MMA: q as mma A fragments, bf16 pairs
#pragma unroll
  for (int hh = 0; hh < HC; ++hh) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane * DPL + e;
      if constexpr (!MMA)
        qr[hh][e] = hh < heads && d < dh ? to_f32(q[(head0 + hh) * dh + d]) : 0.0f;
      acc[hh][e] = 0.0f;
    }
  }
  if constexpr (MMA) {
    const uint16_t* qh = reinterpret_cast<const uint16_t*>(q) + (head0 + my_head) * dh;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 16 * ks + 8 * half + 2 * my_pos;
        const uint32_t lo = my_head < heads && d < dh ? qh[d] : 0u;
        const uint32_t hi = my_head < heads && d + 1 < dh ? qh[d + 1] : 0u;
        qa[ks][half] = lo | hi << 16;
      }
    }
  }

  const long long pos_stride = static_cast<long long>(kh) * dh;
  const long long base = static_cast<long long>(row_b) * s * pos_stride +
                         static_cast<long long>(kv_head) * dh;
  auto issue = [&](int t) {
    const int t0 = start + t * tile;
    const int b = t % stages;
    copy_tile<KV>(kbuf + b * tile * RS, vbuf + b * tile * RS,
                  k + base + t0 * pos_stride, v + base + t0 * pos_stride,
                  pos_stride, min(tile, end - t0), dh, RS, cpb);
  };
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (stages == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();  // tile t has landed; tile t - 1's readers are done
    if (t + stages - 1 < n_tiles) issue(t + stages - 1);
    cp_async_commit();

    const int r0 = warp * kRowsPerWarp;
    const int nvalid = min(kRowsPerWarp, end - (start + t * tile) - r0);
    if (r0 >= tile || nvalid <= 0) continue;  // warp-uniform
    const int b = t % stages;
    const KV* kt = kbuf + (b * tile + r0) * RS;
    const KV* vt = vbuf + (b * tile + r0) * RS + lane * DPL;

    float sc[NSB];
    if constexpr (MMA) {
      // S (8 heads padded to 16, 8 positions) = q @ K^T, K-steps of 16
      // dims; lane holds head my_head at positions 2 my_pos, 2 my_pos + 1
      const uint32_t* krow = reinterpret_cast<const uint32_t*>(kt + (lane >> 2) * RS);
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma_bf16(d, qa[ks][0], qa[ks][1], krow[8 * ks + my_pos],
                 krow[8 * ks + my_pos + 4]);
      sc[0] = d[0] * scale;
      sc[1] = d[1] * scale;
    } else {
      // pair index hh * NPB + pp of sub-batch sb is (head hh, position
      // sb * NPB + pp); lane `lane` ends up with pair `lane`
#pragma unroll
      for (int sb = 0; sb < NSB; ++sb) {
        float part[32];
#pragma unroll
        for (int pp = 0; pp < NPB; ++pp) {
          float kv[DPL];
          load_vec<DPL>(kt + (sb * NPB + pp) * RS + lane * DPL, kv);
#pragma unroll
          for (int hh = 0; hh < HC; ++hh) {
            float a = 0.0f;
#pragma unroll
            for (int e = 0; e < DPL; ++e) a = fmaf(qr[hh][e], kv[e], a);
            part[hh * NPB + pp] = a;
          }
        }
        reduce_scatter<16>(part, lane);
        sc[sb] = part[0] * scale;
      }
    }
    // the online softmax of this warp's positions, per head
    float mx = kNegInf;
#pragma unroll
    for (int sb = 0; sb < NSB; ++sb)
      if (pos_of(sb) < nvalid) mx = fmaxf(mx, sc[sb]);
#pragma unroll
    for (int o = 1; o < NPB; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float* pw = pbuf + warp * kRowsPerWarp * HC;
    float sum = 0.0f;
#pragma unroll
    for (int sb = 0; sb < NSB; ++sb) {
      const int p = pos_of(sb);
      const float e = p < nvalid ? expf(sc[sb] - m_new) : 0.0f;
      pw[p * HC + my_head] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 1; o < NPB; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l_run = l_run * corr + sum;
    m_run = m_new;
    if (my_pos == 0) cbuf[warp * HC + my_head] = corr;
    __syncwarp();
    // acc = acc * corr + p @ V over this warp's valid positions
    if (__any_sync(0xffffffffu, corr != 1.0f)) {  // some head's max moved
      float cr[HC];
      load_heads<HC>(cbuf + warp * HC, cr);
#pragma unroll
      for (int hh = 0; hh < HC; ++hh)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[hh][e] *= cr[hh];
    }
    for (int p = 0; p < nvalid; ++p) {
      float vv[DPL], pv[HC];
      load_vec<DPL>(vt + p * RS, vv);
      load_heads<HC>(pw + p * HC, pv);
#pragma unroll
      for (int hh = 0; hh < HC; ++hh)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[hh][e] = fmaf(pv[hh], vv[e], acc[hh][e]);
    }
    __syncwarp();  // pw and cbuf are rewritten at the next tile
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the warp merge

  // merge the warps' partial softmaxes, in warp order
  float* macc = reinterpret_cast<float*>(smem_raw);  // (warps, HC, RW)
#pragma unroll
  for (int hh = 0; hh < HC; ++hh)
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      macc[(warp * HC + hh) * RW + lane * DPL + e] = acc[hh][e];
  if (my_pos == 0) {
    mbuf[warp * HC + my_head] = m_run;
    lbuf[warp * HC + my_head] = l_run;
  }
  __syncthreads();
  if (tid < HC) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mbuf[w * HC + tid]);
    float l = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(mbuf[w * HC + tid] - m);
      wbuf[w * HC + tid] = wt;
      l += lbuf[w * HC + tid] * wt;
    }
    cta_m[tid] = m;
    cta_l[tid] = l;
  }
  __syncthreads();

  if (n_splits == 1) {
    for (int i = tid; i < heads * dh; i += kThreads) {
      const int hh = i / dh;
      const int d = i - hh * dh;
      float a = 0.0f;
      for (int w = 0; w < kWarps; ++w)
        a += wbuf[w * HC + hh] * macc[(w * HC + hh) * RW + d];
      out[(head0 + hh) * dh + d] = a / fmaxf(cta_l[hh], 1e-30f);
    }
    if (PARTIAL && tid < heads) {
      m_out[head0 + tid] = cta_m[tid];
      l_out[head0 + tid] = cta_l[tid];
    }
    return;
  }

  // a split's partial into the workspace: (m, l) pairs, then acc
  const long long rows = static_cast<long long>(gridDim.y) * gridDim.z;
  const long long row = static_cast<long long>(row_b) * gridDim.y + blockIdx.y;
  float* ws_ml = ws;                               // (rows, splits, HC, 2)
  float* ws_acc = ws + rows * n_splits * HC * 2;   // (rows, splits, HC, dh)
  const long long part = row * n_splits + split;
  for (int i = tid; i < heads * dh; i += kThreads) {
    const int hh = i / dh;
    const int d = i - hh * dh;
    float a = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      a += wbuf[w * HC + hh] * macc[(w * HC + hh) * RW + d];
    ws_acc[part * HC * dh + i] = a;
  }
  if (tid < heads) {
    ws_ml[(part * HC + tid) * 2] = cta_m[tid];
    ws_ml[(part * HC + tid) * 2 + 1] = cta_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[row], 1);
    is_last = ticket == n_splits - 1;
    if (is_last) tickets[row] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last CTA of the row merges every split, in split order
  const long long part0 = row * n_splits;
  if (tid < heads) {
    float m = kNegInf;
    for (int sp = 0; sp < n_splits; ++sp)
      m = fmaxf(m, __ldcg(&ws_ml[((part0 + sp) * HC + tid) * 2]));
    float l = 0.0f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float* ml = &ws_ml[((part0 + sp) * HC + tid) * 2];
      const float wt = expf(__ldcg(ml) - m);
      split_w[sp * HC + tid] = wt;
      l += __ldcg(ml + 1) * wt;
    }
    cta_m[tid] = m;
    cta_l[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < heads * dh; i += kThreads) {
    const int hh = i / dh;
    float a = 0.0f;
    for (int sp = 0; sp < n_splits; ++sp)
      a += split_w[sp * HC + hh] * __ldcg(&ws_acc[(part0 + sp) * HC * dh + i]);
    out[head0 * dh + i] = a / fmaxf(cta_l[hh], 1e-30f);
  }
  if (PARTIAL && tid < heads) {
    m_out[head0 + tid] = cta_m[tid];
    l_out[head0 + tid] = cta_l[tid];
  }
}

template <typename Q, typename KV, int DPL, int HC, bool MMA, bool PARTIAL>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           int uniform_len, int lo, float* out, float* m_out, float* l_out,
           float* ws, int* tickets, int b,
           int s, int h, int kh, int dh, int n_chunks, int n_splits,
           int split_len, const Config& c, int cpb, float scale,
           cudaStream_t stream) {
  auto kernel = decode_attention_kernel<Q, KV, DPL, HC, MMA, PARTIAL>;
  if (c.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(c.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_splits, kh * n_chunks, b);
  kernel<<<grid, kThreads, c.smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), lengths, uniform_len, lo, out, m_out, l_out,
      ws, tickets, s, h,
      kh, dh, n_chunks, split_len, c.tile, c.stages, cpb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename Q, typename KV, bool PARTIAL>
int launch_dpl(const void* q, const void* k, const void* v,
               const int* lengths, int uniform_len, int lo, float* out,
               float* m_out, float* l_out, float* ws,
               int* tickets, int b, int s, int h, int kh, int dh,
               int n_chunks, int n_splits, int split_len, const Config& c,
               float scale, cudaStream_t stream) {
  // the widest copy every row start allows (rows are dh elements, and
  // pos_stride a multiple of them, apart)
  const int row_bytes = dh * static_cast<int>(sizeof(KV));
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  int cpb = 2;
  for (int w = 16; w >= 4; w >>= 1) {
    if (row_bytes % w == 0 && align % w == 0) {
      cpb = w;
      break;
    }
  }
  if (cpb == 2 && sizeof(KV) == 4) return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr bool kMma = sizeof(Q) == 2 && sizeof(KV) == 2;  // bf16 q and K
#define DA_LAUNCH(D, H)                                                        \
  launch<Q, KV, D, H, kMma && H == 8, PARTIAL>(                                \
      q, k, v, lengths, uniform_len, lo, out, m_out, l_out, ws, tickets, b, s, \
      h, kh, dh, n_chunks, n_splits, split_len, c, cpb, scale, stream)
  switch (c.dpl) {
    case 1: return DA_LAUNCH(1, 8);
    case 2: return DA_LAUNCH(2, 8);
    case 4: return DA_LAUNCH(4, 8);
    default: return DA_LAUNCH(8, 4);
  }
#undef DA_LAUNCH
}

// One launch of either form: the whole-cache form (PARTIAL false: lo 0,
// every length in [1, s], m_out and l_out unused) or the partial form over
// the block at lo (module comment).
template <bool PARTIAL>
int launch_any(const void* q, const void* k, const void* v, const int* lengths,
               int uniform_len, int lo, float* out, float* m_out, float* l_out,
               float* ws, int* tickets, int b, int s, int h, int kh, int dh,
               float scale, int q_bf16, int kv_bf16, void* stream) {
  if (b <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  const Config c = make_config(dh, kv_bf16 ? 2 : 4);
  if (c.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (h / kh + c.hc - 1) / c.hc;
  // the splits are cut for the longest row: the block's own length for a
  // uniform one (at least 1: an empty block runs one empty split)
  int max_len = s;
  if (lengths == nullptr) {
    max_len = uniform_len - lo;
    if (max_len > s) max_len = s;
    if (max_len < 1) max_len = 1;
  }
  int n_splits, split_len;
  make_splits(static_cast<long long>(b) * kh * n_chunks, max_len, c.tile,
              &n_splits, &split_len);
  if (n_splits > 1 && (ws == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_KV(QT, KT)                                                          \
  launch_dpl<QT, KT, PARTIAL>(q, k, v, lengths, uniform_len, lo, out, m_out,  \
                              l_out, ws, tickets, b, s, h, kh, dh, n_chunks,  \
                              n_splits, split_len, c, scale, st)
  if (q_bf16) return kv_bf16 ? DA_KV(uint16_t, uint16_t) : DA_KV(uint16_t, float);
  return kv_bf16 ? DA_KV(float, uint16_t) : DA_KV(float, float);
#undef DA_KV
}

}  // namespace
