// embedding_bag: fixed-size bags of table rows pooled by weight, sum or mean.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/embedding_bag.py: the
// one body _embedding_bag_kernel, launched by _bag_pallas_call for both
// entry points, embedding_bag ((n, l) bags) and embedding_bag_batched
// ((b, k, l) bags, flattened to (b * k, l) by the wrapper).
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
// and weights read once and the output written once; the arithmetic is a
// few operations per byte.  At the serving path's shapes (a 64 x 8 neighbor
// bag and a 1 x 64 query bag per request) the work is a few tens of
// kilobytes, so the launch and one dependent row read per element are the
// time.  Design: one warp per bag, lanes across d with a stride of 32 (a
// row of 32 float32 is one coalesced 128-byte read), the bag's ids and
// weights read by every lane of the warp (one broadcast load each), rows
// gathered straight from device memory with no shared-memory staging.  The
// TPU's block of bags per grid cell was a VMEM tile; blocks of 8 warps take
// its place and carry nothing from one to the next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void embedding_bag_kernel(const int* __restrict__ ids,
                                     const float* __restrict__ weights,
                                     const T* __restrict__ table,
                                     T* __restrict__ out, long long n, int l,
                                     long long v, int d, int mean) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long bag = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                       (threadIdx.x >> 5);
       bag < n; bag += warps) {
    const int* bag_ids = ids + bag * l;
    const float* bag_w = weights + bag * l;
    T* bag_out = out + bag * d;
    for (int c = lane; c < d; c += 32) {
      float acc = 0.0f;
      float wsum = 0.0f;
      for (int j = 0; j < l; ++j) {
        const int id = bag_ids[j];
        const bool valid = id >= 0 && id < v;
        const long long row = valid ? id : 0;
        const float w = __fmul_rn(bag_w[j], valid ? 1.0f : 0.0f);
        const float x = load_f32(table + row * d + c);
        acc = __fadd_rn(acc, __fmul_rn(x, w));
        wsum = __fadd_rn(wsum, w);
      }
      if (mean) acc = __fdiv_rn(acc, wsum < 1.0f ? 1.0f : wsum);
      store(bag_out + c, acc);
    }
  }
}

}  // namespace

// out (n, d) = pooled bags of ids (n, l) int32 and weights (n, l) float32
// over table (v, d); table and out are float32, or bf16 when bf16 != 0.
// Every pointer is to contiguous device memory.  Returns cudaGetLastError().
extern "C" int embedding_bag_launch(const int* ids, const float* weights,
                                    const void* table, void* out, long long n,
                                    int l, long long v, int d, int mean,
                                    int bf16, void* stream) {
  if (n > 0 && d > 0) {
    long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int grid = static_cast<int>(blocks < 65535 ? blocks : 65535);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
      embedding_bag_kernel<__nv_bfloat16><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
          ids, weights, static_cast<const __nv_bfloat16*>(table),
          static_cast<__nv_bfloat16*>(out), n, l, v, d, mean);
    } else {
      embedding_bag_kernel<float><<<grid, 32 * kWarpsPerBlock, 0, s>>>(
          ids, weights, static_cast<const float*>(table),
          static_cast<float*>(out), n, l, v, d, mean);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
