// pointer_chase: the latency of one dependent read from device memory.
//
// A measurement probe, not a port of any kernel: chip_smoke.py times one
// thread that follows a random cycle through an int32 array far larger
// than the 50 MB L2 (idx = next[idx], n_reads times), so every read waits
// for the one before and almost every one misses the caches.  Its time over
// n_reads is the latency of a dependent read that misses L2; the same
// chase through an array that L2 holds gives the latency of one that hits.
// chip_smoke.py prices the walk kernels' chains of dependent reads with
// both.
// The loads are the walk kernels' own kind (const __restrict__ int32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pointer_chase_kernel(const int* __restrict__ next, int start,
                                     long long n_reads,
                                     int* __restrict__ out) {
  int idx = start;
  for (long long k = 0; k < n_reads; ++k) idx = next[idx];
  *out = idx;
}

}  // namespace

// next: a permutation of [0, n) holding one cycle; out: one int32 (the
// last index reached, so the chain is not optimised away).  One thread.
// Returns cudaGetLastError().
extern "C" int pointer_chase_launch(const int* next, int start,
                                    long long n_reads, int* out,
                                    void* stream) {
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      next, start, n_reads, out);
  return static_cast<int>(cudaGetLastError());
}
