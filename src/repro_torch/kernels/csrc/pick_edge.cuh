// The edge pick shared by the walk kernels (walk_steps_fused.cu,
// walk_hop.cu and walk_step.cu): one piece of code, so a fused superstep,
// the sharded engine's split hops and the legacy one-superstep walk choose
// the same edge from the same random word.
//
// Port of _pick_edge in src/repro/kernels/walk_step.py and of the
// `start + r % max(deg, 1)` pick of kernels/ref.py.

#pragma once

#include <stdint.h>

namespace pixie {

// Random words are uint32; a pick uses the low 31 bits as a non-negative
// int (the reference's `r & _RMASK` before the int cast).
constexpr uint32_t kRMask = 0x7FFFFFFFu;

// Uniform over [start, start + deg), or over the feature subrange
// [start + lo, start + hi) when use_sub (the bias draw fired) and it is
// non-empty.  Callers guarantee deg > 0.  The bounds come in registers, so
// a caller can read them beside the row's offsets.
__device__ __forceinline__ int pick_edge_in(int start, int deg, int r,
                                            bool use_sub, int lo, int hi) {
  int base = start;
  int span = deg;
  if (use_sub && hi > lo) {
    base = start + lo;
    span = hi - lo;
  }
  return base + r % span;
}

// The same pick reading the bounds fb_row[feat], fb_row[feat + 1] itself;
// fb_row is null for an unbiased pick.
__device__ __forceinline__ int pick_edge(int start, int deg, int r,
                                         bool use_b, const int* fb_row,
                                         int feat) {
  if (fb_row != nullptr && use_b) {
    return pick_edge_in(start, deg, r, true, fb_row[feat], fb_row[feat + 1]);
  }
  return start + r % deg;
}

}  // namespace pixie
