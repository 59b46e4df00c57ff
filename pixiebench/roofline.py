"""Peaks of one NVIDIA H100 SXM and the least time a kernel's work needs.

Peaks are the data sheet's, which assume the card's full 700 W; a run
prints the card's power limit beside them.  ``INT32_OPS_PER_S`` is the
data sheet's 67 TFLOP/s of float32 outside the tensor cores over 4: that
rate counts an FMA as two operations, and an SM has half as many 32-bit
integer lanes as float32 lanes (132 SMs x 64 lanes x 1.98 GHz).

The work is what the requests needed, counted by the reference from the
same requests, never from launches or buffer sizes, so a share reads the
same work whatever implements the kernel:

  * ``walk_steps_fused``: each walker-step a request took draws four
    threefry words (``chip_smoke.walk_ops``: 72 operations a block, one
    xor more a word) and writes its query, slot and pin event lanes;
    each (query, chunk) draws ``chunk_steps`` step keys;
  * ``visit_counter_update_high``: each visit event counted is read
    once (three int32 lanes), and each distinct bin it touched in its
    chunk is read and written once.

The least time is the larger of bytes over bandwidth and operations over
the integer rate; the share is that over the kernel's profiled device
time, and cannot pass 100% while the counts are lower bounds.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
THREEFRY_OPS = 72
LANE_BYTES = 4
EVENT_LANES = 3        # query, slot and pin lanes of the batch-native engine


class Work(NamedTuple):
    """What the profiled stretch's requests needed, from the reference."""
    walker_steps: int      # sum of steps_taken
    query_chunks: int      # (request, chunk) pairs the walk ran
    events: int            # valid visit events counted
    distinct_bins: int     # distinct bins touched, summed over chunks


def walk_ops(n_keys: int, walkers: int, chunk_steps: int) -> int:
    """``chip_smoke.walk_ops``: 32-bit operations of one chunk's words."""
    return chunk_steps * (n_keys * THREEFRY_OPS + 4 * walkers * (THREEFRY_OPS + 1))


def walk_least_s(work: Work, chunk_steps: int) -> float:
    ops = (walk_ops(1, 0, chunk_steps) * work.query_chunks
           + 4 * (THREEFRY_OPS + 1) * work.walker_steps)
    nbytes = EVENT_LANES * LANE_BYTES * work.walker_steps
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def counter_least_s(work: Work) -> float:
    nbytes = EVENT_LANES * LANE_BYTES * work.events + 2 * LANE_BYTES * work.distinct_bins
    return nbytes / HBM_BYTES_PER_S


def share(least_s: float, measured_s: float):
    """Percent of the roofline, or None where the kernel never ran or the
    requests needed none of its work."""
    if measured_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / measured_s
