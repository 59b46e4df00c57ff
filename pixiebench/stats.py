"""The arithmetic the readers share: percentiles over every request, and
means over batches."""

from __future__ import annotations

import math
from typing import Sequence


def nearest_rank(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile by nearest rank: the smallest value with at
    least ``p`` percent of the values at or below it.  Well defined where
    some values are ``inf`` (requests that never got an answer)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(p / 100.0 * len(ordered)) - 1)]


def mean_batch_compute_ms(run) -> float:
    """Mean of ``QueryResult.compute_ms`` over the batches answered before
    the profiler started: the server's own span from a batch's dispatch
    to the end of ``harvest``'s wait on its completion event."""
    per_batch = {r.batch_seq: r.compute_ms for r in run.untraced}
    return sum(per_batch.values()) / len(per_batch) if per_batch else None
