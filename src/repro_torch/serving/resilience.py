"""Degraded-mode serving policy: elastic walk budgets and the degradation
metric (twin of ``repro/serving/resilience.py``; host-side numpy).

  * ``elastic_step_budget``: the deadline-aware shed policy ``PixieServer``
    applies at dispatch.  Once a request's queue wait passes
    ``shed_start_ms``, its Eq. 2 step budget shrinks linearly toward
    ``min_budget_frac`` of its steps over the rest of ``deadline_ms``: a
    shed request is served with fewer steps, never dropped.  A pure
    function of the logical clock, so a chaos run replays exactly.
  * ``overlap_at_k``: the share of an oracle's top-k ids a degraded run
    recovered.

Admission control (bounded bucket queues) lives on the server;
``ResilienceConfig`` may carry its bound so the policy is one object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Degraded-mode policy for one ``PixieServer`` replica.

    ``deadline_ms`` is the per-request latency target; waits up to
    ``shed_start_ms`` keep the full budget (so an unloaded replica equals
    one without this layer, bit for bit); ``min_budget_frac`` floors the
    shrink.  ``max_queue_per_bucket`` optionally carries the admission
    bound.  ``elastic=False`` keeps admission but never shrinks a budget
    (the setting for ranked replicas, which carry no budgets).
    """

    deadline_ms: float = 60.0
    shed_start_ms: float = 10.0
    min_budget_frac: float = 0.25
    elastic: bool = True
    max_queue_per_bucket: Optional[int] = None

    def __post_init__(self):
        if self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {self.deadline_ms}"
            )
        if not 0 <= self.shed_start_ms < self.deadline_ms:
            raise ValueError(
                f"shed_start_ms={self.shed_start_ms} must lie in "
                f"[0, deadline_ms={self.deadline_ms}): shrink must start "
                "before the deadline or the policy can never engage"
            )
        if not 0 < self.min_budget_frac <= 1:
            raise ValueError(
                f"min_budget_frac={self.min_budget_frac} must be in "
                "(0, 1]: zero-step service is a drop"
            )


def elastic_step_budget(
    n_steps: int, wait_ms: float, rcfg: ResilienceConfig
) -> int:
    """Deadline-aware Eq. 2 budget for one request at dispatch time:
    full ``n_steps`` up to ``shed_start_ms`` of wait, then a linear shrink
    across the rest of the deadline, floored at ``min_budget_frac *
    n_steps`` and at 1 step."""
    if wait_ms <= rcfg.shed_start_ms:
        return int(n_steps)
    span = rcfg.deadline_ms - rcfg.shed_start_ms
    frac = (rcfg.deadline_ms - wait_ms) / span
    frac = max(rcfg.min_budget_frac, min(1.0, frac))
    return max(1, int(frac * n_steps))


def overlap_at_k(
    ids_a: np.ndarray, ids_b: np.ndarray, k: Optional[int] = None
) -> float:
    """Top-k id overlap between a degraded run and its oracle, in [0, 1]:
    set intersection over the first ``k`` ids of each row (default the
    full width), averaged over rows; ids < 0 (padding) are ignored."""
    a = np.atleast_2d(np.asarray(ids_a))
    b = np.atleast_2d(np.asarray(ids_b))
    if a.shape[0] != b.shape[0]:
        raise ValueError(
            f"overlap_at_k got {a.shape[0]} degraded rows vs "
            f"{b.shape[0]} oracle rows; compare the same queries"
        )
    if k is None:
        k = min(a.shape[1], b.shape[1])
    fracs = []
    for i in range(a.shape[0]):
        sa = set(int(x) for x in a[i, :k] if x >= 0)
        sb = set(int(x) for x in b[i, :k] if x >= 0)
        if not sb:
            fracs.append(1.0 if not sa else 0.0)
            continue
        fracs.append(len(sa & sb) / len(sb))
    return float(np.mean(fracs)) if fracs else 1.0
