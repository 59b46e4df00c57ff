"""The comparison that decides ``correct`` for the kind ``pixie``, and the
limit of each number.  ``verdict``, ``lines`` and ``as_json`` take any
kind's limits (Pixie's by default).

Every number is exact, so every limit is 0 (the readings they were set
from are in PERF.md):

  * ``csr_mismatch``: arrays of the program's compiled graph (both
    directions' offsets, targets and language bounds, and the largest pin
    degree) that differ from the reference's compile of the same edges;
  * ``unanswered``: requests due in the window that never got an answer
    (refused, failed, or still out when the run stopped waiting);
  * ``id_mismatch``: top-k positions of the sampled requests whose pin id
    differs from the reference's;
  * ``score_gap``: the largest absolute difference between a sampled
    request's served score and the reference's at the same position.

The control, the reference with its float32 boost taken in bfloat16,
fails ``score_gap`` on every seed tried.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from pixiebench import reference

LIMITS = {"csr_mismatch": 0, "unanswered": 0, "id_mismatch": 0, "score_gap": 0.0}
# the gap read where scores cannot be compared (another shape, NaN)
NO_COMPARISON = float(np.finfo(np.float32).max)


def csr_mismatch(program: reference.Graph, ref: reference.Graph) -> int:
    """Arrays of the program's compiled graph (held on the host) unequal to
    the reference's, and the largest pin degree if it differs."""
    bad = 0
    for mine, theirs in ((program.p2b, ref.p2b), (program.b2p, ref.b2p)):
        for a, b in zip(mine, theirs):
            same = (a is not None and a.shape == b.shape and a.dtype == b.dtype
                    and torch.equal(a.to(b.device), b))
            bad += not same
    return bad + int(program.max_pin_degree != ref.max_pin_degree)


def sample(ids: Iterable[int], k: int, seed: int) -> List[int]:
    """``k`` of ``ids`` (all if fewer), drawn from the run's seed."""
    ids = sorted(ids)
    rng = np.random.default_rng([int(seed) % 2**63, 2])
    if len(ids) <= k:
        return ids
    return sorted(int(i) for i in rng.choice(ids, size=k, replace=False))


def compare(served: Dict[int, tuple], expected: Dict[int, tuple]) -> Dict[str, float]:
    """``id_mismatch`` and ``score_gap`` over the requests in ``expected``;
    each value is ``(scores, ids)`` as numpy arrays."""
    ids_off, gap = 0, 0.0
    for rid, (want_s, want_i) in expected.items():
        got_s, got_i = served[rid]
        got_s = np.asarray(got_s, np.float64)
        got_i = np.asarray(got_i)
        want_s = np.asarray(want_s, np.float64)
        if got_i.shape != want_i.shape:
            ids_off += int(want_i.size)
            gap = NO_COMPARISON
            continue
        ids_off += int((got_i != want_i).sum())
        diff = float(np.abs(got_s - want_s).max()) if want_s.size else 0.0
        gap = max(gap, diff if np.isfinite(diff) else NO_COMPARISON)
    return {"id_mismatch": ids_off, "score_gap": gap}


def verdict(numbers: Dict[str, float], limits: Dict[str, float] = LIMITS) -> bool:
    return all(numbers[name] <= limit for name, limit in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float] = LIMITS) -> List[str]:
    """Each number beside its limit, one a line (the run's last stderr lines)."""
    return [f"check {name} {numbers[name]!r} limit {limit!r}" for name, limit in limits.items()]


def as_json(numbers: Dict[str, float], limits: Dict[str, float] = LIMITS) -> dict:
    return {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
