"""Sequential numpy oracle of Algorithms 1-3, twin of
``repro/core/reference.py``, line for line.

Tests hold the port's vectorized walk against it *statistically*: on a
small graph the normalized visit distributions of the two must be close
(the walkers are i.i.d., so the vectorized walk is the same Markov chain
run W times).  It mirrors the paper's pseudocode, including the
hash-table-style counter and the per-step early-stopping check, and
draws from numpy's ``default_rng`` exactly as the reference does, so one
seed gives the reference's visits bit for bit on the same graph.  The
port's graph is read once through ``.cpu().numpy()``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.graph import PinBoardGraph


class _HostGraph:
    """Numpy view of the CSR arrays for fast sequential access."""

    def __init__(self, g: PinBoardGraph):
        host = lambda t: None if t is None else t.cpu().numpy()
        self.p2b_off = host(g.p2b.offsets)
        self.p2b_tgt = host(g.p2b.targets)
        self.b2p_off = host(g.b2p.offsets)
        self.b2p_tgt = host(g.b2p.targets)
        self.p2b_fb = host(g.p2b.feat_bounds)
        self.b2p_fb = host(g.b2p.feat_bounds)
        self.n_pins = g.n_pins
        self.max_pin_degree = g.max_pin_degree

    def pin_degree(self, p: int) -> int:
        return int(self.p2b_off[p + 1] - self.p2b_off[p])

    def sample_board(self, rng, p: int, feat: Optional[int], beta: float) -> int:
        lo, hi = int(self.p2b_off[p]), int(self.p2b_off[p + 1])
        if hi == lo:
            return -1
        if (
            feat is not None
            and self.p2b_fb is not None
            and rng.random() < beta
        ):
            flo = lo + int(self.p2b_fb[p, feat])
            fhi = lo + int(self.p2b_fb[p, feat + 1])
            if fhi > flo:
                return int(self.p2b_tgt[rng.integers(flo, fhi)])
        return int(self.p2b_tgt[rng.integers(lo, hi)])

    def sample_pin(self, rng, b_local: int, feat: Optional[int], beta: float) -> int:
        lo, hi = int(self.b2p_off[b_local]), int(self.b2p_off[b_local + 1])
        if hi == lo:
            return -1
        if (
            feat is not None
            and self.b2p_fb is not None
            and rng.random() < beta
        ):
            flo = lo + int(self.b2p_fb[b_local, feat])
            fhi = lo + int(self.b2p_fb[b_local, feat + 1])
            if fhi > flo:
                return int(self.b2p_tgt[rng.integers(flo, fhi)])
        return int(self.b2p_tgt[rng.integers(lo, hi)])


def sample_walk_length(rng, alpha: float, cap: int = 10_000) -> int:
    """Geometric(alpha) segment length — E[len] = 1/alpha."""
    return min(int(rng.geometric(alpha)), cap)


def basic_random_walk_ref(
    graph: PinBoardGraph, q: int, alpha: float, n_steps: int, seed: int = 0
) -> np.ndarray:
    """Algorithm 1, verbatim."""
    g = _HostGraph(graph)
    rng = np.random.default_rng(seed)
    visits = np.zeros(g.n_pins, dtype=np.int64)
    tot_steps = 0
    while tot_steps < n_steps:
        curr = q
        curr_steps = sample_walk_length(rng, alpha)
        for _ in range(curr_steps):
            b = g.sample_board(rng, curr, None, 0.0)
            if b < 0:
                break
            p = g.sample_pin(rng, b - g.n_pins, None, 0.0)
            if p < 0:
                break
            curr = p
            visits[curr] += 1
        tot_steps += curr_steps
    return visits


def pixie_random_walk_ref(
    graph: PinBoardGraph,
    q: int,
    user_feat: Optional[int],
    alpha: float,
    n_steps: int,
    n_p: int,
    n_v: int,
    beta: float = 0.9,
    seed: int = 0,
) -> np.ndarray:
    """Algorithm 2, verbatim (per-step early-stopping check)."""
    g = _HostGraph(graph)
    rng = np.random.default_rng(seed)
    visits = np.zeros(g.n_pins, dtype=np.int64)
    tot_steps = 0
    n_high = 0
    while True:
        curr = q
        curr_steps = sample_walk_length(rng, alpha)
        for _ in range(curr_steps):
            b = g.sample_board(rng, curr, user_feat, beta)
            if b < 0:
                break
            p = g.sample_pin(rng, b - g.n_pins, user_feat, beta)
            if p < 0:
                break
            curr = p
            visits[curr] += 1
            if visits[curr] == n_v:
                n_high += 1
        tot_steps += curr_steps
        if tot_steps >= n_steps or n_high > n_p:
            break
    return visits


def scaling_factor_ref(deg: int, max_deg: int) -> float:
    """Eq. 1."""
    if deg <= 0:
        return 0.0
    return deg * (max(max_deg, 1) - np.log(max(deg, 1)))


def pixie_random_walk_multiple_ref(
    graph: PinBoardGraph,
    query: Dict[int, float],
    user_feat: Optional[int],
    alpha: float,
    n_steps: int,
    n_p: int,
    n_v: int,
    beta: float = 0.9,
    seed: int = 0,
) -> np.ndarray:
    """Algorithm 3: per-query budgets (Eq. 2) + booster (Eq. 3)."""
    g = _HostGraph(graph)
    pins = list(query.keys())
    w = np.array([query[p] for p in pins], dtype=np.float64)
    s = np.array(
        [scaling_factor_ref(g.pin_degree(p), g.max_pin_degree) for p in pins]
    )
    ws = w * s
    denom = max(ws.sum(), 1e-9)
    boosted = np.zeros(g.n_pins, dtype=np.float64)
    for i, p in enumerate(pins):
        n_q = int(np.floor(ws[i] / denom * n_steps))
        if n_q <= 0:
            continue
        v = pixie_random_walk_ref(
            graph, p, user_feat, alpha, n_q, n_p, n_v, beta, seed=seed + i
        )
        boosted += np.sqrt(v.astype(np.float64))
    return boosted**2
