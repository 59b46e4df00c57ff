"""Per-query step allocation (paper §3.1, Eq. 1-2), twin of
``repro/core/sampling.py``.

    s_q = |E(q)| * (C - log|E(q)|)                       (Eq. 1)
    N_q = w_q * N * s_q / sum_r w_r * s_r                (Eq. 2)

Bit parity with the reference rests on doing the same float32 operations
in the same order:

  * every sum over query slots is an explicit left-to-right chain (XLA's
    CPU reduction order for these short rows);
  * ``log`` is computed in float64 and rounded to float32, so the CPU and
    the card agree with each other (torch's float32 ``log`` differs
    between devices; ``jnp.log`` on XLA's CPU is itself not correctly
    rounded at some integers, e.g. 7 — see ROADMAP Queue 3);
  * every argsort is stable, as JAX's is.

All functions take a leading batch shape: the last axis is the query's
slots.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

IntLike = Union[int, torch.Tensor]


def _sum_last_f32(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis."""
    acc = torch.zeros_like(x[..., 0])
    for s in range(x.shape[-1]):
        acc = acc + x[..., s]
    return acc


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` rounded from float64: the same bits on every device."""
    return torch.log(x.double()).float()


def scaling_factor(degree: torch.Tensor, max_degree: IntLike) -> torch.Tensor:
    """Eq. 1 with C = the max pin degree; degree-0 query pins get 0."""
    deg = degree.float()
    c_lit = torch.clamp(
        torch.as_tensor(max_degree, device=deg.device).float(), min=1.0
    )
    s = deg * (c_lit - log_f32(torch.clamp(deg, min=1.0)))
    return torch.where(degree > 0, torch.clamp(s, min=0.0), 0.0)


def allocate_steps(
    weights: torch.Tensor,
    degrees: torch.Tensor,
    max_degree: IntLike,
    n_total: IntLike,
) -> torch.Tensor:
    """Eq. 2: int32 step budget per query pin, summing to ~n_total.

    Every active (weight > 0, degree > 0) pin gets at least one step.
    ``n_total`` is an int or an int tensor broadcast against the leading
    batch shape (per-lane budgets as data); either form rounds the same.
    """
    s = scaling_factor(degrees, max_degree)
    w = weights.float() * s
    denom = torch.clamp(_sum_last_f32(w), min=1e-9)
    frac = w / denom[..., None]
    total = torch.as_tensor(n_total, device=w.device).float()
    if total.dim():
        total = total[..., None]
    n_q = torch.floor(frac * total).to(torch.int32)
    active = w > 0
    return torch.where(active, torch.clamp(n_q, min=1), 0).to(torch.int32)


def allocate_walkers(
    n_q: torch.Tensor, n_walkers: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a walker pool proportionally to per-slot step budgets.

    Returns ``(slot_of_walker (..., n_walkers), steps_per_walker
    (..., n_slots))``; deterministic largest-remainder apportionment.
    """
    n_slots = n_q.shape[-1]
    total = torch.clamp(n_q.sum(-1, dtype=torch.int32), min=1)
    ratio = torch.tensor(float(n_walkers), device=n_q.device) / total.float()
    ideal = n_q.float() * ratio[..., None]
    base = torch.floor(ideal).to(torch.int32)
    base = torch.where(n_q > 0, torch.clamp(base, min=1), 0)
    short = n_walkers - base.sum(-1, dtype=torch.int32)
    frac = ideal - torch.floor(ideal)
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank_of_slot = torch.argsort(order, dim=-1, stable=True)
    bonus = (rank_of_slot < short[..., None]).to(torch.int32)
    per_slot = torch.clamp(base + bonus, min=0)
    overshoot = per_slot.sum(-1, dtype=torch.int32) - n_walkers
    trim_order = torch.argsort(-per_slot, dim=-1, stable=True)
    trim_rank = torch.argsort(trim_order, dim=-1, stable=True)
    per_slot = torch.where(
        (trim_rank < overshoot[..., None]) & (per_slot > 0),
        per_slot - 1, per_slot,
    )
    bounds = torch.cumsum(per_slot, dim=-1, dtype=torch.int32)
    walker_idx = torch.arange(n_walkers, dtype=torch.int32, device=n_q.device)
    walker_idx = walker_idx.expand(*bounds.shape[:-1], n_walkers).contiguous()
    slot = torch.searchsorted(bounds.contiguous(), walker_idx, right=True)
    slot = torch.clamp(slot, 0, n_slots - 1).to(torch.int32)
    steps_per_walker = torch.where(
        per_slot > 0,
        torch.ceil(n_q.float() / torch.clamp(per_slot, min=1).float()).to(
            torch.int32
        ),
        0,
    )
    return slot, steps_per_walker
