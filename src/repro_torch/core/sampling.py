"""Per-query step allocation (paper §3.1, Eq. 1-2), twin of
``repro/core/sampling.py``.

    s_q = |E(q)| * (C - log|E(q)|)                       (Eq. 1)
    N_q = w_q * N * s_q / sum_r w_r * s_r                (Eq. 2)

Bit parity with the reference rests on doing the same float32 operations
in the same order:

  * every sum over query slots is an explicit left-to-right chain (XLA's
    CPU reduction order for these short rows);
  * ``log`` is XLA's CPU float32 ``log`` rebuilt op for op (``log_f32``):
    ``jnp.log`` is not correctly rounded (at 7, for one), and a correctly
    rounded ``log`` moved an Eq. 2 budget by a step;
  * every argsort is stable, as JAX's is.

All functions take a leading batch shape: the last axis is the query's
slots.  ``restart_mask`` and ``step_key`` are the reference's per-step
restart helpers on the port's threefry (``core/prng.py``).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core import prng
from repro_torch.serving import batch_trace

IntLike = Union[int, torch.Tensor]


def restart_mask(key: torch.Tensor, shape, alpha: float) -> torch.Tensor:
    """Per-walker Bernoulli(alpha) restart decisions for one step, the bits
    of ``jax.random.bernoulli(key, alpha, shape)``.

    jax maps a word to a float32 in [0, 1) as ``((bits >> 9) | 0x3f800000)``
    read as a float, minus 1.0, and compares it with ``alpha`` rounded to
    float32.  ``key`` is one ``(2,)`` key; returns a bool tensor on its
    device.
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    words = prng.bits(key, shape)
    u = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u < torch.tensor(alpha, dtype=torch.float32, device=key.device)


def step_key(base: torch.Tensor, step: IntLike) -> torch.Tensor:
    """Counter-based per-step key (``jax.random.fold_in``): stateless and
    restart-reproducible."""
    return prng.fold_in(base, step)


def _sum_last_f32(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis."""
    acc = torch.zeros_like(x[..., 0])
    for s in range(x.shape[-1]):
        acc = acc + x[..., s]
    return acc


# Cephes' logf polynomial (the form of Eigen's plog that XLA's CPU
# backend emits), highest degree first, and ln 2 split in two parts
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


def _fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding, as an FMA
    unit gives), from float64 ops that round alike on every device.

    The product of two float32 values is exact in float64; the float64
    sum is made round-to-odd (its exact error, from Knuth's two-sum,
    nudges an even result one ulp toward the exact value), and a
    round-to-odd float64 rounds to float32 exactly as the exact value
    would (53 >= 24 + 2 bits).
    """
    p = a.double() * (b.double() if torch.is_tensor(b) else float(b))
    cd = c.double() if torch.is_tensor(c) else torch.full_like(p, float(c))
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` with the bits of ``jnp.log`` on XLA's CPU.

    XLA's CPU backend emits Cephes' ``logf``: frexp to [0.5, 1), a shift
    below sqrt(1/2), the degree-8 polynomial in three interleaved Horner
    parts, and ln 2 added back in two parts.  Its multiply-adds are fused,
    and so is ``y * x^3 + e * q1``; this function makes the same fused
    roundings with ``_fma_f32``.  It equals ``jnp.log`` at every integer
    in [1, 2**24] (checked) and gives the same bits on the CPU and the
    card.  0 and subnormals give -inf (XLA's CPU flushes subnormals to
    0), +inf gives +inf, negatives and NaN give NaN.
    """
    x = x.float()
    m, e = torch.frexp(x)
    e = e.float()
    below = m < _f32(_SQRTHF)
    e = e - below.float()
    m = (m - 1.0) + torch.where(below, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = [_f32(c) for c in _LOG_P]
    y = _fma_f32(m, p[0], p[1])
    y1 = _fma_f32(m, p[3], p[4])
    y2 = _fma_f32(m, p[6], p[7])
    y = _fma_f32(y, m, p[2])
    y1 = _fma_f32(y1, m, p[5])
    y2 = _fma_f32(y2, m, p[8])
    y = _fma_f32(y, x3, y1)
    y = _fma_f32(y, x3, y2)
    y = _fma_f32(y, x3, e * _f32(_LOG_Q1))
    out = (m - x2 * 0.5) + y
    out = out + e * _f32(_LOG_Q2)
    out = torch.where(x < 2.0**-126, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0) | torch.isnan(x), float("nan"), out)


def scaling_factor(degree: torch.Tensor, max_degree: IntLike) -> torch.Tensor:
    """Eq. 1 with C = the max pin degree; degree-0 query pins get 0."""
    deg = degree.float()
    if not torch.is_tensor(max_degree):
        batch_trace.host_sync("walk.plan")      # an int copied to the device
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
    if not torch.is_tensor(n_total):
        batch_trace.host_sync("walk.plan")
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
    batch_trace.host_sync("walk.plan")          # a float copied to the device
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
