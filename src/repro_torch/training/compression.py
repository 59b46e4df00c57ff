"""int8 error-feedback gradient compression for the data-parallel all-reduce.

Twin of ``repro/training/compression.py``.  Quantising the all-reduce
payload to int8 cuts it 4x; error feedback keeps each shard's
quantisation residual and adds it back before the next round, so the
compression error stays O(1) instead of O(T).

``quantize`` is per-tensor symmetric int8 (``scale = max(max|g|, 1e-12) /
127``, values rounded half to even and clipped to ``[-127, 127]``);
``dequantize`` and ``init_residual`` as the reference's.
``compressed_psum(grads, residual, fabric)`` takes the reference's
``axis_name`` as a data-axis fabric (``core.distributed``'s
``LocalFabric`` or ``ProcessGroupFabric``): each leaf carries the
fabric's leading local shard dim.  The shards agree on one scale by a
``pmax``, quantise, sum the int8 payload in int32, and divide by their
count.  Every value equals the reference's bit for bit: every division is
a true float32 division (a 0-d tensor divisor; torch on the card would
multiply by the reciprocal of a Python float), and the residual is one
rounding of ``g_eff - q * scale``, the fused multiply-add that XLA's CPU
backend emits for it (``q * scale`` is exact in float64).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training import tree as tree_lib

PyTree = Any


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    div = torch.tensor(127.0, dtype=g.dtype, device=g.device)
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / div
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _f32_div(x: torch.Tensor, d) -> torch.Tensor:
    return x / torch.as_tensor(d, dtype=torch.float32, device=x.device)


def compressed_psum(grads: PyTree, residual: PyTree, fabric) -> Tuple[PyTree, PyTree]:
    """Error-feedback int8 psum over ``fabric``'s shards.

    Each leaf of ``grads`` and ``residual`` is ``(S_local, ...)``, one row a
    local shard.  Returns ``(reduced, new residual)``: the mean of the
    shards' dequantised payloads in float32, ``(...)`` (the same on every
    shard), and each shard's residual ``(S_local, ...)``."""
    n = fabric.n_shards

    def one(g, r):
        g_eff = g.float() + r
        # the shards agree on ONE scale before quantizing: a scalar pmax
        gmax = fabric.pmax(torch.abs(g_eff).flatten(1).amax(1))
        scale = _f32_div(torch.clamp(gmax, min=1e-12), 127.0)
        q = torch.clamp(torch.round(g_eff / scale), -127, 127).to(torch.int8)
        # the int8 payload summed in int32
        q_sum = fabric.psum(q.to(torch.int32))
        reduced = _f32_div(q_sum.float() * scale, n)
        new_r = (g_eff.double() - q.double() * scale.double()).float()
        return reduced, new_r

    out = [one(g, r) for g, r in zip(tree_lib.leaves(grads), tree_lib.leaves(residual))]
    return (tree_lib.unflatten(grads, [o[0] for o in out]),
            tree_lib.unflatten(grads, [o[1] for o in out]))


def init_residual(params: PyTree) -> PyTree:
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
