"""Embedding-bag kernel (``csrc/embedding_bag.cu``) and its plain twins.

Twins of ``repro/kernels/embedding_bag.py``'s ``embedding_bag`` ((n, l)
bags -> (n, d)) and ``embedding_bag_batched`` ((b, k, l) bags ->
(b, k, d)).  As in the reference, both entry points flatten their bags to
``(rows, l)`` and share one body: ``_bag_launch`` for the kernel,
``_bag_plain`` for the twin, so the two shapes agree by construction.
``embedding_bag_pair`` (port-internal) pools two query-batched bag sets
over one table and mode in one launch: the ranked request's neighbor and
query bags, which the reference pools with two calls; its twin
``embedding_bag_pair_plain`` is two twin calls.

Per bag, in ascending element order: ``w = weight * valid``, ``acc += row *
w``, ``wsum += w``; mean mode divides by ``max(wsum, 1)``; the output is
rounded to the table's dtype (float32 or bf16), accumulated in float32.
An id is valid iff ``0 <= id < v``; an invalid id reads row 0 with weight
0, as the reference's kernel does (-1 is the padding id).

The twin is the port of ``ref.embedding_bag_batched_ref``: one torch op
per multiply and per add, so nothing is contracted into an FMA, and the
kernel rounds at the same places with ``_rn`` intrinsics: kernel and twin
agree bit for bit.  ``block_b`` (bags per TPU grid cell, a VMEM knob) is
accepted and validated; the CUDA kernel has one design for every value.
The kernel wrappers take CUDA tensors only.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_B = 64
MODES = ("sum", "mean")
DTYPES = (torch.float32, torch.bfloat16)

_SET = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
_ARGTYPES = _SET * 2 + [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def _flat_args(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    mode: str,
    block_b: int,
    bag_dims: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate and flatten ``ids``/``weights`` to ``(rows, l)``; ``None``
    weights become ones, as in the reference."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    if ids.dim() != bag_dims:
        raise ValueError(
            f"ids must have {bag_dims} dims (bags..., bag_size), got shape "
            f"{tuple(ids.shape)}"
        )
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must be (v >= 1, d), got {tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    rows = 1
    for n in ids.shape[:-1]:
        rows *= int(n)
    l = ids.shape[-1]
    ids2 = ids.reshape(rows, l)
    if weights is None:
        w2 = torch.ones(ids2.shape, dtype=torch.float32, device=ids.device)
    else:
        if weights.shape != ids.shape:
            raise ValueError(
                f"weights shape {tuple(weights.shape)} differs from ids shape "
                f"{tuple(ids.shape)}"
            )
        w2 = weights.reshape(rows, l).float()
    return ids2, w2


def _bag_launch(table, mode: str, *sets) -> List[torch.Tensor]:
    """ONE launch of the CUDA kernel over one or two ``(ids2, w2)`` sets of
    ``(rows, l)`` bags on the same table; returns each set's ``(rows, d)``
    output."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag runs on CUDA tensors, got {dev}")
    table = table.contiguous()
    v, d = table.shape
    args, outs = [], []
    for ids2, w2 in sets:
        for name, t in (("ids", ids2), ("weights", w2)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, expected {dev}")
        ids2, w2 = ids2.contiguous(), w2.contiguous()
        n, l = ids2.shape
        out = torch.empty((n, d), dtype=table.dtype, device=dev)
        args += [ids2.data_ptr(), w2.data_ptr(), out.data_ptr(), n, l]
        outs.append(out)
    if len(sets) == 1:
        args += [None, None, None, 0, 0]
    if d == 0 or not any(o.shape[0] for o in outs):
        return outs                       # nothing to pool: no launch
    fn = _build.library("embedding_bag").embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    err = fn(
        *args, table.data_ptr(), v, d, int(mode == "mean"),
        int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "embedding_bag")
    _build.launches["embedding_bag"] += 1
    return outs


def _bag_plain(ids2, w2, table, mode: str) -> torch.Tensor:
    """Plain twin over ``(rows, l)`` bags: one chain per bag, ascending."""
    n, l = ids2.shape
    v, d = table.shape
    acc = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    wsum = torch.zeros((n,), dtype=torch.float32, device=table.device)
    for j in range(l):
        idx = ids2[:, j]
        valid = (idx >= 0) & (idx < v)
        rows = table[torch.where(valid, idx, 0).long()].float()
        w = w2[:, j] * valid.float()
        acc = acc + rows * w[:, None]
        wsum = wsum + w
    if mode == "mean":
        acc = acc / torch.clamp(wsum, min=1.0)[:, None]
    return acc.to(table.dtype)


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    mode: str = "sum",
    block_b: int = DEFAULT_BLOCK_B,
) -> torch.Tensor:
    """Pooled lookup on the card: ``(n, l)`` bags -> ``(n, d)``."""
    return _bag_launch(table, mode, _flat_args(table, ids, weights, mode,
                                               block_b, 2))[0]


def embedding_bag_batched(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    mode: str = "sum",
    block_b: int = DEFAULT_BLOCK_B,
) -> torch.Tensor:
    """Query-batched pooled lookup on the card: ``(b, k, l)`` bags ->
    ``(b, k, d)``, one launch for the whole batch."""
    b, k, _ = ids.shape
    out = _bag_launch(table, mode, _flat_args(table, ids, weights, mode,
                                              block_b, 3))[0]
    return out.reshape(b, k, table.shape[1])


def embedding_bag_pair(
    table: torch.Tensor,
    ids_a: torch.Tensor,
    weights_a: Optional[torch.Tensor],
    ids_b: torch.Tensor,
    weights_b: Optional[torch.Tensor],
    *,
    mode: str = "sum",
    block_b: int = DEFAULT_BLOCK_B,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two query-batched bag sets over one table and mode, pooled by ONE
    launch: ``(b, k, l)`` and ``(b', k', l')`` bags -> ``(b, k, d)`` and
    ``(b', k', d)``, bit-identical to two ``embedding_bag_batched`` calls
    (the ranked request's neighbor and query bags; port-internal: the
    reference makes two calls)."""
    sets = [_flat_args(table, i, w, mode, block_b, 3)
            for i, w in ((ids_a, weights_a), (ids_b, weights_b))]
    outs = _bag_launch(table, mode, *sets)
    return tuple(o.reshape(*i.shape[:2], table.shape[1])
                 for o, i in zip(outs, (ids_a, ids_b)))


def embedding_bag_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    mode: str = "sum",
    block_b: int = DEFAULT_BLOCK_B,
) -> torch.Tensor:
    """Plain twin of ``embedding_bag``."""
    ids2, w2 = _flat_args(table, ids, weights, mode, block_b, 2)
    return _bag_plain(ids2, w2, table, mode)


def embedding_bag_batched_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    mode: str = "sum",
    block_b: int = DEFAULT_BLOCK_B,
) -> torch.Tensor:
    """Plain twin of ``embedding_bag_batched``."""
    ids2, w2 = _flat_args(table, ids, weights, mode, block_b, 3)
    b, k, _ = ids.shape
    return _bag_plain(ids2, w2, table, mode).reshape(b, k, table.shape[1])


def embedding_bag_pair_plain(
    table: torch.Tensor,
    ids_a: torch.Tensor,
    weights_a: Optional[torch.Tensor],
    ids_b: torch.Tensor,
    weights_b: Optional[torch.Tensor],
    *,
    mode: str = "sum",
    block_b: int = DEFAULT_BLOCK_B,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``embedding_bag_pair``: two twin calls."""
    return tuple(
        embedding_bag_batched_plain(table, i, w, mode=mode, block_b=block_b)
        for i, w in ((ids_a, weights_a), (ids_b, weights_b)))
