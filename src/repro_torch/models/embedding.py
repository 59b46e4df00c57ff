"""The recsys mega-table: every sparse feature's rows in one table.

Twin of ``repro/models/embedding.py``.  All per-feature tables are
concatenated into ONE ``(total_rows, dim)`` tensor with per-feature row
offsets, ``total_rows`` padded to ``pad_to_multiple`` so any shard count
that divides it splits the table evenly.  Two lookup paths:

  * ``lookup``: a gather of global rows;
  * ``lookup_sharded``: each shard masks the ids outside its row range,
    gathers locally, and one ``fabric.psum`` combines the shards.  The
    fabric is ``core.distributed``'s ``LocalFabric`` (every shard on one
    device: the shards are views of one table) or ``ProcessGroupFabric``
    (one shard a rank, holding its own rows), in place of the
    reference's mesh and ``shard_map``.

Out-of-range ids are read as the reference reads them, without a host
sync:

  * ``take_rows`` is ``jnp.take(table, ids, axis=0)``: a negative id wraps
    once (``-1`` is the last row), and an id still outside the table
    gives a row of NaN;
  * ``lookup_sharded`` wraps nothing: a row no shard owns (negative or
    past the table) is a row of zeros.

``pooled_lookup`` is the reference's plain gather and sum (its docstring
names ``kernels/embedding_bag.py`` as a twin, but the function itself is
``jnp.take`` and a sum), so it launches no kernel here either.

``init_table`` draws from an explicit ``torch.Generator`` on its device,
with the reference's scale; its numbers are not ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import abstract
from repro_torch.core.distributed import reduce_from
from repro_torch.device import DeviceLike, on_card, resolve_device


@dataclasses.dataclass(frozen=True)
class MegaTableConfig:
    feature_rows: Tuple[int, ...]   # rows per sparse feature
    dim: int
    pad_to_multiple: int = 512      # row padding so any shard count divides

    @property
    def n_features(self) -> int:
        return len(self.feature_rows)

    @property
    def total_rows(self) -> int:
        raw = int(sum(self.feature_rows))
        m = self.pad_to_multiple
        return -(-raw // m) * m

    def offsets(self, device: DeviceLike = None) -> torch.Tensor:
        """Each feature's first global row, ``(n_features,)`` int32."""
        off = np.concatenate([[0], np.cumsum(self.feature_rows)[:-1]])
        return torch.as_tensor(off.astype(np.int32), device=resolve_device(device))


def init_table(gen: torch.Generator, cfg: MegaTableConfig,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(total_rows, dim)`` normal draws times ``dim ** -0.5``, drawn in
    ``dtype`` on ``gen``'s device and scaled in place (a full-width table
    is tens of GB: no second copy)."""
    table = torch.randn((cfg.total_rows, cfg.dim), generator=gen, dtype=dtype,
                        device=gen.device)
    return table.mul_(cfg.dim ** -0.5)


def abstract_table(cfg: MegaTableConfig, dtype=torch.float32) -> torch.Tensor:
    """``init_table``'s shape and dtype as a meta tensor."""
    return abstract.meta((cfg.total_rows, cfg.dim), dtype)


def table_logical() -> Tuple[str, str]:
    return ("rows", "dim")


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` for ids in range, whose backward adds each row's
    gradients in an order fixed by the ids: ``index_put_(accumulate=True)``
    on CUDA (torch sorts the ids and adds each row's run in order) and
    ``index_add_`` on the CPU (one id after another).  Autograd's own
    backward of ``table[idx]`` adds float32 rows with atomics on the CPU
    once the gradient passes 32,768 elements, in another order each run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = grad.reshape((flat.numel(),) + grad.shape[idx.dim():])
        out = g.new_zeros((ctx.n_rows,) + g.shape[1:])
        if on_card(g):
            out.index_put_((flat,), g, accumulate=True)
        else:
            out.index_add_(0, flat, g)
        return out, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (``idx`` int64, every id in range) with a backward
    that gives the same bits every run on either device."""
    return _GatherRows.apply(table, idx)


def wrap_ids(ids: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.take``'s index rule over ``n`` rows: ``(ids as int64 with a
    negative id wrapped once, whether each is then in range)``."""
    i = ids.long()
    i = torch.where(i < 0, i + n, i)
    return i, (i >= 0) & (i < n)


def nan_rows(rows: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``rows`` with NaN where ``ok`` is false (``jnp.take``'s fill), in
    place."""
    return rows.masked_fill_(~ok[..., None], float("nan"))


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: ``ids.shape + (dim,)``; a negative
    id wraps once, an id still out of range gives NaN.  Differentiable in
    ``table`` (the NaN rows pass no gradient), the same bits every run."""
    n = table.shape[0]
    i, ok = wrap_ids(ids, n)
    return nan_rows(gather_rows(table, i.clamp(0, n - 1)), ok)


def global_ids(ids: torch.Tensor, cfg: MegaTableConfig) -> torch.Tensor:
    """Per-feature local ids ``(b, f)`` -> global mega-table rows (int32)."""
    return ids + cfg.offsets(ids.device)[None, :]


def lookup(table: torch.Tensor, ids: torch.Tensor, cfg: MegaTableConfig) -> torch.Tensor:
    """``(b, f)`` local ids -> ``(b, f, dim)``."""
    return take_rows(table, global_ids(ids, cfg))


def lookup_sharded(table: torch.Tensor, ids: torch.Tensor, cfg: MegaTableConfig,
                   fabric) -> torch.Tensor:
    """Row-sharded lookup: a local masked gather per shard, one psum.

    Shard ``s`` owns rows ``[s * r, (s + 1) * r)``, ``r = total_rows /
    fabric.n_shards``.  ``table`` holds the fabric's local shards' rows
    in order: the whole table for a ``LocalFabric`` (its shards are views
    of it), one rank's ``r`` rows for a ``ProcessGroupFabric``.
    """
    n_shards = fabric.n_shards
    if cfg.total_rows % n_shards:
        raise ValueError(f"{cfg.total_rows} rows do not split into {n_shards} shards")
    rows_per = cfg.total_rows // n_shards
    local_ids = fabric.shard_ids.long()                       # (S_l,)
    if table.shape[0] != local_ids.numel() * rows_per:
        raise ValueError(f"table has {table.shape[0]} rows; the fabric's "
                         f"{local_ids.numel()} local shards hold {rows_per} each")
    rows = global_ids(ids, cfg).long()
    local = rows[None] - (local_ids * rows_per).view(-1, *([1] * rows.dim()))
    mine = (local >= 0) & (local < rows_per)                  # (S_l, b, f)
    base = torch.arange(local_ids.numel(), device=rows.device) * rows_per
    at = torch.where(mine, local, 0) + base.view(-1, *([1] * rows.dim()))
    vals = table[at] * mine[..., None].to(table.dtype)        # (S_l, b, f, d)
    # under autograd over a process group each rank's table block takes
    # the gradient of the rows it owns (the sum's identity backward)
    return reduce_from(fabric, vals)


def pooled_lookup(table: torch.Tensor, ids: torch.Tensor, cfg: MegaTableConfig,
                  mode: str = "sum") -> torch.Tensor:
    """Multi-hot ``(b, f, l)`` ids, ``-1`` padding -> ``(b, f, dim)``
    (EmbeddingBag semantics).  An id past its feature's rows reads the
    next feature's rows, as in the reference."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0) + cfg.offsets(ids.device)[None, :, None]
    rows = take_rows(table, safe)                             # (b, f, l, d)
    w = valid.to(table.dtype)[..., None]
    pooled = torch.sum(rows * w, dim=2)
    if mode == "mean":
        denom = torch.clamp(torch.sum(w, dim=2), min=1.0)
        pooled = pooled / denom
    return pooled
