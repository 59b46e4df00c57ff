"""Dispatch between the CUDA kernels and their plain PyTorch twins.

Twin of ``repro/kernels/ops.py``, which dispatches by platform; here the
device of the tensors decides.  Every op takes ``use_kernel``:

  * ``False`` — the plain twin on any device (the walk's ``"xla"`` backend,
    used only as the oracle);
  * ``True``  — the hand-written kernel for a CUDA tensor, the plain twin
    for a CPU tensor, and an error for any other device.  There is no
    fallback: a CUDA tensor whose kernel fails to build or launch raises.

The reference's ``block_w`` and ``gather_mode`` are TPU knobs (walkers per
grid cell; blocking scalar loads vs. the double-buffered DMA pipeline).
The CUDA walk kernel has one design for every value of both, so they are
not arguments here; ``WalkConfig`` still accepts and validates them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import visit_counter as vc
from repro_torch.kernels import walk_step as ws


def _kernel_for(use_kernel: bool, t: torch.Tensor) -> bool:
    if not use_kernel:
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {t.device}")


def visit_counts_wide(
    counts: torch.Tensor,
    slot_events: torch.Tensor,
    id_events: torch.Tensor,
    query_events: Optional[torch.Tensor] = None,
    *,
    n_slots: int,
    n_dim: int,
    n_queries: int = 0,
    use_kernel: bool,
) -> torch.Tensor:
    """``counts += hist`` of wide (slot, id) lanes, in place."""
    fn = vc.visit_counter_wide if _kernel_for(use_kernel, counts) else (
        vc.visit_counter_wide_plain
    )
    return fn(counts, slot_events, id_events, query_events,
              n_slots=n_slots, n_dim=n_dim, n_queries=n_queries)


def visit_counts_update_high(
    counts: torch.Tensor,
    slot_events: torch.Tensor,
    pin_events: torch.Tensor,
    query_events: Optional[torch.Tensor] = None,
    *,
    n_slots: int,
    n_pins: int,
    n_v: int,
    n_queries: int = 0,
    use_kernel: bool,
) -> torch.Tensor:
    """``counts += hist`` in place; returns the per-row n_v crossings."""
    fn = vc.visit_counter_update_high if _kernel_for(use_kernel, counts) else (
        vc.visit_counter_update_high_plain
    )
    return fn(counts, slot_events, pin_events, query_events,
              n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=n_queries)


def walk_chunk_fused(
    curr, query, feat, slot, rbits,
    p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
    p2b_feat_bounds=None, b2p_feat_bounds=None,
    *, n_pins: int, n_slots: int, n_boards: int, alpha_u32: int,
    beta_u32: int, count_boards: bool = False, use_kernel: bool,
):
    """Per-query chunk: ``(next, slot_events, pin_events, board_events |
    None)``."""
    args = (curr, query, feat, slot, rbits, p2b_offsets, p2b_targets,
            b2p_offsets, b2p_targets, p2b_feat_bounds, b2p_feat_bounds)
    kw = dict(n_pins=n_pins, n_slots=n_slots, n_boards=n_boards,
              alpha_u32=alpha_u32, beta_u32=beta_u32,
              count_boards=count_boards)
    if _kernel_for(use_kernel, curr):
        return ws.walk_steps_fused(*args, **kw)
    return ws.walk_chunk_plain(*args, **kw)


def walk_chunk_fused_batched(
    curr, query, feat, slot, qid, rbits,
    p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
    p2b_feat_bounds=None, b2p_feat_bounds=None,
    *, n_pins: int, n_slots: int, n_queries: int, n_boards: int,
    alpha_u32: int, beta_u32: int, count_boards: bool = False,
    use_kernel: bool,
):
    """Batch-native chunk: ``(next, query_events, slot_events, pin_events,
    board_events | None)`` for the whole serving batch in one call."""
    kw = dict(n_pins=n_pins, n_slots=n_slots, n_boards=n_boards,
              alpha_u32=alpha_u32, beta_u32=beta_u32,
              count_boards=count_boards, n_queries=n_queries)
    csr = (p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
           p2b_feat_bounds, b2p_feat_bounds)
    if _kernel_for(use_kernel, curr):
        return ws.walk_steps_fused(curr, query, feat, slot, rbits, *csr,
                                   qid, **kw)
    return ws.walk_chunk_batched_plain(curr, query, feat, slot, qid, rbits,
                                       *csr, **kw)
