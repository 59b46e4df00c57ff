"""Dispatch between the CUDA kernels and their plain PyTorch twins.

Twin of ``repro/kernels/ops.py``, which dispatches by platform; here the
device of the tensors decides.  Every op takes ``use_kernel``:

  * ``False`` — the plain twin on any device (the walk's ``"xla"`` backend,
    used only as the oracle);
  * ``True``  — the hand-written kernel for a CUDA tensor, the plain twin
    for a CPU tensor, and an error for any other device.  There is no
    fallback: a CUDA tensor whose kernel fails to build or launch raises.

``visit_counts`` and ``walk_step``, the reference's public entry points to
its two legacy kernels, take ``use_kernel=None`` as the reference does:
``None`` lets the tensor's device decide, as ``True`` does.

``decode_attention`` takes ``use_kernel`` from the LM decode step's
``backend`` (``"xla"``: the twin), as the walk ops take it from the walk's.

The bag ops default to ``use_kernel=True``: the device decides, never the
walk backend, so both walk backends share one stage 2 on a device and
ranked serving keeps the walk's bit parity (the reference's rule,
``repro/kernels/ops.py:334``).

The reference's ``block_w`` and ``gather_mode`` are TPU knobs (walkers per
grid cell; blocking scalar loads vs. the double-buffered DMA pipeline).
The CUDA walk kernel has one design for every value of both, so they are
not arguments here; ``WalkConfig`` still accepts and validates them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import embedding_bag as eb
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


def visit_counts(
    events: torch.Tensor, n_bins: int, *, use_kernel: Optional[bool] = None
) -> torch.Tensor:
    """Histogram of flat int32 visit events over ``[0, n_bins)``: a fresh
    ``(n_bins,)`` int32 buffer; ids outside the range are dropped."""
    if _kernel_for(use_kernel is not False, events):
        return vc.visit_counter(events, n_bins)
    return vc.visit_counter_plain(events, n_bins)


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
    high: Optional[torch.Tensor] = None,
    use_kernel: bool,
) -> torch.Tensor:
    """``counts += hist`` in place; the per-row n_v crossings are added
    into ``high`` in place (returned), or returned as a fresh delta (the
    reference's shape)."""
    fn = vc.visit_counter_update_high if _kernel_for(use_kernel, counts) else (
        vc.visit_counter_update_high_plain
    )
    return fn(counts, slot_events, pin_events, query_events,
              n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=n_queries,
              high=high)


def walk_step(
    curr: torch.Tensor,
    query: torch.Tensor,
    rbits: torch.Tensor,
    p2b_offsets: torch.Tensor,
    p2b_targets: torch.Tensor,
    b2p_offsets: torch.Tensor,
    b2p_targets: torch.Tensor,
    *,
    n_pins: int,
    alpha_u32: int,
    use_kernel: Optional[bool] = None,
):
    """One unbiased walk superstep -> ``(next, visited, ok)``.  ``rbits``
    ``(w, 3)`` holds uint32 words as int32 bit patterns, int64 values or
    torch.uint32; the kernel gets the bit patterns."""
    args = (p2b_offsets, p2b_targets, b2p_offsets, b2p_targets)
    kw = dict(n_pins=n_pins, alpha_u32=alpha_u32)
    if _kernel_for(use_kernel is not False, curr):
        return ws.walk_step(curr, query,
                            ws.u32_bits_as_int32(rbits).contiguous(),
                            *args, **kw)
    return ws.walk_step_plain(curr, query, rbits, *args, **kw)


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


def walk_hop(
    pos: torch.Tensor,
    gate: torch.Tensor,
    r: torch.Tensor,
    offsets: torch.Tensor,
    targets: torch.Tensor,
    row_base: torch.Tensor,
    *,
    use_kernel: bool,
):
    """ONE walk hop on shard-local CSR slices -> ``(tgt, ok)``: the
    sharded superstep's half step, one launch for every co-located shard.
    ``r`` holds uint32 words as int32 bit patterns or as int64 (the
    port's threefry representation); the kernel gets the low 32 bits."""
    if not _kernel_for(use_kernel, pos):
        return ws.walk_hop_ref(pos, gate, r, offsets, targets, row_base)
    if r.dtype == torch.int64:
        r = (r & 0xFFFFFFFF).to(torch.int32)   # wraps to the bit pattern
    return ws.walk_hop_fused(pos, gate, r.contiguous(), row_base, offsets,
                             targets)


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    mode: str = "sum",
    use_kernel: bool = True,
) -> torch.Tensor:
    """Pooled (sum/mean) embedding lookup: ``(n, l)`` bags -> ``(n, d)``."""
    fn = eb.embedding_bag if _kernel_for(use_kernel, table) else (
        eb.embedding_bag_plain
    )
    return fn(table, ids, weights, mode=mode)


def embedding_bag_batched(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    mode: str = "sum",
    use_kernel: bool = True,
) -> torch.Tensor:
    """Query-batched pooled lookup: ``(b, k, l)`` bags -> ``(b, k, d)``;
    the two-stage serving path's bag op."""
    fn = eb.embedding_bag_batched if _kernel_for(use_kernel, table) else (
        eb.embedding_bag_batched_plain
    )
    return fn(table, ids, weights, mode=mode)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths,
    *,
    use_kernel: bool,
) -> torch.Tensor:
    """Single-token GQA attention over a KV cache: ``q (b, h, dh)``, ``k, v
    (b, s, kh, dh)``, ``lengths`` a ``(b,)`` int32 tensor or one int ->
    ``(b, h, dh)`` float32 (the LM decode step's attention)."""
    fn = da.decode_attention if _kernel_for(use_kernel, k) else (
        da.decode_attention_plain
    )
    return fn(q, k, v, lengths)
