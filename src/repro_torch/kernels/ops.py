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

``decode_attention`` and ``decode_attention_partial`` take ``use_kernel``
from the LM decode step's ``backend`` (``"xla"``: the twin), as the walk
ops take it from the walk's.

The bag ops default to ``use_kernel=True``: the device decides, never the
walk backend, so both walk backends share one stage 2 on a device and
ranked serving keeps the walk's bit parity (the reference's rule,
``repro/kernels/ops.py:334``).  ``topk_select`` (the top-k's selection)
is the card's route alone: ``counter._topk`` takes it for every top-k on
the card, the plain walk's included, as every top-k of the reference is
``lax.top_k``, and its twin ``counter.topk_select_plain`` elsewhere.

The walk dispatchers take the walk's key(s) (``walk_chunk_fused[_batched]``,
with ``step_base`` and ``chunk_steps``) or the chunk's word table with
each lane's walker id (``walk_hop``) on both routes: one signature each.
The reference's words-in forms (a word table given to the chunk, gathered
words given to the hop) live apart, in the ``*_words*_plain`` helpers,
which run the plain twins and never launch a kernel.

The reference's ``block_w`` and ``gather_mode`` are TPU knobs (walkers per
grid cell; blocking scalar loads vs. the double-buffered DMA pipeline).
The CUDA walk kernel has one design for every value of both, so they are
not arguments here; ``WalkConfig`` still accepts and validates them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import on_card
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import topk_select as ts
from repro_torch.kernels import visit_counter as vc
from repro_torch.kernels import walk_step as ws


def _kernel_for(use_kernel: bool, t: torch.Tensor) -> bool:
    if not use_kernel:
        return False
    if on_card(t):          # a CUDA tensor, or a dry run's fake one
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


def topk_select(keys: torch.Tensor, kth: torch.Tensor, k: int) -> torch.Tensor:
    """The exact top-k's selection on the card: ``(rows, k)`` int64, each
    row's indices above its k-th key ``kth`` ``(rows, 1)`` and the
    lowest-index ties, ascending; the kernel takes ``keys`` made
    contiguous and makes no host wait."""
    return ts.topk_select(keys.contiguous(), kth, k)


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


def _chunk_rbits(keys, step_base, chunk_steps, w):
    """``core/walk._chunk_rbits``: the walk kernels' plain word table
    (imported here at call time, as ``core/walk`` imports this module)."""
    from repro_torch.core import walk

    return walk._chunk_rbits(keys, step_base, chunk_steps, w)


def _keys(keys: torch.Tensor) -> torch.Tensor:
    """The walk's key(s): one ``(2,)`` key or ``(Q, 2)`` per-query keys.
    A word table is the words-in helpers' contract, refused here."""
    if keys.dim() not in (1, 2) or keys.shape[-1] != 2:
        raise ValueError(
            "the walk draws its own words from the key(s): pass a (2,) key "
            f"or (Q, 2) keys, got shape {tuple(keys.shape)}; a word table "
            "goes to walk_chunk_words_plain / walk_chunk_words_batched_plain"
        )
    return keys


def _plain_words(keys, step_base: int, chunk_steps: int, n: int):
    """The plain route's word table for ``n`` walkers, drawn from one key
    or per-query keys over query-major walkers."""
    w = n if keys.dim() == 1 else n // keys.shape[0]
    return _chunk_rbits(keys, step_base, chunk_steps, w)


def _words(rbits: torch.Tensor) -> torch.Tensor:
    """A chunk's ``(chunk_steps, n, 4)`` word table; keys are refused."""
    if rbits.dim() != 3 or rbits.shape[-1] != 4:
        raise ValueError(
            "expected a chunk's (chunk_steps, n, 4) word table, got shape "
            f"{tuple(rbits.shape)}; keys go to walk_chunk_fused[_batched], "
            "gathered words to walk_hop_words_plain"
        )
    return rbits


def walk_bits(keys, step_base: int, chunk_steps: int, w: int, *,
              use_kernel: bool) -> torch.Tensor:
    """One chunk's ``(chunk_steps, n, 4)`` int32 word table from one
    ``(2,)`` key (n = w) or ``(Q, 2)`` per-query keys (n = Q * w,
    query-major); keys are int32 bit patterns or int64 word values."""
    if _kernel_for(use_kernel, keys):
        return ws.walk_bits(ws.u32_bits_as_int32(keys).contiguous(),
                            step_base, chunk_steps, w)
    return _chunk_rbits(keys, step_base, chunk_steps, w)


def walk_chunk_fused(
    curr, query, feat, slot, keys,
    p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
    p2b_feat_bounds=None, b2p_feat_bounds=None,
    *, step_base: int, chunk_steps: int,
    n_pins: int, n_slots: int, n_boards: int, alpha_u32: int,
    beta_u32: int, count_boards: bool = False, use_kernel: bool,
):
    """Per-query chunk from the walk's ``(2,)`` key: ``(next, slot_events,
    pin_events, board_events | None)``.  The kernel draws the chunk's words
    itself; the plain route draws their table with
    ``core/walk._chunk_rbits``."""
    kw = dict(n_pins=n_pins, n_slots=n_slots, n_boards=n_boards,
              alpha_u32=alpha_u32, beta_u32=beta_u32,
              count_boards=count_boards)
    csr = (p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
           p2b_feat_bounds, b2p_feat_bounds)
    keys = _keys(keys)
    if _kernel_for(use_kernel, curr):
        return ws.walk_steps_fused(
            curr, query, feat, slot, ws.u32_bits_as_int32(keys).contiguous(),
            *csr, step_base=step_base, chunk_steps=chunk_steps, **kw)
    rbits = _plain_words(keys, step_base, chunk_steps, curr.shape[0])
    return ws.walk_chunk_plain(curr, query, feat, slot, rbits, *csr, **kw)


def walk_chunk_fused_batched(
    curr, query, feat, slot, qid, keys,
    p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
    p2b_feat_bounds=None, b2p_feat_bounds=None,
    *, step_base: int, chunk_steps: int,
    n_pins: int, n_slots: int, n_queries: int, n_boards: int,
    alpha_u32: int, beta_u32: int, count_boards: bool = False,
    use_kernel: bool,
):
    """Batch-native chunk from the ``(n_queries, 2)`` per-query keys:
    ``(next, query_events, slot_events, pin_events, board_events | None)``
    for the whole serving batch in one call (the words drawn as in
    ``walk_chunk_fused``, walkers query-major)."""
    kw = dict(n_pins=n_pins, n_slots=n_slots, n_boards=n_boards,
              alpha_u32=alpha_u32, beta_u32=beta_u32,
              count_boards=count_boards, n_queries=n_queries)
    csr = (p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
           p2b_feat_bounds, b2p_feat_bounds)
    keys = _keys(keys)
    if _kernel_for(use_kernel, curr):
        return ws.walk_steps_fused(
            curr, query, feat, slot, ws.u32_bits_as_int32(keys).contiguous(),
            *csr, qid, step_base=step_base, chunk_steps=chunk_steps, **kw)
    rbits = _plain_words(keys, step_base, chunk_steps, curr.shape[0])
    return ws.walk_chunk_batched_plain(curr, query, feat, slot, qid, rbits,
                                       *csr, **kw)


def walk_hop(
    pos: torch.Tensor,
    gate: torch.Tensor,
    table: torch.Tensor,
    offsets: torch.Tensor,
    targets: torch.Tensor,
    row_base: torch.Tensor,
    *,
    step: int,
    column: int,
    walker: torch.Tensor,
    use_kernel: bool,
):
    """ONE walk hop on shard-local CSR slices -> ``(tgt, ok)``: the
    sharded superstep's half step, one launch for every co-located shard.
    ``table`` is the chunk's ``(chunk_steps, n, 4)`` word table
    (``walk_bits``) and a gated lane's word is ``table[step, walker,
    column]``: the kernel reads it itself, the plain route gathers it
    (gated-off lanes may hold any walker id)."""
    if not _kernel_for(use_kernel, pos):
        g = torch.where(gate, walker, 0).long()
        r = _words(table)[step, :, column][g]
        return ws.walk_hop_ref(pos, gate, r, offsets, targets, row_base)
    return ws.walk_hop_fused(pos, gate, _words(table), step, column,
                             walker.contiguous(), row_base, offsets, targets)


# ---------------------------------------------------------------------------
# The reference's words-in forms: plain route only, never a kernel
# ---------------------------------------------------------------------------


def walk_chunk_words_plain(
    curr, query, feat, slot, rbits,
    p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
    p2b_feat_bounds=None, b2p_feat_bounds=None, **kw,
):
    """The reference's ``walk_chunk_fused`` contract: the chunk's
    ``(chunk_steps, w, 4)`` word table given, walked by the plain twin."""
    return ws.walk_chunk_plain(
        curr, query, feat, slot, _words(rbits), p2b_offsets, p2b_targets,
        b2p_offsets, b2p_targets, p2b_feat_bounds, b2p_feat_bounds, **kw)


def walk_chunk_words_batched_plain(
    curr, query, feat, slot, qid, rbits,
    p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
    p2b_feat_bounds=None, b2p_feat_bounds=None, **kw,
):
    """The reference's ``walk_chunk_fused_batched`` contract: the chunk's
    ``(chunk_steps, n, 4)`` word table given, walked by the plain twin."""
    return ws.walk_chunk_batched_plain(
        curr, query, feat, slot, qid, _words(rbits), p2b_offsets, p2b_targets,
        b2p_offsets, b2p_targets, p2b_feat_bounds, b2p_feat_bounds, **kw)


def walk_hop_words_plain(pos, gate, r, offsets, targets, row_base):
    """The reference's ``walk_hop`` contract: each lane's word already
    gathered (uint32 values as int32 bit patterns or int64), hopped by the
    plain twin."""
    return ws.walk_hop_ref(pos, gate, r, offsets, targets, row_base)


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


def embedding_bag_pair(
    table: torch.Tensor,
    ids_a: torch.Tensor,
    weights_a: Optional[torch.Tensor],
    ids_b: torch.Tensor,
    weights_b: Optional[torch.Tensor],
    *,
    mode: str = "sum",
    use_kernel: bool = True,
):
    """Two query-batched bag sets over one table and mode -> their two
    outputs: ONE kernel launch on the card, two twin calls on the plain
    route (the ranked request's neighbor and query bags)."""
    fn = eb.embedding_bag_pair if _kernel_for(use_kernel, table) else (
        eb.embedding_bag_pair_plain
    )
    return fn(table, ids_a, weights_a, ids_b, weights_b, mode=mode)


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


def decode_attention_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lo: int,
    lengths,
    *,
    use_kernel: bool,
):
    """Single-token GQA attention over one sequence block ``k, v (b, s, kh,
    dh)`` that holds positions ``[lo, lo + s)`` of a cache of valid length
    ``lengths`` (a ``(b,)`` int32 tensor or one int, >= 0) -> the block's
    ``(o (b, h, dh), m (b, h), l (b, h))`` float32, merged across blocks by
    ``decode_attention.merge_partials`` (a tensor-parallel decode step's
    ``kv_seq`` shard)."""
    fn = da.decode_attention_partial if _kernel_for(use_kernel, k) else (
        da.decode_attention_partial_plain
    )
    return fn(q, k, v, lo, lengths)
