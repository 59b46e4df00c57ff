"""Visit counters, the sharded-count fold, the Eq. 3 booster and exact
top-k (twin of ``repro/core/counter.py``): dense counting, and the event
counters of event mode (sort-based, wide lanes, no id-space limit).

Events are WIDE int32 lanes: (slot, id), led by a query lane in the
batch-native engine; an event is invalid iff its slot lane holds
``n_slots`` (or its query lane ``n_queries``).  Counting accumulates into
a flat ``(n_rows * n_dim,)`` int32 buffer IN PLACE: at production scale
the buffer is 4.5 GB and a copy per chunk would cost more than the chunk.

Float parity with the reference:

  * ``boost_combine`` takes ``sqrt`` in float64 rounded to float32 (torch's
    float32 CPU ``sqrt`` is not correctly rounded; ``jnp.sqrt`` is) and sums
    the slots as an explicit left-to-right chain (XLA's CPU order);
  * ``topk_dense`` reproduces ``lax.top_k``'s tie rule — among equal
    scores the lower index comes first — without sorting the whole row,
    for rows free of NaN (the walk's); ``topk_total`` adds ``lax.top_k``'s
    IEEE total order (NaN first, ``+0.0`` above ``-0.0``) for scores that
    may hold NaN (a model's, a ranker's);
  * ``boosted_from_events`` sums a pin's roots as a left-to-right chain in
    slot order (XLA's CPU ``segment_sum`` order), which is also the dense
    booster's order, so event mode and dense mode give the same scores.

Two host reads size work by the data; a dry run (fake tensors,
``repro_torch/abstract.py``) cannot make them and takes a stated static
form: the events' live entries are all ``max_unique`` of them, each may
start a run, and a pin's chain is ``n_slots`` adds long.  The top-k's
selection reads nothing on the host on the card's route
(``ops.topk_select``), which a dry run takes; off the card its twin,
``topk_select_plain``, sizes a ``nonzero`` by the data.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import abstract
from repro_torch.device import on_card
from repro_torch.kernels import ops
from repro_torch.serving import batch_trace


def dense_accumulate(
    counts: torch.Tensor, pins: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Scatter-add a batch of visit events into per-slot dense counts.

    ``counts`` is ``(n_slots, n_pins)``, ``pins`` and ``valid`` are
    ``(n_slots, m)``; returns new counts.  An id is read as the
    reference's ``.at[].add(mode="drop")`` reads it: a negative id wraps
    once (``-1`` is the last bin), and an id still outside ``[0, n_pins)``
    is dropped.
    """
    n_slots, n_pins = counts.shape
    rows = torch.arange(n_slots, device=counts.device)[:, None] * n_pins
    return _drop_mode_add(counts, pins, valid, n_pins, rows)


def dense_accumulate_flat(
    counts: torch.Tensor, pins: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Single-slot ``dense_accumulate``: counts ``(n_pins,)``, pins and
    valid ``(m,)``."""
    return _drop_mode_add(counts, pins, valid, counts.shape[0], 0)


def _drop_mode_add(counts, pins, valid, n_pins: int, row_base):
    ids = torch.where(valid, pins, 0).long()
    ids = torch.where(ids < 0, ids + n_pins, ids)
    keep = valid & (ids >= 0) & (ids < n_pins)
    flat = (torch.where(keep, ids, 0) + row_base).reshape(-1)
    out = counts.clone()
    out.view(-1).index_add_(0, flat, keep.reshape(-1).to(counts.dtype))
    return out


def accumulate_packed_events(
    counts: torch.Tensor,
    slot_events: torch.Tensor,
    id_events: torch.Tensor,
    n_slots: int,
    n_dim: int,
    backend: str,
    query_events: Optional[torch.Tensor] = None,
    n_queries: int = 0,
) -> torch.Tensor:
    """Accumulate wide (slot, id) lanes into flat dense ``counts`` in place.

    ``backend="pallas"`` runs the ``visit_counter_wide`` kernel on a CUDA
    tensor (its plain twin on a CPU tensor); ``"xla"`` runs the twin.
    With ``query_events`` the bins are query-major over
    ``n_queries * n_slots * n_dim``.  Returns ``counts``.
    """
    ops.visit_counts_wide(
        counts, slot_events.reshape(-1), id_events.reshape(-1),
        None if query_events is None else query_events.reshape(-1),
        n_slots=n_slots, n_dim=n_dim, n_queries=n_queries,
        use_kernel=backend == "pallas",
    )
    return counts


def accumulate_packed_events_with_high(
    counts: torch.Tensor,
    high: torch.Tensor,
    slot_events: torch.Tensor,
    pin_events: torch.Tensor,
    n_slots: int,
    n_pins: int,
    n_v: int,
    backend: str,
    query_events: Optional[torch.Tensor] = None,
    n_queries: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate wide events AND maintain the early-stop tally (Alg. 3).

    ``counts`` (flat int32) is updated IN PLACE, and so is ``high``, the
    ``(n_rows,)`` int32 tally, which gains per row the number of bins whose
    count crossed from below ``n_v`` to ``>= n_v`` (the reference returns
    a new tally; here one chunk's counting is one kernel launch).  Returns
    ``(counts, high)``.  Dense bins must fit int32 and ``n_v >= 1``; the
    kernels and their twins refuse anything else.
    """
    ops.visit_counts_update_high(
        counts, slot_events.reshape(-1), pin_events.reshape(-1),
        None if query_events is None else query_events.reshape(-1),
        n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=n_queries,
        high=high, use_kernel=backend == "pallas",
    )
    return counts, high


def fold_sharded_counts(
    shard_counts: torch.Tensor,
    n_queries: int,
    n_slots: int,
    per_shard_dim: int,
) -> torch.Tensor:
    """Fold per-shard dense counts into the unsharded batched layout.

    ``shard_counts`` is ``(n_shards, n_queries * n_slots *
    per_shard_dim)``: each shard's query-major counts over its OWNED id
    subrange ``[s * per_shard_dim, (s + 1) * per_shard_dim)``.  Ownership
    partitions the id space, so folding is a pure layout move: returns
    ``(n_queries, n_slots, n_shards * per_shard_dim)`` with the global id
    axis reassembled in shard order (padded ids past the real ``n_pins``
    stay zero).
    """
    n_shards = shard_counts.shape[0]
    blocks = shard_counts.reshape(n_shards, n_queries, n_slots, per_shard_dim)
    return blocks.permute(1, 2, 0, 3).reshape(
        n_queries, n_slots, n_shards * per_shard_dim
    )


def boost_combine(
    counts_q: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Multi-hit booster, Eq. 3: V[p] = (sum_q w_q * sqrt(V_q[p]))**2.

    ``counts_q`` is ``(..., n_slots, n_pins)``; returns ``(..., n_pins)``
    float32.  One slot at a time, so the float64 ``sqrt`` never holds more
    than one slot's row.
    """
    n_slots = counts_q.shape[-2]
    acc = None
    for s in range(n_slots):
        root = torch.sqrt(counts_q[..., s, :].double()).float()
        if weights is not None:
            root = root * weights[..., s, None].float()
        acc = root if acc is None else acc + root
    if acc is None:
        acc = torch.zeros(
            counts_q.shape[:-2] + counts_q.shape[-1:], device=counts_q.device
        )
    return acc * acc


def n_high_visited(counts_q: torch.Tensor, n_v: int) -> torch.Tensor:
    """Per-slot count of pins whose visit count reached n_v."""
    return (counts_q >= n_v).sum(-1, dtype=torch.int32)


_KEY_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF),
             torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF),
             torch.bfloat16: (torch.int16, 0x7FFF),
             torch.float16: (torch.int16, 0x7FFF)}


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """Integer keys that order ``x`` as ``lax.top_k`` does: IEEE total
    order, ``-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN``, equal
    keys only for equal bit patterns.  Integer tensors are their own keys."""
    if not x.is_floating_point():
        return x
    itype, mag = _KEY_BITS[x.dtype]
    bits = x.contiguous().view(itype)
    return torch.where(bits < 0, bits ^ mag, bits)


def topk_select_plain(keys: torch.Tensor, kth: torch.Tensor, k: int) -> torch.Tensor:
    """The top-k's selection off the card, and the kernel's oracle:
    ``(rows, k)`` int64, each row's indices above its k-th key ``kth``
    ``(rows, 1)`` and the lowest-index ties, ascending.  Its ``nonzero``
    waits on the host (counted)."""
    above = keys > kth
    ties = keys == kth
    need = k - above.sum(-1, keepdim=True)
    take = above | (ties & (torch.cumsum(ties, dim=-1) <= need))
    batch_trace.host_sync("topk.nonzero")              # sized by the data
    return take.nonzero()[:, 1].reshape(-1, k)         # ascending per row


def _topk(rows: torch.Tensor, keys: torch.Tensor,
          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``rows`` by ``keys``, ties to the lower index:
    the k-th key comes from ``torch.topk``; then every entry strictly above
    it and the lowest-index entries equal to it (on the card
    ``ops.topk_select``, a kernel with no host wait; elsewhere
    ``topk_select_plain``), so no full sort of the row."""
    kth = torch.topk(keys, k, dim=-1, sorted=True).values[:, -1:]
    select = ops.topk_select if on_card(keys) else topk_select_plain
    idx = select(keys, kth, k)                         # ascending per row
    top, perm = torch.sort(torch.gather(keys, 1, idx), dim=-1, descending=True,
                           stable=True)
    idx = torch.gather(idx, 1, perm)
    return (top if keys is rows else torch.gather(rows, 1, idx)), idx


def _topk_rows(x: torch.Tensor, k: int, total: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top_k={k} must lie in [0, {n}]")
    out_shape = x.shape[:-1] + (k,)
    if k == 0:
        return (x.new_zeros(out_shape),
                torch.zeros(out_shape, dtype=torch.int32, device=x.device))
    rows = x.reshape(-1, n)
    vals, idx = _topk(rows, order_keys(rows) if total else rows, k)
    return vals.reshape(out_shape), idx.to(torch.int32).reshape(out_shape)


def topk_dense(boosted: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k ``(scores, int32 ids)`` over the last axis, ``lax.top_k`` ties.

    Scores descend; among equal scores the lower index comes first.  For
    rows free of NaN (the walk's boosted counts): a NaN compares false, so
    a row holding one fails; ``topk_total`` orders it.
    """
    return _topk_rows(boosted, k, total=False)


def topk_total(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_dense`` in ``lax.top_k``'s full order, for scores that may
    hold NaN: descending in ``order_keys``' IEEE total order (NaN first,
    ``+0.0`` above ``-0.0``), equal keys to the lower index.  It keys the
    row by its bits first, one more pass than ``topk_dense``."""
    return _topk_rows(scores, k, total=True)


# ---------------------------------------------------------------------------
# Event-buffer (sort-based) counters: scale-free, wide lanes
# ---------------------------------------------------------------------------

_INT32_MIN = -(2**31)


def _valid_lanes(slot_ev, id_ev, n_slots: int, n_dim: int) -> torch.Tensor:
    return (slot_ev >= 0) & (slot_ev < n_slots) & (id_ev >= 0) & (id_ev < n_dim)


def _pair_keys(slot_ids: torch.Tensor, pin_ids: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as the (slot, pin) pairs are, lexicographically,
    over every int32 value of either lane."""
    return slot_ids.long() * 2**32 + (pin_ids.long() + 2**31)


def _runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Run index of each element of a sorted sequence (0-based)."""
    boundary = torch.ones_like(sorted_keys, dtype=torch.int64)
    boundary[1:] = (sorted_keys[1:] != sorted_keys[:-1]).long()
    return torch.cumsum(boundary, 0) - 1


def _segment_sum(values, segment_ids, num_segments: int) -> torch.Tensor:
    """``segment_sum``: ids past ``num_segments`` land in one spare bin
    that is dropped (no host sync for a mask)."""
    out = values.new_zeros((num_segments + 1,))
    out.scatter_add_(0, segment_ids.long().clamp(max=num_segments), values)
    return out[:num_segments]


def _segment_values(values, run_idx, num_segments: int, fill: int):
    """Per segment, the value its elements share (``fill`` where empty).
    Runs past ``num_segments`` are dropped, as ``segment_max`` drops them."""
    out = torch.full((num_segments + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[run_idx.clamp(max=num_segments)] = values
    return out[:num_segments]


def events_to_counts(
    slot_ids: torch.Tensor,
    pin_ids: torch.Tensor,
    n_slots: int,
    max_unique: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Aggregate wide visit events by (slot, pin) with a lexicographic sort.

    ``slot_ids`` / ``pin_ids``: ``(m,)`` int32 lanes; invalid events carry
    slot ``n_slots``.  Returns ``(uniq_slot, uniq_pin, counts)``, each
    ``(max_unique,)`` int32, sorted by (slot, pin) with unused bins set to
    the (``n_slots``, 0) sentinel, so the arrays stay sorted end to end.
    No lane holds the packed ``slot * n_pins + pin`` product.  The sort
    is one ``torch.sort`` of int64 pair keys: the keys are the whole
    payload, so its order is the reference's two-key ``lax.sort``.
    """
    keys, _ = torch.sort(_pair_keys(slot_ids, pin_ids))
    run_idx = _runs(keys)
    counts = _segment_sum(torch.ones_like(run_idx, dtype=torch.int32), run_idx,
                          max_unique)
    s_sorted = (keys >> 32).to(torch.int32)
    p_sorted = ((keys & 0xFFFFFFFF) - 2**31).to(torch.int32)
    used = counts > 0
    uniq_slot = torch.where(
        used, _segment_values(s_sorted, run_idx, max_unique, 0), n_slots
    ).to(torch.int32)
    uniq_pin = torch.where(
        used, _segment_values(p_sorted, run_idx, max_unique, 0), 0
    ).to(torch.int32)
    return uniq_slot, uniq_pin, counts


def _chain_sum(values: torch.Tensor, run_idx: torch.Tensor,
               num_segments: int, max_run: int) -> torch.Tensor:
    """Per-segment float32 sums of a segment-sorted sequence, each a
    left-to-right chain ``((v0 + v1) + v2) + ...``: the order of XLA's CPU
    ``segment_sum``.  One vector add per position within a run, so the
    passes are the longest run's length, read from the device.  A dry run
    (fake tensors) bounds both reads: every entry may start a run, and a
    run is at most ``max_run`` long (the caller's static bound)."""
    n = values.shape[0]
    out = values.new_zeros((num_segments + 1,))
    if n == 0:
        return out[:num_segments]
    starts = torch.ones((n,), dtype=torch.bool, device=values.device)
    starts[1:] = run_idx[1:] != run_idx[:-1]
    dry = abstract.is_fake(starts)
    first = (torch.arange(n, device=values.device) if dry
             else torch.nonzero(starts).reshape(-1))
    length = torch.diff(first, append=first.new_tensor([n]))
    acc = values[first]
    depth = max_run if dry else int(length.max())
    for d in range(1, depth):
        acc = acc + torch.where(length > d, values[(first + d).clamp(max=n - 1)],
                                0.0)
    out[run_idx[first].clamp(max=num_segments)] = acc
    return out[:num_segments]


def boosted_from_events(
    uniq_slot: torch.Tensor,
    uniq_pin: torch.Tensor,
    counts: torch.Tensor,
    n_slots: int,
    n_pins: int,
    max_unique: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 3 across query slots from (slot, pin, count) runs.

    Every run maps to (pin, sqrt(count)); a stable sort by pin (slot order
    kept within a pin) and a left-to-right chain per pin sum the roots,
    which are then squared.  Returns ``(pin_ids, boosted_scores)``, each
    ``(max_unique,)``: one entry per pin run in pin order, then the
    invalid run (pin ``n_pins``, score 0), then unused entries whose pin
    is int32 min (``segment_max`` of an empty segment) and score 0.
    """
    valid = _valid_lanes(uniq_slot, uniq_pin, n_slots, n_pins) & (counts > 0)
    pin = torch.where(valid, uniq_pin, n_pins).to(torch.int32)
    root = torch.where(valid, torch.sqrt(counts.double()).float(), 0.0)
    order = torch.argsort(pin, stable=True)
    pin_s = pin[order]
    root_s = root[order]
    run_idx = _runs(pin_s)
    # valid entries (pin < n_pins) sort first; the rest form the one
    # invalid run, whose roots are all 0 and whose sum stays 0.  A dry run
    # (fake tensors) bounds the live entries by all of them, and a pin's
    # run by n_slots: the (slot, pin) runs hold each pin once a slot
    n_live = max_unique if abstract.is_fake(valid) else int(valid.sum())
    summed = _chain_sum(root_s[:n_live], run_idx[:n_live], max_unique, n_slots)
    rep_pin = _segment_values(pin_s, run_idx, max_unique, _INT32_MIN)
    boosted = summed * summed
    boosted = torch.where((rep_pin >= 0) & (rep_pin < n_pins), boosted, 0.0)
    return rep_pin, boosted


def topk_events(
    pin_ids: torch.Tensor, scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k ``(scores, pin ids)`` over event runs, ``lax.top_k`` ties."""
    vals, idx = topk_dense(scores, k)
    return vals, pin_ids[idx.long()]


def events_n_high_per_slot(
    slot_ids: torch.Tensor,
    pin_ids: torch.Tensor,
    n_slots: int,
    n_pins: int,
    n_v: int,
    max_unique: int,
) -> torch.Tensor:
    """Per-slot Algorithm 3 statistic by FULL re-aggregation of the buffer:
    ``(n_slots,)`` int32 counts of pins whose visits reached ``n_v``.  The
    obviously-correct oracle ``events_high_fold`` is held against."""
    uniq_slot, uniq_pin, counts = events_to_counts(
        slot_ids, pin_ids, n_slots, max_unique
    )
    hot = (counts >= n_v) & _valid_lanes(uniq_slot, uniq_pin, n_slots, n_pins)
    return _segment_sum(hot.to(torch.int32), torch.where(hot, uniq_slot, n_slots),
                        n_slots)


class EventHighState(NamedTuple):
    """Carried state of the incremental event-mode ``n_high`` tally.

    ``seg_slot`` / ``seg_pin`` / ``seg_count`` hold one SORTED run segment
    per completed check window, back to back (segment k occupies ``[k *
    seg_cap, (k + 1) * seg_cap)``); unwritten segments hold the
    (``n_slots``, 0, 0) sentinel.  A key's prior count is the sum of its
    matches over the stored segments.  ``n_checks`` is a host int (the
    reference carries a device scalar), so the fold loop needs no sync;
    ``events_high_fold`` writes the segment buffers in place.
    """

    seg_slot: torch.Tensor    # (n_segments * seg_cap,) int32
    seg_pin: torch.Tensor     # (n_segments * seg_cap,) int32
    seg_count: torch.Tensor   # (n_segments * seg_cap,) int32
    high: torch.Tensor        # (n_slots,) int32 running Algorithm 3 tally
    n_checks: int             # windows folded so far


def events_high_init(
    n_slots: int, n_segments: int, seg_cap: int, device=None
) -> EventHighState:
    """Fresh state sized for ``n_segments`` check windows of ``seg_cap``."""
    m = max(1, n_segments) * seg_cap
    i32 = dict(dtype=torch.int32, device=device)
    return EventHighState(
        seg_slot=torch.full((m,), n_slots, **i32),
        seg_pin=torch.zeros((m,), **i32),
        seg_count=torch.zeros((m,), **i32),
        high=torch.zeros((n_slots,), **i32),
        n_checks=0,
    )


def _searchsorted_pair(
    keys_slot: torch.Tensor, keys_pin: torch.Tensor,
    q_slot: torch.Tensor, q_pin: torch.Tensor,
) -> torch.Tensor:
    """Left insertion points of (q_slot, q_pin) into lexicographically
    sorted (keys_slot, keys_pin): a binary search over int64 pair keys, no
    sort.  Returns int64."""
    return torch.searchsorted(
        _pair_keys(keys_slot, keys_pin), _pair_keys(q_slot, q_pin)
    )


def events_high_fold(
    state: EventHighState,
    slot_events: torch.Tensor,
    pin_events: torch.Tensor,
    n_slots: int,
    n_pins: int,
    n_v: int,
    *,
    seg_cap: int,
) -> EventHighState:
    """Fold ONE check window's events into the running ``n_high`` tally.

    The only sort is over the window's own ``seg_cap`` events; prior counts
    of its keys come from binary searches into the segments written so
    far.  Bit-identical to ``events_n_high_per_slot`` over every event
    folded so far.  The state must be sized for every fold that will run:
    a fold past capacity keeps the stored segments intact and drops its
    own runs (later folds would then see stale priors), never a prior
    window's.
    """
    sev = slot_events.reshape(-1).to(torch.int32)
    pev = pin_events.reshape(-1).to(torch.int32)
    if sev.shape[0] != seg_cap:
        raise ValueError(
            f"window has {sev.shape[0]} events but seg_cap={seg_cap}"
        )
    uniq_slot, uniq_pin, counts = events_to_counts(sev, pev, n_slots, seg_cap)
    n_segments = state.seg_slot.shape[0] // seg_cap
    prior = torch.zeros_like(counts)
    for k in range(min(state.n_checks, n_segments)):
        seg = slice(k * seg_cap, (k + 1) * seg_cap)
        ss, sp, sc = state.seg_slot[seg], state.seg_pin[seg], state.seg_count[seg]
        pos = _searchsorted_pair(ss, sp, uniq_slot, uniq_pin)
        pos_c = pos.clamp(max=seg_cap - 1)
        match = (pos < seg_cap) & (ss[pos_c] == uniq_slot) & (sp[pos_c] == uniq_pin)
        prior += torch.where(match, sc[pos_c], 0)

    valid_run = _valid_lanes(uniq_slot, uniq_pin, n_slots, n_pins) & (counts > 0)
    crossed = valid_run & (prior < n_v) & (prior + counts >= n_v)
    delta = _segment_sum(crossed.to(torch.int32),
                         torch.where(crossed, uniq_slot, n_slots), n_slots)
    if state.n_checks < n_segments:
        seg = slice(state.n_checks * seg_cap, (state.n_checks + 1) * seg_cap)
        state.seg_slot[seg] = uniq_slot
        state.seg_pin[seg] = uniq_pin
        state.seg_count[seg] = counts
    return state._replace(high=state.high + delta, n_checks=state.n_checks + 1)
