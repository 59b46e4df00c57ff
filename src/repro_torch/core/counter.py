"""Dense visit counters, the sharded-count fold, the Eq. 3 booster and
exact top-k (twin of the dense part of ``repro/core/counter.py``).

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
    scores the lower index comes first — without sorting the whole row.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


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

    ``counts`` (flat int32) is updated IN PLACE; ``high`` gains, per row,
    the number of bins whose count crossed from below ``n_v`` to
    ``>= n_v``.  Returns ``(counts, new_high)``.  Dense bins must fit int32
    and ``n_v >= 1``; the kernels and their twins refuse anything else.
    """
    delta = ops.visit_counts_update_high(
        counts, slot_events.reshape(-1), pin_events.reshape(-1),
        None if query_events is None else query_events.reshape(-1),
        n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=n_queries,
        use_kernel=backend == "pallas",
    )
    return counts, high + delta


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


def topk_dense(boosted: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k ``(scores, int32 ids)`` over the last axis, ``lax.top_k`` ties.

    Scores descend; among equal scores the lower index comes first.  The
    k-th value comes from ``torch.topk``; then every entry strictly above it
    and the lowest-index entries equal to it, so no full sort of the row.
    """
    n = boosted.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top_k={k} must lie in [0, {n}]")
    if k == 0:
        shape = boosted.shape[:-1] + (0,)
        return (boosted.new_zeros(shape),
                torch.zeros(shape, dtype=torch.int32, device=boosted.device))
    rows = boosted.reshape(-1, n)
    kth = torch.topk(rows, k, dim=-1, sorted=True).values[:, -1:]
    above = rows > kth
    ties = rows == kth
    need = k - above.sum(-1, keepdim=True)
    take = above | (ties & (torch.cumsum(ties, dim=-1) <= need))
    idx = take.nonzero()[:, 1].reshape(-1, k)          # ascending per row
    vals = torch.gather(rows, 1, idx)
    vals, perm = torch.sort(vals, dim=-1, descending=True, stable=True)
    idx = torch.gather(idx, 1, perm)
    out_shape = boosted.shape[:-1] + (k,)
    return vals.reshape(out_shape), idx.to(torch.int32).reshape(out_shape)
