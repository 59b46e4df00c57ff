"""The Pixie Random Walk engines (paper §3.1, Algorithms 1-3), in torch.

Twin of ``repro/core/walk.py``: W walkers run in lockstep; one step is
maybe-restart -> board from E(pin) -> pin from E(board) -> record visit.
Each superstep chunk draws the counter-based threefry bits
(``_chunk_rbits``), runs the fused walk (``kernels/ops``), and folds the
chunk's wide event lanes into the running counts and the early-stop tally.

Two step engines (``WalkConfig.backend``), bit-identical by construction:

  * ``"pallas"`` — the hand-written CUDA kernels ``walk_steps_fused`` and
    ``visit_counter_update_high`` / ``visit_counter_wide`` on the card;
    their plain PyTorch twins on the CPU;
  * ``"xla"``    — the plain twins on any device: the oracle.

Two walk drivers, as in the reference: the batch-native engine
(``pixie_random_walk_batched``), which packs every query's walkers
query-major along one walker axis with a query event lane and one shared
early-stop loop, and the per-query engine (``pixie_random_walk``), which
``serve_batch`` runs query by query for ``backend="xla"`` and past
``batched_engine_fits``.  Per-query random streams are the same in both,
so they agree bit for bit.

The count buffers are updated IN PLACE every chunk: at production scale
the batch-native buffer is 4.5 GB, and a copy per chunk would cost more
than the chunk itself.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import counter as counter_lib
from repro_torch.core import prng, sampling
from repro_torch.core.graph import PinBoardGraph
from repro_torch.kernels import ops

BACKENDS = ("xla", "pallas")
GATHER_MODES = ("scalar", "dma")

# disables Algorithm 2's early stopping: no pin can ever reach this many
# visits (int32 max // 2, compared against counts and never added to them)
NO_EARLY_STOP_NV = (2**31 - 1) // 2


def select_count_engine(
    backend: str, n_slots: int, n_pins: int, n_boards: int = 0
) -> str:
    """The counting engine (the backend itself), after the shape check:
    dense counting needs ``n_slots * max(n_pins, n_boards) < 2**31``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown walk backend {backend!r}; use {BACKENDS}")
    n_bins = n_slots * max(n_pins, n_boards)
    if n_bins + 1 >= 2**31:
        raise ValueError(
            f"dense counting materializes n_slots * n_dim = {n_bins} bins, "
            "past int32 indexing; use event-mode counting for "
            "production-scale id spaces"
        )
    return backend


def batched_engine_fits(
    n_queries: int,
    n_slots: int,
    n_pins: int,
    n_boards: int = 0,
    count_boards: bool = False,
    n_shards: int = 1,
) -> bool:
    """Whether the batch-native engine's ``n_queries * n_slots * n_dim``
    query-major bins fit int32 indexing (pure-int predicate)."""
    per_shard = -(-max(n_pins, n_boards if count_boards else 0) // n_shards)
    return n_queries * n_slots * per_shard + 1 < 2**31


def _prob_u32(p: float) -> int:
    """Map a probability to the uint32 threshold used by both engines."""
    return max(0, min(int(round(p * 2.0**32)), 2**32 - 1))


@dataclasses.dataclass(frozen=True)
class WalkConfig:
    """Hyper-parameters of the Pixie random walk; the reference's field
    names and defaults (``repro/core/walk.py:176``).

    n_steps:      N, the total step budget across all query pins (Eq. 2).
    alpha:        restart probability; E[walk segment] = 1/alpha.
    n_walkers:    parallel walkers per query.
    chunk_steps:  supersteps per kernel launch between early-stop checks.
    n_p, n_v:     early stopping: >= n_p pins with >= n_v visits.
    bias_beta:    probability a step uses the personalized feature subrange.
    top_k:        number of recommendations.
    count_boards: also count board visits (board recs, §5.3).
    backend:      "pallas" (hand kernels on the card, plain twins on the
                  CPU) or "xla" (plain twins everywhere: the oracle).
    pallas_block_w, gather_mode: TPU knobs, accepted for config parity and
                  validated; the CUDA kernel has one design for every
                  value, so neither changes a bit.
    """

    n_steps: int = 100_000
    alpha: float = 0.5
    n_walkers: int = 1024
    chunk_steps: int = 8
    n_p: int = 2_000
    n_v: int = 4
    bias_beta: float = 0.9
    top_k: int = 1_000
    count_boards: bool = False
    backend: str = "xla"
    pallas_block_w: Optional[int] = None
    gather_mode: str = "scalar"

    def max_chunks(self) -> int:
        per_chunk = self.n_walkers * self.chunk_steps
        return max(1, -(-self.n_steps // per_chunk))

    def without_early_stop(self) -> "WalkConfig":
        """Algorithm 1 mode: run the full step budget, never stop early."""
        return dataclasses.replace(
            self, n_p=self.n_steps + 1, n_v=NO_EARLY_STOP_NV
        )


class WalkResult(NamedTuple):
    """Dense-mode walk output (batch axis first in the batched engine)."""

    counts: torch.Tensor                  # (..., n_slots, n_pins) int32
    board_counts: Optional[torch.Tensor]  # (..., n_slots, n_boards) or None
    steps_taken: torch.Tensor             # (..., n_slots) int32
    n_high: torch.Tensor                  # (..., n_slots) int32


# ---------------------------------------------------------------------------
# One chunk of steps
# ---------------------------------------------------------------------------


def _chunk_rbits(
    keys: torch.Tensor, step_base: int, chunk_steps: int, w: int
) -> torch.Tensor:
    """Counter-based random bits for one chunk as int32 bit patterns.

    ``keys`` is one ``(2,)`` key -> ``(chunk_steps, w, 4)``, or ``(n, 2)``
    per-query keys -> ``(chunk_steps, n * w, 4)`` laid out query-major
    along the walker axis.  Step ``s`` of query ``q`` draws
    ``bits(fold_in(keys[q], step_base + s), (w, 4))``: keyed by the
    absolute step, so a restarted run replays the identical walk.
    """
    steps = step_base + torch.arange(
        chunk_steps, dtype=torch.int64, device=keys.device
    )
    if keys.dim() == 1:
        step_keys = prng.fold_in(keys[None, :], steps)          # (C, 2)
        rb = prng.bits(step_keys, (w, 4))                       # (C, w, 4)
    else:
        step_keys = prng.fold_in(keys[:, None, :], steps[None, :])  # (Q, C, 2)
        rb = prng.bits(step_keys, (w, 4))                       # (Q, C, w, 4)
        rb = rb.transpose(0, 1).reshape(chunk_steps, -1, 4)
    return prng.to_int32_bits(rb).contiguous()


def _validated_bias_bounds(graph: PinBoardGraph, cfg: WalkConfig):
    """(p2b, b2p) feat bounds for a biased walk, or (None, None)."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown walk backend {cfg.backend!r}; use {BACKENDS}")
    if cfg.gather_mode not in GATHER_MODES:
        raise ValueError(
            f"unknown gather_mode {cfg.gather_mode!r}; use {GATHER_MODES}"
        )
    has_p2b = graph.p2b.feat_bounds is not None
    has_b2p = graph.b2p.feat_bounds is not None
    if has_p2b != has_b2p and cfg.bias_beta > 0.0:
        raise ValueError(
            "graph has feat_bounds on only one CSR side; build both sides "
            "for biased walks or set bias_beta=0"
        )
    use_bias = has_p2b and has_b2p and cfg.bias_beta > 0.0
    if not use_bias:
        return None, None
    return graph.p2b.feat_bounds, graph.b2p.feat_bounds


def _check_feats(feats: torch.Tensor, graph: PinBoardGraph) -> None:
    """Personalization features index the bound tables: refuse ids out of
    range rather than read past a row."""
    n_feats = graph.p2b.n_feats
    if feats.numel() and (int(feats.min()) < 0 or int(feats.max()) >= n_feats):
        raise ValueError(
            f"user features must lie in [0, {n_feats}) for a biased walk"
        )


def _walk_chunk(
    graph: PinBoardGraph,
    curr: torch.Tensor,
    query_of_walker: torch.Tensor,
    feat_of_walker: torch.Tensor,
    slot_of_walker: torch.Tensor,
    key: torch.Tensor,
    step_base: int,
    cfg: WalkConfig,
    n_slots: int,
):
    """Per-query chunk -> ``(new_curr, slot_events, pin_events,
    board_events | None)``, each lane ``(chunk_steps, W)`` int32."""
    p2b_fb, b2p_fb = _validated_bias_bounds(graph, cfg)
    rbits = _chunk_rbits(key, step_base, cfg.chunk_steps, curr.shape[0])
    return ops.walk_chunk_fused(
        curr, query_of_walker, feat_of_walker, slot_of_walker, rbits,
        graph.p2b.offsets, graph.p2b.targets,
        graph.b2p.offsets, graph.b2p.targets, p2b_fb, b2p_fb,
        n_pins=graph.n_pins, n_slots=n_slots, n_boards=graph.n_boards,
        alpha_u32=_prob_u32(cfg.alpha), beta_u32=_prob_u32(cfg.bias_beta),
        count_boards=cfg.count_boards, use_kernel=cfg.backend == "pallas",
    )


def _walk_chunk_batched(
    graph: PinBoardGraph,
    curr: torch.Tensor,
    query_of_walker: torch.Tensor,
    feat_of_walker: torch.Tensor,
    slot_of_walker: torch.Tensor,
    qid_of_walker: torch.Tensor,
    keys: torch.Tensor,
    step_base: int,
    cfg: WalkConfig,
    n_slots: int,
    n_queries: int,
):
    """Batch-native chunk: every query's walkers in ONE fused call ->
    ``(new_curr, query_events, slot_events, pin_events, board_events |
    None)``.  Walker ``q * w + i`` draws exactly the bits it would draw in
    the per-query engine for query ``q``."""
    p2b_fb, b2p_fb = _validated_bias_bounds(graph, cfg)
    w = curr.shape[0] // n_queries
    rbits = _chunk_rbits(keys, step_base, cfg.chunk_steps, w)
    return ops.walk_chunk_fused_batched(
        curr, query_of_walker, feat_of_walker, slot_of_walker, qid_of_walker,
        rbits, graph.p2b.offsets, graph.p2b.targets,
        graph.b2p.offsets, graph.b2p.targets, p2b_fb, b2p_fb,
        n_pins=graph.n_pins, n_slots=n_slots, n_queries=n_queries,
        n_boards=graph.n_boards, alpha_u32=_prob_u32(cfg.alpha),
        beta_u32=_prob_u32(cfg.bias_beta), count_boards=cfg.count_boards,
        use_kernel=cfg.backend == "pallas",
    )


# ---------------------------------------------------------------------------
# Shared set-up: Eq. 1-2 budgets and walker apportionment
# ---------------------------------------------------------------------------


class _Plan(NamedTuple):
    valid_q: torch.Tensor          # (..., S) bool
    safe_q: torch.Tensor           # (..., S) int32 query pin, 0 for padding
    n_q: torch.Tensor              # (..., S) int32 Eq. 2 budgets
    slot_of_walker: torch.Tensor   # (..., w) int32
    query_of_walker: torch.Tensor  # (..., w) int32
    walkers_per_slot: torch.Tensor  # (..., S) int32


def _plan(graph, query_pins, query_weights, cfg, step_budgets) -> _Plan:
    """Eq. 1-2 budgets per slot and the walker pool apportioned to match;
    leading batch axes ride along."""
    if cfg.n_v < 1:
        raise ValueError(
            f"n_v must be >= 1, got {cfg.n_v}; use "
            "cfg.without_early_stop() to disable early stopping"
        )
    dev = graph.device
    query_pins = torch.as_tensor(query_pins, device=dev).to(torch.int32)
    query_weights = torch.as_tensor(query_weights, device=dev).float()
    valid_q = (query_pins >= 0) & (query_weights > 0)
    safe_q = torch.where(valid_q, query_pins, 0)
    degs = graph.pin_degree(safe_q) * valid_q.to(torch.int32)
    if step_budgets is None:
        total = cfg.n_steps
    else:
        total = torch.clamp(
            torch.as_tensor(step_budgets, device=dev).to(torch.int32),
            max=cfg.n_steps,
        )
    n_q = sampling.allocate_steps(
        torch.where(valid_q, query_weights, 0.0), degs,
        graph.max_pin_degree, total,
    )
    slot_of_walker, _ = sampling.allocate_walkers(n_q, cfg.n_walkers)
    query_of_walker = torch.gather(safe_q, -1, slot_of_walker.long())
    walkers_per_slot = torch.zeros_like(n_q).scatter_add_(
        -1, slot_of_walker.long(), torch.ones_like(slot_of_walker)
    )
    return _Plan(valid_q, safe_q, n_q, slot_of_walker, query_of_walker,
                 walkers_per_slot)


def _debit_query_pins(per_slot, safe_q, high, n_v):
    """Never recommend the query pins themselves: zero their counts (in
    place) and debit the tally for any that had reached ``n_v``."""
    rows = per_slot.reshape(-1, per_slot.shape[-1])
    r = torch.arange(rows.shape[0], device=rows.device)
    q = safe_q.reshape(-1).long()
    q_reached = (rows[r, q] >= n_v).to(torch.int32)
    rows[r, q] = 0
    return high - q_reached


# ---------------------------------------------------------------------------
# Per-query engine (Algorithms 2 + 3)
# ---------------------------------------------------------------------------


def pixie_random_walk(
    graph: PinBoardGraph,
    query_pins: torch.Tensor,     # (n_slots,) int32, padded with -1
    query_weights: torch.Tensor,  # (n_slots,) float32, 0 for padding
    user_feat,                    # int or () int32 personalization feature
    key: torch.Tensor,            # (2,) PRNG key
    cfg: WalkConfig,
    step_budget=None,             # optional override of cfg.n_steps
) -> WalkResult:
    """PIXIERANDOMWALKMULTIPLE for one query: biased, weighted,
    early-stopped.  ``step_budget`` overrides Eq. 2's total as data,
    clamped to ``cfg.n_steps``."""
    n_slots = int(query_pins.shape[0])
    n_pins = graph.n_pins
    w = cfg.n_walkers
    dev = graph.device
    count_engine = select_count_engine(
        cfg.backend, n_slots, n_pins, graph.n_boards if cfg.count_boards else 0
    )
    plan = _plan(graph, query_pins, query_weights, cfg, step_budget)
    feat = torch.as_tensor(user_feat, device=dev).to(torch.int32).expand(w)
    feat = feat.contiguous()
    if _validated_bias_bounds(graph, cfg)[0] is not None:
        _check_feats(feat[:1], graph)
    slot_of_walker = plan.slot_of_walker.contiguous()
    query_of_walker = plan.query_of_walker.contiguous()
    key = key.to(dev)

    counts = torch.zeros((n_slots * n_pins,), dtype=torch.int32, device=dev)
    bcounts = (
        torch.zeros((n_slots * graph.n_boards,), dtype=torch.int32, device=dev)
        if cfg.count_boards else None
    )
    high = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    steps_taken = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    slot_active = plan.valid_q.clone()
    curr = query_of_walker.clone()
    it = 0
    while it < cfg.max_chunks() and bool(slot_active.any()):
        walker_active = slot_active[slot_of_walker.long()]
        curr2, sev, pev, bev = _walk_chunk(
            graph, curr, query_of_walker, feat, slot_of_walker, key,
            it * cfg.chunk_steps, cfg, n_slots,
        )
        curr = torch.where(walker_active, curr2, curr)
        # masking the shared slot lane invalidates pin AND board events
        sev = torch.where(walker_active[None, :], sev, n_slots)
        counts, high = counter_lib.accumulate_packed_events_with_high(
            counts, high, sev, pev, n_slots, n_pins, cfg.n_v, count_engine
        )
        if cfg.count_boards:
            counter_lib.accumulate_packed_events(
                bcounts, sev, bev, n_slots, graph.n_boards, count_engine
            )
        steps_taken += (
            plan.walkers_per_slot * slot_active.to(torch.int32) * cfg.chunk_steps
        )
        slot_active = (
            plan.valid_q & (steps_taken < plan.n_q) & (high <= cfg.n_p)
        )
        it += 1
    per_slot = counts.view(n_slots, n_pins)
    n_high = _debit_query_pins(per_slot, plan.safe_q, high, cfg.n_v)
    return WalkResult(
        counts=per_slot,
        board_counts=None if bcounts is None
        else bcounts.view(n_slots, graph.n_boards),
        steps_taken=steps_taken,
        n_high=n_high,
    )


def basic_random_walk(graph, query_pin: int, key, cfg) -> torch.Tensor:
    """Algorithm 1: unbiased, one query pin, the full budget (no early
    stop) -> ``(n_pins,)`` visit counts."""
    cfg_basic = dataclasses.replace(cfg, bias_beta=0.0).without_early_stop()
    res = pixie_random_walk(
        graph, torch.tensor([query_pin], dtype=torch.int32),
        torch.ones((1,)), 0, key, cfg_basic,
    )
    return res.counts[0]


def recommend_with_stats(
    graph, query_pins, query_weights, user_feat, key, cfg, step_budget=None
):
    """walk -> Eq. 3 booster -> top-k, plus Algorithm 3's telemetry:
    ``(scores, ids, steps_taken, n_high)``."""
    res = pixie_random_walk(
        graph, query_pins, query_weights, user_feat, key, cfg,
        step_budget=step_budget,
    )
    boosted = counter_lib.boost_combine(res.counts)
    scores, ids = counter_lib.topk_dense(boosted, cfg.top_k)
    return scores, ids, res.steps_taken, res.n_high


def recommend(graph, query_pins, query_weights, user_feat, key, cfg):
    """Full query path: walk -> Eq. 3 booster -> top-k (scores, pin ids)."""
    scores, ids, _, _ = recommend_with_stats(
        graph, query_pins, query_weights, user_feat, key, cfg
    )
    return scores, ids


# ---------------------------------------------------------------------------
# Batch-native engine: ONE fused loop for the whole serving batch
# ---------------------------------------------------------------------------


def pixie_random_walk_batched(
    graph: PinBoardGraph,
    query_pins: torch.Tensor,     # (n_queries, n_slots) int32, -1 padded
    query_weights: torch.Tensor,  # (n_queries, n_slots) float32
    user_feats: torch.Tensor,     # (n_queries,) int32
    keys: torch.Tensor,           # (n_queries, 2) per-query PRNG keys
    cfg: WalkConfig,
    step_budgets: Optional[torch.Tensor] = None,  # (n_queries,) int32
) -> WalkResult:
    """PIXIERANDOMWALKMULTIPLE over a serving batch, batch-natively.

    Every query's walkers are packed query-major on one walker axis; each
    chunk is one fused walk call and one query-major counting call over
    ``(query, slot, pin)`` bins; one loop carries a per-(query, slot)
    early-stop mask.  Bit-identical to running ``pixie_random_walk`` per
    query with the same keys.  Fields lead with the batch axis.
    ``step_budgets`` overrides each query's Eq. 2 total as data, clamped
    to ``cfg.n_steps``.
    """
    if query_pins.dim() != 2:
        raise ValueError(
            f"query_pins must be (n_queries, n_slots), got {tuple(query_pins.shape)}"
        )
    n_queries, n_slots = (int(d) for d in query_pins.shape)
    n_pins = graph.n_pins
    w = cfg.n_walkers
    n_rows = n_queries * n_slots
    dev = graph.device
    count_engine = select_count_engine(
        cfg.backend, n_rows, n_pins, graph.n_boards if cfg.count_boards else 0
    )
    if keys.shape != (n_queries, 2):
        raise ValueError(f"keys must be ({n_queries}, 2), got {tuple(keys.shape)}")
    plan = _plan(graph, query_pins, query_weights, cfg, step_budgets)
    feats = torch.as_tensor(user_feats, device=dev).to(torch.int32)
    if _validated_bias_bounds(graph, cfg)[0] is not None:
        _check_feats(feats, graph)

    # query-major walker packing: walkers of query q occupy [q*w, (q+1)*w)
    qid_of_walker = torch.arange(
        n_queries, dtype=torch.int32, device=dev
    ).repeat_interleave(w)
    slot_of_walker = plan.slot_of_walker.reshape(-1).contiguous()
    query_of_walker = plan.query_of_walker.reshape(-1).contiguous()
    feat_of_walker = feats.repeat_interleave(w)
    row_of_walker = (qid_of_walker * n_slots + slot_of_walker).long()
    walkers_per_slot = plan.walkers_per_slot.reshape(-1)
    valid_row = plan.valid_q.reshape(-1)
    n_q_row = plan.n_q.reshape(-1)
    keys = keys.to(dev)

    counts = torch.zeros((n_rows * n_pins,), dtype=torch.int32, device=dev)
    bcounts = (
        torch.zeros((n_rows * graph.n_boards,), dtype=torch.int32, device=dev)
        if cfg.count_boards else None
    )
    high = torch.zeros((n_rows,), dtype=torch.int32, device=dev)
    steps_taken = torch.zeros((n_rows,), dtype=torch.int32, device=dev)
    row_active = valid_row.clone()
    curr = query_of_walker.clone()
    it = 0
    while it < cfg.max_chunks() and bool(row_active.any()):
        walker_active = row_active[row_of_walker]
        curr2, qev, sev, pev, bev = _walk_chunk_batched(
            graph, curr, query_of_walker, feat_of_walker, slot_of_walker,
            qid_of_walker, keys, it * cfg.chunk_steps, cfg, n_slots, n_queries,
        )
        curr = torch.where(walker_active, curr2, curr)
        # masking the shared lanes to the sentinel pair invalidates pin AND
        # board events of stopped queries/slots
        qev = torch.where(walker_active[None, :], qev, n_queries)
        sev = torch.where(walker_active[None, :], sev, n_slots)
        # ONE call updates the whole batch's counts in place and every
        # (query, slot) tally
        counts, high = counter_lib.accumulate_packed_events_with_high(
            counts, high, sev, pev, n_slots, n_pins, cfg.n_v, count_engine,
            query_events=qev, n_queries=n_queries,
        )
        if cfg.count_boards:
            counter_lib.accumulate_packed_events(
                bcounts, sev, bev, n_slots, graph.n_boards, count_engine,
                query_events=qev, n_queries=n_queries,
            )
        steps_taken += (
            walkers_per_slot * row_active.to(torch.int32) * cfg.chunk_steps
        )
        row_active = valid_row & (steps_taken < n_q_row) & (high <= cfg.n_p)
        it += 1
    per_slot = counts.view(n_queries, n_slots, n_pins)
    n_high = _debit_query_pins(per_slot, plan.safe_q, high, cfg.n_v)
    return WalkResult(
        counts=per_slot,
        board_counts=None if bcounts is None
        else bcounts.view(n_queries, n_slots, graph.n_boards),
        steps_taken=steps_taken.view(n_queries, n_slots),
        n_high=n_high.view(n_queries, n_slots),
    )


def recommend_with_stats_batched(
    graph, query_pins, query_weights, user_feats, keys, cfg, step_budgets=None
):
    """Batch-native ``recommend_with_stats``: ``(scores (B, top_k), ids
    (B, top_k), steps_taken (B, S), n_high (B, S))``."""
    res = pixie_random_walk_batched(
        graph, query_pins, query_weights, user_feats, keys, cfg,
        step_budgets=step_budgets,
    )
    boosted = counter_lib.boost_combine(res.counts)
    scores, ids = counter_lib.topk_dense(boosted, cfg.top_k)
    return scores, ids, res.steps_taken, res.n_high
