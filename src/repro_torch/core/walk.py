"""The Pixie Random Walk engines (paper §3.1, Algorithms 1-3), in torch.

Twin of ``repro/core/walk.py``: W walkers run in lockstep; one step is
maybe-restart -> board from E(pin) -> pin from E(board) -> record visit.
Each superstep chunk draws the counter-based threefry bits, runs the fused
walk (``kernels/ops``), and folds the chunk's wide event lanes into the
running counts and the early-stop tally.  On the card the walk kernel
draws the bits itself from the keys; the plain twins take them as a
table (``_chunk_rbits``).  Keys travel as int32 bit patterns, converted
once per request.

Two step engines (``WalkConfig.backend``), bit-identical by construction:

  * ``"pallas"`` — the hand-written CUDA kernels ``walk_steps_fused`` and
    ``visit_counter_update_high`` / ``visit_counter_wide`` on the card;
    their plain PyTorch twins on the CPU;
  * ``"xla"``    — the plain twins on any device: the oracle.

Three walk drivers, as in the reference: the batch-native engine
(``pixie_random_walk_batched``), which packs every query's walkers
query-major along one walker axis with a query event lane and one shared
early-stop loop, and the per-query engine (``pixie_random_walk``), which
``serve_batch`` runs query by query for ``backend="xla"`` and past
``batched_engine_fits``.  Per-query random streams are the same in both,
so they agree bit for bit.  The third is event mode
(``pixie_walk_events`` + ``recommend_from_events``), the reference's
replicated serving path: per query, it keeps the walk's wide (slot, pin)
event lanes instead of a count table and aggregates them by sorting, so
its memory is O(steps) and its packed id space has no int32 limit.

The count buffers are updated IN PLACE every chunk: at production scale
the batch-native buffer is 4.5 GB, and a copy per chunk would cost more
than the chunk itself.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import abstract
from repro_torch.core import counter as counter_lib
from repro_torch.core import prng, sampling
from repro_torch.core.graph import PinBoardGraph
from repro_torch.kernels import ops
from repro_torch.kernels import walk_step as ws
from repro_torch.serving import batch_trace

BACKENDS = ("xla", "pallas")
GATHER_MODES = ("scalar", "dma")

# disables Algorithm 2's early stopping: no pin can ever reach this many
# visits (int32 max // 2, compared against counts and never added to them)
NO_EARLY_STOP_NV = (2**31 - 1) // 2


def packed_event_dtype(n_slots: int, n_pins: int) -> torch.dtype:
    """Dtype of EACH wide event lane: int32 at every id-space scale, since
    no lane ever holds the packed ``slot * n_pins + pin`` product."""
    del n_slots, n_pins
    return torch.int32


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
            "past int32 indexing; use event-mode counting "
            "(pixie_walk_events) for production-scale id spaces"
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


class EventWalkResult(NamedTuple):
    """Event-mode walk output (scale-free, wide lanes)."""

    slot_events: torch.Tensor  # (max_events,) int32 slot lane (n_slots = invalid)
    pin_events: torch.Tensor   # (max_events,) int32 pin lane
    steps_taken: torch.Tensor  # (n_slots,) int32
    chunks_run: torch.Tensor   # () int32
    n_high: torch.Tensor       # (n_slots,) int32 Algorithm 3 tally as of the
                               # last completed check window (zeros when
                               # early stopping never checked)


# ---------------------------------------------------------------------------
# One chunk of steps
# ---------------------------------------------------------------------------


def _chunk_rbits(
    keys: torch.Tensor, step_base: int, chunk_steps: int, w: int
) -> torch.Tensor:
    """Counter-based random bits for one chunk as int32 bit patterns: the
    plain twin of the ``walk_bits`` kernel (the walk kernel draws the same
    words in registers from the keys).

    ``keys`` is one ``(2,)`` key -> ``(chunk_steps, w, 4)``, or ``(n, 2)``
    per-query keys -> ``(chunk_steps, n * w, 4)`` laid out query-major
    along the walker axis; keys are int64 word values or int32 bit
    patterns.  Step ``s`` of query ``q`` draws ``bits(fold_in(keys[q],
    step_base + s), (w, 4))``: keyed by the absolute step, so a restarted
    run replays the identical walk.
    """
    if keys.dtype != torch.int64:
        keys = prng.from_int32_bits(keys)
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


def _key_bits(keys: torch.Tensor, dev) -> torch.Tensor:
    """The walk's key(s) as the uint32 bit patterns the kernels read (int32),
    converted once per request and handed to every chunk."""
    return ws.u32_bits_as_int32(keys.to(dev)).contiguous()


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
    if abstract.is_fake(feats):
        return              # a dry run's features hold no values to check
    if not feats.numel():
        return
    batch_trace.host_sync("walk.feat_check", 2)     # the min and the max
    if int(feats.min()) < 0 or int(feats.max()) >= n_feats:
        raise ValueError(
            f"user features must lie in [0, {n_feats}) for a biased walk"
        )


def _any_live(active: torch.Tensor) -> bool:
    """Whether any query or slot still walks: a host read of the device,
    before each chunk."""
    batch_trace.host_sync("walk.live_rows")
    return bool(active.any())


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
    board_events | None)``, each lane ``(chunk_steps, W)`` int32.  ``key``
    is the query's key as int32 bit patterns (``_key_bits``)."""
    p2b_fb, b2p_fb = _validated_bias_bounds(graph, cfg)
    return ops.walk_chunk_fused(
        curr, query_of_walker, feat_of_walker, slot_of_walker, key,
        graph.p2b.offsets, graph.p2b.targets,
        graph.b2p.offsets, graph.b2p.targets, p2b_fb, b2p_fb,
        step_base=step_base, chunk_steps=cfg.chunk_steps,
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
    the per-query engine for query ``q``.  ``keys`` are the per-query
    keys as int32 bit patterns (``_key_bits``)."""
    p2b_fb, b2p_fb = _validated_bias_bounds(graph, cfg)
    return ops.walk_chunk_fused_batched(
        curr, query_of_walker, feat_of_walker, slot_of_walker, qid_of_walker,
        keys, graph.p2b.offsets, graph.p2b.targets,
        graph.b2p.offsets, graph.b2p.targets, p2b_fb, b2p_fb,
        step_base=step_base, chunk_steps=cfg.chunk_steps,
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


def _query_setup(graph, query_pins, query_weights, user_feat, cfg,
                 step_budget=None):
    """One query's plan, its feature per walker (checked against the bound
    tables of a biased walk) and contiguous walker lanes: ``(plan, feat,
    slot_of_walker, query_of_walker)``."""
    plan = _plan(graph, query_pins, query_weights, cfg, step_budget)
    feat = torch.as_tensor(user_feat, device=graph.device).to(torch.int32)
    feat = feat.expand(cfg.n_walkers).contiguous()
    if _validated_bias_bounds(graph, cfg)[0] is not None:
        _check_feats(feat[:1], graph)
    return (plan, feat, plan.slot_of_walker.contiguous(),
            plan.query_of_walker.contiguous())


def _debit_query_pins(per_slot, safe_q, high, n_v):
    """Never recommend the query pins themselves: zero their counts (in
    place) and debit the tally for any that had reached ``n_v``."""
    rows = per_slot.reshape(-1, per_slot.shape[-1])
    r = torch.arange(rows.shape[0], device=rows.device)
    q = safe_q.reshape(-1).long()
    q_reached = (rows[r, q] >= n_v).to(torch.int32)
    batch_trace.host_sync("walk.debit")     # the 0 copied to the device
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
    dev = graph.device
    count_engine = select_count_engine(
        cfg.backend, n_slots, n_pins, graph.n_boards if cfg.count_boards else 0
    )
    plan, feat, slot_of_walker, query_of_walker = _query_setup(
        graph, query_pins, query_weights, user_feat, cfg, step_budget)
    key = _key_bits(key, dev)

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
    while it < cfg.max_chunks() and _any_live(slot_active):
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
    batch_trace.count_chunks(it)
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
# Event mode: the scale-free path of the replicated serving cell
# ---------------------------------------------------------------------------


def pixie_walk_events(
    graph: PinBoardGraph,
    query_pins: torch.Tensor,     # (n_slots,) int32, padded with -1
    query_weights: torch.Tensor,  # (n_slots,) float32, 0 for padding
    user_feat,                    # int or () int32 personalization feature
    key: torch.Tensor,            # (2,) PRNG key
    cfg: WalkConfig,
    check_every: int = 4,
    check_mode: str = "incremental",
) -> EventWalkResult:
    """Event-buffer walk for one query: memory O(steps), independent of the
    graph's size and of the packed id space.

    Each chunk's wide (slot, pin) lanes (from ``walk_steps_fused`` on the
    card with ``backend="pallas"``) are written in place into lane buffers
    allocated once for ``max_chunks`` chunks; lanes of stopped walkers
    become the (``n_slots``, 0) sentinel.  Early stopping checks after
    every ``check_every``-th chunk:

      * ``"incremental"`` folds only the new window's events into an
        ``EventHighState`` (``counter.events_high_fold``): every sort is
        window-sized;
      * ``"full"`` re-sorts the whole buffer (``events_n_high_per_slot``),
        the oracle the incremental tally is held against.

    Between checks a slot stays active while it has budget left, as in
    the reference (a stop holds until the next chunk unless every slot
    stopped).  Board counting is forced off: event mode buffers pins only.
    ``n_v`` must be >= 1, as in the dense engines.
    """
    if check_mode not in ("incremental", "full"):
        raise ValueError(
            f"unknown check_mode {check_mode!r}; use 'incremental' or 'full'"
        )
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if cfg.count_boards:
        cfg = dataclasses.replace(cfg, count_boards=False)
    n_slots = int(query_pins.shape[0])
    n_pins = graph.n_pins
    w = cfg.n_walkers
    dev = graph.device
    per_chunk = w * cfg.chunk_steps
    max_chunks = cfg.max_chunks()
    max_events = max_chunks * per_chunk
    # check windows that can fire: they size the run-segment state
    n_windows = max_chunks // check_every
    seg_cap = check_every * per_chunk

    plan, feat, slot_of_walker, query_of_walker = _query_setup(
        graph, query_pins, query_weights, user_feat, cfg)
    key = _key_bits(key, dev)

    sev_buf = torch.full((max_events,), n_slots, dtype=torch.int32, device=dev)
    pev_buf = torch.zeros((max_events,), dtype=torch.int32, device=dev)
    incremental = check_mode == "incremental" and n_windows > 0
    hstate = counter_lib.events_high_init(
        n_slots, n_windows if incremental else 0,
        seg_cap if incremental else 1, device=dev,
    )
    steps_taken = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
    slot_active = plan.valid_q.clone()
    curr = query_of_walker.clone()
    it = 0
    while it < max_chunks and _any_live(slot_active):
        walker_active = slot_active[slot_of_walker.long()]
        curr2, sev, pev, _ = _walk_chunk(
            graph, curr, query_of_walker, feat, slot_of_walker, key,
            it * cfg.chunk_steps, cfg, n_slots,
        )
        curr = torch.where(walker_active, curr2, curr)
        # mask BOTH lanes to the (n_slots, 0) sentinel, so aggregated runs
        # stay sorted end to end (events_high_fold binary-searches them)
        live = walker_active[None, :]
        window = slice(it * per_chunk, (it + 1) * per_chunk)
        sev_buf[window] = torch.where(live, sev, n_slots).reshape(-1)
        pev_buf[window] = torch.where(live, pev, 0).reshape(-1)
        steps_taken += (
            plan.walkers_per_slot * slot_active.to(torch.int32) * cfg.chunk_steps
        )
        budget_left = plan.valid_q & (steps_taken < plan.n_q)
        if (it + 1) % check_every == 0:
            if incremental:
                start = (it + 1) * per_chunk - seg_cap
                hstate = counter_lib.events_high_fold(
                    hstate, sev_buf[start:start + seg_cap],
                    pev_buf[start:start + seg_cap], n_slots, n_pins,
                    cfg.n_v, seg_cap=seg_cap,
                )
            else:
                hstate = hstate._replace(high=counter_lib.events_n_high_per_slot(
                    sev_buf, pev_buf, n_slots, n_pins, cfg.n_v, max_events
                ))
            slot_active = budget_left & (hstate.high <= cfg.n_p)
        else:
            slot_active = budget_left
        it += 1
    return EventWalkResult(
        slot_events=sev_buf,
        pin_events=pev_buf,
        steps_taken=steps_taken,
        chunks_run=torch.tensor(it, dtype=torch.int32, device=dev),
        n_high=hstate.high,
    )


def pixie_walk_events_fixed(
    graph: PinBoardGraph,
    query_pins: torch.Tensor,
    query_weights: torch.Tensor,
    user_feat,
    key: torch.Tensor,
    cfg: WalkConfig,
    n_chunks: int,
    unroll: bool = True,
) -> EventWalkResult:
    """Exactly ``n_chunks`` chunks, no early stopping and no masking: the
    reference's cost-model twin of ``pixie_walk_events``.  ``unroll`` is
    its XLA unrolling knob, accepted for parity; it changes no bit."""
    del unroll
    if cfg.count_boards:
        cfg = dataclasses.replace(cfg, count_boards=False)
    n_slots = int(query_pins.shape[0])
    dev = graph.device
    _, feat, slot_of_walker, query_of_walker = _query_setup(
        graph, query_pins, query_weights, user_feat, cfg)
    key = _key_bits(key, dev)
    curr = query_of_walker.clone()
    sev_chunks, pev_chunks = [], []
    for it in range(n_chunks):
        curr, sev, pev, _ = _walk_chunk(
            graph, curr, query_of_walker, feat, slot_of_walker, key,
            it * cfg.chunk_steps, cfg, n_slots,
        )
        sev_chunks.append(sev.reshape(-1))
        pev_chunks.append(pev.reshape(-1))
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    return EventWalkResult(
        slot_events=torch.cat(sev_chunks) if sev_chunks else empty,
        pin_events=torch.cat(pev_chunks) if pev_chunks else empty,
        steps_taken=torch.full((n_slots,), n_chunks * cfg.chunk_steps,
                               dtype=torch.int32, device=dev),
        chunks_run=torch.tensor(n_chunks, dtype=torch.int32, device=dev),
        n_high=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    )


def recommend_from_events(
    result: EventWalkResult,
    n_slots: int,
    n_pins: int,
    query_pins: torch.Tensor,
    top_k: int,
):
    """Eq. 3 + top-k from wide event lane buffers -> ``(scores, pin ids)``.
    Pair-sort aggregation on the int32 lanes: no 64-bit packed id, so id
    spaces past 2**31 packed ids are served as any other."""
    max_events = result.slot_events.shape[0]
    uniq_slot, uniq_pin, counts = counter_lib.events_to_counts(
        result.slot_events, result.pin_events, n_slots, max_events
    )
    pin_ids, boosted = counter_lib.boosted_from_events(
        uniq_slot, uniq_pin, counts, n_slots, n_pins, max_events
    )
    query_pins = torch.as_tensor(query_pins, device=pin_ids.device)
    is_query = torch.isin(pin_ids, query_pins.to(torch.int32))
    boosted = torch.where(is_query, 0.0, boosted)
    return counter_lib.topk_events(pin_ids, boosted, top_k)


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
    keys = _key_bits(keys, dev)

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
    while it < cfg.max_chunks() and _any_live(row_active):
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
    batch_trace.count_chunks(it)
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
    (B, top_k), steps_taken (B, S), n_high (B, S))``; the walk, the boost
    and the top-k are spans of a served batch's record."""
    with batch_trace.span("pixie.walk"):
        res = pixie_random_walk_batched(
            graph, query_pins, query_weights, user_feats, keys, cfg,
            step_budgets=step_budgets,
        )
    with batch_trace.span("pixie.boost"):
        boosted = counter_lib.boost_combine(res.counts)
    with batch_trace.span("pixie.topk"):
        scores, ids = counter_lib.topk_dense(boosted, cfg.top_k)
    return scores, ids, res.steps_taken, res.n_high


# ---------------------------------------------------------------------------
# Multi-interest merge: Eq. 3 across a user's interest-cluster lanes
# ---------------------------------------------------------------------------

# id-lane sentinel that sorts after every real pin id
_MERGE_ID_SENTINEL = 2**31 - 1


def merge_interest_topk(
    scores: torch.Tensor,      # (..., k, top_k) float32 per-cluster scores
    ids: torch.Tensor,         # (..., k, top_k) int32 pin ids, -1 padded
    importance: torch.Tensor,  # (..., k) float32, 0 for padding lanes
    top_k: Optional[int] = None,
):
    """Merge each user's per-cluster top-k lists: Eq. 3 across clusters,
    ``V[p] = (sum_c I_c * sqrt(V_c[p]))**2``; leading axes are users.

    The reference's bit-reproducible construction, step for step:

      * entries are put in (id, contribution) order — the reference's
        two-key ``lax.sort`` as two stable sorts, contribution first,
        then id;
      * per-id sums are left-to-right shift-adds (a pin appears in at
        most k lanes);
      * the final top-k takes the lower entry index among equal scores,
        i.e. the lower pin id (``counter.topk_dense``);
      * a user with exactly one live lane gets that lane verbatim.

    ``sqrt`` is taken in float64 and rounded, as ``jnp.sqrt`` rounds.
    Returns ``(scores (..., top_k), ids (..., top_k))``, id -1 / score 0
    padded, ``top_k`` defaulting to the per-lane top_k.
    """
    if scores.dim() < 2 or scores.shape != ids.shape:
        raise ValueError(
            f"scores/ids must be matching (..., k, top_k), got "
            f"{tuple(scores.shape)} vs {tuple(ids.shape)}"
        )
    k, per_lane_k = scores.shape[-2], scores.shape[-1]
    lead = scores.shape[:-2]
    out_k = per_lane_k if top_k is None else top_k
    live_lane = importance > 0
    valid = live_lane[..., None] & (ids >= 0) & (scores > 0)
    root = torch.sqrt(scores.double()).float()
    contrib = torch.where(valid, importance[..., None] * root, 0.0)
    contrib = contrib.reshape(*lead, k * per_lane_k)
    sort_ids = torch.where(valid, ids, _MERGE_ID_SENTINEL).to(torch.int32)
    sort_ids = sort_ids.reshape(*lead, k * per_lane_k)
    sc, order = torch.sort(contrib, dim=-1, stable=True)
    sid = torch.gather(sort_ids, -1, order)
    sid, order = torch.sort(sid, dim=-1, stable=True)
    sc = torch.gather(sc, -1, order)

    acc = sc
    for d in range(1, k):
        pad_b = torch.zeros((*lead, d), dtype=torch.bool, device=sc.device)
        pad_f = torch.zeros((*lead, d), dtype=sc.dtype, device=sc.device)
        same = torch.cat([sid[..., d:] == sid[..., :-d], pad_b], dim=-1)
        shifted = torch.cat([sc[..., d:], pad_f], dim=-1)
        acc = acc + torch.where(same, shifted, 0.0)

    first = torch.cat(
        [torch.ones((*lead, 1), dtype=torch.bool, device=sc.device),
         sid[..., 1:] != sid[..., :-1]], dim=-1,
    )
    owner = first & (sid != _MERGE_ID_SENTINEL)
    merged = torch.where(owner, acc * acc, float("-inf"))
    vals, idx = counter_lib.topk_dense(merged, out_k)
    got = vals > float("-inf")
    merged_scores = torch.where(got, vals, 0.0).to(scores.dtype)
    merged_ids = torch.where(
        got, torch.gather(sid, -1, idx.long()), -1
    ).to(torch.int32)

    if out_k == per_lane_k:
        single = live_lane.to(torch.int32).sum(-1) == 1        # lead
        lane = live_lane.to(torch.int32).argmax(-1)            # lead
        pick = lane[..., None, None].expand(*lead, 1, per_lane_k)
        lane_scores = torch.gather(scores, -2, pick)[..., 0, :]
        lane_ids = torch.gather(ids, -2, pick)[..., 0, :]
        merged_scores = torch.where(single[..., None], lane_scores, merged_scores)
        merged_ids = torch.where(single[..., None], lane_ids.to(torch.int32),
                                 merged_ids)
    return merged_scores, merged_ids
