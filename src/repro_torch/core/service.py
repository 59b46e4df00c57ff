"""Query construction and batched serving (paper §5), twin of
``repro/core/service.py`` (unsharded).

* Homefeed (§5.1): each acted pin gets an action-type weight decayed with
  half-life lambda; the top ``n_slots`` pins form the query.
* Related pins (§5.2): shorter walks (higher alpha).
* Board recs (§5.3): board counting on.
* Multi-interest users (PinnerSage): a user's action history clusters
  host-side into k interest lanes over pin topic vectors; each lane is one
  weighted query with its own Eq. 2 step budget, every lane rides the
  batch axis of one ``serve_batch`` call, and ``walk.merge_interest_topk``
  merges a user's lanes back (Eq. 3 across clusters).

``serve_batch`` runs one batch of padded queries: the batch-native engine
for ``backend="pallas"`` (the hand kernels on the card), or query by
query for ``backend="xla"`` and for batches whose query-major bins would
not fit int32; with ``rank=`` it runs stage 2 (``serving/ranker.py``) on
the retrieved candidates.  A ``distributed.ShardedGraph`` routes through
the sharded engine over a routing ``fabric``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import distributed as dist_lib
from repro_torch.core import prng, walk as walk_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving import ranker as ranker_lib

ACTION_WEIGHTS: Dict[str, float] = {
    "save": 1.0,
    "click": 0.6,
    "like": 0.5,
    "view": 0.2,
}


@dataclasses.dataclass(frozen=True)
class UserAction:
    pin: int
    action: str
    age_hours: float


def _decayed_pin_weights(
    actions: Sequence[UserAction],
    half_life_hours: float,
    default_weight: Optional[float],
) -> Dict[int, float]:
    """Per-pin decayed action weights, each pin's terms summed ascending,
    so a weight depends on the multiset of actions, not their order."""
    contribs: Dict[int, List[float]] = {}
    for a in actions:
        base = ACTION_WEIGHTS.get(a.action, default_weight)
        if base is None:
            raise ValueError(
                f"unknown action type {a.action!r}; known: "
                f"{sorted(ACTION_WEIGHTS)} (pass default_weight to accept "
                "unrecognized actions)"
            )
        contribs.setdefault(a.pin, []).append(
            base * 0.5 ** (a.age_hours / half_life_hours)
        )
    acc: Dict[int, float] = {}
    for pin, ws in contribs.items():
        total = 0.0
        for w in sorted(ws):
            total += w
        acc[pin] = total
    return acc


def build_query(
    actions: Sequence[UserAction],
    n_slots: int,
    half_life_hours: float = 24.0,
    default_weight: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse a user's action history into (query_pins, weights): the
    top ``n_slots`` pins by decayed weight (ties by pin id), padded with
    (-1, 0).  Unknown action types raise unless ``default_weight`` is set."""
    acc = _decayed_pin_weights(actions, half_life_hours, default_weight)
    items = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))[:n_slots]
    pins = np.full((n_slots,), -1, dtype=np.int32)
    weights = np.zeros((n_slots,), dtype=np.float32)
    for i, (p, w) in enumerate(items):
        pins[i] = p
        weights[i] = w
    return pins, weights


def homefeed_config(base: walk_lib.WalkConfig) -> walk_lib.WalkConfig:
    """Broad, exploratory walk: longer segments (§5.1 / Explore)."""
    return dataclasses.replace(base, alpha=min(base.alpha, 0.3))


def related_pins_config(base: walk_lib.WalkConfig) -> walk_lib.WalkConfig:
    """Narrow walk, the §5.2 A/B result: shorter walks lift engagement."""
    return dataclasses.replace(base, alpha=max(base.alpha, 0.65))


def board_rec_config(base: walk_lib.WalkConfig) -> walk_lib.WalkConfig:
    return dataclasses.replace(base, count_boards=True)


def batch_queries(
    queries: List[Tuple[np.ndarray, np.ndarray]],
    user_feats: Sequence[int],
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack padded queries for batched serving, on ``device``.

    Validates before stacking: one feature per query, every query with the
    same ``n_slots``, float weights.
    """
    dev = resolve_device(device)
    if not queries:
        raise ValueError("batch_queries needs at least one query")
    if len(user_feats) != len(queries):
        raise ValueError(
            f"{len(queries)} queries but {len(user_feats)} user_feats; "
            "one personalization feature per query required"
        )
    slot_shape = np.asarray(queries[0][0]).shape
    n_slots = slot_shape[0] if len(slot_shape) == 1 else slot_shape
    for i, (q_pins, q_weights) in enumerate(queries):
        p = np.asarray(q_pins)
        w = np.asarray(q_weights)
        if p.shape != slot_shape or w.shape != slot_shape:
            raise ValueError(
                f"query {i} is ragged: pins shape {p.shape}, weights shape "
                f"{w.shape}, but the batch has {n_slots} slots; pad "
                "every query to the same n_slots (service.build_query does)"
            )
        if not np.issubdtype(w.dtype, np.floating):
            raise ValueError(
                f"query {i} weights have dtype {w.dtype}; weights must be "
                "float (integer weights silently skew Eq. 2 step budgets)"
            )
    pins = torch.as_tensor(np.stack([np.asarray(q[0]) for q in queries]),
                           device=dev)
    weights = torch.as_tensor(np.stack([np.asarray(q[1]) for q in queries]),
                              device=dev)
    feats = torch.as_tensor(np.asarray(user_feats, dtype=np.int32), device=dev)
    return pins, weights, feats


# ---------------------------------------------------------------------------
# Multi-interest user queries (PinnerSage-style clustering)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UserQuery:
    """One user's multi-interest query: k interest-cluster lanes.

    Each row of ``cluster_pins`` / ``cluster_weights`` is a weighted query
    for one interest cluster; ``importance`` is the cluster's share of the
    user's action weight, summing to 1.  Lanes are ordered by importance
    descending (ties: smallest member pin id).
    """

    cluster_pins: np.ndarray     # (k, n_slots) int32, -1 padded
    cluster_weights: np.ndarray  # (k, n_slots) float32, 0 padded
    importance: np.ndarray       # (k,) float32, sums to 1
    user_feat: int = 0

    @property
    def n_clusters(self) -> int:
        return int(self.cluster_pins.shape[0])

    @property
    def n_slots(self) -> int:
        return int(self.cluster_pins.shape[1])


def _agglomerate(
    vecs: np.ndarray, mass: np.ndarray, n_clusters: int
) -> List[List[int]]:
    """Deterministic weighted-centroid agglomeration to ``n_clusters``:
    repeatedly merge the pair of clusters with the closest centroids.
    Distances are float64 and the argmin scans row-major, so ties break on
    the smallest (i, j)."""
    members = [[i] for i in range(vecs.shape[0])]
    cent = np.asarray(vecs, np.float64).copy()
    mass = np.asarray(mass, np.float64).copy()
    while len(members) > n_clusters:
        diff = cent[:, None, :] - cent[None, :, :]
        d2 = np.einsum("ijk,ijk->ij", diff, diff)
        iu = np.triu_indices(len(members), k=1)
        flat = np.full_like(d2, np.inf)
        flat[iu] = d2[iu]
        i, j = np.unravel_index(int(np.argmin(flat)), flat.shape)
        tot = mass[i] + mass[j]
        cent[i] = (mass[i] * cent[i] + mass[j] * cent[j]) / tot
        mass[i] = tot
        members[i] = members[i] + members[j]
        del members[j]
        cent = np.delete(cent, j, axis=0)
        mass = np.delete(mass, j, axis=0)
    return members


def build_user_query(
    actions: Sequence[UserAction],
    pin_topics: np.ndarray,   # (n_pins, n_topics) pin embedding table
    n_slots: int,
    n_clusters: int = 3,
    half_life_hours: float = 24.0,
    default_weight: Optional[float] = None,
    user_feat: int = 0,
) -> UserQuery:
    """Cluster a user's action history into a multi-interest ``UserQuery``.

    The distinct acted pins are clustered over their topic vectors; each
    cluster becomes a lane of pins with their decayed weights (top
    ``n_slots`` by weight desc, pin asc) and an importance equal to its
    share of the total action weight (``math.fsum``).  Users with fewer
    distinct pins than ``n_clusters`` get one cluster per pin;
    ``n_clusters=1`` is the flat homefeed query.  Deterministic: the same
    action multiset gives the same ``UserQuery``.
    """
    if n_clusters < 1:
        raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
    acc = _decayed_pin_weights(actions, half_life_hours, default_weight)
    if not acc:
        raise ValueError("build_user_query needs at least one action")
    topics = np.asarray(pin_topics)
    pins = sorted(acc)
    if pins[0] < 0 or pins[-1] >= topics.shape[0]:
        raise ValueError(
            f"action pin ids span [{pins[0]}, {pins[-1]}] but pin_topics "
            f"covers [0, {topics.shape[0]})"
        )
    w64 = np.array([acc[p] for p in pins], dtype=np.float64)
    k = min(n_clusters, len(pins))
    members = _agglomerate(topics[pins].astype(np.float64), w64, k)

    clusters = []
    for mem in members:
        mem_pins = sorted(pins[m] for m in mem)
        imp = math.fsum(acc[p] for p in mem_pins)
        clusters.append((imp, mem_pins))
    clusters.sort(key=lambda c: (-c[0], c[1][0]))

    cluster_pins = np.full((k, n_slots), -1, dtype=np.int32)
    cluster_weights = np.zeros((k, n_slots), dtype=np.float32)
    imp64 = np.array([c[0] for c in clusters], dtype=np.float64)
    for ci, (_, mem_pins) in enumerate(clusters):
        items = sorted(
            ((p, acc[p]) for p in mem_pins), key=lambda kv: (-kv[1], kv[0])
        )[:n_slots]
        for si, (p, w) in enumerate(items):
            cluster_pins[ci, si] = p
            cluster_weights[ci, si] = w
    importance = (imp64 / imp64.sum()).astype(np.float32)
    return UserQuery(
        cluster_pins=cluster_pins,
        cluster_weights=cluster_weights,
        importance=importance,
        user_feat=int(user_feat),
    )


def cluster_step_budgets(importance: np.ndarray, n_steps: int) -> np.ndarray:
    """Eq. 2 at cluster granularity: ``N_c = floor(I_c * N)``, at least 1
    for a live cluster; every budget is <= ``n_steps``."""
    imp = np.asarray(importance, np.float32)
    n_c = np.floor(imp * np.float32(n_steps)).astype(np.int32)
    return np.where(imp > 0, np.maximum(n_c, 1), 0).astype(np.int32)


class UserBatch(NamedTuple):
    """A batch of multi-interest users flattened to cluster lanes.

    The lane axis L (the sum of every user's k) is ``serve_batch``'s query
    axis.  ``lane_user`` / ``lane_of_user`` are host-side numpy: the
    per-user lane map the merge gathers with.
    """

    pins: torch.Tensor          # (L, n_slots) int32
    weights: torch.Tensor       # (L, n_slots) float32
    feats: torch.Tensor         # (L,) int32
    importance: torch.Tensor    # (L,) float32, per-user normalized
    step_budgets: torch.Tensor  # (L,) int32 per-lane Eq. 2 totals
    lane_user: np.ndarray       # (L,) int32 lane -> user index
    lane_of_user: np.ndarray    # (n_users, k_max) int32 lane ids, -1 pad
    n_users: int


def batch_user_queries(
    users: Sequence[UserQuery], n_steps: int, device: DeviceLike = None
) -> UserBatch:
    """Flatten users -> cluster lanes for one batched call, on ``device``.

    ``n_steps`` is the per-user walk budget (the flat path's
    ``cfg.n_steps``), split across each user's lanes by importance.
    """
    dev = resolve_device(device)
    if not users:
        raise ValueError("batch_user_queries needs at least one user")
    n_slots = users[0].n_slots
    for i, u in enumerate(users):
        if u.n_slots != n_slots:
            raise ValueError(
                f"user {i} has {u.n_slots} slots but the batch has "
                f"{n_slots}; build every UserQuery with the same n_slots"
            )
    k_max = max(u.n_clusters for u in users)
    pins, weights, feats, imps, budgets, lane_user = [], [], [], [], [], []
    lane_of_user = np.full((len(users), k_max), -1, dtype=np.int32)
    for ui, u in enumerate(users):
        u_budgets = cluster_step_budgets(u.importance, n_steps)
        for ci in range(u.n_clusters):
            lane_of_user[ui, ci] = len(pins)
            lane_user.append(ui)
            pins.append(u.cluster_pins[ci])
            weights.append(u.cluster_weights[ci])
            feats.append(u.user_feat)
            imps.append(u.importance[ci])
            budgets.append(u_budgets[ci])
    t = lambda a: torch.as_tensor(a, device=dev)
    return UserBatch(
        pins=t(np.stack(pins)),
        weights=t(np.stack(weights)),
        feats=t(np.asarray(feats, np.int32)),
        importance=t(np.asarray(imps, np.float32)),
        step_budgets=t(np.asarray(budgets, np.int32)),
        lane_user=np.asarray(lane_user, np.int32),
        lane_of_user=lane_of_user,
        n_users=len(users),
    )


def serve_batch(
    graph,
    pins: torch.Tensor,        # (batch, n_slots) int32, -1 padded
    weights: torch.Tensor,     # (batch, n_slots) float32
    user_feats: torch.Tensor,  # (batch,) int32
    key: torch.Tensor,         # (2,) key, or (batch, 2) per-query keys
    cfg: walk_lib.WalkConfig,
    backend: Optional[str] = None,
    with_stats: bool = False,
    fabric=None,
    slack: float = 2.0,
    rank: Optional[ranker_lib.RankRequest] = None,
    scenario: Optional[torch.Tensor] = None,
    step_budgets: Optional[torch.Tensor] = None,
    shard_dead_at: Optional[torch.Tensor] = None,
    *,
    return_killed: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """One serving step: Pixie over a whole query batch, on the graph's
    device.

    ``backend`` overrides ``cfg.backend``.  ``"pallas"`` runs the
    batch-native engine (one fused walk launch and one counting launch per
    chunk for the whole batch) whenever its query-major bins fit int32;
    ``"xla"`` and larger batches run query by query.  Both give the same
    bits.

    ``key`` is one ``(2,)`` key, split into one stream per query, or a
    ``(batch, 2)`` array of per-query keys used as they are (the server
    keys each request by ``fold_in(server_key, req_id)``, so a result never
    depends on batch composition).  ``step_budgets`` (optional ``(batch,)``
    int32) overrides each query's Eq. 2 total as data.

    ``rank`` (a ``serving.ranker.RankRequest``) makes the step two-stage:
    retrieval runs with ``top_k`` overridden to ``rank.cfg.n_candidates``,
    then ``ranker.rank_candidates`` re-scores the candidates with each
    request's ``scenario`` head (``(batch,)`` int32; head 0 by default).
    The returned ``(scores, ids)`` are then ``(batch, final_k)``; the
    stats stay stage 1's.  The bag op in stage 2 follows the device, not
    the backend, so both backends give the same ranked bits.

    Returns ``(scores, ids)``, plus ``(steps_taken, n_high)`` with
    ``with_stats=True``, each leading with the batch axis.

    A ``distributed.ShardedGraph`` runs the sharded engine instead
    (``fabric`` required: a ``distributed.LocalFabric`` or
    ``ProcessGroupFabric``; ``slack`` scales routing capacity): the same
    walk, bit-identical to the unsharded engines whenever routing drops
    nothing.  ``with_stats=True`` then appends ``dropped``, the routing
    overflow count.  ``shard_dead_at`` (optional ``(n_shards,)`` int32,
    sharded graphs only) kills shard ``s`` from absolute superstep
    ``shard_dead_at[s]`` on (``distributed.pixie_walk_sharded_batched``);
    the stats stay the reference's five values.  ``return_killed`` (port
    only, with ``with_stats=True`` over a sharded graph) appends
    ``killed``, the walkers lost to dead shards, for ``PixieServer``'s
    ``ServerStats.killed``.
    Over a sharded graph ``step_budgets=`` and ``rank=`` are refused.
    """
    if backend is not None and backend != cfg.backend:
        cfg = dataclasses.replace(cfg, backend=backend)
    if scenario is not None and rank is None:
        raise ValueError(
            "scenario= selects a ranker head and needs rank=; a bare "
            "retrieval step has no scenario axis"
        )
    sharded = isinstance(graph, dist_lib.ShardedGraph)
    if sharded:
        if step_budgets is not None:
            raise ValueError(
                "serve_batch(step_budgets=...) over a ShardedGraph is not "
                "supported: the sharded engine allocates Eq. 2 budgets "
                "from cfg.n_steps; serve multi-interest lanes on an "
                "unsharded replica"
            )
        if rank is not None:
            raise ValueError(
                "serve_batch(rank=...) over a ShardedGraph is not "
                "supported: stage 2 gathers candidate neighborhoods from "
                "the full CSR, which a node-range shard doesn't hold; rank "
                "on an unsharded replica or host-side from the sharded "
                "walk's (scores, ids)"
            )
        if fabric is None:
            raise ValueError(
                "serve_batch over a ShardedGraph needs the routing fabric "
                "(pass fabric=...)"
            )
    elif shard_dead_at is not None:
        raise ValueError(
            "serve_batch(shard_dead_at=...) needs a ShardedGraph: an "
            "unsharded replica has no shards to lose"
        )
    if rank is not None and cfg.top_k != rank.cfg.n_candidates:
        cfg = dataclasses.replace(cfg, top_k=rank.cfg.n_candidates)
    dev = graph.device
    pins = torch.as_tensor(pins, device=dev)
    weights = torch.as_tensor(weights, device=dev)
    user_feats = torch.as_tensor(user_feats, device=dev)
    n_queries = int(pins.shape[0])
    key = torch.as_tensor(key, device=dev)
    if key.dim() == 2:
        if key.shape[0] != n_queries:
            raise ValueError(
                f"per-query key array has {key.shape[0]} keys for a batch "
                f"of {n_queries} queries; one key per query required"
            )
        keys = key
    else:
        keys = prng.split(key, n_queries)

    if sharded:
        out = dist_lib.recommend_sharded_batched(
            graph, pins, weights, keys, cfg, fabric, slack=slack,
            shard_dead_at=shard_dead_at, return_killed=return_killed,
        )
        return out if with_stats else out[:2]
    if cfg.backend == "pallas" and walk_lib.batched_engine_fits(
        n_queries, int(pins.shape[1]), graph.n_pins, graph.n_boards,
        cfg.count_boards,
    ):
        scores, ids, steps, n_high = walk_lib.recommend_with_stats_batched(
            graph, pins, weights, user_feats, keys, cfg,
            step_budgets=step_budgets,
        )
    else:
        budgets = (
            [None] * n_queries if step_budgets is None
            else torch.as_tensor(step_budgets, device=dev).to(torch.int32)
        )
        per_query = [
            walk_lib.recommend_with_stats(
                graph, pins[i], weights[i], user_feats[i], keys[i], cfg,
                step_budget=budgets[i],
            )
            for i in range(n_queries)
        ]
        scores, ids, steps, n_high = (
            torch.stack(parts) for parts in zip(*per_query)
        )
    if rank is not None:
        if scenario is None:
            scenario = torch.zeros((n_queries,), dtype=torch.int32, device=dev)
        scores, ids = ranker_lib.rank_candidates(
            rank.params, rank.cfg, graph, ids, scores, scenario
        )
    if with_stats:
        return scores, ids, steps, n_high
    return scores, ids
