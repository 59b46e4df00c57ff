"""Query construction and batched retrieval serving (paper §5), twin of
``repro/core/service.py`` (unsharded, unranked).

* Homefeed (§5.1): each acted pin gets an action-type weight decayed with
  half-life lambda; the top ``n_slots`` pins form the query.
* Related pins (§5.2): shorter walks (higher alpha).
* Board recs (§5.3): board counting on.

``serve_batch`` runs one batch of padded queries: the batch-native engine
for ``backend="pallas"`` (the hand kernels on the card), or query by
query for ``backend="xla"`` and for batches whose query-major bins would
not fit int32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng, walk as walk_lib
from repro_torch.device import DeviceLike, resolve_device

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


def serve_batch(
    graph,
    pins: torch.Tensor,        # (batch, n_slots) int32, -1 padded
    weights: torch.Tensor,     # (batch, n_slots) float32
    user_feats: torch.Tensor,  # (batch,) int32
    key: torch.Tensor,         # (2,) key, or (batch, 2) per-query keys
    cfg: walk_lib.WalkConfig,
    backend: Optional[str] = None,
    with_stats: bool = False,
    step_budgets: Optional[torch.Tensor] = None,
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

    Returns ``(scores, ids)``, plus ``(steps_taken, n_high)`` with
    ``with_stats=True``, each leading with the batch axis.
    """
    if backend is not None and backend != cfg.backend:
        cfg = dataclasses.replace(cfg, backend=backend)
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
    if with_stats:
        return scores, ids, steps, n_high
    return scores, ids
