"""Two-stage and multi-interest recommendation (twin of
``repro/serving/recommend.py``).

Pixie's walk retrieves candidates; a ranker re-scores them.  The stage
boundary is ``rank_retrieved``: anything holding walk output enters there
without re-walking.  ``recommend_two_stage`` is ``serve_batch(rank=...)``;
``recommend_multi_interest`` walks every interest lane of a batch of users
in one ``serve_batch`` call and merges each user's lanes (Eq. 3 across
clusters), optionally ranking the merged set.  ``sasrec_ranker`` builds
a stage-2 closure from a SASRec user state (``models/sequential_rec.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import counter as counter_lib
from repro_torch.core import service, walk as walk_lib
from repro_torch.core.graph import PinBoardGraph
from repro_torch.models import embedding, sequential_rec as sr
from repro_torch.serving import ranker as ranker_lib


@dataclasses.dataclass(frozen=True)
class TwoStageConfig:
    n_candidates: int = 200      # Pixie walk top-k fed to the ranker
    final_k: int = 20


def rank_retrieved(
    walk_scores: torch.Tensor,   # (k,) stage-1 scores, 0 = padding
    cand: torch.Tensor,          # (k,) stage-1 candidate ids
    ranker: Callable[[torch.Tensor], torch.Tensor],  # ids (k,) -> scores (k,)
    final_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 alone: re-score a precomputed retrieval ``(scores, ids)``.

    Zero-walk-score candidates are padding: masked to -inf, and reported
    as id -1 if the top ``final_k`` reaches them.
    """
    rank_scores = ranker(cand)
    rank_scores = torch.where(walk_scores > 0, rank_scores, float("-inf"))
    # a ranker's scores may hold NaN (an id past its table): lax.top_k's order
    vals, idx = counter_lib.topk_total(rank_scores, final_k)
    idx = idx.long()
    ids = torch.where(walk_scores[idx] > 0, cand[idx], -1)
    return vals, ids.to(torch.int32)


def pixie_then_rank(
    graph: PinBoardGraph,
    query_pins: torch.Tensor,    # (n_slots,)
    query_weights: torch.Tensor,
    user_feat,
    key: torch.Tensor,
    walk_cfg: walk_lib.WalkConfig,
    ranker: Callable[[torch.Tensor], torch.Tensor],
    cfg: TwoStageConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk with ``top_k = n_candidates``, then ``rank_retrieved``:
    ``(scores (final_k,), ids (final_k,))``."""
    walk_cfg = dataclasses.replace(walk_cfg, top_k=cfg.n_candidates)
    walk_scores, cand = walk_lib.recommend(
        graph, query_pins, query_weights, user_feat, key, walk_cfg
    )
    return rank_retrieved(walk_scores, cand, ranker, cfg.final_k)


def sasrec_ranker(
    params: Dict[str, Any],
    user_history: torch.Tensor,  # (s,) item ids
    cfg: sr.SeqRecConfig,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """A candidate-scoring closure from one SASRec user state.

    A ``-1`` candidate (an under-full retrieval slot) scores ``-inf``, not
    item 0's affinity; other ids are read as ``jnp.take`` reads them."""
    state = sr.sasrec_user_state(params, user_history[None], cfg)[0]   # (d,)

    def score(cand: torch.Tensor) -> torch.Tensor:
        emb = embedding.take_rows(params["items"], torch.clamp(cand, min=0))
        return torch.where(cand >= 0, emb @ state, float("-inf"))

    return score


def recommend_two_stage(
    graph: PinBoardGraph,
    pins: torch.Tensor,          # (batch, n_slots)
    weights: torch.Tensor,       # (batch, n_slots)
    user_feats: torch.Tensor,    # (batch,)
    key: torch.Tensor,
    walk_cfg: walk_lib.WalkConfig,
    rank: ranker_lib.RankRequest,
    scenario: Optional[torch.Tensor] = None,
    backend: Optional[str] = None,
    with_stats: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The two-stage serving step: ``service.serve_batch(rank=...)``."""
    return service.serve_batch(
        graph, pins, weights, user_feats, key, walk_cfg,
        backend=backend, with_stats=with_stats,
        rank=rank, scenario=scenario,
    )


def recommend_multi_interest(
    graph: PinBoardGraph,
    batch: service.UserBatch,
    key: torch.Tensor,
    walk_cfg: walk_lib.WalkConfig,
    backend: Optional[str] = None,
    with_stats: bool = False,
    rank: Optional[ranker_lib.RankRequest] = None,
    scenario: Optional[torch.Tensor] = None,   # (n_users,) head per user
) -> Tuple[torch.Tensor, ...]:
    """Multi-interest serving: every user's interest lanes in one walk.

      1. all users' cluster lanes ride one ``serve_batch`` call with
         per-lane Eq. 2 step budgets;
      2. each user's lanes gather back through the host-side lane map and
         merge with ``walk.merge_interest_topk`` (a single-cluster user's
         lane passes through verbatim);
      3. with ``rank``, stage 2 re-scores each user's merged candidate set
         (``walk_cfg.top_k`` becomes ``rank.cfg.n_candidates``), with
         ``scenario`` indexed per user.

    ``key`` is one ``(2,)`` key, split into one stream per lane, or an
    ``(n_lanes, 2)`` array of per-lane keys.  Returns ``(scores, ids)``,
    each ``(n_users, top_k)``; ``with_stats=True`` appends the lane-level
    ``(steps_taken, n_high)``.
    """
    if rank is not None and walk_cfg.top_k != rank.cfg.n_candidates:
        walk_cfg = dataclasses.replace(walk_cfg, top_k=rank.cfg.n_candidates)
    if scenario is not None and rank is None:
        raise ValueError(
            "scenario= selects a ranker head and needs rank=; a bare "
            "multi-interest retrieval has no scenario axis"
        )
    scores, ids, steps, n_high = service.serve_batch(
        graph, batch.pins, batch.weights, batch.feats, key, walk_cfg,
        backend=backend, with_stats=True, step_budgets=batch.step_budgets,
    )
    dev = scores.device
    lane_map = np.asarray(batch.lane_of_user)          # (U, k_max)
    take_idx = torch.as_tensor(np.where(lane_map >= 0, lane_map, 0),
                               dtype=torch.int64, device=dev)
    live = torch.as_tensor((lane_map >= 0).astype(np.float32), device=dev)
    merged_scores, merged_ids = walk_lib.merge_interest_topk(
        scores[take_idx], ids[take_idx],
        batch.importance.to(dev)[take_idx] * live,
    )
    if rank is not None:
        if scenario is None:
            scenario = torch.zeros((batch.n_users,), dtype=torch.int32,
                                   device=dev)
        merged_scores, merged_ids = ranker_lib.rank_candidates(
            rank.params, rank.cfg, graph, merged_ids, merged_scores, scenario,
        )
    if with_stats:
        return merged_scores, merged_ids, steps, n_high
    return merged_scores, merged_ids
