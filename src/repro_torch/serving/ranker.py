"""Stage 2 of the serving path: rank Pixie candidates with scenario heads.

Twin of ``repro/serving/ranker.py``.  The walk's boosted visit counts are
already an importance-weighted sample of the query's neighborhood, so
stage 2 needs no second sampling pass:

  * the query embedding pools the retrieved candidates themselves,
    weighted by ``sqrt(walk score)`` (undoing the Eq. 3 boost);
  * each candidate embedding pools a deterministic 2-hop fan gathered
    from the walk's own CSR (``candidate_neighborhoods``);
  * both pools are one ``embedding_bag_pair`` call for the whole batch:
    one launch of the hand-written kernel on the card (the reference's two
    ``embedding_bag_batched`` calls), two twin calls on the CPU;
  * a per-scenario head (related pins vs homefeed) scores candidates
    against the query, and an exact top-k with ``lax.top_k``'s tie rule
    keeps ``final_k``.

Float contract: the bag op's ``use_kernel`` defaults by device, never by
walk backend, so both walk backends share one stage 2 and ranked serving
keeps the walk's bit parity.  ``sqrt`` is taken in float64 and rounded
(torch's float32 CPU ``sqrt`` is not correctly rounded).  The head
products are ``torch.matmul`` in full float32: on the card TF32 is turned
off (``float32_matmul_precision`` "highest"); their summation order is
torch's, not XLA's, so scores agree with the reference to the last few
ulps, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import counter as counter_lib
from repro_torch.core.graph import PinBoardGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

SCENARIOS: Tuple[str, ...] = ("related_pins", "homefeed")


@dataclasses.dataclass(frozen=True)
class RankerConfig:
    """Shape of the stage-2 ranker (the reference's fields and defaults).

    ``n_items`` must equal the graph's ``n_pins``: candidate ids index the
    item table directly.  ``n_candidates`` is the stage-1 walk top-k fed to
    the ranker (it overrides ``WalkConfig.top_k`` on the serving path);
    ``final_k`` of those come back ranked.
    """

    n_items: int
    d_model: int = 32
    n_neighbors: int = 8
    n_candidates: int = 64
    final_k: int = 16
    scenarios: Tuple[str, ...] = SCENARIOS

    def __post_init__(self):
        if self.final_k > self.n_candidates:
            raise ValueError(
                f"final_k={self.final_k} > n_candidates={self.n_candidates}: "
                "stage 2 can only return candidates stage 1 retrieved"
            )
        if len(set(self.scenarios)) != len(self.scenarios) or not self.scenarios:
            raise ValueError(
                f"scenarios must be non-empty and unique, got {self.scenarios}"
            )

    @property
    def n_scenarios(self) -> int:
        return len(self.scenarios)

    def scenario_id(self, name: str) -> int:
        """Scenario name -> head index; raises on unknown names."""
        try:
            return self.scenarios.index(name)
        except ValueError:
            raise ValueError(
                f"unknown scenario {name!r}; known: {list(self.scenarios)}"
            ) from None


class RankRequest(NamedTuple):
    """What ``service.serve_batch(rank=...)`` needs to run stage 2."""

    params: Dict[str, Any]
    cfg: RankerConfig


def _dense_init(gen: torch.Generator, shape) -> torch.Tensor:
    """The reference's ``layers.dense_init``: normal, std 1/sqrt(fan_in)."""
    std = (1.0 / shape[0]) ** 0.5
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def _embed_init(gen: torch.Generator, shape) -> torch.Tensor:
    """The reference's ``layers.embed_init``: normal, std 0.02 (in place,
    so the production table is never held twice)."""
    return torch.randn(shape, generator=gen, device=gen.device).mul_(0.02)


def init_ranker_params(gen: torch.Generator, cfg: RankerConfig) -> Dict[str, Any]:
    """Item table + one (w_self, w_neigh, w_query, b) head per scenario,
    stacked on a leading scenario axis, drawn from ``gen`` on its device.

    The draws are torch's, not ``jax.random``'s: to hold the port against
    the reference with identical weights, carry the reference's arrays
    across with ``params_from_numpy``."""
    d = cfg.d_model

    def per_scenario() -> torch.Tensor:
        return torch.stack(
            [_dense_init(gen, (d, d)) for _ in range(cfg.n_scenarios)]
        )

    items = _embed_init(gen, (cfg.n_items, d))
    return {
        "items": items,
        "heads": {
            "w_self": per_scenario(),
            "w_neigh": per_scenario(),
            "w_query": per_scenario(),
            "b": torch.zeros((cfg.n_scenarios, d), device=gen.device),
        },
    }


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter pytree, as numpy arrays, as the port's
    parameters on ``device``: ``items`` (n_items, d) and
    ``heads.{w_self, w_neigh, w_query}`` (S, d, d), ``heads.b`` (S, d)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.require(a, requirements="W"), device=dev)
    heads = tree["heads"]
    return {
        "items": t(tree["items"]),
        "heads": {name: t(heads[name])
                  for name in ("w_self", "w_neigh", "w_query", "b")},
    }


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (via float64), as ``jnp.sqrt``."""
    return torch.sqrt(x.double()).float()


def candidate_neighborhoods(
    graph: PinBoardGraph,
    cand_ids: torch.Tensor,   # (..., k) int32, ignored under valid=False
    valid: torch.Tensor,      # (..., k) bool
    n_neighbors: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic 2-hop fan per candidate from the walk's own CSR.

    Neighbor j of candidate c is ``b2p[p2b[c][j % deg(c)]][(j*31 + 7) %
    deg(board)]``.  Returns ``(nbr_ids, nbr_w)``, each ``(..., k,
    n_neighbors)``: ids are -1 where the fan dead-ends (invalid candidate,
    isolated pin, empty board), weights ``1 / (1 + j)`` zeroed there.
    Every gather index is kept in range, so a dead end never reads past a
    CSR array (the reference's ``jnp.take`` clamps instead).
    """
    dev = cand_ids.device
    p2b_off = graph.p2b.offsets
    safe_c = torch.where(valid, cand_ids, 0).long()
    start = p2b_off[safe_c].long()
    deg = p2b_off[safe_c + 1].long() - start
    j = torch.arange(n_neighbors, dtype=torch.int64, device=dev)
    bsel = j % torch.clamp(deg, min=1)[..., None]
    board_ok = (deg > 0)[..., None]
    board = graph.p2b.targets[torch.where(board_ok, start[..., None] + bsel, 0)]
    b_local = torch.where(board_ok, board.long() - graph.n_pins, 0)
    b2p_off = graph.b2p.offsets
    bstart = b2p_off[b_local].long()
    bdeg = b2p_off[b_local + 1].long() - bstart
    psel = (j * 31 + 7) % torch.clamp(bdeg, min=1)
    nbr = graph.b2p.targets[torch.where(bdeg > 0, bstart + psel, 0)]
    ok = valid[..., None] & board_ok & (bdeg > 0)
    nbr_ids = torch.where(ok, nbr.to(torch.int32), -1)
    nbr_w = ok.float() / (1.0 + j.float())
    return nbr_ids, nbr_w


def _full_f32_matmul(dev: torch.device) -> None:
    """Head products in full float32 on the card: TF32 off, which is
    ``float32_matmul_precision`` "highest"."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError("float32 matmul precision must be 'highest'")


def query_bag(
    cand_ids: torch.Tensor, cand_scores: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query side's one bag per request: the retrieved candidates
    weighted by ``sqrt(walk score)`` (undoing the Eq. 3 boost back to
    visit-count scale), padding (score <= 0) as id -1.  Returns ``(ids,
    weights)``, each ``(batch, 1, k)``."""
    valid = cand_scores > 0
    q_ids = torch.where(valid, cand_ids, -1).to(torch.int32)[:, None, :]
    q_w = _sqrt_f32(torch.clamp(cand_scores, min=0.0))[:, None, :]
    return q_ids, q_w


def score_heads(
    heads: Dict[str, torch.Tensor],
    scenario: torch.Tensor,    # (batch,) int64 head index
    self_emb: torch.Tensor,    # (batch, k, d)
    neigh_emb: torch.Tensor,   # (batch, k, d)
    query_emb: torch.Tensor,   # (batch, d)
) -> torch.Tensor:
    """Per-request scenario head: ``relu(self @ W_self + neigh @ W_neigh +
    b) . (query @ W_query) / sqrt(d)`` -> ``(batch, k)`` raw scores."""
    _full_f32_matmul(self_emb.device)
    d = self_emb.shape[-1]
    h = torch.relu(
        torch.matmul(self_emb.float(), heads["w_self"][scenario])
        + torch.matmul(neigh_emb.float(), heads["w_neigh"][scenario])
        + heads["b"][scenario][:, None, :]
    )                                                        # (b, k, d)
    qv = torch.matmul(query_emb.float()[:, None, :],
                      heads["w_query"][scenario])[:, 0]      # (b, d)
    root_d = torch.tensor(math.sqrt(float(d)), dtype=torch.float64).float()
    return torch.matmul(h, qv[:, :, None])[..., 0] / root_d.to(h.device)


def rank_candidates(
    params: Dict[str, Any],
    cfg: RankerConfig,
    graph: PinBoardGraph,
    cand_ids: torch.Tensor,     # (batch, k) int32 from stage-1 top-k
    cand_scores: torch.Tensor,  # (batch, k) f32 boosted walk scores (0 = pad)
    scenario,                   # (batch,) int32 head index per request
    *,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2: score a batch's retrieved candidates with scenario heads.

    Takes the stage-1 ``(ids, scores)`` directly: callers holding walk
    output enter here without re-walking.  ``use_kernel=False`` runs the
    bag twin on any device (the plain path a card run is held against).

    Returns ``(final_scores, final_ids)``, each ``(batch, final_k)``; ids
    are -1 (and scores -inf) where a query retrieved fewer than
    ``final_k`` real candidates.
    """
    if cand_ids.dim() != 2:
        raise ValueError(
            f"rank_candidates is batched: want (batch, k) candidate ids, "
            f"got shape {tuple(cand_ids.shape)}"
        )
    if cfg.n_items != graph.n_pins:
        raise ValueError(
            f"ranker table has {cfg.n_items} items but the graph has "
            f"{graph.n_pins} pins; candidate ids index the item table"
        )
    table = params["items"]
    dev = table.device
    scenario = torch.as_tensor(scenario, device=dev).to(torch.int64)
    scenario = scenario.broadcast_to(cand_ids.shape[:1])
    valid = cand_scores > 0

    # candidate side: self embedding + pooled 2-hop neighborhood
    nbr_ids, nbr_w = candidate_neighborhoods(
        graph, cand_ids, valid, cfg.n_neighbors
    )
    # query side: the retrieved set itself, pooled by sqrt(walk score)
    q_ids, q_w = query_bag(cand_ids, cand_scores)
    # both bags in one launch on the card (two twin calls on the plain path)
    neigh_emb, query_emb = ops.embedding_bag_pair(
        table, nbr_ids, nbr_w, q_ids, q_w, mode="mean", use_kernel=use_kernel
    )                                                 # (b, k, d), (b, 1, d)
    query_emb = query_emb[:, 0]                                # (b, d)
    self_emb = (
        table[torch.where(valid, cand_ids, 0).long()]
        * valid[..., None].to(table.dtype)
    )                                                        # (b, k, d)

    raw = score_heads(params["heads"], scenario, self_emb, neigh_emb,
                      query_emb)
    rank_scores = torch.where(valid, raw, float("-inf"))
    vals, idx = counter_lib.topk_dense(rank_scores, cfg.final_k)
    idx = idx.long()
    sel_valid = torch.gather(valid, 1, idx)
    ids = torch.where(sel_valid, torch.gather(cand_ids, 1, idx), -1)
    return vals, ids.to(torch.int32)
