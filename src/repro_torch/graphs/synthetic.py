"""Synthetic Pinterest-like bipartite graphs (twin of
``repro/graphs/synthetic.py``).

The edge lists are drawn on the host with the reference's exact numpy
``default_rng`` call sequence, so a seed gives the same edges as the
reference; the CSR is then compiled by the port's ``build_graph`` on the
requested device.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import PinBoardGraph, build_graph
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticGraphConfig:
    n_pins: int = 20_000
    n_boards: int = 2_000
    n_topics: int = 16
    n_langs: int = 4
    mean_board_size: int = 40
    board_size_sigma: float = 1.0
    popularity_exponent: float = 1.1
    diverse_board_frac: float = 0.1
    board_topic_alpha: float = 0.08
    pin_topic_alpha: float = 0.10
    noise_edge_frac: float = 0.05
    lang_probs: Optional[Tuple[float, ...]] = None
    seed: int = 0


class SyntheticGraph(NamedTuple):
    graph: PinBoardGraph
    pin_topics: np.ndarray     # (n_pins, n_topics) float32 rows sum to 1
    board_topics: np.ndarray   # (n_boards, n_topics)
    pin_lang: np.ndarray       # (n_pins,) int32
    board_lang: np.ndarray     # (n_boards,) int32
    heldout_pins: np.ndarray   # (n_heldout,) future-save pin per board sample
    heldout_boards: np.ndarray


def _lang_probs(cfg: SyntheticGraphConfig) -> np.ndarray:
    if cfg.lang_probs is not None:
        p = np.asarray(cfg.lang_probs, dtype=np.float64)
        return p / p.sum()
    base = np.ones(cfg.n_langs)
    base[0] = max(1.0, cfg.n_langs * 2.0)  # dominant language
    return base / base.sum()


def generate(
    cfg: SyntheticGraphConfig,
    holdout_frac: float = 0.05,
    device: DeviceLike = None,
) -> SyntheticGraph:
    """Seeded graph with planted topics, languages and heavy-tailed pins.

    The draws below are the reference's, call for call; only the final
    CSR compile runs in torch, on ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    nt = cfg.n_topics

    board_topics = rng.dirichlet(
        np.full(nt, cfg.board_topic_alpha), size=cfg.n_boards
    ).astype(np.float32)
    n_diverse = int(cfg.diverse_board_frac * cfg.n_boards)
    if n_diverse:
        diverse_idx = rng.choice(cfg.n_boards, size=n_diverse, replace=False)
        board_topics[diverse_idx] = rng.dirichlet(
            np.full(nt, 5.0), size=n_diverse
        ).astype(np.float32)
    pin_topics = rng.dirichlet(
        np.full(nt, cfg.pin_topic_alpha), size=cfg.n_pins
    ).astype(np.float32)

    lp = _lang_probs(cfg)
    board_lang = rng.choice(cfg.n_langs, size=cfg.n_boards, p=lp).astype(np.int32)
    pin_lang = rng.choice(cfg.n_langs, size=cfg.n_pins, p=lp).astype(np.int32)

    ranks = np.arange(1, cfg.n_pins + 1, dtype=np.float64)
    pop = ranks ** (-cfg.popularity_exponent)
    rng.shuffle(pop)
    pin_main_topic = pin_topics.argmax(axis=1)

    sizes = np.clip(
        rng.lognormal(
            mean=np.log(cfg.mean_board_size), sigma=cfg.board_size_sigma,
            size=cfg.n_boards,
        ).astype(np.int64),
        3,
        cfg.n_pins // 2,
    )

    edges_p, edges_b = [], []
    topic_pools = [np.where(pin_main_topic == t)[0] for t in range(nt)]
    pool_probs = []
    for t in range(nt):
        pool = topic_pools[t]
        w = pop[pool]
        pool_probs.append(w / w.sum() if w.size else None)
    all_probs = pop / pop.sum()

    for b in range(cfg.n_boards):
        size = int(sizes[b])
        p_b = board_topics[b].astype(np.float64)
        p_b /= p_b.sum()
        topics = rng.choice(nt, size=size, p=p_b)
        picks = np.empty(size, dtype=np.int64)
        for i, t in enumerate(topics):
            pool = topic_pools[t]
            if pool.size == 0 or rng.random() < cfg.noise_edge_frac:
                picks[i] = rng.choice(cfg.n_pins, p=all_probs)
            else:
                picks[i] = rng.choice(pool, p=pool_probs[t])
        mism = pin_lang[picks] != board_lang[b]
        for i in np.where(mism)[0]:
            if rng.random() < 0.7:
                pool = topic_pools[topics[i]]
                if pool.size:
                    lang_pool = pool[pin_lang[pool] == board_lang[b]]
                    if lang_pool.size:
                        w = pop[lang_pool]
                        picks[i] = rng.choice(lang_pool, p=w / w.sum())
        picks = np.unique(picks)
        edges_p.append(picks)
        edges_b.append(np.full(picks.shape, b, dtype=np.int64))

    pin_ids = np.concatenate(edges_p)
    board_ids = np.concatenate(edges_b)

    n_edges = pin_ids.shape[0]
    n_hold = int(holdout_frac * n_edges)
    hold_idx = rng.choice(n_edges, size=n_hold, replace=False)
    mask = np.ones(n_edges, dtype=bool)
    mask[hold_idx] = False
    heldout_pins = pin_ids[hold_idx].astype(np.int64)
    heldout_boards = board_ids[hold_idx].astype(np.int64)
    pin_ids, board_ids = pin_ids[mask], board_ids[mask]

    # p2b edges sorted by target-board language, b2p by target-pin language
    graph = build_graph(
        torch.as_tensor(pin_ids, device=dev),
        torch.as_tensor(board_ids, device=dev),
        n_pins=cfg.n_pins,
        n_boards=cfg.n_boards,
        edge_feat=torch.as_tensor(board_lang[board_ids], device=dev),
        n_feats=cfg.n_langs,
        edge_feat_b2p=torch.as_tensor(pin_lang[pin_ids], device=dev),
    )
    return SyntheticGraph(
        graph=graph,
        pin_topics=pin_topics,
        board_topics=board_topics,
        pin_lang=pin_lang,
        board_lang=board_lang,
        heldout_pins=heldout_pins,
        heldout_boards=heldout_boards,
    )


def small_test_graph(seed: int = 0, device: DeviceLike = None) -> SyntheticGraph:
    """Tiny but well-connected graph for unit tests."""
    return generate(
        SyntheticGraphConfig(
            n_pins=300, n_boards=80, n_topics=6, n_langs=3,
            mean_board_size=30, popularity_exponent=0.6, seed=seed,
        ),
        device=device,
    )


@dataclasses.dataclass(frozen=True)
class UserHistoryConfig:
    """Knobs of the planted multi-topic user sampler."""

    n_users: int = 16
    n_interests: int = 3        # planted topics per user
    mean_actions: int = 30      # Poisson mean actions per user
    max_age_hours: float = 72.0
    offtopic_frac: float = 0.1  # actions ignoring the planted interests
    seed: int = 0


class UserHistory(NamedTuple):
    """One sampled user: an action history plus its planted ground truth."""

    actions: list              # List[service.UserAction]
    topics: np.ndarray         # (n_interests,) planted interest topic ids
    mixture: np.ndarray        # (n_interests,) interest mixture weights


_ACTION_TYPES = ("save", "click", "like", "view")
_ACTION_PROBS = (0.3, 0.3, 0.2, 0.2)


def sample_user_histories(
    sg: SyntheticGraph, cfg: UserHistoryConfig
) -> List[UserHistory]:
    """Seeded action histories with planted multi-topic users, drawn with
    the reference's numpy calls in the reference's order, so a seed gives
    the reference's histories.

    Each user gets ``n_interests`` distinct planted topics and a Dirichlet
    mixture over them; each action picks a planted topic by the mixture
    (or, with ``offtopic_frac``, any connected pin), then a pin of that
    topic weighted by graph degree.
    """
    from repro_torch.core.service import UserAction

    if cfg.n_interests < 1:
        raise ValueError(f"n_interests must be >= 1, got {cfg.n_interests}")
    rng = np.random.default_rng(cfg.seed)
    nt = sg.pin_topics.shape[1]
    if cfg.n_interests > nt:
        raise ValueError(
            f"n_interests={cfg.n_interests} exceeds the graph's "
            f"{nt} topics"
        )
    pin_main_topic = sg.pin_topics.argmax(axis=1)
    degs = sg.graph.p2b.degrees().cpu().numpy().astype(np.float64)
    pools, pool_probs = [], []
    for t in range(nt):
        pool = np.where((pin_main_topic == t) & (degs > 0))[0]
        pools.append(pool)
        w = degs[pool] if pool.size else None
        pool_probs.append(w / w.sum() if pool.size else None)
    plantable = np.array([t for t in range(nt) if pools[t].size > 0])
    if plantable.size < cfg.n_interests:
        raise ValueError(
            f"only {plantable.size} topics have connected pins; cannot "
            f"plant {cfg.n_interests} interests per user"
        )
    connected = np.where(degs > 0)[0]
    conn_probs = degs[connected] / degs[connected].sum()

    users: List[UserHistory] = []
    for _ in range(cfg.n_users):
        topics = rng.choice(plantable, size=cfg.n_interests, replace=False)
        mixture = rng.dirichlet(np.full(cfg.n_interests, 2.0))
        n_actions = max(cfg.n_interests, int(rng.poisson(cfg.mean_actions)))
        actions = []
        for _ in range(n_actions):
            if rng.random() < cfg.offtopic_frac:
                pin = int(rng.choice(connected, p=conn_probs))
            else:
                t = int(topics[rng.choice(cfg.n_interests, p=mixture)])
                pin = int(rng.choice(pools[t], p=pool_probs[t]))
            kind = str(rng.choice(_ACTION_TYPES, p=_ACTION_PROBS))
            age = float(rng.uniform(0.0, cfg.max_age_hours))
            actions.append(UserAction(pin=pin, action=kind, age_hours=age))
        users.append(UserHistory(
            actions=actions,
            topics=np.asarray(topics, np.int32),
            mixture=mixture.astype(np.float32),
        ))
    return users


def top_degree_pins(sg: SyntheticGraph, k: int = 16) -> np.ndarray:
    """Pins with the highest degree: safe query pins for tests/benchmarks.
    The same numpy argsort as the reference, so ties order alike."""
    degs = sg.graph.p2b.degrees().cpu().numpy()
    return np.argsort(-degs)[:k].astype(np.int32)


def sparse_wide_graph(
    seed: int, n_pins: int, n_boards: int, n_edges: int, hot_pins: int,
    device: DeviceLike = None,
) -> PinBoardGraph:
    """Huge pin-id space, edges concentrated on the hot prefix
    ``[0, hot_pins)``: tiny CSR arrays, production-sized id space."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pins = rng.integers(0, hot_pins, n_edges)
    boards = rng.integers(0, n_boards, n_edges)
    return build_graph(
        torch.as_tensor(pins, device=dev), torch.as_tensor(boards, device=dev),
        n_pins=n_pins, n_boards=n_boards,
    )
