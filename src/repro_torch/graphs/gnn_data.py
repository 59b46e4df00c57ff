"""Synthetic GNN datasets shaped like the gin-tu cells, twin of
``repro/graphs/gnn_data.py``: numpy, the reference's ``default_rng`` draws
call for call, so a seed and scale give the reference's arrays bit for
bit.  Nothing is downloaded.

  * cora_like      — 2,708 nodes / 10,556 edges / 1,433 feats (full_graph_sm)
  * reddit_like    — 232,965 nodes / ~115M edges (minibatch_lg; edges are
    never materialized at full scale on this host — the *sampler* sees a
    degree-faithful CSR; reduced variants materialize fully)
  * products_like  — 2,449,029 nodes / 61,859,140 edges / 100 feats
    (full-batch-large; dry-run only at full scale)
  * molecules      — batches of ~30-node graphs (batched-small-graphs)

All are SBM-style planted-partition graphs: class-pure communities so GIN
training measurably learns (tests assert loss decreases).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class NodeGraph(NamedTuple):
    feats: np.ndarray      # (n, d) f32
    labels: np.ndarray     # (n,) int32
    edge_src: np.ndarray   # (e,) int32
    edge_dst: np.ndarray   # (e,) int32
    train_mask: np.ndarray  # (n,) f32


def planted_partition(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int,
    seed: int = 0,
    p_intra: float = 0.8,
) -> NodeGraph:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    # class-informative features + noise
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + 0.5 * rng.normal(size=(n_nodes, d_feat)).astype(
        np.float32
    )
    # edges: intra-class with prob p_intra else uniform
    src = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    intra = rng.random(n_edges) < p_intra
    # sample intra-class dst by rejection over a candidate pool
    cand = rng.integers(0, n_nodes, (n_edges, 8)).astype(np.int64)
    match = labels[cand] == labels[src][:, None]
    first = np.argmax(match, axis=1)
    has = match[np.arange(n_edges), first]
    dst_intra = cand[np.arange(n_edges), first]
    dst_rand = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    dst = np.where(intra & has, dst_intra, dst_rand)
    train_mask = (rng.random(n_nodes) < 0.5).astype(np.float32)
    return NodeGraph(
        feats=feats,
        labels=labels,
        edge_src=src.astype(np.int32),
        edge_dst=dst.astype(np.int32),
        train_mask=train_mask,
    )


def cora_like(seed: int = 0, scale: float = 1.0) -> NodeGraph:
    n = max(int(2708 * scale), 64)
    e = max(int(10556 * scale), 256)
    d = max(int(1433 * scale), 16)
    return planted_partition(n, e, d, n_classes=7, seed=seed)


def reddit_like(seed: int = 0, scale: float = 1.0) -> NodeGraph:
    n = max(int(232_965 * scale), 256)
    e = max(int(114_615_892 * scale), 1024)
    return planted_partition(n, e, d_feat=602, n_classes=41, seed=seed)


def products_like(seed: int = 0, scale: float = 1.0) -> NodeGraph:
    n = max(int(2_449_029 * scale), 256)
    e = max(int(61_859_140 * scale), 1024)
    return planted_partition(n, e, d_feat=100, n_classes=47, seed=seed)


class MoleculeBatch(NamedTuple):
    feats: np.ndarray       # (total_nodes, d)
    edge_src: np.ndarray    # (total_edges,)
    edge_dst: np.ndarray
    graph_ids: np.ndarray   # (total_nodes,)
    labels: np.ndarray      # (batch,)


def molecule_batch(
    batch: int = 128,
    nodes_per: int = 30,
    edges_per: int = 64,
    d_feat: int = 16,
    n_classes: int = 2,
    seed: int = 0,
) -> MoleculeBatch:
    """Batched small graphs, flat layout with graph_ids readout."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, batch).astype(np.int32)
    feats, es, ed, gid = [], [], [], []
    for g in range(batch):
        base = g * nodes_per
        # label-dependent motif: class 1 graphs are rings, class 0 stars
        f = rng.normal(size=(nodes_per, d_feat)).astype(np.float32)
        f[:, 0] += labels[g] * 1.5
        feats.append(f)
        if labels[g] == 1:
            s = np.arange(nodes_per)
            d_ = (s + 1) % nodes_per
        else:
            s = np.zeros(nodes_per, np.int64)
            d_ = np.arange(nodes_per)
        extra = rng.integers(0, nodes_per, (2, edges_per - nodes_per))
        es.append(np.concatenate([s, extra[0]]) + base)
        ed.append(np.concatenate([d_, extra[1]]) + base)
        gid.append(np.full(nodes_per, g, np.int32))
    return MoleculeBatch(
        feats=np.concatenate(feats),
        edge_src=np.concatenate(es).astype(np.int32),
        edge_dst=np.concatenate(ed).astype(np.int32),
        graph_ids=np.concatenate(gid),
        labels=labels,
    )
