"""Fanout neighbor sampler for minibatch GNN training (GraphSAGE-style),
twin of ``repro/graphs/sampler.py``: host-side numpy by design, with the
reference's draws, so a ``(seed, step)`` gives the reference's block bit
for bit.

`minibatch_lg` (Reddit-scale: 233k nodes / 115M edges, batch 1024, fanout
15-10) cannot train full-batch; the sampler draws a fixed-fanout L-hop
neighborhood around each seed batch and emits a *fixed-shape* subgraph
(padded) so a compiled train step never sees a new shape.

The sampler is host-side numpy over the same CSR layout as the Pixie graph
(core/graph.py): random neighbor access on CSR is exactly Pixie's Eq. 4
access pattern, which is why this module shares that substrate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np


class CSRGraph(NamedTuple):
    """Host CSR adjacency for sampling: neighbors of i in
    targets[offsets[i]:offsets[i+1]]."""

    offsets: np.ndarray   # (n_nodes + 1,) int64
    targets: np.ndarray   # (n_edges,) int32


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=n_nodes)
    offsets = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return CSRGraph(offsets=offsets, targets=dst[order].astype(np.int32))


class SampledBlock(NamedTuple):
    """One fixed-shape sampled subgraph.

    nodes:    (max_nodes,) int32 global node ids (-1 pad); seeds first.
    edge_src: (max_edges,) int32 *local* indices into nodes (-1 pad).
    edge_dst: (max_edges,) int32 local indices (-1 pad).
    n_seeds:  int — first n_seeds entries of `nodes` are the loss targets.
    """

    nodes: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    n_seeds: int


@dataclasses.dataclass(frozen=True)
class FanoutSampler:
    graph: CSRGraph
    fanouts: Tuple[int, ...] = (15, 10)
    seed: int = 0

    def max_nodes(self, batch: int) -> int:
        n = batch
        total = batch
        for f in self.fanouts:
            n = n * f
            total += n
        return total

    def max_edges(self, batch: int) -> int:
        n = batch
        total = 0
        for f in self.fanouts:
            total += n * f
            n = n * f
        return total

    def sample(self, seeds: np.ndarray, step: int) -> SampledBlock:
        """L-hop fixed-fanout expansion. Deterministic in (seed, step)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        off, tgt = self.graph.offsets, self.graph.targets
        batch = seeds.shape[0]
        max_n = self.max_nodes(batch)
        max_e = self.max_edges(batch)

        node_of: Dict[int, int] = {}
        nodes = np.full(max_n, -1, np.int32)
        for i, s in enumerate(seeds):
            node_of[int(s)] = i
            nodes[i] = s
        n_nodes = batch

        es, ed = [], []
        frontier = list(int(s) for s in seeds)
        for f in self.fanouts:
            nxt = []
            for u in frontier:
                lo, hi = off[u], off[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                picks = tgt[lo + rng.integers(0, deg, size=min(f, deg))]
                for v in picks:
                    v = int(v)
                    if v not in node_of:
                        if n_nodes >= max_n:
                            continue
                        node_of[v] = n_nodes
                        nodes[n_nodes] = v
                        n_nodes += 1
                        nxt.append(v)
                    # message flows neighbor -> frontier node
                    es.append(node_of[v])
                    ed.append(node_of[u])
            frontier = nxt

        edge_src = np.full(max_e, -1, np.int32)
        edge_dst = np.full(max_e, -1, np.int32)
        k = min(len(es), max_e)
        edge_src[:k] = es[:k]
        edge_dst[:k] = ed[:k]
        return SampledBlock(
            nodes=nodes, edge_src=edge_src, edge_dst=edge_dst, n_seeds=batch
        )


def block_to_arrays(
    block: SampledBlock,
    feats: np.ndarray,
    labels: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Materialize padded features/labels/mask for the train step.

    Padding nodes get zero features and mask 0; padding edges self-loop on
    node 0 with (segment ids clipped) zero contribution via masking inside
    the model (edge -1 -> 0 with zero message is avoided by mapping pad
    edges to an unused slot: here we clip and rely on pad-node zero feats).
    """
    n = block.nodes.shape[0]
    valid = block.nodes >= 0
    safe = np.where(valid, block.nodes, 0)
    x = feats[safe] * valid[:, None]
    y = labels[safe] * valid
    mask = np.zeros(n, np.float32)
    mask[: block.n_seeds] = 1.0
    e_valid = block.edge_src >= 0
    return {
        "feats": x.astype(np.float32),
        "labels": y.astype(np.int32),
        "mask": mask,
        "edge_src": np.where(e_valid, block.edge_src, 0).astype(np.int32),
        # pad edges scatter to an out-of-range segment -> dropped
        "edge_dst": np.where(e_valid, block.edge_dst, n).astype(np.int32),
    }
