"""GIN (Graph Isomorphism Network) by segment-sum message passing.

Twin of ``repro/models/gnn.py`` (arXiv:1810.00826 GIN; sum aggregator,
learnable eps):

    h_v' = MLP((1 + eps) * h_v + sum_{u in N(v)} h_u)

One forward covers the reference's three input regimes: a full graph
(``(n_nodes, d)`` features and an edge list), a sampled block from
``graphs/sampler.py`` (pad edges aim at segment ``n_nodes`` and are
dropped), and a batch of small graphs with a ``graph_ids`` sum readout.
The same ``GINConfig``, the same parameter tree (``layers`` stacked on
axis 0, ``eps`` one scalar a layer) and the losses' forward values.

``segment_sum`` adds each segment's rows in index order, one add at a
time, as XLA's sequential scatter on the CPU adds them: the rows are
sorted stably by segment, each row gets its rank within its segment, and
the sum is a chain over ranks (``out + rows of rank r``, padded ranks
reading a zero row), so the result is the same bits on every run and on
every device, with no atomics (``index_add_`` on the card adds in another
order each run).  The chain's depth is the largest segment, read once
from the device.  ``edge_src`` is read as ``jnp.take`` reads it
(``embedding.take_rows``); ``segment_ids`` outside ``[0, n)`` are dropped,
as ``jax.ops.segment_sum`` drops them.  The layers run as a Python loop
where the reference scans.

``edge_fabric`` (a ``core.distributed`` fabric; the dry run's GIN cells
pass the process group of every mesh axis) splits the edges over its
ranks, as the reference's cells shard the edge axis: each rank passes
its own edges, aggregates them, and the partial sums are added over the
ranks (``reduce_from``; the node states read by the edges ``copy_to`` the
fabric, so autograd all-reduces their gradient).

Under a dry run (fake tensors, ``repro_torch/abstract.py``) ``segment_sum`` cannot
read its depth: it is charged as one ``index_add`` of the rows into the
segments, the traffic a segmented sum must move (each row and id read
once, each touched segment read and written); the port's chain adds
``depth - 1`` passes over the segments that the dry run does not count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import abstract
from repro_torch.core.distributed import copy_to, reduce_from
from repro_torch.models import layers
from repro_torch.models.embedding import take_rows


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 1433
    n_classes: int = 7
    train_eps: bool = True
    readout: Optional[str] = None  # None (node-level) | 'sum' (graph-level)
    compute_dtype: Any = torch.float32
    unroll_layers: bool = False    # a TPU compile knob, accepted and ignored

    def param_count(self) -> int:
        mlp = 2 * self.d_hidden * self.d_hidden + 2 * self.d_hidden
        enc = self.d_in * self.d_hidden + self.d_hidden
        head = self.d_hidden * self.n_classes + self.n_classes
        return enc + self.n_layers * (mlp + 1) + head


def init_params(gen: torch.Generator, cfg: GINConfig) -> Dict[str, Any]:
    """Seeded float32 parameters on the generator's device, in the
    reference's tree; biases and eps start at zero, as there."""
    dev = gen.device
    d, n = cfg.d_hidden, cfg.n_layers
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return {
        "encoder": {"w": layers.dense_init(gen, (cfg.d_in, d), device=dev),
                    "b": zeros(d)},
        "layers": {"w1": layers.dense_stack(gen, n, (d, d)), "b1": zeros(n, d),
                   "w2": layers.dense_stack(gen, n, (d, d)), "b2": zeros(n, d),
                   "eps": zeros(n)},
        "head": {"w": layers.dense_init(gen, (d, cfg.n_classes), device=dev),
                 "b": zeros(cfg.n_classes)},
    }


def abstract_params(cfg: GINConfig) -> Dict[str, Any]:
    """``init_params``' tree as meta tensors (the dry run; no allocation)."""
    return abstract.abstract_of(lambda: init_params(torch.Generator(), cfg))


def param_logical(cfg: GINConfig) -> Dict[str, Any]:
    return {
        "encoder": {"w": ("feat", "hidden"), "b": ("hidden",)},
        "layers": {
            "w1": ("layers", "hidden", "hidden"),
            "b1": ("layers", "hidden"),
            "w2": ("layers", "hidden", "hidden"),
            "b2": ("layers", "hidden"),
            "eps": ("layers",),
        },
        "head": {"w": ("hidden", None), "b": (None,)},
    }


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, segment_ids, num_segments)``: each
    segment's rows added in index order; ids outside ``[0, num_segments)``
    dropped.  Deterministic (see the module docstring)."""
    n_rows = data.shape[0]
    dev = data.device
    ids = segment_ids.long()
    if abstract.is_fake(data):
        # the dry run's static form (see the module docstring)
        keep = (ids >= 0) & (ids < num_segments)
        out = data.new_zeros((num_segments + 1,) + data.shape[1:])
        return out.index_add(0, torch.where(keep, ids, num_segments), data)[:-1]
    valid = (ids >= 0) & (ids < num_segments)
    ids = torch.where(valid, ids, num_segments)     # dropped rows sort last
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    rank = torch.arange(n_rows, device=dev) - torch.searchsorted(sid, sid)
    keep = valid[order]
    sid, rank, order = sid[keep], rank[keep], order[keep]
    depth = int(rank.max()) + 1 if rank.numel() else 0
    # table[s, r]: the row of segment s's r-th member; n_rows is a zero row
    table = torch.full((num_segments, depth), n_rows, dtype=torch.long, device=dev)
    table[sid, rank] = order
    rows = torch.cat([data, data.new_zeros((1,) + data.shape[1:])])
    out = data.new_zeros((num_segments,) + data.shape[1:])
    for r in range(depth):
        out = out + rows[table[:, r]]
    return out


def forward(
    params: Dict[str, Any],
    feats: torch.Tensor,        # (n_nodes, d_in)
    edge_src: torch.Tensor,     # (n_edges,) int32
    edge_dst: torch.Tensor,     # (n_edges,) int32
    cfg: GINConfig,
    graph_ids: Optional[torch.Tensor] = None,   # (n_nodes,) for batched readout
    n_graphs: int = 0,
    edge_fabric=None,
) -> torch.Tensor:
    """Returns (n_nodes, n_classes) node logits, or (n_graphs, n_classes);
    with ``edge_fabric`` the edges are this rank's (module docstring)."""
    cd = cfg.compute_dtype
    n_nodes = feats.shape[0]
    enc, lp = params["encoder"], params["layers"]
    h = feats.to(cd) @ enc["w"].to(cd)
    h = torch.relu(h + enc["b"].to(cd))
    for i in range(lp["w1"].shape[0]):
        if edge_fabric is None:
            agg = segment_sum(take_rows(h, edge_src), edge_dst, n_nodes)
        else:
            msgs = take_rows(copy_to(edge_fabric, h), edge_src)
            agg = reduce_from(edge_fabric, segment_sum(msgs, edge_dst, n_nodes)[None])
        z = (1.0 + lp["eps"][i]).to(cd) * h + agg
        z = torch.relu(z @ lp["w1"][i].to(cd) + lp["b1"][i].to(cd))
        z = z @ lp["w2"][i].to(cd) + lp["b2"][i].to(cd)
        h = torch.relu(z)
    if cfg.readout == "sum" and graph_ids is not None:
        h = segment_sum(h, graph_ids, n_graphs)
    head = params["head"]
    return (h @ head["w"].to(cd) + head["b"].to(cd)).float()


def node_classification_loss(
    params: Dict[str, Any],
    feats: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    labels: torch.Tensor,       # (n_nodes,) int32
    mask: torch.Tensor,         # (n_nodes,) — train mask / target-node mask
    cfg: GINConfig,
    edge_fabric=None,
) -> torch.Tensor:
    logits = forward(params, feats, edge_src, edge_dst, cfg, edge_fabric=edge_fabric)
    return layers.cross_entropy_logits(logits, labels, mask.float())


def graph_classification_loss(
    params: Dict[str, Any],
    feats: torch.Tensor,
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    graph_ids: torch.Tensor,
    labels: torch.Tensor,       # (n_graphs,)
    cfg: GINConfig,
    n_graphs: int,
    edge_fabric=None,
) -> torch.Tensor:
    logits = forward(params, feats, edge_src, edge_dst, cfg,
                     graph_ids=graph_ids, n_graphs=n_graphs, edge_fabric=edge_fabric)
    mask = torch.ones((n_graphs,), dtype=torch.float32, device=logits.device)
    return layers.cross_entropy_logits(logits, labels, mask)
