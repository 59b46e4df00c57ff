"""Bipartite pin-board graph in contiguous CSR ("edgeVec") form, in torch.

Twin of ``repro/core/graph.py``: pins own ids ``[0, n_pins)``, boards
``[n_pins, n_pins + n_boards)``; each direction is one ``CSR`` whose
neighbours of node ``i`` are ``targets[offsets[i]:offsets[i+1]]``, sorted
within the slice by a small edge feature with per-node relative subrange
bounds (``feat_bounds``) for the personalized walk.  Every array is an
int32 tensor; the graph lives on one device and is the port's equivalent
of model weights.

``build_graph`` is the graph compiler: it runs on whatever device its
input tensors are on, so the production-sized graph is compiled on the
card.  ``load_graph`` reads the reference's own ``save_graph`` format
(``graph.npz`` + ``meta.json``) and ``graph_from_numpy`` carries the
reference graph's arrays across.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import abstract
from repro_torch.device import DeviceLike, resolve_device

_ARRAY_NAMES = (
    "p2b_offsets", "p2b_targets", "b2p_offsets", "b2p_targets",
    "p2b_feat_bounds", "b2p_feat_bounds",
)


@dataclasses.dataclass(frozen=True)
class CSR:
    """One direction of the bipartite adjacency in edgeVec form.

    offsets:     (n_src + 1,) int32 prefix sums of degrees.
    targets:     (n_edges,) int32 neighbour ids.
    feat_bounds: optional (n_src, n_feats + 1) int32 per-node boundaries of
                 the feature-sorted sublists, relative to the node's slice.
    """

    offsets: torch.Tensor
    targets: torch.Tensor
    feat_bounds: Optional[torch.Tensor] = None

    @property
    def n_src(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.targets.shape[0]

    @property
    def n_feats(self) -> int:
        return 0 if self.feat_bounds is None else self.feat_bounds.shape[1] - 1

    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def degree(self, node: torch.Tensor) -> torch.Tensor:
        node = node.long()
        return self.offsets[node + 1] - self.offsets[node]

    def to(self, device: DeviceLike) -> "CSR":
        return CSR(*(None if a is None else a.to(device) for a in
                     (self.offsets, self.targets, self.feat_bounds)))


@dataclasses.dataclass(frozen=True)
class PinBoardGraph:
    """The full bipartite graph: ``p2b`` maps pin id -> global board ids,
    ``b2p`` maps local board index (board id - n_pins) -> pin ids."""

    p2b: CSR
    b2p: CSR
    n_pins: int
    n_boards: int
    max_pin_degree: int

    @property
    def device(self) -> torch.device:
        return self.p2b.offsets.device

    @property
    def n_edges(self) -> int:
        return self.p2b.n_edges

    def pin_degree(self, pin: torch.Tensor) -> torch.Tensor:
        return self.p2b.degree(pin)

    def nbytes(self) -> int:
        total = 0
        for csr in (self.p2b, self.b2p):
            for a in (csr.offsets, csr.targets, csr.feat_bounds):
                if a is not None:
                    total += a.numel() * a.element_size()
        return int(total)

    def to(self, device: DeviceLike) -> "PinBoardGraph":
        return dataclasses.replace(
            self, p2b=self.p2b.to(device), b2p=self.b2p.to(device)
        )


# ---------------------------------------------------------------------------
# Graph compiler (runs on the device of its inputs)
# ---------------------------------------------------------------------------


# edges per pass of the graph compiler's counting sort
BUILD_CHUNK = 2**24


def _build_csr(
    src: torch.Tensor,
    dst: torch.Tensor,
    n_src: int,
    edge_feat: Optional[torch.Tensor],
    n_feats: int,
    dst_base: int = 0,
) -> CSR:
    """Group edges by (src, feat), stably, and emit edgeVec CSR + bounds.

    A stable counting sort, the reference's ``np.lexsort((feat, src))``:
    one pass counts each ``src * n_feats + feat`` key, a prefix sum places
    each key's group, and a second pass moves every edge to its group's
    next free slot in input order (within one pass a stable sort of the
    pass's keys ranks the edges that share a key).  Only the per-key
    counts and the output are as large as the key space and the edge
    list; no pass holds more than ``BUILD_CHUNK`` edges' keys and order,
    which keeps a billion-edge build inside the card.
    """
    dev = src.device
    n_edges = src.shape[0]
    chunk = BUILD_CHUNK
    n_keys = n_src * max(n_feats, 1)
    key_dtype = torch.int32 if n_keys < 2**31 else torch.int64
    spans = [(e0, min(e0 + chunk, n_edges)) for e0 in range(0, n_edges, chunk)]

    def keys(e0, e1):
        k = src[e0:e1].to(key_dtype)
        return k if edge_feat is None else k * n_feats + edge_feat[e0:e1].to(key_dtype)

    counts = torch.zeros(n_keys + 1, dtype=torch.int32, device=dev)
    for e0, e1 in spans:
        k = keys(e0, e1)
        counts.index_add_(0, k + 1, torch.ones_like(k, dtype=torch.int32))
    pos = torch.cumsum(counts, 0, dtype=torch.int32)   # first slot of each key
    del counts
    cursor = pos[:-1].clone()
    targets = torch.empty(n_edges, dtype=torch.int32, device=dev)
    for e0, e1 in spans:
        sk, order = torch.sort(keys(e0, e1), stable=True)
        # an edge's rank among this pass's edges of its key
        rank = torch.arange(sk.shape[0], device=dev) - torch.searchsorted(sk, sk)
        slot = cursor[sk].long() + rank
        targets[slot] = dst[e0:e1][order].to(torch.int32) + dst_base
        cursor.index_add_(0, sk, torch.ones_like(sk, dtype=torch.int32))
        del sk, order, rank, slot
    del cursor
    if edge_feat is None:
        return CSR(offsets=pos, targets=targets)
    offsets = pos[::n_feats].contiguous()
    starts = pos[:-1].view(n_src, n_feats)
    feat_bounds = torch.empty((n_src, n_feats + 1), dtype=torch.int32, device=dev)
    torch.sub(starts, starts[:, :1], out=feat_bounds[:, :n_feats])
    torch.sub(offsets[1:], offsets[:-1], out=feat_bounds[:, n_feats])
    return CSR(offsets=offsets, targets=targets, feat_bounds=feat_bounds)


def _as_ids(x, device: Optional[torch.device] = None) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    if t.is_floating_point() or t.dtype == torch.bool:
        raise TypeError(f"ids must be integers, got {t.dtype}")
    return t


def _check_range(name: str, x: torch.Tensor, hi: int) -> None:
    if x.numel() and (int(x.min()) < 0 or int(x.max()) >= hi):
        raise ValueError(f"{name} must lie in [0, {hi})")


def build_graph(
    pin_ids,
    board_ids,
    n_pins: int,
    n_boards: int,
    edge_feat=None,
    n_feats: int = 0,
    edge_feat_b2p=None,
) -> PinBoardGraph:
    """Compile an edge list (pin id, board id in [0, n_boards)) to CSR.

    Runs on the device of ``pin_ids`` (numpy inputs become CPU tensors).
    ``edge_feat`` is an optional small per-edge categorical used to sort
    the pin->board direction (the personalized subrange); ``edge_feat_b2p``
    (default: the same) sorts the board->pin direction.  Id and feature
    tensors may have any integer dtype; narrow ones keep the build small.
    """
    pins = _as_ids(pin_ids)
    boards = _as_ids(board_ids, pins.device)
    if pins.shape != boards.shape:
        raise ValueError("pin_ids and board_ids must align")
    _check_range("pin_ids", pins, n_pins)
    _check_range("board_ids", boards, n_boards)
    if edge_feat is not None:
        edge_feat = _as_ids(edge_feat, pins.device)
        if n_feats <= 0:
            n_feats = int(edge_feat.max()) + 1 if edge_feat.numel() else 1
        _check_range("edge_feat", edge_feat, n_feats)
    if edge_feat_b2p is None:
        edge_feat_b2p = edge_feat
    else:
        edge_feat_b2p = _as_ids(edge_feat_b2p, pins.device)
        _check_range("edge_feat_b2p", edge_feat_b2p, n_feats)
    if (n_pins + n_boards) >= 2**31 or pins.numel() >= 2**31:
        raise ValueError("int32 CSR needs node ids and edge counts below 2**31")

    p2b = _build_csr(pins, boards, n_pins, edge_feat, n_feats, dst_base=n_pins)
    b2p = _build_csr(boards, pins, n_boards, edge_feat_b2p, n_feats)
    degs = p2b.degrees()
    max_deg = int(degs.max()) if degs.numel() else 0
    return PinBoardGraph(
        p2b=p2b, b2p=b2p, n_pins=int(n_pins), n_boards=int(n_boards),
        max_pin_degree=max_deg,
    )


def edge_list(graph: PinBoardGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Recover the (pin, local board) edge list from CSR (host-side)."""
    offsets = graph.p2b.offsets.cpu().numpy()
    targets = graph.p2b.targets.cpu().numpy()
    pins = np.repeat(np.arange(graph.n_pins, dtype=np.int64), np.diff(offsets))
    boards = targets.astype(np.int64) - graph.n_pins
    return pins, boards


# ---------------------------------------------------------------------------
# Persistence: the reference's binary format, read and written as is
# ---------------------------------------------------------------------------


def graph_to_numpy(graph: PinBoardGraph) -> Dict[str, np.ndarray]:
    """The graph's arrays under the reference's ``graph.npz`` names."""
    arrays = {
        "p2b_offsets": graph.p2b.offsets, "p2b_targets": graph.p2b.targets,
        "b2p_offsets": graph.b2p.offsets, "b2p_targets": graph.b2p.targets,
        "p2b_feat_bounds": graph.p2b.feat_bounds,
        "b2p_feat_bounds": graph.b2p.feat_bounds,
    }
    return {k: v.cpu().numpy() for k, v in arrays.items() if v is not None}


def graph_from_numpy(
    arrays: Dict[str, np.ndarray],
    n_pins: int,
    n_boards: int,
    max_pin_degree: int,
    device: DeviceLike = None,
) -> PinBoardGraph:
    """The port's graph from the reference graph's arrays as numpy.

    ``arrays`` uses the ``graph.npz`` names (``p2b_offsets`` ...; the two
    ``*_feat_bounds`` together or not at all).  Arrays are copied to int32
    tensors on ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    has_p, has_b = "p2b_feat_bounds" in arrays, "b2p_feat_bounds" in arrays
    if has_p != has_b:
        raise ValueError("feat bounds must be given for both CSR sides or neither")

    def t(name):
        a = np.asarray(arrays[name])
        if a.size and (a.min() < np.iinfo(np.int32).min
                       or a.max() > np.iinfo(np.int32).max):
            raise ValueError(f"{name} does not fit int32")
        return torch.as_tensor(a.astype(np.int32), device=dev)

    def csr(side):
        fb = t(f"{side}_feat_bounds") if has_p else None
        return CSR(t(f"{side}_offsets"), t(f"{side}_targets"), fb)

    return PinBoardGraph(
        p2b=csr("p2b"), b2p=csr("b2p"), n_pins=int(n_pins),
        n_boards=int(n_boards), max_pin_degree=int(max_pin_degree),
    )


def graph_abstract(
    n_pins: int,
    n_boards: int,
    n_edges: int,
    n_feats: int = 0,
    offset_dtype=torch.int64,
    target_dtype=torch.int32,
) -> PinBoardGraph:
    """Meta-tensor stand-in graph for the dry run: production scale (3e9
    nodes / 17e9 edges) never materialises.  Board adjacency reuses the
    same edge count (each edge appears once per direction)."""
    fb = fb_b = None
    if n_feats > 0:
        fb = abstract.meta((n_pins, n_feats + 1), torch.int32)
        fb_b = abstract.meta((n_boards, n_feats + 1), torch.int32)
    p2b = CSR(offsets=abstract.meta((n_pins + 1,), offset_dtype),
              targets=abstract.meta((n_edges,), target_dtype), feat_bounds=fb)
    b2p = CSR(offsets=abstract.meta((n_boards + 1,), offset_dtype),
              targets=abstract.meta((n_edges,), target_dtype), feat_bounds=fb_b)
    return PinBoardGraph(p2b=p2b, b2p=b2p, n_pins=n_pins, n_boards=n_boards,
                         max_pin_degree=4096)


def save_graph(graph: PinBoardGraph, path: str) -> None:
    """Write ``graph.npz`` + ``meta.json`` exactly as the reference does."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "graph.npz"), **graph_to_numpy(graph))
    meta = {
        "n_pins": graph.n_pins,
        "n_boards": graph.n_boards,
        "max_pin_degree": graph.max_pin_degree,
        "has_feats": graph.p2b.feat_bounds is not None,
    }
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, "meta.json"))


def load_graph(path: str, device: DeviceLike = None) -> PinBoardGraph:
    """Read a graph written by either package's ``save_graph``."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "graph.npz")) as data:
        names = [n for n in _ARRAY_NAMES
                 if meta["has_feats"] or "feat_bounds" not in n]
        arrays = {n: data[n] for n in names}
    return graph_from_numpy(
        arrays, meta["n_pins"], meta["n_boards"], meta["max_pin_degree"],
        device=device,
    )
