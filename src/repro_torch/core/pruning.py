"""Graph pruning (paper §3.2), twin of ``repro/core/pruning.py``: board
entropy pruning, then degree pruning by cosine similarity.

1. **Board entropy pruning**: each board's topic distribution is the mean
   of its pins' topic vectors; the ``entropy_board_frac`` most diverse
   boards are dropped with all their edges.
2. **Degree pruning**: a pin of degree d keeps the ``ceil(d**delta)``
   edges (at least ``min(d, min_keep)``) whose boards' topic vectors are
   most cosine-similar to its own.

Everything runs on the device of the graph, in passes of bounded size,
so the production graph (1.2B edges) prunes on one card: no pass gathers
topic rows for more than ``CHUNK_EDGES`` edges at a time.

Which edges survive is decided by float comparisons, so the port keeps
the reference's numpy arithmetic bit for bit:

  * a board's topic sum adds its pins' float64 rows in the reference's
    ``np.add.at`` order: the order of ``edge_list``, which within one
    board is increasing pin order.  The board->pin CSR holds each board's
    pins (in another order), so each board's pins are sorted and then
    added rank by rank in a chain, one pass per rank up to the largest
    board degree;
  * numpy sums the last axis of a row pairwise (``_np_sum``: eight
    partial sums, then a fixed tree), not left to right; the norms, the
    dot, ``dist.sum`` and the entropy sum follow that order;
  * a float32 ``sqrt`` is taken in float64 and rounded, which is the
    correctly rounded ``np.sqrt``;
  * the kept-edge order is ``np.lexsort((-sim, pins))``: a stable sort by
    pin, then by similarity descending;
  * ``ceil(d**delta)`` comes from a table of every degree computed by
    numpy's own ``**`` on the host, so no ``pow`` of another library
    decides a boundary.

One rule differs by design: boards that tie at the entropy cut are
dropped lowest index first (a stable sort), where the reference's
``np.argsort(-ent)`` leaves the choice to numpy's unstable sort.  The
entropy's float64 ``log`` is torch's; it may differ from numpy's in the
last bit, which the tests measure.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.graph import PinBoardGraph, build_graph

# edges per pass of the per-edge work (two gathered float32 topic blocks
# of 16 columns are 2 GB at this size)
CHUNK_EDGES = 2**24


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    entropy_board_frac: float = 0.10   # drop this fraction of highest-entropy boards
    delta: float = 0.91                # degree pruning factor (Fig. 4 peak)
    min_keep: int = 2                  # never prune a pin below this degree


def _pairwise(cols: List[torch.Tensor]) -> torch.Tensor:
    """numpy's ``pairwise_sum`` over a list of equal-shape columns."""
    n = len(cols)
    if n < 8:
        res = torch.zeros_like(cols[0])
        for c in cols:
            res = res + c
        return res
    if n <= 128:
        r = list(cols[:8])
        i = 8
        while i < n - n % 8:
            r = [r[j] + cols[i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for c in cols[i:]:
            res = res + c
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(cols[:n2]) + _pairwise(cols[n2:])


def _np_sum(x: torch.Tensor) -> torch.Tensor:
    """``np.sum(x, axis=-1)`` with numpy's summation order."""
    return _pairwise([x[..., j] for j in range(x.shape[-1])])


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``sqrt`` (float64 root, rounded once)."""
    return torch.sqrt(x.double()).float()


def _to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    return t if dtype is None else t.to(dtype)


def cosine_sim(a, b, eps: float = 1e-12) -> torch.Tensor:
    """Cosine similarity of float32 rows over the last axis, numpy's bits."""
    a = torch.as_tensor(a)
    b = _to_device(b, a.device)
    na = _sqrt_f32(_np_sum(a * a))
    nb = _sqrt_f32(_np_sum(b * b))
    den = torch.maximum(na * nb, torch.tensor(eps, dtype=na.dtype, device=na.device))
    return _np_sum(a * b) / den


def _board_sums(seg_pins: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, pin_topics: torch.Tensor) -> torch.Tensor:
    """float64 ``(n, n_topics)`` sums of each segment's topic rows, added
    in segment order: segment i is ``seg_pins[starts[i]:starts[i] +
    counts[i]]``.  One pass per rank; segments are visited longest first
    so each pass touches only the segments that still have a row."""
    n, nt = counts.shape[0], pin_topics.shape[1]
    dev = pin_topics.device
    by_len = torch.sort(counts, descending=True, stable=True).indices
    hist = torch.bincount(counts.long()).cpu().numpy() if n else np.zeros(1, np.int64)
    alive = n - np.cumsum(hist)          # alive[r]: segments longer than r
    sums = torch.zeros((n, nt), dtype=torch.float64, device=dev)
    first = starts.long()[by_len]
    for r in range(hist.shape[0] - 1):
        k = int(alive[r])
        rows = pin_topics[seg_pins[first[:k] + r].long()].double()
        sums[:k] += rows
    out = torch.empty_like(sums)
    out[by_len] = sums
    return out


def _entropy(sums: torch.Tensor, counts: torch.Tensor, eps: float):
    """Entropy of each board's mean topic vector, float32; and that mean."""
    cnt = torch.clamp(counts.double(), min=1.0)[:, None]
    mean = sums / cnt
    dist = mean / torch.clamp(_np_sum(mean), min=eps)[:, None]
    ent = -_np_sum(dist * torch.log(torch.clamp(dist, min=eps)))
    ent = torch.where(counts == 0, 0.0, ent)
    return ent.float(), mean


def board_entropy(pins, boards, pin_topics, n_boards: int,
                  eps: float = 1e-12) -> torch.Tensor:
    """Entropy of each board's aggregated topic distribution (§3.2).

    ``pins`` and ``boards`` are an edge list; each board's rows are summed
    in the list's order, as ``np.add.at`` sums them.  Runs on the device of
    ``pin_topics`` (numpy inputs: the CPU).
    """
    pin_topics = torch.as_tensor(pin_topics)
    dev = pin_topics.device
    pins = _to_device(pins, dev, torch.int64)
    boards = _to_device(boards, dev, torch.int64)
    order = torch.sort(boards, stable=True).indices
    counts = torch.bincount(boards, minlength=n_boards)
    starts = torch.cumsum(counts, 0) - counts
    sums = _board_sums(pins[order], starts, counts, pin_topics)
    return _entropy(sums, counts, eps)[0]


def _chunks(offsets: torch.Tensor, n_rows: int, chunk_edges: int):
    """Row ranges ``(r0, r1, e0, e1)`` of a CSR, each at most about
    ``chunk_edges`` edges (a row longer than that is one range)."""
    n_edges = int(offsets[-1])
    marks = torch.arange(0, n_edges, chunk_edges, dtype=offsets.dtype,
                         device=offsets.device)
    cuts = torch.searchsorted(offsets, marks, right=True) - 1
    rows = sorted(set(cuts.cpu().tolist()) | {0, n_rows})
    offs = offsets[torch.as_tensor(rows, device=offsets.device)].cpu().tolist()
    for i in range(len(rows) - 1):
        yield rows[i], rows[i + 1], int(offs[i]), int(offs[i + 1])


def _segment_ids(degrees: torch.Tensor, base: int) -> torch.Tensor:
    """``base + i`` repeated ``degrees[i]`` times (int64)."""
    ids = torch.arange(base, base + degrees.shape[0], device=degrees.device)
    return torch.repeat_interleave(ids, degrees.long())


def _entropy_pass(graph: PinBoardGraph, pin_topics: torch.Tensor,
                  want_topics: bool):
    """Every board's entropy (and, if asked, its mean topic vector as
    float32) from the board->pin CSR, board range by board range."""
    dev = graph.device
    b2p = graph.b2p
    ent = torch.empty(graph.n_boards, dtype=torch.float32, device=dev)
    topics = (torch.empty((graph.n_boards, pin_topics.shape[1]),
                          dtype=torch.float32, device=dev)
              if want_topics else None)
    for b0, b1, e0, e1 in _chunks(b2p.offsets, graph.n_boards, CHUNK_EDGES):
        deg = b2p.offsets[b0 + 1:b1 + 1] - b2p.offsets[b0:b1]
        local = _segment_ids(deg, 0)
        # sort each board's pins ascending: the order of edge_list
        key = local * graph.n_pins + b2p.targets[e0:e1].long()
        key = torch.sort(key).values
        seg_pins = key - local * graph.n_pins
        del key
        starts = b2p.offsets[b0:b1].long() - e0
        sums = _board_sums(seg_pins, starts, deg, pin_topics)
        del seg_pins, local
        ent[b0:b1], mean = _entropy(sums, deg, 1e-12)
        if want_topics:
            topics[b0:b1] = mean.float()
        del sums, mean
    return ent, topics


def degree_targets(max_degree: int, delta: float, min_keep: int) -> np.ndarray:
    """``max(ceil(d**delta), min(d, min_keep))`` for d in ``[0,
    max_degree]``, int64, by numpy's float64 ``**`` as the reference
    computes it."""
    deg = np.arange(max_degree + 1, dtype=np.int64)
    return np.maximum(
        np.ceil(deg.astype(np.float64) ** delta).astype(np.int64),
        np.minimum(deg, min_keep),
    )


def _descending_key(sim: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) that orders float32 ``sim`` descending, with
    -0.0 equal to 0.0 (as numpy compares them)."""
    bits = (sim + 0.0).view(torch.int32)
    asc = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (~asc).long() + 2**31


def prune_graph(
    graph: PinBoardGraph,
    pin_topics,
    board_topics,
    cfg: PruneConfig,
    board_lang=None,
    pin_lang=None,
    n_langs: int = 0,
) -> Tuple[PinBoardGraph, dict]:
    """Apply both pruning stages on the graph's device; returns (pruned
    graph, stats), the stats under the reference's keys.

    ``pin_topics`` ``(n_pins, n_topics)`` float32, ``board_topics``
    (optional, else recomputed from the edges that survive stage 1) and
    the language arrays may be numpy arrays or tensors; they are moved to
    the graph's device.
    """
    dev = graph.device
    n_pins, n_boards = graph.n_pins, graph.n_boards
    pin_topics = _to_device(pin_topics, dev, torch.float32)
    stats: dict = {"edges_before": graph.n_edges}

    # -- stage 1: entropy-based board removal --------------------------------
    ent, mean_topics = _entropy_pass(graph, pin_topics, board_topics is None)
    n_drop = int(cfg.entropy_board_frac * n_boards)
    keep_board = None
    if n_drop > 0:
        drop = torch.sort(ent + 0.0, descending=True, stable=True).indices[:n_drop]
        keep_board = torch.ones(n_boards, dtype=torch.bool, device=dev)
        keep_board[drop] = False
        stats["boards_dropped"] = int(n_drop)
        del drop
    del ent
    b2p_deg = graph.b2p.degrees()
    n_kept = int(b2p_deg.sum() if keep_board is None
                 else (b2p_deg * keep_board).sum())
    stats["edges_after_entropy"] = n_kept
    # a surviving board keeps all its edges, so its recomputed mean is the
    # stage-1 mean; a dropped board has no surviving edge to read it
    if board_topics is None:
        board_topics = mean_topics
    else:
        board_topics = _to_device(board_topics, dev, torch.float32)
    del mean_topics

    # -- stage 2: degree pruning with cosine similarity, pin range by range --
    table = torch.as_tensor(
        degree_targets(graph.max_pin_degree, cfg.delta, cfg.min_keep), device=dev)
    pins_f = torch.empty(n_kept, dtype=torch.int32, device=dev)
    boards_f = torch.empty(n_kept, dtype=torch.int32, device=dev)
    at = 0
    p2b = graph.p2b
    for p0, p1, e0, e1 in _chunks(p2b.offsets, n_pins, CHUNK_EDGES):
        pins = _segment_ids(p2b.offsets[p0 + 1:p1 + 1] - p2b.offsets[p0:p1], p0)
        boards = p2b.targets[e0:e1].long() - n_pins
        if keep_board is not None:
            m = keep_board[boards]
            pins, boards = pins[m], boards[m]
        sim = cosine_sim(pin_topics[pins], board_topics[boards])
        # np.lexsort((-sim, pins)): by pin, then by sim descending, stably
        local = pins - p0
        order = torch.sort((local << 32) + _descending_key(sim), stable=True).indices
        del sim
        local, boards = local[order], boards[order]
        deg = torch.bincount(local, minlength=p1 - p0)
        starts = torch.cumsum(deg, 0) - deg
        rank = torch.arange(local.shape[0], device=dev) - starts[local]
        keep = rank < table[deg][local]
        n = int(keep.sum())
        pins_f[at:at + n] = (local[keep] + p0).to(torch.int32)
        boards_f[at:at + n] = boards[keep].to(torch.int32)
        at += n
        del pins, boards, local, order, deg, starts, rank, keep
    del board_topics, keep_board, table
    pins_f, boards_f = pins_f[:at], boards_f[:at]
    stats["edges_after"] = at
    stats["edge_keep_frac"] = stats["edges_after"] / max(stats["edges_before"], 1)

    ef = None if board_lang is None else _to_device(board_lang, dev)[boards_f.long()]
    ef2 = None if pin_lang is None else _to_device(pin_lang, dev)[pins_f.long()]
    pruned = build_graph(
        pins_f, boards_f, n_pins=n_pins, n_boards=n_boards,
        edge_feat=ef, n_feats=n_langs, edge_feat_b2p=ef2,
    )
    stats["bytes_before"] = graph.nbytes()
    stats["bytes_after"] = pruned.nbytes()
    return pruned, stats
