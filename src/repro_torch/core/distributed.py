"""Sharded Pixie: the graph split by node ranges, walkers routed between
shards (twin of ``repro/core/distributed.py``).

A graph too large for one card's memory (the paper's 2B pins, 1B boards
and 17B edges need ~136 GB as int32 CSR) is split by node ranges: shard
``s`` owns pins ``[s, s+1) * pins_per_shard`` and boards ``[s, s+1) *
boards_per_shard``, each with its local CSR slices (padded to the largest
shard by ``shard_graph``).  The walk is the batched engine's walk, split
at the hop boundary:

  * a walker's identity is its GLOBAL walker id (query-major,
    ``q * n_walkers + i``), so it draws the unsharded engine's counter-RNG
    bits (``walk._chunk_rbits``) wherever it resides;
  * one superstep = restart kill/rebirth-at-home -> hop pin -> board on
    the local p2b slice (``ops.walk_hop``) -> ONE bounded exchange to the
    board's owner -> hop board -> pin on the local b2p slice (board
    visits counted there) -> ONE bounded exchange to the pin's owner ->
    (query, slot, local pin) events into the owner's dense bins with the
    incremental ``n_high`` crossing tally;
  * early stop is global per (query, slot): a chunk-boundary sum of the
    per-shard tallies, never a reduction over the count buffers;
  * routing has a fixed per-(source, destination) capacity
    (``route_capacity``); overflow walkers are dropped, counted, and
    reborn at home on their next restart draw;
  * ``shard_dead_at`` kills shards at chosen supersteps: their residents
    and walkers routed to them die (``killed``), and their counts leave
    the merge.

The reference runs the superstep inside ``shard_map`` with
``all_to_all``, ``psum``, ``pmax`` and ``axis_index``.  Here the superstep
body is written once over a local shard axis ``S_local``, and a fabric
object supplies the collectives:

  * ``LocalFabric(n_shards)``: every shard on one device in one process;
    the exchange is a transpose of the (source, destination) axes on the
    device;
  * ``ProcessGroupFabric(group)``: one shard per rank of a
    ``torch.distributed`` group (NCCL on cards, gloo on CPUs), exchanges
    by ``all_to_all_single``, sums and maxima by ``all_reduce``.

In the reference's positional slots, ``mesh, axis`` become ``fabric``.
With zero drops the engine is bit-identical to the unsharded batched
engine on the same graph (counts, board counts, ``steps_taken``,
``n_high``), on both walk backends.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import counter as counter_lib
from repro_torch.core import prng, sampling
from repro_torch.core import walk as walk_lib
from repro_torch.core.graph import PinBoardGraph
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

# "this shard never dies": the liveness sentinel of ``shard_dead_at``
NEVER_DIES = 2**31 - 1


# ---------------------------------------------------------------------------
# Graph sharding (the production graph compiler's final stage)
# ---------------------------------------------------------------------------


class ShardedGraph(NamedTuple):
    """Node-range sharded CSR; every tensor has leading dim n_shards."""

    p2b_offsets: torch.Tensor   # (S, pins_per_shard + 1) int32
    p2b_targets: torch.Tensor   # (S, max_p2b_edges) int32 (board *indices*)
    b2p_offsets: torch.Tensor   # (S, boards_per_shard + 1) int32
    b2p_targets: torch.Tensor   # (S, max_b2p_edges) int32 (global pin ids)
    n_pins: int
    n_boards: int
    n_shards: int
    max_pin_degree: int = 4096

    @property
    def pins_per_shard(self) -> int:
        return self.p2b_offsets.shape[1] - 1

    @property
    def boards_per_shard(self) -> int:
        return self.b2p_offsets.shape[1] - 1

    @property
    def device(self) -> torch.device:
        return self.p2b_offsets.device

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self[:4]))


def _slice_csr(offsets, targets, n_shards, rows, shift):
    """Stack each shard's rows ``[s * rows, (s + 1) * rows)`` of one CSR
    direction as rebased offsets ``(S, rows + 1)`` and targets ``(S,
    E_max)`` (minus ``shift``), zero padded; rows past the graph are
    degree-0 ghost rows.  Slices are copied on the graph's device, one
    shard at a time, into the stacked output."""
    n_src = offsets.shape[0] - 1
    dev = offsets.device
    bounds = torch.arange(n_shards + 1, device=dev, dtype=torch.int64) * rows
    edge_at = offsets[bounds.clamp(max=n_src)].tolist()
    e_max = max(edge_at[s + 1] - edge_at[s] for s in range(n_shards))
    off = torch.empty((n_shards, rows + 1), dtype=torch.int32, device=dev)
    tgt = torch.zeros((n_shards, e_max), dtype=torch.int32, device=dev)
    for s in range(n_shards):
        lo, hi = min(s * rows, n_src), min((s + 1) * rows, n_src)
        n = hi - lo
        torch.sub(offsets[lo:hi + 1], edge_at[s], out=off[s, :n + 1])
        off[s, n + 1:] = edge_at[s + 1] - edge_at[s]
        seg = tgt[s, :edge_at[s + 1] - edge_at[s]]
        seg.copy_(targets[edge_at[s]:edge_at[s + 1]])
        if shift:
            seg.sub_(shift)
    return off, tgt


def shard_graph(graph: PinBoardGraph, n_shards: int) -> ShardedGraph:
    """Split a graph into node-range shards (padded to equal size), on the
    graph's own device: the graph is never copied to the host."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    pps = -(-graph.n_pins // n_shards)
    bps = -(-graph.n_boards // n_shards)
    po, pt = _slice_csr(graph.p2b.offsets, graph.p2b.targets, n_shards, pps,
                        graph.n_pins)   # board *indices*, not node ids
    bo, bt = _slice_csr(graph.b2p.offsets, graph.b2p.targets, n_shards, bps, 0)
    return ShardedGraph(
        p2b_offsets=po, p2b_targets=pt, b2p_offsets=bo, b2p_targets=bt,
        n_pins=pps * n_shards, n_boards=bps * n_shards, n_shards=n_shards,
        max_pin_degree=graph.max_pin_degree,
    )


# ---------------------------------------------------------------------------
# Routing fabric
# ---------------------------------------------------------------------------


class LocalFabric:
    """Every shard on one device, in one process: the local shard axis is
    all ``n_shards`` shards, and an exchange is a transpose on the
    device."""

    def __init__(self, n_shards: int, device: DeviceLike = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)
        self.shard_ids = torch.arange(
            self.n_shards, dtype=torch.int32, device=self.device)

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf[src, dst, ...]`` -> ``out[dst, src, ...]``: each shard
        receives its blocks in source order (``all_to_all(..., 0, 0)``)."""
        return buf.transpose(0, 1).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0, dtype=x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x


class ProcessGroupFabric:
    """One shard per rank of a ``torch.distributed`` process group (NCCL
    on cards, gloo on CPUs): the local shard axis has length 1, and shard
    ``s`` is rank ``s``.  The caller initialises the group; tensors live on
    ``device`` (``cuda`` unless the caller names another)."""

    def __init__(self, group=None, device: DeviceLike = None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.n_shards = dist.get_world_size(group)
        self.device = resolve_device(device)
        self.shard_ids = torch.tensor(
            [dist.get_rank(group)], dtype=torch.int32, device=self.device)

    def all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(buf)
        self._dist.all_to_all_single(out[0], buf[0].contiguous(),
                                     group=self.group)
        return out

    def _reduce(self, x, op):
        y = x[0].clone()
        self._dist.all_reduce(y, op=op, group=self.group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self._dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x[0]) for _ in range(self.n_shards)]
        self._dist.all_gather(parts, x[0].contiguous(), group=self.group)
        return torch.stack(parts)


def route_capacity(n_shards: int, n_walkers_total: int, slack: float) -> int:
    """Per-(shard, shard) route capacity for a pool of W walkers.

    Balanced hops put ``W / n_shards**2`` walkers on each (source, dest)
    pair; ``slack`` is the skew headroom before drops start.  Rounded up
    to a multiple of 8, floor 8.
    """
    c = int(slack * n_walkers_total / (n_shards * n_shards))
    return max(8, -(-c // 8) * 8)


def _route(
    fabric,
    n_shards: int,
    capacity: int,
    dest: torch.Tensor,                 # (S_local, L) dest shard (>= S: none)
    payload: Tuple[torch.Tensor, ...],  # each (S_local, L) int32
):
    """Walker exchange with fixed per-pair capacity: ONE fabric exchange
    carries every payload lane and the validity lane.

    Returns ``(valid (S_local, S*C) bool, routed payload tuple, n_dropped
    (S_local,), max_occupancy (S_local,))``; the last is the fullest
    outbound bucket before the capacity clamp.  Each shard receives the
    ``(S_src, C)`` blocks in source order; within a block, walkers keep
    their buffer order (a stable sort by destination).
    """
    s_l, l = dest.shape
    dev = dest.device
    dsort, order = torch.sort(dest.long(), dim=-1, stable=True)
    bucket = dsort.clamp(max=n_shards)
    counts = torch.zeros((s_l, n_shards + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, bucket, torch.ones_like(bucket))
    start = counts.cumsum(-1) - counts
    pos = torch.arange(l, device=dev) - torch.gather(start, 1, bucket)
    live = dsort < n_shards
    keep = live & (pos < capacity)
    slot = torch.where(keep, dsort * capacity + pos, n_shards * capacity)
    dropped = (live & ~keep).sum(-1, dtype=torch.int32)
    max_occ = counts[:, :n_shards].amax(-1).to(torch.int32)

    lanes = [keep.to(torch.int32)] + [
        torch.gather(a, 1, order) for a in payload
    ]
    stacked = torch.stack(lanes, -1)                      # (S_l, L, P)
    n_lanes = stacked.shape[-1]
    buf = torch.zeros((s_l, n_shards * capacity + 1, n_lanes),
                      dtype=torch.int32, device=dev)
    # dropped walkers all land on the trailing sentinel row, then vanish
    buf.scatter_(1, slot[..., None].expand(-1, -1, n_lanes), stacked)
    routed = fabric.all_to_all(
        buf[:, :-1].reshape(s_l, n_shards, capacity, n_lanes)
    ).reshape(s_l, n_shards * capacity, n_lanes)
    valid = routed[..., 0] != 0
    lanes = tuple(routed[..., i + 1].contiguous() for i in range(len(payload)))
    return valid, lanes, dropped, max_occ


# ---------------------------------------------------------------------------
# The sharded batched walk engine
# ---------------------------------------------------------------------------


class ShardedBatchedWalkResult(NamedTuple):
    """Sharded twin of ``walk.WalkResult`` with routing telemetry.

    ``counts`` / ``board_counts`` stay SHARD-STACKED over the fabric's
    local shards (each shard's query-major owned-subrange bins);
    ``counter.fold_sharded_counts`` reassembles the unsharded layout.
    ``killed`` counts walkers lost to dead shards (``None`` without a
    fault schedule), distinct from capacity ``dropped``.
    """

    counts: torch.Tensor                  # (S_local, B * n_slots * pps) int32
    board_counts: Optional[torch.Tensor]  # (S_local, B * n_slots * bps)
    steps_taken: torch.Tensor             # (B, n_slots) int32
    n_high: torch.Tensor                  # (B, n_slots) int32
    dropped: torch.Tensor                 # () int32 routing-overflow drops
    max_occupancy: torch.Tensor           # () int32 fullest route bucket
    killed: Optional[torch.Tensor] = None


def _local_slices(graph: ShardedGraph, fabric):
    """The CSR slices of the fabric's local shards: the whole stack, or
    the graph's own rows when it holds only the local shards."""
    arrays = tuple(graph[:4])
    lead, s_l = arrays[0].shape[0], fabric.shard_ids.shape[0]
    if lead == s_l:
        return arrays
    if lead == graph.n_shards:
        idx = fabric.shard_ids.long()
        return tuple(a.index_select(0, idx) for a in arrays)
    raise ValueError(
        f"graph holds {lead} shard slices; the fabric's local shards are "
        f"{s_l} of {graph.n_shards}"
    )


def pixie_walk_sharded_batched(
    graph: ShardedGraph,
    query_pins: torch.Tensor,      # (B, n_slots) int32 global pin ids, -1 pad
    query_weights: torch.Tensor,   # (B, n_slots) float32, 0 for padding
    keys: torch.Tensor,            # (B, 2) per-query PRNG keys
    cfg: walk_lib.WalkConfig,
    fabric,
    *,
    slack: float = 2.0,
    shard_dead_at: Optional[torch.Tensor] = None,
) -> ShardedBatchedWalkResult:
    """The batched walk engine on a node-range-sharded graph.

    The bit-parity twin of ``walk.pixie_random_walk_batched`` on the same
    (replicated) graph whenever no walker is dropped (raise ``slack``
    until ``dropped == 0``).  Each hop is one ``ops.walk_hop`` call for
    every local shard (the hand kernel for ``cfg.backend == "pallas"`` on
    the card, its twin otherwise); ONE bounded exchange per hop carries
    the whole query batch.  One host sync per chunk (the early-stop
    check).

    ``cfg.bias_beta`` must be 0 (the sharded CSR carries no feature
    bounds).  ``shard_dead_at`` (optional ``(n_shards,)`` int32) kills
    shard ``s`` from absolute superstep ``shard_dead_at[s]`` on
    (``NEVER_DIES``: never): its residents die with it and walkers routed
    to it die in flight (both tallied in ``killed``), its homed walkers
    stop being (re)injected, a killed walker is reborn at home on its next
    restart draw, and a shard that died before the walk ended contributes
    no counts and leaves the ``n_high`` tally.  An all-``NEVER_DIES``
    schedule gives the healthy results with ``killed == 0``.
    """
    if query_pins.dim() != 2:
        raise ValueError(
            f"query_pins must be (n_queries, n_slots), got {tuple(query_pins.shape)}"
        )
    if cfg.n_v < 1:
        raise ValueError(
            f"n_v must be >= 1, got {cfg.n_v}; use "
            "cfg.without_early_stop() to disable early stopping"
        )
    if cfg.bias_beta > 0.0:
        raise ValueError(
            "the sharded graph carries no feat_bounds; set bias_beta=0 "
            "for sharded walks"
        )
    if cfg.gather_mode not in walk_lib.GATHER_MODES:
        raise ValueError(
            f"unknown gather_mode {cfg.gather_mode!r}; use {walk_lib.GATHER_MODES}"
        )
    n_shards = fabric.n_shards
    if graph.n_shards != n_shards:
        raise ValueError(
            f"graph sharded {graph.n_shards} ways but the fabric has "
            f"{n_shards} shards"
        )
    dev = graph.device
    n_queries, n_slots = (int(d) for d in query_pins.shape)
    if keys.shape != (n_queries, 2):
        raise ValueError(f"keys must be ({n_queries}, 2), got {tuple(keys.shape)}")
    faulty = shard_dead_at is not None
    if faulty:
        dead_at = torch.as_tensor(shard_dead_at, device=dev).to(torch.int32)
        if dead_at.shape != (n_shards,):
            raise ValueError(
                f"shard_dead_at must be ({n_shards},) — one death "
                f"superstep per shard — got {tuple(dead_at.shape)}"
            )
    p2b_off, p2b_tgt, b2p_off, b2p_tgt = _local_slices(graph, fabric)
    sid = fabric.shard_ids
    s_l = sid.shape[0]
    w = cfg.n_walkers
    w_total = n_queries * w
    pps, bps = graph.pins_per_shard, graph.boards_per_shard
    cap = route_capacity(n_shards, w_total, slack)
    recv = n_shards * cap
    n_rows = n_queries * n_slots
    count_engine = walk_lib.select_count_engine(
        cfg.backend, n_rows, pps, bps if cfg.count_boards else 0
    )
    use_kernel = cfg.backend == "pallas"
    alpha_u32 = walk_lib._prob_u32(cfg.alpha)
    pin_lo = (sid * pps).contiguous()                     # (S_l,) int32
    board_lo = (sid * bps).contiguous()
    if faulty:
        dead_self = dead_at[sid.long()]                   # (S_l,)

    qp = torch.as_tensor(query_pins, device=dev).to(torch.int32)
    qw = torch.as_tensor(query_weights, device=dev).float()
    keys = keys.to(dev)
    valid_q = (qp >= 0) & (qw > 0)
    safe_q = torch.where(valid_q, qp, 0)

    # ---- Eq. 1-2 setup, the unsharded arithmetic; query-pin degrees come
    # from each shard's owned rows, summed (ownership partitions the ids)
    lo3 = pin_lo[:, None, None]
    owned_q = valid_q & (safe_q >= lo3) & (safe_q < lo3 + pps)
    lq0 = torch.where(owned_q, safe_q - lo3, 0).reshape(s_l, -1).long()
    deg_own = (torch.gather(p2b_off, 1, lq0 + 1) - torch.gather(p2b_off, 1, lq0))
    deg_own = deg_own.reshape(s_l, n_queries, n_slots) * owned_q.to(torch.int32)
    degs = fabric.psum(deg_own)                           # (B, n_slots)
    n_q = sampling.allocate_steps(
        torch.where(valid_q, qw, 0.0), degs, graph.max_pin_degree, cfg.n_steps)
    slot_q, _ = sampling.allocate_walkers(n_q, w)         # (B, w)
    query_q = torch.gather(safe_q, -1, slot_q.long())
    walkers_per_slot = torch.zeros_like(n_q).scatter_add_(
        -1, slot_q.long(), torch.ones_like(slot_q)).reshape(-1)
    slot_of_walker = slot_q.reshape(-1).to(torch.int32)
    query_of_walker = query_q.reshape(-1).to(torch.int32)
    qid_of_walker = torch.arange(
        n_queries, dtype=torch.int32, device=dev).repeat_interleave(w)
    row_of_walker = (qid_of_walker * n_slots + slot_of_walker).long()
    home_of_walker = query_of_walker // pps
    walker_ids = torch.arange(w_total, dtype=torch.int32, device=dev)
    valid_row = valid_q.reshape(-1)
    n_q_row = n_q.reshape(-1)

    res_v = torch.zeros((s_l, recv), dtype=torch.bool, device=dev)
    res_g = torch.zeros((s_l, recv), dtype=torch.int32, device=dev)
    res_p = torch.zeros((s_l, recv), dtype=torch.int32, device=dev)
    counts = torch.zeros((s_l, n_rows * pps), dtype=torch.int32, device=dev)
    bcounts = (torch.zeros((s_l, n_rows * bps), dtype=torch.int32, device=dev)
               if cfg.count_boards else None)
    high = torch.zeros((s_l, n_rows), dtype=torch.int32, device=dev)
    steps_taken = torch.zeros((n_rows,), dtype=torch.int32, device=dev)
    row_active = valid_row.clone()
    dropped = torch.zeros((s_l,), dtype=torch.int32, device=dev)
    occ = torch.zeros((s_l,), dtype=torch.int32, device=dev)
    killed = torch.zeros((s_l,), dtype=torch.int32, device=dev)

    def die_in_flight(dest):
        """Walkers bound for a dead shard die in flight (the drop sentinel
        keeps them out of the exchange): ``(dest, n_killed)``."""
        to_dead = (dest < n_shards) & ~alive_vec[dest.clamp(max=n_shards - 1)]
        return (torch.where(to_dead, n_shards, dest),
                to_dead.sum(-1, dtype=torch.int32))

    def count(buf, sev, iev, qev, n_dim, with_high):
        """Each local shard's events into its own bins (one counting call
        per shard, as each reference shard makes its own); with
        ``with_high`` each shard's row of ``high`` gains its crossings in
        place."""
        for s in range(s_l):
            if with_high:
                counter_lib.accumulate_packed_events_with_high(
                    buf[s], high[s], sev[s], iev[s], n_slots, n_dim, cfg.n_v,
                    count_engine, query_events=qev[s], n_queries=n_queries)
            else:
                counter_lib.accumulate_packed_events(
                    buf[s], sev[s], iev[s], n_slots, n_dim, count_engine,
                    query_events=qev[s], n_queries=n_queries)

    n_chunks = 0
    for it in range(cfg.max_chunks()):
        if not bool(row_active.any()):
            break
        step_base = it * cfg.chunk_steps
        # the whole batch's counter-RNG bits, once per chunk for every
        # local shard: walker q*w+i draws its unsharded bits
        rbits = walk_lib._chunk_rbits(keys, step_base, cfg.chunk_steps, w)
        restarts = (rbits[..., 0].long() & prng.MASK32) < alpha_u32
        active_w = row_active[row_of_walker]
        for s in range(cfg.chunk_steps):
            restart = restarts[s]
            first = it == 0 and s == 0
            if faulty:
                step_abs = step_base + s
                alive_vec = step_abs < dead_at                # (S,)
                self_alive = step_abs < dead_self             # (S_l,)
            # kill + rebirth-at-home: restarting (or frozen-row) residents
            # leave; restarting walkers of active rows re-enter at their
            # home shard with pos = query pin, and hop this same superstep
            rg = res_g.long()
            res_live = res_v & ~restart[rg] & active_w[rg]
            inject = (((restart | first) & active_w)[None, :]
                      & (home_of_walker[None, :] == sid[:, None]))
            if faulty:
                killed = killed + torch.where(
                    step_abs == dead_self, res_v.sum(-1, dtype=torch.int32), 0)
                res_live = res_live & self_alive[:, None]
                inject = inject & self_alive[:, None]
            cand_v = torch.cat([res_live, inject], 1)
            cand_g = torch.cat([res_g, walker_ids.expand(s_l, -1)], 1)
            cand_p = torch.cat([res_p, query_of_walker.expand(s_l, -1)], 1)
            # valid lanes first, in buffer order; keep the first recv
            order = torch.sort((~cand_v).to(torch.uint8), dim=-1,
                               stable=True).indices[:, :recv]
            sel_v = torch.gather(cand_v, 1, order)
            sel_g = torch.gather(cand_g, 1, order)
            sel_p = torch.gather(cand_p, 1, order)
            d0 = (cand_v.sum(-1, dtype=torch.int32)
                  - sel_v.sum(-1, dtype=torch.int32))
            g = sel_g.long()

            # ---- phase A: pin -> board on the local p2b slices
            b_pick, ok1 = ops.walk_hop(
                sel_p, sel_v, rbits[s, :, 2][g], p2b_off,
                p2b_tgt, pin_lo, use_kernel=use_kernel)
            qpin = query_of_walker[g]
            # a dead-end pin forces a restart: the walker routes home
            # carrying its query pin (flag 0 skips hop 2 and counting)
            dest1 = torch.where(
                sel_v, torch.where(ok1, b_pick // bps, home_of_walker[g]),
                n_shards)
            if faulty:
                dest1, k1 = die_in_flight(dest1)
                killed = killed + k1
            pay1 = torch.where(ok1, b_pick, qpin)
            v1, (g1, p1, f1), d1, o1 = _route(
                fabric, n_shards, cap, dest1,
                (sel_g, pay1, ok1.to(torch.int32)))

            # ---- phase B: board -> pin on the local b2p slices; board
            # visits count here, on the board's owner
            g1l = g1.long()
            live1 = v1 & (f1 == 1)
            pin_pick, ok2 = ops.walk_hop(
                p1, live1, rbits[s, :, 3][g1l], b2p_off, b2p_tgt, board_lo,
                use_kernel=use_kernel)
            if cfg.count_boards:
                count(bcounts,
                      torch.where(ok2, slot_of_walker[g1l], n_slots),
                      torch.where(ok2, p1 - board_lo[:, None], 0),
                      torch.where(ok2, qid_of_walker[g1l], n_queries),
                      bps, with_high=False)
            # dead-end boards and in-flight restarts continue at the query
            nxt = torch.where(ok2, pin_pick, query_of_walker[g1l])
            dest2 = torch.where(v1, nxt // pps, n_shards)
            if faulty:
                dest2, k2 = die_in_flight(dest2)
                killed = killed + k2
            v2, (g2, p2, e2), d2, o2 = _route(
                fabric, n_shards, cap, dest2, (g1, nxt, ok2.to(torch.int32)))

            # ---- arrival: (query, slot, local pin) events into the owned
            # bins and the incremental crossing tally
            g2l = g2.long()
            cnt_ok = v2 & (e2 == 1)
            count(
                counts,
                torch.where(cnt_ok, slot_of_walker[g2l], n_slots),
                torch.where(cnt_ok, p2 - pin_lo[:, None], 0),
                torch.where(cnt_ok, qid_of_walker[g2l], n_queries),
                pps, with_high=True)
            occ = torch.maximum(occ, torch.maximum(o1, o2))
            dropped = dropped + d0 + d1 + d2
            res_v, res_g, res_p = v2, g2, p2
        steps_taken += (walkers_per_slot * row_active.to(torch.int32)
                        * cfg.chunk_steps)
        if faulty:
            # a dead shard's bins die with it: its tally leaves the
            # early-stop statistic the moment it does
            alive_h = dead_self > step_base + cfg.chunk_steps - 1
            g_high = fabric.psum(torch.where(alive_h[:, None], high, 0))
        else:
            g_high = fabric.psum(high)
        row_active = valid_row & (steps_taken < n_q_row) & (g_high <= cfg.n_p)
        n_chunks += 1

    if faulty:
        # a shard that died before the walk ended harvests nothing
        keep = (dead_self >= n_chunks * cfg.chunk_steps).to(torch.int32)
        counts.mul_(keep[:, None])
        if cfg.count_boards:
            bcounts.mul_(keep[:, None])
        high = high * keep[:, None]

    # ---- query-pin debit, as the unsharded engine (position-only
    # ownership: an invalid slot's pin 0 hits all-zero bins)
    c4 = counts.view(s_l, n_queries, n_slots, pps)
    own_q = (safe_q >= lo3) & (safe_q < lo3 + pps)        # (S_l, B, n_slots)
    lq = torch.where(own_q, safe_q - lo3, 0).long()
    idx = (
        torch.arange(s_l, device=dev)[:, None, None],
        torch.arange(n_queries, device=dev)[None, :, None],
        torch.arange(n_slots, device=dev)[None, None, :],
        lq,
    )
    vals = c4[idx]
    q_reach = (own_q & (vals >= cfg.n_v)).to(torch.int32)
    c4[idx] = torch.where(own_q, 0, vals)
    n_high = (fabric.psum(high).view(n_queries, n_slots)
              - fabric.psum(q_reach))
    return ShardedBatchedWalkResult(
        counts=counts,
        board_counts=bcounts,
        steps_taken=steps_taken.view(n_queries, n_slots),
        n_high=n_high,
        dropped=fabric.psum(dropped[:, None])[0],
        max_occupancy=fabric.pmax(occ[:, None])[0],
        killed=fabric.psum(killed[:, None])[0] if faulty else None,
    )


def _hierarchical_topk(
    counts: torch.Tensor,      # (S_local, B * n_slots * pps) shard counts
    n_shards: int,
    n_queries: int,
    n_slots: int,
    pps: int,
    k: int,
    fabric=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global boosted top-k from shard-stacked counts.

    Eq. 3's boost is per pin, so a per-shard boost + top-k followed by a
    global re-top-k over the ``S * k`` candidates is exact.  The
    candidates are ordered shard-major per query and ties go to the lower
    candidate index (``counter.topk_dense``, ``lax.top_k``'s rule).
    ``counts`` holds every shard (``fabric`` None or a ``LocalFabric``)
    or the fabric's local shards, whose candidates are all-gathered.
    """
    s_l = counts.shape[0]
    if fabric is None:
        shard_ids = torch.arange(n_shards, dtype=torch.int32, device=counts.device)
    else:
        shard_ids = fabric.shard_ids
    c = counts.view(s_l, n_queries, n_slots, pps)
    scores, pins = [], []
    for s in range(s_l):
        sc, idx = counter_lib.topk_dense(counter_lib.boost_combine(c[s]), k)
        scores.append(sc)
        pins.append(idx + shard_ids[s] * pps)
    scores, pins = torch.stack(scores), torch.stack(pins)    # (S_l, B, k)
    if fabric is not None:
        scores, pins = fabric.all_gather(scores), fabric.all_gather(pins)
    flat_s = scores.transpose(0, 1).reshape(n_queries, n_shards * k)
    flat_p = pins.transpose(0, 1).reshape(n_queries, n_shards * k)
    gs, gi = counter_lib.topk_dense(flat_s, k)
    return gs, torch.gather(flat_p, 1, gi.long())


def recommend_sharded_batched(
    graph: ShardedGraph,
    query_pins: torch.Tensor,
    query_weights: torch.Tensor,
    keys: torch.Tensor,
    cfg: walk_lib.WalkConfig,
    fabric,
    *,
    slack: float = 2.0,
    shard_dead_at: Optional[torch.Tensor] = None,
    return_killed: bool = False,
):
    """Batch-native sharded serving: walk + hierarchical boosted top-k ->
    ``(scores (B, top_k), ids (B, top_k), steps_taken (B, n_slots),
    n_high (B, n_slots), dropped ())``, the reference's five values with a
    ``shard_dead_at`` schedule or without one; a dead shard's counts
    arrive zeroed, so its candidates never win a slot.

    ``return_killed`` (port only) appends ``killed ()``, the walkers lost
    to dead shards (0 without a schedule): ``PixieServer`` reads it for
    ``ServerStats.killed``."""
    res = pixie_walk_sharded_batched(
        graph, query_pins, query_weights, keys, cfg, fabric,
        slack=slack, shard_dead_at=shard_dead_at,
    )
    n_queries, n_slots = (int(d) for d in query_pins.shape)
    scores, ids = _hierarchical_topk(
        res.counts, fabric.n_shards, n_queries, n_slots,
        graph.pins_per_shard, cfg.top_k, fabric,
    )
    out = (scores, ids, res.steps_taken, res.n_high, res.dropped)
    if not return_killed:
        return out
    killed = res.killed if res.killed is not None else torch.zeros_like(res.dropped)
    return out + (killed,)


# ---------------------------------------------------------------------------
# Single-query recipe (the production sharded walk)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedWalkConfig:
    """Single-query sharded walk knobs (``pixie_walk_sharded``): a recipe
    over the batched engine, ``n_supersteps`` global hops with ``n_shards
    * walkers_per_shard`` walkers and no early stopping.  ``slack`` scales
    routing capacity; ``backend`` picks the hop engine (``"pallas"``: the
    hand kernel on the card).  ``unroll`` and ``gather_mode`` hold the
    reference's positional slots: ``gather_mode`` is a TPU knob accepted
    as ``WalkConfig`` accepts it, and ``unroll=True`` (the reference's
    loop-free cost-model mode, which the port does not have) is
    refused."""

    n_supersteps: int = 64
    walkers_per_shard: int = 1024
    alpha: float = 0.5
    slack: float = 2.0
    top_k: int = 100
    unroll: bool = False
    backend: str = "xla"
    gather_mode: str = "scalar"

    def __post_init__(self):
        if self.unroll:
            raise ValueError(
                "ShardedWalkConfig(unroll=True) is the reference's loop-free "
                "cost-model mode for the dry run; the port has no such mode"
            )

    def capacity(self, n_shards: int) -> int:
        return route_capacity(
            n_shards, n_shards * self.walkers_per_shard, self.slack
        )


class ShardedWalkResult(NamedTuple):
    top_scores: torch.Tensor   # (top_k,) f32 boosted scores
    top_pins: torch.Tensor     # (top_k,) int32 global pin ids
    dropped: torch.Tensor      # () int32 walkers dropped by routing overflow


def _wrapper_walk_config(
    cfg: ShardedWalkConfig, n_shards: int
) -> walk_lib.WalkConfig:
    """Map the single-query recipe onto the batched engine's config."""
    w_total = n_shards * cfg.walkers_per_shard
    n_ss = cfg.n_supersteps
    chunk = 8 if n_ss % 8 == 0 else (4 if n_ss % 4 == 0 else 1)
    return walk_lib.WalkConfig(
        n_steps=w_total * n_ss,
        alpha=cfg.alpha,
        n_walkers=w_total,
        chunk_steps=chunk,
        bias_beta=0.0,
        top_k=cfg.top_k,
        count_boards=False,
        backend=cfg.backend,
        gather_mode=cfg.gather_mode,
    ).without_early_stop()


def pixie_walk_sharded(
    graph: ShardedGraph,
    query_pins: torch.Tensor,      # (n_slots,) int32 global pin ids (-1 pad)
    query_weights: torch.Tensor,   # (n_slots,) float32
    key: torch.Tensor,             # (2,) PRNG key
    cfg: ShardedWalkConfig,
    fabric,
) -> ShardedWalkResult:
    """Multi-slot Pixie walk for one query on a node-range-sharded graph:
    the batched engine for a batch of 1, then the exact hierarchical
    boosted top-k."""
    wcfg = _wrapper_walk_config(cfg, fabric.n_shards)
    keys = prng.split(key.to(graph.device), 1)
    res = pixie_walk_sharded_batched(
        graph, query_pins[None], query_weights[None], keys, wcfg, fabric,
        slack=cfg.slack,
    )
    n_slots = int(query_pins.shape[0])
    scores, pins = _hierarchical_topk(
        res.counts, fabric.n_shards, 1, n_slots, graph.pins_per_shard,
        cfg.top_k, fabric,
    )
    return ShardedWalkResult(
        top_scores=scores[0], top_pins=pins[0], dropped=res.dropped
    )
