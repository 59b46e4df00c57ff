"""Pixie serving replica (paper §3.3 "Pixie Server"), twin of the retrieval
part of ``repro/serving/server.py``.

  * requests route into shape buckets, ``(batch_size, n_slots)`` pairs: a
    request goes to the smallest bucket whose ``n_slots`` fits its pins;
  * batches form deadline-aware: a bucket dispatches when full or when its
    oldest request has waited ``max_wait_ms``, whichever comes first;
  * every request gets its PRNG stream at submit time,
    ``fold_in(server_key, req_id)``, so batch composition never changes a
    query's walk: bucketed serving equals the single-bucket ``flush``;
  * every batch carries per-request Eq. 2 budgets as data (a plain request
    carries ``cfg.n_steps``), one program for every budget;
  * dispatch records a CUDA event on the current stream after the serving
    call; ``harvest`` synchronises on it (JAX's async dispatch plus
    ``block_until_ready`` in the reference);
  * ``swap_graph`` is the daily reload behind a generation barrier: queued
    requests dispatch on the old graph first, and each result carries the
    generation its batch dispatched under.

Latency per query = queue wait (logical clock, stamped at ``submit``) +
compute (wall clock from dispatch to the end of ``harvest``'s wait).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng, service, walk as walk_lib
from repro_torch.core.graph import PinBoardGraph

# the padding lanes' stream: fold_in(server_key, int32 max)
_PAD_REQ = 2**31 - 1


class LatencyRing:
    """Bounded float ring buffer: a long-lived replica keeps only the most
    recent ``capacity`` samples, and ``percentile`` is exact over them."""

    __slots__ = ("capacity", "_buf", "_n", "_head")

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf = np.zeros((self.capacity,), np.float64)
        self._n = 0
        self._head = 0

    def append(self, x: float) -> None:
        self._buf[self._head] = float(x)
        self._head = (self._head + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def extend(self, xs) -> None:
        for x in xs:
            self.append(x)

    def clear(self) -> None:
        self._n = 0
        self._head = 0

    def values(self) -> np.ndarray:
        """Samples oldest-first (only the retained window)."""
        if self._n < self.capacity:
            return self._buf[: self._n].copy()
        return np.roll(self._buf, -self._head)

    def percentile(self, p: float) -> float:
        """Exact percentile over the window; 0.0 when empty."""
        if not self._n:
            return 0.0
        return float(np.percentile(self.values(), p))

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self.values())


@dataclasses.dataclass
class ServerStats:
    """Serving telemetry with bounded memory; ``latencies_ms[i] =
    wait_ms[i] + compute_ms[i]`` per query."""

    capacity: int = 4096
    latencies_ms: LatencyRing = None
    wait_ms: LatencyRing = None
    compute_ms: LatencyRing = None
    queries: int = 0
    batches: int = 0
    graph_generation: int = 0

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = LatencyRing(self.capacity)
        if self.wait_ms is None:
            self.wait_ms = LatencyRing(self.capacity)
        if self.compute_ms is None:
            self.compute_ms = LatencyRing(self.capacity)

    def percentile(self, p: float, which: str = "latency") -> float:
        ring = {
            "latency": self.latencies_ms,
            "wait": self.wait_ms,
            "compute": self.compute_ms,
        }[which]
        return ring.percentile(p)

    def qps(self, wall_seconds: float) -> float:
        return self.queries / max(wall_seconds, 1e-9)


class QueryResult:
    """Per-query result: unpacks as ``scores, ids = result`` and carries
    the request id, graph generation, latency split and dispatched Eq. 2
    budget."""

    __slots__ = ("req_id", "scores", "ids", "generation", "wait_ms",
                 "compute_ms", "latency_ms", "batch_seq", "budget")

    def __init__(self, req_id, scores, ids, generation, wait_ms,
                 compute_ms, batch_seq, budget=0):
        self.req_id = req_id
        self.scores = scores
        self.ids = ids
        self.generation = generation
        self.wait_ms = wait_ms
        self.compute_ms = compute_ms
        self.latency_ms = wait_ms + compute_ms
        self.batch_seq = batch_seq
        self.budget = budget

    def __iter__(self):
        return iter((self.scores, self.ids))

    def __getitem__(self, i):
        return (self.scores, self.ids)[i]

    def __len__(self):
        return 2

    def __repr__(self):
        return (f"QueryResult(req_id={self.req_id}, gen={self.generation}, "
                f"wait={self.wait_ms:.2f}ms, compute={self.compute_ms:.2f}ms)")


@dataclasses.dataclass
class _Pending:
    req_id: int
    pins: np.ndarray      # (bucket n_slots,) int32, -1 padded
    weights: np.ndarray   # (bucket n_slots,) float32, 0 padded
    feat: int
    key: torch.Tensor     # (2,) per-request PRNG key (fold_in at submit)
    t_enqueue: float      # logical seconds (wall by default)
    budget: int = 0       # Eq. 2 step total (0 = cfg.n_steps)


@dataclasses.dataclass
class _InFlight:
    entries: List[_Pending]
    scores: torch.Tensor
    ids: torch.Tensor
    done: Optional[torch.cuda.Event]  # recorded after the serving call
    generation: int                   # stamped at dispatch
    t_dispatch: float                 # logical clock
    t_dispatch_wall: float            # wall clock, for compute time
    batch_seq: int
    budgets: List[int]


class PixieServer:
    """Single-host Pixie serving replica (bucketed, deadline-aware)."""

    def __init__(
        self,
        graph: PinBoardGraph,
        cfg: walk_lib.WalkConfig,
        batch_size: int = 8,
        n_slots: int = 8,
        seed: int = 0,
        backend: Optional[str] = None,
        buckets: Optional[Sequence[Tuple[int, int]]] = None,
        max_wait_ms: float = 5.0,
        stats_capacity: int = 4096,
    ):
        """Serve ``graph`` on its device.  ``backend`` overrides
        ``cfg.backend``; ``buckets`` is the ``(batch_size, n_slots)`` shape
        table (``None``: the single bucket ``(batch_size, n_slots)``);
        ``max_wait_ms`` is the batch-formation deadline.  Production
        configs (``configs.pixie.FULL_WALK``) carry ``backend="pallas"``,
        the hand kernels; ``"xla"`` selects the plain twins, the oracle."""
        if backend is not None and backend != cfg.backend:
            cfg = dataclasses.replace(cfg, backend=backend)
        self.graph = graph
        self.cfg = cfg
        self.batch_size = batch_size
        self.n_slots = n_slots
        self.max_wait_ms = float(max_wait_ms)
        self.stats = ServerStats(capacity=stats_capacity)
        # keys are tiny: derived on the host, moved with each batch
        self._key = prng.key(seed, "cpu")
        self._pad_key = prng.fold_in(self._key, _PAD_REQ)
        self._seq = 0        # next auto-assigned request id
        self._batch_seq = 0  # dispatch order (monotone)
        if buckets is None:
            buckets = [(batch_size, n_slots)]
        if not buckets:
            raise ValueError("need at least one (batch_size, n_slots) bucket")
        self._buckets: List[Tuple[int, int]] = sorted(
            ((int(b), int(s)) for b, s in buckets), key=lambda bs: bs[1]
        )
        seen = set()
        for b, s in self._buckets:
            if b < 1 or s < 1:
                raise ValueError(f"bucket ({b}, {s}) must be positive")
            if s in seen:
                raise ValueError(
                    f"two buckets share n_slots={s}; routing by pin count "
                    "needs distinct slot shapes"
                )
            seen.add(s)
        self.max_slots = self._buckets[-1][1]
        self._queues: Dict[int, List[_Pending]] = {
            s: [] for _, s in self._buckets
        }
        self._inflight: List[_InFlight] = []

    # -- request path ---------------------------------------------------------
    def _route(self, n_pins: int) -> Tuple[int, int]:
        """Smallest bucket whose n_slots fits the query; raises past the
        largest (a query is never silently truncated)."""
        for b, s in self._buckets:
            if n_pins <= s:
                return b, s
        raise ValueError(
            f"query has {n_pins} pins but the largest bucket holds "
            f"{self.max_slots} slots; shrink the query (service.build_query "
            f"keeps the top-n_slots pins by weight) or add a larger bucket"
        )

    def submit(
        self,
        pins: Sequence[int],
        weights: Sequence[float],
        user_feat: int = 0,
        now: Optional[float] = None,
        req_id: Optional[int] = None,
        budget: Optional[int] = None,
    ) -> int:
        """Enqueue one request; returns its id.

        ``budget`` pins its Eq. 2 step total (1..cfg.n_steps); ``now``
        injects a logical clock (default: wall time); ``req_id`` overrides
        the auto-assigned id, which seeds the request's PRNG stream.
        """
        if len(weights) != len(pins):
            raise ValueError(
                f"query has {len(pins)} pins but {len(weights)} weights; "
                "one weight per pin required (mismatched lengths silently "
                "misalign weights to the wrong pins)"
            )
        if budget is not None and not 1 <= int(budget) <= self.cfg.n_steps:
            raise ValueError(
                f"budget={budget} outside [1, cfg.n_steps="
                f"{self.cfg.n_steps}]: the engine's chunk grid is sized "
                "for cfg.n_steps and a zero-step walk is a drop"
            )
        n = len(pins)
        _, slots = self._route(n)
        if now is None:
            now = time.perf_counter()
        if req_id is None:
            req_id = self._seq
            self._seq += 1
        else:
            self._seq = max(self._seq, req_id + 1)
        qp = np.full(slots, -1, np.int32)
        qw = np.zeros(slots, np.float32)
        qp[:n] = np.asarray(pins, np.int32)
        qw[:n] = np.asarray(weights, np.float32)
        self._queues[slots].append(_Pending(
            req_id=req_id, pins=qp, weights=qw, feat=int(user_feat),
            key=prng.fold_in(self._key, req_id), t_enqueue=now,
            budget=0 if budget is None else int(budget),
        ))
        return req_id

    # -- batch formation ------------------------------------------------------
    def _dispatch(self, batch_size: int, slots: int, now: float) -> None:
        """Form one batch from a bucket queue, run it, and record its
        completion event; the wait happens in ``harvest``."""
        queue = self._queues[slots]
        entries = queue[:batch_size]
        del queue[:batch_size]
        n_real = len(entries)
        pad = batch_size - n_real
        pins = np.full((batch_size, slots), -1, np.int32)
        weights = np.zeros((batch_size, slots), np.float32)
        feats = np.zeros((batch_size,), np.int32)
        budgets = np.full((batch_size,), self.cfg.n_steps, np.int32)
        for i, e in enumerate(entries):
            pins[i] = e.pins
            weights[i] = e.weights
            feats[i] = e.feat
            budgets[i] = e.budget if e.budget else self.cfg.n_steps
        keys = torch.stack([e.key for e in entries] + [self._pad_key] * pad)
        dev = self.graph.device
        t_wall = time.perf_counter()
        scores, ids = service.serve_batch(
            self.graph,
            torch.as_tensor(pins, device=dev),
            torch.as_tensor(weights, device=dev),
            torch.as_tensor(feats, device=dev),
            keys.to(dev), self.cfg,
            step_budgets=torch.as_tensor(budgets, device=dev),
        )
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        self._inflight.append(_InFlight(
            entries=entries, scores=scores, ids=ids, done=done,
            generation=self.stats.graph_generation,
            t_dispatch=now, t_dispatch_wall=t_wall,
            batch_seq=self._batch_seq,
            budgets=[int(budgets[i]) for i in range(n_real)],
        ))
        self._batch_seq += 1
        self.stats.batches += 1

    def _deadline_of(self, entry: _Pending) -> float:
        """Logical dispatch deadline of one queued request: the single
        float expression shared by ``pump`` and ``next_deadline``."""
        return entry.t_enqueue + self.max_wait_ms / 1e3

    def pump(self, now: Optional[float] = None) -> int:
        """Dispatch every full bucket and every bucket whose oldest request
        has waited ``max_wait_ms``; returns the batches dispatched."""
        if now is None:
            now = time.perf_counter()
        dispatched = 0
        for batch_size, slots in self._buckets:
            queue = self._queues[slots]
            while len(queue) >= batch_size:
                self._dispatch(batch_size, slots, now)
                dispatched += 1
            if queue and now >= self._deadline_of(queue[0]):
                self._dispatch(batch_size, slots, now)
                dispatched += 1
        return dispatched

    def next_deadline(self) -> Optional[float]:
        """Logical time the oldest queued request hits its deadline (None
        when every queue is empty)."""
        heads = [self._deadline_of(q[0]) for q in self._queues.values() if q]
        return min(heads) if heads else None

    def pending(self) -> int:
        """Requests queued but not yet dispatched."""
        return sum(len(q) for q in self._queues.values())

    # -- completion path ------------------------------------------------------
    def harvest(self) -> List[QueryResult]:
        """Wait for every in-flight batch and account latency per query:
        ``wait = dispatch - enqueue`` (logical clock), ``compute`` = wall
        time from dispatch to completion, ``latency = wait + compute``."""
        out: List[QueryResult] = []
        for fl in self._inflight:
            if fl.done is not None:
                fl.done.synchronize()
            t_done_wall = time.perf_counter()
            compute_ms = (t_done_wall - fl.t_dispatch_wall) * 1e3
            s_np, i_np = fl.scores.cpu().numpy(), fl.ids.cpu().numpy()
            for i, e in enumerate(fl.entries):
                wait_ms = max(0.0, (fl.t_dispatch - e.t_enqueue) * 1e3)
                out.append(QueryResult(
                    req_id=e.req_id, scores=s_np[i], ids=i_np[i],
                    generation=fl.generation, wait_ms=wait_ms,
                    compute_ms=compute_ms, batch_seq=fl.batch_seq,
                    budget=fl.budgets[i],
                ))
                self.stats.queries += 1
                self.stats.wait_ms.append(wait_ms)
                self.stats.compute_ms.append(compute_ms)
                self.stats.latencies_ms.append(wait_ms + compute_ms)
        self._inflight = []
        return out

    def flush(self, now: Optional[float] = None) -> List[QueryResult]:
        """Serve every queued request synchronously (padding partials);
        results in request-id order.  The single-bucket oracle path."""
        if now is None:
            now = time.perf_counter()
        for batch_size, slots in self._buckets:
            while self._queues[slots]:
                self._dispatch(batch_size, slots, now)
        out = self.harvest()
        out.sort(key=lambda r: r.req_id)
        return out

    # -- graph swap (the daily reload, §3.3) -----------------------------------
    def swap_graph(self, new_graph: PinBoardGraph,
                   now: Optional[float] = None) -> None:
        """Swap in a new graph under load: every queued request dispatches
        on the old graph first (the generation barrier), then the handle
        moves and the generation increments once.  In-flight batches keep
        their old generation."""
        if now is None:
            now = time.perf_counter()
        for batch_size, slots in self._buckets:
            while self._queues[slots]:
                self._dispatch(batch_size, slots, now)
        self.graph = new_graph
        self.stats.graph_generation += 1
