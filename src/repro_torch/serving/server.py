"""Pixie serving replica (paper §3.3 "Pixie Server"), twin of the
unsharded part of ``repro/serving/server.py``.

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
  * every batch keeps a record (``batch_trace.BatchTrace``): its spans on
    the device clock and its host waits and walk chunks, which
    ``harvest`` hangs on each of the batch's results (``QueryResult.trace``)
    and folds into ``stats``;
  * ``swap_graph`` is the daily reload behind a generation barrier: queued
    requests dispatch on the old graph first, and each result carries the
    generation its batch dispatched under;
  * ``ranker=`` makes a two-stage replica: every batch runs retrieval and
    the scenario ranker heads, and ``submit(scenario=...)`` picks each
    request's head;
  * ``pin_topics=`` opens the multi-interest intake (``submit_user``): a
    user's history clusters into interest lanes, each lane is queued like
    a request with an importance-scaled budget, and ``harvest`` merges a
    user's lanes once all have returned;
  * ``max_queue_per_bucket`` bounds admission (a full queue refuses the
    request, counted per bucket), and ``resilience=`` sheds step budgets
    of requests that waited past ``shed_start_ms`` (serving/resilience.py).

A ``distributed.ShardedGraph`` makes a sharded replica (a graph too big
for one card): every batch runs the sharded engine over the routing
``fabric``, a ``(n_shards,)`` death-superstep array rides every dispatch
as data (``kill_shard`` / ``revive_shards``; a graph swap revives every
shard), and ``stats`` sums the walkers dropped by routing overflow and
killed by dead shards.  A sharded replica refuses ``ranker``,
``pin_topics`` and elastic shedding, as the reference's does; on an
unsharded replica the shard controls raise.

Latency per query = queue wait (logical clock, stamped at ``submit``) +
compute (wall clock from dispatch to the end of ``harvest``'s wait).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import distributed as dist_lib
from repro_torch.core import prng, service, walk as walk_lib
from repro_torch.serving import batch_trace
from repro_torch.serving.resilience import ResilienceConfig, elastic_step_budget

# the padding lanes' stream: fold_in(server_key, int32 max)
_PAD_REQ = 2**31 - 1


def _h2d(a, dev: torch.device) -> torch.Tensor:
    """A host array onto the device: a pageable copy, which the host
    waits for."""
    batch_trace.host_sync("dispatch.h2d")
    return torch.as_tensor(a, device=dev)


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
    wait_ms[i] + compute_ms[i]`` per query.  ``dropped`` counts all refused
    work (admission rejections and the traffic harness's sheds);
    ``rejected`` breaks the admission rejections down by bucket
    (``n_slots``).  On a sharded replica ``route_dropped`` sums the walkers
    dropped by routing overflow and ``killed`` those lost to dead shards,
    over every harvested batch.  ``spans`` keeps one ring a span name of
    ``batch_trace.SPANS``: the span's milliseconds, one a batch that held
    it."""

    capacity: int = 4096
    latencies_ms: LatencyRing = None
    wait_ms: LatencyRing = None
    compute_ms: LatencyRing = None
    queries: int = 0
    batches: int = 0
    dropped: int = 0
    rejected: Dict[int, int] = None
    graph_generation: int = 0
    route_dropped: int = 0
    killed: int = 0
    spans: Dict[str, LatencyRing] = None

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = LatencyRing(self.capacity)
        if self.wait_ms is None:
            self.wait_ms = LatencyRing(self.capacity)
        if self.compute_ms is None:
            self.compute_ms = LatencyRing(self.capacity)
        if self.rejected is None:
            self.rejected = {}
        if self.spans is None:
            self.spans = {name: LatencyRing(self.capacity)
                          for name in batch_trace.SPANS}

    @property
    def rejected_total(self) -> int:
        """Admission rejections across every bucket."""
        return sum(self.rejected.values())

    def percentile(self, p: float, which: str = "latency") -> float:
        """``which``: ``"latency"``, ``"wait"``, ``"compute"`` or a span
        name (``"pixie.walk"``)."""
        ring = {
            "latency": self.latencies_ms,
            "wait": self.wait_ms,
            "compute": self.compute_ms,
            **self.spans,
        }[which]
        return ring.percentile(p)

    def qps(self, wall_seconds: float) -> float:
        return self.queries / max(wall_seconds, 1e-9)


class QueryResult:
    """Per-query result: unpacks as ``scores, ids = result`` and carries
    the request id, graph generation, latency split, dispatched Eq. 2
    budget and its batch's resolved record (``trace``, shared by the
    batch's results; None on a multi-interest user's merged result, whose
    lanes may span batches)."""

    __slots__ = ("req_id", "scores", "ids", "generation", "wait_ms",
                 "compute_ms", "latency_ms", "batch_seq", "budget", "trace")

    def __init__(self, req_id, scores, ids, generation, wait_ms,
                 compute_ms, batch_seq, budget=0, trace=None):
        self.req_id = req_id
        self.scores = scores
        self.ids = ids
        self.generation = generation
        self.wait_ms = wait_ms
        self.compute_ms = compute_ms
        self.latency_ms = wait_ms + compute_ms
        self.batch_seq = batch_seq
        self.budget = budget
        self.trace = trace

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
    scenario: int = 0     # ranker head index (ranked replicas only)
    budget: int = 0       # Eq. 2 step total (0 = cfg.n_steps)
    user_id: Optional[int] = None   # owning user (cluster lanes)
    cluster_idx: int = 0  # lane index within the owning user


@dataclasses.dataclass
class _UserAssembly:
    """One multi-interest user awaiting its lanes.  ``generation`` is
    stamped at ``submit_user``: ``swap_graph`` drains every queue before
    the handle moves, so all lanes run under it."""

    n_clusters: int
    importance: np.ndarray           # (k,) float32, normalized
    t_enqueue: float
    generation: int
    parts: Dict[int, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=dict
    )
    wait_ms: float = 0.0
    compute_ms: float = 0.0
    batch_seq: int = -1
    budget: int = 0                  # summed dispatched lane budgets


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
    trace: batch_trace.BatchTrace
    # sharded replicas: () int32 routing drops and dead-shard kills
    route_dropped: Optional[torch.Tensor] = None
    killed: Optional[torch.Tensor] = None


class PixieServer:
    """Single-host Pixie serving replica (bucketed, deadline-aware)."""

    def __init__(
        self,
        graph,
        cfg: walk_lib.WalkConfig,
        batch_size: int = 8,
        n_slots: int = 8,
        seed: int = 0,
        backend: Optional[str] = None,
        fabric=None,
        slack: float = 2.0,
        buckets: Optional[Sequence[Tuple[int, int]]] = None,
        max_wait_ms: float = 5.0,
        max_queue_per_bucket: Optional[int] = None,
        stats_capacity: int = 4096,
        ranker=None,
        pin_topics: Optional[np.ndarray] = None,
        n_clusters: int = 3,
        resilience: Optional[ResilienceConfig] = None,
    ):
        """Serve ``graph`` (a ``PinBoardGraph`` or a
        ``distributed.ShardedGraph``) on its device.  ``backend`` overrides
        ``cfg.backend``; ``buckets`` is the ``(batch_size, n_slots)`` shape
        table (``None``: the single bucket ``(batch_size, n_slots)``);
        ``max_wait_ms`` is the batch-formation deadline;
        ``max_queue_per_bucket`` bounds each bucket's queue (a full queue
        refuses the request: ``submit`` returns None).  Production configs
        (``configs.pixie.FULL_WALK``) carry ``backend="pallas"``, the hand
        kernels; ``"xla"`` selects the plain twins, the oracle.

        ``ranker`` (a ``serving.ranker.RankRequest``) makes a two-stage
        replica: each batch runs retrieval with ``top_k`` overridden to
        ``ranker.cfg.n_candidates`` and then the scenario heads; results
        are ``final_k`` wide.  ``pin_topics`` opens ``submit_user`` with up
        to ``n_clusters`` interest lanes per user; it cannot be combined
        with ``ranker`` (rank a merged set with
        ``recommend.recommend_multi_interest(rank=...)``).  ``resilience``
        turns on the elastic shed; a ranked replica carries no budgets and
        needs ``ResilienceConfig(elastic=False)``.

        A ``distributed.ShardedGraph`` replica needs ``fabric`` (the
        routing fabric of ``serve_batch``) and takes ``slack``; it refuses
        ``ranker``, ``pin_topics`` and elastic shedding, carries no
        budgets, and gets the shard controls ``kill_shard`` /
        ``revive_shards``."""
        if backend is not None and backend != cfg.backend:
            cfg = dataclasses.replace(cfg, backend=backend)
        if pin_topics is not None and ranker is not None:
            raise ValueError(
                "a multi-interest replica can't rank in-batch: stage 2 "
                "re-scores the MERGED per-user candidate bag, which only "
                "exists after harvest; rank via "
                "recommend.recommend_multi_interest(rank=...) instead"
            )
        if n_clusters < 1:
            raise ValueError(f"n_clusters must be >= 1, got {n_clusters}")
        if resilience is not None:
            if ranker is not None and resilience.elastic:
                raise ValueError(
                    "elastic shedding rides the step_budgets axis, which a "
                    "ranked replica's batches don't carry (its batch axis "
                    "is scenario); use ResilienceConfig(elastic=False) for "
                    "admission-only"
                )
            if resilience.max_queue_per_bucket is not None:
                if (max_queue_per_bucket is not None
                        and max_queue_per_bucket
                        != resilience.max_queue_per_bucket):
                    raise ValueError(
                        f"max_queue_per_bucket given twice and disagreeing: "
                        f"server={max_queue_per_bucket} vs "
                        f"resilience={resilience.max_queue_per_bucket}"
                    )
                max_queue_per_bucket = resilience.max_queue_per_bucket
        self.pin_topics = (
            None if pin_topics is None else np.asarray(pin_topics)
        )
        self.n_clusters = int(n_clusters)
        self.ranker = ranker
        self.resilience = resilience
        self.max_queue_per_bucket = max_queue_per_bucket
        self.fabric = fabric
        self.slack = slack
        self.graph = graph
        self._setup_shards()
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
        self._users: Dict[int, _UserAssembly] = {}

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
        scenario: int = 0,
        budget: Optional[int] = None,
    ) -> Optional[int]:
        """Enqueue one request; returns its id, or None when its bucket's
        queue is full (counted in ``stats.dropped`` and
        ``stats.rejected``).

        ``scenario`` picks the ranker head on a two-stage replica
        (``ranker.cfg.scenario_id`` maps names to indices); ``budget`` pins
        the Eq. 2 step total (1..cfg.n_steps) on a replica that carries
        budgets; ``now`` injects a logical clock (default: wall time);
        ``req_id`` overrides the auto-assigned id, which seeds the
        request's PRNG stream.
        """
        if len(weights) != len(pins):
            raise ValueError(
                f"query has {len(pins)} pins but {len(weights)} weights; "
                "one weight per pin required (mismatched lengths silently "
                "misalign weights to the wrong pins)"
            )
        if self.ranker is None:
            if scenario != 0:
                raise ValueError(
                    f"scenario={scenario} on a retrieval-only server; pass "
                    "ranker= to PixieServer to open the scenario axis"
                )
        elif not 0 <= int(scenario) < self.ranker.cfg.n_scenarios:
            raise ValueError(
                f"scenario={scenario} out of range for heads "
                f"{list(self.ranker.cfg.scenarios)}"
            )
        if budget is not None and not 1 <= int(budget) <= self.cfg.n_steps:
            raise ValueError(
                f"budget={budget} outside [1, cfg.n_steps="
                f"{self.cfg.n_steps}]: the engine's chunk grid is sized "
                "for cfg.n_steps and a zero-step walk is a drop"
            )
        if budget is not None and not self._takes_budgets:
            raise ValueError(
                "a ranked or sharded replica's batches carry no budgets; "
                "per-request budgets need a plain or multi-interest replica"
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
        queue = self._queues[slots]
        if (self.max_queue_per_bucket is not None
                and len(queue) >= self.max_queue_per_bucket):
            self._reject(slots)
            return None
        qp = np.full(slots, -1, np.int32)
        qw = np.zeros(slots, np.float32)
        qp[:n] = np.asarray(pins, np.int32)
        qw[:n] = np.asarray(weights, np.float32)
        queue.append(_Pending(
            req_id=req_id, pins=qp, weights=qw, feat=int(user_feat),
            key=prng.fold_in(self._key, req_id), t_enqueue=now,
            scenario=int(scenario),
            budget=0 if budget is None else int(budget),
        ))
        return req_id

    def _reject(self, slots: int) -> None:
        self.stats.dropped += 1
        self.stats.rejected[slots] = self.stats.rejected.get(slots, 0) + 1

    def submit_user(
        self,
        actions: Sequence[service.UserAction],
        user_feat: int = 0,
        now: Optional[float] = None,
        req_id: Optional[int] = None,
        half_life_hours: float = 24.0,
    ) -> Optional[int]:
        """Enqueue one multi-interest user (an action history).

        The history clusters into up to ``n_clusters`` lanes
        (``service.build_user_query`` over ``pin_topics``); each lane is
        queued like a request in the smallest bucket fitting its own pins,
        with the importance-scaled budget of
        ``service.cluster_step_budgets`` and the key
        ``fold_in(fold_in(server_key, req_id), cluster_idx)``.  ``harvest``
        emits one merged result under the returned id once every lane has
        returned.  Admission is all or nothing: if any lane would overflow
        its bucket the whole user is refused (None, one ``stats.dropped``).
        """
        if self.pin_topics is None:
            raise ValueError(
                "submit_user needs a multi-interest replica; pass "
                "pin_topics= to PixieServer to open the clustered intake"
            )
        uq = service.build_user_query(
            actions, self.pin_topics, n_slots=self.max_slots,
            n_clusters=self.n_clusters, half_life_hours=half_life_hours,
            user_feat=user_feat,
        )
        budgets = service.cluster_step_budgets(uq.importance, self.cfg.n_steps)
        if now is None:
            now = time.perf_counter()
        if req_id is None:
            req_id = self._seq
            self._seq += 1
        else:
            self._seq = max(self._seq, req_id + 1)
        lanes = []
        demand: Dict[int, int] = {}
        for ci in range(uq.n_clusters):
            n = int(np.sum(uq.cluster_pins[ci] >= 0))
            _, slots = self._route(n)
            demand[slots] = demand.get(slots, 0) + 1
            lanes.append((ci, slots, n))
        if self.max_queue_per_bucket is not None:
            for slots, extra in demand.items():
                if len(self._queues[slots]) + extra > self.max_queue_per_bucket:
                    self._reject(slots)
                    return None
        user_key = prng.fold_in(self._key, req_id)
        for ci, slots, n in lanes:
            qp = np.full(slots, -1, np.int32)
            qw = np.zeros(slots, np.float32)
            qp[:n] = uq.cluster_pins[ci][:n]
            qw[:n] = uq.cluster_weights[ci][:n]
            self._queues[slots].append(_Pending(
                req_id=req_id, pins=qp, weights=qw, feat=int(user_feat),
                key=prng.fold_in(user_key, ci), t_enqueue=now,
                budget=int(budgets[ci]), user_id=req_id, cluster_idx=ci,
            ))
        self._users[req_id] = _UserAssembly(
            n_clusters=uq.n_clusters,
            importance=np.asarray(uq.importance, np.float32),
            t_enqueue=now,
            generation=self.stats.graph_generation,
        )
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
        scen = np.zeros((batch_size,), np.int32)
        for i, e in enumerate(entries):
            pins[i] = e.pins
            weights[i] = e.weights
            feats[i] = e.feat
            scen[i] = e.scenario
        keys = torch.stack([e.key for e in entries] + [self._pad_key] * pad)
        dev = self.graph.device
        extra = {}
        host = {}   # the batch's fifth array: budgets, scenarios or shard liveness
        if self._sharded:
            # shard liveness rides every dispatch as (n_shards,) data
            extra.update(with_stats=True, fabric=self.fabric, slack=self.slack,
                         return_killed=True)
            host["shard_dead_at"] = self._shard_dead_at.copy()
            entry_budgets = [self.cfg.n_steps] * n_real
        elif self._takes_budgets:
            rcfg = self.resilience
            shed = rcfg is not None and rcfg.elastic
            budgets = np.full((batch_size,), self.cfg.n_steps, np.int32)
            for i, e in enumerate(entries):
                b = e.budget if e.budget else self.cfg.n_steps
                if shed:
                    # queue wait on the logical clock: a replay sheds alike
                    wait_ms = max(0.0, (now - e.t_enqueue) * 1e3)
                    b = elastic_step_budget(b, wait_ms, rcfg)
                budgets[i] = b
            host["step_budgets"] = budgets
            entry_budgets = [int(budgets[i]) for i in range(n_real)]
        else:
            extra["rank"] = self.ranker
            host["scenario"] = scen
            entry_budgets = [self.cfg.n_steps] * n_real
        t_wall = time.perf_counter()
        # the record spans the copies, the serving call and the completion
        # event it records on leaving (rec.done)
        with batch_trace.BatchTrace(dev) as rec:
            out = service.serve_batch(
                self.graph, _h2d(pins, dev), _h2d(weights, dev),
                _h2d(feats, dev), _h2d(keys, dev), self.cfg, **extra,
                **{name: _h2d(a, dev) for name, a in host.items()},
            )
        scores, ids = out[:2]
        route_dropped, killed = out[4:] if self._sharded else (None, None)
        self._inflight.append(_InFlight(
            entries=entries, scores=scores, ids=ids, done=rec.done,
            generation=self.stats.graph_generation,
            t_dispatch=now, t_dispatch_wall=t_wall,
            batch_seq=self._batch_seq, budgets=entry_budgets, trace=rec,
            route_dropped=route_dropped, killed=killed,
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
        time from the batch's dispatch to the end of this wait on it,
        ``latency = wait + compute``.  ``compute`` also holds the host time
        of every batch dispatched after it before this ``harvest`` (in one
        ``pump``, dispatch blocks the host on the device's work), so the
        batch's own time is its record's ``pixie.batch`` span.  Each
        batch's record is resolved after the wait (no further wait) and
        hung on its results.

        A cluster lane parks in its user's assembly; a user whose lanes
        have all returned is emitted as one result merged by
        ``walk.merge_interest_topk`` (on the host), with the max wait and
        compute over its lanes, the last lane's ``batch_seq``, the summed
        lane budgets and the generation stamped at ``submit_user``."""
        out: List[QueryResult] = []
        for fl in self._inflight:
            rec = fl.trace
            rec.count_sync("harvest.done")
            if fl.done is not None:
                fl.done.synchronize()
            t_done_wall = time.perf_counter()
            compute_ms = (t_done_wall - fl.t_dispatch_wall) * 1e3
            rec.resolve()
            for name, span in rec.spans.items():
                self.stats.spans[name].append(span.ms)
            rec.count_sync("harvest.d2h", 2)
            s_np, i_np = fl.scores.cpu().numpy(), fl.ids.cpu().numpy()
            if fl.killed is not None:
                rec.count_sync("harvest.d2h", 2)
                self.stats.route_dropped += int(fl.route_dropped)
                self.stats.killed += int(fl.killed)
            for i, e in enumerate(fl.entries):
                wait_ms = max(0.0, (fl.t_dispatch - e.t_enqueue) * 1e3)
                if e.user_id is not None:
                    asm = self._users[e.user_id]
                    asm.parts[e.cluster_idx] = (s_np[i], i_np[i])
                    asm.wait_ms = max(asm.wait_ms, wait_ms)
                    asm.compute_ms = max(asm.compute_ms, compute_ms)
                    asm.batch_seq = max(asm.batch_seq, fl.batch_seq)
                    asm.budget += fl.budgets[i]
                    continue
                out.append(QueryResult(
                    req_id=e.req_id, scores=s_np[i], ids=i_np[i],
                    generation=fl.generation, wait_ms=wait_ms,
                    compute_ms=compute_ms, batch_seq=fl.batch_seq,
                    budget=fl.budgets[i], trace=rec,
                ))
                self.stats.queries += 1
                self.stats.wait_ms.append(wait_ms)
                self.stats.compute_ms.append(compute_ms)
                self.stats.latencies_ms.append(wait_ms + compute_ms)
        self._inflight = []
        done = [rid for rid, a in self._users.items()
                if len(a.parts) == a.n_clusters]
        for rid in sorted(done):
            asm = self._users.pop(rid)
            lanes = range(asm.n_clusters)
            ms, mi = walk_lib.merge_interest_topk(
                torch.from_numpy(np.stack([asm.parts[c][0] for c in lanes])),
                torch.from_numpy(np.stack([asm.parts[c][1] for c in lanes])),
                torch.from_numpy(asm.importance),
            )
            out.append(QueryResult(
                req_id=rid, scores=ms.numpy(), ids=mi.numpy(),
                generation=asm.generation, wait_ms=asm.wait_ms,
                compute_ms=asm.compute_ms, batch_seq=asm.batch_seq,
                budget=asm.budget,
            ))
            self.stats.queries += 1
            self.stats.wait_ms.append(asm.wait_ms)
            self.stats.compute_ms.append(asm.compute_ms)
            self.stats.latencies_ms.append(asm.wait_ms + asm.compute_ms)
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
    def swap_graph(self, new_graph, now: Optional[float] = None) -> None:
        """Swap in a new graph under load: every queued request dispatches
        on the old graph first (the generation barrier), then the handle
        moves and the generation increments once.  In-flight batches keep
        their old generation.  A sharded replica's swap revives every
        shard (the daily reload replaces the shards)."""
        if now is None:
            now = time.perf_counter()
        for batch_size, slots in self._buckets:
            while self._queues[slots]:
                self._dispatch(batch_size, slots, now)
        self.graph = new_graph
        self.stats.graph_generation += 1
        self._setup_shards()

    # -- shard liveness (degraded-mode serving) --------------------------------
    def _setup_shards(self) -> None:
        """Validate the graph's kind against the replica's options and give
        a sharded graph an all-alive liveness array."""
        self._sharded = isinstance(self.graph, dist_lib.ShardedGraph)
        # ranked and sharded batches carry no step budgets
        self._takes_budgets = self.ranker is None and not self._sharded
        if not self._sharded:
            self._shard_dead_at = None
            return
        if self.ranker is not None:
            raise ValueError(
                "a sharded replica can't rank: stage 2 gathers candidate "
                "neighborhoods from the full CSR, which a node-range shard "
                "doesn't hold; rank on an unsharded replica"
            )
        if self.pin_topics is not None:
            raise ValueError(
                "a sharded replica can't serve multi-interest users: "
                "per-lane step budgets are not threaded through the "
                "sharded engine; serve them on an unsharded replica"
            )
        if self.resilience is not None and self.resilience.elastic:
            raise ValueError(
                "a sharded replica can't shed elastically: the sharded "
                "engine allocates every walker from the static cfg.n_steps "
                "bound; use ResilienceConfig(elastic=False) for admission "
                "control + dead-shard tolerance"
            )
        if self.fabric is None:
            raise ValueError(
                "a sharded replica needs the routing fabric (pass fabric=...)"
            )
        self._shard_dead_at = np.full(
            (self.graph.n_shards,), dist_lib.NEVER_DIES, np.int32
        )

    def kill_shard(self, shard: int, at_superstep: int = 0) -> None:
        """Mark one shard dead from absolute superstep ``at_superstep`` of
        every subsequently dispatched walk (0 = dead from the start).  The
        liveness array rides the next dispatch as data: walkers routed to
        a dead shard are killed and reborn at home, walkers homed there
        stop being (re)injected, and its counts leave the merge."""
        if not self._sharded:
            raise ValueError(
                "kill_shard needs a sharded replica; a plain graph has no "
                "shards to lose"
            )
        if not 0 <= int(shard) < self._shard_dead_at.shape[0]:
            raise ValueError(
                f"shard {shard} out of range for "
                f"{self._shard_dead_at.shape[0]} shards"
            )
        if int(at_superstep) < 0:
            raise ValueError(f"at_superstep={at_superstep} must be >= 0")
        self._shard_dead_at[int(shard)] = int(at_superstep)

    def revive_shards(self) -> None:
        """Bring every shard back to life (subsequent dispatches only)."""
        if not self._sharded:
            raise ValueError("revive_shards needs a sharded replica")
        self._shard_dead_at[:] = dist_lib.NEVER_DIES

    def dead_shards(self) -> List[int]:
        """Shards currently marked dead (empty on a healthy or unsharded
        replica)."""
        if self._shard_dead_at is None:
            return []
        return [int(i) for i in
                np.flatnonzero(self._shard_dead_at != dist_lib.NEVER_DIES)]
