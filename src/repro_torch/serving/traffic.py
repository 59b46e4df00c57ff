"""Open-loop traffic and seeded chaos for the Pixie server (twin of
``repro/serving/traffic.py``).

An open-loop generator offers requests at arrival times drawn from a
seeded Poisson process: arrivals never wait for the server, so queueing
shows in the latency distribution.  ``run_open_loop`` drives
``PixieServer`` on a deterministic virtual clock:

  * arrivals and batch-formation deadlines advance logical time, so the
    arrival pattern, the composition of every batch and every walk are
    reproducible from the seed (numpy ``default_rng``, the reference's
    draws call for call);
  * each batch's compute is the wall time from its dispatch to the end of
    ``harvest``'s wait on its CUDA event (the card's round trip), folded
    into a single-executor queueing model: batch k starts at
    ``max(dispatch_k, done_{k-1})``;
  * per-query latency = queue wait + executor queue + compute;
  * ``max_backlog_s`` sheds arrivals that find the executor backlogged,
    counted, never silent.

Chaos: ``FaultSchedule`` holds faults drawn from a seed
(``sample_fault_schedule``): traffic bursts warp arrival times up front
(``apply_traffic_bursts``), latency spikes defer every dispatch that lands
in their window to its end, and shard deaths call ``server.kill_shard``
(which needs a sharded replica).  An empty schedule is exactly no
schedule, so a zero-fault chaos run equals the plain run bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.server import PixieServer, QueryResult


@dataclasses.dataclass(frozen=True)
class Request:
    """One offered request: arrival time plus the query payload.

    Two payload shapes share the schedule: a FLAT query (``pins`` +
    ``weights``, the classic homefeed request) or a MULTI-INTEREST user
    (``actions`` set — a raw action history the server clusters into
    interest lanes via ``submit_user``).  ``actions`` wins when both are
    present; flat requests leave it ``None``.
    """

    req_id: int
    t_arrival: float            # seconds since epoch start
    pins: Tuple[int, ...]
    weights: Tuple[float, ...]
    user_feat: int
    actions: Optional[Tuple] = None   # Tuple[service.UserAction, ...]


@dataclasses.dataclass(frozen=True)
class OpenLoopConfig:
    """Seeded Poisson workload shape.

    ``offered_qps`` sets the exponential inter-arrival rate; query sizes
    draw uniformly from ``1..max_pins`` (mixed sizes exercise bucket
    routing), weights decay from 1.0 with seeded jitter, feats draw from
    ``n_feats``.  Same seed -> same arrivals, payloads, and (via request
    ids seeding the server's per-query ``fold_in`` streams) same walks.
    """

    offered_qps: float
    n_requests: int
    seed: int = 0
    max_pins: int = 8
    n_feats: int = 4


def poisson_requests(
    candidate_pins: np.ndarray, cfg: OpenLoopConfig
) -> List[Request]:
    """Draw the open-loop arrival schedule and query payloads."""
    if cfg.offered_qps <= 0:
        raise ValueError(f"offered_qps must be > 0, got {cfg.offered_qps}")
    if cfg.max_pins > len(candidate_pins):
        raise ValueError(
            f"max_pins={cfg.max_pins} exceeds the {len(candidate_pins)} "
            "candidate pins to sample from"
        )
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.offered_qps, size=cfg.n_requests)
    arrivals = np.cumsum(gaps)
    out: List[Request] = []
    for i in range(cfg.n_requests):
        k = int(rng.integers(1, cfg.max_pins + 1))
        pins = rng.choice(candidate_pins, size=k, replace=False)
        # weight profile: leading pin strongest, seeded decay after it
        weights = np.maximum(
            1.0 * (0.6 ** np.arange(k)) * rng.uniform(0.5, 1.0, size=k),
            0.05,
        )
        out.append(Request(
            req_id=i,
            t_arrival=float(arrivals[i]),
            pins=tuple(int(p) for p in pins),
            weights=tuple(float(w) for w in weights),
            user_feat=int(rng.integers(0, cfg.n_feats)),
        ))
    return out


def poisson_user_requests(
    histories: Sequence, cfg: OpenLoopConfig
) -> List[Request]:
    """Open-loop arrivals whose payloads are USER ACTION HISTORIES.

    ``histories`` is a sequence of ``graphs.synthetic.UserHistory`` (or
    anything with ``.actions``); arrival ``i`` carries history
    ``i % len(histories)`` — the round-robin keeps every planted user in
    rotation while the Poisson schedule stays identical to the flat
    generator's for the same ``(seed, offered_qps, n_requests)``, so QPS
    sweeps compare flat vs multi-interest serving under the SAME arrival
    pattern.  Feats draw from the same seeded stream position the flat
    generator uses for sizes, so the schedules stay seeded-deterministic
    but are NOT bitwise-coupled to flat payloads (they don't need to be:
    the request ids, not the payload stream, seed the walks).
    """
    if cfg.offered_qps <= 0:
        raise ValueError(f"offered_qps must be > 0, got {cfg.offered_qps}")
    if not histories:
        raise ValueError("poisson_user_requests needs at least one history")
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.offered_qps, size=cfg.n_requests)
    arrivals = np.cumsum(gaps)
    out: List[Request] = []
    for i in range(cfg.n_requests):
        h = histories[i % len(histories)]
        out.append(Request(
            req_id=i,
            t_arrival=float(arrivals[i]),
            pins=(),
            weights=(),
            user_feat=int(rng.integers(0, cfg.n_feats)),
            actions=tuple(h.actions),
        ))
    return out


# ---------------------------------------------------------------------------
# Seeded fault injection (degraded-mode serving, serving/resilience.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault on the virtual clock.

    ``kind`` is ``"latency_spike"`` (dispatch suppression over
    ``[t_start, t_start + duration_s)``), ``"traffic_burst"`` (arrivals in
    the window compress toward ``t_start`` by ``factor``), or
    ``"shard_death"`` (``shard`` dies at walk superstep ``at_superstep``
    for every batch dispatched at or after ``t_start``).
    """

    kind: str
    t_start: float
    duration_s: float = 0.0
    factor: float = 1.0
    shard: int = -1
    at_superstep: int = 0


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A set of fault events, a pure function of the chaos seed.

    Immutable and host-side: applying the same schedule to the same
    request list and server seed replays the whole degraded run
    bit-for-bit (budgets, batch composition, walks, everything).
    """

    events: Tuple[FaultEvent, ...] = ()

    def of_kind(self, kind: str) -> Tuple[FaultEvent, ...]:
        return tuple(
            sorted(
                (e for e in self.events if e.kind == kind),
                key=lambda e: e.t_start,
            )
        )

    def defer(self, t: float) -> float:
        """Earliest non-suppressed instant at or after ``t``.

        A dispatch landing inside a latency-spike window slides to the
        window's end; cascading windows chain (the loop runs to a fixed
        point, so overlapping spikes behave like one long one).
        """
        spikes = self.of_kind("latency_spike")
        moved = True
        while moved:
            moved = False
            for e in spikes:
                if e.t_start <= t < e.t_start + e.duration_s:
                    t = e.t_start + e.duration_s
                    moved = True
        return t


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Knobs for ``sample_fault_schedule`` — how much of each fault kind.

    ``horizon_s`` spans the window fault start times draw from (uniform,
    seeded).  ``n_shards`` must be set when ``n_shard_deaths > 0`` (the
    victim shard draws from it); ``death_max_superstep`` bounds the drawn
    in-walk death step.
    """

    horizon_s: float
    seed: int = 0
    n_spikes: int = 0
    spike_duration_s: float = 0.05
    n_bursts: int = 0
    burst_duration_s: float = 0.2
    burst_factor: float = 4.0
    n_shard_deaths: int = 0
    n_shards: int = 0
    death_max_superstep: int = 8

    def __post_init__(self):
        if self.horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, got {self.horizon_s}")
        if self.burst_factor < 1.0:
            raise ValueError(
                f"burst_factor={self.burst_factor} must be >= 1 (a burst "
                "compresses arrivals; use fewer requests to thin traffic)"
            )
        if self.n_shard_deaths > 0 and self.n_shards < 1:
            raise ValueError(
                "n_shard_deaths > 0 needs n_shards (the victim pool)"
            )


def sample_fault_schedule(cfg: ChaosConfig) -> FaultSchedule:
    """Draw a fault schedule — same ``ChaosConfig`` -> same schedule."""
    rng = np.random.default_rng(cfg.seed)
    events: List[FaultEvent] = []
    for _ in range(cfg.n_spikes):
        events.append(FaultEvent(
            kind="latency_spike",
            t_start=float(rng.uniform(0.0, cfg.horizon_s)),
            duration_s=cfg.spike_duration_s,
        ))
    for _ in range(cfg.n_bursts):
        events.append(FaultEvent(
            kind="traffic_burst",
            t_start=float(rng.uniform(0.0, cfg.horizon_s)),
            duration_s=cfg.burst_duration_s,
            factor=cfg.burst_factor,
        ))
    for _ in range(cfg.n_shard_deaths):
        events.append(FaultEvent(
            kind="shard_death",
            t_start=float(rng.uniform(0.0, cfg.horizon_s)),
            shard=int(rng.integers(0, cfg.n_shards)),
            at_superstep=int(rng.integers(0, cfg.death_max_superstep + 1)),
        ))
    events.sort(key=lambda e: (e.t_start, e.kind))
    return FaultSchedule(events=tuple(events))


def apply_traffic_bursts(
    requests: Sequence[Request], faults: FaultSchedule
) -> List[Request]:
    """Deterministic arrival time-warp for every burst event.

    Arrivals inside ``[t_start, t_start + duration_s)`` compress toward
    ``t_start`` by ``factor`` (monotone within the window, so arrival
    ORDER never changes); payloads and request ids are untouched, so the
    walks — keyed by request id — are bit-identical to the unwarped
    run's, only their queueing differs.  Applied once, up front: the
    burst is part of the offered schedule, not a serving-time effect.
    """
    out = list(requests)
    for e in faults.of_kind("traffic_burst"):
        warped = []
        for r in out:
            t = r.t_arrival
            if e.t_start <= t < e.t_start + e.duration_s:
                t = e.t_start + (t - e.t_start) / e.factor
            warped.append(
                dataclasses.replace(r, t_arrival=t) if t != r.t_arrival
                else r
            )
        out = warped
    return out


@dataclasses.dataclass
class TrafficReport:
    """Aggregate + per-request accounting of one open-loop run."""

    offered_qps: float
    n_offered: int
    n_served: int
    n_dropped: int
    makespan_s: float
    latency_ms: np.ndarray        # (n_served,) wait + exec queue + compute
    wait_ms: np.ndarray           # batch-formation wait
    queue_ms: np.ndarray          # executor backlog wait
    compute_ms: np.ndarray        # measured device round-trip
    results: Dict[int, QueryResult]  # req_id -> result (scores/ids/gen)
    generations: Dict[int, int]   # req_id -> graph generation served under
    # submit-time admission rejections (bounded bucket queues) — part of
    # n_dropped, broken out so total refused work is attributable
    n_rejected: int = 0
    # req_id -> the Eq. 2 step budget the request actually dispatched
    # with (shrunk under elastic shed) — the replay record the chaos
    # verdict feeds back through ``submit(budget=...)``
    budgets: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def drop_rate(self) -> float:
        """Total refused work (backlog sheds + admission rejections)
        over offered — rejections are NOT extra on top of n_dropped."""
        return self.n_dropped / max(self.n_offered, 1)

    @property
    def achieved_qps(self) -> float:
        return self.n_served / max(self.makespan_s, 1e-9)

    def percentile(self, p: float) -> float:
        if self.latency_ms.size == 0:
            return 0.0
        return float(np.percentile(self.latency_ms, p))

    def summary(self) -> Dict:
        return {
            "offered_qps": round(self.offered_qps, 3),
            "achieved_qps": round(self.achieved_qps, 3),
            "n_offered": self.n_offered,
            "n_served": self.n_served,
            "n_dropped": self.n_dropped,
            "n_rejected": self.n_rejected,
            "drop_rate": round(self.drop_rate, 4),
            "p50_ms": round(self.percentile(50), 3),
            "p95_ms": round(self.percentile(95), 3),
            "p99_ms": round(self.percentile(99), 3),
            "mean_wait_ms": round(float(self.wait_ms.mean()), 3)
            if self.wait_ms.size else 0.0,
            "mean_queue_ms": round(float(self.queue_ms.mean()), 3)
            if self.queue_ms.size else 0.0,
            "mean_compute_ms": round(float(self.compute_ms.mean()), 3)
            if self.compute_ms.size else 0.0,
        }


def run_open_loop(
    server: PixieServer,
    requests: Sequence[Request],
    max_backlog_s: Optional[float] = None,
    swap_at: Optional[int] = None,
    swap_graph=None,
    faults: Optional[FaultSchedule] = None,
) -> TrafficReport:
    """Offer ``requests`` to ``server`` on the virtual clock.

    ``max_backlog_s`` bounds the executor backlog an arrival may join
    (open-loop load shedding; ``None`` admits everything — required for
    the agreement verdict, where every request must be served).
    ``swap_at``/``swap_graph`` exercise the daily graph reload (§3.3)
    UNDER load: after offering ``swap_at`` requests the new graph swaps
    in; requests dispatched before the swap carry the old generation.

    ``faults`` injects the seeded chaos schedule: traffic bursts warp the
    arrival times up front (``apply_traffic_bursts``), latency spikes
    defer every dispatch landing in their window to the window's end
    (waits grow, elastic budgets shrink — all on the virtual clock, so
    the degraded run replays bit-for-bit), and shard deaths call
    ``server.kill_shard`` once the clock passes their start time.  An
    empty schedule is exactly no schedule.

    Multi-interest requests (``Request.actions`` set) route through
    ``server.submit_user``; each user surfaces as ONE harvested result
    once its slowest cluster lane lands.  The executor model then sees
    only user-FINAL batches: a user's ``compute_ms``/``wait_ms`` are the
    max over its lanes and its ``batch_seq`` the last lane's, so the
    queueing curve is an honest APPROXIMATION under multi-interest load
    (batches holding only non-final lanes don't advance the executor).
    The bit-level regression signal is the ``multi_interest_agrees``
    verdict, never this model's latency numbers.
    """
    if faults is not None:
        requests = apply_traffic_bursts(requests, faults)
        deaths = list(faults.of_kind("shard_death"))
        eff = faults.defer          # dispatch-time suppression mapping
    else:
        deaths = []
        eff = lambda t: t
    requests = sorted(requests, key=lambda r: r.t_arrival)
    busy_until = 0.0
    harvested: List[QueryResult] = []
    dispatch_time: Dict[int, float] = {}  # batch_seq -> logical dispatch t
    n_dropped = 0
    rejected_before = server.stats.rejected_total

    def _account():
        """Harvest any newly dispatched batches and note dispatch times."""
        for fl in server._inflight:
            dispatch_time[fl.batch_seq] = fl.t_dispatch
        harvested.extend(server.harvest())

    for i, req in enumerate(requests):
        while deaths and deaths[0].t_start <= req.t_arrival:
            e = deaths.pop(0)
            server.kill_shard(e.shard, at_superstep=e.at_superstep)
        if swap_at is not None and i == swap_at:
            if swap_graph is None:
                raise ValueError("swap_at set but no swap_graph given")
            # the swap's generation barrier may dispatch queued partials
            # on the old graph — account them before serving continues
            server.swap_graph(swap_graph, now=eff(req.t_arrival))
            _account()
        # fire every deadline that ripens before this arrival, in order;
        # a deadline landing in a latency-spike window fires (with every
        # other dispatch due by then) at the window's end
        while True:
            d = server.next_deadline()
            if d is None or d > req.t_arrival:
                break
            server.pump(now=eff(d))
            _account()
        if max_backlog_s is not None and (
            busy_until - req.t_arrival > max_backlog_s
        ):
            n_dropped += 1
            server.stats.dropped += 1
            continue
        if req.actions is not None:
            # multi-interest user: the server clusters the history into
            # lanes; all-or-nothing admission may shed the whole user
            # (returns None) — already counted in server.stats.dropped.
            admitted = server.submit_user(
                list(req.actions), req.user_feat,
                now=req.t_arrival, req_id=req.req_id,
            )
        else:
            admitted = server.submit(
                list(req.pins), list(req.weights), req.user_feat,
                now=req.t_arrival, req_id=req.req_id,
            )
        if admitted is None:
            # admission rejection (bounded bucket queue): counted here so
            # the drop rate reflects TOTAL refused work, and per-bucket
            # in server.stats.rejected
            n_dropped += 1
            server.pump(now=eff(req.t_arrival))
            _account()
            busy_until = _advance_executor(
                harvested, dispatch_time, busy_until
            )
            continue
        server.pump(now=eff(req.t_arrival))  # full-bucket dispatches
        _account()
        # fold harvested compute into the executor model as batches land
        busy_until = _advance_executor(harvested, dispatch_time, busy_until)

    # drain: remaining partials dispatch at their deadlines
    while server.pending():
        d = server.next_deadline()
        server.pump(now=eff(d))
        _account()
    busy_until = _advance_executor(harvested, dispatch_time, busy_until)

    # executor queueing model over the full run (batch_seq = dispatch order)
    per_batch: Dict[int, List[QueryResult]] = {}
    for r in harvested:
        per_batch.setdefault(r.batch_seq, []).append(r)
    busy = 0.0
    lat, wait, queue, comp = [], [], [], []
    results: Dict[int, QueryResult] = {}
    generations: Dict[int, int] = {}
    budgets: Dict[int, int] = {}
    for seq in sorted(per_batch):
        rs = per_batch[seq]
        t_d = dispatch_time[seq]
        start = max(t_d, busy)
        compute_s = rs[0].compute_ms / 1e3
        done = start + compute_s
        busy = done
        for r in rs:
            t_arr = t_d - r.wait_ms / 1e3
            lat.append((done - t_arr) * 1e3)
            wait.append(r.wait_ms)
            queue.append((start - t_d) * 1e3)
            comp.append(r.compute_ms)
            results[r.req_id] = r
            generations[r.req_id] = r.generation
            budgets[r.req_id] = int(r.budget)

    makespan = max(
        [busy] + [r.t_arrival for r in requests[-1:]]
    ) if requests else 0.0
    return TrafficReport(
        offered_qps=(
            len(requests) / max(requests[-1].t_arrival, 1e-9)
            if requests else 0.0
        ),
        n_offered=len(requests),
        n_served=len(results),
        n_dropped=n_dropped,
        makespan_s=makespan,
        latency_ms=np.asarray(lat),
        wait_ms=np.asarray(wait),
        queue_ms=np.asarray(queue),
        compute_ms=np.asarray(comp),
        results=results,
        generations=generations,
        n_rejected=server.stats.rejected_total - rejected_before,
        budgets=budgets,
    )


def _advance_executor(harvested, dispatch_time, busy_until: float) -> float:
    """Current executor-free time given everything harvested so far."""
    busy = 0.0
    seen: Dict[int, float] = {}
    for r in harvested:
        seen.setdefault(r.batch_seq, r.compute_ms / 1e3)
    for seq in sorted(seen):
        start = max(dispatch_time[seq], busy)
        busy = start + seen[seq]
    return max(busy_until, busy)
