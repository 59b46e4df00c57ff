"""One run of one cell: set-up, the measured window, the check, the metrics.

Set-up draws the graph from the seed on the device, compiles it with the
program's ``build_graph``, starts a ``PixieServer`` with the
configuration's buckets and walk (``backend="pallas"``: the hand kernels
on the card), draws the traffic's payloads, and serves one request of the
cell's bucket shape, which loads the kernels (and builds them with
``nvcc`` into the checkout's ``build/`` on a checkout's first run).

The window drives ``submit`` / ``pump`` / ``harvest`` from one thread:

  * open loop: each request is submitted at its scheduled time (stamped
    with it, so the server's queue wait counts a late submit), every
    dispatchable batch is pumped, then harvested; a request's latency
    runs from its scheduled arrival to the host clock after the harvest
    that returned it.  After the window the run keeps serving until every
    request due in it is answered, for at most ``drain_s``;
  * closed loop: ``callers`` requests are out at all times; each answer
    sends that caller's next request at once.  The window closes at the
    first harvest past ``--seconds``, so it holds whole cycles of ``pump``
    and ``harvest`` (each returns ``callers`` answers at once), and
    throughput counts every answer over the whole window.

With ``--trace 1`` a stretch of the window (from a third of it in, at
most ``PROFILE_S``) runs under ``torch.profiler``; it starts and stops
between harvests, with nothing in flight.  After the window the peak
memory is read, the program's state is dropped, and the reference
(``reference.py``) compiles the graph again from the same seed, is held
against the program's compile, and redoes a sample of the answers drawn
from the seed.  The metrics' readers (``metrics/``) read the ``Run``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pixiebench import checks, devtrace, graphgen, reference, roofline
from pixiebench import traffic as traffic_lib

WARM_ID = 2**31 - 2      # the warm-up request's id; every window id is smaller
PROFILE_AT = 1 / 3       # the profiled stretch starts this far into the window
PROFILE_S = 4.0          # and lasts this long at most (a third of the window)
clock = time.perf_counter


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    loop: str
    seconds: float                      # the window's length
    setup_s: float
    answers: Dict[int, object]          # req_id -> QueryResult, window requests
    done_at: Dict[int, float]           # req_id -> seconds after the window opened
    due_at: Dict[int, float]            # req_id -> scheduled (open) or sent (closed)
    trace: Optional[devtrace.Summary] = None
    trace_window_s: float = 0.0
    stretch: List[int] = dataclasses.field(default_factory=list)
    traced_from: float = math.inf        # seconds into the window the profiler started
    config: dict = dataclasses.field(default_factory=dict)
    _work: Optional[roofline.Work] = None
    _work_fn: Optional[object] = None

    @property
    def latencies_ms(self) -> List[float]:
        """Open loop: every request due in the window, scheduled arrival to
        answer; an unanswered one is ``inf``, beyond every limit."""
        return [(self.done_at[r] - t) * 1e3 if r in self.done_at else math.inf
                for r, t in self.due_at.items()]

    @property
    def untraced(self) -> List[object]:
        """The answers returned before the profiler started: the server's
        own spans over them hold none of the profiler's host cost."""
        return [r for rid, r in self.answers.items() if self.done_at[rid] < self.traced_from]

    @property
    def answered_in_window(self) -> int:
        return sum(1 for t in self.done_at.values() if t <= self.seconds)

    def work(self) -> roofline.Work:
        """The profiled stretch's work, counted by the reference (once)."""
        if self._work is None:
            self._work = self._work_fn()
        return self._work


class _Stretch:
    """Starts and stops the profiler at harvest boundaries."""

    def __init__(self, on: bool, t0: float, seconds: float, device: torch.device):
        self.on, self.device = on, device
        self.start_at = t0 + seconds * PROFILE_AT
        self.length = min(PROFILE_S, seconds * PROFILE_AT)
        self.prof = None
        self.first = self.last = 0
        self.t0 = self.t1 = 0.0
        self.finished = False

    def boundary(self, now: float, order: List[int]) -> None:
        if not self.on or self.finished:
            return
        if self.prof is None and now >= self.start_at:
            _sync(self.device)
            self.prof = _profiler(self.device)
            self.prof.start()
            self.t0, self.first = clock(), len(order)
        elif self.prof is not None and now >= self.t0 + self.length:
            self.stop(order)

    def stop(self, order: List[int]) -> None:
        if self.prof is None or self.finished:
            return
        _sync(self.device)
        self.t1 = clock()
        self.prof.stop()
        self.last, self.finished = len(order), True

    def span(self, name: str):
        if self.prof is not None and not self.finished:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def padded(pay: traffic_lib.Payloads, j: int, slots: int):
    """Payload ``j`` as its bucket holds it: ``slots`` wide, -1 / 0 padded."""
    pins = np.full(slots, -1, np.int32)
    weights = np.zeros(slots, np.float32)
    k = pay.pins.shape[1]
    pins[:k], weights[:k] = pay.pins[j], pay.weights[j]
    return pins, weights


def _submit(server, pay, j: int, rid: int, now: float) -> None:
    got = server.submit(pay.pins[j].tolist(), pay.weights[j].tolist(),
                        int(pay.feats[j]), now=now, req_id=rid)
    if got is None:
        raise RuntimeError(f"request {rid} refused by admission control")


def _open_loop(server, arrivals, pay, seconds, drain_s, stretch):
    """The window is the schedule's ``seconds``; serving goes on past it
    until every request due in it is answered, or ``drain_s`` runs out."""
    n = len(arrivals)
    t0 = clock()
    due = t0 + arrivals
    answers, done_at, order = {}, {}, []
    i = 0
    while True:
        now = clock()
        while i < n and due[i] <= now:
            with stretch.span("bench.submit"):
                _submit(server, pay, i, i, float(due[i]))
            i += 1
        with stretch.span("bench.pump"):
            dispatched = server.pump(now=clock())
        if dispatched:
            with stretch.span("bench.harvest"):
                out = server.harvest()
            t = clock()
            for r in out:
                answers[r.req_id], done_at[r.req_id] = r, t - t0
                order.append(r.req_id)
            stretch.boundary(t, order)
            continue
        stretch.boundary(now, order)
        wake = min(due[i] if i < n else math.inf, server.next_deadline() or math.inf)
        if wake == math.inf or now > t0 + seconds + drain_s:
            break
        with stretch.span("bench.wait_for_arrival"):
            time.sleep(max(0.0, min(wake, t0 + seconds + drain_s) - clock()))
    stretch.stop(order)
    due_at = {j: float(arrivals[j]) for j in range(n)}
    return answers, done_at, due_at, order, seconds


def _closed_loop(server, pay, callers, seconds, stretch):
    """The window closes at the first harvest at or past ``seconds``, so it
    holds whole pump-and-harvest cycles; returns its length as well."""
    t0 = clock()
    t_end = t0 + seconds
    answers, done_at, due_at, order = {}, {}, {}, []
    pool = pay.pins.shape[0]
    nxt = 0

    def send(now):
        nonlocal nxt
        _submit(server, pay, nxt % pool, nxt, now)
        due_at[nxt] = now - t0
        nxt += 1

    for _ in range(callers):
        send(t0)
    while True:
        with stretch.span("bench.pump"):
            dispatched = server.pump(now=clock())
        if dispatched:
            with stretch.span("bench.harvest"):
                out = server.harvest()
            t = clock()
            for r in out:
                answers[r.req_id], done_at[r.req_id] = r, t - t0
                order.append(r.req_id)
                if t < t_end:
                    send(t)
            stretch.boundary(t, order)
            if t >= t_end:
                break
            continue
        deadline = server.next_deadline()
        if deadline is None:
            break
        with stretch.span("bench.wait_for_batch"):
            time.sleep(max(0.0, deadline - clock()))
    stretch.stop(order)
    window = clock() - t0
    for r in server.flush():           # a partial batch sent in the window
        answers[r.req_id], done_at[r.req_id] = r, clock() - t0
    return answers, done_at, due_at, order, window


def _program_graph(config, edges):
    from repro_torch.core.graph import build_graph

    return build_graph(
        edges.pins, edges.boards, config["n_pins"], config["n_boards"],
        edge_feat=torch.index_select(edges.board_lang, 0, edges.boards),
        n_feats=config["n_langs"],
        edge_feat_b2p=torch.index_select(edges.pin_lang, 0, edges.pins),
    )


def _to_host(graph):
    side = lambda c: reference.Csr(c.offsets.cpu(), c.targets.cpu(), c.feat_bounds.cpu())
    return reference.Graph(side(graph.p2b), side(graph.b2p), graph.n_pins, graph.n_boards,
                           graph.max_pin_degree)


def slots_for(config: dict, n_pins: int) -> int:
    """The slots of the smallest bucket a query of ``n_pins`` pins fits."""
    return min(s for _, s in config["buckets"] if s >= n_pins)


@dataclasses.dataclass
class Replica:
    """A served replica, set up and warm: the program's graph and server,
    and the traffic's payloads."""

    config: dict
    mix: dict
    seed: int
    graph: object
    server: object
    has_edge: torch.Tensor
    pay: traffic_lib.Payloads
    arrivals: Optional[np.ndarray]
    phases: Dict[str, float]


def set_up(cell, seed: int, seconds: float, device: torch.device, trace: bool) -> Replica:
    """Draw and compile the graph, start the server, make the traffic and
    serve one request of the cell's bucket shape."""
    from repro_torch.core.walk import WalkConfig
    from repro_torch.serving.server import PixieServer

    config, mix = cell.config, cell.traffic
    traffic_lib.validate(mix)
    phases = {}
    t = clock()
    edges = graphgen.draw(config, seed, device)
    has_edge = graphgen.pins_with_edges(edges, config["n_pins"])
    _sync(device)
    phases["graph_draw_s"], t = clock() - t, clock()
    graph = _program_graph(config, edges)
    del edges
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phases["graph_compile_s"], t = clock() - t, clock()
    server = PixieServer(
        graph, WalkConfig(**config["walk"]), seed=seed,
        buckets=[tuple(b) for b in config["buckets"]],
        max_wait_ms=config["max_wait_ms"],
    )
    rep = Replica(config, mix, seed, graph, server, has_edge, None, None, phases)
    traffic_for(rep, mix, seconds)
    _submit(server, rep.pay, 0, WARM_ID, clock())
    server.flush()
    _sync(device)
    if trace:           # the profiler's own first start stays out of the window
        with _profiler(device):
            torch.zeros(1, device=device).add_(1)
            _sync(device)
    phases["warmup_s"] = clock() - t
    return rep


def traffic_for(rep: Replica, mix: dict, seconds: float) -> None:
    """The arrivals (open loop) and payloads of ``mix`` for a window."""
    rep.mix = mix
    if mix["loop"] == "open":
        rep.arrivals = traffic_lib.arrivals(mix, seconds, rep.seed)
        n = len(rep.arrivals)
    else:
        n = mix["pool"]
    rep.pay = traffic_lib.payloads(mix, n, rep.has_edge, rep.config["n_langs"], rep.seed)


def serve_window(rep: Replica, seconds: float, stretch: "_Stretch"):
    """The measured window -> ``(answers, done_at, due_at, order, seconds)``."""
    if rep.mix["loop"] == "open":
        return _open_loop(rep.server, rep.arrivals, rep.pay, seconds,
                          rep.mix["drain_s"], stretch)
    return _closed_loop(rep.server, rep.pay, rep.mix["callers"], seconds, stretch)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """One run; returns the result line's fields and the checks' numbers."""
    start_s = clock() - t_start        # interpreter, imports, argument checks
    rep = set_up(cell, seed, seconds, device, trace)
    config, mix, phases, pay = rep.config, rep.mix, rep.phases, rep.pay
    phases["start_s"] = start_s
    setup_s = clock() - t_start

    t_window = clock()
    stretch = _Stretch(trace, t_window, seconds, device)
    answers, done_at, due_at, order, window = serve_window(rep, seconds, stretch)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    per_batch = sorted({r.batch_seq: r.compute_ms for r in answers.values()}.values())
    if per_batch:
        phases["batches"] = len(per_batch)
        phases["batch_compute_ms_p50"] = per_batch[len(per_batch) // 2]
    run = Run(loop=mix["loop"], seconds=window, setup_s=setup_s, answers=answers,
              done_at=done_at, due_at=due_at, config=config)
    if trace and stretch.prof is not None:
        t = clock()
        run.trace = devtrace.summarize(devtrace.events_of(stretch.prof))
        run.trace_window_s = stretch.t1 - stretch.t0
        run.stretch = order[stretch.first:stretch.last]
        run.traced_from = stretch.t0 - t_window
        phases["trace_read_s"] = clock() - t
    # the program's compiled graph waits on the host for its comparison,
    # so the reference's compile has the card
    graph = _to_host(rep.graph)
    del stretch, rep
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the program's state goes, the reference works it all again
    t = clock()
    served = {rid: (r.scores, r.ids) for rid, r in answers.items()}
    slots = slots_for(config, pay.pins.shape[1])
    edges = graphgen.draw(config, seed, device)
    ref = reference.compile_graph(edges.pins, edges.boards, edges.pin_lang,
                                  edges.board_lang, config["n_pins"],
                                  config["n_boards"], config["n_langs"])
    del edges
    numbers = {"csr_mismatch": checks.csr_mismatch(graph, ref)}
    del graph
    if device.type == "cuda":
        torch.cuda.empty_cache()
    walk = reference.walk_from(config)
    pool = pay.pins.shape[0]

    def redo(rid, rank=True):
        pins, weights = padded(pay, rid % pool, slots)
        return reference.recommend(ref, pins, weights, int(pay.feats[rid % pool]),
                                   reference.request_key(seed, rid, device), walk,
                                   rank=rank)

    sampled = checks.sample(answers, mix["check_requests"], seed)
    expected = {}
    for rid in sampled:
        a = redo(rid)
        expected[rid] = (a.scores.numpy(), a.ids.numpy())
    numbers.update(checks.compare(served, expected))
    numbers["unanswered"] = sum(1 for rid in due_at if rid not in answers)
    phases["reference_s"] = clock() - t

    def stretch_work():
        counts = [0, 0, 0, 0]
        for rid in run.stretch:
            a = redo(rid, rank=False)
            counts[0] += int(a.steps_taken.sum())
            counts[1] += len(a.chunks)
            counts[2] += sum(e for e, _ in a.chunks)
            counts[3] += sum(b for _, b in a.chunks)
        return roofline.Work(*counts)

    run._work_fn = stretch_work
    metrics = {}
    t = clock()
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            # beyond every limit (a tail of unanswered requests) as the
            # largest double: JSON has no infinity
            value = float(value) if math.isfinite(value) else sys.float_info.max
            metrics[m.name] = {"value": value, "unit": m.unit}
    phases["metrics_s"] = clock() - t
    del ref

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": checks.verdict(numbers), "attempted": len(due_at),
           "failed": numbers["unanswered"], "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace_window_s
        out["breakdown"] = devtrace.breakdown(run.trace)
    out["phases"] = phases
    out["checks"] = checks.as_json(numbers)
    return out
