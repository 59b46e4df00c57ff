"""What every kind of cell shares: the driver's contract for one run.

A kind (``kinds/<kind>.py``) sets its system up, drives its server
through one of the window drivers here, checks what the window produced
against its own reference, and builds its result line with ``result``,
so no kind can drift from what the driver and the metric readers read:

  * ``Run``: what a run measured, for the metric readers (``metrics/``).
    The end-to-end readers use ``latencies_ms``, ``answered_in_window``,
    ``seconds`` and ``setup_s``; the per-layer readers ``trace``,
    ``trace_window_s``, ``untraced``, ``stretch``, ``config`` and
    ``work()``;
  * ``_Stretch``: the profiled stretch of a ``--trace 1`` run (from a
    third of the window in, at most ``PROFILE_S``), started and stopped
    between harvests, with nothing in flight;
  * ``open_loop`` / ``closed_loop``: the window, driven from one thread,
    over any server with ``pump(now)``, ``harvest()`` (answers with a
    ``req_id``), ``next_deadline()`` and ``flush()``; the kind's
    ``send(j, rid, now)`` submits payload ``j`` as request ``rid``;
  * ``read_metrics`` and ``result``: the result line, with ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device`` (with
    ``memory_peak_bytes``, and ``busy_s`` / ``window_s`` when traced),
    ``breakdown``, ``phases`` and, last, ``checks``: each number that
    decided ``correct`` beside its limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from pixiebench import checks, devtrace

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
    answers: Dict[int, object]          # req_id -> answer, window requests
    done_at: Dict[int, float]           # req_id -> seconds after the window opened
    due_at: Dict[int, float]            # req_id -> scheduled (open) or sent (closed)
    trace: Optional[devtrace.Summary] = None
    trace_window_s: float = 0.0
    stretch: List[int] = dataclasses.field(default_factory=list)
    traced_from: float = math.inf        # seconds into the window the profiler started
    config: dict = dataclasses.field(default_factory=dict)
    _work: Optional[object] = None
    _work_fn: Optional[Callable[[], object]] = None

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

    def work(self):
        """The profiled stretch's work, counted by the kind's reference (once)."""
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


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once in set-up: its own first start stays
    out of the window."""
    with _profiler(device):
        torch.zeros(1, device=device).add_(1)
        _sync(device)


def open_loop(server, arrivals, send, seconds, drain_s, stretch):
    """The window is the schedule's ``seconds``; serving goes on past it
    until every request due in it is answered, or ``drain_s`` runs out.
    Request ``i`` is payload ``i``, sent stamped with its scheduled time.
    Returns ``(answers, done_at, due_at, order, seconds)``."""
    n = len(arrivals)
    t0 = clock()
    due = t0 + arrivals
    answers, done_at, order = {}, {}, []
    i = 0
    while True:
        now = clock()
        while i < n and due[i] <= now:
            with stretch.span("bench.submit"):
                send(i, i, float(due[i]))
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


def closed_loop(server, send, pool, callers, seconds, stretch):
    """The window closes at the first harvest at or past ``seconds``, so it
    holds whole pump-and-harvest cycles; returns its length as well.
    Request ``rid`` is payload ``rid % pool``."""
    t0 = clock()
    t_end = t0 + seconds
    answers, done_at, due_at, order = {}, {}, {}, []
    nxt = 0

    def next_request(now):
        nonlocal nxt
        send(nxt % pool, nxt, now)
        due_at[nxt] = now - t0
        nxt += 1

    for _ in range(callers):
        next_request(t0)
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
                    next_request(t)
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


def memory_peak(device: torch.device) -> int:
    """The card's peak allocation so far (0 off the card), read after the
    window and before the reference runs."""
    _sync(device)
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def read_trace(run: Run, stretch: _Stretch, order: List[int], t_window: float,
               phases: dict) -> None:
    """Hand the profiled stretch, if one ran, to ``run``."""
    if stretch.prof is None:
        return
    t = clock()
    run.trace = devtrace.summarize(devtrace.events_of(stretch.prof))
    run.trace_window_s = stretch.t1 - stretch.t0
    run.stretch = order[stretch.first:stretch.last]
    run.traced_from = stretch.t0 - t_window
    phases["trace_read_s"] = clock() - t


def read_metrics(cell, run: Run, trace: bool, phases: dict) -> dict:
    """The cell's per-layer metrics (``trace``) or end-to-end ones, each
    that its reader finds; a value beyond every limit (a tail of
    unanswered requests) as the largest double: JSON has no infinity."""
    metrics = {}
    t = clock()
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            value = float(value) if math.isfinite(value) else sys.float_info.max
            metrics[m.name] = {"value": value, "unit": m.unit}
    phases["metrics_s"] = clock() - t
    return metrics


def result(cell, run: Run, numbers: Dict[str, float], limits: Dict[str, float],
           metrics: dict, *, attempted: int, failed: int, peak: int,
           device: torch.device, phases: dict) -> dict:
    """The result line's fields, ``checks`` last."""
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": checks.verdict(numbers, limits), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace_window_s
        out["breakdown"] = devtrace.breakdown(run.trace)
    out["phases"] = phases
    out["checks"] = checks.as_json(numbers, limits)
    return out
