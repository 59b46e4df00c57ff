"""One served batch's record: spans on the device clock, host counters.

``PixieServer._dispatch`` opens one ``BatchTrace`` a batch and makes it
current while ``service.serve_batch`` runs.  The layers below write into
the current record with one call a site, which returns at once when no
record is current: a direct ``serve_batch`` call records nothing.

  * ``span(name)``: a range of the batch, from its start to its end on
    the device clock (CUDA timing events on a card, ``time.perf_counter``
    on a CPU, which runs synchronously), and, while a profiler runs, a
    ``torch.profiler.record_function`` range of the same name, so the
    profile holds it on the kernels' clock.  Its parent is the span open
    when it opened; ``pixie.batch`` holds them all, from the top of the
    dispatch (before the host-to-device copies) to the batch's completion
    event;
  * ``host_sync(site)``: one point where the host waits on the device,
    counted by site, on every device (a CPU counts where a card would
    wait);
  * ``count_chunks(n)``: walk chunks run.

``harvest`` resolves the record after its wait on the completion event,
which has then passed every mark: resolving reads the marks' elapsed
times and adds no wait.  A resolved record holds plain floats and ints.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, NamedTuple, Optional

import torch

BATCH = "pixie.batch"
# every span a batch may hold: ServerStats keeps a ring of each
SPANS = (BATCH, "pixie.walk", "pixie.boost", "pixie.topk")

_current: contextvars.ContextVar = contextvars.ContextVar(
    "pixie_batch_trace", default=None)


def _range(name: str):
    """An entered ``record_function`` range, or None when no profiler runs
    (a range costs ~10 host us even then)."""
    if not torch.autograd._profiler_enabled():
        return None
    r = torch.profiler.record_function(name)
    r.__enter__()
    return r


def _leave(r, exc) -> None:
    if r is not None:
        r.__exit__(*exc)


class Span(NamedTuple):
    """A resolved span: milliseconds from the batch's start."""

    parent: Optional[str]
    start_ms: float
    end_ms: float

    @property
    def ms(self) -> float:
        return self.end_ms - self.start_ms


class BatchTrace:
    """The record of one batch.  ``spans`` (name -> ``Span``) fills when
    ``resolve`` runs; ``host_syncs`` counts waits by site; ``chunks``
    counts walk chunks.  Use it as a context manager around the batch's
    device work: entering marks the batch's start and makes the record
    current, leaving marks its end (``done``: the completion event on a
    card, None on a CPU)."""

    __slots__ = ("chunks", "host_syncs", "spans", "done", "_cuda",
                 "_stream", "_marks", "_open", "_token", "_range")

    def __init__(self, device: torch.device):
        self.chunks = 0
        self.host_syncs: Dict[str, int] = {}
        self.spans: Dict[str, Span] = {}
        self.done: Optional[torch.cuda.Event] = None
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.current_stream(device) if self._cuda else None
        self._marks: Dict[str, list] = {}   # name -> [parent, start, end]
        self._open: List[str] = []
        self._token = self._range = None

    def _mark(self):
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(self._stream)
            return event
        return time.perf_counter()

    def _enter_span(self, name: str) -> None:
        parent = self._open[-1] if self._open else None
        self._marks[name] = [parent, self._mark(), None]
        self._open.append(name)

    def _exit_span(self) -> None:
        self._marks[self._open.pop()][2] = self._mark()

    def __enter__(self) -> "BatchTrace":
        self._range = _range(BATCH)
        self._enter_span(BATCH)
        self._token = _current.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _current.reset(self._token)
        self._exit_span()
        if self._cuda:
            self.done = self._marks[BATCH][2]
        _leave(self._range, exc)
        self._token = self._range = None

    def count_sync(self, site: str, n: int = 1) -> None:
        self.host_syncs[site] = self.host_syncs.get(site, 0) + n

    def resolve(self) -> "BatchTrace":
        """Read the marks as ms from the batch's start, once the batch's
        completion has been waited on; drops every event."""
        t0 = self._marks[BATCH][1]
        since = (t0.elapsed_time if self._cuda
                 else lambda t: (t - t0) * 1e3)
        self.spans = {name: Span(parent, since(start), since(end))
                      for name, (parent, start, end) in self._marks.items()}
        self._marks, self.done, self._stream = {}, None, None
        return self


class _SpanRange:
    __slots__ = ("_rec", "_name", "_range")

    def __init__(self, rec: BatchTrace, name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        self._range = _range(self._name)
        self._rec._enter_span(self._name)

    def __exit__(self, *exc):
        self._rec._exit_span()
        _leave(self._range, exc)


def span(name: str):
    """A span of the current batch (a no-op context without one)."""
    rec = _current.get()
    return contextlib.nullcontext() if rec is None else _SpanRange(rec, name)


def host_sync(site: str, n: int = 1) -> None:
    """Count ``n`` host waits on the device at ``site``."""
    rec = _current.get()
    if rec is not None:
        rec.count_sync(site, n)


def count_chunks(n: int) -> None:
    """Count ``n`` walk chunks run."""
    rec = _current.get()
    if rec is not None:
        rec.chunks += n
