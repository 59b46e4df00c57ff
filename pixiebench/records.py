"""What the readers of the program's batch records share.

The server hangs one record a batch on each of the batch's answers
(``QueryResult.trace``): spans in ms from the batch's start on the device
clock, host waits on the device by site, walk chunks run.  A reader takes
the mean over the batches answered before the profiler started, one value
a ``batch_seq``, as ``stats.mean_batch_compute_ms`` does; it finds
nothing (None) where the answers carry no record, or no such span.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def per_batch(run) -> List[object]:
    """One record a batch, from the answers returned before the profiler
    started."""
    records = {}
    for r in run.untraced:
        rec = getattr(r, "trace", None)
        if rec is not None:
            records[r.batch_seq] = rec
    return list(records.values())


def _mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def span_ms(run, name: str) -> Optional[float]:
    """Mean length of span ``name`` over the batches that hold it."""
    return _mean(s.end_ms - s.start_ms for s in
                 (rec.spans.get(name) for rec in per_batch(run)) if s is not None)


def host_syncs(run) -> Optional[float]:
    """Mean host waits on the device a batch, every site summed."""
    return _mean(sum(rec.host_syncs.values()) for rec in per_batch(run))


def walk_chunks(run) -> Optional[float]:
    """Mean walk chunks run a batch."""
    return _mean(rec.chunks for rec in per_batch(run))
