"""Layer ``core/service.py`` serve_batch, program span: the mean over the
open loop's batches of ``QueryResult.compute_ms``
(before the profiler started), dispatch to the end of
``harvest``'s wait on the batch's completion event.  Moves
``latency_p50_ms``."""

from pixiebench import stats


def read(run):
    return stats.mean_batch_compute_ms(run)
