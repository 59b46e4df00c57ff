"""Layer ``core/service.py`` serve_batch, program span: the mean over the
closed loop's batches of ``QueryResult.compute_ms``
(before the profiler started).  ``pump`` dispatches
every full batch before ``harvest`` waits, so a batch's span holds the
batches dispatched after it.  Moves ``throughput_qps``."""

from pixiebench import stats


def read(run):
    return stats.mean_batch_compute_ms(run)
