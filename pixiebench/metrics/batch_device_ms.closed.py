"""Layer ``core/service.py`` serve_batch, program span: the mean over the
closed loop's batches (answered before the profiler started) of the
record's ``pixie.batch`` span, from the top of the dispatch (before its
host-to-device copies) to the batch's completion event, on the device
clock: the batch's own time, where ``batch_compute_ms.closed`` holds the
batches dispatched after it.  Moves ``throughput_qps``."""

from pixiebench import records


def read(run):
    return records.span_ms(run, "pixie.batch")
