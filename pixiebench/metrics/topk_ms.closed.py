"""Layer ``core/counter.py`` topk_dense, program span: the mean over the
closed loop's batches (answered before the profiler started) of the
record's ``pixie.topk`` span, on the device clock.  Moves
``throughput_qps``."""

from pixiebench import records


def read(run):
    return records.span_ms(run, "pixie.topk")
