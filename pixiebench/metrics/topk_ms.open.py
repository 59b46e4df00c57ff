"""Layer ``core/counter.py`` topk_dense, program span: the mean over the
open loop's batches (answered before the profiler started) of the
record's ``pixie.topk`` span, the exact top-k with its tie pass, on the
device clock.  Moves ``latency_p50_ms``."""

from pixiebench import records


def read(run):
    return records.span_ms(run, "pixie.topk")
