"""Layer ``core/walk.py`` pixie_random_walk_batched, program span: the
mean over the closed loop's batches (answered before the profiler
started) of the record's ``pixie.walk`` span, on the device clock.
Moves ``throughput_qps``."""

from pixiebench import records


def read(run):
    return records.span_ms(run, "pixie.walk")
