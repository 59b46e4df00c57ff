"""Layer ``core/walk.py`` pixie_random_walk_batched, program span: the
mean over the open loop's batches (answered before the profiler started)
of the record's ``pixie.walk`` span, the walk from the Eq. 1-2 plan
through the last chunk's counting to the query-pin debit, on the device
clock.  Moves ``latency_p50_ms``."""

from pixiebench import records


def read(run):
    return records.span_ms(run, "pixie.walk")
