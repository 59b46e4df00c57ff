"""Layer ``core/counter.py`` boost_combine, program span: the mean over
the open loop's batches (answered before the profiler started) of the
record's ``pixie.boost`` span, Eq. 3 over every slot's bins, on the
device clock.  Moves ``latency_p50_ms``."""

from pixiebench import records


def read(run):
    return records.span_ms(run, "pixie.boost")
