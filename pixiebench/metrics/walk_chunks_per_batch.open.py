"""Layer ``core/walk.py`` pixie_random_walk_batched, program counter: the
mean over the open loop's batches (answered before the profiler started)
of the walk chunks run; fewer than the walk's most only where early
stops end a whole batch.  Moves ``latency_p50_ms``."""

from pixiebench import records


def read(run):
    return records.walk_chunks(run)
