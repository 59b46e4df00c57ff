"""Layer ``core/walk.py`` pixie_random_walk_batched, program counter: the
mean over the closed loop's batches (answered before the profiler
started) of the walk chunks run; fewer than the walk's most only where
early stops end every query of a batch.  Moves ``throughput_qps``."""

from pixiebench import records


def read(run):
    return records.walk_chunks(run)
