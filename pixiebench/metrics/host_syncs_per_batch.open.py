"""Layer ``serving/server.py`` PixieServer, program counter: the mean
over the open loop's batches (answered before the profiler started) of
the host's waits on the device from the batch's dispatch to the end of
its harvest, every site of the record summed.  Moves
``latency_p50_ms``."""

from pixiebench import records


def read(run):
    return records.host_syncs(run)
