"""Layer ``serving/server.py`` PixieServer, program span: the mean of
``QueryResult.wait_ms``, a request's queue wait from its (scheduled)
submit to its batch's dispatch, over the answers returned before the
profiler started.  Moves ``latency_p95_ms``."""


def read(run):
    waits = [r.wait_ms for r in run.untraced]
    return sum(waits) / len(waits) if waits else None
