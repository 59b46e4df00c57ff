"""End to end, host clock: the median (nearest rank) of the same requests
as ``latency_p95_ms``."""

from pixiebench import stats


def read(run):
    lat = run.latencies_ms
    return stats.nearest_rank(lat, 50) if lat else None
