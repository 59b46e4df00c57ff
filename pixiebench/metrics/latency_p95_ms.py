"""End to end, host clock: the 95th percentile (nearest rank) of every
request due in the window, from its scheduled arrival to the host clock
after the harvest that returned it; a request never answered counts as
beyond every limit."""

from pixiebench import stats


def read(run):
    lat = run.latencies_ms
    return stats.nearest_rank(lat, 95) if lat else None
