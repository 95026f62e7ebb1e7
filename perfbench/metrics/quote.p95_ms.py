"""95th percentile latency, client side, over every quote sent in the
window."""

from perfbench import stats


def read(run):
    lat = stats.latencies_ms(run.window)
    return stats.percentile(lat, 95.0) if lat else None
