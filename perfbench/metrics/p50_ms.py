"""Median latency, client side, over every request sent in the window."""

from perfbench import stats


def read(run):
    lat = stats.latencies_ms(run.window)
    return stats.median(lat) if lat else None
