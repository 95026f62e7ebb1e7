"""Median time in the route's handler (its entry of `_POST_ROUTES`), from
the benchmark's own span around each call entered in the window."""

from perfbench import stats


def read(run):
    spans = [(b - a) * 1e3 for a, b in run.spans if run.t0 <= a < run.t1]
    return stats.median(spans) if spans else None
