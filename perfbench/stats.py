"""The metric arithmetic over a run's client-side records.

A record is (index, client, t_send, t_done, status, text), times on the
monotonic clock. Every statistic is taken over all requests of the
window at once, never over chunks of it.
"""

from __future__ import annotations

import statistics


def sent_in(records: list, t0: float, t1: float) -> list:
    """The requests sent in [t0, t1), however late they returned."""
    return [r for r in records if t0 <= r[2] < t1]


def completed_in(records: list, t0: float, t1: float) -> list:
    """The requests sent at or after t0 that returned 200 by t1."""
    return [r for r in records if r[2] >= t0 and r[3] <= t1 and r[4] == 200]


def rate(records: list, t0: float, t1: float) -> float:
    """Requests completed over the window's whole length."""
    return len(completed_in(records, t0, t1)) / (t1 - t0)


def latencies_ms(records: list) -> list:
    return [(r[3] - r[2]) * 1e3 for r in records]


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: list) -> float:
    return statistics.median(values)

