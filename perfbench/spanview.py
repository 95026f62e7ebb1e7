"""What the per-layer readers of the port's spans share: the recorder's
spans (`mcos_tpu_torch/utils/spans.py`), read in the run's process after
the run, grouped by request, and interval arithmetic on them.

A span is the recorder's `Span`: `(span_id, parent_id, request_id, name,
t_start_ns, t_end_ns, cpu_ns)` on `time.monotonic_ns()`, the clock of the
harness's window (`run.t0`, `run.t1`, in seconds). A span whose
`request_id` is a tuple (a coalesced batch and its device→host copy)
serves each request in it.

Every reader gives nothing, rather than a partial value, where the program
has no recorder (a program older than it) or the ring lost spans of the
interval read.
"""

from __future__ import annotations

from perfbench import stats


def spans_since(t_s: float):
    """Every span of the port's recorder, or None where there is no
    recorder or its ring lost spans opened at or after `t_s` seconds."""
    try:
        from mcos_tpu_torch.utils import spans
    except ImportError:
        return None
    if not spans.RECORDER.complete_since(int(t_s * 1e9)):
        return None
    return [s for s in spans.RECORDER.snapshot() if s.t_end_ns is not None]


def requests_of(spans: list, t0: float, t1: float) -> dict:
    """{request id: [its spans]} for each request whose `http.request`
    opened in [t0, t1) seconds; a span of a tuple of requests counts for
    each of them."""
    lo, hi = t0 * 1e9, t1 * 1e9
    out = {s.request_id: [] for s in spans if s.name == "http.request"
           and s.span_id == s.request_id and lo <= s.t_start_ns < hi}
    for s in spans:
        ids = s.request_id if isinstance(s.request_id, tuple) \
            else (s.request_id,)
        for rid in ids:
            if rid in out:
                out[rid].append(s)
    return out


def window_requests(run):
    """`requests_of` the run's window, or None (see the module)."""
    spans = spans_since(run.t0)
    return None if spans is None else requests_of(spans, run.t0, run.t1)


def wall_ns(s) -> int:
    return s.t_end_ns - s.t_start_ns


def union(intervals) -> list:
    """Sorted disjoint [start, end] intervals covering `intervals`."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return merged


def covered(intervals, lo: int, hi: int) -> int:
    """Length of [lo, hi] that the union of `intervals` covers."""
    return sum(max(min(b, hi) - max(a, lo), 0)
               for a, b in union(intervals))


def self_ns(parent, spans: list) -> int:
    """`parent`'s wall minus the part of it that its direct children
    cover."""
    children = [(s.t_start_ns, s.t_end_ns) for s in spans
                if s.parent_id == parent.span_id]
    return wall_ns(parent) - covered(children, parent.t_start_ns,
                                     parent.t_end_ns)


def median_ms(values_ns: list):
    return stats.median([v / 1e6 for v in values_ns]) if values_ns else None
