"""Of the device's idle time in the traced slice, the share during which at
least one thread was inside a `program.*` span, in %: the card waiting on
launches. The rest is the card waiting on queueing, parsing, formatting or
HTTP.

Idle is the slice minus the union of `run.slice["kernels"]`, which holds
kernels only: copies and sets count as idle here. Spans move to the
profiler's clock by `profiler_clock_offset_ns()`, read now."""

from perfbench import spanview


def read(run):
    if run.slice is None:
        return None
    spans = spanview.spans_since(run.slice["t_start"])
    if spans is None:
        return None
    from mcos_tpu_torch.utils.spans import profiler_clock_offset_ns

    offset = profiler_clock_offset_ns()
    lo = int(run.slice["t_start"] * 1e9) + offset
    hi = int(run.slice["t_end"] * 1e9) + offset
    busy = spanview.union((start, start + dur)
                          for _, start, dur in run.slice["kernels"])
    idle, edge = [], lo
    for a, b in busy:
        if a > edge:
            idle.append((edge, min(a, hi)))
        edge = max(edge, b)
    if edge < hi:
        idle.append((edge, hi))
    idle = [(a, b) for a, b in idle if b > a]
    idle_ns = sum(b - a for a, b in idle)
    if idle_ns <= 0:
        return None
    launching = spanview.union(
        (s.t_start_ns + offset, s.t_end_ns + offset) for s in spans
        if s.name.startswith("program.")
        and s.t_end_ns + offset > lo and s.t_start_ns + offset < hi)
    inside = sum(spanview.covered(launching, a, b) for a, b in idle)
    return 100.0 * inside / idle_ns
