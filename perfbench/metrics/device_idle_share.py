"""Share of the traced slice in which no device activity ran, in %: one
minus the union of kernel, copy and set intervals over the slice. Read under
the profiler, which slows the host, so it overstates the untraced idle
share."""


def read(run):
    if run.slice is None or run.slice["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.slice["busy_s"] / run.slice["window_s"])
