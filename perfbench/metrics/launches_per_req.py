"""Kernels the device ran in the traced slice over the requests' worth of
work done in it: each request counts by the share of its time, send to
return, that falls inside the slice (requests outlast a short slice, so
counting only those wholly inside it would miscount)."""


def read(run):
    if run.slice is None:
        return None
    a, b = run.slice["t_start"], run.slice["t_end"]
    worth = sum((min(r[3], b) - max(r[2], a)) / (r[3] - r[2])
                for r in run.records
                if r[4] == 200 and r[2] < b and r[3] > a and r[3] > r[2])
    return run.slice["n_kernels"] / worth if worth > 0 else None
