"""Kernel K1's share of its roofline in the traced slice, in %: the least
time of every traced launch at its shape (`perfbench/roofline.py`, against
the H100's published peaks) over K1's device time by kernel name. Nothing
where the slice holds no K1 launch, or where the traced kernels and the
recorded launches do not pair one to one."""

from perfbench import roofline

KERNEL = "svj_draws_kernel"


def read(run):
    if run.slice is None:
        return None
    times = [dur for name, _, dur in run.slice["kernels"] if KERNEL in name]
    if not times or len(times) != len(run.k1_shapes):
        return None
    least = sum(roofline.k1_least_s(**shape) for shape in run.k1_shapes)
    return 100.0 * least / (sum(times) / 1e9)
