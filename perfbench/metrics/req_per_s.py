"""Requests completed (status 200) over the measured window's seconds."""

from perfbench import stats


def read(run):
    return stats.rate(run.records, run.t0, run.t1)
