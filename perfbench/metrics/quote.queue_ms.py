"""Median, over the window's quotes, of the request's `coalesce.queue`
span: from its submit to the coalescer until the batch that holds it
starts to run (the leader's window or slot wait, a follower's wait for the
leader's drain)."""

from perfbench import spanview


def read(run):
    requests = spanview.window_requests(run)
    if not requests:
        return None
    return spanview.median_ms([spanview.wall_ns(s)
                               for spans in requests.values() for s in spans
                               if s.name == "coalesce.queue"])
