"""Median, over the window's requests, of the wall of the `host.sync`
spans (the device→host copy, which waits for the device) that the
request's answer waited on; a coalesced batch's one copy counts for each
of its members."""

from perfbench import spanview


def read(run):
    requests = spanview.window_requests(run)
    if not requests:
        return None
    waits = [sum(spanview.wall_ns(s) for s in spans if s.name == "host.sync")
             for spans in requests.values()
             if any(s.name == "host.sync" for s in spans)]
    return spanview.median_ms(waits)
