"""Median, over the window's requests, of the program's `handler` span
minus the part its direct children cover: the handler's own Python
(schema, guards, engine build, formatting, the JSON of the viz arrays),
without the coalescer, the programs and the device→host copy."""

from perfbench import spanview


def read(run):
    requests = spanview.window_requests(run)
    if not requests:
        return None
    selfs = []
    for spans in requests.values():
        for s in spans:
            if s.name == "handler":
                selfs.append(spanview.self_ns(s, spans))
    return spanview.median_ms(selfs)
