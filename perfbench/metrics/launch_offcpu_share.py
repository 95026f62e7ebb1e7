"""Share of the launching time that the launching thread spent off CPU,
in %: over the `program.*` spans of the window's requests, (sum of wall -
sum of the thread's CPU time) / sum of wall. Off CPU is waiting for the
interpreter lock, another lock or a blocking call."""

from perfbench import spanview


def read(run):
    requests = spanview.window_requests(run)
    if not requests:
        return None
    programs = {s.span_id: s for spans in requests.values() for s in spans
                if s.name.startswith("program.")}.values()
    wall = sum(spanview.wall_ns(s) for s in programs)
    if wall <= 0:
        return None
    cpu = sum(min(s.cpu_ns, spanview.wall_ns(s)) for s in programs)
    return 100.0 * (wall - cpu) / wall
