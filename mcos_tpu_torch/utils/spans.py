"""Request-scoped spans and counters of the serving path: one recorder,
always on, read by GET /api/metrics and by the benchmark's per-layer
readers.

A span is `(span_id, parent_id, request_id, name, t_start_ns, t_end_ns,
cpu_ns)`:

- times are `time.monotonic_ns()`; `cpu_ns` is the opening thread's CPU
  time over the span (`time.thread_time_ns()`), so wall minus CPU is the
  time that thread spent off CPU: waiting for the interpreter lock,
  another lock, or a blocking call;
- the parent is the innermost span open on the thread when it opened (or
  the span named when it was recorded after the fact);
- `request_id` is the request the span works for: the id of its
  `http.request` root. The spans that serve every member of a coalesced
  batch at once (`coalesce.batch` and its `host.sync`) carry the tuple of
  the members' ids.

The recorder keeps the current request and the stack of open spans in a
thread-local slot, and the spans in a preallocated ring of `RING_SIZE`
slots: the newest spans, with `dropped` counting those overwritten.
Opening or closing a span touches no device (no synchronise, no CUDA
event) and writes only its ring slot and, under the one lock, the
per-name totals. No span is
opened inside a step loop: the spans mark the serving path's layer
boundaries, a few tens a request.

Span names: `http.request`, `http.parse`, `handler`, `http.send`
(`api/server.py`); `coalesce.submit`, `coalesce.queue`, `coalesce.batch`
(`api/coalesce.py`); `program.price`, `program.viz_paths`,
`program.viz_terms` (`engine/pricer.py`), `program.greeks`
(`engine/greeks.py`), `program.lifted` (`ops/roughheston.py`);
`host.sync` (`engine/pricer.py:to_host`, the device→host copy);
`sobol.build` (a Sobol net built on a cache miss).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import namedtuple
from typing import Dict, List, Optional

__all__ = ["Span", "Recorder", "RECORDER", "NEW_REQUEST", "span", "traced",
           "count", "profiler_clock_offset_ns"]

#: Slots of the process's ring: a benchmark cell's window and traced slice
#: (up to about 5 000 quotes of 11 spans each, at 80-90 quotes a second)
#: fit with room.
RING_SIZE = 1 << 17

Span = namedtuple("Span", ["span_id", "parent_id", "request_id", "name",
                           "t_start_ns", "t_end_ns", "cpu_ns"])

#: `open`/`span`/`record`'s `request` for a root: the span's id becomes the
#: request's.
NEW_REQUEST = object()
_INHERIT = object()


class _Close:
    """The context manager `Recorder.span` returns: one per recorder, so a
    span allocates nothing beyond its ring slot."""

    __slots__ = ("_rec",)

    def __init__(self, rec):
        self._rec = rec

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._rec.close()
        return False


class _Release:
    """The context manager `Recorder.acting_for` returns."""

    __slots__ = ("_rec",)

    def __init__(self, rec):
        self._rec = rec

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._rec._local.requests.pop()
        return False


class Recorder:
    """Spans in a fixed ring, per-name totals and named counters; every
    method is thread-safe (a span that stays open while the ring comes
    round to its slot is counted in its totals, not kept)."""

    def __init__(self, size: int = RING_SIZE):
        self.size = int(size)
        # A slot: [span_id, parent_id, request_id, name, t_start, t_end,
        # cpu_ns]; span_id 0 is an empty slot, t_end None an open span.
        self._ring = [[0, None, None, "", 0, None, 0]
                      for _ in range(self.size)]
        self._lock = threading.Lock()
        self._ids = itertools.count(1)     # next() is atomic: no lock
        self._local = threading.local()
        self._totals: Dict[str, List[int]] = {}
        self._counters: Dict[str, int] = {}
        self._close = _Close(self)
        self._release = _Release(self)

    # -- this thread's state --------------------------------------------------
    def _state(self):
        tl = self._local
        try:
            return tl.ids, tl.names, tl.starts, tl.cpus, tl.requests
        except AttributeError:
            tl.ids, tl.names, tl.starts, tl.cpus, tl.requests = \
                [], [], [], [], []
            return tl.ids, tl.names, tl.starts, tl.cpus, tl.requests

    def current_request(self):
        """The request this thread works for, or None."""
        requests = self._state()[4]
        return requests[-1] if requests else None

    def current_span(self) -> Optional[int]:
        """The innermost span open on this thread, or None."""
        ids = self._state()[0]
        return ids[-1] if ids else None

    # -- spans ----------------------------------------------------------------
    def open(self, name: str, request=_INHERIT) -> int:
        """Open `name` under this thread's innermost open span; returns its
        id. `request=spans.NEW_REQUEST` makes it a root whose id is the new
        request's id; another value makes the span, and what opens inside
        it, work for that request."""
        ids, names, starts, cpus, requests = self._state()
        parent = ids[-1] if ids else None
        sid = next(self._ids)
        if request is NEW_REQUEST:
            request = sid
        elif request is _INHERIT:
            request = requests[-1] if requests else None
        # Only this span writes its slot until the ring comes round again.
        slot = self._ring[sid % self.size]
        slot[5], slot[6] = None, 0
        slot[1], slot[2], slot[3] = parent, request, name
        t = slot[4] = time.monotonic_ns()
        slot[0] = sid
        ids.append(sid)
        names.append(name)
        starts.append(t)
        cpus.append(time.thread_time_ns())
        requests.append(request)
        return sid

    def close(self) -> int:
        """Close this thread's innermost open span; returns its wall ns."""
        cpu_end = time.thread_time_ns()
        t_end = time.monotonic_ns()
        ids, names, starts, cpus, requests = self._state()
        sid, name = ids.pop(), names.pop()
        wall = t_end - starts.pop()
        cpu = cpu_end - cpus.pop()
        requests.pop()
        slot = self._ring[sid % self.size]
        if slot[0] == sid:              # not overwritten while it was open
            slot[5], slot[6] = t_end, cpu
        with self._lock:
            self._add(name, wall, cpu)
        return wall

    def _add(self, name: str, wall: int, cpu: int) -> None:
        tot = self._totals.get(name)
        if tot is None:
            tot = self._totals[name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += wall
        tot[2] += max(wall - cpu, 0)

    def span(self, name: str, request=_INHERIT) -> _Close:
        """`with recorder.span(name):` opens and closes a span around the
        block (`open`'s `request` applies)."""
        self.open(name, request)
        return self._close

    def record(self, name: str, t_start_ns: int, t_end_ns: int, *,
               request, parent: Optional[int], cpu_ns: int = 0) -> int:
        """A closed span stamped after the fact, for another thread's wait
        (`coalesce.queue` of a batch's followers); `request` as `open`'s,
        but given."""
        sid = next(self._ids)
        if request is NEW_REQUEST:
            request = sid
        slot = self._ring[sid % self.size]
        slot[1], slot[2], slot[3] = parent, request, name
        slot[4], slot[5], slot[6] = t_start_ns, t_end_ns, cpu_ns
        slot[0] = sid
        with self._lock:
            self._add(name, t_end_ns - t_start_ns, cpu_ns)
        return sid

    def acting_for(self, request) -> _Release:
        """`with recorder.acting_for(rid):` spans opened in the block work
        for `rid` (a coalesced batch runs each member for its request)."""
        self._state()[4].append(request)
        return self._release

    # -- counters ---------------------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    # -- reading ------------------------------------------------------------------
    def _last_id(self) -> int:
        return max(slot[0] for slot in self._ring)

    @property
    def dropped(self) -> int:
        """Spans overwritten in the ring."""
        return max(self._last_id() - self.size, 0)

    def snapshot(self) -> List[Span]:
        """Every span in the ring, closed or open (`t_end_ns` None), oldest
        first."""
        return sorted((Span(*slot) for slot in self._ring if slot[0]),
                      key=lambda s: s.span_id)

    def complete_since(self, t_ns: int) -> bool:
        """Whether the ring holds every span opened at or after `t_ns`: it
        lost none, or its oldest span opened before `t_ns`."""
        last = self._last_id()
        if last <= self.size:
            return True
        return self._ring[(last + 1) % self.size][4] < t_ns

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per span name since start: count, wall ms, off-CPU ms."""
        with self._lock:
            return {name: {"count": c, "wall_ms": w / 1e6,
                           "offcpu_ms": o / 1e6}
                    for name, (c, w, o) in sorted(self._totals.items())}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._counters.items()))


#: The process's recorder.
RECORDER = Recorder()


def span(name: str, request=_INHERIT) -> _Close:
    """A span of the process's recorder around a `with` block."""
    return RECORDER.span(name, request)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the process's counter `name`."""
    RECORDER.count(name, n)


def traced(name: str):
    """Decorate a function so that each call is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            RECORDER.open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                RECORDER.close()
        return call
    return wrap


def profiler_clock_offset_ns() -> int:
    """What to add to a `time.monotonic_ns()` stamp to put it on the clock
    `torch.profiler` stamps its events with (Unix-epoch ns), sampled now:
    the wall clock between two monotonic reads, against their midpoint."""
    a = time.monotonic_ns()
    wall = time.time_ns()
    b = time.monotonic_ns()
    return wall - (a + b) // 2
