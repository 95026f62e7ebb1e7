"""The port's span and counter recorder (`mcos_tpu_torch/utils/spans.py`),
on the CPU: parent and request ids across the stdlib server's threads, a
coalesced batch's spans, self time, the ring's bound and `dropped`, the
benchmark's span readers (`perfbench/metrics/`) on a synthetic run, and
GET /api/metrics' latency histogram."""

import http.client
import importlib.util
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from mcos_tpu_torch.api import coalesce
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.engine.pricer import MonteCarloEngine
from mcos_tpu_torch import utils
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.utils import spans
from perfbench import spanview

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 22500.0
_PRICE = {"spot": S, "strike": S, "T": 0.05, "num_paths": 1024}
_RH = {"spot": S, "T": 0.25, "num_paths": 1000, "n_factors": 4,
       "mode": "price"}
_GREEKS = {"spot": S, "strike": S, "T": 0.05, "num_paths": 1024}


@pytest.fixture(scope="module")
def base():
    real_warm = pserver.warm
    pserver.warm = lambda device: None
    try:
        httpd = pserver.serve("127.0.0.1", 0, device="cpu")
    finally:
        pserver.warm = real_warm
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _post_all(base, path, bodies):
    out = [None] * len(bodies)

    def call(i):
        out[i] = _post(base, path, bodies[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None and o[0] == 200 for o in out)
    return out


def _since(mark):
    """The spans recorded after `mark`, once every one has closed: a server
    thread closes its request's spans after the client has its answer."""
    deadline = time.monotonic() + 30
    while True:
        got = [s for s in spans.RECORDER.snapshot() if s.span_id > mark]
        if all(s.t_end_ns is not None for s in got) \
                or time.monotonic() > deadline:
            return got
        time.sleep(0.01)


def _mark():
    snap = spans.RECORDER.snapshot()
    return snap[-1].span_id if snap else 0


def _by_request(recorded):
    return spanview.requests_of(recorded, 0.0, float("inf"))


# ─────────────────────────────────────────────────────────────────────────────
# Spans of the serving path
# ─────────────────────────────────────────────────────────────────────────────
def test_parent_and_request_ids_across_server_threads(base, monkeypatch):
    monkeypatch.setattr(coalesce.coalescer, "window_s", 0.0)
    assert _post(base, "/api/price", _PRICE)[0] == 200    # the Sobol net
    mark = _mark()
    bodies = [dict(_PRICE, strike=k) for k in (22000.0, 22500.0, 23000.0,
                                               23500.0)]
    _post_all(base, "/api/price", bodies)
    recorded = _since(mark)
    requests = _by_request(recorded)
    assert len(requests) == 4
    by_id = {s.span_id: s for s in recorded}
    for rid, mine in requests.items():
        assert all(s.t_end_ns is not None for s in mine)
        root = by_id[rid]
        assert root.name == "http.request" and root.parent_id is None
        names = sorted(s.name for s in mine)
        assert names == sorted([
            "http.request", "http.parse", "handler", "http.send",
            "program.viz_paths", "program.viz_terms", "program.price",
            "host.sync"])
        handler = next(s for s in mine if s.name == "handler")
        for s in mine:
            assert s.request_id == rid
            assert root.t_start_ns <= s.t_start_ns <= s.t_end_ns \
                <= root.t_end_ns
            want = {"http.request": None, "http.parse": rid,
                    "handler": rid, "http.send": rid}.get(
                        s.name, handler.span_id)
            assert s.parent_id == want, s
    # No span of one request hangs under another's.
    roots = {s.span_id: s.request_id for s in recorded}
    for s in recorded:
        if s.parent_id is not None and s.parent_id in roots:
            assert roots[s.parent_id] == s.request_id


def test_a_coalesced_batch_of_three(base, monkeypatch):
    """One batch of three: each member's `program.*` spans carry its own
    request id under the batch span; every member's queue span (the two
    followers' stamped by the leader) ends at the drain, before the batch
    opens; the batch's copy serves all three."""
    monkeypatch.setattr(coalesce.coalescer, "window_s", 0.0)
    assert _post(base, "/api/price", _PRICE)[0] == 200    # the Sobol net
    monkeypatch.setattr(coalesce.coalescer, "window_s", 0.5)
    runs0 = coalesce.coalescer.batches_run
    mark = _mark()
    _post_all(base, "/api/price", [dict(_PRICE, strike=k)
                                   for k in (22000.0, 22600.0, 23100.0)])
    assert coalesce.coalescer.batches_run == runs0 + 1
    recorded = _since(mark)
    requests = _by_request(recorded)
    assert len(requests) == 3
    batch, = [s for s in recorded if s.name == "coalesce.batch"]
    assert sorted(batch.request_id) == sorted(requests)
    sync, = [s for s in recorded if s.name == "host.sync"]
    assert sync.parent_id == batch.span_id
    assert sync.request_id == batch.request_id
    queues = [s for s in recorded if s.name == "coalesce.queue"]
    assert len(queues) == 3 and len({q.t_end_ns for q in queues}) == 1
    assert queues[0].t_end_ns <= batch.t_start_ns
    for rid, mine in requests.items():
        one = {s.name: s for s in mine}
        submit, queue = one["coalesce.submit"], one["coalesce.queue"]
        assert queue.parent_id == submit.span_id
        assert submit.parent_id == one["handler"].span_id
        assert spanview.wall_ns(queue) <= spanview.wall_ns(submit) \
            <= spanview.wall_ns(one["handler"])
        programs = [s for s in mine if s.name.startswith("program.")]
        assert sorted(s.name for s in programs) == [
            "program.price", "program.viz_paths", "program.viz_terms"]
        for s in programs:
            assert s.request_id == rid and s.parent_id == batch.span_id
    # The leader's submit holds the batch.
    leader = next(s for s in recorded if s.span_id == batch.parent_id)
    assert leader.name == "coalesce.submit"


@pytest.mark.parametrize("path, bodies", [
    ("/api/price", [dict(_PRICE, T=0.05), dict(_PRICE, T=0.4)]),
    ("/api/roughheston", [dict(_RH, num_steps=64),
                          dict(_RH, num_steps=4096)]),
    ("/api/greeks", [dict(_GREEKS, T=0.05), dict(_GREEKS, T=0.3)]),
], ids=["price", "roughheston", "greeks"])
def test_spans_a_request_do_not_grow_with_its_steps(base, monkeypatch, path,
                                                    bodies):
    monkeypatch.setattr(coalesce.coalescer, "window_s", 0.0)
    counts = []
    for body in bodies:
        assert _post(base, path, body)[0] == 200    # builds what it caches
        mark = _mark()
        assert _post(base, path, body)[0] == 200
        mine, = _by_request(_since(mark)).values()
        counts.append(len(mine))
        assert sum(s.name == "host.sync" for s in mine) == 1
        assert sum(s.name.startswith("program.") for s in mine) >= 1
    assert counts[0] == counts[1] <= 40


def test_error_answers_close_their_request_span(base):
    """A body that is not JSON (422) and one over the size limit (413, not
    read) each close an `http.request` with its parse and send spans, no
    `handler` span, and count as errors of the route."""
    before = pserver.METRICS.snapshot()["endpoints"].get(
        "/api/price", {"count": 0, "errors": 0})
    mark = _mark()
    req = urllib.request.Request(base + "/api/price", data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 422
    host, port = base.rsplit("/", 1)[-1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.putrequest("POST", "/api/price")
        conn.putheader("Content-Length", str(pserver.MAX_BODY_BYTES + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
    finally:
        conn.close()
    requests = _by_request(_since(mark))
    assert len(requests) == 2
    for mine in requests.values():
        assert sorted(s.name for s in mine) == [
            "http.parse", "http.request", "http.send"]
    after = pserver.METRICS.snapshot()["endpoints"]["/api/price"]
    assert after["count"] - before["count"] == 2
    assert after["errors"] - before["errors"] == 2


def test_sobol_cache_and_metrics_blocks(base):
    eng = MonteCarloEngine(SVJParams(), num_paths=256, seed=987_654,
                           device="cpu")
    before = spans.RECORDER.counters()
    builds = spans.RECORDER.totals().get("sobol.build", {"count": 0})
    eng._sobol_draws(7)
    eng._sobol_draws(7)
    after = spans.RECORDER.counters()
    assert after["sobol_cache_misses"] - before.get(
        "sobol_cache_misses", 0) == 1
    assert after["sobol_cache_hits"] - before.get("sobol_cache_hits", 0) == 1
    assert spans.RECORDER.totals()["sobol.build"]["count"] == \
        builds["count"] + 1
    with urllib.request.urlopen(base + "/api/metrics", timeout=60) as r:
        snap = json.loads(r.read())
    assert snap["counters"]["sobol_cache_misses"] >= 1
    for name, agg in snap["spans"].items():
        assert agg.keys() == {"count", "wall_ms", "offcpu_ms"}
        assert agg["count"] >= 1 and 0 <= agg["offcpu_ms"] <= \
            agg["wall_ms"] + 0.01, name


# ─────────────────────────────────────────────────────────────────────────────
# The recorder
# ─────────────────────────────────────────────────────────────────────────────
def _span(sid, parent, rid, name, a, b, cpu=0):
    return spans.Span(sid, parent, rid, name, a, b, cpu)


def test_self_time_is_the_span_minus_the_union_of_its_children():
    parent = _span(1, None, 1, "handler", 0, 100)
    kids = [_span(2, 1, 1, "a", 10, 30), _span(3, 1, 1, "b", 20, 50),
            _span(4, 1, 1, "c", 90, 120),        # runs past the parent
            _span(5, 2, 1, "grandchild", 60, 80)]  # not a direct child
    assert spanview.self_ns(parent, [parent] + kids) == 100 - 40 - 10
    rec = spans.Recorder(size=64)
    with rec.span("outer", request=spans.NEW_REQUEST):
        with rec.span("inner"):
            pass
        with rec.span("inner"):
            with rec.span("deeper"):
                pass
    outer, i1, i2, deeper = rec.snapshot()
    assert (i1.parent_id, i2.parent_id, deeper.parent_id) == \
        (outer.span_id,) * 2 + (i2.span_id,)
    assert {s.request_id for s in (outer, i1, i2, deeper)} == \
        {outer.span_id}
    got = spanview.self_ns(outer, [outer, i1, i2, deeper])
    assert got == spanview.wall_ns(outer) - spanview.wall_ns(i1) \
        - spanview.wall_ns(i2)


def test_the_ring_keeps_the_newest_spans_and_counts_the_rest():
    rec = spans.Recorder(size=8)
    t = []
    for i in range(20):
        with rec.span(f"s{i}"):
            pass
        t.append(rec.snapshot()[-1].t_start_ns)
    kept = rec.snapshot()
    assert [s.span_id for s in kept] == list(range(13, 21))
    assert rec.dropped == 12
    assert rec.totals()["s0"]["count"] == 1      # totals outlive the ring
    assert rec.complete_since(t[12] + 1) and not rec.complete_since(t[11])
    # A span overwritten while open closes without touching its slot's new
    # owner, and still counts in its name's totals.
    rec.open("long")
    for i in range(8):
        with rec.span("short"):
            pass
    assert rec.close() >= 0
    assert all(s.name == "short" and s.t_end_ns is not None
               for s in rec.snapshot())
    assert rec.totals()["long"]["count"] == 1


def test_threads_lose_no_span_and_keep_their_own_parents():
    rec = spans.Recorder(size=1 << 16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(k):
        for _ in range(300):
            with rec.span("root", request=spans.NEW_REQUEST):
                root = rec.current_span()
                with rec.span("child"):
                    if rec.current_request() != root:
                        errors.append(k)
                with rec.acting_for(("batch", k)):
                    with rec.span("member"):
                        pass

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert {n: v["count"] for n, v in rec.totals().items()} == \
        {"root": 4800, "child": 4800, "member": 4800}
    recorded = rec.snapshot()
    assert len(recorded) == 3 * 4800 and rec.dropped == 0
    by_id = {s.span_id: s for s in recorded}
    for s in recorded:
        if s.name == "child":
            assert by_id[s.parent_id].name == "root"
            assert s.request_id == s.parent_id
        elif s.name == "member":
            assert s.request_id[0] == "batch"


# ─────────────────────────────────────────────────────────────────────────────
# The benchmark's span readers
# ─────────────────────────────────────────────────────────────────────────────
def _reader(name):
    path = os.path.join(ROOT, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


_READERS = ("handler_self_ms", "quote.queue_ms", "launch_offcpu_share",
            "sync_ms", "idle_launching_share")
MS = 1_000_000
#: Profiler clock minus monotonic clock, in the synthetic run.
OFFSET = 5_000 * MS


def _request(rec, t, queue_ms, program_ms, cpu_ms, sync_ms):
    """One quote as the server records it, opened at `t` ns: parse 1 ms,
    then the handler's 2 ms of its own, its submit (queue, then a program
    and the copy), 1 ms more of its own, the send."""
    root = rec.record("http.request", t, t + 100 * MS,
                      request=spans.NEW_REQUEST, parent=None)
    rec.record("http.parse", t, t + MS, request=root, parent=root)
    h0 = t + MS
    run = queue_ms + program_ms + sync_ms
    handler = rec.record("handler", h0, h0 + (3 + run) * MS, request=root,
                         parent=root)
    sub0 = h0 + 2 * MS
    sub = rec.record("coalesce.submit", sub0, sub0 + run * MS, request=root,
                     parent=handler)
    rec.record("coalesce.queue", sub0, sub0 + queue_ms * MS, request=root,
               parent=sub)
    p0 = sub0 + queue_ms * MS
    rec.record("program.price", p0, p0 + program_ms * MS, request=root,
               parent=sub, cpu_ns=cpu_ms * MS)
    s0 = p0 + program_ms * MS
    rec.record("host.sync", s0, s0 + sync_ms * MS, request=root, parent=sub)
    rec.record("http.send", h0 + (3 + run) * MS, h0 + (3 + run) * MS + MS,
               request=root, parent=root)


@pytest.fixture
def synthetic(monkeypatch):
    rec = spans.Recorder(size=256)
    monkeypatch.setattr(spans, "RECORDER", rec)
    monkeypatch.setattr(spans, "profiler_clock_offset_ns", lambda: OFFSET)
    t0 = 10_000 * MS
    # One request before the window, three in it, one after.
    for i, (q, p, c, y) in enumerate([(50, 50, 50, 50), (10, 20, 5, 4),
                                      (30, 40, 10, 6), (20, 60, 30, 8),
                                      (70, 70, 70, 70)]):
        _request(rec, t0 + (i - 1) * 1000 * MS + 1, q, p, c, y)
    kernels = [("k", OFFSET + t0 + 3050 * MS, 10 * MS),
               ("k", OFFSET + t0 + 3100 * MS, 20 * MS)]
    run = SimpleNamespace(
        t0=t0 / 1e9, t1=(t0 + 3000 * MS) / 1e9,
        slice={"t_start": (t0 + 3050 * MS) / 1e9,
               "t_end": (t0 + 3150 * MS) / 1e9, "kernels": kernels})
    return rec, run


def test_span_readers_on_a_synthetic_run(synthetic):
    rec, run = synthetic
    got = {name: _reader(name)(run) for name in _READERS}
    # Handler self time: 2 ms before the submit and 1 ms after it.
    assert got["handler_self_ms"] == pytest.approx(3.0)
    assert got["quote.queue_ms"] == pytest.approx(20.0)
    # Programs 20 + 40 + 60 ms wall, 5 + 10 + 30 ms CPU.
    assert got["launch_offcpu_share"] == pytest.approx(100 * 75 / 120)
    assert got["sync_ms"] == pytest.approx(6.0)
    # The slice [3050, 3150] ms: kernels cover [3050, 3060] and
    # [3100, 3120], idle 70 ms. The fifth request's program runs over
    # [3073, 3143] ms: 27 + 23 ms of the idle time.
    assert got["idle_launching_share"] == pytest.approx(100 * 50 / 70)


@pytest.mark.parametrize("lost", ["the window", "the window and the slice"])
def test_span_readers_read_nothing_from_a_partial_ring(synthetic, lost):
    """20 spans lost take the window's first request and part of its
    second: the window's readers read nothing, the slice's still reads;
    with every span lost, the slice's reads nothing too."""
    rec, run = synthetic
    t = int(run.t1 * 1e9) + 2000 * MS
    extra = rec.size - 20 if lost == "the window" else rec.size
    for i in range(extra):
        rec.record("filler", t + i, t + i + 1, request=None, parent=None)
    assert rec.dropped == 40 + extra - rec.size
    for name in _READERS[:-1]:
        assert _reader(name)(run) is None, name
    slice_read = _reader("idle_launching_share")(run)
    if lost == "the window":
        assert slice_read == pytest.approx(100 * 50 / 70)
    else:
        assert slice_read is None


def test_span_readers_read_nothing_without_the_recorder(synthetic,
                                                        monkeypatch):
    _, run = synthetic
    # As in a program older than the recorder: the import fails.
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "mcos_tpu_torch.utils.spans", None)
    for name in _READERS:
        assert _reader(name)(run) is None, name


# ─────────────────────────────────────────────────────────────────────────────
# GET /api/metrics' histogram
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("latencies", [
    [float(ms) for ms in range(1, 1001)],
    [0.05] * 60 + [3.0] * 35 + [2500.0] * 4 + [4e6],
], ids=["uniform", "below-and-above-the-buckets"])
def test_metrics_histogram_percentiles_on_known_latencies(latencies):
    m = pserver._Metrics()
    for i, ms in enumerate(latencies):
        m.observe("/api/x", ms, ok=i % 10 != 0)
    st = m.snapshot()["endpoints"]["/api/x"]
    ordered = sorted(latencies)
    assert st["count"] == len(latencies)
    assert st["errors"] == len(latencies[::10])
    assert st["max_ms"] == pytest.approx(max(latencies))
    for p in (50, 95, 99):
        true = ordered[-(-p * len(ordered) // 100) - 1]
        got = st[f"p{p}_ms"]
        # The bucket's upper edge: never below, under 2^(1/8) above.
        assert true - 0.01 <= got <= max(true * 2 ** 0.125, 0.1) + 0.01, p
        assert got <= st["max_ms"]
