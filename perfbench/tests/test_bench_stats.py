"""The metric arithmetic: rates over the whole window, medians and tails
over all requests at once, the trace's reductions."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from perfbench import roofline, stats, trace

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metrics")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _rec(i, t_send, t_done, status=200):
    return [i, 0, t_send, t_done, status, ""]


def test_rate_is_all_the_work_over_the_whole_window():
    # 10 requests done in the first second of a 10-second window: 1 req/s,
    # not the 10 req/s of the busy second.
    recs = [_rec(i, 0.05 * i, 0.05 * i + 0.04) for i in range(10)]
    assert stats.rate(recs, 0.0, 10.0) == pytest.approx(1.0)


def test_rate_counts_neither_failures_nor_late_returns():
    recs = [_rec(0, 0.1, 0.2), _rec(1, 0.3, 0.4, 500), _rec(2, 0.5, 11.0)]
    assert stats.rate(recs, 0.0, 10.0) == pytest.approx(0.1)


def test_median_and_tail_are_over_all_requests_not_chunks():
    lat = [1.0] * 90 + [100.0] * 10
    recs = [_rec(i, i, i + lat[i] / 1e3) for i in range(100)]
    window = stats.sent_in(recs, 0, 100)
    ms = stats.latencies_ms(window)
    assert stats.median(ms) == pytest.approx(1.0)
    # Chunked medians of 10 would average to 10.9; a mean of chunk p95s
    # differs too. The tail is taken once, over all 100.
    assert stats.percentile(ms, 95) == pytest.approx(100.0)
    assert _reader("quote.p95_ms")(SimpleNamespace(window=window)) == \
        pytest.approx(100.0)
    assert _reader("p50_ms")(SimpleNamespace(window=window)) == \
        pytest.approx(1.0)


def test_a_request_sent_in_the_window_counts_however_late():
    recs = [_rec(0, 9.9, 30.0), _rec(1, 10.0, 10.5)]
    assert [r[0] for r in stats.sent_in(recs, 0.0, 10.0)] == [0]


@pytest.mark.parametrize("values,q,want", [
    ([3.0, 1.0, 2.0], 50, 2.0), ([1.0, 2.0, 3.0, 4.0], 50, 2.5),
    ([0.0, 10.0], 95, 9.5), ([5.0], 95, 5.0)])
def test_percentile_interpolates_between_order_statistics(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_batch_size_is_the_ratio_of_the_counters_rises():
    run = SimpleNamespace(counters={"start": (10, 14), "end": (30, 54)})
    assert _reader("quote.batch_size")(run) == pytest.approx(2.0)
    run = SimpleNamespace(counters={"start": (10, 14), "end": (10, 14)})
    assert _reader("quote.batch_size")(run) is None


def test_handler_median_takes_the_spans_entered_in_the_window():
    run = SimpleNamespace(t0=0.0, t1=10.0, spans=[
        (-1.0, 0.5), (1.0, 1.002), (2.0, 2.004), (3.0, 3.006),
        (10.0, 99.0)])
    assert _reader("handler_ms")(run) == pytest.approx(4.0)


def test_launches_count_the_requests_worth_done_in_the_slice():
    # A slice [10, 12] inside two requests of 4 s each, half of each in
    # it: one request's worth of work, 1000 kernels.
    run = SimpleNamespace(
        slice={"t_start": 10.0, "t_end": 12.0, "n_kernels": 1000},
        records=[_rec(0, 8.0, 12.0), _rec(1, 10.0, 14.0),
                 _rec(2, 1.0, 2.0)])
    assert _reader("launches_per_req")(run) == pytest.approx(1000.0)
    assert _reader("launches_per_req")(SimpleNamespace(slice=None)) is None


def _slice(events, t_start=0.0, t_end=1.0):
    s = trace.DeviceSlice.__new__(trace.DeviceSlice)
    s.t_start, s.t_end = t_start, t_end
    s.device_events = lambda: sorted(events, key=lambda e: e[1])
    return s.reduce()


def test_trace_busy_is_the_union_of_device_intervals():
    ns = 1_000_000
    red = _slice([("k_a", 0, 100 * ns), ("k_b", 50 * ns, 100 * ns),
                  ("Memcpy DtoH", 300 * ns, 10 * ns),
                  ("k_a", 500 * ns, 100 * ns)])
    assert red["busy_s"] == pytest.approx(0.26)
    assert red["n_kernels"] == 3
    assert red["device_ops"][0] == ["k_a", pytest.approx(0.2)]
    assert red["idle_gaps"][0] == ["after Memcpy DtoH", pytest.approx(0.19)]
    idle = _reader("device_idle_share")(SimpleNamespace(slice=red))
    assert idle == pytest.approx(74.0)


def test_k1_roofline_pairs_traced_kernels_with_recorded_launches():
    shape = {"members": 1, "steps": 62, "paths": 500_000, "n_branch": 2,
             "companion": True, "streamed_u": False}
    least = roofline.k1_least_s(**shape)
    kernels = [("void svj_draws_kernel<4>(float const*)", 0,
                int(2 * least * 1e9))]
    run = SimpleNamespace(slice={"kernels": kernels}, k1_shapes=[shape])
    assert _reader("k1_roofline")(run) == pytest.approx(50.0, rel=1e-4)
    run.k1_shapes = [shape, shape]
    assert _reader("k1_roofline")(run) is None


def test_k1_bound_is_chip_smokes_main_path_bound():
    # chip_smoke.py: bound("svj_terminal_from_draws", steps * N,
    # 3 * steps * N * 4, 3 * 2 * N * 4) at N = 500 000, 63 steps.
    n, s = 500_000, 63
    want = roofline.bound("svj_terminal_from_draws", s * n, 3 * s * n * 4,
                          3 * 2 * n * 4)["bound_ms"]
    assert roofline.k1_least_s(1, s, n, 2, True, False) * 1e3 == \
        pytest.approx(want)
    assert want == pytest.approx(0.1164, abs=1e-4)
