"""`POST /api/exotic` of the port against the JAX package's handler: the
same response keys, every 400 the same, and prices within 4 combined
standard errors (the PRNG streams differ between the two packages)."""

import inspect
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import mcos_tpu.api.server as jserver
import mcos_tpu_torch.api.server as pserver
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import simulate as psim
from mcos_tpu_torch.ops import sobol as psobol

torch.set_num_threads(1)

_BASE = {"spot": 100.0, "T": 0.1, "num_paths": 8000}
_UP, _LO = 108.0, 93.0

_BODIES = {
    "asian": dict(kind="asian", strike=100.0),
    "asian_geometric_put": dict(kind="asian", strike=101.0, is_call=False,
                                averaging="geometric"),
    "barrier_discrete": dict(kind="barrier", strike=100.0, barrier=_UP),
    "barrier_continuous_down_in": dict(kind="barrier", strike=100.0,
                                       barrier=_LO, knock="in",
                                       monitoring="continuous"),
    "barrier_bridge": dict(kind="barrier", strike=100.0, barrier=_UP,
                           monitoring="bridge"),
    "barrier_bridge_rebate_at_hit": dict(
        kind="barrier", strike=100.0, barrier=_UP, monitoring="bridge",
        rebate=2.0, rebate_at_hit=True),
    "barrier_window": dict(kind="barrier", strike=100.0, barrier=_UP,
                           window=[0.02, 0.08]),
    "one_touch_continuous": dict(kind="one_touch", barrier=_UP,
                                 monitoring="continuous"),
    "one_touch_bridge_at_hit": dict(kind="one_touch", barrier=_UP,
                                    monitoring="bridge", pay_at_hit=True),
    "one_touch_window": dict(kind="one_touch", barrier=_LO,
                             window=[0.02, 0.08]),
    "double_barrier": dict(kind="double_barrier", strike=100.0, barrier=_UP,
                           barrier_lo=_LO),
    "double_barrier_discrete_rebate": dict(
        kind="double_barrier", strike=100.0, barrier=_UP, barrier_lo=_LO,
        monitoring="discrete", rebate=1.5, knock="in"),
    "double_barrier_window": dict(kind="double_barrier", strike=100.0,
                                  barrier=_UP, barrier_lo=_LO,
                                  window=[0.02, 0.08]),
    "double_no_touch": dict(kind="double_no_touch", barrier=_UP,
                            barrier_lo=_LO),
    "double_one_touch_continuous": dict(kind="double_one_touch", barrier=_UP,
                                        barrier_lo=_LO,
                                        monitoring="continuous"),
    "double_no_touch_decided": dict(kind="double_no_touch", barrier=99.0,
                                    barrier_lo=90.0),
    "lookback_floating": dict(kind="lookback"),
    "lookback_fixed_put": dict(kind="lookback", strike=99.0, is_call=False),
    "digital": dict(kind="digital", strike=101.0),
    "variance_swap": dict(kind="variance_swap"),
}


def _se(res):
    return res.get("std_error", 0.0)


@pytest.mark.parametrize("name", list(_BODIES))
def test_handle_exotic_matches_jax(name):
    body = dict(_BASE, **_BODIES[name])
    before = dict(ck.launch_counts())
    got = pserver.handle_exotic(dict(body), device="cpu")
    assert ck.launch_counts() == before        # the CPU launches no kernel
    ref = jserver.handle_exotic(dict(body))
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        g = got[key]
        if key in ("price", "raw_mc_price"):
            tol = 4 * np.hypot(_se(got), _se(ref)) + 1e-9
            if key == "raw_mc_price":      # the raw estimate's own se is
                tol *= 4                   # not returned: a loose window
            assert abs(g - r) < tol, (key, g, r)
        elif key == "std_error":
            assert g == pytest.approx(r, rel=0.25, abs=1e-9)
        elif key in ("cv_beta", "delta"):
            assert g == pytest.approx(r, rel=0.3, abs=0.05)
        elif key in ("touch_probability", "stay_probability"):
            assert g == pytest.approx(r, abs=0.03)
        elif key == "elapsed_ms":
            assert g >= 0
        elif isinstance(r, float):         # closed forms and echoes
            assert g == pytest.approx(r, rel=1e-9, abs=1e-12), key
        else:
            assert g == r, key


_BAD = {
    "asian_no_strike": dict(kind="asian"),
    "window_on_asian": dict(kind="asian", strike=100.0, window=[0.0, 0.05]),
    "barrier_no_barrier": dict(kind="barrier", strike=100.0),
    "rebate_at_hit_knock_in": dict(kind="barrier", strike=100.0, barrier=_UP,
                                   knock="in", rebate=1.0,
                                   rebate_at_hit=True),
    "window_bad_order": dict(kind="barrier", strike=100.0, barrier=_UP,
                             window=[0.08, 0.02]),
    "window_with_rebate": dict(kind="barrier", strike=100.0, barrier=_UP,
                               window=[0.02, 0.08], rebate=1.0),
    "window_discrete": dict(kind="barrier", strike=100.0, barrier=_UP,
                            window=[0.02, 0.08], monitoring="discrete"),
    "barrier_unknown_monitoring_window": dict(
        kind="one_touch", barrier=_UP, window=[0.02, 0.08],
        monitoring="continuous"),
    "one_touch_no_barrier": dict(kind="one_touch"),
    "one_touch_window_at_hit": dict(kind="one_touch", barrier=_UP,
                                    window=[0.02, 0.08], pay_at_hit=True),
    "double_no_lower": dict(kind="double_barrier", strike=100.0,
                            barrier=_UP),
    "double_crossed": dict(kind="double_barrier", strike=100.0, barrier=_LO,
                           barrier_lo=_UP),
    "double_rebate_at_hit": dict(kind="double_barrier", strike=100.0,
                                 barrier=_UP, barrier_lo=_LO,
                                 rebate_at_hit=True),
    "double_window_past_T": dict(kind="double_barrier", strike=100.0,
                                 barrier=_UP, barrier_lo=_LO,
                                 window=[0.02, 0.5]),
    "double_window_discrete": dict(kind="double_barrier", strike=100.0,
                                   barrier=_UP, barrier_lo=_LO,
                                   window=[0.02, 0.08],
                                   monitoring="discrete"),
    "dnt_no_barriers": dict(kind="double_no_touch"),
    "dnt_crossed": dict(kind="double_one_touch", barrier=_LO,
                        barrier_lo=_UP),
    "dnt_window_bad": dict(kind="double_no_touch", barrier=_UP,
                           barrier_lo=_LO, window=[-0.1, 0.05]),
    "dnt_window_discrete": dict(kind="double_no_touch", barrier=_UP,
                                barrier_lo=_LO, window=[0.02, 0.08],
                                monitoring="discrete"),
    "digital_no_strike": dict(kind="digital"),
    "unknown_kind": dict(kind="cliquet"),
}


@pytest.mark.parametrize("name", list(_BAD))
def test_every_400_is_the_reference_400(name):
    body = dict(_BASE, **_BAD[name])
    with pytest.raises(jserver.ApiError) as ref:
        jserver.handle_exotic(dict(body))
    with pytest.raises(pserver.ApiError) as got:
        pserver.handle_exotic(dict(body), device="cpu")
    assert (got.value.status, got.value.detail) == (400, ref.value.detail)
    assert ref.value.status == 400


@pytest.mark.parametrize("name,method,keys", [
    ("asian", "pathwise_ad", ("delta", "vega", "vega_v0", "rho")),
    ("lookback_floating", "pathwise_ad", ("delta", "vega", "rho")),
    ("barrier_discrete", "crn_fd_homogeneity", ("delta", "vega")),
    ("barrier_window", "pathwise_ad_bridge", ("delta", "vega", "rho")),
    ("one_touch_continuous", "pathwise_ad_bridge", ("delta", "vega")),
    ("double_no_touch", "pathwise_ad_bridge", ("delta", "vega", "rho")),
])
def test_with_greeks_matches_jax(name, method, keys):
    """Another stream on each side: the Greeks agree within Monte Carlo
    noise, taken here as 15 % of the value plus a small floor."""
    body = dict(_BASE, with_greeks=True, **_BODIES[name])
    got = pserver.handle_exotic(dict(body), device="cpu")["greeks"]
    ref = jserver.handle_exotic(dict(body))["greeks"]
    assert got.keys() == ref.keys()
    assert got["method"] == ref["method"] == method
    assert got["price"] == pytest.approx(ref["price"], rel=0.1, abs=0.02)
    for key in keys:
        floor = {"delta": 0.03, "rho": 0.3}.get(key, 1.5)
        assert got[key] == pytest.approx(ref[key], rel=0.15, abs=floor), key


def test_greeks_argument_errors():
    from mcos_tpu_torch.engine.exotics import ExoticEngine
    from mcos_tpu_torch.models.params import SVJParams

    eng = ExoticEngine(SVJParams(), num_paths=1000, device="cpu")
    for kw in (dict(kind="barrier", barrier=_UP, rebate=1.0),
               dict(kind="barrier", barrier=_UP, window=(0.02, 0.08)),
               dict(kind="barrier"),
               dict(kind="barrier", monitoring="bridge"),
               dict(kind="double_barrier", barrier=_UP, monitoring="bridge"),
               dict(kind="cliquet")):
        with pytest.raises(ValueError):
            eng.greeks(100.0, 100.0, 0.1, **kw)
    with pytest.raises(ValueError):
        ExoticEngine(SVJParams(), backend="pallas", device="cpu")


def test_engine_torch_backend_prices_the_same_law():
    """backend="torch" (the twin, the Greeks' path) against the default
    backend on the CPU (K6's plain version): within 4 combined se."""
    from mcos_tpu_torch.engine.exotics import ExoticEngine
    from mcos_tpu_torch.models.params import SVJParams

    kw = dict(num_paths=8000, device="cpu")
    a = ExoticEngine(SVJParams(), **kw).price_barrier(
        100.0, 100.0, 0.1, _UP, monitoring="bridge")
    b = ExoticEngine(SVJParams(), backend="torch", **kw).price_barrier(
        100.0, 100.0, 0.1, _UP, monitoring="bridge")
    assert a.keys() == b.keys()
    assert abs(a["price"] - b["price"]) < 4 * np.hypot(a["std_error"],
                                                      b["std_error"])


def test_exotic_route_over_http():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), pserver._Handler)
    httpd.device = torch.device("cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/exotic"

    def call(body):
        req = urllib.request.Request(url, data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, res = call(dict(_BASE, **_BODIES["double_no_touch"]))
        assert status == 200 and 0.0 < res["stay_probability"] < 1.0
        status, res = call(dict(_BASE, kind="barrier", strike=100.0))
        assert status == 400 and "barrier" in res["detail"]
        assert call(dict(_BASE, kind="asian", num_paths=10))[0] == 422
        assert call({"spot": 100.0})[0] == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("fn", [
    psobol.sobol_svj_draws, psobol.sobol_qe_draws, psim.simulate_terminal,
    psim.simulate_paths_recorded, psim.simulate_terminal_qe,
    psim.simulate_terminal_tilted])
def test_ops_level_programs_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("fn", [
    ck.gbm_terminal_plain, ck.svj_terminal_plain, ck.svj_terminal_qe_plain])
def test_plain_versions_keep_the_cpu_default(fn):
    assert inspect.signature(fn).parameters["device"].default == "cpu"
