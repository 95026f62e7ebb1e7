"""`POST /api/american` and `POST /api/pde` of the port against the JAX
package's handlers, on the CPU.

The same response keys at every level, nested blocks included, and the
same 400s. `/api/pde` is deterministic: every number equal to 1e-4
relative (float32 grids on both sides). `/api/american`'s Monte Carlo
fields come from different streams (the port's generators, the
reference's keys), so they are held within 4 combined standard errors;
its deterministic blocks (the COS oracle, the Crank-Nicolson boundary,
the step and path counts) are equal."""

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

torch.set_num_threads(1)

_AM = {"spot": 100.0, "strike": 105.0, "T": 0.25, "is_call": False,
       "num_paths": 4000}
_PDE = {"spot": 100.0, "strike": 105.0, "T": 0.5, "n_x": 51, "n_v": 21,
        "n_t": 16}


def _keys(got, ref, path=""):
    """The same keys at every level of nesting."""
    assert got.keys() == ref.keys(), path
    for k, v in ref.items():
        if isinstance(v, dict):
            _keys(got[k], v, f"{path}.{k}")


def _equal(got, ref, rel=1e-4, path=""):
    """Every deterministic value equal (floats to `rel`, NaN where NaN)."""
    if isinstance(ref, dict):
        assert got.keys() - {"elapsed_ms"} == ref.keys() - {"elapsed_ms"}
        for k in ref:
            if k != "elapsed_ms":
                _equal(got[k], ref[k], rel, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _equal(g, r, rel, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        if np.isnan(ref):
            assert np.isnan(got), path
        else:
            assert got == pytest.approx(ref, rel=rel, abs=1e-6), path
    else:
        assert got == ref, path


def _within(got, ref, se_got, se_ref, k=4.0):
    assert abs(got - ref) <= k * np.hypot(se_got, se_ref), (got, ref)


def _both_american(body):
    return (pserver.handle_american(dict(body), device="cpu"),
            jserver.handle_american(dict(body)))


@pytest.mark.parametrize("case", [
    {},
    {"is_call": True, "params": {"q": 0.06}},
    {"exercise_every": 4},
    {"exercise_every": 999},
    {"dividends": [{"t": 0.1, "amount": 3.0}], "is_call": True},
    {"dividends": [{"t": 0.1, "amount": 0.03}],
     "dividend_kind": "proportional"},
    {"rate_curve": [{"t": 0.1, "r": 0.02}, {"t": 1.0, "r": 0.07}]},
])
def test_american_price_matches_jax(case):
    got, ref = _both_american(dict(_AM, **case))
    _keys(got, ref)
    for k in ("num_paths_used", "num_steps", "exercise_every", "intrinsic"):
        assert got.get(k) == ref.get(k), k
    for k in ("price", "mc_continuation"):
        _within(got[k], ref[k], got["std_error"], ref["std_error"])
    assert got["std_error"] == pytest.approx(ref["std_error"], rel=0.1)


def test_american_with_every_block_matches_jax():
    """with_bounds, with_greeks, with_cos_oracle and with_boundary in one
    request."""
    body = dict(_AM, with_bounds=True, with_greeks=True,
                with_cos_oracle=True, with_boundary=True, n_outer=256,
                n_inner=17)
    got, ref = _both_american(body)
    _keys(got, ref)
    _equal(got["cos_oracle"], ref["cos_oracle"], rel=1e-12)
    _equal(got["exercise_boundary"], ref["exercise_boundary"], rel=1e-5)
    b, rb = got["bounds"], ref["bounds"]
    for k in ("num_steps", "n_outer", "n_inner"):
        assert b[k] == rb[k]
    _within(b["lower_bound"], rb["lower_bound"], b["lower_se"],
            rb["lower_se"])
    _within(b["upper_bound"], rb["upper_bound"], b["upper_se"],
            rb["upper_se"])
    g, rg = got["greeks"], ref["greeks"]
    assert g["num_steps"] == rg["num_steps"]
    _within(g["price"], rg["price"], got["std_error"], ref["std_error"])
    assert g["delta"] == pytest.approx(rg["delta"], abs=0.05)
    assert all(np.isfinite(v) for v in g.values())


@pytest.mark.parametrize("body,detail", [
    (dict(_AM, with_bounds=True, dividends=[{"t": 0.1, "amount": 1.0}]),
     "with_bounds"),
    (dict(_AM, with_bounds=True, rate_curve=[{"t": 1.0, "r": 0.05}]),
     "with_bounds"),
    (dict(_AM, with_cos_oracle=True, dividends=[{"t": 0.1, "amount": 1.0}]),
     "with_cos_oracle"),
    (dict(_AM, with_cos_oracle=True, rate_curve=[{"t": 1.0, "r": 0.05}]),
     "with_cos_oracle"),
    (dict(_AM, with_boundary=True, dividends=[{"t": 0.1, "amount": 1.0}]),
     "proportional"),
    (dict(_AM, dividends=[{"t": 0.1, "amount": 1.5}],
          dividend_kind="proportional"), "dividends"),
])
def test_american_400s_match_jax(body, detail):
    with pytest.raises(pserver.ApiError) as got:
        pserver.handle_american(dict(body), device="cpu")
    with pytest.raises(jserver.ApiError) as ref:
        jserver.handle_american(dict(body))
    assert got.value.status == ref.value.status == 400
    assert got.value.detail == ref.value.detail
    assert detail in got.value.detail


@pytest.mark.parametrize("case", [
    {},
    {"with_oracle": True},
    {"scheme": "douglas", "is_call": False},
    {"american": True, "is_call": False, "with_boundary": True,
     "params": {"q": 0.03}},
    {"params": {"lambda_j": 1.5, "sigma_j": 0.2}, "with_oracle": True},
    {"barrier": 125.0},
    {"barrier": 85.0, "direction": "down", "is_call": False, "rebate": 1.0,
     "rebate_at_hit": True},
    {"barrier": 130.0, "barrier_lo": 80.0},
    {"barrier": 125.0, "knock": "in"},
    {"model": "bs"},
    {"model": "bs", "sigma": 0.3, "american": True, "is_call": False,
     "with_boundary": True},
])
def test_pde_matches_jax_line_for_line(case):
    body = dict(_PDE, **case)
    got = pserver.handle_pde(dict(body), device="cpu")
    ref = jserver.handle_pde(dict(body))
    _equal(got, ref, rel=1e-4)


@pytest.mark.parametrize("body", [
    dict(_PDE, params={"lambda_j": 1.0, "sigma_j": 0.0}),
    dict(_PDE, barrier=95.0),
    dict(_PDE, barrier=105.0, direction="down"),
    dict(_PDE, barrier=125.0, knock="in", rebate=1.0),
    dict(_PDE, barrier=125.0, knock="in", american=True),
])
def test_pde_400s_match_jax(body):
    with pytest.raises(pserver.ApiError) as got:
        pserver.handle_pde(dict(body), device="cpu")
    with pytest.raises(jserver.ApiError) as ref:
        jserver.handle_pde(dict(body))
    assert got.value.status == ref.value.status == 400
    assert got.value.detail == ref.value.detail


def test_routes_over_http_on_cpu():
    """/api/american and /api/pde are registered: 200, 400 and 422 over
    the stdlib transport."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), pserver._Handler)
    httpd.device = torch.device("cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, res = post("/api/american", dict(_AM, num_paths=2000))
        assert status == 200 and res["num_steps"] == 16
        assert np.isfinite(res["price"]) and res["std_error"] > 0
        status, res = post("/api/pde", _PDE)
        assert status == 200 and res["method"] == "adi-cs"
        assert post("/api/pde", dict(_PDE, barrier=95.0))[0] == 400
        assert post("/api/pde", dict(_PDE, model="sabr"))[0] == 422
        assert post("/api/american", dict(_AM, num_paths=10))[0] == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
