"""`/api/stress`, `/api/regime`, `/api/hedge` and `/api/var` of the port
against the JAX handlers on CPU: the same keys, the same 400s, values within
5 combined standard errors where the Monte Carlo streams differ and equal
where they do not (the regime); the settled difference, a correlation
matrix that is not positive definite (JAX: 200 with NaN figures; the port:
400); the four routes over the port's HTTP server."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mcos_tpu.api import server as jserver
from mcos_tpu.engine import risk as jrisk
from mcos_tpu_torch.api import schemas as pschemas
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.engine import risk as prisk
from mcos_tpu_torch.engine.pricer import MonteCarloEngine
from mcos_tpu_torch.ops import cuda_kernels

torch.set_num_threads(1)

SPOT, T = 100.0, 0.05                 # 12 steps (days) at 252 a year
STRESS = {"spot": SPOT, "strike": 102.0, "T": T, "num_paths": 8192}
HEDGE = {"spot": SPOT, "strike": SPOT, "T": T, "num_scenarios": 2000}
BOOK = {"spots": [100.0, 80.0, 120.0], "sigmas": [0.2, 0.35, 0.15],
        "weights": [0.4, 0.35, 0.25],
        "corr": [[1.0, 0.5, 0.1], [0.5, 1.0, 0.3], [0.1, 0.3, 1.0]],
        "T": 0.05, "num_paths": 100_000}
NOT_PD = [[1.0, 1.5], [1.5, 1.0]]
K = 5 * np.sqrt(2.0)                  # 5 se of a difference of two streams


def _port(handler, body):
    return getattr(pserver, handler)(json.loads(json.dumps(body)),
                                     device="cpu")


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, row in enumerate(v):
                if isinstance(row, dict):
                    out.update(_flat(row, f"{prefix}{k}[{i}]."))
                elif isinstance(row, list):
                    out.update(_flat(dict(enumerate(row)),
                                     f"{prefix}{k}[{i}]."))
                else:
                    out[f"{prefix}{k}[{i}]"] = row
        else:
            out[prefix + str(k)] = v
    return out


def _stress_se(body):
    """The largest standard error among the prices of a default stress
    report at this width: the spot axis' (× 1 + shock) and each vol
    member's, from the port's engine in process (the handler's seed)."""
    eng = prisk.StressTestEngine(
        pschemas.StressRequest(**body).params.to_params(),
        num_paths=body["num_paths"], device="cpu")
    shocks = np.array([0.0, -0.08, 0.08, -0.3, 0.6])
    rel, res = eng._shock_prices_device(SPOT, body["strike"], T, True,
                                        shocks)
    se = [float(x) for x in res["std_error"] * torch.from_numpy(rel)]
    for m in eng._vol_members()[0]:
        se.append(float(eng._engine(m)._price_result(
            SPOT, [body["strike"]], T, True)["std_error"][0]))
    return max(se)


@pytest.fixture(scope="module")
def stress_se():
    return _stress_se(STRESS)


def _compare_stress(got, ref, se):
    a, b = _flat(got), _flat(ref)
    assert a.keys() == b.keys()
    for k in b:
        if k == "elapsed_ms":
            continue
        leaf = k.rsplit(".", 1)[-1]
        if "price" in leaf or k.startswith("prices"):
            tol = K * se
        elif "pnl" in leaf and "pct" not in leaf or k.startswith("pnl"):
            tol = 2 * K * se
        elif leaf == "pnl_pct":
            tol = 2 * K * se / a["jump_scenario.base_price"] * 100
        else:
            assert a[k] == b[k], k
            continue
        assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k], tol)


def test_handle_stress_report_matches_jax(stress_se):
    ref = jserver.handle_stress(dict(STRESS))
    got = _port("handle_stress", STRESS)
    _compare_stress(got, ref, stress_se)


@pytest.mark.parametrize("axes", [{}, {"spot_shocks": [-0.3, 0.6],
                                       "vol_shocks": [-0.1, 0.25]}])
def test_handle_stress_matrix_matches_jax(stress_se, axes):
    body = dict(STRESS, mode="matrix", **axes)
    ref = jserver.handle_stress(dict(body))
    got = _port("handle_stress", body)
    _compare_stress(got, ref, stress_se)
    report = _port("handle_stress", STRESS)
    assert got["base_price"] == pytest.approx(
        report["jump_scenario"]["base_price"], rel=1e-6)


def test_stress_launches_k3_as_counted(monkeypatch):
    """backend="cuda" on the CPU runs K3's plain version: once for the spot
    axis and once a shocked vol member (report), once a vol row
    (matrix)."""
    calls = []
    plain = cuda_kernels.svj_terminal_plain

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(cuda_kernels, "svj_terminal_plain", counting)
    _port("handle_stress", dict(STRESS, num_paths=1024))
    assert len(calls) == 1 + 2
    calls.clear()
    _port("handle_stress", dict(STRESS, num_paths=1024, mode="matrix",
                                vol_shocks=[-0.1, 0.05, 0.2]))
    assert len(calls) == 4


def test_handle_regime_equal():
    for body in ({"realized_vol": 0.12, "iv_percentile": 25,
                  "skew_slope": 0.02},
                 {"realized_vol": 0.35, "iv_percentile": 85,
                  "skew_slope": -0.12},
                 {"realized_vol": 0.22, "iv_percentile": 60,
                  "skew_slope": 0.06}):
        assert _port("handle_regime", body) == jserver.handle_regime(
            dict(body))


def _premium_se(body, dynamics):
    """The premium's standard error at the handler's width."""
    req = pschemas.HedgeRequest(**body)
    p = req.params.to_params()
    if dynamics == "rough":
        from mcos_tpu_torch.ops.rough import (RoughBergomiParams,
                                              rbergomi_chol_device,
                                              rbergomi_conditional_payoffs)
        from mcos_tpu_torch.engine.pricer import seeded_generator

        rp = RoughBergomiParams(xi=p.v0, eta=1.9, rho=-0.9, r=p.r, q=p.q,
                                hurst=0.07)
        n = max(int(T * 252), 1)
        pay = rbergomi_conditional_payoffs(
            rp, SPOT, [SPOT], T, rbergomi_chol_device(0.07, T, n,
                                                      device="cpu"),
            seeded_generator(43, "cpu"), num_paths=50_000, num_steps=n,
            is_call=True, device="cpu")
        pair = pay.mean(0)[:, 0]
        return float(np.exp(-p.r * T) * pair.std() / np.sqrt(pair.numel()))
    return MonteCarloEngine(p, num_paths=50_000, use_sobol=False,
                            device="cpu").price(SPOT, SPOT, T)["std_error"]


@pytest.mark.parametrize("dynamics,hedge", [
    ("gbm", "bs_delta"), ("gbm", "mv_delta"), ("gbm", "ww_band"),
    ("svj", "bs_delta"), ("svj", "mv_delta"), ("svj", "ww_band"),
    ("rough", "bs_delta")])
def test_handle_hedge_matches_jax(dynamics, hedge):
    body = dict(HEDGE, dynamics=dynamics, hedge=hedge)
    ref = jserver.handle_hedge(dict(body))
    got = _port("handle_hedge", body)
    assert _flat(got).keys() == _flat(ref).keys()
    for k in ("dynamics", "hedge", "num_scenarios"):
        assert got[k] == ref[k]
    assert all(np.isfinite(v) for k, v in _flat(got).items()
               if k not in ("dynamics", "hedge")
               and k != "risk_metrics.tail_index")
    n = body["num_scenarios"]
    se_p = _premium_se(body, dynamics)
    assert abs(got["premium"] - ref["premium"]) <= K * se_p
    std = max(got["std_pnl"], ref["std_pnl"])
    assert abs(got["mean_pnl"] - ref["mean_pnl"]) <= K * (std / np.sqrt(n)
                                                          + se_p)
    kurt = max(got["risk_metrics"]["kurtosis"], ref["risk_metrics"]["kurtosis"])
    se_std = std * np.sqrt(max(kurt - 1.0, 0.0) / (4 * n))
    assert abs(got["std_pnl"] - ref["std_pnl"]) <= K * se_std
    assert got["total_txn_cost_avg"] > 0


def test_hedge_pins_of_the_reference():
    """ww_band at zero cost equals bs_delta (tests/test_ww_band.py); at
    rho = 0 the mv hedge equals bs_delta (tests/test_mv_delta.py)."""
    free = dict(HEDGE, txn_cost_bps=0.0, slippage_bps=0.0)
    for dyn in ("gbm", "svj"):
        a = _port("handle_hedge", dict(free, dynamics=dyn))
        b = _port("handle_hedge", dict(free, dynamics=dyn, hedge="ww_band"))
        a.pop("elapsed_ms"), b.pop("elapsed_ms")
        b["hedge"] = a["hedge"]
        np.testing.assert_equal(a, b)
    zero_rho = dict(HEDGE, dynamics="svj", params={"rho": 0.0})
    a = _port("handle_hedge", zero_rho)
    b = _port("handle_hedge", dict(zero_rho, hedge="mv_delta"))
    assert a["mean_pnl"] == b["mean_pnl"] and a["std_pnl"] == b["std_pnl"]


def _var_tol(n, confidence=0.99):
    """Relative 5 combined se of a normal tail quantile at n paths."""
    from scipy.stats import norm

    z = norm.ppf(confidence)
    return K * np.sqrt(confidence * (1 - confidence) / n) / norm.pdf(z) / z


def test_handle_var_contributions_matches_jax():
    ref = jserver.handle_var(dict(BOOK))
    got = _port("handle_var", BOOK)
    assert got.keys() == ref.keys()
    tol = _var_tol(BOOK["num_paths"])
    for k in ("var", "cvar"):
        assert got[k] == pytest.approx(ref[k], rel=tol), k
    assert sum(got["component_cvar"]) == pytest.approx(got["cvar"], rel=1e-5)
    assert sum(got["component_var"]) == pytest.approx(got["var"], rel=1e-5)
    # the normal oracle of tests/test_risk_regime_guards.py at this width
    s, w = np.array(BOOK["sigmas"]), np.array(BOOK["weights"])
    cov = np.outer(s, s) * np.array(BOOK["corr"]) * BOOK["T"]
    pct = w * (cov @ w) / (w @ cov @ w) * 100
    np.testing.assert_allclose(got["component_cvar_pct"], pct, atol=4.0)
    for k in ("confidence", "num_paths_used"):
        assert got[k] == ref[k]


@pytest.mark.parametrize("extra", [
    {"with_contributions": False},
    {"copula": "student_t", "nu": 4.0},
    {"copula": "student_t", "nu": 300.0, "with_contributions": False},
])
def test_handle_var_matches_jax(extra):
    """The JAX handler's keys on one device (its Gaussian path without
    contributions shards over every visible device; the port's sharding
    waits for its slice)."""
    from mcos_tpu.parallel.mesh import make_mesh

    body = dict(BOOK, **extra)
    got = _port("handle_var", body)
    req = pschemas.VarRequest(**body)
    ref = jrisk.portfolio_var(
        req.spots, req.sigmas, np.asarray(req.corr), req.weights, req.T,
        r=req.r, q=req.q, num_paths=req.num_paths,
        confidence=req.confidence, mesh=make_mesh(jax.devices()[:1]),
        copula=req.copula, nu=req.nu)
    assert got.keys() == set(ref) | {"elapsed_ms"}
    tol = _var_tol(BOOK["num_paths"])
    for k in ("var", "cvar"):
        assert got[k] == pytest.approx(ref[k], rel=tol), k
    assert got["std"] == pytest.approx(ref["std"], rel=K / np.sqrt(
        2 * BOOK["num_paths"]) * 2)
    if "copula" in extra:
        assert got["copula"] == ref["copula"] and got["nu"] == ref["nu"]


_400 = [
    ("handle_stress", dict(STRESS, mode="matrix", spot_shocks=[-0.95])),
    ("handle_stress", dict(STRESS, mode="matrix", spot_shocks=[0.1, 4.0])),
    ("handle_stress", dict(STRESS, mode="matrix", vol_shocks=[1.5])),
    ("handle_stress", dict(STRESS, mode="matrix", vol_shocks=[-1.01])),
    ("handle_hedge", dict(HEDGE, dynamics="rough", hedge="mv_delta")),
    ("handle_hedge", dict(HEDGE, dynamics="rough", hedge="ww_band")),
    ("handle_hedge", dict(HEDGE, hedge="gamma_neutral")),
    ("handle_var", dict(BOOK, weights=[0.5, 0.5])),
    ("handle_var", dict(BOOK, sigmas=[0.2])),
    ("handle_var", dict(BOOK, corr=[[1.0, 0.0], [0.0, 1.0]])),
]


@pytest.mark.parametrize("handler,body", _400)
def test_bad_requests_answer_400_as_jax(handler, body):
    with pytest.raises(jserver.ApiError) as ref:
        getattr(jserver, handler)(dict(body))
    with pytest.raises(pserver.ApiError) as got:
        _port(handler, body)
    assert ref.value.status == got.value.status == 400
    assert got.value.detail == ref.value.detail


@pytest.mark.parametrize("extra", [{}, {"with_contributions": False},
                                   {"copula": "student_t"}])
def test_hazard_var_correlation_not_positive_definite_answers_400(extra):
    """The JAX handler takes the Cholesky factor of `corr` unchecked
    (risk.py:675, :726): a matrix that is not positive definite answers 200
    with every figure NaN. The port answers 400."""
    body = {"spots": [100.0, 100.0], "sigmas": [0.2, 0.2],
            "weights": [0.5, 0.5], "corr": NOT_PD, "T": 0.1,
            "num_paths": 4096, **extra}
    if extra.get("with_contributions") is False:
        from mcos_tpu.parallel.mesh import make_mesh

        ref = jrisk.portfolio_var(body["spots"], body["sigmas"],
                                  np.asarray(NOT_PD), body["weights"], 0.1,
                                  num_paths=4096,
                                  mesh=make_mesh(jax.devices()[:1]))
    else:
        ref = jserver.handle_var(dict(body))
    assert np.isnan(ref["var"]) and np.isnan(ref["cvar"])
    with pytest.raises(pserver.ApiError) as got:
        _port("handle_var", body)
    assert got.value.status == 400
    assert "positive definite" in got.value.detail
    with pytest.raises(pserver.ApiError) as asym:
        _port("handle_var", dict(body, corr=[[1.0, 0.2], [0.3, 1.0]]))
    assert asym.value.status == 400


@pytest.mark.parametrize("extra", [{}, {"copula": "student_t", "nu": 4.0}])
def test_var_corr_symmetric_to_rounding_answers_200_as_jax(extra):
    """A `corr` asymmetric at 1e-9 (decimal or float32 rounding at the
    client) answers 200 in both packages, with the same figures within 5
    combined se: the port symmetrizes it as JAX's `cholesky` does."""
    corr = [[1.0, 0.5, 0.1], [0.5 + 1e-9, 1.0, 0.3], [0.1, 0.3 - 1e-9, 1.0]]
    body = dict(BOOK, corr=corr, num_paths=20_000, **extra)
    ref = jserver.handle_var(dict(body))
    got = _port("handle_var", body)
    assert got.keys() == ref.keys()
    tol = _var_tol(body["num_paths"])
    for k in ("var", "cvar"):
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(ref[k], rel=tol), k


def test_risk_desk_routes_over_http(monkeypatch):
    monkeypatch.setattr(pserver, "warm", lambda device: None)
    httpd = pserver.serve("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, res = call("/api/stress", dict(STRESS, num_paths=1024))
        assert status == 200 and len(res["spot_shocks"]) == 6
        status, res = call("/api/stress", dict(STRESS, num_paths=1024,
                                               mode="matrix"))
        assert status == 200 and np.isfinite(res["prices"]).all()
        status, res = call("/api/regime", {"realized_vol": 0.35,
                                           "iv_percentile": 85,
                                           "skew_slope": 0.12})
        assert status == 200 and res["regime"] == "crisis"
        status, res = call("/api/hedge", dict(HEDGE, num_scenarios=64,
                                              dynamics="svj"))
        assert status == 200 and np.isfinite(res["mean_pnl"])
        status, res = call("/api/var", dict(BOOK, num_paths=4096))
        assert status == 200 and res["cvar"] >= res["var"] > 0
        status, res = call("/api/var", dict(BOOK, num_paths=4096,
                                            corr=[[1.0, 1.5, 0.0],
                                                  [1.5, 1.0, 0.0],
                                                  [0.0, 0.0, 1.0]]))
        assert status == 400 and "positive definite" in res["detail"]
        assert call("/api/regime", {"realized_vol": 0.1})[0] == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
