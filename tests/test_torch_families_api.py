"""`POST /api/hhw`, `/api/svcj` and `/api/termsvj` of the port against the
JAX package's handlers: the same response keys for every mode, the same
400s, deterministic fields equal, Monte Carlo fields within 4 combined
standard errors (the streams differ between the two packages), and
`termsvj`/`american` equal to the reference's on the JAX key's draws; plus
what the port answers differently on purpose: a 400 for an HHW
correlation matrix that is not positive definite."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from pydantic import ValidationError

import mcos_tpu.api.server as jserver
import mcos_tpu_torch.api.server as pserver
from mcos_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

_SEGMENTS = [{"t_end": 0.1, "theta": 0.04, "xi": 0.5, "lambda_j": 1.0},
             {"t_end": 0.2, "theta": 0.08, "xi": 0.8, "lambda_j": 4.0},
             {"t_end": 0.3, "theta": 0.05, "xi": 0.6, "lambda_j": 2.0}]
_HHW = {"spot": 100.0, "strike": 100.0, "T": 2.0, "num_paths": 4000,
        "num_steps": 16}
_SVCJ = {"spot": 100.0, "T": 0.25, "num_paths": 4000, "num_steps": 64}
_TD = {"spot": 100.0, "T": 0.3, "num_paths": 4000, "num_steps": 16,
       "segments": _SEGMENTS}

# (route, body): every mode that answers 200 in both packages.
_CASES = {
    "hhw_price": ("hhw", _HHW),
    "hhw_price_put": ("hhw", dict(_HHW, is_call=False, T=10.0)),
    "hhw_greeks": ("hhw", dict(_HHW, mode="greeks")),
    "hhw_impact": ("hhw", dict(_HHW, mode="impact")),
    "svcj_price": ("svcj", _SVCJ),
    "svcj_price_strike": ("svcj", dict(_SVCJ, strike=105.0, is_call=False)),
    "svcj_greeks": ("svcj", dict(_SVCJ, mode="greeks")),
    "svcj_smile": ("svcj", dict(_SVCJ, mode="smile")),
    "svcj_compare": ("svcj", dict(_SVCJ, mode="compare",
                                  strikes=[95.0, 100.0, 105.0])),
    "svcj_warned": ("svcj", dict(_SVCJ, params={"xi": 1.2})),
    "termsvj_price": ("termsvj", _TD),
    "termsvj_compare": ("termsvj", dict(_TD, mode="compare")),
    "termsvj_smile": ("termsvj", dict(_TD, mode="smile")),
    "termsvj_forward_start": ("termsvj", dict(_TD, mode="forward_start",
                                              t1=0.1, strike=1.02)),
    "termsvj_cliquet": ("termsvj", dict(_TD, mode="cliquet", n_periods=3,
                                        global_cap=0.15)),
    "termsvj_greeks": ("termsvj", dict(_TD, mode="greeks")),
    "termsvj_varswap": ("termsvj", dict(_TD, mode="varswap")),
    "termsvj_american": ("termsvj", dict(_TD, mode="american")),
}
# Fields that one seed's Monte Carlo estimate fills, with the field that
# holds its standard error (None: no error is returned, compared loosely).
_MC = {"price": "std_error", "mc_price": "std_error",
       "mc_continuation": "std_error",
       "raw_mc_price": None, "zero_coupon_mc": None,
       "price_deterministic_rates": "std_error",
       "stochastic_rates_premium": "std_error",
       "mc_fair_variance": "mc_std_error"}
_NOISY = ("std_error", "mc_std_error", "cv_beta", "delta", "vega", "dP_dv0",
          "vega_per_vol_point", "rate_vega", "rho_rate", "v_max",
          "err_sigmas", "abs_error_sigma", "mc_vs_closed_sigmas")


def _compare(got, ref, where=""):
    assert got.keys() == ref.keys(), where
    for key, r in ref.items():
        g, at = got[key], f"{where}.{key}"
        if isinstance(r, dict):
            _compare(g, r, at)
        elif isinstance(r, list) and r and isinstance(r[0], dict):
            assert len(g) == len(r), at
            for i, (gi, ri) in enumerate(zip(g, r)):
                _compare(gi, ri, f"{at}[{i}]")
        elif key in _MC:
            se = _MC[key]
            # a Greeks response carries a price and no error: 6 %
            tol = (4 * np.hypot(got[se], ref[se]) if se in got
                   else 0.06 * abs(r) + 1e-3)
            assert abs(g - r) < tol + 1e-9, (at, g, r)
        elif key in _NOISY:
            assert np.isfinite(g), at
            if key in ("std_error", "mc_std_error"):
                assert g == pytest.approx(r, rel=0.3), at
            elif key in ("delta", "vega", "vega_per_vol_point", "rho_rate"):
                assert g == pytest.approx(r, rel=0.25), at
        elif key == "elapsed_ms":
            assert g >= 0
        elif key == "bs_ref":              # float32 on the device
            assert g == pytest.approx(r, rel=1e-5), at
        elif isinstance(r, float):         # closed forms, oracles, echoes
            assert g == pytest.approx(r, rel=1e-9, abs=1e-12), at
        elif isinstance(r, list) and r and isinstance(r[0], (int, float)):
            np.testing.assert_allclose(
                np.asarray(g, float), np.asarray(r, float), rtol=1e-9,
                atol=1e-12, err_msg=at)
        else:
            assert g == r, at


@pytest.mark.parametrize("name", list(_CASES))
def test_handler_matches_jax(name):
    route, body = _CASES[name]
    before = dict(ck.launch_counts())
    got = getattr(pserver, f"handle_{route}")(dict(body), device="cpu")
    assert ck.launch_counts() == before        # the CPU launches no kernel
    ref = getattr(jserver, f"handle_{route}")(dict(body))
    json.dumps(got)                            # plain JSON types only
    _compare(got, ref, name)


_BAD = {
    "hhw_unknown_mode": ("hhw", dict(_HHW, mode="vega")),
    "svcj_unknown_mode": ("svcj", dict(_SVCJ, mode="calibrate")),
    "termsvj_unknown_mode": ("termsvj", dict(_TD, mode="surface")),
    "termsvj_no_segments": ("termsvj", {"spot": 100.0, "T": 0.3}),
    "termsvj_forward_start_no_t1": ("termsvj", dict(_TD,
                                                    mode="forward_start")),
    "termsvj_forward_start_late": ("termsvj", dict(_TD, mode="forward_start",
                                                   t1=0.3)),
    "termsvj_calibrate_nothing": ("termsvj", dict(_TD, mode="calibrate")),
    "termsvj_calibrate_no_strikes": ("termsvj", dict(
        _TD, mode="calibrate", maturities=[0.25], market_prices=[[5.0]])),
    "termsvj_calibrate_bad_shape": ("termsvj", dict(
        _TD, mode="calibrate", maturities=[0.25, 0.5], strikes=[100.0],
        market_prices=[[5.0]])),
}


@pytest.mark.parametrize("name", list(_BAD))
def test_handler_400s_match_jax(name):
    route, body = _BAD[name]
    with pytest.raises(jserver.ApiError) as ref:
        getattr(jserver, f"handle_{route}")(dict(body))
    with pytest.raises(pserver.ApiError) as got:
        getattr(pserver, f"handle_{route}")(dict(body), device="cpu")
    assert got.value.status == ref.value.status == 400
    assert got.value.detail == ref.value.detail


@pytest.mark.parametrize("route,body", [
    ("hhw", dict(_HHW, rho_sv=1.0)), ("hhw", dict(_HHW, num_steps=4)),
    ("hhw", dict(_HHW, T=31.0)),
    ("svcj", dict(_SVCJ, params={"mu_v": 0.5, "rho_j": 2.5})),
    ("svcj", dict(_SVCJ, T=11.0)),
    ("termsvj", dict(_TD, segments=list(reversed(_SEGMENTS)))),
    ("termsvj", dict(_TD, segments=[dict(_SEGMENTS[0], lambda_j=21.0)])),
])
def test_schema_refusals_match_jax(route, body):
    for server in (jserver, pserver):
        kw = {} if server is jserver else {"device": "cpu"}
        with pytest.raises(ValidationError):
            getattr(server, f"handle_{route}")(dict(body), **kw)


def test_hazard_hhw_correlation_not_positive_definite_answers_400():
    """(-0.999, 0.999, 0.999) passes the schema's per-field bounds. The
    reference prices it to NaN, silently; the port answers 400 naming the
    three correlations, for every mode."""
    body = dict(_HHW, rho_sv=-0.999, rho_sr=0.999, rho_vr=0.999)
    ref = jserver.handle_hhw(dict(body))
    assert np.isnan(ref["price"])
    for mode in ("price", "greeks", "impact"):
        with pytest.raises(pserver.ApiError) as err:
            pserver.handle_hhw(dict(body, mode=mode), device="cpu")
        assert err.value.status == 400
        for name in ("rho_sv", "rho_sr", "rho_vr", "positive definite"):
            assert name in err.value.detail


def _replayed(key, n, steps):
    """The JAX LSM recorder's per-step draws for `key`: fold_in(key, t) →
    split → normal (3, n), uniform (n,)."""
    import jax
    import jax.numpy as jnp

    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_norm, (3, n), jnp.float32),
                jax.random.uniform(k_unif, (n,), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def test_termsvj_american_answers_501(monkeypatch):
    """Ported (once a 501): `mode="american"` answers 200, and on the JAX
    key's draws (the engine's seed, 42) the Longstaff-Schwartz price under
    td dynamics equals the reference's: within half a standard error (the
    float32 regressions of the two packages flip a few exercise decisions
    that sit on their continuation to rounding), the same segments."""
    import jax

    import mcos_tpu_torch.engine.american as pam

    draws = _replayed(jax.random.PRNGKey(42), _TD["num_paths"],
                      _TD["num_steps"])
    monkeypatch.setattr(pam, "_euler_draws", lambda *a, **k: draws)
    got = pserver.handle_termsvj(dict(_TD, mode="american"), device="cpu")
    ref = jserver.handle_termsvj(dict(_TD, mode="american"))
    assert got.keys() == ref.keys()
    assert got["segments"] == ref["segments"]
    assert got["intrinsic"] == ref["intrinsic"] == 0.0
    assert abs(got["price"] - ref["price"]) < 0.5 * ref["std_error"]
    assert got["std_error"] == pytest.approx(ref["std_error"], rel=0.05)


def test_termsvj_american_501_names_its_slice_not_an_item_number():
    """Ported (once a 501 naming its slice): a Bermudan with no early date
    (exercise_every = num_steps) is the European td price, within 3
    standard errors of the chained-Riccati COS oracle."""
    from mcos_tpu_torch.engine.termsvj import TDSVJEngine
    from mcos_tpu_torch.models.params import SVJParams

    seg = _SEGMENTS
    eng = TDSVJEngine(SVJParams(), [s["t_end"] for s in seg],
                      [s["theta"] for s in seg], [s["xi"] for s in seg],
                      [s["lambda_j"] for s in seg], num_paths=20_000,
                      num_steps=64, device="cpu")
    for is_call in (False, True):
        got = eng.price_american(100.0, 100.0, 0.3, is_call,
                                 exercise_every=64)
        exact = float(eng.cos_chain(100.0, [100.0], 0.3, is_call)[0])
        assert abs(got["price"] - exact) < 3 * got["std_error"]
        assert got["price"] == got["mc_continuation"]


def test_termsvj_calibrate_keys_match_jax():
    """Host only (scipy differential evolution over `cos_price_td`): one
    maturity, the same seed, so the same fit."""
    from mcos_tpu_torch.ops.tdsvj import cos_price_td
    from mcos_tpu_torch.models.params import SVJParams

    strikes = [95.0, 100.0, 105.0]
    market = cos_price_td(SVJParams(), 100.0, strikes, 0.25, [0.25], [0.06],
                          [0.7], [2.0])
    body = {"spot": 100.0, "mode": "calibrate", "maturities": [0.25],
            "strikes": strikes, "market_prices": [market.tolist()]}
    got = pserver.handle_termsvj(dict(body), device="cpu")
    ref = jserver.handle_termsvj(dict(body))
    assert got.keys() == ref.keys()
    assert got["segments"] == ref["segments"]
    assert got["errors"] == ref["errors"]


def test_routes_over_http_on_cpu():
    """The three routes are registered: 200, 400 and 422 over the stdlib
    transport; `termsvj`/`american` answers 200."""
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
        status, res = post("/api/hhw", _HHW)
        assert status == 200 and res["num_steps"] == 16
        status, res = post("/api/svcj", _SVCJ)
        assert status == 200 and res["num_steps"] == 16
        status, res = post("/api/termsvj", _TD)
        assert status == 200 and np.isfinite(res["cos_price"])
        assert post("/api/hhw", dict(_HHW, rho_sv=-0.999, rho_sr=0.999,
                                     rho_vr=0.999))[0] == 400
        status, res = post("/api/termsvj", dict(_TD, mode="american"))
        assert status == 200 and np.isfinite(res["price"])
        assert res["segments"]["seg_ends"] == [0.1, 0.2, 0.3]
        assert post("/api/svcj", {"spot": -1.0, "T": 0.25})[0] == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
