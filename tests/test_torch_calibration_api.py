"""`POST /api/calibrate`, `/api/surface`, `/api/quotegreeks`,
`/api/localvol` and `/api/slv` of the port against the JAX package's
handlers, on the CPU.

The same response keys at every level, and the same 400s with the same
messages (and the same 422s where the schema refuses). `/api/quotegreeks`
is host float64 in both: every number equal to 1e-9. The IVs and the
arbitrage report of `/api/surface` are host float64 (1e-9); its SABR and
SSVI fits run differential evolution on different streams and are held by
outcome (within 2× the JAX fit's error + 1e-9). The Monte Carlo routes'
prices are held within 4 combined standard errors. `/api/calibrate` runs
at 1 000 paths with its DE cut to 8 steps, 6 members and 25 generations a
stage in both packages (patched the same way on both sides): at that size
a stage-2 fit lands anywhere from 1e-3 to 0.16 in either package as the
seed changes (a CPU run over seeds 0-4), so the handler is held
by its keys, generation counts, finite errors and parameters inside the
search box; the fits' outcome is pinned at 4 096 paths and the full
generation counts in tests/test_torch_calibration.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from pydantic import ValidationError

import mcos_tpu.api.server as jserver
import mcos_tpu.engine.calibration as jcal
import mcos_tpu_torch.api.server as pserver
import mcos_tpu_torch.engine.calibration as pcal
from mcos_tpu_torch.engine.american import binomial_american_bs
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.cos_pricer import cos_price

torch.set_num_threads(1)

SPOT, R, Q = 100.0, 0.05, 0.01
STRIKES = np.linspace(80.0, 120.0, 9)
MATS = np.array([0.25, 0.5, 1.0])


def _iv():
    k = np.log(STRIKES / SPOT)
    return 0.2 - 0.12 * k[None, :] + 0.15 * k[None, :] ** 2 \
        + 0.01 * np.sqrt(MATS)[:, None]


def _keys(got, ref, path=""):
    assert got.keys() == ref.keys(), path
    for k, v in ref.items():
        if isinstance(v, dict):
            _keys(got[k], v, f"{path}.{k}")


def _equal(got, ref, rel=1e-9, path=""):
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
        assert got == pytest.approx(ref, rel=rel, abs=1e-12), path
    else:
        assert got == ref, path


def _refused_alike(handler, body):
    with pytest.raises(pserver.ApiError) as got:
        getattr(pserver, handler)(dict(body), device="cpu")
    with pytest.raises(jserver.ApiError) as ref:
        getattr(jserver, handler)(dict(body))
    assert got.value.status == ref.value.status == 400
    assert got.value.detail == ref.value.detail
    return got.value.detail


# ─────────────────────────────────────────────────────────────────────────────
# /api/surface
# ─────────────────────────────────────────────────────────────────────────────
def _surface_body(**kw):
    iv = _iv()
    call = np.stack([bs_price(SPOT, STRIKES, t, R, Q, iv[i], True).numpy()
                     for i, t in enumerate(MATS)]).astype(np.float64)
    put = np.stack([bs_price(SPOT, STRIKES, t, R, Q, iv[i], False).numpy()
                    for i, t in enumerate(MATS)]).astype(np.float64)
    return dict({"spot": SPOT, "strikes": STRIKES.tolist(),
                 "maturities": MATS.tolist(), "call_prices": call.tolist(),
                 "put_prices": put.tolist(), "r": R, "q": Q}, **kw)


@pytest.mark.parametrize("case", [{"fit_ssvi": True},
                                  {"fit_sabr": False, "exercise": "american",
                                   "maturities": [0.25, 0.5]}])
def test_surface_matches_jax(case):
    body = _surface_body(**case)
    if case.get("exercise") == "american":
        body["call_prices"] = body["call_prices"][:2]
        body["put_prices"] = body["put_prices"][:2]
    got = pserver.handle_surface(dict(body), device="cpu")
    ref = jserver.handle_surface(dict(body))
    _keys(got, ref)
    for key in ("iv_call", "iv_put", "valid_mask", "arbitrage_report"):
        _equal(got[key], ref[key], path=key)
    if "sabr_fits" in ref:
        assert got["sabr_fits"].keys() == ref["sabr_fits"].keys()
        for T, fit in ref["sabr_fits"].items():
            assert got["sabr_fits"][T]["error"] <= 2 * fit["error"] + 1e-9
    if "ssvi_fit" in ref:
        assert got["ssvi_fit"]["objective"] <= \
            2 * ref["ssvi_fit"]["objective"] + 1e-9
        _equal(got["ssvi_fit"]["theta"], ref["ssvi_fit"]["theta"], rel=1e-6)


def test_surface_ssvi_needs_two_rows_as_jax():
    body = _surface_body(fit_sabr=False, fit_ssvi=True,
                         maturities=[0.5])
    body["call_prices"] = body["call_prices"][1:2]
    body["put_prices"] = body["put_prices"][1:2]
    got = pserver.handle_surface(dict(body), device="cpu")
    ref = jserver.handle_surface(dict(body))
    assert got["ssvi_fit"] == ref["ssvi_fit"]


def test_surface_schema_refusal_matches_jax():
    body = _surface_body(exercise="bermudan")
    with pytest.raises(ValidationError):
        pserver.handle_surface(dict(body), device="cpu")
    with pytest.raises(ValidationError):
        jserver.handle_surface(dict(body))


# ─────────────────────────────────────────────────────────────────────────────
# /api/calibrate
# ─────────────────────────────────────────────────────────────────────────────
@pytest.fixture
def small_de(monkeypatch):
    """The handler's calibrate cut to 8 steps, 6 members and 25
    generations a stage, alike in both packages."""
    for mod in (pcal, jcal):
        orig = mod.CalibrationEngine.calibrate

        def cut(self, *a, _orig=orig, **k):
            self.config = dataclasses.replace(
                self.config, stage1_max_iter=100, stage2_max_iter=100)
            return _orig(self, *a, num_steps=8, pop_size=6, **k)

        monkeypatch.setattr(mod.CalibrationEngine, "calibrate", cut)


TRUE = dict(kappa=2.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.045, lambda_j=0.8,
            mu_j=-0.08, sigma_j=0.12, r=R, q=Q)


def test_calibrate_matches_jax_by_outcome(small_de):
    market = cos_price(SVJParams(**TRUE), SPOT, STRIKES, 0.5, True)
    body = {"spot": SPOT, "strikes": STRIKES.tolist(), "T": 0.5,
            "market_prices": market.tolist(), "r": R, "q": Q,
            "num_paths": 1000}
    got = pserver.handle_calibrate(dict(body), device="cpu")
    ref = jserver.handle_calibrate(dict(body))
    _keys(got, ref)
    assert got["params"].keys() == ref["params"].keys()
    for stage in ("stage1_result", "stage2_result"):
        assert got[stage].keys() == ref[stage].keys()
        assert got[stage]["nit"] == ref[stage]["nit"] == 25
        assert got[stage]["success"] and np.isfinite(got[stage]["error"])
    bounds = dict(zip(("kappa", "theta", "xi", "rho", "v0", "lambda_j",
                       "mu_j", "sigma_j"),
                      np.vstack([pcal.HESTON_BOUNDS, pcal.JUMP_BOUNDS])))
    for name, (lo, hi) in bounds.items():
        assert lo <= got["params"][name] <= hi, name
    assert got["feller_satisfied"] == SVJParams(
        **got["params"]).feller_satisfied


def test_calibrate_american_matches_jax(small_de):
    strikes = np.array([85.0, 90.0, 95.0, 100.0, 105.0, 110.0])
    prices = [binomial_american_bs(SPOT, K, 0.5, R, Q, 0.22, steps=256,
                                   is_call=False) for K in strikes]
    body = {"spot": SPOT, "strikes": strikes.tolist(), "T": 0.5,
            "market_prices": prices, "is_call": False, "r": R, "q": Q,
            "num_paths": 1000, "exercise": "american",
            "bid_ask_spreads": [0.05] * 6}
    got = pserver.handle_calibrate(dict(body), device="cpu")
    ref = jserver.handle_calibrate(dict(body))
    _keys(got, ref)
    _equal(got["deamericanized"], ref["deamericanized"])


@pytest.mark.parametrize("case,needle", [
    ({"exercise": "bermudan"}, "unknown exercise"),
    ({"exercise": "american", "market_prices": [0.0] * 9}, "de-Americanize"),
])
def test_calibrate_400s_match_jax(case, needle):
    body = dict({"spot": SPOT, "strikes": STRIKES.tolist(), "T": 0.5,
                 "market_prices": [5.0] * 9}, **case)
    assert needle in _refused_alike("handle_calibrate", body)


# ─────────────────────────────────────────────────────────────────────────────
# /api/quotegreeks
# ─────────────────────────────────────────────────────────────────────────────
_QG = {"spot": SPOT, "T": 0.5, "strikes": STRIKES.tolist(),
       "product": {"kind": "vanilla", "T": 0.5}}


@pytest.mark.parametrize("case", [
    {},
    {"product": {"kind": "digital", "T": 0.5, "strike": 104.0,
                 "is_call": False}, "free": ["kappa", "theta", "xi"]},
    {"product": {"kind": "varswap", "T": 1.0, "notional": 3.0},
     "T": [0.25, 1.0], "strikes": [STRIKES[::2].tolist(),
                                   STRIKES[1::2].tolist()],
     "weights": list(np.linspace(1.0, 2.0, 9))},
])
def test_quotegreeks_matches_jax(case):
    body = dict(_QG, **case)
    _equal(pserver.handle_quotegreeks(dict(body), device="cpu"),
           jserver.handle_quotegreeks(dict(body)))


@pytest.mark.parametrize("case,needle", [
    ({"free": ["theta", "omega"]}, "unknown free parameter"),
    ({"product": {"kind": "asian", "T": 0.5}}, "unknown product kind"),
    ({"T": [0.25, 0.5]}, "align"),
    ({"weights": [1.0, 2.0]}, "weights length"),
])
def test_quotegreeks_400s_match_jax(case, needle):
    assert needle in _refused_alike("handle_quotegreeks", dict(_QG, **case))


# ─────────────────────────────────────────────────────────────────────────────
# /api/localvol and /api/slv
# ─────────────────────────────────────────────────────────────────────────────
_LV = {"spot": SPOT, "strikes": STRIKES.tolist(), "maturities": MATS.tolist(),
       "iv": _iv().tolist(), "price_strikes": [90.0, 100.0, 110.0],
       "T": 0.5, "r": R, "q": Q, "num_paths": 8192, "num_steps": 32}


def _chains_within(got, ref, k=4.0):
    for a, b in zip(got, ref):
        assert a["strike"] == b["strike"]
        assert abs(a["price"] - b["price"]) <= k * np.hypot(
            a["std_error"], b["std_error"]), (a, b)


def test_localvol_matches_jax():
    got = pserver.handle_localvol(dict(_LV), device="cpu")
    ref = jserver.handle_localvol(dict(_LV))
    _keys(got, ref)
    _equal(got["local_vol_grid"], ref["local_vol_grid"])
    _chains_within(got["chain"], ref["chain"])


@pytest.mark.parametrize("case,needle", [
    ({"iv": _iv()[:, :4].tolist()}, "n_maturities"),
    ({"maturities": [0.5], "iv": _iv()[1:2].tolist()}, "2 maturities"),
])
def test_localvol_400s_match_jax(case, needle):
    assert needle in _refused_alike("handle_localvol", dict(_LV, **case))


@pytest.mark.parametrize("case", [
    {},
    {"mode": "barrier", "barrier": 125.0, "knock": "in"},
    {"mode": "forward_start", "t1": 0.2, "k": 1.05, "is_call": False},
])
def test_slv_matches_jax(case):
    body = dict(_LV, **case)
    got = pserver.handle_slv(dict(body), device="cpu")
    ref = jserver.handle_slv(dict(body))
    _keys(got, ref)
    if "chain" in ref:
        _chains_within(got["chain"], ref["chain"])
    else:
        assert abs(got["price"] - ref["price"]) <= 4 * np.hypot(
            got["std_error"], ref["std_error"])


@pytest.mark.parametrize("case,needle", [
    ({"iv": _iv()[:2].tolist()}, "iv must be"),
    ({"price_strikes": []}, "non-empty price_strikes"),
    ({"mode": "barrier", "price_strikes": []}, "non-empty price_strikes"),
    ({"maturities": [0.5], "iv": _iv()[1:2].tolist()}, "2 maturities"),
    ({"mode": "barrier"}, "barrier > 0"),
    ({"mode": "forward_start", "t1": 0.7}, "0 < t1 < T"),
    ({"mode": "cliquet"}, "unknown mode"),
])
def test_slv_400s_match_jax(case, needle):
    assert needle in _refused_alike("handle_slv", dict(_LV, **case))
