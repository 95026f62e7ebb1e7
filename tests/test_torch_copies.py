"""The port's copies of JAX-free modules against their originals: the same
public names and the same outputs on a few inputs."""

import dataclasses
import json

import numpy as np
import pytest
from pydantic import ValidationError

import mcos_tpu.api.schemas as jschemas
import mcos_tpu.config as jconfig
import mcos_tpu.engine.american as jamerican
import mcos_tpu.engine.pde as jpde
import mcos_tpu.engine.regime as jregime
import mcos_tpu.ops.cos_bermudan as jcos_bermudan
import mcos_tpu.ops.cos_pricer as jcos
import mcos_tpu.ops.curves as jcurves
import mcos_tpu.ops.dividends as jdivs
import mcos_tpu.ops.exotics as jexotics
import mcos_tpu.ops.levy as jlevy
import mcos_tpu.utils.chain_loader as jchain
import mcos_tpu.utils.fastjson as jfastjson
import mcos_tpu_torch.api.schemas as pschemas
import mcos_tpu_torch.config as pconfig
import mcos_tpu_torch.engine.american as pamerican
import mcos_tpu_torch.engine.pde as ppde
import mcos_tpu_torch.engine.regime as pregime
import mcos_tpu_torch.ops.cos_bermudan as pcos_bermudan
import mcos_tpu_torch.ops.cos_pricer as pcos
import mcos_tpu_torch.ops.curves as pcurves
import mcos_tpu_torch.ops.dividends as pdivs
import mcos_tpu_torch.ops.exotics as pexotics
import mcos_tpu_torch.ops.levy as plevy
import mcos_tpu_torch.utils.chain_loader as pchain
import mcos_tpu_torch.utils.fastjson as pfastjson
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu_torch.models.params import SVJParams


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and getattr(getattr(mod, n), "__module__", mod.__name__)
            in (mod.__name__, None)}


#: The array frameworks each package imports at module level: public by
#: `_public`'s reading, and the one difference the port must have.
_FRAMEWORKS = {"jax", "jnp", "torch"}


@pytest.mark.parametrize("jmod,pmod", [
    (jconfig, pconfig), (jcurves, pcurves), (jdivs, pdivs),
    (jcos, pcos), (jfastjson, pfastjson), (jregime, pregime),
    (jamerican, pamerican), (jpde, ppde), (jcos_bermudan, pcos_bermudan),
    (jlevy, plevy), (jchain, pchain),
])
def test_same_public_names(jmod, pmod):
    assert _public(pmod) - _FRAMEWORKS == _public(jmod) - _FRAMEWORKS


def test_config_values_equal():
    for name in _public(jconfig):
        a, b = getattr(jconfig, name), getattr(pconfig, name)
        if callable(a) and not dataclasses.is_dataclass(a):
            continue
        if dataclasses.is_dataclass(a) and not isinstance(a, type):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        elif not isinstance(a, type):
            assert a == b, name
    for T in (0.001, 0.1, 1.0, 3.7):
        assert pconfig.scaled_steps(252, T) == jconfig.scaled_steps(252, T)
    p = {"kappa": 20.0, "rho": 0.5, "other": 1.0}
    assert pconfig.clamp_params(p) == jconfig.clamp_params(p)
    assert pconfig.check_params_in_bounds(p) == jconfig.check_params_in_bounds(p)


def test_curves_outputs_equal():
    a = jcurves.RateCurve([0.25, 1.0, 2.0], [0.05, 0.06, 0.07])
    b = pcurves.RateCurve([0.25, 1.0, 2.0], [0.05, 0.06, 0.07])
    for T in (0.0, 0.1, 0.25, 1.5, 3.0):
        assert b.r_eff(T) == a.r_eff(T) and b.discount(T) == a.discount(T)
    np.testing.assert_array_equal(b.grid_log_offsets(1.3, 9, 0.06),
                                  a.grid_log_offsets(1.3, 9, 0.06))
    np.testing.assert_array_equal(b.grid_step_dfs(1.3, 9),
                                  a.grid_step_dfs(1.3, 9))
    with pytest.raises(ValueError):
        pcurves.RateCurve([1.0, 0.5], [0.1, 0.1])


@pytest.mark.parametrize("kind,amounts", [("cash", [100.0, 150.0]),
                                          ("proportional", [0.01, 0.02])])
def test_dividends_outputs_equal(kind, amounts):
    a = jdivs.DividendSchedule([0.1, 0.4], amounts, kind)
    b = pdivs.DividendSchedule([0.1, 0.4], amounts, kind)
    for T in (0.05, 0.25, 1.0):
        assert (pdivs.effective_spot(22500.0, b, 0.065, T)
                == jdivs.effective_spot(22500.0, a, 0.065, T))
        assert (pdivs.forward_with_dividends(22500.0, b, 0.065, 0.01, T)
                == jdivs.forward_with_dividends(22500.0, a, 0.065, 0.01, T))
        np.testing.assert_array_equal(
            np.asarray(b.grid_amounts(T, 10), dtype=float),
            np.asarray(a.grid_amounts(T, 10), dtype=float))


@pytest.mark.parametrize("fields,T", [(dict(), 0.25),
                                      (dict(lambda_j=0.0, xi=0.3), 1.0)])
def test_cos_price_equal(fields, T):
    strikes = [18000.0, 22500.0, 27000.0]
    for is_call in (True, False):
        ref = jcos.cos_price(JSVJParams(**fields), 22500.0, strikes, T,
                             is_call)
        got = pcos.cos_price(SVJParams(**fields), 22500.0, strikes, T,
                             is_call)
        np.testing.assert_array_equal(got, ref)


def test_fastjson_equal():
    x = np.array([[1.005, -2.5, np.nan], [np.inf, 0.125, 1e6]])
    assert (pfastjson.float_array_json(x, 2).raw
            == jfastjson.float_array_json(x, 2).raw)
    body = {"a": pfastjson.float_array_json(x[0], 1), "b": 1}
    jbody = {"a": jfastjson.float_array_json(x[0], 1), "b": 1}
    assert pfastjson.dumps(body) == jfastjson.dumps(jbody)
    assert json.loads(pfastjson.dumps(body))["b"] == 1


def test_price_request_schema_equal():
    for name in ("PriceRequest", "SVJParamsRequest", "DividendItem",
                 "RateKnot"):
        a, b = getattr(jschemas, name), getattr(pschemas, name)
        assert a.model_json_schema() == b.model_json_schema(), name
    body = {"spot": 22500.0, "strike": 23000.0, "T": 0.3,
            "params": {"xi": 0.7}, "dividends": [{"t": 0.2, "amount": 50.0}],
            "rate_curve": [{"t": 1.0, "r": 0.05}]}
    a, b = jschemas.PriceRequest(**body), pschemas.PriceRequest(**body)
    assert a.model_dump() == b.model_dump()
    assert b.params.to_params().as_dict() == a.params.to_params().as_dict()
    ad = jschemas.build_dividend_schedule(a.dividends, "cash")
    bd = pschemas.build_dividend_schedule(b.dividends, "cash")
    assert (bd.times, bd.amounts, bd.kind) == (ad.times, ad.amounts, ad.kind)
    ac, bc = (jschemas.build_rate_curve(a.rate_curve),
              pschemas.build_rate_curve(b.rate_curve))
    assert (bc.times, bc.rates) == (ac.times, ac.rates)


def test_exotic_request_schema_equal():
    a, b = jschemas.ExoticRequest, pschemas.ExoticRequest
    ja, jb = a.model_json_schema(), b.model_json_schema()
    ja.pop("description"), jb.pop("description")   # the docstrings differ
    assert ja == jb
    body = {"spot": 100.0, "T": 0.5, "kind": "barrier", "strike": 101.0,
            "barrier": 120.0, "window": [0.1, 0.3], "rebate": 1.0,
            "params": {"xi": 0.7}}
    assert a(**body).model_dump() == b(**body).model_dump()


# The host float64 closed forms are copies: equal to the last bit.
_GBM = dict(r=0.05, q=0.01, sigma=0.25)


def _same(name, *args, **kw):
    ref = getattr(jexotics, name)(*args, **kw)
    got = getattr(pexotics, name)(*args, **kw)
    assert got == ref, (name, args, kw)
    return got


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("knock", ["out", "in"])
@pytest.mark.parametrize("barrier,direction", [(120.0, "up"), (85.0, "down"),
                                               (95.0, "up")])
def test_barrier_bs_equal(is_call, knock, barrier, direction):
    for K in (90.0, 100.0, 125.0):
        price = _same("barrier_bs", 100.0, K, 0.75, 0.05, 0.01, 0.25,
                      barrier, is_call, knock, direction)
        assert price >= 0.0


@pytest.mark.parametrize("direction,barrier", [("up", 115.0), ("down", 88.0),
                                               ("up", 99.0)])
@pytest.mark.parametrize("pay_at_hit", [False, True])
def test_one_touch_bs_equal(direction, barrier, pay_at_hit):
    p = _same("one_touch_bs", 100.0, 0.5, 0.05, 0.01, 0.25, barrier,
              direction, pay_at_hit)
    assert 0.0 <= p <= 1.0


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("knock", ["out", "in"])
def test_double_barrier_bs_equal(is_call, knock):
    for lo, hi in ((80.0, 125.0), (95.0, 104.0), (101.0, 130.0)):
        _same("double_barrier_bs", 100.0, 100.0, 0.5, lower=lo, upper=hi,
              is_call=is_call, knock=knock, **_GBM)
    with pytest.raises(ValueError):
        pexotics.double_barrier_bs(100.0, 100.0, 0.5, 0.05, 0.01, 0.25,
                                   120.0, 80.0)


def test_double_no_touch_bs_equal():
    for lo, hi in ((80.0, 125.0), (95.0, 104.0), (101.0, 130.0)):
        _same("double_no_touch_bs", 100.0, 0.5, lower=lo, upper=hi, **_GBM)


@pytest.mark.parametrize("is_call,knock", [(True, "out"), (False, "in")])
@pytest.mark.parametrize("window", [(0.1, 0.4), (0.0, 0.3), (0.0, 0.5),
                                    (0.2, 0.2)])
@pytest.mark.parametrize("barrier_lo", [None, 82.0])
def test_window_barrier_bs_equal(is_call, knock, window, barrier_lo):
    _same("window_barrier_bs", 100.0, 100.0, 0.5, 0.05, 0.01, 0.25, 118.0,
          window[0], window[1], is_call=is_call, knock=knock,
          barrier_lo=barrier_lo, n_quad=48, n_outer=24)


@pytest.mark.parametrize("window", [(0.1, 0.4), (0.0, 0.5), (0.2, 0.2)])
@pytest.mark.parametrize("barrier,barrier_lo", [(118.0, None), (85.0, None),
                                                (118.0, 82.0)])
def test_window_no_touch_bs_equal(window, barrier, barrier_lo):
    _same("window_no_touch_bs", 100.0, 0.5, 0.05, 0.01, 0.25, barrier,
          window[0], window[1], barrier_lo=barrier_lo, n_quad=48, n_outer=24)
    with pytest.raises(ValueError):
        pexotics.window_no_touch_bs(100.0, 0.5, 0.05, 0.01, 0.25, 118.0,
                                    0.4, 0.1)


def test_corridor_density_and_constants_equal():
    x = np.linspace(-0.3, 0.2, 41)
    np.testing.assert_array_equal(
        pexotics._corridor_density(x, -0.3, 0.2, 0.01, 0.25, 0.5),
        jexotics._corridor_density(x, -0.3, 0.2, 0.01, 0.25, 0.5))
    assert pexotics.BGK_BETA == jexotics.BGK_BETA
    for n in (16, 96):
        for a, b in zip(pexotics._leggauss(n), jexotics._leggauss(n)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pexotics._hermgauss(n), jexotics._hermgauss(n)):
            np.testing.assert_array_equal(a, b)


# ── the model families' host copies (HHW, SVCJ, td-SVJ) ─────────────────────
def _svcj_pair(**fields):
    from mcos_tpu.models.params import SVCJParams as JSVCJParams
    from mcos_tpu_torch.models.params import SVCJParams

    return JSVCJParams(**fields), SVCJParams(**fields)


@pytest.mark.parametrize("fields,T", [
    (dict(), 0.25), (dict(mu_v=0.1, rho_j=-1.5, lambda_j=3.0), 1.0),
    (dict(mu_v=1e-9), 0.5)])
def test_svcj_oracle_equal(fields, T):
    import mcos_tpu.ops.svcj as jsvcj
    import mcos_tpu_torch.ops.svcj as psvcj

    jp, pp = _svcj_pair(**fields)
    u = np.linspace(0.0, 40.0, 17)
    np.testing.assert_allclose(psvcj.svcj_cf(u, pp, T, 100.0),
                               jsvcj.svcj_cf(u, jp, T, 100.0), rtol=0,
                               atol=1e-12)
    strikes = [80.0, 100.0, 125.0]
    for is_call in (True, False):
        np.testing.assert_allclose(
            psvcj.svcj_cos_price(pp, 100.0, strikes, T, is_call),
            jsvcj.svcj_cos_price(jp, 100.0, strikes, T, is_call), rtol=0,
            atol=1e-12)
    with pytest.raises(ValueError):
        psvcj.svcj_cf(u, pp.replace(rho_j=30.0, mu_v=0.05), T, 100.0)


_TD_SEG = ([0.2, 0.5, 1.0], [0.04, 0.09, 0.05], [0.4, 1.1, 0.6],
           [0.5, 8.0, 2.0])


@pytest.mark.parametrize("T", [0.1, 0.5, 1.0, 1.7])
def test_tdsvj_host_copies_equal(T):
    import mcos_tpu.ops.tdsvj as jtd
    import mcos_tpu_torch.ops.tdsvj as ptd

    jp, pp = JSVJParams(kappa=2.5, v0=0.05), SVJParams(kappa=2.5, v0=0.05)
    strikes = [80.0, 100.0, 125.0]
    for is_call in (True, False):
        np.testing.assert_allclose(
            ptd.cos_price_td(pp, 100.0, strikes, T, *_TD_SEG, is_call),
            jtd.cos_price_td(jp, 100.0, strikes, T, *_TD_SEG, is_call),
            rtol=0, atol=1e-12)
    a = ptd.td_variance_swap_fair_strike(pp, *_TD_SEG, T)
    b = jtd.td_variance_swap_fair_strike(jp, *_TD_SEG, T)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k] == pytest.approx(b[k], rel=0, abs=1e-12), k
    for x, y in zip(ptd.normalize_segments(*_TD_SEG, T),
                    jtd.normalize_segments(*_TD_SEG, T)):
        np.testing.assert_array_equal(x, y)
    seg = [np.asarray(x) for x in _TD_SEG]
    for x, y in zip(ptd.step_param_arrays(*seg, 1.0, 37),
                    jtd.step_param_arrays(*seg, 1.0, 37)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        ptd.normalize_segments([0.5, 0.2], [1, 1], [1, 1], [1, 1], T)


@pytest.mark.parametrize("T", [0.5, 5.0, 30.0])
def test_hhw_closed_forms_equal(T):
    import mcos_tpu.ops.hhw as jhhw
    import mcos_tpu_torch.ops.hhw as phhw

    fields = dict(a=0.15, b=0.04, sigma_r=0.015, r0=0.03, rho_sr=0.4, q=0.02)
    jp, pp = jhhw.HHWParams(**fields), phhw.HHWParams(**fields)
    assert phhw.vasicek_bond(pp, T) == pytest.approx(
        jhhw.vasicek_bond(jp, T), rel=0, abs=1e-12)
    for is_call in (True, False):
        for K in (80.0, 100.0, 130.0):
            assert phhw.bsm_hullwhite(pp, 100.0, K, T, 0.25, is_call) \
                == pytest.approx(jhhw.bsm_hullwhite(jp, 100.0, K, T, 0.25,
                                                    is_call),
                                 rel=0, abs=1e-12)
    assert ({f.name: f.default for f in dataclasses.fields(phhw.HHWParams)}
            == {f.name: f.default
                for f in dataclasses.fields(jhhw.HHWParams)})


def test_implied_vol_copies_equal():
    import mcos_tpu.engine.surface as jsurf
    import mcos_tpu_torch.engine.surface as psurf

    K = np.array([[80.0, 100.0, 120.0]])
    T = np.array([[0.1], [1.0]])
    price = jsurf._bs_price_np(100.0, K, T, 0.05, 0.01, 0.3, True)
    price[0, 0] = 1.0                     # below intrinsic: not bracketed
    got = psurf.implied_vol_grid(price, 100.0, K, T, 0.05, 0.01)
    ref = jsurf.implied_vol_grid(price, 100.0, K, T, 0.05, 0.01)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, equal_nan=True)
    assert np.isnan(got[0, 0]) and got[1, 1] == pytest.approx(0.3, abs=1e-9)
    assert psurf.implied_vol(1.0, 100.0, 80.0, 0.1, 0.05, 0.01) is None
    assert psurf.implied_vol(float(price[1, 2]), 100.0, 120.0, 1.0, 0.05,
                             0.01, True) == jsurf.implied_vol(
        float(price[1, 2]), 100.0, 120.0, 1.0, 0.05, 0.01, True)


@pytest.mark.parametrize("is_call", [True, False])
def test_cliquet_closed_forms_equal(is_call):
    import mcos_tpu.engine.cliquet as jcl
    import mcos_tpu_torch.engine.cliquet as pcl

    for k in (0.0, 0.95, 1.0, 1.1):
        assert pcl.forward_start_bs(0.3, 1.0, k, 0.05, 0.01, 0.25, is_call) \
            == pytest.approx(jcl.forward_start_bs(0.3, 1.0, k, 0.05, 0.01,
                                                  0.25, is_call),
                             rel=0, abs=1e-12)
    for floor, cap in ((0.0, 0.08), (-0.02, 0.05)):
        assert pcl.cliquet_bs(1.0, 4, 0.05, 0.01, 0.25, floor, cap, 100.0) \
            == pytest.approx(jcl.cliquet_bs(1.0, 4, 0.05, 0.01, 0.25, floor,
                                            cap, 100.0), rel=0, abs=1e-12)
    import torch

    dlog = np.random.default_rng(0).normal(0.0, 0.05, (4, 2, 64)).astype(
        np.float32)
    np.testing.assert_allclose(
        pcl._cliquet_payoff(torch.from_numpy(dlog), 0.0, 0.08, 0.0,
                            0.2).numpy(),
        np.asarray(jcl._cliquet_payoff(dlog, 0.0, 0.08, 0.0, 0.2)),
        rtol=1e-6, atol=1e-7)


def test_family_request_schemas_equal():
    for name in ("HHWRequest", "SVCJParamsRequest", "SVCJRequest",
                 "TermSVJSegment", "TermSVJRequest", "RoughRequest"):
        ja = getattr(jschemas, name).model_json_schema()
        jb = getattr(pschemas, name).model_json_schema()
        ja.pop("description", None), jb.pop("description", None)
        assert ja == jb, name
    body = {"spot": 100.0, "T": 0.5, "mode": "cliquet", "n_periods": 3,
            "segments": [{"t_end": 0.2, "theta": 0.05},
                         {"t_end": 0.5, "xi": 0.9, "lambda_j": 3.0}]}
    assert (jschemas.TermSVJRequest(**body).model_dump()
            == pschemas.TermSVJRequest(**body).model_dump())
    body = {"spot": 100.0, "T": 0.5, "params": {"mu_v": 0.1, "rho_j": -2.0}}
    a, b = jschemas.SVCJRequest(**body), pschemas.SVCJRequest(**body)
    assert a.model_dump() == b.model_dump()
    assert b.params.to_params().as_dict() == {
        k: float(v) for k, v in a.params.to_params().as_dict().items()}
    body = {"spot": 100.0, "strike": 95.0, "T": 12.0, "mode": "impact"}
    assert (jschemas.HHWRequest(**body).model_dump()
            == pschemas.HHWRequest(**body).model_dump())
    body = {"spot": 100.0, "T": 0.5, "mode": "calibrate", "num_steps": 512,
            "maturities": [0.1], "cal_strikes": [[95.0]],
            "market_prices": [[6.0]], "hurst_grid": [0.1]}
    assert (jschemas.RoughRequest(**body).model_dump()
            == pschemas.RoughRequest(**body).model_dump())


_EDGES = np.array([0.0, 0.25, 1.0])
_VALS = np.array([0.04, 0.0633])


@pytest.mark.parametrize("name,args", [
    ("roughheston.lifted_kernel_nodes", (0.07, 1.0, 1.0 / 64, 24)),
    ("roughheston.lifted_kernel_nodes", (0.5, 0.25, 0.25 / 512, 24)),
    ("roughheston.lifted_kernel_error", (0.1, 0.5, 0.5 / 128, 8)),
    ("rough.volterra_cov", (np.linspace(0.0, 1.0, 9)[:, None],
                            np.linspace(0.1, 2.0, 7)[None, :], 0.07)),
    ("rough.volterra_cov", (0.5, 0.5, 0.5)),
    ("rough.volterra_increment_cov", (np.linspace(0.1, 1.0, 10), 0.2, 0.1)),
    ("rough._lift_cached", (0.07, 0.25, 512, 24)),
    ("rough._lift_cached", (0.5, 1.0, 64, 24)),
    ("rough._lift_cached", (0.25, 2.0, 33, 8)),
    ("rough.xi_curve_from_variance_swaps", ([0.25, 1.0, 2.0],
                                            [0.2, 0.22, 0.21])),
    ("rough.sample_xi_curve", (_EDGES, _VALS, 1.5, 12)),
])
def test_rough_host_copies_equal(name, args):
    """The host float64 functions the rough Bergomi slice copied: the same
    outputs as the JAX package's (the lift tables through the rough Heston
    kernel fit)."""
    import importlib

    mod, fn = name.split(".")
    got = getattr(importlib.import_module(f"mcos_tpu_torch.ops.{mod}"),
                  fn)(*args)
    ref = getattr(importlib.import_module(f"mcos_tpu.ops.{mod}"), fn)(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=0)


def test_risk_desk_request_schemas_equal():
    for name in ("StressRequest", "RegimeRequest", "HedgeRequest",
                 "VarRequest"):
        a = getattr(jschemas, name).model_json_schema()
        b = getattr(pschemas, name).model_json_schema()
        assert a == b, name
    bodies = {
        "StressRequest": {"spot": 100.0, "strike": 95.0, "T": 0.5,
                          "mode": "matrix", "spot_shocks": [-0.1, 0.2],
                          "params": {"xi": 0.7}},
        "RegimeRequest": {"realized_vol": 0.2, "iv_percentile": 50,
                          "skew_slope": -0.01},
        "HedgeRequest": {"spot": 100.0, "strike": 95.0, "T": 0.5,
                         "dynamics": "svj", "hedge": "ww_band",
                         "risk_aversion": 0.5},
        "VarRequest": {"spots": [1.0, 2.0], "sigmas": [0.2, 0.3],
                       "weights": [0.5, 0.5],
                       "corr": [[1.0, 0.1], [0.1, 1.0]], "T": 0.1,
                       "copula": "student_t", "nu": 7.0},
    }
    for name, body in bodies.items():
        assert (getattr(jschemas, name)(**body).model_dump()
                == getattr(pschemas, name)(**body).model_dump()), name


def test_american_and_pde_request_schemas_equal():
    for name in ("AmericanRequest", "PDERequest"):
        a = getattr(jschemas, name).model_json_schema()
        b = getattr(pschemas, name).model_json_schema()
        assert a == b, name
    bodies = {
        "AmericanRequest": {"spot": 100.0, "strike": 95.0, "T": 0.5,
                            "is_call": False, "with_bounds": True,
                            "exercise_every": 4, "n_inner": 33,
                            "dividends": [{"t": 0.2, "amount": 0.02}],
                            "dividend_kind": "proportional",
                            "rate_curve": [{"t": 1.0, "r": 0.05}],
                            "params": {"xi": 0.0}},
        "PDERequest": {"spot": 100.0, "strike": 95.0, "T": 0.5,
                       "model": "bs", "sigma": 0.3, "american": True,
                       "barrier": 130.0, "barrier_lo": 70.0, "rebate": 1.0,
                       "scheme": "douglas", "n_x": 801, "n_v": 401},
    }
    for name, body in bodies.items():
        assert (getattr(jschemas, name)(**body).model_dump()
                == getattr(pschemas, name)(**body).model_dump()), name
    for bad in ({"model": "sabr"}, {"scheme": "adi"}, {"n_x": 802}):
        body = dict(bodies["PDERequest"], **bad)
        with pytest.raises(ValidationError):
            jschemas.PDERequest(**body)
        with pytest.raises(ValidationError):
            pschemas.PDERequest(**body)


_CHAIN_CSV = """expiry_years,strike,is_call,bid,ask,open_interest
0.04,22000,CE,510.0,514.0,5000
0.04,22500,CE,195.5,197.0,12000
0.04,23000,CE,48.2,49.0,8000
0.04,22500,PE,180.0,182.0,9000
0.04,24000,CE,2.0,6.0,50
garbage,row,that,should,be,skipped
0.25,22500,1,560.0,564.0,3000
0.25,23000,0,700.0,900.0,2000
"""


@pytest.mark.parametrize("force_python", [True, False])
def test_chain_loader_equal(tmp_path, force_python):
    path = tmp_path / "chain.csv"
    path.write_text(_CHAIN_CSV)
    a = pchain.load_chain(str(path), force_python=force_python)
    b = jchain.load_chain(str(path), force_python=force_python)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for T, side in ((0.04, "call"), (0.04, "put"), (0.25, "call")):
        ia = pchain.chain_to_calibration_inputs(a, T, side)
        ib = jchain.chain_to_calibration_inputs(b, T, side)
        for k in ib:
            np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)
    with pytest.raises(ValueError) as got:
        pchain.chain_to_calibration_inputs(a, 0.04, "straddle")
    with pytest.raises(ValueError) as ref:
        jchain.chain_to_calibration_inputs(b, 0.04, "straddle")
    assert str(got.value) == str(ref.value)


def test_slice_i_request_schemas_equal():
    for name in ("SurfaceRequest", "CalibrateRequest", "ProductSpec",
                 "QuoteGreeksRequest", "LocalVolRequest", "SLVRequest"):
        a = getattr(jschemas, name).model_json_schema()
        b = getattr(pschemas, name).model_json_schema()
        assert a == b, name
    grid = {"strikes": [90.0, 110.0], "maturities": [0.5, 1.0],
            "iv": [[0.2, 0.2], [0.2, 0.2]], "price_strikes": [100.0],
            "spot": 100.0, "T": 0.5}
    bodies = {
        "SurfaceRequest": {"spot": 100.0, "strikes": [90.0], "maturities":
                           [0.5], "call_prices": [[12.0]],
                           "put_prices": [[1.0]], "fit_ssvi": True},
        "CalibrateRequest": {"spot": 100.0, "strikes": [90.0, 100.0],
                             "T": 0.5, "market_prices": [12.0, 5.0],
                             "exercise": "american", "num_paths": 2000},
        "QuoteGreeksRequest": {"spot": 100.0, "T": [0.5, 1.0],
                               "strikes": [[90.0], [110.0]],
                               "product": {"kind": "varswap", "T": 1.0},
                               "free": ["theta"], "params": {"xi": 0.7}},
        "LocalVolRequest": dict(grid, num_steps=32),
        "SLVRequest": dict(grid, mode="barrier", barrier=120.0, xi=0.0),
    }
    for name, body in bodies.items():
        assert (getattr(jschemas, name)(**body).model_dump()
                == getattr(pschemas, name)(**body).model_dump()), name
    for name, bad in (("SurfaceRequest", {"exercise": "bermudan"}),
                      ("SLVRequest", {"num_steps": 8}),
                      ("CalibrateRequest", {"num_paths": 10})):
        body = dict(bodies[name], **bad)
        with pytest.raises(ValidationError):
            getattr(jschemas, name)(**body)
        with pytest.raises(ValidationError):
            getattr(pschemas, name)(**body)


@pytest.mark.parametrize("name", ["pnl", "modelrisk", "margin", "hedge",
                                  "volderivs", "book", "exposure"])
def test_desk_public_names_match_jax(name):
    """The desk modules define the JAX package's public names (modules
    they import aside: the port's own `cuda_kernels` has no JAX twin)."""
    import importlib
    import inspect

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))
                and n not in _FRAMEWORKS | {"Array"}
                and getattr(getattr(mod, n), "__module__", mod.__name__)
                == mod.__name__}

    jmod = importlib.import_module(f"mcos_tpu.engine.{name}")
    pmod = importlib.import_module(f"mcos_tpu_torch.engine.{name}")
    assert public(pmod) == public(jmod)


def test_desk_request_schemas_equal():
    names = ("ReplicateRequest", "MarginRequest", "VolDerivsRequest",
             "BookRequest", "ExposurePosition", "ExposureRequest",
             "ModelRiskRequest", "PnlRequest")
    for name in names:
        a = getattr(jschemas, name).model_json_schema()
        b = getattr(pschemas, name).model_json_schema()
        assert a == b, name
    assert pschemas.MAX_BOOK_POSITIONS == jschemas.MAX_BOOK_POSITIONS
    bodies = {
        "ReplicateRequest": {"spot": 100.0, "T": 0.5, "kind": "asian",
                             "strike": 95.0, "hedge_strikes": [90.0, 110.0]},
        "MarginRequest": {"spot": 100.0, "strikes": [95.0], "Ts": [0.5],
                          "is_calls": [True], "quantities": [-1.0]},
        "VolDerivsRequest": {"kind": "vix_option", "T": 1.0, "strike": 0.2},
        "BookRequest": {"spots": [100.0], "strikes": [95.0], "Ts": [0.5],
                        "is_calls": [False]},
        "ExposurePosition": {"kind": "put", "strike": 95.0, "T": 0.5},
        "ExposureRequest": {"spots": [100.0], "sigmas": [0.2],
                            "corr": [[1.0]], "positions": [{"strike": 95.0,
                                                            "T": 0.5}]},
        "ModelRiskRequest": {"spot": 100.0, "strike": 95.0, "T": 0.5,
                             "params": {"v0": 0.05}},
        "PnlRequest": {"strike": 100.0, "spot_old": 100.0, "spot_new": 99.0,
                       "T_old": 0.5, "T_new": 0.49},
    }
    for name, body in bodies.items():
        assert (getattr(jschemas, name)(**body).model_dump()
                == getattr(pschemas, name)(**body).model_dump()), name
    for name, bad in (("ReplicateRequest", {"kind": "cliquet"}),
                      ("MarginRequest", {"strikes": []}),
                      ("VolDerivsRequest", {"convention": "other"}),
                      ("ExposureRequest", {"num_dates": 1}),
                      ("PnlRequest", {"T_new": 0.0})):
        body = dict(bodies[name], **bad)
        with pytest.raises(ValidationError):
            getattr(jschemas, name)(**body)
        with pytest.raises(ValidationError):
            getattr(pschemas, name)(**body)


@pytest.mark.parametrize("name", ["engine.cliquet", "engine.quanto",
                                  "engine.basket", "engine.basket_american",
                                  "engine.autocallable", "ops.rainbow"])
def test_multiasset_public_names_match_jax(name):
    """Slice K's modules define the JAX package's public names."""
    import importlib
    import inspect

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))
                and n not in _FRAMEWORKS | {"Array"}
                and getattr(getattr(mod, n), "__module__", mod.__name__)
                == mod.__name__}

    jmod = importlib.import_module(f"mcos_tpu.{name}")
    pmod = importlib.import_module(f"mcos_tpu_torch.{name}")
    assert public(pmod) == public(jmod)


@pytest.mark.parametrize("rho", [-0.6, 0.0, 0.45, 0.999])
def test_rainbow_closed_forms_equal(rho):
    """`ops/rainbow.py`: host float64, equal to the JAX package's; the
    best-of call's two vanilla legs are float32 Black-Scholes in both
    (tests/test_torch_params_bs.py holds those at rtol 1e-5)."""
    import mcos_tpu.ops.rainbow as jr
    import mcos_tpu_torch.ops.rainbow as pr

    assert pr._bvn_cdf(0.3, -0.2, rho) == jr._bvn_cdf(0.3, -0.2, rho)
    args = (100.0, 95.0, 0.75, 0.01, 0.03, 0.25, 0.35, rho)
    assert pr.margrabe_exchange(*args) == jr.margrabe_exchange(*args)
    assert pr.min_asset_value(*args) == jr.min_asset_value(*args)
    for K in (0.0, 90.0, 110.0):
        stulz = (100.0, 95.0, K, 0.75, 0.05, 0.01, 0.03, 0.25, 0.35, rho)
        assert pr.stulz_min_call(*stulz) == jr.stulz_min_call(*stulz)
        for kind in ("worst_of", "best_of"):
            for is_call in (True, False):
                got = pr.rainbow_price(*stulz, kind=kind, is_call=is_call)
                ref = jr.rainbow_price(*stulz, kind=kind, is_call=is_call)
                if kind == "worst_of":
                    assert got == ref
                else:
                    assert got == pytest.approx(ref, rel=1e-5, abs=1e-4)
    with pytest.raises(ValueError, match="worst_of\\|best_of"):
        pr.rainbow_price(*stulz, kind="middle")


def test_slice_k_host_closed_forms_equal():
    """`quanto_bs` (float32 Black-Scholes in both, rtol 1e-6),
    `no_call_note_bs` and `_geometric_basket_undiscounted` (host float64,
    exactly)."""
    import mcos_tpu.engine.autocallable as ja
    import mcos_tpu.engine.basket as jb
    import mcos_tpu.engine.quanto as jq
    import mcos_tpu_torch.engine.autocallable as pa
    import mcos_tpu_torch.engine.basket as pb
    import mcos_tpu_torch.engine.quanto as pq

    for is_call in (True, False):
        for rho_fx, sigma_fx in ((-0.3, 0.1), (0.5, 0.25), (0.0, 0.0)):
            args = (100.0, 95.0, 0.5, 0.06, 0.04, 0.01, 0.2, sigma_fx,
                    rho_fx, is_call)
            assert pq.quanto_bs(*args) == pytest.approx(jq.quanto_bs(*args),
                                                        rel=1e-6)
        w = np.array([0.5, 0.3, 0.2])
        args = (350.0, w, np.array([0.01, -0.02, 0.03]), 0.035, 340.0,
                is_call)
        assert (pb._geometric_basket_undiscounted(*args)
                == jb._geometric_basket_undiscounted(*args))
    for terms in ((0.8, 0.7, 0.08), (1.0, 0.5, 0.1), (0.0, 0.0, 0.02)):
        args = (1.0, 0.05, 0.01, 0.2, *terms, 100.0)
        assert pa.no_call_note_bs(*args) == ja.no_call_note_bs(*args)


def test_slice_k_request_schemas_equal():
    names = ("BasketRequest", "QuantoRequest", "AutocallRequest",
             "CliquetRequest")
    for name in names:
        a = getattr(jschemas, name).model_json_schema()
        b = getattr(pschemas, name).model_json_schema()
        assert a == b, name
    bodies = {
        "BasketRequest": {"spots": [100.0, 95.0], "strike": 100.0,
                          "T": 0.5, "corr": [[1.0, 0.3], [0.3, 1.0]],
                          "params": [{"v0": 0.05}, {}],
                          "american": True, "with_bounds": True},
        "QuantoRequest": {"spot": 100.0, "strike": 95.0, "T": 0.5},
        "AutocallRequest": {"T": 1.0, "params_list": [{}, {"r": 0.03}],
                            "corr": [[1.0, 0.5], [0.5, 1.0]]},
        "CliquetRequest": {"T": 1.0, "kind": "forward_start", "t1": 0.3},
    }
    for name, body in bodies.items():
        assert (getattr(jschemas, name)(**body).model_dump()
                == getattr(pschemas, name)(**body).model_dump()), name
    for name, bad in (("BasketRequest", {"n_outer": 64}),
                      ("QuantoRequest", {"rho_fx": 1.0}),
                      ("AutocallRequest", {"steps_per_period": 1}),
                      ("CliquetRequest", {"n_periods": 0})):
        body = dict(bodies[name], **bad)
        with pytest.raises(ValidationError):
            getattr(jschemas, name)(**body)
        with pytest.raises(ValidationError):
            getattr(pschemas, name)(**body)


@pytest.mark.parametrize("name", ["ops.roughheston", "engine.roughheston",
                                  "engine.mlmc", "api.quotes", "api.client",
                                  "api.serverless", "utils.timing",
                                  "utils.checkpoint", "cli"])
def test_slice_lm_public_names_match_jax(name, monkeypatch):
    """Slices L and M define the JAX package's public names. (Importing
    the port's serverless entry points the kernels' build directory at
    $MCOS_JIT_CACHE; it is put back after the test.)"""
    import importlib
    import inspect

    from mcos_tpu_torch.ops import cuda_kernels

    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", cuda_kernels.BUILD_DIR)

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))
                and n not in _FRAMEWORKS | {"Array"}
                and getattr(getattr(mod, n), "__module__", mod.__name__)
                == mod.__name__}

    jmod = importlib.import_module(f"mcos_tpu.{name}")
    pmod = importlib.import_module(f"mcos_tpu_torch.{name}")
    # The port's serverless entry names the device it serves on; the JAX
    # package's picks its platform through JAX_PLATFORMS instead.
    extra = {"DEVICE"} if name == "api.serverless" else set()
    assert public(pmod) - extra == public(jmod)


_RH_FIELDS = dict(lam=1.5, theta=0.04, nu=0.35, rho=-0.7, v0=0.04,
                  r=0.065, q=0.012)


@pytest.mark.parametrize("hurst,T", [(0.1, 0.25), (0.3, 1.0), (0.5, 0.1)])
def test_rough_heston_host_copies_equal(hurst, T):
    """The fractional Adams solve, the CF, the cumulant range and the COS
    prices: the same float64 numpy code, equal to the JAX package's."""
    import mcos_tpu.ops.roughheston as jr
    import mcos_tpu_torch.ops.roughheston as pr

    jp = jr.RoughHestonParams(hurst=hurst, **_RH_FIELDS)
    pp = pr.RoughHestonParams(hurst=hurst, **_RH_FIELDS)
    assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
    assert pp.replace(nu=0.5) == pr.RoughHestonParams(
        hurst=hurst, **dict(_RH_FIELDS, nu=0.5))
    u = np.linspace(0.1, 60.0, 9)
    for a, b in zip(pr.rough_heston_h(u, pp, T, n_steps=64),
                    jr.rough_heston_h(u, jp, T, n_steps=64)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pr.rough_heston_cf(u, pp, T, 22500.0, n_steps=64),
        jr.rough_heston_cf(u, jp, T, 22500.0, n_steps=64))
    assert pr._cf_cumulant_range(pp, T, 22500.0, n_steps=96) == \
        jr._cf_cumulant_range(jp, T, 22500.0, n_steps=96)
    strikes = np.array([0.9, 1.0, 1.1]) * 22500.0
    for is_call in (True, False):
        np.testing.assert_array_equal(
            pr.rough_heston_cos_price(pp, 22500.0, strikes, T, is_call,
                                      n_terms=128, n_steps=64),
            jr.rough_heston_cos_price(jp, 22500.0, strikes, T, is_call,
                                      n_terms=128, n_steps=64))


def test_rough_heston_cos_guard_raises_as_jax(monkeypatch):
    """A CF that never turns finite: three step doublings, then
    FloatingPointError, in both."""
    import mcos_tpu.ops.roughheston as jr
    import mcos_tpu_torch.ops.roughheston as pr

    for mod, params in ((pr, pr.RoughHestonParams()),
                        (jr, jr.RoughHestonParams())):
        real, calls = mod.rough_heston_cf, []

        def cf(u, p, T, spot, n_steps=256, _real=real, _calls=calls):
            _calls.append(n_steps)
            out = _real(u, p, T, spot, n_steps=n_steps)
            return out if len(u) == 2 else out * np.nan
        monkeypatch.setattr(mod, "rough_heston_cf", cf)
        with pytest.raises(FloatingPointError, match="raise n_steps"):
            mod.rough_heston_cos_price(params, 100.0, [100.0], 0.25,
                                       n_terms=32, n_steps=32)
        assert calls == [96, 32, 64, 128]


def test_calibrate_rough_heston_equal():
    """The scipy least-squares fit on the COS objective, at a reduced COS
    grid, on quotes from known parameters: a fixed H and the H grid."""
    import mcos_tpu.engine.roughheston as je
    import mcos_tpu.ops.roughheston as jr
    import mcos_tpu_torch.engine.roughheston as pe

    strikes = np.array([0.95, 1.0, 1.05]) * 100.0
    market = jr.rough_heston_cos_price(
        jr.RoughHestonParams(nu=0.3, rho=-0.5, v0=0.05, theta=0.05,
                             hurst=0.2), 100.0, strikes, 0.5, True,
        n_terms=64, n_steps=32)
    for kw in ({"hurst": 0.2, "n_starts": 1},
               {"hurst_grid": (0.1, 0.2), "n_starts": 1,
                "fit_lam_theta": True}):
        got = pe.calibrate_rough_heston(100.0, strikes, 0.5, market,
                                        n_terms=64, n_adams=32, **kw)
        ref = je.calibrate_rough_heston(100.0, strikes, 0.5, market,
                                        n_terms=64, n_adams=32, **kw)
        assert dataclasses.asdict(got.pop("params")) == \
            dataclasses.asdict(ref.pop("params"))
        assert got == ref


def test_giles_driver_equal():
    """The host allocation loop on a deterministic fake run_level: the
    same levels, path counts and result."""
    import mcos_tpu.engine.mlmc as jm
    import mcos_tpu_torch.engine.mlmc as pm

    def fake(calls):
        def run_level(level, n):
            calls.append((level, n))
            n = 1 << int(np.ceil(np.log2(max(n, 256))))
            mean = 10.0 if level == 0 else 2.0 ** -level
            return n, mean, mean * mean + 4.0 * 2.0 ** -level
        return run_level

    for eps in (0.5, 0.05):
        a, b = [], []
        got = pm.giles_driver(fake(a), eps=eps, base_steps=4, max_levels=8,
                              pilot_paths=1024)
        ref = jm.giles_driver(fake(b), eps=eps, base_steps=4, max_levels=8,
                              pilot_paths=1024)
        assert got == ref and a == b and got["num_levels"] >= 3


def test_rough_heston_request_schema_equal():
    a = jschemas.RoughHestonRequest.model_json_schema()
    b = pschemas.RoughHestonRequest.model_json_schema()
    assert a == b
    body = {"spot": 22500.0, "T": 0.25, "mode": "calibrate",
            "strikes": [22000.0, 23000.0], "market_prices": [700.0, 300.0],
            "fit_hurst": True, "num_steps": 1024}
    assert (jschemas.RoughHestonRequest(**body).model_dump()
            == pschemas.RoughHestonRequest(**body).model_dump())
    for bad in ({"hurst": 0.0}, {"T": 11.0}, {"n_factors": 0},
                {"num_paths": 999}):
        with pytest.raises(ValidationError):
            jschemas.RoughHestonRequest(**dict(body, **bad))
        with pytest.raises(ValidationError):
            pschemas.RoughHestonRequest(**dict(body, **bad))


#: The reference's sharded programs with pooling of their own: slice N2,
#: once missing from the port, now present.
_N2_MESH = {"sharded_all_greeks", "sharded_sobol_price",
            "sharded_american_price", "sharded_mlmc_price",
            "sharded_exposure_profile", "sharded_basket_bounds",
            "sharded_pde_chain", "sharded_portfolio_returns"}
#: The port's own names for what shard_map and jax.sharding give the
#: reference: the mesh class, its shards and seeds, the one pooling
#: function and its gather across processes, the lockstep runner and the
#: DE population split.
_PORT_MESH = {"Mesh", "Shard", "MAX_KEYS", "StepPool", "beta_one_payoffs",
              "mesh_shards", "pool_shards", "run_lockstep", "shard_moments",
              "shard_seed", "gather_shards", "COLLECTIVES",
              "sharded_population"}


@pytest.mark.parametrize("name", ["mesh", "families", "distributed"])
def test_parallel_public_names_match_jax(name):
    """Slices N1 and N2 define every public name of the reference's
    `parallel/mesh.py` (N2's eight programs among them), of its
    `parallel/families.py` (all 13 drivers) and of its
    `parallel/distributed.py`."""
    import importlib
    import inspect

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))
                and n not in _FRAMEWORKS | {"Array"}
                and getattr(getattr(mod, n), "__module__", mod.__name__)
                == mod.__name__}

    jmod = importlib.import_module(f"mcos_tpu.parallel.{name}")
    pmod = importlib.import_module(f"mcos_tpu_torch.parallel.{name}")
    if name == "families":
        assert public(pmod) == public(jmod)
        assert len({n for n in public(pmod) if n.startswith("sharded_")}) \
            == 13
    elif name == "distributed":
        assert public(pmod) == public(jmod) == {
            "initialize", "global_mesh", "is_distributed", "main"}
    else:
        assert public(pmod) - _PORT_MESH == public(jmod)
        assert _N2_MESH <= public(pmod)
