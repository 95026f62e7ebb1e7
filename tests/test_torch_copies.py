"""The port's copies of JAX-free modules against their originals: the same
public names and the same outputs on a few inputs."""

import dataclasses
import json

import numpy as np
import pytest

import mcos_tpu.api.schemas as jschemas
import mcos_tpu.config as jconfig
import mcos_tpu.ops.cos_pricer as jcos
import mcos_tpu.ops.curves as jcurves
import mcos_tpu.ops.dividends as jdivs
import mcos_tpu.ops.exotics as jexotics
import mcos_tpu.utils.fastjson as jfastjson
import mcos_tpu_torch.api.schemas as pschemas
import mcos_tpu_torch.config as pconfig
import mcos_tpu_torch.ops.cos_pricer as pcos
import mcos_tpu_torch.ops.curves as pcurves
import mcos_tpu_torch.ops.dividends as pdivs
import mcos_tpu_torch.ops.exotics as pexotics
import mcos_tpu_torch.utils.fastjson as pfastjson
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu_torch.models.params import SVJParams


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and getattr(getattr(mod, n), "__module__", mod.__name__)
            in (mod.__name__, None)}


@pytest.mark.parametrize("jmod,pmod", [
    (jconfig, pconfig), (jcurves, pcurves), (jdivs, pdivs),
    (jcos, pcos), (jfastjson, pfastjson),
])
def test_same_public_names(jmod, pmod):
    assert _public(pmod) == _public(jmod)


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
