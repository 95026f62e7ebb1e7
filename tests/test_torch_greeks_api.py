"""`/api/greeks` and `/api/smile` of the port against the JAX handlers on
CPU: the same keys, the same 400s, values within 5 standard errors where
the Monte Carlo streams differ and to float32 rounding where they do not
(COS, and the Sobol net with no jumps); `price_term_structure` by law; the
pricer's host wrappers."""

import numpy as np
import pytest
import torch

from mcos_tpu.api import schemas as jschemas
from mcos_tpu.api import server as jserver
from mcos_tpu.engine.pricer import MonteCarloEngine as JEngine
from mcos_tpu.engine.pricer import price_term_structure as jterm
from mcos_tpu.models.params import TermStructureSVJ as JTerm
from mcos_tpu_torch.api import schemas as pschemas
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.engine import greeks as pg
from mcos_tpu_torch.engine import pricer as ppricer
from mcos_tpu_torch.models.params import TermStructureSVJ
from mcos_tpu_torch.ops import cuda_kernels, simulate

torch.set_num_threads(1)

SPOT, T = 100.0, 0.1                  # 25 steps at 252 a year
PATHS = 2048
BODY = {"spot": SPOT, "strike": SPOT, "T": T, "num_paths": PATHS}
FULL = dict(BODY, with_cross=True, with_second_order=True,
            with_min_variance=True)
SEEDS = 12


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, row in enumerate(v):
                out.update(_flat(row, f"{prefix}{k}[{i}]."))
        else:
            out[prefix + k] = v
    return out


def _port(handler, body):
    return getattr(pserver, handler)(dict(body), device="cpu")


@pytest.fixture(scope="module")
def full_se():
    """Each Greek's standard error at this request's width: the spread of
    the port's engine over SEEDS seeds (the handler's blocks, seeds 1...)."""
    rows = []
    for seed in range(1, SEEDS + 1):
        eng = pg.GreeksEngine(pschemas.SVJParamsRequest().to_params(),
                              num_paths=PATHS, seed=seed, device="cpu")
        out = eng.all_greeks(SPOT, SPOT, T)
        out["cross"] = eng.cross_greeks(SPOT, SPOT, T)
        out["second_order"] = eng.second_order_greeks(SPOT, SPOT, T)
        out["min_variance"] = eng.min_variance_delta(SPOT, SPOT, T)
        rows.append(_flat(out))
    return {k: float(np.std([r[k] for r in rows], ddof=1)) for k in rows[0]}


def test_request_schemas_equal():
    for name in ("GreeksRequest", "SmileRequest"):
        a, b = getattr(jschemas, name), getattr(pschemas, name)
        assert a.model_json_schema() == b.model_json_schema(), name
    body = dict(FULL, strikes=[90.0], dividends=[{"t": 0.05, "amount": 1.0}])
    assert (jschemas.GreeksRequest(**body).model_dump()
            == pschemas.GreeksRequest(**body).model_dump())


def test_handle_greeks_matches_jax(full_se):
    """Every block of a single-contract request: the JAX handler's keys, and
    each value within 5 combined standard errors (two independent streams:
    √2 × the port's spread over seeds)."""
    ref = _flat(jserver.handle_greeks(dict(FULL)))
    got = _flat(_port("handle_greeks", FULL))
    assert got.keys() == ref.keys()
    ref.pop("elapsed_ms"), got.pop("elapsed_ms")
    assert got.keys() == full_se.keys()
    for k in ref:
        tol = 5 * np.sqrt(2.0) * full_se[k]
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k], tol)


def test_handle_greeks_chain_matches_jax(full_se):
    body = dict(BODY, strike=0.0, strikes=[95.0, SPOT, 105.0])
    ref = jserver.handle_greeks(dict(body))
    got = _port("handle_greeks", body)
    assert _flat(got).keys() == _flat(ref).keys()
    assert [r["strike"] for r in got["chain"]] == [95.0, SPOT, 105.0]
    atm = _flat(got["chain"][1])
    for k, v in _flat(ref["chain"][1]).items():
        if k != "strike":
            assert abs(atm[k] - v) <= 5 * np.sqrt(2.0) * full_se[k], k


@pytest.mark.parametrize("kind,amount", [("cash", 1.5),
                                         ("proportional", 0.015)])
def test_handle_greeks_dividends(kind, amount):
    """The JAX handler's layout and dividend block; the chain rule on the
    port's own effective-spot Greeks, exactly."""
    body = dict(BODY, with_cross=True, dividend_kind=kind,
                dividends=[{"t": 0.05, "amount": amount}])
    ref = jserver.handle_greeks(dict(body))
    got = _port("handle_greeks", body)
    assert _flat(got).keys() == _flat(ref).keys()
    assert got["dividends"]["model"] == ref["dividends"]["model"]
    assert (got["dividends"]["spot_effective"]
            == ref["dividends"]["spot_effective"])
    eff = got["dividends"]["spot_effective"]
    f = 1.0 if kind == "cash" else got["dividends"]["chain_factor"]
    eng = pg.GreeksEngine(pschemas.SVJParamsRequest().to_params(),
                          num_paths=PATHS, device="cpu")
    plain = eng.all_greeks(eff, SPOT, T)
    assert got["delta"]["pathwise"] == pytest.approx(
        f * plain["delta"]["pathwise"], rel=1e-12)
    assert got["gamma"]["gamma"] == pytest.approx(
        f * f * plain["gamma"]["gamma"], rel=1e-12)
    assert got["vega"] == plain["vega"]
    cross = eng.cross_greeks(eff, SPOT, T)
    assert got["cross"]["vanna"] == pytest.approx(f * cross["vanna"],
                                                  rel=1e-12)
    assert got["cross"]["volga"] == cross["volga"]


_DIV = [{"t": 0.05, "amount": 1.0}]
_400 = [
    ("handle_greeks", dict(BODY, strikes=[100.0], with_cross=True)),
    ("handle_greeks", dict(BODY, strikes=[100.0], with_second_order=True)),
    ("handle_greeks", dict(BODY, strikes=[100.0], dividends=_DIV)),
    ("handle_greeks", dict(BODY, strike=0.0)),
    ("handle_greeks", dict(BODY, strike=-5.0)),
    ("handle_greeks", dict(BODY, dividend_kind="proportional",
                           dividends=[{"t": 0.05, "amount": 1.0}])),
    ("handle_greeks", dict(BODY, dividends=[{"t": 0.05, "amount": 150.0}])),
    ("handle_greeks", dict(BODY, with_second_order=True, dividends=_DIV)),
    ("handle_greeks", dict(BODY, with_min_variance=True, dividends=_DIV)),
    ("handle_smile", {"spot": SPOT, "T": T, "num_paths": PATHS,
                      "rate_curve": [{"t": 1.0, "r": 0.05},
                                     {"t": 1.0, "r": 0.06}]}),
    ("handle_smile", {"spot": SPOT, "T": T, "method": "pde"}),
]


@pytest.mark.parametrize("handler,body", _400)
def test_bad_requests_answer_400_as_jax(handler, body):
    with pytest.raises(jserver.ApiError) as ref:
        getattr(jserver, handler)(dict(body))
    with pytest.raises(pserver.ApiError) as got:
        _port(handler, body)
    assert ref.value.status == got.value.status == 400
    assert got.value.detail == ref.value.detail


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_smile_mc_runs_k1_plain_on_the_sobol_net(monkeypatch):
    """Without jumps both packages price the bit-identical Sobol net: the
    port's K1 plain version (once a request, no twin) matches JAX's
    price_batch and the JAX handler to float32 rounding."""
    k1 = _counting(monkeypatch, cuda_kernels, "svj_terminal_from_draws")
    twin = _counting(monkeypatch, simulate, "simulate_terminal_from_draws")
    body = {"spot": SPOT, "T": 0.25, "num_paths": 4096, "num_strikes": 9,
            "params": {"lambda_j": 0.0}}
    got = _port("handle_smile", body)
    assert len(k1) == 1 and not twin
    ref = jserver.handle_smile(dict(body))
    assert got.keys() == ref.keys() == {"smile", "method"}
    assert got["method"] == "mc"
    strikes = [row["strike"] for row in ref["smile"]]
    rows = JEngine(jschemas.SVJParamsRequest(lambda_j=0.0).to_params(),
                   num_paths=4096).price_batch(SPOT, strikes, 0.25)
    for a, b, c in zip(got["smile"], ref["smile"], rows):
        assert a["strike"] == b["strike"]
        # float32 rounding of a mean of payoffs of order the spot.
        for other in (b, c):
            np.testing.assert_allclose(a["price"], other["price"],
                                       rtol=1e-4, atol=1e-6 * SPOT)
        np.testing.assert_allclose(a["iv"], b["iv"], rtol=1e-3)


def test_smile_mc_with_jumps_within_5_se():
    body = {"spot": SPOT, "T": 0.25, "num_paths": 4096, "num_strikes": 7}
    got = _port("handle_smile", body)
    ref = jserver.handle_smile(dict(body))
    eng = ppricer.MonteCarloEngine(pschemas.SVJParamsRequest().to_params(),
                                   num_paths=4096, device="cpu")
    rows = eng.price_batch(SPOT, [r["strike"] for r in got["smile"]], 0.25)
    for a, b, c in zip(got["smile"], ref["smile"], rows):
        assert a.keys() == b.keys()
        assert abs(a["price"] - b["price"]) <= 5 * np.sqrt(2) * c["std_error"]
        assert a["iv"] > 0 and b["iv"] > 0


def test_smile_cos_and_density_match_jax():
    body = {"spot": SPOT, "T": 0.5, "method": "cos", "with_density": True,
            "rate_curve": [{"t": 0.25, "r": 0.04}, {"t": 1.0, "r": 0.06}]}
    got = _port("handle_smile", body)
    ref = jserver.handle_smile(dict(body))
    assert got.keys() == ref.keys() and got["method"] == "cos"
    for a, b in zip(got["smile"], ref["smile"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    assert got["density"].keys() == ref["density"].keys()
    for k in ("s", "pdf"):
        np.testing.assert_allclose(got["density"][k], ref["density"][k],
                                   rtol=1e-6)
    assert got["density"]["forward"] == pytest.approx(
        ref["density"]["forward"], rel=1e-12)


def test_price_term_structure_matches_jax_by_law(monkeypatch):
    """One K3 (plain on the CPU) call a maturity; each strike within 5
    combined standard errors of the JAX package's PRNG prices."""
    k3 = _counting(monkeypatch, cuda_kernels, "svj_terminal")
    curves = dict(theta_curve={0.25: 0.04, 1.0: 0.06},
                  xi_curve={0.25: 0.6, 1.0: 0.4},
                  lambda_curve={0.25: 2.0, 1.0: 1.0})
    mats, strikes = [0.2, 0.5], [90.0, 100.0, 110.0]
    got = ppricer.price_term_structure(
        TermStructureSVJ(**curves), SPOT, strikes, mats, num_paths=4096,
        num_steps=64, device="cpu")
    assert len(k3) == len(mats)
    ref = jterm(JTerm(**curves), SPOT, strikes, mats, num_paths=4096,
                num_steps=64)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g["maturity"] == r["maturity"]
        assert g["params"] == pytest.approx(r["params"], rel=1e-12)
        for a, b in zip(g["chain"], r["chain"]):
            assert a.keys() == b.keys() and a["strike"] == b["strike"]
            se = np.hypot(a["std_error"], b["std_error"])
            assert abs(a["price"] - b["price"]) <= 5 * se


def test_host_sample_wrappers():
    eng = ppricer.MonteCarloEngine(pschemas.SVJParamsRequest().to_params(),
                                   num_paths=2048, device="cpu")
    paths = eng.get_sample_paths(SPOT, 0.2, num_samples=7)
    assert isinstance(paths, np.ndarray) and paths.shape == (7, 51)
    np.testing.assert_array_equal(
        paths, eng.sample_paths_device(SPOT, 0.2, 7).numpy())
    terms = eng.terminal_samples(SPOT, 0.2, num_samples=64)
    assert terms.shape == (64,) and (terms > 0).all()
    np.testing.assert_array_equal(
        terms, eng.terminal_samples_device(SPOT, 0.2, 64).numpy())
