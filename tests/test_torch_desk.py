"""The port's desk engines (`mcos_tpu_torch/engine/{pnl,modelrisk,margin,
hedge,volderivs,book,exposure}.py`) against the JAX package's on CPU, on
the same numpy-seeded inputs and on draws replayed from the JAX keys
(`fold_in(key, t)` → `split` → `normal(3, n)`, `uniform(n)`; per position
`fold_in(key(seed), i)` first for the book; `normal(fold_in(key, i),
(paths, assets))` a date for exposure), and the JAX package's own oracles
as cases.

Tolerances: host float64 parts (pnl, the VIX quadrature, the CIR law,
modelrisk's COS legs) 1e-10; modelrisk's float32 Black-Scholes leg to 4
float32 ulps of the spot; margin's price table, book prices and standard errors, replicate's
summaries and the realized variance rtol 1e-4; replicate's payoff samples
and terminals rtol 1e-5; book AD Greeks rtol 1e-3 beside 1e-5 × the
block's largest value; exposure's EE, PFE and CVA rtol 1e-4, cva_delta
1e-3. The cuda backends run the plain versions of K3, K4, K6 and K7 here
and are held by law against the torch backend, within 4 combined se; the
Monte Carlo legs on different streams within 5 combined se."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import book as jbook
from mcos_tpu.engine import exposure as jexposure
from mcos_tpu.engine import hedge as jhedge
from mcos_tpu.engine import margin as jmargin
from mcos_tpu.engine import modelrisk as jmodelrisk
from mcos_tpu.engine import pnl as jpnl
from mcos_tpu.engine import volderivs as jvol
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu_torch.engine import book as pbook
from mcos_tpu_torch.engine import exposure as pexposure
from mcos_tpu_torch.engine import hedge as phedge
from mcos_tpu_torch.engine import margin as pmargin
from mcos_tpu_torch.engine import modelrisk as pmodelrisk
from mcos_tpu_torch.engine import pnl as ppnl
from mcos_tpu_torch.engine import volderivs as pvol
from mcos_tpu_torch.models.params import SVJParams, gbm_params
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.cos_pricer import cos_price

torch.set_num_threads(1)

FIELDS = dict(kappa=2.0, theta=0.04, xi=0.5, rho=-0.6, v0=0.05,
              lambda_j=0.5, mu_j=-0.05, sigma_j=0.1, r=0.06, q=0.0)
SPOT = 100.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(**fields):
    f = dict(FIELDS, **fields)
    return SVJParams(**f), JSVJParams(**f)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_step_draws(key, n, steps):
    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_norm, (3, n), jnp.float32),
                jax.random.uniform(k_unif, (n,), jnp.float32))

    return jax.vmap(one)(jnp.arange(steps))


def _step_draws(key, n, steps):
    """The JAX twins' (z, u) for `key`: (steps, 3, n) and (steps, n)."""
    z, u = _jax_step_draws(key, n, steps)
    return _t(z), _t(u)


def _close(a, b, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _within_se(a, se_a, b, se_b, k=4.0, what=""):
    assert abs(a - b) < k * np.hypot(se_a, se_b), (what, a, b, se_a, se_b)


# ── pnl (host float64) ───────────────────────────────────────────────────────
PNL_P = dict(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04, lambda_j=1.0,
             mu_j=-0.05, sigma_j=0.1, r=0.065, q=0.012)
PS, PK, PT = 22500.0, 22500.0, 0.25


@pytest.mark.parametrize("move,spot_mult,dT,qty", [
    ({}, 1.0, 0.0, 1.0),
    ({"v0": 0.047, "xi": 0.45}, 0.985, 1 / 252, 1.0),
    ({"v0": 0.047, "theta": 0.052}, 0.99, 1 / 252, -3.0),
    ({}, 0.90, 0.0, 1.0),
])
def test_pnl_equals_jax(move, spot_mult, dT, qty):
    old, new = dict(PNL_P), dict(PNL_P, **move)
    args = (PS, PS * spot_mult, PT, PT - dT, PK)
    got = ppnl.pnl_explain(SVJParams(**old), SVJParams(**new), *args,
                           quantity=qty)
    ref = jpnl.pnl_explain(JSVJParams(**old), JSVJParams(**new), *args,
                           quantity=qty)
    assert got.keys() == ref.keys()
    assert got["attribution"].keys() == ref["attribution"].keys()
    for k in ("total_pnl", "explained", "unexplained", "price_old",
              "price_new"):
        _close(got[k], ref[k], 0.0, 1e-10, k)
    for block in ("attribution", "greeks_at_old"):
        for k in ref[block]:
            _close(got[block][k], ref[block][k], 0.0,
                   1e-10 * max(1.0, abs(ref[block][k])), f"{block}.{k}")
    # The JAX package's oracle: explained + unexplained is the total.
    assert got["explained"] + got["unexplained"] == pytest.approx(
        got["total_pnl"], abs=1e-9)


# ── modelrisk ────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("strike,is_call,svj", [
    (95.0, False, None),
    (100.0, True, dict(kappa=2.0, theta=0.05, xi=0.4, rho=-0.5, v0=0.06,
                       lambda_j=0.5, mu_j=-0.08, sigma_j=0.12, r=0.05,
                       q=0.01)),
])
def test_modelrisk_against_jax(strike, is_call, svj):
    kw = dict(is_call=is_call, num_paths=4096)
    got = pmodelrisk.model_risk_report(
        SPOT, strike, 0.25, svj=None if svj is None else SVJParams(**svj),
        device="cpu", **kw)
    ref = jmodelrisk.model_risk_report(
        SPOT, strike, 0.25, svj=None if svj is None else JSVJParams(**svj),
        **kw)
    assert got.keys() == ref.keys()
    assert got["prices"].keys() == ref["prices"].keys()
    for k in ("heston", "svj", "vg"):
        _close(got["prices"][k], ref["prices"][k], 0.0, 1e-10, k)
        _close(got["implied_vols"][k], ref["implied_vols"][k], 0.0, 1e-9, k)
    # Both float32: a put's two terms cancel, so the legs agree to a few
    # float32 ulps of the spot, not of the price.
    _close(got["prices"]["bs"], ref["prices"]["bs"], 0.0,
           4 * np.finfo(np.float32).eps * SPOT, "bs")
    for k in ("rough", "hhw"):
        _within_se(got["prices"][k], got["mc_std_errors"][k],
                   ref["prices"][k], ref["mc_std_errors"][k], 5.0, k)
    assert got["anchor_atm_vol"] == ref["anchor_atm_vol"]


def test_modelrisk_degenerate_collapse_and_hhw_backends():
    """The JAX package's oracle (degenerate SVJ collapses onto BS), and the
    HHW leg on K7's plain version against the twin by law."""
    deg = SVJParams(kappa=3.0, theta=0.04, xi=1e-4, rho=0.0, v0=0.04,
                    lambda_j=0.0, mu_j=0.0, sigma_j=1e-4, r=0.065, q=0.012)
    cuda = pmodelrisk.model_risk_report(22500.0, 22500.0, 0.25, svj=deg,
                                        num_paths=4096, device="cpu")
    p = cuda["prices"]
    assert p["heston"] == pytest.approx(p["bs"], rel=1e-4)
    assert p["svj"] == pytest.approx(p["bs"], rel=1e-4)
    twin = pmodelrisk.model_risk_report(22500.0, 22500.0, 0.25, svj=deg,
                                        num_paths=4096, backend="torch",
                                        device="cpu")
    _within_se(cuda["prices"]["hhw"], cuda["mc_std_errors"]["hhw"],
               twin["prices"]["hhw"], twin["mc_std_errors"]["hhw"], 4.0,
               "hhw")


# ── margin ───────────────────────────────────────────────────────────────────
def _margin_pair(n=4096, steps=64, seed=9, **fields):
    p, jp = _pair(**fields)
    got = pmargin.MarginEngine(p, num_paths=n, num_steps=steps, seed=seed,
                               backend="torch", device="cpu")
    key = jax.random.key(seed)
    got._draws = lambda s, T: _step_draws(
        jax.random.fold_in(key, int(round(T * 1e4))), n, s)
    ref = jmargin.MarginEngine(jp, num_paths=n, num_steps=steps, seed=seed)
    return got, ref


def _jax_price_table(ref, spot, strikes, Ts, calls):
    """The JAX engine's (3, positions, 9) table, as `margin` builds it."""
    factors = np.concatenate([[1.0], 1.0 + ref.psr * np.array(
        [1 / 3, 2 / 3, 1.0]), 1.0 - ref.psr * np.array([1 / 3, 2 / 3, 1.0]),
        [1.0 + ref.extreme_mult * ref.psr,
         1.0 - ref.extreme_mult * ref.psr]])
    batch = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]),
        jmargin._vol_shift(ref.params, -ref.vsr), ref.params,
        jmargin._vol_shift(ref.params, ref.vsr))
    out = np.zeros((3, len(strikes), 9))
    for T in np.unique(Ts):
        rows = np.nonzero(Ts == T)[0]
        k = (strikes[rows][:, None] / factors[None, :]).reshape(-1)
        flags = np.repeat(np.where(calls[rows], 1.0, -1.0), 9)
        from mcos_tpu.config import scaled_steps
        tab = jmargin._scenario_price_table(
            batch, spot, jnp.asarray(k, jnp.float32), float(T),
            jax.random.fold_in(jax.random.key(ref.seed), int(round(T * 1e4))),
            jnp.asarray(flags, jnp.float32), num_paths=ref.num_paths,
            num_steps=scaled_steps(ref.num_steps, float(T)))
        out[:, rows, :] = np.asarray(tab, np.float64).reshape(3, len(rows), 9)
    return out


def test_margin_price_table_and_report_match_jax():
    got, ref = _margin_pair()
    strikes = np.array([95.0, 100.0, 105.0, 100.0])
    # Two maturity groups (two seeds) on one step count: one JAX compile.
    Ts = np.array([0.25, 0.26, 0.25, 0.26])
    calls = np.array([False, True, True, False])
    qty = [-1.0, -2.0, 1.0, 3.0]
    tab = got.price_table(SPOT, strikes, Ts, calls)
    _close(tab, _jax_price_table(ref, SPOT, strikes, Ts, calls), 1e-4,
           1e-5 * SPOT, "price table")
    a = got.margin(SPOT, strikes, Ts, calls, qty)
    b = ref.margin(SPOT, strikes, Ts, calls, qty)
    assert a.keys() == b.keys()
    assert a["scenario_labels"] == b["scenario_labels"]
    assert a["worst_scenario"] == b["worst_scenario"]
    _close(a["risk_array"], b["risk_array"], 1e-3, 1e-4 * SPOT)
    _close(a["margin"], b["margin"], 1e-3)
    _close(a["net_option_value"], b["net_option_value"], 1e-4)


def test_margin_cuda_backend_by_law():
    """K3's plain version (three launches on one seed) against the member
    twin: each state's ATM call within 4 combined se."""
    p, _ = _pair()
    n, T = 8192, 0.5
    states = (pmargin._vol_shift(p, -0.04), p, pmargin._vol_shift(p, 0.04))
    est = {}
    for backend in ("cuda", "torch"):
        eng = pmargin.MarginEngine(p, num_paths=n, num_steps=64, seed=3,
                                   backend=backend, device="cpu")
        rows = []
        for s in eng._state_terminals(states, SPOT, T):
            pay = torch.clamp(s - SPOT, min=0.0).mean(dim=0).double()
            rows.append((float(pay.mean()), float(pay.std() / np.sqrt(n))))
        est[backend] = rows
    for (a, sa), (b, sb) in zip(est["cuda"], est["torch"]):
        _within_se(a, sa, b, sb, 4.0, "margin state price")
    # The three states of a maturity share their paths on K3: the vol
    # shift moves every state's price the same way.
    assert est["cuda"][0][0] < est["cuda"][1][0] < est["cuda"][2][0]


@pytest.fixture(scope="module")
def margin_eng():
    p, _ = _pair()
    return pmargin.MarginEngine(p, num_paths=20_000, num_steps=64, seed=9,
                                device="cpu")


@pytest.mark.parametrize("case", ["hedged", "short_call", "short_put",
                                  "long", "subadditive"])
def test_margin_oracles(margin_eng, case):
    """tests/test_margin.py's structural oracles on the cuda backend."""
    m = margin_eng.margin
    if case == "hedged":
        out = m(SPOT, [100.0, 100.0], [0.5, 0.5], [True, True], [5.0, -5.0])
        assert out["margin"] == 0.0
        assert all(abs(x) < 1e-9 for x in out["risk_array"])
    elif case == "short_call":
        out = m(SPOT, [100.0], [0.5], [True], [-1.0])
        assert out["margin"] > 0 and "price+" in out["worst_scenario"]
        assert out["num_scenarios"] == 16 == len(out["risk_array"])
    elif case == "short_put":
        out = m(SPOT, [100.0], [0.5], [False], [-1.0])
        assert out["margin"] > 0 and "price-" in out["worst_scenario"]
    elif case == "long":
        out = m(SPOT, [100.0], [0.5], [True], [1.0])
        assert 0.0 <= out["margin"] <= out["net_option_value"] + 1e-9
    else:
        a = m(SPOT, [95.0], [0.5], [False], [-2.0])
        b = m(SPOT, [105.0], [0.5], [True], [-3.0])
        both = m(SPOT, [95.0, 105.0], [0.5, 0.5], [False, True],
                 [-2.0, -3.0])
        assert both["margin"] <= a["margin"] + b["margin"] + 1e-9
        assert both["margin"] < a["margin"] + b["margin"] - 1e-6


def test_margin_scan_identity_and_chunking(monkeypatch):
    """tests/test_margin.py's scan identity: the payoff-axis spot transform
    against actually moving the spot (independent paths, 5 %); and the
    strike chunks change no price."""
    from mcos_tpu_torch.engine.pricer import MonteCarloEngine

    gbm = gbm_params(0.2, r=0.06, q=0.0)
    eng = pmargin.MarginEngine(gbm, num_paths=50_000, num_steps=64, seed=1,
                               device="cpu")
    out = eng.margin(SPOT, [100.0], [0.5], [True], [-1.0])

    def price(p, spot):
        return MonteCarloEngine(p, num_paths=50_000, num_steps=64, seed=5,
                                use_sobol=False, device="cpu").price(
            spot, 100.0, 0.5)["price"]

    direct = price(pmargin._vol_shift(gbm, 0.04), SPOT * 1.06) - price(
        gbm, SPOT)
    assert out["margin"] == pytest.approx(direct, rel=0.05)
    small = pmargin.MarginEngine(gbm, num_paths=2048, num_steps=16, seed=1,
                                 device="cpu")
    strikes = np.array([90.0, 100.0, 110.0])
    full = small.price_table(SPOT, strikes, np.full(3, 0.5),
                             np.array([True, False, True]))
    monkeypatch.setattr(pmargin, "_PAYOFF_CHUNK_BYTES", 4 * 2 * 2048 * 2)
    chunked = small.price_table(SPOT, strikes, np.full(3, 0.5),
                                np.array([True, False, True]))
    _close(chunked, full, 1e-6)


# ── replicate ────────────────────────────────────────────────────────────────
HEDGE_P = dict(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=0.5, mu_j=-0.05, sigma_j=0.10)
HS, HT = 22500.0, 0.25


def _basis(s_t, ks):
    return np.concatenate([np.ones((s_t.size, 1)), s_t[:, None],
                           np.maximum(s_t[:, None] - ks[None, :], 0.0)],
                          axis=1)


@pytest.mark.parametrize("kind,extra", [
    ("digital", {}),
    ("asian", {}),
    ("barrier", {"barrier": HS * 1.08, "knock": "out", "direction": "up"}),
    ("lookback", {"floating": True, "is_call": False}),
])
def test_replicate_matches_jax(kind, extra):
    n, steps, seed = 4096, 64, 11
    p, jp = SVJParams(**HEDGE_P), JSVJParams(**HEDGE_P)
    got = phedge.StaticHedgeEngine(p, num_paths=n, num_steps=steps,
                                   seed=seed, backend="torch", device="cpu")
    from mcos_tpu.config import scaled_steps
    n_steps = scaled_steps(steps, HT)
    got.draws = _step_draws(jax.random.key(seed), n, n_steps)
    ref = jhedge.StaticHedgeEngine(jp, num_paths=n, num_steps=steps,
                                   seed=seed)
    kw = dict(kind=kind, strike=HS, **extra)
    # The device pass: payoff samples and terminals.
    spec = dict(kind=kind, num_paths=n, num_steps=n_steps,
                is_call=extra.get("is_call", True), averaging="arithmetic",
                knock=extra.get("knock", "out"),
                direction=extra.get("direction", "up"),
                floating=extra.get("floating", False))
    a = phedge._target_and_terminals(
        p, HS, HS, HT, seed, extra.get("barrier", 0.0), backend="torch",
        draws=got.draws, device="cpu", **spec)
    b = jhedge._target_and_terminals(
        jp, HS, HS, HT, jax.random.key(seed), extra.get("barrier", 0.0),
        **spec)
    _close(a["s_t"].numpy(), np.asarray(b["s_t"]), 1e-5, 0.0, "s_t")
    _close(a["y"].numpy(), np.asarray(b["y"]), 1e-5,
           1e-5 * float(np.abs(np.asarray(b["y"])).max()), "y")
    x, y = got.replicate(HS, HT, **kw), ref.replicate(HS, HT, **kw)
    assert x.keys() == y.keys()
    for k in ("r2", "hedge_value", "target_price_mc", "target_se",
              "resid_std", "unhedgeable_fraction"):
        _close(x[k], y[k], 1e-4, 1e-9, k)
    scale = max(abs(v) for v in y["resid_quantiles"].values())
    for k in y["resid_quantiles"]:
        _close(x["resid_quantiles"][k], y["resid_quantiles"][k], 1e-4,
               1e-4 * scale, k)
    # The weights of a near-collinear strip, through the fitted values.
    ks = np.asarray(y["hedge_strikes"])
    fit = []
    for out, s_t in ((x, a["s_t"].numpy()), (y, np.asarray(b["s_t"]))):
        w = np.r_[out["weights"]["bond"], out["weights"]["forward"],
                  out["weights"]["calls"]]
        fit.append(_basis(s_t.astype(np.float64), ks) @ w)
    _close(fit[0], fit[1], 1e-4, 1e-4 * float(np.abs(fit[1]).max()),
           "fitted values")


def test_replicate_cuda_backend_by_law():
    """K6's plain version against the path-stats twin: the Asian's MC price
    within 4 combined se."""
    p = SVJParams(**HEDGE_P)
    out = {b: phedge.StaticHedgeEngine(
        p, num_paths=8192, num_steps=64, seed=4, backend=b,
        device="cpu").replicate(HS, HT, kind="asian", strike=HS)
        for b in ("cuda", "torch")}
    _within_se(out["cuda"]["target_price_mc"], out["cuda"]["target_se"],
               out["torch"]["target_price_mc"], out["torch"]["target_se"],
               4.0, "asian")


@pytest.fixture(scope="module")
def hedge_eng():
    return phedge.StaticHedgeEngine(SVJParams(**HEDGE_P), num_paths=50_000,
                                    num_steps=64, seed=11, device="cpu")


def test_replicate_vanilla_self_replication(hedge_eng):
    out = hedge_eng.replicate(HS, HT, kind="vanilla", strike=HS,
                              hedge_strikes=np.linspace(0.9, 1.1, 5) * HS)
    assert out["r2"] > 0.999999
    ref = float(cos_price(hedge_eng.params, HS, np.asarray([HS]), HT,
                          True)[0])
    assert out["hedge_value"] == pytest.approx(ref, rel=2e-3)
    assert out["resid_std"] < 1e-2 * ref


def test_replicate_digital_as_call_spread(hedge_eng):
    ks = np.linspace(0.94, 1.06, 13) * HS
    out = hedge_eng.replicate(HS, HT, kind="digital", strike=HS,
                              hedge_strikes=ks)
    assert out["r2"] > 0.93
    w = np.asarray(out["weights"]["calls"])
    assert abs(w.sum()) < 0.05 * np.abs(w).max()
    assert out["hedge_value"] == pytest.approx(
        out["target_price_mc"], abs=6 * out["target_se"] + 0.01)
    assert 0.0 < out["unhedgeable_fraction"] < 0.3
    with pytest.raises(ValueError):
        hedge_eng.replicate(HS, HT, kind="powerball")
    with pytest.raises(ValueError):
        hedge_eng.replicate(HS, HT, kind="digital", strike=HS,
                            hedge_strikes=[])


def test_replicate_gbm_digital_closed_form():
    from scipy.stats import norm

    sigma, r, q = 0.2, 0.065, 0.012
    e = phedge.StaticHedgeEngine(gbm_params(sigma, r=r, q=q),
                                 num_paths=100_000, num_steps=32, seed=3,
                                 device="cpu")
    out = e.replicate(HS, HT, kind="digital", strike=HS,
                      hedge_strikes=np.linspace(0.92, 1.08, 17) * HS)
    d2 = (r - q - 0.5 * sigma**2) * HT / (sigma * np.sqrt(HT))
    ref = float(np.exp(-r * HT) * norm.cdf(d2))
    assert out["target_price_mc"] == pytest.approx(
        ref, abs=4 * out["target_se"])
    assert out["hedge_value"] == pytest.approx(ref, abs=0.02 * ref + 5e-3)


# ── volderivs ────────────────────────────────────────────────────────────────
VOL_P = dict(kappa=2.0, theta=0.04, xi=0.5, rho=-0.6, v0=0.09, lambda_j=0.8,
             mu_j=-0.06, sigma_j=0.12, r=0.06, q=0.0)


def test_realized_variance_matches_jax():
    n, steps, seed, T = 4096, 48, 3, 0.75
    p, jp = SVJParams(**VOL_P), JSVJParams(**VOL_P)
    key = jax.random.key(seed)
    draws = _step_draws(key, n, steps)
    got = pvol.realized_variance_paths(p, T, num_paths=n, num_steps=steps,
                                       draws=draws, device="cpu")
    ref = jvol.realized_variance_paths(jp, T, key, num_paths=n,
                                       num_steps=steps)
    _close(got.numpy(), np.asarray(ref), 1e-4, 0.0, "rv")
    eng = pvol.VolDerivsEngine(p, num_paths=n, num_steps=64, seed=seed,
                               device="cpu")
    eng._rv_draws = lambda s: _step_draws(key, n, s)
    jeng = jvol.VolDerivsEngine(jp, num_paths=n, num_steps=64, seed=seed)
    for name in ("variance_swap", "vol_swap"):
        a, b = getattr(eng, name)(T), getattr(jeng, name)(T)
        assert a.keys() == b.keys()
        for k in b:
            _close(a[k], b[k], 1e-4, 1e-9, f"{name}.{k}")


@pytest.mark.parametrize("fields,T", [
    (VOL_P, 1.0),
    (dict(VOL_P, lambda_j=0.0), 0.3),
    (dict(VOL_P, xi=0.0), 0.5),
])
def test_vix_host_parts_equal(fields, T):
    p, jp = SVJParams(**fields), JSVJParams(**fields)
    for conv in ("log_contract", "quadratic_variation"):
        a = pvol.vix_squared_coefficients(p, 0.1, conv)
        b = jvol.vix_squared_coefficients(jp, 0.1, conv)
        for k in b:
            _close(a[k], b[k], 0.0, 1e-12, k)
    a, b = pvol.cir_terminal_law(p, T), jvol.cir_terminal_law(jp, T)
    assert a.keys() == b.keys()
    for k in b:
        if b[k] is None:
            assert a[k] is None
        else:
            _close(a[k], b[k], 1e-12, 1e-12, k)
    eng = pvol.VolDerivsEngine(p, device="cpu")
    jeng = jvol.VolDerivsEngine(jp)
    for a, b in ((eng.vix_future(T), jeng.vix_future(T)),
                 (eng.vix_option(T, 0.22, False),
                  jeng.vix_option(T, 0.22, False))):
        assert a.keys() == b.keys()
        for k in b:
            if k != "convention":
                _close(a[k], b[k], 0.0, 1e-10, k)
    # mesh= is ported (slice N1): it routes the variance swap only.
    assert pvol.VolDerivsEngine(p, mesh="auto", device="cpu").mesh == "auto"


def test_vix_future_mc_cuda_backend_by_law():
    """K4's plain version (one branch, 32 steps) against the QE twin, and
    both against the quadrature (4 se plus the reference's 2e-3 scheme
    allowance)."""
    p = SVJParams(**VOL_P)
    quad = pvol.VolDerivsEngine(p, device="cpu").vix_future(1.0)["future"]
    out = {b: pvol.VolDerivsEngine(p, num_paths=8192, seed=3, backend=b,
                                   device="cpu").vix_future_mc(1.0)
           for b in ("cuda", "torch")}
    _within_se(out["cuda"]["future_mc"], out["cuda"]["std_error"],
               out["torch"]["future_mc"], out["torch"]["std_error"], 4.0,
               "vix mc")
    for o in out.values():
        assert abs(o["future_mc"] - quad) < 4 * o["std_error"] + 2e-3


def test_volderivs_oracles():
    """tests/test_volderivs.py: the variance-swap pin, the vol swap under
    degenerate GBM, VIX parity and monotonicity."""
    eng = pvol.VolDerivsEngine(SVJParams(**VOL_P), num_paths=20_000,
                               num_steps=252, seed=3, device="cpu")
    out = eng.variance_swap(1.0)
    assert out["mc_vs_closed_sigmas"] < 4.0
    assert out["fair_variance"] == pytest.approx(
        out["diffusion_leg"] + out["jump_leg"])
    fut = eng.vix_future(1.0)["future"]
    for k in (0.15, 0.22, 0.30):
        call = eng.vix_option(1.0, k, is_call=True)
        put = eng.vix_option(1.0, k, is_call=False)
        assert call["price"] - put["price"] == pytest.approx(
            call["discount_factor"] * (fut - k), abs=1e-10)
    assert (eng.vix_option(1.0, 0.15)["price"]
            > eng.vix_option(1.0, 0.25)["price"] > 0)
    g = pvol.VolDerivsEngine(gbm_params(0.25, r=0.06, q=0.0),
                             num_paths=20_000, num_steps=128, seed=1,
                             device="cpu").vol_swap(0.5)
    assert g["fair_vol_strike"] == pytest.approx(0.25 - 0.25 * 2 / (8 * 64),
                                                 abs=2e-3)
    assert 0.0 < g["convexity_discount"] < 5e-3


# ── book ─────────────────────────────────────────────────────────────────────
def _book_draws(seed, n, steps, first, count):
    """Positions first..first+count−1 of the JAX book's keys, in the member
    layout (steps, 3, M, paths) and (steps, M, paths)."""
    zs, us = [], []
    for i in range(first, first + count):
        z, u = _step_draws(jax.random.fold_in(jax.random.key(seed), i), n,
                           steps)
        zs.append(z)
        us.append(u)
    return torch.stack(zs, dim=2), torch.stack(us, dim=1)


def test_book_matches_jax(monkeypatch):
    n, steps, seed = 2048, 8, 9
    p, jp = _pair()
    spots = [100.0, 100.0, 95.0, 110.0, 100.0]
    strikes = [100.0, 90.0, 100.0, 105.0, 120.0]
    Ts = [0.25, 0.5, 0.1, 1.0, 0.25]
    calls = [True, False, True, False, True]
    qty = [1.0, -2.0, 0.5, 1.0, 3.0]
    # Two positions a chunk: the chunks must not change a position's draws.
    monkeypatch.setattr(pbook, "_BOOK_CHUNK_BYTES",
                        2 * pbook._BYTES_PER_PATH_STEP * n * steps)
    eng = pbook.BookEngine(p, num_paths=n, num_steps=steps, seed=seed,
                           device="cpu")
    eng._draws = lambda gen, first, count: _book_draws(seed, n, steps, first,
                                                       count)
    got = eng.price_book(spots, strikes, Ts, calls, qty)
    ref = jbook.BookEngine(jp, num_paths=n, num_steps=steps,
                           seed=seed).price_book(spots, strikes, Ts, calls,
                                                 qty)
    assert got.keys() == ref.keys()
    for k in ("price", "std_error"):
        _close(got[k], ref[k], 1e-4, 0.0, k)
    for k in ("delta", "theta", "vega", "vega_v0", "rho"):
        r_ = np.asarray(ref[k])
        _close(got[k], r_, 1e-3, 1e-5 * np.abs(r_).max(), k)
    for k in ("book_value", "book_delta", "book_theta", "book_vega",
              "book_rho"):
        _close(got[k], ref[k], 1e-3, 1e-5 * max(abs(ref[k]), 1.0), k)
    assert got["num_positions"] == 5


def test_book_own_draws_and_oracles(monkeypatch):
    """Each position's draws come from one generator in position order
    (chunking changes nothing), and tests/test_book.py's flat book: long
    one, short one under GBM nets to zero."""
    p, _ = _pair()
    args = ([100.0, 100.0, 100.0], [100.0, 95.0, 105.0], [0.25, 0.25, 0.5],
            [True, False, True])
    one = pbook.BookEngine(p, num_paths=1024, num_steps=8, seed=2,
                           device="cpu")
    full = one.price_book(*args)
    monkeypatch.setattr(pbook, "_BOOK_CHUNK_BYTES",
                        pbook._BYTES_PER_PATH_STEP * 1024 * 8)
    chunked = one.price_book(*args)
    for k in ("price", "delta", "vega"):
        np.testing.assert_array_equal(chunked[k], full[k])
    eng = pbook.BookEngine(gbm_params(0.2, r=0.065, q=0.012),
                           num_paths=20_000, num_steps=32, seed=1,
                           device="cpu")
    out = eng.price_book([100.0, 100.0], [100.0, 100.0], [0.25, 0.25],
                         [True, True], quantities=[1.0, -1.0])
    assert out["book_value"] == pytest.approx(0.0, abs=1e-4)
    assert out["book_delta"] == pytest.approx(0.0, abs=1e-6)
    assert out["book_vega"] == pytest.approx(0.0, abs=1e-4)
    assert out["book_rho"] == pytest.approx(0.0, abs=1e-4)
    c0 = float(bs_price(100.0, 100.0, 0.25, 0.065, 0.012, 0.2, True))
    assert out["price"][0] == pytest.approx(c0, rel=1e-5)


# ── exposure ─────────────────────────────────────────────────────────────────
XS, XSIG, XR, XQ, XT = 100.0, 0.25, 0.05, 0.0, 1.0
XCALL = {"kind": "call", "strike": 100.0, "T": XT, "qty": 1.0}


def _date_normals(seed, n, assets, dates):
    key = jax.random.key(seed)
    z = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (n, assets), jnp.float32))
        for i in range(dates)])
    return torch.from_numpy(z)


def test_exposure_matches_jax():
    n, seed, dates = 4096, 5, 8
    spots, sigmas = [100.0, 50.0], [0.25, 0.35]
    corr = [[1.0, 0.5], [0.5, 1.0]]
    book = [{"kind": "call", "strike": 100.0, "T": 1.0, "qty": 1.0,
             "asset": 0},
            {"kind": "put", "strike": 50.0, "T": 0.5, "qty": -2.0,
             "asset": 1},
            {"kind": "forward", "strike": 95.0, "T": 0.75, "qty": 0.5,
             "asset": 0}]
    got = pexposure.ExposureEngine(spots, sigmas, corr, book, r=XR,
                                   num_paths=n, seed=seed, device="cpu")
    z = _date_normals(seed, n, 2, dates)
    got._date_normals = lambda: (lambda i: z[i])
    ref = jexposure.ExposureEngine(spots, sigmas, corr, book, r=XR,
                                   num_paths=n, seed=seed)
    for kw in ({}, {"quantile": 0.9}):
        a = got.profile(num_dates=dates, **kw)
        b = ref.profile(num_dates=dates, **kw)
        assert a.keys() == b.keys()
        for k in ("ee", "ene", "pfe", "gross_ee", "epe", "ene_avg",
                  "netting_benefit"):
            _close(a[k], b[k], 1e-4, 1e-5, k)
    a = got.cva(hazard_rate=0.03, num_dates=dates, own_hazard=0.01)
    b = ref.cva(hazard_rate=0.03, num_dates=dates, own_hazard=0.01)
    assert a.keys() == b.keys()
    for k in b:
        _close(a[k], b[k], 1e-4, 1e-9, k)
    a = got.cva_delta(0.03, 0.6, dates)
    b = ref.cva_delta(0.03, 0.6, dates)
    _close(a["cva"], b["cva"], 1e-4, 0.0, "cva")
    _close(a["cva_delta"], b["cva_delta"], 1e-3, 0.0, "cva_delta")


def _xeng(positions, num_paths=100_000, seed=1, spot=XS):
    return pexposure.ExposureEngine([spot], [XSIG], [[1.0]], positions, r=XR,
                                    q=[XQ], num_paths=num_paths, seed=seed,
                                    device="cpu")


def test_exposure_forward_ee_matches_black():
    from scipy.stats import norm

    fwd = {"kind": "forward", "strike": 100.0, "T": XT, "qty": 1.0}
    prof = _xeng([fwd], num_paths=200_000, seed=2).profile(num_dates=4,
                                                           horizon=0.8)
    t = np.asarray(prof["dates"])
    f_mean = XS * np.exp((XR - XQ) * XT)
    s_ = XSIG * np.sqrt(t)
    d1 = (np.log(f_mean / 100.0) + 0.5 * s_**2) / s_
    oracle = np.exp(-XR * (XT - t)) * (f_mean * norm.cdf(d1)
                                       - 100.0 * norm.cdf(d1 - s_))
    np.testing.assert_allclose(np.asarray(prof["ee"]), oracle, rtol=0.02)


def test_exposure_call_cva_closed_form():
    c0 = float(bs_price(XS, 100.0, XT, XR, XQ, XSIG, True))
    h, lgd, hor = 0.03, 0.6, 0.999 * XT
    cva = _xeng([XCALL], num_paths=200_000).cva(
        hazard_rate=h, lgd=lgd, num_dates=16, horizon=hor)
    assert cva["cva"] == pytest.approx(lgd * c0 * (1.0 - np.exp(-h * hor)),
                                       rel=0.01)


def test_exposure_cva_delta_matches_crn_fd():
    d = _xeng([XCALL]).cva_delta(hazard_rate=0.03, lgd=0.6, num_dates=8)
    h = 0.5
    fd = (_xeng([XCALL], spot=XS + h).cva_delta(0.03, 0.6, 8)["cva"]
          - _xeng([XCALL], spot=XS - h).cva_delta(0.03, 0.6, 8)["cva"]) \
        / (2 * h)
    assert d["cva_delta"][0] == pytest.approx(fd, abs=1e-4)


def test_exposure_quantile_rows_numpy():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 1001))
                         .astype(np.float32))
    for q in (0.5, 0.975, 0.9):
        _close(pexposure._quantile_rows(x, q).numpy(),
               np.quantile(x.numpy(), q, axis=1), 1e-6, 1e-6)


def test_simulate_terminal_members_member_draws():
    """A member axis on the draws: each member equals the shared-draws twin
    on its own draws, bit for bit."""
    from mcos_tpu_torch.ops import simulate

    p, _ = _pair()
    g = torch.Generator().manual_seed(0)
    draws = [simulate._euler_draws(None, g, 256, 12, "cpu") for _ in range(3)]
    z = torch.stack([d[0] for d in draws], dim=2)
    u = torch.stack([d[1] for d in draws], dim=1)
    T = torch.tensor([0.1, 0.5, 1.0])
    s, gg, score = simulate.simulate_terminal_members(p, 100.0, T,
                                                      draws=(z, u))
    assert s.shape == (3, 2, 256) and score.shape == (3, 256)
    for m in range(3):
        s1, g1, sc1 = simulate.simulate_terminal_members(
            p, 100.0, T[m:m + 1], draws=draws[m])
        assert torch.equal(s[m], s1[0]) and torch.equal(gg[m], g1[0])
        assert torch.equal(score[m], sc1[0])
    with pytest.raises(ValueError):
        simulate.simulate_terminal_members(p, 100.0, T, draws=(z[:, :2], u))
