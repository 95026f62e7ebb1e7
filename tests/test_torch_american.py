"""`mcos_tpu_torch/engine/american.py` against `mcos_tpu/engine/american.py`
on the JAX key's draws, replayed into the port (`fold_in(key, t)` →
`split` → `normal(3, n)`, `uniform(n)` per step; the dual's inner halves
per step from the second half of its key).

Tolerances: the recorded sheet, the European legs and every function fed
the same policy are float32 on both sides (rtol 1e-5, the Greeks 1e-4).
The regressions that fit a policy are float32 normal equations whose
fitted continuation differs from the reference's by rounding (~1e-3 of
the price); a path whose payoff sits that close to its continuation
exercises in one package and not in the other, and the in-sample fit then
moves with it. Those flips are counted, and the prices held within half a
standard error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.american as ja
import mcos_tpu_torch.engine.american as pa
from mcos_tpu.models.params import SVJParams as JSVJ
from mcos_tpu.ops.curves import RateCurve as JCurve
from mcos_tpu.ops.dividends import DividendSchedule as JDivs
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.curves import RateCurve
from mcos_tpu_torch.ops.dividends import DividendSchedule

torch.set_num_threads(1)

N, STEPS, SEED = 4000, 16, 7
S0, K, T = 100.0, 100.0, 0.5


def _replayed(key, n=N, steps=STEPS):
    """The JAX recorder's (z (steps, 3, n), u (steps, n)) for `key`."""
    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_norm, (3, n), jnp.float32),
                jax.random.uniform(k_unif, (n,), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _inner(key, steps, half, n):
    """The dual's per-step inner halves for its inner key."""
    def one(k):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, k))
        return (jax.random.normal(k_norm, (3, half, n), jnp.float32),
                jax.random.uniform(k_unif, (half, n), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps, dtype=jnp.int32))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def key():
    return jax.random.key(SEED)


@pytest.fixture(scope="module")
def draws(key):
    return _replayed(key)


@pytest.fixture(scope="module")
def trained(key):
    """The JAX policy/value fit of the put on the key's sheet."""
    return ja.lsm_train(JSVJ(), S0, K, T, key, num_paths=N, num_steps=STEPS,
                        is_call=False)


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


# ── the recorded sheet ──────────────────────────────────────────────────────
_TD = np.stack([np.linspace(0.03, 0.09, STEPS), np.linspace(0.4, 0.9, STEPS),
                np.linspace(0.5, 4.0, STEPS)]).astype(np.float32)


@pytest.mark.parametrize("td", [None, "td", "constant"])
def test_recorded_sheet_matches_jax(key, draws, td):
    """rtol 1e-5: float32 on both sides; a constant table is the
    constant-parameter sheet."""
    p = SVJParams()
    table = {None: None, "td": _TD,
             "constant": np.stack([np.full(STEPS, p.theta),
                                   np.full(STEPS, p.xi),
                                   np.full(STEPS, p.lambda_j)])}[td]
    ref = ja._record_log_paths(JSVJ(), S0, T, key, num_paths=N,
                               num_steps=STEPS,
                               td_table=None if table is None
                               else jnp.asarray(table, jnp.float32))
    got = pa._record_log_paths(p, S0, T, draws=draws, td_table=table)
    assert got.shape == (STEPS, N)
    _close(got, ref, rtol=1e-5)
    if td == "constant":
        _close(got, pa._record_log_paths(p, S0, T, draws=draws), rtol=0)


@pytest.mark.parametrize("kind", ["cash", "proportional"])
def test_dividend_sheets_match_jax(draws, kind):
    log_paths = pa._record_log_paths(SVJParams(), S0, T, draws=draws)
    s = torch.exp(log_paths)
    grid = np.zeros(STEPS, np.float32)
    grid[[3, 11]] = (2.5, 4.0) if kind == "cash" else (0.03, 0.05)
    floor = np.float32(1e-6 * K)
    ref = ja._dividend_sheets(jnp.asarray(s.numpy()), jnp.asarray(grid),
                              kind, floor)
    got = pa._dividend_sheets(s, torch.from_numpy(grid), kind,
                              torch.tensor(floor))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-6)
    assert not torch.equal(got[0], got[1])     # the ex-dates differ


def test_rate_and_dividend_args_match_jax():
    """The engine's host vectors: the curve's offsets, step discounts and
    integrals, and the dividend grid, equal (float32) to the reference's."""
    times, rates = [0.2, 0.6], [0.03, 0.07]
    divs = ([0.1, 0.35], [1.0, 2.0], "cash")
    jeng = ja.AmericanEngine(JSVJ(), num_paths=N, rate_curve=JCurve(times,
                                                                     rates),
                             dividends=JDivs(*divs))
    peng = pa.AmericanEngine(SVJParams(), num_paths=N,
                             rate_curve=RateCurve(times, rates),
                             dividends=DividendSchedule(*divs), device="cpu")
    for for_lb in (False, True):
        ref = jeng._rate_args(T, STEPS, for_lb)
        got = peng._rate_args(T, STEPS, for_lb)
        assert got.keys() == ref.keys()
        for k in ref:
            _close(np.float32(got[k]), ref[k], rtol=0)
    ref, got = jeng._div_args(T, STEPS), peng._div_args(T, STEPS)
    assert got["div_kind"] == ref["div_kind"] == "cash"
    _close(np.float32(got["div_grid"]), ref["div_grid"], rtol=0)
    assert peng._params_T(T).r == pytest.approx(float(jeng._params_T(T).r))


def test_exercise_mask_and_basis():
    for every in (1, 3, STEPS):
        assert np.array_equal(pa._exercise_mask(STEPS, every),
                              ja._exercise_mask(STEPS, every))
    s = np.linspace(60.0, 140.0, 41, dtype=np.float32)
    for is_call in (True, False):
        _close(pa._basis_fn(torch.tensor(K), is_call, 3)(torch.from_numpy(s)),
               ja._basis_fn(jnp.float32(K), is_call, 3)(jnp.asarray(s)),
               rtol=1e-6)
    _close(pa._value_basis(torch.tensor(K))(torch.from_numpy(s)),
           ja._value_basis(jnp.float32(K))(jnp.asarray(s)), rtol=1e-6)


# ── the regressions ─────────────────────────────────────────────────────────
def test_solve_normal_equations_fits_what_jax_fits(draws):
    """One date's ITM-masked normal equations, the same float32 inputs:
    the fitted continuation agrees to rounding (the coefficients need not:
    payoff/K and u are collinear on an ITM put sample); a singular system
    gives non-finite coefficients, as the reference's solve does."""
    s = torch.exp(pa._record_log_paths(SVJParams(), S0, T, draws=draws))
    basis = pa._basis_fn(torch.tensor(K), False, 3)
    cf = torch.clamp(K - s[-1], min=0.0)
    for t in (2, 8, STEPS - 2):
        b = basis(s[t])
        w = (K - s[t] > 0).to(torch.float32)
        gram, rhs = b.T @ (b * w[:, None]), (b * w[:, None]).T @ cf
        got = pa.solve_normal_equations(gram, rhs)
        ref = ja.solve_normal_equations(jnp.asarray(gram.numpy()),
                                        jnp.asarray(rhs.numpy()))
        itm = w > 0
        _close((b @ got)[itm], (b @ _t(ref))[itm], rtol=0,
               atol=2e-4 * float(cf.max()))
    bad = torch.full((5, 5), float("nan"))
    assert not torch.isfinite(pa.solve_normal_equations(
        bad, torch.ones(5))).any()


def test_lsm_train_policy_and_value_match_jax(key, draws, trained):
    """The fits of the last date see the same cashflows in both packages:
    fitted values equal to rounding. Earlier dates inherit any exercise
    flip; the two policies, run on one evaluation sheet, stop the same
    paths but for the flips (≤ 3 % of paths) and price within half a
    standard error."""
    got = pa.lsm_train(SVJParams(), S0, K, T, draws=draws, is_call=False)
    assert got["policy"].shape == (STEPS - 1, 5)
    assert got["value"].shape == (STEPS - 1, 4)
    s = torch.exp(pa._record_log_paths(SVJParams(), S0, T, draws=draws))
    last = s[STEPS - 2]
    itm = last < K
    for name, basis in (("policy", pa._basis_fn(torch.tensor(K), False, 3)),
                        ("value", pa._value_basis(torch.tensor(K)))):
        b = basis(last)
        mask = itm if name == "policy" else torch.ones_like(itm)
        ref = (b @ _t(trained[name][-1]))[mask]
        _close((b @ got[name][-1])[mask], ref, rtol=0,
               atol=1e-4 * float(ref.abs().max()))
    eval_draws = _replayed(jax.random.key(SEED + 1))
    vals = [pa._lower_bound_values(SVJParams(), S0, K, T, None, c,
                                   draws=eval_draws, is_call=False)
            for c in (got["policy"], _t(trained["policy"]))]
    assert int((vals[0] != vals[1]).sum()) <= 0.03 * N
    se = float(torch.std(vals[1], correction=0)) / np.sqrt(N)
    assert abs(float(vals[0].mean() - vals[1].mean())) < 0.5 * se


@pytest.mark.parametrize("is_call,q", [(False, 0.0), (True, 0.08)])
def test_lsm_price_matches_jax(key, draws, is_call, q):
    """In-sample LSM: price within half a standard error, standard errors
    within 5 %, the intrinsic equal."""
    jp, pp = JSVJ(q=q), SVJParams(q=q)
    ref = ja.lsm_price(jp, S0, K, T, key, num_paths=N, num_steps=STEPS,
                       is_call=is_call)
    got = pa.lsm_price(pp, S0, K, T, draws=draws, is_call=is_call)
    assert got.keys() == ref.keys()
    se = float(ref["std_error"])
    assert abs(float(got["price"]) - float(ref["price"])) < 0.5 * se
    _close(got["std_error"], ref["std_error"], rtol=0.05)
    _close(got["intrinsic"], ref["intrinsic"], rtol=0)


@pytest.mark.parametrize("every", [1, 4, STEPS])
def test_exercise_every_matches_jax(key, draws, every):
    """Bermudan schedules on the same sheet: European at every = steps
    (no regression decides anything: rtol 1e-5), and the LSM within half a
    standard error at 1 and 4."""
    ref = ja.lsm_price(JSVJ(), S0, 105.0, T, key, num_paths=N,
                       num_steps=STEPS, is_call=False, exercise_every=every)
    got = pa.lsm_price(SVJParams(), S0, 105.0, T, draws=draws,
                       is_call=False, exercise_every=every)
    if every == STEPS:
        for k in ref:
            _close(got[k], ref[k], rtol=1e-5)
        s_T = torch.exp(pa._record_log_paths(SVJParams(), S0, T,
                                             draws=draws)[-1])
        euro = np.exp(-SVJParams().r * T) * torch.clamp(105.0 - s_T,
                                                        min=0).mean()
        _close(got["price"], euro, rtol=1e-5)
    else:
        assert abs(float(got["price"]) - float(ref["price"])) \
            < 0.5 * float(ref["std_error"])


def test_lsm_lower_bound_on_the_same_policy_matches_jax(trained):
    """The FIXED policy on an evaluation sheet: the same stopping times
    but where a payoff ties its continuation to rounding, so the price to
    rtol 1e-5; dividends and a curve ride the same loop."""
    k_eval = jax.random.key(SEED + 1)
    eval_draws = _replayed(k_eval)
    coefs = trained["policy"]
    grid = np.zeros(STEPS, np.float32)
    grid[5] = 3.0
    cum = np.linspace(0.002, 0.025, STEPS).astype(np.float32)
    off = np.linspace(0.0, 0.001, STEPS).astype(np.float32)
    for kw in ({}, {"div_grid": grid, "div_kind": "cash"},
               {"rate_offsets": off, "rate_cum": cum}):
        ref = ja.lsm_lower_bound(JSVJ(), S0, K, T, k_eval, coefs,
                                 num_paths=N, num_steps=STEPS, is_call=False,
                                 **{k: jnp.asarray(v) if isinstance(
                                     v, np.ndarray) else v
                                    for k, v in kw.items()})
        got = pa.lsm_lower_bound(SVJParams(), S0, K, T, None, _t(coefs),
                                 draws=eval_draws, is_call=False, **kw)
        _close(got["price"], ref["price"], rtol=1e-5)
        _close(got["std_error"], ref["std_error"], rtol=1e-4)


# ── Greeks ──────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("case", ["flat", "curve_and_dividends"])
def test_american_greeks_ad_matches_jax(trained, case):
    """(price, ∂spot, ∂v0, ∂T, ∂r) of one autograd pass, rtol 1e-4 (float32
    forward and backward on both sides), on the reference's policy."""
    k_eval = jax.random.key(SEED + 1)
    eval_draws = _replayed(k_eval)
    coefs = trained["policy"]
    kw = {}
    if case == "curve_and_dividends":
        grid = np.zeros(STEPS, np.float32)
        grid[5] = 2.0
        kw = {"div_grid": grid, "div_kind": "cash",
              "rate_offsets": np.linspace(0.0, 0.001, STEPS, dtype=np.float32),
              "rate_cum": np.linspace(0.002, 0.025, STEPS,
                                      dtype=np.float32)}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref_p, ref_g = ja.american_greeks_ad(JSVJ(), S0, K, T, k_eval, coefs,
                                         num_paths=N, num_steps=STEPS,
                                         is_call=False, **jkw)
    got_p, got_g = pa.american_greeks_ad(SVJParams(), S0, K, T, None,
                                         _t(coefs), draws=eval_draws,
                                         is_call=False, **kw)
    _close(got_p, ref_p, rtol=1e-5)
    assert len(got_g) == 4
    for g, r in zip(got_g, ref_g):
        _close(g, r, rtol=1e-4, atol=1e-6)
    ref = ja._american_delta_batch(JSVJ(), [101.0, 99.0], K, T, k_eval,
                                   coefs, num_paths=N, num_steps=STEPS,
                                   is_call=False, **jkw)
    got = pa._american_delta_batch(SVJParams(), [101.0, 99.0], K, T, None,
                                   _t(coefs), draws=eval_draws,
                                   is_call=False, **kw)
    assert got.shape == (2,)
    _close(got, ref, rtol=1e-4)


# ── the dual ────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("is_call,n_inner", [(False, 33), (True, 16)])
def test_dual_upper_bound_matches_jax(trained, is_call, n_inner):
    """An odd n_inner rounds down to even, as in the reference; the same
    outer and inner draws give the same bound (rtol 1e-5)."""
    key = jax.random.key(3)
    n_outer = 512
    coefs = (trained["value"] if not is_call else ja.lsm_train(
        JSVJ(), S0, K, T, jax.random.key(SEED), num_paths=N,
        num_steps=STEPS, is_call=True)["value"])
    ref = ja.dual_upper_bound(JSVJ(), S0, K, T, key, coefs, n_outer=n_outer,
                              n_inner=n_inner, num_steps=STEPS,
                              is_call=is_call)
    k_outer, k_inner = jax.random.split(key)
    half = (n_inner - n_inner % 2) // 2
    draws = (_replayed(k_outer, n_outer),
             _inner(k_inner, STEPS, half, n_outer))
    got = pa.dual_upper_bound(SVJParams(), S0, K, T, None, _t(coefs),
                              n_outer=n_outer, n_inner=n_inner,
                              num_steps=STEPS, is_call=is_call, draws=draws)
    for k in ref:
        _close(got[k], ref[k], rtol=1e-5)


# ── the engine ──────────────────────────────────────────────────────────────
def _engines(monkeypatch, keys, **kw):
    """The two engines; the port's `_draws(k, steps)` replays keys[k]."""
    jeng = ja.AmericanEngine(JSVJ(), num_paths=N, num_steps=32, seed=SEED,
                             **kw.get("jax", {}))
    peng = pa.AmericanEngine(SVJParams(), num_paths=N, num_steps=32,
                             seed=SEED, device="cpu", **kw.get("port", {}))
    monkeypatch.setattr(peng, "_draws",
                        lambda k, steps: _replayed(keys[k], N, steps))
    return jeng, peng


def test_engine_price_and_greeks_match_jax(monkeypatch):
    """`price` on key(seed), `greeks` on split(key(seed)): the same keys,
    the price within half a standard error, the Greeks within the flips'
    reach (their policy is refitted in each package)."""
    key = jax.random.key(SEED)
    jeng, peng = _engines(monkeypatch, {0: key})
    ref, got = jeng.price(S0, K, T, False), peng.price(S0, K, T, False)
    assert got.keys() == ref.keys()
    assert got["num_steps"] == ref["num_steps"] == STEPS
    assert abs(got["price"] - ref["price"]) < 0.5 * ref["std_error"]
    ref = jeng.price(S0, K, T, False, exercise_every=99)
    got = peng.price(S0, K, T, False, exercise_every=99)
    assert got["exercise_every"] == ref["exercise_every"] == STEPS
    _close(got["price"], ref["price"], rtol=1e-5)

    k_train, k_eval = jax.random.split(key)
    jeng, peng = _engines(monkeypatch, {0: k_train, 1: k_eval})
    ref, got = jeng.greeks(S0, K, T, False), peng.greeks(S0, K, T, False)
    assert got.keys() == ref.keys()
    se = ref["price"] / np.sqrt(N)
    assert abs(got["price"] - ref["price"]) < se
    assert got["delta"] == pytest.approx(ref["delta"], abs=0.02)
    assert got["gamma"] == pytest.approx(ref["gamma"], abs=0.01)
    assert got["vega_per_vol_point"] == pytest.approx(
        ref["vega_per_vol_point"], rel=0.05)
    assert got["theta_annual"] == pytest.approx(ref["theta_annual"], rel=0.1)
    assert got["rho"] == pytest.approx(ref["rho"], rel=0.1)


def test_engine_price_bounds_and_its_refusals(monkeypatch):
    """The bracket on split(key(seed), 3): the lower bound within half a
    standard error of the reference's, the dual (seed + 2's generator, not
    replayed) within 4 combined standard errors; dividends and curves
    refuse, as in the reference; mesh="auto" with no second CUDA device
    prices on one device."""
    k_train, k_eval, _ = jax.random.split(jax.random.key(SEED), 3)
    jeng, peng = _engines(monkeypatch, {0: k_train, 1: k_eval})
    ref = jeng.price_bounds(S0, K, T, False, n_outer=512, n_inner=33)
    got = peng.price_bounds(S0, K, T, False, n_outer=512, n_inner=33)
    assert got.keys() == ref.keys()
    assert (got["num_steps"], got["n_outer"], got["n_inner"]) == \
        (STEPS, 512, 33)
    assert abs(got["lower_bound"] - ref["lower_bound"]) \
        < 0.5 * ref["lower_se"]
    assert abs(got["upper_bound"] - ref["upper_bound"]) \
        < 4 * np.hypot(got["upper_se"], ref["upper_se"])
    assert got["lower_bound"] <= got["upper_bound"] + 3 * got["upper_se"]

    peng = pa.AmericanEngine(SVJParams(), num_paths=N, device="cpu",
                             dividends=DividendSchedule([0.2], [1.0]))
    with pytest.raises(ValueError, match="discrete dividends"):
        peng.price_bounds(S0, K, T)
    peng = pa.AmericanEngine(SVJParams(), num_paths=N, device="cpu",
                             rate_curve=RateCurve([1.0], [0.04]))
    with pytest.raises(ValueError, match="rate curves"):
        peng.price_bounds(S0, K, T)
    # mesh="auto", once refused, is slice N2's: without two CUDA devices
    # it resolves to no mesh, so the engine prices on its one device.
    kw = dict(num_paths=1000, num_steps=16, device="cpu")
    auto = pa.AmericanEngine(SVJParams(), mesh="auto", **kw)
    assert auto.price(S0, K, T, False) == pa.AmericanEngine(
        SVJParams(), **kw).price(S0, K, T, False)


def test_engine_with_dividends_and_curve_matches_jax(monkeypatch):
    """Cash and proportional dividends, and a rate curve, through the
    engine on the same key: within half a standard error."""
    key = jax.random.key(SEED)
    cases = [
        ({"dividends": JDivs([0.2], [3.0])},
         {"dividends": DividendSchedule([0.2], [3.0])}, True),
        ({"dividends": JDivs([0.2], [0.03], "proportional")},
         {"dividends": DividendSchedule([0.2], [0.03], "proportional")},
         False),
        ({"rate_curve": JCurve([0.25, 1.0], [0.02, 0.06])},
         {"rate_curve": RateCurve([0.25, 1.0], [0.02, 0.06])}, False),
    ]
    for jkw, pkw, is_call in cases:
        jeng, peng = _engines(monkeypatch, {0: key}, jax=jkw, port=pkw)
        ref = jeng.price(S0, K, T, is_call)
        got = peng.price(S0, K, T, is_call)
        assert abs(got["price"] - ref["price"]) < 0.5 * ref["std_error"]


# ── the host oracles ────────────────────────────────────────────────────────
@pytest.mark.parametrize("is_call,q", [(True, 0.0), (False, 0.02),
                                       (True, 0.08)])
def test_binomial_american_bs_equals_jax(is_call, q):
    args = (100.0, 95.0, 0.75, 0.05, q, 0.3)
    got = pa.binomial_american_bs(*args, steps=400, is_call=is_call)
    ref = ja.binomial_american_bs(*args, steps=400, is_call=is_call)
    assert got == pytest.approx(ref, rel=1e-12, abs=0)


def test_american_cos_oracle_matches_jax_and_the_tree():
    """Equal to the reference's COS oracle (host float64, 1e-12), and at
    xi = 0, theta = v0, lambda_j = 0 (Black-Scholes) within 2e-3
    relative of the CRR tree."""
    for fields in ({}, {"lambda_j": 3.0, "mu_j": -0.1}):
        got = pa.american_cos_oracle(SVJParams(**fields), 100.0, 105.0, 0.5,
                                     False)
        ref = ja.american_cos_oracle(JSVJ(**fields), 100.0, 105.0, 0.5,
                                     False)
        assert got.keys() == ref.keys()
        assert got["price"] == pytest.approx(ref["price"], rel=1e-12)
        _close(got["ladder_prices"], ref["ladder_prices"], rtol=1e-12)
    bs = SVJParams(xi=0.0, theta=0.09, v0=0.09, lambda_j=0.0, r=0.05, q=0.0)
    cos = pa.american_cos_oracle(bs, 100.0, 105.0, 0.5, False)["price"]
    tree = pa.binomial_american_bs(100.0, 105.0, 0.5, 0.05, 0.0, 0.3,
                                   steps=2000, is_call=False)
    assert cos == pytest.approx(tree, rel=2e-3)
