"""The port's risk engine (`mcos_tpu_torch/engine/risk.py`) against the JAX
package's on CPU, on the same numpy-seeded inputs and on draws replayed
from the JAX keys: tail metrics, the stress programs and engine (torch
backend), the hedge day loops, the correlated-GBM terminals, Euler
contributions and the Student-t copula; the cuda backend (K3's plain
version on the CPU) by law against COS; the float64 `betainc` against
scipy.

Tolerances: tail metrics and portfolio programs rtol 1e-5; the stress and
hedge programs rtol 1e-4 beside an atol of 1e-5 × spot (float32 sums of
payoffs of order the spot); the t-copula rtol 1e-4 where u lies in
[1e-6, 1 − 1e-6]; betainc abs 1e-9; the law within 4 se + 1 %."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from mcos_tpu.engine import risk as jrisk
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu_torch.engine import risk as prisk
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.cos_pricer import cos_price

torch.set_num_threads(1)

FIELDS = dict(kappa=2.0, theta=0.05, xi=0.5, rho=-0.6, v0=0.04, lambda_j=1.5,
              mu_j=-0.08, sigma_j=0.15, r=0.05, q=0.01)
SPOT, STRIKE, T = 100.0, 102.0, 0.05          # 12 steps at 252 a year
N, STEPS, SEED = 4096, 12, 5
TOL = dict(rtol=1e-4, atol=1e-5 * SPOT)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _replayed(seed=SEED, n=N, steps=STEPS):
    """The JAX twins' per-step draws for `jax.random.key(seed)`:
    fold_in(key, t) → split → normal (3, n), uniform (n,)."""
    key = jax.random.key(seed)

    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_norm, (3, n), jnp.float32),
                jax.random.uniform(k_unif, (n,), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return key, (_t(z), _t(u))


@pytest.fixture(scope="module")
def replayed():
    return _replayed()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, row in enumerate(v):
                if isinstance(row, (dict, list)):
                    out.update(_flat(row if isinstance(row, dict)
                                     else dict(enumerate(row)),
                                     f"{prefix}{k}[{i}]."))
                else:
                    out[f"{prefix}{k}[{i}]"] = row
        else:
            out[prefix + str(k)] = v
    return out


# ── tail metrics ─────────────────────────────────────────────────────────────
@pytest.mark.parametrize("n,confidence", [(5000, 0.99), (777, 0.95),
                                          (30, 0.99)])
def test_compute_risk_metrics_matches_jax(n, confidence):
    rng = np.random.default_rng(n)
    returns = (0.02 * rng.standard_t(4, n) - 0.001).astype(np.float32)
    ref = jrisk.compute_risk_metrics(returns, confidence=confidence)
    got = prisk.compute_risk_metrics(returns, confidence=confidence,
                                     device="cpu")
    assert got.keys() == ref.keys()
    for k in ref:
        if np.isnan(ref[k]):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    t = prisk.compute_risk_metrics(torch.from_numpy(returns),
                                   confidence=confidence)
    np.testing.assert_equal(t, got)


def test_hill_estimator_equal():
    rng = np.random.default_rng(2)
    losses = np.abs(rng.standard_t(3, 2000))
    for k in (None, 5, 50, 5000):
        a = prisk._hill_estimator(losses, k)
        b = jrisk._hill_estimator(losses, k)
        assert a == b
    assert np.isnan(prisk._hill_estimator(np.array([1.0])))
    assert np.isnan(prisk._hill_estimator(np.zeros(50)))


# ── stress ───────────────────────────────────────────────────────────────────
def _members():
    eng = jrisk.StressTestEngine(JSVJParams(**FIELDS), num_paths=N, seed=SEED)
    members, v0s = eng._vol_members()
    batch = jax.tree.map(lambda *xs: jnp.stack(
        [jnp.asarray(x, jnp.float32) for x in xs]), *members)
    port = prisk._stack_members(
        [SVJParams(**{f: float(getattr(m, f)) for f in FIELDS})
         for m in members], "cpu")
    return batch, port


def test_params_batch_programs_match_jax(replayed):
    key, draws = replayed
    batch, port = _members()
    kw = dict(num_paths=N, num_steps=STEPS, is_call=True)
    ref = jrisk._params_batch_prices(batch, SPOT, STRIKE, T, key, **kw)
    got = prisk._params_batch_prices(port, SPOT, STRIKE, T, draws, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    strikes = np.array([90.0, 100.0, 102.0, 115.0], np.float32)
    for is_call in (True, False):
        kw["is_call"] = is_call
        ref = jrisk._params_batch_price_grid(batch, SPOT, strikes, T, key,
                                             **kw)
        got = prisk._params_batch_price_grid(port, SPOT, strikes, T, draws,
                                             **kw)
        assert got.shape == (3, 4)
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def _stress_pair(replayed, **fields):
    _, draws = replayed
    params = dict(FIELDS, **fields)
    ref = jrisk.StressTestEngine(JSVJParams(**params), num_paths=N,
                                 seed=SEED)
    got = prisk.StressTestEngine(SVJParams(**params), num_paths=N, seed=SEED,
                                 backend="torch", device="cpu")
    got._draws = lambda steps: draws
    return ref, got


def _assert_close_flat(got, ref, tol=TOL):
    a, b = _flat(got), _flat(ref)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


@pytest.mark.parametrize("is_call", [True, False])
def test_full_stress_report_matches_jax(replayed, is_call):
    ref, got = _stress_pair(replayed)
    _assert_close_flat(got.full_stress_report(SPOT, STRIKE, T, is_call),
                       ref.full_stress_report(SPOT, STRIKE, T, is_call))


def test_standalone_ladders_match_jax(replayed):
    ref, got = _stress_pair(replayed)
    for name in ("spot_shock_ladder", "vol_shock_ladder", "jump_scenario"):
        _assert_close_flat({"x": getattr(got, name)(SPOT, STRIKE, T)},
                           {"x": getattr(ref, name)(SPOT, STRIKE, T)})


@pytest.mark.parametrize("axes", [
    {},
    {"spot_shocks": [-0.3, 0.1, 0.6], "vol_shocks": [-0.1, 0.02, 0.25]},
    {"spot_shocks": [0.0], "vol_shocks": [0.0]},
])
def test_scenario_matrix_matches_jax(replayed, axes):
    ref, got = _stress_pair(replayed, v0=0.09)
    a = got.scenario_matrix(SPOT, STRIKE, T, **axes)
    b = ref.scenario_matrix(SPOT, STRIKE, T, **axes)
    for k in ("spot_shocks_pct", "vol_shocks_pts", "spots", "v0s"):
        assert a[k] == b[k], k
    _assert_close_flat(a, b)


def test_liquidity_stress_equal():
    p, jp = SVJParams(**FIELDS), JSVJParams(**FIELDS)
    for args in ((0.5,), (0.5, 5.0)):
        assert (prisk.LiquidityStress.bid_ask_widening(*args)
                == jrisk.LiquidityStress.bid_ask_widening(*args))
    for name, kw in (("vol_gap_no_spot_move", {}),
                     ("vol_gap_no_spot_move", {"vol_jump": 0.2}),
                     ("expiry_vol_crush", {}),
                     ("expiry_vol_crush", {"crush_pct": 0.99})):
        a = getattr(prisk.LiquidityStress, name)(p, **kw).as_dict()
        b = getattr(jrisk.LiquidityStress, name)(jp, **kw).as_dict()
        assert a == {k: float(v) for k, v in b.items()}, name


def test_stress_cuda_backend_by_law():
    """The default backend, on the CPU K3's plain version, against COS:
    every spot row, both gap rows and every vol member within 4 se + 1 %,
    the se from the same device results."""
    p = SVJParams(**FIELDS)
    eng = prisk.StressTestEngine(p, num_paths=16_384, seed=11, device="cpu")
    rep = eng.full_stress_report(SPOT, STRIKE, T)
    shocks = np.concatenate([[0.0], prisk.SPOT_SHOCKS,
                             [-prisk.JUMP_SCENARIO_SIZE,
                              prisk.JUMP_SCENARIO_SIZE]])
    rel, res = eng._shock_prices_device(SPOT, STRIKE, T, True, shocks)
    se = _np(res["std_error"]) * rel
    price = _np(res["price"]) * rel
    exact = np.array([cos_price(p, SPOT * r, [STRIKE], T, True)[0]
                      for r in rel])
    got = ([rep["jump_scenario"]["base_price"]]
           + [row["price"] for row in rep["spot_shocks"]]
           + [rep["jump_scenario"]["gap_down_price"],
              rep["jump_scenario"]["gap_up_price"]])
    np.testing.assert_allclose(got, price, rtol=1e-6)
    assert (np.abs(price - exact) < 4 * se + 0.01 * exact).all()
    members, _ = eng._vol_members()
    for m, row in zip(members[1:], rep["vol_shocks"]):
        r = eng._engine(m)._price_result(SPOT, [STRIKE], T, True)
        c = cos_price(m, SPOT, [STRIKE], T, True)[0]
        assert row["price"] == pytest.approx(float(r["price"][0]), rel=1e-6)
        assert abs(row["price"] - c) < 4 * float(r["std_error"][0]) + 0.01 * c


def test_stress_cuda_backend_matrix_shares_the_report_paths():
    """On the cuda backend every member and row is on the engine's seed:
    the matrix's base cell is the report's base, its zero-vol row the
    report's spot rows."""
    eng = prisk.StressTestEngine(SVJParams(**FIELDS), num_paths=4096,
                                 device="cpu")
    rep = eng.full_stress_report(SPOT, STRIKE, T)
    mat = eng.scenario_matrix(SPOT, STRIKE, T)
    assert mat["base_price"] == pytest.approx(
        rep["jump_scenario"]["base_price"], rel=1e-6)
    i0 = mat["vol_shocks_pts"].index(0.0)
    row = dict(zip(mat["spot_shocks_pct"], mat["prices"][i0]))
    for r in rep["spot_shocks"]:
        assert row[r["shock_pct"]] == pytest.approx(r["price"], rel=1e-6)
    with pytest.raises(ValueError):
        prisk.StressTestEngine(SVJParams(), backend="pallas")


# ── hedging ──────────────────────────────────────────────────────────────────
HEDGE_N, DAYS, HSEED = 1024, 16, 7
HEDGE_P = dict(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04,
               lambda_j=2.0, mu_j=-0.05, sigma_j=0.1, r=0.05, q=0.01)


def _hedge_draws(dynamics):
    key = jax.random.key(HSEED)
    if dynamics == "svj":
        return key, _replayed(HSEED, HEDGE_N, DAYS)[1]
    z = jax.vmap(lambda d: jax.random.normal(jax.random.fold_in(key, d),
                                             (HEDGE_N,), jnp.float32))(
        jnp.arange(DAYS))
    return key, (_t(z), None)


@pytest.mark.parametrize("dynamics", ["gbm", "svj"])
@pytest.mark.parametrize("hedge", ["bs_delta", "mv_delta", "ww_band"])
def test_hedge_paths_match_jax(dynamics, hedge):
    key, draws = _hedge_draws(dynamics)
    T_h = DAYS / 252
    kw = dict(num_days=DAYS, num_scenarios=HEDGE_N, is_call=True,
              txn_cost_bps=5.0, slippage_bps=2.0, dynamics=dynamics,
              hedge=hedge, risk_aversion=1e-2)
    ref_pnl, ref_cost = jrisk._hedge_paths(
        JSVJParams(**HEDGE_P), SPOT, STRIKE, T_h, 3.1, key, **kw)
    pnl, cost = prisk._hedge_paths(SVJParams(**HEDGE_P), SPOT, STRIKE, T_h,
                                   3.1, draws=draws, **kw)
    np.testing.assert_allclose(_np(pnl), np.asarray(ref_pnl), **TOL)
    np.testing.assert_allclose(_np(cost), np.asarray(ref_cost), rtol=1e-4,
                               atol=1e-7 * SPOT)
    assert float(cost.mean()) > 0


def test_hedge_paths_generator_draws_as_replayed():
    """Without draws, each day's randoms come from the generator in the
    documented order."""
    p = SVJParams(**HEDGE_P)
    kw = dict(num_days=4, num_scenarios=64, is_call=False, txn_cost_bps=1.0,
              slippage_bps=1.0, dynamics="svj", device="cpu")
    gen = torch.Generator().manual_seed(3)
    z, u = [], []
    for _ in range(4):
        z.append(torch.randn((3, 64), generator=gen))
        u.append(torch.rand((64,), generator=gen))
    a = prisk._hedge_paths(p, SPOT, STRIKE, 0.1, 2.0,
                           torch.Generator().manual_seed(3), **kw)
    b = prisk._hedge_paths(p, SPOT, STRIKE, 0.1, 2.0,
                           draws=(torch.stack(z), torch.stack(u)), **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("is_call", [True, False])
def test_hedge_paths_from_sheet_match_jax(is_call):
    rng = np.random.default_rng(4)
    sheet = np.cumsum(rng.normal(0.0, 0.012, (512, DAYS)), axis=1).astype(
        np.float32)
    args = (SPOT, STRIKE, DAYS / 252, 2.5, 0.2, 0.05, 0.01)
    kw = dict(num_days=DAYS, is_call=is_call, txn_cost_bps=5.0,
              slippage_bps=2.0)
    ref = jrisk._hedge_paths_from_sheet(jnp.asarray(sheet), *args, **kw)
    got = prisk._hedge_paths_from_sheet(torch.from_numpy(sheet), *args, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * SPOT)


def test_run_backtest_errors_as_jax():
    port = prisk.HedgingBacktest(SVJParams(), device="cpu")
    ref = jrisk.HedgingBacktest(JSVJParams())
    for kw in ({"hedge": "gamma_neutral"},
               {"hedge": "mv_delta", "dynamics": "rough"},
               {"hedge": "ww_band", "dynamics": "rough"},
               {"risk_aversion": 0.0}, {"risk_aversion": -1.0}):
        with pytest.raises(ValueError) as a:
            port.run_backtest(SPOT, SPOT, 0.1, num_scenarios=10, **kw)
        with pytest.raises(ValueError) as b:
            ref.run_backtest(SPOT, SPOT, 0.1, num_scenarios=10, **kw)
        assert str(a.value) == str(b.value)


def test_run_backtest_zero_cost_band_is_daily_delta():
    """The reference's own pin (tests/test_ww_band.py): at zero cost the
    band collapses to the daily-delta strategy, bit for bit here."""
    bt = prisk.HedgingBacktest(SVJParams(**HEDGE_P), device="cpu")
    kw = dict(num_scenarios=256, num_mc_paths=4096, txn_cost_bps=0.0,
              slippage_bps=0.0)
    for dyn in ("gbm", "svj"):
        a = bt.run_backtest(SPOT, SPOT, 0.05, dynamics=dyn, **kw)
        b = bt.run_backtest(SPOT, SPOT, 0.05, dynamics=dyn, hedge="ww_band",
                            **kw)
        assert a["mean_pnl"] == b["mean_pnl"] and a["std_pnl"] == b["std_pnl"]


# ── portfolio ────────────────────────────────────────────────────────────────
SPOTS = np.array([100.0, 80.0, 120.0], np.float32)
SIGMAS = np.array([0.2, 0.3, 0.25], np.float32)
CORR = np.array([[1.0, 0.5, 0.1], [0.5, 1.0, 0.3], [0.1, 0.3, 1.0]])
WEIGHTS = np.array([0.5, 0.3, 0.2], np.float32)
PN, PSTEPS = 4096, 8


def _gbm_normals(key, n=PN, steps=PSTEPS, assets=3):
    return _t(jax.vmap(lambda t: jax.random.normal(
        jax.random.fold_in(key, t), (n, assets), jnp.float32))(
        jnp.arange(steps)))


def test_multi_asset_gbm_terminal_matches_jax():
    key = jax.random.key(3)
    ref = jrisk.multi_asset_gbm_terminal(SPOTS, SIGMAS, CORR, 0.05, 0.01,
                                         0.25, key, num_paths=PN,
                                         num_steps=PSTEPS)
    got = prisk.multi_asset_gbm_terminal(SPOTS, SIGMAS, CORR, 0.05, 0.01,
                                         0.25, num_paths=PN,
                                         num_steps=PSTEPS,
                                         draws=_gbm_normals(key))
    assert got.shape == (PN, 3)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5)


def test_risk_contrib_device_matches_jax():
    rng = np.random.default_rng(6)
    rel = (rng.standard_normal((PN, 3)) @ np.linalg.cholesky(CORR).T
           * 0.05).astype(np.float32)
    kw = dict(k_tail=40, k_band=200)
    ref = jrisk._risk_contrib_device(jnp.asarray(rel), jnp.asarray(WEIGHTS),
                                     **kw)
    got = prisk._risk_contrib_device(torch.from_numpy(rel), WEIGHTS, **kw)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


def test_portfolio_programs_match_jax():
    """`portfolio_risk_contributions` and the Gaussian `portfolio_var` on
    the JAX key's replayed normals (the JAX side on a one-device mesh;
    tests/test_torch_mesh_n2_desk.py holds the sharded path)."""
    from mcos_tpu.parallel.mesh import make_mesh

    key = jax.random.key(9)
    kw = dict(r=0.05, q=0.01, num_paths=PN, num_steps=PSTEPS,
              confidence=0.98)
    draws = _gbm_normals(key)
    ref = jrisk.portfolio_risk_contributions(SPOTS, SIGMAS, CORR, WEIGHTS,
                                             0.1, key, **kw)
    got = prisk.portfolio_risk_contributions(SPOTS, SIGMAS, CORR, WEIGHTS,
                                             0.1, draws=draws, **kw)
    _assert_close_flat(got, ref, dict(rtol=1e-5, atol=1e-8))
    assert sum(got["component_cvar"]) == pytest.approx(got["cvar"], rel=1e-5)
    ref = jrisk.portfolio_var(SPOTS, SIGMAS, CORR, WEIGHTS, 0.1, key,
                              mesh=make_mesh(jax.devices()[:1]), **kw)
    got = prisk.portfolio_var(SPOTS, SIGMAS, CORR, WEIGHTS, 0.1, draws=draws,
                              **kw)
    _assert_close_flat(got, ref, dict(rtol=1e-5, atol=1e-8))
    # mesh="auto", once refused, is slice N2's: without two CUDA devices
    # it resolves to no mesh (tests/test_torch_mesh_n2_desk.py shards it).
    kw.pop("num_paths")
    auto = prisk.portfolio_var(SPOTS, SIGMAS, CORR, WEIGHTS, 0.1,
                               mesh="auto", num_paths=PN, device="cpu", **kw)
    assert auto == prisk.portfolio_var(SPOTS, SIGMAS, CORR, WEIGHTS, 0.1,
                                       num_paths=PN, device="cpu", **kw)


@pytest.mark.parametrize("nu", [1.0, 3.0, 30.0, 300.0])
def test_t_copula_terminal_matches_jax(nu):
    key = jax.random.key(int(nu))
    k_z, k_g = jax.random.split(key)
    z = jax.random.normal(k_z, (PN, 3), jnp.float32)
    g = 2.0 * jax.random.gamma(k_g, 0.5 * nu, (PN, 1), jnp.float32)
    ref = np.asarray(jrisk.multi_asset_t_copula_terminal(
        SPOTS, SIGMAS, CORR, 0.05, 0.01, 0.25, key, num_paths=PN, nu=nu))
    got = prisk.multi_asset_t_copula_terminal(
        SPOTS, SIGMAS, CORR, 0.05, 0.01, 0.25, num_paths=PN, nu=nu,
        draws=(_t(z), _t(g)))
    chol = torch.linalg.cholesky(torch.tensor(CORR, dtype=torch.float32))
    x = (_t(z) @ chol.T) * torch.sqrt(nu / torch.clamp(_t(g), min=1e-10))
    u = _np(prisk.student_t_cdf(x, nu))
    # The port's t CDF is scipy's in float64 on the same x, everywhere.
    u_exact = scipy.special.stdtr(nu, x.double().numpy())
    np.testing.assert_allclose(u, u_exact, rtol=0, atol=1e-12)
    # The reference's own u (risk.py:731-733) is float32: near x = 0 its
    # argument nu/(nu + x^2) rounds to float32's grid below 1, and u
    # collapses towards 0.5 (1.5e-3 off the exact CDF at nu = 300). Where
    # that error alone moves the reference's S by more than half the
    # tolerance, the point is the reference's error: counted here, and held
    # above against the exact CDF instead.
    xj = jnp.asarray(x.numpy())
    ib = jax.scipy.special.betainc(0.5 * nu, 0.5, nu / (nu + xj * xj))
    u_jax = np.asarray(jnp.where(xj >= 0, 1.0 - 0.5 * ib, 0.5 * ib),
                       np.float64)
    clip = (1e-7, 1 - 1e-7)
    dz = np.abs(scipy.special.ndtri(np.clip(u_jax, *clip))
                - scipy.special.ndtri(np.clip(u_exact, *clip)))
    ref_ok = dz * SIGMAS * np.sqrt(0.25) <= 5e-5
    inner = (u >= 1e-6) & (u <= 1 - 1e-6) & ref_ok
    assert (~ref_ok).mean() < 0.05 and inner.mean() > 0.9
    np.testing.assert_allclose(_np(got)[inner], ref[inner], rtol=1e-4)


@pytest.mark.parametrize("nu", [1, 2, 3, 5, 10, 30, 100, 300])
def test_betainc_matches_scipy(nu):
    x = np.concatenate([np.geomspace(1e-6, 0.5, 300),
                        1.0 - np.geomspace(1e-6, 0.5, 300)])
    got = prisk.betainc(nu / 2, 0.5, torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               scipy.special.betainc(nu / 2, 0.5, x),
                               rtol=0, atol=1e-9)
    edge = prisk.betainc(nu / 2, 0.5, torch.tensor([0.0, 1.0],
                                                   dtype=torch.float64))
    assert edge.tolist() == [0.0, 1.0]


def test_t_copula_generator_law():
    """Drawn from a generator (z, then the χ² by `torch._standard_gamma`):
    each marginal's log-return mean and std within 4 se of GBM's."""
    n = 60_000
    s = prisk.multi_asset_t_copula_terminal(
        SPOTS[:2], SIGMAS[:2], CORR[:2, :2], 0.05, 0.0, 0.25,
        torch.Generator().manual_seed(1), num_paths=n, nu=4.0, device="cpu")
    lr = np.log(_np(s) / SPOTS[:2])
    for i in range(2):
        mu = (0.05 - 0.5 * SIGMAS[i] ** 2) * 0.25
        sd = SIGMAS[i] * np.sqrt(0.25)
        assert abs(lr[:, i].mean() - mu) < 4 * sd / np.sqrt(n)
        assert abs(lr[:, i].std() - sd) < 4 * sd / np.sqrt(2 * n)


@pytest.mark.parametrize("corr", [
    [[1.0, 1.5], [1.5, 1.0]],
    [[1.0, 0.2], [0.3, 1.0]],
    [[1.0, 0.2, 0.0], [0.2, 1.0, 0.0]],
    [[1.0, 0.2], [0.2]],
    [[1.0, float("nan")], [float("nan"), 1.0]],
])
def test_corr_cholesky_refuses(corr):
    """Any `corr` that is not a finite, square, symmetric, positive definite
    matrix raises ValueError before a path is drawn (the JAX package prices
    such a matrix to NaN)."""
    with pytest.raises(ValueError):
        prisk._corr_cholesky(corr, "cpu")
    for fn, kw in ((prisk.multi_asset_gbm_terminal, {"num_steps": 1}),
                   (prisk.multi_asset_t_copula_terminal, {})):
        with pytest.raises(ValueError):
            fn([1.0, 1.0], [0.2, 0.2], corr, 0.0, 0.0, 1.0, num_paths=8,
               device="cpu", **kw)
    good = prisk._corr_cholesky([[1.0, 0.3], [0.3, 1.0]], "cpu")
    torch.testing.assert_close(good @ good.T, torch.tensor(
        [[1.0, 0.3], [0.3, 1.0]]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("corr", [
    [[1.0, 0.3], [0.30000001, 1.0]],
    [[1.0, 0.5, 0.1], [0.5 + 1e-9, 1.0, 0.3], [0.1, 0.3 - 1e-9, 1.0]],
    [[1.0, float(np.float32(0.7))], [0.7, 1.0]],
])
def test_corr_cholesky_symmetrizes_rounding_as_jax(corr):
    """A `corr` symmetric only to decimal or float32 rounding is accepted
    and factored as the JAX package factors it: the float32 matrix
    symmetrized, (c + cᵀ)/2, then Cholesky."""
    got = prisk._corr_cholesky(corr, "cpu")
    ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(corr, jnp.float32)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)
