"""`mcos_tpu_torch/engine/basket.py` against `mcos_tpu/engine/basket.py` on
the JAX keys' own draws, replayed into the port (`fold_in(key, step)` →
`split` → `normal(3, A, n)`, `uniform(A, n)`), and the port's own
properties: the stacked parameters, the jittered Cholesky factor, common
random numbers across correlations and the implied-correlation round trip.

Tolerances: float32 programs on both sides, rounded differently by the two
libraries' exp/log/sqrt, matmuls and reductions: simulators and prices
rtol 1e-5; the stacked parameters and the Cholesky factor exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.basket as jb
import mcos_tpu_torch.engine.basket as pb
from mcos_tpu.models.params import SVJParams as JSVJ
from mcos_tpu.models.params import gbm_params as jgbm
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models.params import SVJParams, gbm_params, _stack_params

torch.set_num_threads(1)

N, SEED = 2000, 42
FIELDS = [dict(kappa=3.0, theta=0.04, xi=0.3, rho=-0.5, v0=0.04,
               lambda_j=0.5, mu_j=-0.03, sigma_j=0.05, r=0.05, q=0.01),
          dict(kappa=1.5, theta=0.09, xi=0.7, rho=-0.8, v0=0.06,
               lambda_j=2.0, mu_j=-0.08, sigma_j=0.15, r=0.05, q=0.03),
          dict(kappa=4.0, theta=0.03, xi=0.4, rho=0.2, v0=0.02,
               lambda_j=0.0, mu_j=0.0, sigma_j=0.1, r=0.03, q=0.0)]
CORR3 = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.35], [0.2, 0.35, 1.0]])
SPOTS3 = [100.0, 50.0, 200.0]


def _params(n):
    return ([JSVJ(**f) for f in FIELDS[:n]],
            [SVJParams(**f) for f in FIELDS[:n]])


def _replayed(key, steps, a, n=N):
    """The JAX basket loop's (z (steps, 3, A, n), u (steps, A, n))."""
    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (3, a, n), jnp.float32),
                jax.random.uniform(k_u, (a, n), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _jstack(params):
    return jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]),
        *params)


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def test_stacked_params_equal_the_jax_stack():
    jp, pp = _params(3)
    ref, got = _jstack(jp), _stack_params(pp)
    for name in ref.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)))
        assert getattr(got, name).dtype == np.float32


@pytest.mark.parametrize("corr", [CORR3, np.ones((3, 3)), np.eye(3)])
def test_jittered_cholesky_equals_jax(corr):
    """The same float64 factor (ρ = 1 needs the jitter) cast to float32."""
    jp, pp = _params(3)
    ref = jb.BasketEngine(jp, corr, num_paths=N)._chol
    got = pb.BasketEngine(pp, corr, num_paths=N, device="cpu")._chol
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="not PSD"):
        pb.BasketEngine(pp, -np.ones((3, 3)) + 2 * np.eye(3), device="cpu")
    with pytest.raises(ValueError, match="corr must be"):
        pb.BasketEngine(pp, np.eye(2), device="cpu")


@pytest.mark.parametrize("antithetic,companion", [(True, True),
                                                  (False, False)])
def test_terminal_matches_jax(antithetic, companion):
    jp, pp = _params(3)
    key, steps = jax.random.key(5), 9
    chol = np.linalg.cholesky(CORR3).astype(np.float32)
    ref = jb.simulate_basket_terminal(
        _jstack(jp), jnp.asarray(SPOTS3, jnp.float32), jnp.asarray(chol),
        0.6, key, num_paths=N, num_steps=steps, antithetic=antithetic,
        companion=companion)
    got = pb.simulate_basket_terminal(
        _stack_params(pp), SPOTS3, chol, 0.6, None, num_paths=N,
        num_steps=steps, antithetic=antithetic, companion=companion,
        draws=_replayed(key, steps, 3))
    assert got[0].shape == ((2 if antithetic else 1), 3, N)
    _close(got[0], ref[0])
    if companion:
        _close(got[1], ref[1])
    else:
        assert got[1] is None and ref[1] is None


@pytest.mark.parametrize("n_assets", [1, 3])
def test_states_match_jax(n_assets):
    """Levels and variance states at every observation date, 3 periods of
    3 steps (an odd step count); v beside atol 1e-6 (the variance step's
    cancellation, v + κ(θ − v)dt + ξ√v dW₂, near small v)."""
    jp, pp = _params(n_assets)
    key = jax.random.key(6)
    corr = CORR3[:n_assets, :n_assets]
    chol = np.linalg.cholesky(corr).astype(np.float32)
    spots = SPOTS3[:n_assets]
    ref = jb.simulate_basket_states(
        _jstack(jp), jnp.asarray(spots, jnp.float32), jnp.asarray(chol),
        0.9, key, num_paths=N, n_obs=3, steps_per_period=3)
    draws = _replayed(key, 9, n_assets)
    got = pb.simulate_basket_states(
        _stack_params(pp), spots, chol, 0.9, None, num_paths=N, n_obs=3,
        steps_per_period=3, draws=draws)
    for g, r, atol in zip(got, ref, (0.0, 1e-6)):
        assert g.shape == (3, 2, n_assets, N)
        _close(g, r, atol=atol)
    levels = pb.simulate_basket_observations(
        _stack_params(pp), spots, chol, 0.9, None, num_paths=N, n_obs=3,
        steps_per_period=3, draws=draws)
    torch.testing.assert_close(levels, got[0], rtol=0, atol=0)


def _engines(monkeypatch, n, corr, cv=True, **kw):
    jp, pp = _params(n)
    jeng = jb.BasketEngine(jp, corr, num_paths=N, num_steps=32, seed=SEED,
                           use_control_variate=cv, **kw)
    peng = pb.BasketEngine(pp, corr, num_paths=N, num_steps=32, seed=SEED,
                           use_control_variate=cv, device="cpu", **kw)
    monkeypatch.setattr(peng, "_draws", lambda k, steps: _replayed(
        jax.random.key(SEED), steps, n))
    return jeng, peng


def _results_close(got, ref, rtol=1e-5):
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], str):
            assert got[k] == ref[k]
        else:
            _close(got[k], ref[k], rtol=rtol, atol=1e-9)


@pytest.mark.parametrize("cv", [True, False])
@pytest.mark.parametrize("is_call,strike", [(True, 110.0), (False, 95.0)])
def test_basket_price_matches_jax(monkeypatch, cv, is_call, strike):
    """The arithmetic basket and its geometric-companion control."""
    jeng, peng = _engines(monkeypatch, 3, CORR3, cv)
    w = [0.5, 0.3, 0.2]
    _results_close(peng.price(SPOTS3, w, strike, 0.5, is_call),
                   jeng.price(SPOTS3, w, strike, 0.5, is_call))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["worst_of", "best_of"])
@pytest.mark.parametrize("is_call", [True, False])
def test_rainbow_matches_jax(monkeypatch, n, kind, is_call):
    """Two assets with the Stulz control (the user's corr[0, 1]), three
    plain."""
    jeng, peng = _engines(monkeypatch, n, CORR3[:n, :n])
    spots = [100.0, 95.0, 105.0][:n]
    _results_close(peng.price_rainbow(spots, 100.0, 0.75, kind, is_call),
                   jeng.price_rainbow(spots, 100.0, 0.75, kind, is_call))


@pytest.mark.parametrize("cv", [True, False])
@pytest.mark.parametrize("strike,is_call", [(0.0, True), (5.0, False)])
def test_spread_matches_jax(monkeypatch, cv, strike, is_call):
    """The Margrabe control on companion carries folded into q′."""
    jeng, peng = _engines(monkeypatch, 2, CORR3[:2, :2], cv)
    _results_close(peng.price_spread([100.0, 95.0], strike, 0.75, is_call),
                   jeng.price_spread([100.0, 95.0], strike, 0.75, is_call))


def test_payoff_errors_match_jax():
    jp, pp = _params(3)
    jeng = jb.BasketEngine(jp, CORR3, num_paths=N)
    peng = pb.BasketEngine(pp, CORR3, num_paths=N, device="cpu")
    for call in (lambda e: e.price_rainbow(SPOTS3, 1.0, 0.5, kind="mid"),
                 lambda e: e.price_spread(SPOTS3, 1.0, 0.5)):
        with pytest.raises(ValueError) as a:
            call(jeng)
        with pytest.raises(ValueError) as b:
            call(peng)
        assert str(a.value) == str(b.value)


def test_geometric_control_exact_equals_jax():
    jp, pp = _params(3)
    for is_call in (True, False):
        ref = jb.BasketEngine(jp, CORR3)._geo_ctrl_exact(
            SPOTS3, [0.5, 0.3, 0.2], 110.0, 0.5, is_call)
        got = pb.BasketEngine(pp, CORR3, device="cpu")._geo_ctrl_exact(
            SPOTS3, [0.5, 0.3, 0.2], 110.0, 0.5, is_call)
        assert got == pytest.approx(ref, rel=1e-12)


def _generator_draws(seed, steps, a, n):
    """The engine generator's stream as the simulator draws it."""
    gen = seeded_generator(seed, "cpu")
    z, u = zip(*[(torch.randn((3, a, n), generator=gen),
                  torch.rand((a, n), generator=gen)) for _ in range(steps)])
    return torch.stack(z), torch.stack(u)


@pytest.mark.parametrize("rho", [0.1, 0.7])
def test_common_random_numbers_across_correlations(monkeypatch, rho):
    """Engines at different ρ on one seed consume the same normals: each
    price equals the price on the generator's stream materialized once,
    and that stream does not depend on ρ."""
    _, pp = _params(3)
    corr = np.full((3, 3), rho)
    np.fill_diagonal(corr, 1.0)
    n, steps = 512, 16
    eng = pb.BasketEngine(pp, corr, num_paths=n, num_steps=32, seed=11,
                          device="cpu")
    own = eng.price(SPOTS3, [1 / 3] * 3, 115.0, 0.5)
    stream = _generator_draws(11, steps, 3, n)
    monkeypatch.setattr(eng, "_draws", lambda k, s: stream)
    assert eng.price(SPOTS3, [1 / 3] * 3, 115.0, 0.5) == own


def test_implied_correlation_round_trip():
    """A quote priced at a flat ρ = 0.45 on the port's generator inverts
    to 0.45 (common random numbers keep the price monotone in ρ); a quote
    outside the attainable range raises ValueError, as in the JAX
    package."""
    gp = [gbm_params(s, r=0.05, q=0.01) for s in (0.2, 0.25, 0.3)]
    spots, w = [100.0, 50.0, 200.0], [1 / 3] * 3
    corr = np.full((3, 3), 0.45)
    np.fill_diagonal(corr, 1.0)
    quote = pb.BasketEngine(gp, corr, num_paths=1000, seed=42,
                            device="cpu").price(spots, w, 115.0,
                                                0.5)["price"]
    out = pb.implied_correlation(gp, spots, w, 115.0, 0.5, quote,
                                 num_paths=1000, seed=42, device="cpu")
    assert out["implied_correlation"] == pytest.approx(0.45, abs=5e-3)
    assert abs(out["model_price"] - quote) < 1e-3
    assert out.keys() == {"implied_correlation", "model_price",
                          "market_price", "iterations"}
    with pytest.raises(ValueError, match="attainable"):
        pb.implied_correlation(gp, spots, w, 115.0, 0.5, quote * 3.0,
                               num_paths=1000, seed=42, device="cpu")
    jgp = [jgbm(s, r=0.05, q=0.01) for s in (0.2, 0.25, 0.3)]
    with pytest.raises(ValueError, match="attainable"):
        jb.implied_correlation(jgp, spots, w, 115.0, 0.5, quote * 3.0,
                               num_paths=1000, seed=42)


def test_mesh_not_ported():
    """The mesh, once refused, is slice N1's: a one-shard mesh prices the
    unsharded engine's path set (its own tests: test_torch_families_mesh)."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    _, pp = _params(2)
    kw = dict(num_paths=1000, num_steps=8, device="cpu")
    args = ([100.0, 95.0], [0.5, 0.5], 100.0, 0.5)
    ref = pb.BasketEngine(pp, np.eye(2), **kw).price(*args)
    got = pb.BasketEngine(pp, np.eye(2), mesh=make_mesh(["cpu"]),
                          **kw).price(*args)
    assert got["num_devices"] == 1
    for k in ("price", "std_error", "cv_beta"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
