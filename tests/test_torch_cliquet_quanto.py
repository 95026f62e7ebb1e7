"""`mcos_tpu_torch/engine/cliquet.py` and `engine/quanto.py` against the
JAX package's on the JAX keys' own draws, replayed into the port
(`fold_in(key, step)` → `split` → `normal(3, n)`, `uniform(n)`).

Tolerances: float32 programs on both sides, rounded differently by the two
libraries' exp/log/sqrt and reductions: simulators rtol 1e-5 (atol 1e-6
for period log returns near 0), prices and standard errors rtol 1e-5; the
quanto's Black-Scholes adjustment, a difference of two float32 closed
forms, atol 2e-6 × the spot."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.cliquet as jcl
import mcos_tpu.engine.quanto as jq
import mcos_tpu_torch.engine.cliquet as pcl
import mcos_tpu_torch.engine.quanto as pq
from mcos_tpu.models.params import SVJParams as JSVJ
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models.params import SVJParams, gbm_params

torch.set_num_threads(1)

N, SEED = 2000, 42
FIELDS = dict(kappa=2.5, theta=0.05, xi=0.6, rho=-0.65, v0=0.045,
              lambda_j=2.0, mu_j=-0.06, sigma_j=0.12, r=0.05, q=0.01)


def _replayed(key, steps, n=N):
    """The JAX step loop's (z (steps, 3, n), u (steps, n)) for `key`."""
    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_norm, (3, n), jnp.float32),
                jax.random.uniform(k_unif, (n,), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _results_close(got: dict, ref: dict, rtol=1e-5, atol=None):
    """Every key at rtol; `atol` maps keys to an absolute tolerance."""
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k], rtol=rtol, atol=(atol or {}).get(k, 1e-9))


@pytest.mark.parametrize("n_periods,spp,companion", [(4, 4, True),
                                                     (3, 5, False)])
def test_period_log_returns_match_jax(n_periods, spp, companion):
    """Every period's log return of S and of the companion, on the JAX
    loop's draws (an odd step count in the second case)."""
    key = jax.random.key(3)
    steps = n_periods * spp
    ref = jcl.simulate_period_log_returns(
        JSVJ(**FIELDS), 0.7, key, num_paths=N, n_periods=n_periods,
        steps_per_period=spp, companion=companion)
    got = pcl.simulate_period_log_returns(
        SVJParams(**FIELDS), 0.7, None, num_paths=N, n_periods=n_periods,
        steps_per_period=spp, companion=companion,
        draws=_replayed(key, steps))
    assert got[0].shape == (n_periods, 2, N)
    _close(got[0], ref[0], atol=1e-6)
    if companion:
        _close(got[1], ref[1], atol=1e-6)
    else:
        assert got[1] is None and ref[1] is None


def test_period_log_returns_draw_one_step_at_a_time():
    """The generator path draws each step's normals, then its uniforms:
    the same returns as those draws materialized and replayed."""
    steps, n = 6, 512
    gen = seeded_generator(5, "cpu")
    z, u = zip(*[(torch.randn((3, n), generator=gen),
                  torch.rand((n,), generator=gen)) for _ in range(steps)])
    kw = dict(num_paths=n, n_periods=3, steps_per_period=2)
    a = pcl.simulate_period_log_returns(
        SVJParams(**FIELDS), 0.5, seeded_generator(5, "cpu"), device="cpu",
        **kw)
    b = pcl.simulate_period_log_returns(
        SVJParams(**FIELDS), 0.5, None, draws=(torch.stack(z),
                                              torch.stack(u)), **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _cliquet_engines(monkeypatch, cv=True, **kw):
    jeng = jcl.CliquetEngine(JSVJ(**FIELDS), num_paths=N, seed=SEED,
                             use_control_variate=cv, **kw)
    peng = pcl.CliquetEngine(SVJParams(**FIELDS), num_paths=N, seed=SEED,
                             use_control_variate=cv, device="cpu", **kw)
    monkeypatch.setattr(peng, "_draws", lambda steps: _replayed(
        jax.random.key(SEED), steps))
    return jeng, peng


@pytest.mark.parametrize("cv", [True, False])
@pytest.mark.parametrize("terms", [
    dict(n_periods=4), dict(n_periods=3, local_floor=-0.02, local_cap=0.05,
                            global_floor=0.01, global_cap=0.12,
                            notional=100.0)])
def test_cliquet_engine_matches_jax(monkeypatch, cv, terms):
    jeng, peng = _cliquet_engines(monkeypatch, cv, steps_per_period=4)
    _results_close(peng.price_cliquet(0.8, **terms),
                   jeng.price_cliquet(0.8, **terms))


@pytest.mark.parametrize("cv", [True, False])
@pytest.mark.parametrize("t1,k,is_call", [(0.3, 1.0, True),
                                          (0.55, 0.95, False)])
def test_forward_start_engine_matches_jax(monkeypatch, cv, t1, k, is_call):
    jeng, peng = _cliquet_engines(monkeypatch, cv, steps_per_period=5)
    _results_close(peng.price_forward_start(t1, 1.0, k=k, is_call=is_call),
                   jeng.price_forward_start(t1, 1.0, k=k, is_call=is_call))


def test_gbm_cliquet_and_forward_start_by_law():
    """The port's own generator: under GBM the companion is the priced
    path, so the CV prices equal the closed forms (an uncapped sum); with
    the CV off the raw estimates lie within 4 se of them."""
    gp = gbm_params(0.25, r=0.05, q=0.01)
    for cv in (True, False):
        eng = pcl.CliquetEngine(gp, num_paths=4000, steps_per_period=4,
                                seed=9, use_control_variate=cv,
                                device="cpu")
        res = eng.price_cliquet(1.0, n_periods=4, local_floor=-0.03,
                                local_cap=0.06, global_floor=-np.inf)
        exact = pcl.cliquet_bs(1.0, 4, 0.05, 0.01, 0.25, -0.03, 0.06)
        assert abs(res["price"] - exact) < 4 * res["std_error"] + 1e-6
        fs = eng.price_forward_start(0.25, 1.0)
        exact = pcl.forward_start_bs(fs["t1_effective"], 1.0, 1.0, 0.05,
                                     0.01, 0.25)
        assert abs(fs["price"] - exact) < 4 * fs["std_error"] + 1e-6


@pytest.mark.parametrize("rho_fx,sigma_fx", [(-0.3, 0.1), (0.6, 0.25)])
def test_quanto_terminal_matches_jax(rho_fx, sigma_fx):
    """S and the constant-vol companion: the tilt from the pre-step
    variance, subtracted after the core step."""
    key, steps = jax.random.key(8), 12
    ref = jq._quanto_terminal(JSVJ(**FIELDS), 100.0, 0.5, jnp.float32(0.03),
                              jnp.float32(sigma_fx), jnp.float32(rho_fx),
                              key, num_paths=N, num_steps=steps)
    got = pq._quanto_terminal(SVJParams(**FIELDS), 100.0, 0.5, 0.03,
                              sigma_fx, rho_fx, None, num_paths=N,
                              num_steps=steps, draws=_replayed(key, steps))
    for g, r in zip(got, ref):
        assert g.shape == (2, N)
        _close(g, r)


@pytest.mark.parametrize("cv", [True, False])
@pytest.mark.parametrize("is_call,fx_fixed", [(True, 1.0), (False, 0.85)])
def test_quanto_engine_matches_jax(monkeypatch, cv, is_call, fx_fixed):
    kw = dict(num_paths=N, num_steps=16, seed=SEED, use_control_variate=cv)
    jeng = jq.QuantoEngine(JSVJ(**FIELDS), 0.03, 0.12, -0.4, **kw)
    peng = pq.QuantoEngine(SVJParams(**FIELDS), 0.03, 0.12, -0.4,
                           device="cpu", **kw)
    monkeypatch.setattr(peng, "_draws", lambda steps: _replayed(
        jax.random.key(SEED), steps))
    # quanto_adjustment_bs is the difference of two float32 Black-Scholes
    # prices (each within rtol 1e-5 of the JAX package's,
    # tests/test_torch_params_bs.py): atol 2e-6 × the spot.
    _results_close(peng.price(100.0, 95.0, 0.5, is_call, fx_fixed),
                   jeng.price(100.0, 95.0, 0.5, is_call, fx_fixed),
                   atol={"quanto_adjustment_bs": 2e-6 * 100.0})


def test_gbm_quanto_by_law():
    """The port's generator under GBM: the CV price equals `quanto_bs`;
    σ_fx = 0 is plain Black-Scholes at the domestic discount."""
    gp = gbm_params(0.2, r=0.04, q=0.01)
    eng = pq.QuantoEngine(gp, 0.06, 0.15, -0.5, num_paths=4000,
                          num_steps=16, seed=3, use_control_variate=False,
                          device="cpu")
    res = eng.price(100.0, 100.0, 1.0)
    exact = pq.quanto_bs(100.0, 100.0, 1.0, 0.06, 0.04, 0.01, 0.2, 0.15,
                         -0.5)
    assert abs(res["price"] - exact) < 4 * res["std_error"]
    flat = pq.QuantoEngine(gp, 0.06, 0.0, -0.5, num_paths=4000, num_steps=16,
                           seed=3, device="cpu").price(100.0, 100.0, 1.0)
    plain = pq.quanto_bs(100.0, 100.0, 1.0, 0.06, 0.04, 0.01, 0.2, 0.0, 0.0)
    assert flat["price"] == pytest.approx(plain, abs=1e-4)


def test_mesh_not_ported():
    """The mesh, once refused, is slice N1's: on a one-shard mesh both
    engines price the unsharded path set."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    for build, run in (
            (lambda m: pcl.CliquetEngine(SVJParams(), num_paths=1000,
                                         steps_per_period=4, mesh=m,
                                         device="cpu"),
             lambda e: e.price_cliquet(1.0)),
            (lambda m: pq.QuantoEngine(SVJParams(), 0.05, 0.1, -0.3,
                                       num_paths=1000, num_steps=8, mesh=m,
                                       device="cpu"),
             lambda e: e.price(100.0, 100.0, 0.5))):
        ref, got = run(build(None)), run(build(make_mesh(["cpu"])))
        for k in ("price", "std_error", "cv_beta"):
            assert got[k] == pytest.approx(ref[k], rel=1e-6), k
