"""The port's SSVI surface (`mcos_tpu_torch/engine/ssvi.py`) against the
JAX package's on CPU.

Tolerances:
- `ssvi_total_variance`, the objective and `SSVISurface`'s float32
  evaluations: rtol 1e-6 (float32 torch against float32 XLA);
- `butterfly_g` (w′ and w″ by autograd in both packages): rtol 1e-5 beside
  atol 1e-6 (g is a difference of O(1) terms);
- `theta_at`, `atm_skew`, the Thm 4.2 conditions: host float64, rtol 1e-12;
- the fit, whose streams differ (threefry against a torch generator), by
  outcome: the objective within 2× the JAX package's + 1e-10, and a
  synthetic surface's (ρ, η, γ) recovered to 0.02 / 0.05 / 0.05.
"""

import numpy as np
import pytest
import torch

import mcos_tpu.engine.ssvi as jssvi
import mcos_tpu_torch.engine.ssvi as pssvi

import jax.numpy as jnp

torch.set_num_threads(1)

TRUE = dict(rho=-0.45, eta=1.2, gamma=0.4)
MATS = np.array([0.25, 0.5, 1.0, 2.0])
THETA = np.array([0.012, 0.022, 0.041, 0.078])
SPOT, R, Q = 100.0, 0.05, 0.01


def _surfaces(**shape):
    shape = shape or TRUE
    return (pssvi.SSVISurface(MATS, THETA, **shape),
            jssvi.SSVISurface(MATS, THETA, **shape))


def test_total_variance_matches_jax():
    rng = np.random.default_rng(0)
    k = rng.uniform(-1.5, 1.5, (4, 9)).astype(np.float32)
    th = THETA.astype(np.float32)[:, None]
    got = pssvi.ssvi_total_variance(torch.from_numpy(k), torch.from_numpy(th),
                                    **TRUE).numpy()
    ref = np.asarray(jssvi.ssvi_total_variance(k, th, **TRUE))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [TRUE, dict(rho=0.3, eta=3.5, gamma=0.1)])
def test_butterfly_g_matches_jax(shape):
    k = np.linspace(-1.0, 1.0, 41).astype(np.float32)
    for th in (0.01, 0.2):
        got = pssvi.butterfly_g(torch.from_numpy(k), th, **shape).numpy()
        ref = np.asarray(jssvi.butterfly_g(jnp.asarray(k), th, **shape))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_objective_matches_jax_per_member():
    rng = np.random.default_rng(1)
    strikes = np.tile(np.linspace(80.0, 120.0, 7), (len(MATS), 1))
    fwd = SPOT * np.exp((R - Q) * MATS)
    k = np.log(strikes / fwd[:, None]).astype(np.float32)
    w_mkt = (0.04 * MATS[:, None] + 0.01 * k ** 2).astype(np.float32)
    wts = rng.uniform(0.5, 1.5, k.shape).astype(np.float32)
    wts /= wts.sum()
    pop = np.stack([rng.uniform(-0.9, 0.9, 6), rng.uniform(0.1, 4.0, 6),
                    rng.uniform(0.05, 0.9, 6)], 1).astype(np.float32)
    th = THETA.astype(np.float32)
    got = pssvi._ssvi_objective(torch.from_numpy(pop), {
        "k": torch.from_numpy(k), "w_mkt": torch.from_numpy(w_mkt),
        "weights": torch.from_numpy(wts), "theta": torch.from_numpy(th)}
    ).numpy()
    jdata = {"k": jnp.asarray(k), "w_mkt": jnp.asarray(w_mkt),
             "weights": jnp.asarray(wts), "theta": jnp.asarray(th)}
    ref = np.array([float(jssvi._ssvi_objective(jnp.asarray(x), jdata))
                    for x in pop])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def test_surface_methods_match_jax():
    a, b = _surfaces()
    T = np.array([0.1, 0.25, 0.7, 2.0, 3.0])
    np.testing.assert_allclose(a.theta_at(T), b.theta_at(T), rtol=1e-12)
    k = np.linspace(-0.8, 0.8, 17)
    for t in (0.1, 0.7, 3.0):
        np.testing.assert_allclose(a.total_variance(k, t),
                                   b.total_variance(k, t), rtol=1e-6)
        np.testing.assert_allclose(a.vol(k, t), b.vol(k, t), rtol=1e-6)
        assert a.atm_skew(t) == pytest.approx(b.atm_skew(t), rel=1e-12)
    strikes = np.linspace(70.0, 130.0, 13)
    np.testing.assert_allclose(a.iv_grid(SPOT, strikes, MATS, R, Q),
                               b.iv_grid(SPOT, strikes, MATS, R, Q),
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [TRUE, dict(rho=-0.95, eta=4.8,
                                              gamma=0.05)])
def test_arbitrage_report_matches_jax(shape):
    a, b = _surfaces(**shape)
    got, ref = a.arbitrage_report(), b.arbitrage_report()
    assert got.keys() == ref.keys()
    for key in ("butterfly_free", "calendar_free"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["butterfly_g_min"], ref["butterfly_g_min"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["calendar_min_dw"], ref["calendar_min_dw"],
                               rtol=1e-5, atol=1e-8)
    for key in ("thm42_cond1_max", "thm42_cond2_max"):
        assert got[key] == pytest.approx(ref[key], rel=1e-12)


@pytest.fixture(scope="module")
def fits():
    truth = pssvi.SSVISurface(MATS, THETA, **TRUE)
    strikes = np.tile(np.linspace(75.0, 125.0, 11), (len(MATS), 1))
    fwd = SPOT * np.exp((R - Q) * MATS)
    ivs = np.stack([truth.vol(np.log(strikes[i] / fwd[i]), t)
                    for i, t in enumerate(MATS)])
    ivs[2, 3] = np.nan                     # a missing quote is skipped
    kw = dict(seed=2, pop_size=16, iters=40, polish_steps=40)
    return (pssvi.calibrate_ssvi(MATS, fwd, strikes, ivs, device="cpu", **kw),
            jssvi.calibrate_ssvi(MATS, fwd, strikes, ivs, **kw))


def test_calibrate_ssvi_by_outcome(fits):
    got, ref = fits
    assert got.keys() == ref.keys()
    assert got["objective"] <= 2.0 * ref["objective"] + 1e-10, (
        got["objective"], ref["objective"])
    assert abs(got["rho"] - TRUE["rho"]) < 0.02, got
    assert abs(got["eta"] - TRUE["eta"]) < 0.05, got
    assert abs(got["gamma"] - TRUE["gamma"]) < 0.05, got
    assert got["n_quotes"] == ref["n_quotes"] == 43
    np.testing.assert_allclose(got["theta"], ref["theta"], rtol=1e-12)
    assert got["arbitrage"].keys() == ref["arbitrage"].keys()
    assert isinstance(got["surface"], pssvi.SSVISurface)
