"""The port's surface engine (`mcos_tpu_torch/engine/surface.py`) against
the JAX package's on CPU, on numpy-seeded inputs.

Tolerances:
- host float64 parts at rtol 1e-9: the cubic splines and the arbitrage
  report, the American inversion (Brent through the same CRR tree), the IV
  surface extraction; the de-Americanized European prices are float32
  Black-Scholes in both packages, rtol 1e-5 (an out-of-the-money price
  cancels a few float32 digits);
- `sabr_vol` and the SABR objectives (float32 torch against float32 XLA):
  rtol 1e-5 beside atol 1e-7 (the z/x(z) quotient's float32 rounding) at
  parameters where x(z) does not cancel (at ν/α = 30, 40 % out of the
  money, √(1 − 2ρz + z²) + z − ρ loses four digits in both packages and
  they part by 5e-4), and 1e-4 relative on the objectives (squared
  residuals);
- the SABR differential evolution, whose streams differ (threefry against
  a torch generator), by outcome: the fitted objective within 2× the JAX
  package's + 1e-9, and a synthetic SABR smile's (α, ρ, ν) recovered to
  0.02 / 0.05 / 0.05.
"""

import numpy as np
import pytest
import torch

import mcos_tpu.engine.surface as jsurf
import mcos_tpu_torch.engine.surface as psurf
from mcos_tpu_torch.ops.bs import bs_price

torch.set_num_threads(1)

SPOT, R, Q = 100.0, 0.05, 0.01
STRIKES = np.linspace(80.0, 120.0, 9)
MATS = np.array([0.25, 0.5, 1.0])


def _smile():
    """A skewed IV grid (maturities × strikes) and its BS call/put prices."""
    iv = (0.2 - 0.1 * np.log(STRIKES / SPOT)[None, :]
          + 0.02 * np.sqrt(MATS)[:, None])
    call = np.stack([bs_price(SPOT, STRIKES, t, R, Q, iv[i], True).numpy()
                     for i, t in enumerate(MATS)]).astype(np.float64)
    put = np.stack([bs_price(SPOT, STRIKES, t, R, Q, iv[i], False).numpy()
                    for i, t in enumerate(MATS)]).astype(np.float64)
    return iv, call, put


def _close(got, ref, rtol=1e-9, path=""):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            _close(got[k], ref[k], rtol, f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, rtol, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray) and ref.dtype.kind == "f":
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0,
                                   equal_nan=True, err_msg=path)
    elif isinstance(ref, (float, np.floating)):
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0, err_msg=path)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert got == ref, path


# ─────────────────────────────────────────────────────────────────────────────
# Host float64: splines
# ─────────────────────────────────────────────────────────────────────────────
def test_natural_cubic_spline_matches_jax():
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(-1.0, 1.0, 12))
    y = np.sin(3 * x) + 0.1 * rng.standard_normal(12)
    xq = np.linspace(-1.2, 1.2, 57)
    a, b = psurf.NaturalCubicSpline(x, y), jsurf.NaturalCubicSpline(x, y)
    for nu in (0, 1, 2):
        np.testing.assert_allclose(a(xq, nu), b(xq, nu), rtol=1e-9, atol=0)
    for bad in (x[:2], x[::-1]):
        for cls in (psurf.NaturalCubicSpline, jsurf.NaturalCubicSpline):
            with pytest.raises(ValueError, match="strictly increasing"):
                cls(bad, bad)
    with pytest.raises(ValueError, match="nu"):
        a(xq, 3)


def test_arbitrage_free_spline_matches_jax():
    iv, _, _ = _smile()
    rng = np.random.default_rng(2)
    noisy = iv + 0.02 * rng.standard_normal(iv.shape)   # violations to report
    noisy[1, 4] = np.nan
    for grid in (iv, noisy):
        a, b = psurf.ArbitrageFreeSpline(), jsurf.ArbitrageFreeSpline()
        _close(a.fit(STRIKES, MATS, grid), b.fit(STRIKES, MATS, grid))
        for K, T in ((95.0, 0.25), (101.0, 0.4), (117.0, 0.75), (90.0, 0.1),
                     (110.0, 2.0)):
            _close(a.get_iv(K, T), b.get_iv(K, T))
        _close(a.check_local_variance(STRIKES, MATS),
               b.check_local_variance(STRIKES, MATS))
    assert psurf.ArbitrageFreeSpline().get_iv(100.0, 0.5) is None


# ─────────────────────────────────────────────────────────────────────────────
# Host float64: the American inversion and the IV surface
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("is_call,q", [(False, 0.0), (True, 0.04)])
def test_deamericanize_matches_jax(is_call, q):
    from mcos_tpu_torch.engine.american import binomial_american_bs

    strikes = np.array([85.0, 95.0, 100.0, 105.0, 130.0])
    prices = [binomial_american_bs(SPOT, K, 0.5, 0.06, q, 0.25, steps=256,
                                   is_call=is_call) for K in strikes]
    prices[-1 if not is_call else 0] = max(
        (SPOT - strikes[0]) if is_call else (strikes[-1] - SPOT), 0.0)
    got = psurf.deamericanize_quotes(SPOT, strikes, 0.5, prices, 0.06, q,
                                     is_call)
    ref = jsurf.deamericanize_quotes(SPOT, strikes, 0.5, prices, 0.06, q,
                                     is_call)
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[2].sum() == 4          # the quote at intrinsic is dropped
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[0], 0.25, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=0)
    for args in ((0.0, SPOT, 100.0, 0.5), (5.0, SPOT, 100.0, 0.0),
                 (500.0, SPOT, 100.0, 0.5)):
        assert psurf.implied_vol_american(*args, 0.06, q, is_call) is \
            jsurf.implied_vol_american(*args, 0.06, q, is_call) is None


@pytest.mark.parametrize("exercise,spreads", [
    ("european", False), ("european", True), ("american", False)])
def test_extract_iv_surface_matches_jax(exercise, spreads):
    _, call, put = _smile()
    if exercise == "american":
        call, put = call[:2, ::2], put[:2, ::2]
        strikes, mats = STRIKES[::2], MATS[:2]
    else:
        strikes, mats = STRIKES, MATS
    call = call.copy()
    call[0, 0] = 1e-6                 # below intrinsic: not bracketed
    bas = (0.02 + 0.3 * (np.arange(call.size) % 4 == 0).reshape(call.shape)
           * (call + put)) if spreads else None
    got = psurf.extract_iv_surface(SPOT, R, Q, strikes, mats, call, put,
                                   bid_ask_spreads=bas, exercise=exercise)
    ref = jsurf.extract_iv_surface(SPOT, R, Q, strikes, mats, call, put,
                                   bid_ask_spreads=bas, exercise=exercise)
    _close(got, ref)
    assert np.isnan(got["iv_call"][0, 0]) and not got["valid_mask"][0, 0]
    with pytest.raises(ValueError, match="exercise"):
        psurf.extract_iv_surface(SPOT, R, Q, strikes, mats, call, put,
                                 exercise="bermudan")


# ─────────────────────────────────────────────────────────────────────────────
# SABR (float32 torch)
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("alpha,beta,rho,nu", [
    (0.2, 0.8, -0.3, 0.5), (0.3, 0.5, 0.4, 0.9), (1.2, 1.0, -0.9, 0.05)])
def test_sabr_vol_matches_jax(alpha, beta, rho, nu):
    F = 100.0
    # Strikes on both sides of the |z| < 1e-3 series knee and at the money.
    K = np.concatenate([np.linspace(60.0, 150.0, 31),
                        F * np.exp(np.array([-2e-3, -1e-4, 0.0, 1e-4, 2e-3])
                                   / max(nu / alpha, 1.0))]).astype(np.float32)
    got = psurf.sabr_vol(F, torch.from_numpy(K), 0.7, alpha, beta, rho,
                         nu).numpy()
    ref = np.asarray(jsurf.sabr_vol(F, K, 0.7, alpha, beta, rho, nu))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert np.isfinite(got).all()


def test_sabr_objectives_match_jax_per_member():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    K = np.linspace(85.0, 115.0, 7).astype(np.float32)
    mkt = (0.22 - 0.2 * np.log(K / 100.0)).astype(np.float32)
    w = np.linspace(1.0, 2.0, 7).astype(np.float32)
    w /= w.sum()
    pop_free = np.stack([rng.uniform(lo, hi, 6) for lo, hi in (
        (0.01, 1.0), (0.5, 1.0), (-0.9, 0.9), (0.05, 2.0))], 1)
    pop_fixed = pop_free[:, [0, 2, 3]]
    pdata = {"F": torch.tensor(100.0), "strikes": torch.from_numpy(K),
             "T": torch.tensor(0.5), "market_ivs": torch.from_numpy(mkt),
             "weights": torch.from_numpy(w), "beta_fixed": torch.tensor(0.8)}
    jdata = {"F": jnp.float32(100.0), "strikes": jnp.asarray(K),
             "T": jnp.float32(0.5), "market_ivs": jnp.asarray(mkt),
             "weights": jnp.asarray(w), "beta_fixed": jnp.float32(0.8)}
    for pfn, jfn, pop in (
            (psurf._sabr_objective_free_beta,
             jsurf._sabr_objective_free_beta, pop_free),
            (psurf._sabr_objective_fixed_beta,
             jsurf._sabr_objective_fixed_beta, pop_fixed)):
        pop = pop.astype(np.float32)
        got = pfn(torch.from_numpy(pop), pdata).numpy()
        ref = np.array([float(jfn(jnp.asarray(x), jdata)) for x in pop])
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-10)


@pytest.fixture(scope="module")
def sabr_fits():
    true = dict(alpha=0.45, beta=0.8, rho=-0.35, nu=0.6)
    F, T = 100.0, 0.5
    K = np.linspace(80.0, 120.0, 9)
    ivs = np.asarray(jsurf.sabr_vol(F, K.astype(np.float32), T, **true),
                     np.float64)
    vegas = np.linspace(1.0, 2.0, 9)
    out = {}
    for beta_fixed in (0.8, None):
        kw = dict(vegas=vegas, beta_fixed=beta_fixed, pop_size=12, iters=60,
                  seed=1)
        out[beta_fixed] = (
            psurf.calibrate_sabr(F, K, T, ivs, device="cpu", **kw),
            jsurf.calibrate_sabr(F, K, T, ivs, **kw))
    return true, out


@pytest.mark.parametrize("beta_fixed", [0.8, None])
def test_calibrate_sabr_by_outcome(sabr_fits, beta_fixed):
    true, out = sabr_fits
    got, ref = out[beta_fixed]
    assert got.keys() == ref.keys()
    assert got["error"] <= 2.0 * ref["error"] + 1e-9, (got, ref)
    if beta_fixed is not None:
        assert got["beta"] == 0.8
        assert abs(got["alpha"] - true["alpha"]) < 0.02, got
        assert abs(got["rho"] - true["rho"]) < 0.05, got
        assert abs(got["nu"] - true["nu"]) < 0.05, got
