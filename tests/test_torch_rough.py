"""Port pins for the rough Bergomi slice against `mcos_tpu`: the host
tables (Volterra covariance, the Cholesky, PCA and conditional factors,
the lift tables), the exact sampler and the lift twins on replayed draws,
the lift twins against the interpreted Pallas kernels, the engine's
autograd Greeks, the RQMC normals, and the calibration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine.rough import RoughBergomiEngine as JEngine
from mcos_tpu.ops import pallas_kernels as jpk
from mcos_tpu.ops import rough as jr
from mcos_tpu.ops import sobol as jsobol
from mcos_tpu_torch.engine.rough import RoughBergomiEngine, calibrate_rbergomi
from mcos_tpu_torch.ops import rough as pr
from mcos_tpu_torch.ops import sobol as psobol

torch.set_num_threads(1)

H = 0.07
_FIELDS = dict(xi=0.04, eta=1.9, rho=-0.9, r=0.05, q=0.01, hurst=H)
_SPOT, _T = 100.0, 0.25


def _both(**updates):
    fields = dict(_FIELDS, **updates)
    return jr.RoughBergomiParams(**fields), pr.RoughBergomiParams(**fields)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _close_signed(got, ref, scale, rtol):
    """|got - ref| <= rtol·(|ref| + scale): a signed sum such as I1 is held
    relative to the size of its terms, not to its own value near zero."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(got - ref) <= rtol * (np.abs(ref) + scale))


# ─────────────────────────────────────────────────────────────────────────────
# Host tables (float64, copied)
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("h,T,n", [(0.07, 0.25, 16), (0.1, 1.0, 64),
                                   (0.5, 0.5, 16)])
def test_host_tables_equal_jax(h, T, n):
    """volterra_cov, the Cholesky and PCA factors, the conditional factor
    and the lift tables equal the JAX package's to 1e-6 relative."""
    t = T / n * np.arange(1, n + 1)
    np.testing.assert_allclose(pr.volterra_cov(t[:, None], t[None, :], h),
                               jr.volterra_cov(t[:, None], t[None, :], h),
                               rtol=1e-6)
    np.testing.assert_allclose(pr.volterra_increment_cov(t, h, T / n),
                               jr.volterra_increment_cov(t, h, T / n),
                               rtol=1e-6)
    for transform in ("cholesky", "pca"):
        np.testing.assert_allclose(pr.rbergomi_chol(h, T, n, transform),
                                   jr.rbergomi_chol(h, T, n, transform),
                                   rtol=1e-6, atol=1e-9)
    for a, b in zip(pr.rbergomi_conditional_factor(h, T, n, rank=4),
                    jr.rbergomi_conditional_factor(h, T, n, rank=4)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    lift_p, lift_j = pr.rbergomi_lift(h, T, n), jr.rbergomi_lift(h, T, n)
    for a, b in zip(lift_p, lift_j):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    assert len(lift_p[0]) == (1 if h == 0.5 else 25)
    with pytest.raises(ValueError):
        pr.rbergomi_chol(h, T, n, "conditional")
    with pytest.raises(ValueError):
        pr.rbergomi_conditional_factor(h, T, n, rank=0)


def test_params_round_trip_and_xi_curve():
    jp, pp = _both()
    assert pr.RoughBergomiParams.from_numpy(pp.to_numpy()) == pp
    assert pr.RoughBergomiParams.from_numpy(
        {k: np.float64(getattr(jp, k)) for k in _FIELDS}) == pp
    with pytest.raises(KeyError):
        pr.RoughBergomiParams.from_numpy({"xi": 0.04})
    edges, vals = pr.xi_curve_from_variance_swaps([0.25, 1.0], [0.2, 0.25])
    for a, b in zip((edges, vals), jr.xi_curve_from_variance_swaps(
            [0.25, 1.0], [0.2, 0.25])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pr.sample_xi_curve(edges, vals, 1.0, 16),
                                  jr.sample_xi_curve(edges, vals, 1.0, 16))


# ─────────────────────────────────────────────────────────────────────────────
# Exact sampler on the same normals
# ─────────────────────────────────────────────────────────────────────────────
_N, _STEPS = 2048, 16


def _normals(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("variant", ["flat", "xi_curve", "conditional"])
def test_core_equals_jax_on_the_same_normals(variant):
    """rbergomi_core against the JAX function fed the same z (and, for the
    conditional factorization, the same tail normals): v_mean and I2 at
    rtol 1e-4, I1 against the size of its terms."""
    jp, pp = _both()
    key = jax.random.key(4)
    kw = dict(num_paths=_N, num_steps=_STEPS)
    xi_t = (np.linspace(0.03, 0.05, _STEPS).astype(np.float32)
            if variant == "xi_curve" else None)
    if variant == "conditional":
        chol, tail = pr.rbergomi_conditional_factor(H, _T, _STEPS, rank=6)
        zd = np.asarray(jax.random.normal(jax.random.fold_in(key, 77),
                                          (_N, _STEPS), jnp.float32))
    else:
        chol, tail, zd = pr.rbergomi_chol(H, _T, _STEPS), None, None
    z = _normals((_N, chol.shape[1]))
    ref = jr.rbergomi_core(jp, _T, jnp.asarray(chol), key, z=jnp.asarray(z),
                           xi_t=None if xi_t is None else jnp.asarray(xi_t),
                           diag_tail=None if tail is None
                           else jnp.asarray(tail), **kw)
    got = pr.rbergomi_core(pp, _T, chol, None, z=_t(z), xi_t=xi_t,
                           diag_tail=tail,
                           zd=None if zd is None else _t(zd), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4)
    _close_signed(got[1].numpy(), ref[1], np.sqrt(np.asarray(ref[2])), 1e-4)


@pytest.mark.parametrize("is_call", [True, False])
def test_conditional_payoffs_equal_jax(is_call):
    jp, pp = _both()
    chol = pr.rbergomi_chol(H, _T, _STEPS)
    z = _normals((_N, 2 * _STEPS), seed=1)
    strikes = [90.0, 100.0, 112.0]
    ref = jr.rbergomi_conditional_payoffs(
        jp, _SPOT, jnp.asarray(strikes), _T, jnp.asarray(chol),
        jax.random.key(0), num_paths=_N, num_steps=_STEPS, is_call=is_call,
        z=jnp.asarray(z))
    got = pr.rbergomi_conditional_payoffs(
        pp, _SPOT, strikes, _T, chol, None, num_paths=_N,
        num_steps=_STEPS, is_call=is_call, z=_t(z))
    assert got.shape == (2, _N, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_path_sheets_equal_jax_on_replayed_draws():
    """rbergomi_log_paths, rbergomi_path_stats and rbergomi_terminal on the
    JAX functions' own draws (split key: z from the first half, the
    orthogonal normals from the second), rtol 1e-4."""
    jp, pp = _both()
    key = jax.random.key(6)
    k_w, k_perp = jax.random.split(key)
    chol = pr.rbergomi_chol(H, _T, _STEPS)
    z = np.asarray(jax.random.normal(k_w, (_N, 2 * _STEPS), jnp.float32))
    zp = np.asarray(jax.random.normal(k_perp, (_N, _STEPS), jnp.float32))
    zp1 = np.asarray(jax.random.normal(k_perp, (_N,), jnp.float32))
    kw = dict(num_paths=_N, num_steps=_STEPS)
    ref = jr.rbergomi_log_paths(jp, _T, jnp.asarray(chol), key, **kw)
    got = pr.rbergomi_log_paths(pp, _T, chol, None, draws=(_t(z), _t(zp)),
                                **kw)
    assert got.shape == (2, _N, _STEPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)
    ref = jr.rbergomi_path_stats(jp, _SPOT, _T, jnp.asarray(chol), key, **kw)
    got = pr.rbergomi_path_stats(pp, _SPOT, _T, chol, None,
                                 draws=(_t(z), _t(zp)), **kw)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4)
    ref = jr.rbergomi_terminal(jp, _SPOT, _T, jnp.asarray(chol), key, **kw)
    got = pr.rbergomi_terminal(pp, _SPOT, _T, chol, None,
                               draws=(_t(z), _t(zp1)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)


# ─────────────────────────────────────────────────────────────────────────────
# Lift twins
# ─────────────────────────────────────────────────────────────────────────────
def _fold_in_draws(key, steps, k, n):
    """The (steps, k, n) normals the JAX lift scans draw, fold_in per step."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (k, n), jnp.float32))
        for i in range(steps)])


@pytest.mark.parametrize("xi_curve", [False, True])
def test_lift_twins_equal_jax_scans_on_replayed_draws(xi_curve):
    """rbergomi_core_lifted (also checkpointed per 8 steps) and
    rbergomi_path_stats_lifted step for step against the JAX scans on
    their fold_in draws: rtol 2e-5 (float32 on both sides)."""
    jp, pp = _both()
    key = jax.random.key(3)
    c, d, g, tail = pr.rbergomi_lift(H, _T, _STEPS)
    xi_t = (np.linspace(0.03, 0.05, _STEPS).astype(np.float32)
            if xi_curve else None)
    kw = dict(num_paths=_N, num_steps=_STEPS)
    ref = jr.rbergomi_core_lifted(
        jp, _T, key, c, d, g, tail,
        xi_t=None if xi_t is None else jnp.asarray(xi_t), **kw)
    draws = _t(_fold_in_draws(key, _STEPS, 2, _N))
    for remat in (0, 8):
        got = pr.rbergomi_core_lifted(pp, _T, None, c, d, g, tail,
                                      xi_t=xi_t, draws=draws,
                                      remat_chunk=remat, **kw)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=2e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=2e-5)
        _close_signed(got[1].numpy(), ref[1], np.sqrt(np.asarray(ref[2])),
                      2e-5)
    ref = jr.rbergomi_path_stats_lifted(
        jp, _SPOT, _T, key, c, d, g, tail,
        xi_t=None if xi_t is None else jnp.asarray(xi_t), **kw)
    got = pr.rbergomi_path_stats_lifted(
        pp, _SPOT, _T, None, c, d, g, tail, xi_t=xi_t,
        draws=_t(_fold_in_draws(key, _STEPS, 3, _N)), **kw)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=2e-5)
    with pytest.raises(ValueError):
        pr.rbergomi_core_lifted(pp, _T, None, c, d, g, tail, draws=draws,
                                remat_chunk=5, **kw)


def _interpreter_normals(steps, k, n):
    """Off a TPU the Pallas interpreter's generator returns zero bits:
    every uniform is 2^-24 and every Box-Muller pair the same
    (z_a, z_b). K10 runs each step on (z_a, z_b); K11 runs step 2i on
    (z_a, z_b, z_a), step 2i+1 on (z_b, z_a, z_b), an odd tail on
    (z_a, z_b, z_a)."""
    u0 = jnp.float32(2.0 ** -24)
    z_a, z_b = (float(x) for x in jpk._boxmuller(u0, u0))
    z = np.empty((steps, k, n), np.float32)
    even, odd = [z_a, z_b, z_a][:k], [z_b, z_a, z_b][:k]
    z[0::2] = np.array(even, np.float32)[None, :, None]
    z[1::2] = np.array(odd if k == 3 else even, np.float32)[None, :, None]
    if steps % 2 and k == 3:
        z[steps - 1] = np.array(even, np.float32)[:, None]
    return _t(z)


@pytest.mark.parametrize("steps", [16, 7])
def test_lift_twins_step_the_interpreted_pallas_kernels(steps):
    """The interpreted K10/K11 Pallas kernels (rows=8, one known path per
    branch) against the twins on the same normals: I2 and the statistics
    at rtol 2e-5, I1 against the size of its terms. Pins the algebra, the
    left-point tables and the draw layout against the TPU kernels."""
    jp, pp = _both()
    n = 1024
    c, d, g, tail = pr.rbergomi_lift(H, _T, steps)
    i1_ref, i2_ref = (np.asarray(x) for x in jpk.rbergomi_lift_integrals_pallas(
        jp.eta, _T, 3, c, d, g, tail, H, num_paths=n, num_steps=steps,
        xi_flat=jp.xi, rows=8))
    assert (i2_ref == i2_ref[:, :1]).all()           # one path per branch
    _, i1, i2 = pr.rbergomi_core_lifted(
        pp, _T, None, c, d, g, tail, num_paths=n, num_steps=steps,
        draws=_interpreter_normals(steps, 2, n))
    np.testing.assert_allclose(i2.numpy(), i2_ref, rtol=2e-5)
    _close_signed(i1.numpy(), i1_ref, np.sqrt(i2_ref), 2e-5)
    st_ref = jpk.rbergomi_lift_stats_pallas(
        (jp.eta, jp.rho, jp.r, jp.q, jp.xi, _SPOT), _T, 3, c, d, g, tail, H,
        num_paths=n, num_steps=steps, rows=8)
    st = pr.rbergomi_path_stats_lifted(
        pp, _SPOT, _T, None, c, d, g, tail, num_paths=n, num_steps=steps,
        draws=_interpreter_normals(steps, 3, n))
    for k in st_ref:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(st_ref[k]),
                                   rtol=2e-5)


# ─────────────────────────────────────────────────────────────────────────────
# Engine: Greeks by autograd, RQMC normals
# ─────────────────────────────────────────────────────────────────────────────
_GREEKS = ("price", "delta", "gamma", "vega_xi", "d_eta", "d_rho",
           "rho_rate")


@pytest.mark.parametrize("sampler,steps", [("exact", 16), ("lift", 24)])
def test_greeks_equal_jax_on_replayed_draws(sampler, steps):
    """`greeks` on the JAX engine's own draws equals the JAX engine's
    nested `jax.grad` (rtol 2e-3): the exact sampler, and the lift twin
    checkpointed per 8 steps (24 steps, three chunks)."""
    jp, pp = _both()
    n, seed = 2048, 3
    ref = JEngine(jp, num_paths=n, num_steps=steps, seed=seed,
                  sampler=sampler).greeks(_SPOT, 100.0, _T)
    if sampler == "exact":
        draws = _t(jax.random.normal(jax.random.key(seed), (n, 2 * steps),
                                     jnp.float32))
    else:
        draws = _t(_fold_in_draws(jax.random.key(seed), steps, 2, n))
    eng = RoughBergomiEngine(pp, num_paths=n, num_steps=steps, seed=seed,
                             sampler=sampler, device="cpu")
    assert eng._remat_chunk() == 8 or sampler == "exact"
    got = eng.greeks(_SPOT, 100.0, _T, draws=draws)
    assert got.keys() == ref.keys() == set(_GREEKS)
    for k in _GREEKS:
        assert got[k] == pytest.approx(ref[k], rel=2e-3), k


@pytest.mark.parametrize("seed,stream,dims", [(42, 0, 32), (7, 5, 48)])
def test_sobol_normals_equal_jax(seed, stream, dims):
    """The stream's scramble words come from fold_in(key(seed), stream) as
    in the JAX package: words and uniforms bit-equal, normals within 1e-6."""
    key = jax.random.fold_in(jax.random.key(seed), stream)
    words = psobol._scramble_words(
        psobol._fold_in(psobol._seed_key(seed), stream), dims)
    np.testing.assert_array_equal(
        words, np.asarray(jsobol._scramble_shift(key, dims)))
    sv = psobol.sobol_direction_numbers(dims)
    n = 1000
    got_int = psobol._sobol_integers(torch.from_numpy(sv.astype(np.int64)),
                                     torch.from_numpy(words.astype(np.int64)),
                                     n, 10)
    ref_u = jsobol._sobol_uniforms_T(jnp.asarray(sv), jnp.asarray(words),
                                     1024)[:, :n]
    np.testing.assert_array_equal(psobol._uniforms(got_int).numpy(),
                                  np.asarray(ref_u))
    got = psobol.sobol_normals(n, dims, seed=seed, stream=stream,
                               device="cpu")
    ref = jsobol.sobol_normals(n, dims, seed=seed, stream=stream)
    assert got.shape == (n, dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_rqmc_price_equals_jax():
    """`price` with use_sobol runs the same 8 Owen streams through the same
    PCA factor as the JAX engine: the same price and error bar to float32
    sums."""
    jp, pp = _both()
    kw = dict(num_paths=4096, num_steps=16, use_sobol=True)
    ref = JEngine(jp, **kw).price(_SPOT, [95.0, 105.0], _T)
    got = RoughBergomiEngine(pp, device="cpu", **kw).price(
        _SPOT, [95.0, 105.0], _T)
    assert got.keys() == ref.keys()
    assert got["estimator"] == ref["estimator"] == "conditional-black+rqmc"
    np.testing.assert_allclose(got["price"], ref["price"], rtol=1e-4)
    np.testing.assert_allclose(got["std_error"], ref["std_error"], rtol=1e-2)


def test_variance_legs_and_terminal_sample_against_jax():
    """The engine's forward-variance curve, variance swaps and terminal
    sample: the curve strike equals the JAX engine's exactly, the MC fair
    variance agrees within 4 joint se, the full corridor is the plain
    variance swap, and E[S_T] = S0 e^{(r-q)T} within 4 se."""
    jp, pp = _both()
    kw = dict(num_paths=4096, num_steps=16)
    quotes = ([0.1, 0.25, 0.5], [0.18, 0.2, 0.21])
    ref = JEngine.from_variance_swaps(jp, *quotes, **kw)
    eng = RoughBergomiEngine.from_variance_swaps(pp, *quotes, device="cpu",
                                                 **kw)
    assert eng.variance_swap_strike(0.3) == ref.variance_swap_strike(0.3)
    a, b = eng.variance_swap_mc(0.25), ref.variance_swap_mc(0.25)
    assert a.keys() == b.keys() and a["curve_strike"] == b["curve_strike"]
    joint = np.hypot(a["std_error_variance"], b["std_error_variance"])
    assert abs(a["fair_variance"] - b["fair_variance"]) < 4 * joint
    full = eng.corridor_variance_swap(_SPOT, 0.25)
    assert full.keys() == ref.corridor_variance_swap(_SPOT, 0.25).keys()
    assert full["fair_variance"] == pytest.approx(a["fair_variance"],
                                                  rel=1e-6)
    assert full["accrual_fraction"] == 1.0
    part = eng.corridor_variance_swap(_SPOT, 0.25, lower=95.0, upper=105.0)
    assert 0.0 < part["accrual_fraction"] < 1.0
    assert part["fair_variance"] < full["fair_variance"]
    s = RoughBergomiEngine(pp, device="cpu", **kw).terminal_sample(_SPOT,
                                                                   _T)
    assert s.shape == (2 * 4096,)
    pair = s.reshape(2, -1).astype(np.float64).mean(axis=0)
    assert abs(pair.mean() - _SPOT * np.exp((pp.r - pp.q) * _T)) \
        < 4 * pair.std() / np.sqrt(pair.size)


# ─────────────────────────────────────────────────────────────────────────────
# Calibration
# ─────────────────────────────────────────────────────────────────────────────
def test_calibration_recovers_rough_parameters():
    """On prices made by the port's own engine at known parameters, the
    batched DE + Adam fit selects the true H from a two-point grid and
    lands (eta, rho, xi) within the JAX package's own test's bands
    (tests/test_rough.py::test_calibration_recovers_rough_parameters)."""
    _, true = _both()
    spot, mats = 100.0, [0.1, 0.5]
    strikes = np.stack([spot * np.linspace(0.92, 1.08, 5) for _ in mats])
    market = np.asarray([
        RoughBergomiEngine(true, num_paths=32_768, num_steps=24, seed=99,
                           device="cpu").price(spot, ks, t)["price"]
        for t, ks in zip(mats, strikes)])
    fit = calibrate_rbergomi(spot, mats, strikes, market, r=0.05, q=0.01,
                             hurst_grid=(H, 0.3), num_paths=4096,
                             num_steps=24, pop_size=10, iters=20,
                             polish_steps=30, device="cpu")
    assert fit["hurst"] == H and fit["params"].hurst == H
    assert abs(fit["eta"] - 1.9) < 0.35
    assert abs(fit["rho"] + 0.9) < 0.10
    assert fit["xi"] == pytest.approx(0.04, abs=0.004)
    assert fit["rmse_price"] < 0.05
    assert list(fit["hurst_grid"]) == [f"{H:g}", "0.3"]
    assert fit["n_quotes"] == 10
