"""Port pins for the time-dependent SVJ slice: the torch twins step for
step against the JAX scans on replayed draws, kernel K9's plain version
(the CPU side of `cuda_kernels.svj_terminal_td`) by law and against the
interpreted Pallas kernel's known path, the Poisson-binomial count table
and the unclamped-v0 hazard, and `TDSVJEngine`. The kernel itself runs only
on a CUDA device (tests/test_torch_cuda.py and chip_smoke.py, word for word
against the plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import termsvj as jterm
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.models.params import TermStructureSVJ as JTermStructureSVJ
from mcos_tpu.ops import pallas_kernels as jpk
from mcos_tpu.ops import tdsvj as jtd
from mcos_tpu_torch.engine import termsvj as pterm
from mcos_tpu_torch.models.params import SVJParams, TermStructureSVJ
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import tdsvj as ptd

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.06, xi=0.5, rho=-0.7, v0=0.04,
               lambda_j=1.0, mu_j=-0.05, sigma_j=0.1, r=0.05, q=0.01)
_SEG = (np.array([0.15, 0.3, 0.5]), np.array([0.04, 0.08, 0.05]),
        np.array([0.4, 0.9, 0.6]), np.array([0.5, 6.0, 2.0]))
_SPOT, _T = 100.0, 0.5


def _both(**updates):
    fields = dict(_FIELDS, **updates)
    return JSVJParams(**fields), SVJParams(**fields)


def _levels(steps, T=_T):
    return ptd.step_param_arrays(*_SEG, T, steps)


def _replayed_draws(key, steps, n):
    """The JAX td scan's own (steps, 3, n) normals and (steps, n) uniforms
    (ops/tdsvj.py: fold_in by step, then one split)."""
    z, u = [], []
    for i in range(steps):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, i))
        z.append(np.asarray(jax.random.normal(k_norm, (3, n), jnp.float32)))
        u.append(np.asarray(jax.random.uniform(k_unif, (n,), jnp.float32)))
    return torch.from_numpy(np.stack(z)), torch.from_numpy(np.stack(u))


@pytest.mark.parametrize("antithetic", [True, False])
def test_terminal_twin_equals_jax_scan_on_replayed_draws(antithetic):
    """`simulate_terminal_td` on the JAX scan's own draws: S, v and G at
    rtol 2e-5 (atol 1e-7 for a v at the truncation floor)."""
    jp, pp = _both()
    steps, n = 16, 2048
    th, xi, lam = _levels(steps)
    key = jax.random.key(7)
    ref = jtd.simulate_terminal_td(jp, th, xi, lam, _SPOT, _T, key, n, steps,
                                   antithetic=antithetic, companion=True)
    got = ptd.simulate_terminal_td(pp, th, xi, lam, _SPOT, _T, None, n, steps,
                                   antithetic=antithetic, companion=True,
                                   draws=_replayed_draws(key, steps, n))
    for g, r in zip(got, ref):
        assert g.shape == (2 if antithetic else 1, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("reset_step", [1, 5, 15])
def test_reset_twin_equals_jax_scan_on_replayed_draws(reset_step):
    jp, pp = _both()
    steps, n = 16, 1024
    th, xi, lam = _levels(steps)
    key = jax.random.key(9)
    ref = jtd.simulate_reset_td(jp, th, xi, lam, _SPOT, _T, reset_step, key,
                                n, steps)
    got = ptd.simulate_reset_td(pp, th, xi, lam, _SPOT, _T, reset_step, None,
                                n, steps,
                                draws=_replayed_draws(key, steps, n))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5)
    no_g = ptd.simulate_reset_td(pp, th, xi, lam, _SPOT, _T, reset_step,
                                 None, n, steps, companion=False,
                                 draws=_replayed_draws(key, steps, n))
    assert no_g[2] is None and no_g[3] is None


def test_period_returns_twin_equals_jax_scan_on_replayed_draws():
    """`_period_log_returns_td` (cliquet legs, variance swap) on the JAX
    nested scan's draws: per-period log returns at atol 2e-6."""
    jp, pp = _both()
    n_periods, spp, n = 4, 4, 1024
    steps = n_periods * spp
    th, xi, lam = _levels(steps)
    key = jax.random.key(11)
    shape = (n_periods, spp)
    ref = jterm._period_log_returns_td(
        jp, th.reshape(shape), xi.reshape(shape), lam.reshape(shape), _T, key,
        num_paths=n, n_periods=n_periods, steps_per_period=spp)
    got = pterm._period_log_returns_td(
        pp, th.reshape(shape), xi.reshape(shape), lam.reshape(shape), _T,
        None, num_paths=n, n_periods=n_periods, steps_per_period=spp,
        draws=_replayed_draws(key, steps, n))
    for g, r in zip(got, ref):
        assert g.shape == (n_periods, 2, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("steps", [6, 7])
def test_twin_steps_the_interpreted_pallas_kernel(steps):
    """Off a TPU the Pallas interpreter's generator returns zero bits, so
    `svj_terminal_td_pallas` runs one known path per branch: every
    Box-Muller pair is the same (z_a, z_b), and the count uniform 2^-24
    lies below P(no jump), so no jump lands. The port's twin on those
    normals, with jump uniforms of 1 (no jump), gives the same S, v and G
    (rtol 2e-5): the step algebra and the per-step table against the TPU
    kernel itself."""
    jp, pp = _both()
    n = 1024
    th, xi, lam = _levels(steps)
    ref = jpk.svj_terminal_td_pallas(jp, th, xi, lam, _SPOT, _T, 3,
                                     num_paths=n, num_steps=steps,
                                     companion=True, rows=8)
    u0 = jnp.float32(2.0 ** -24)
    z_a, z_b = (float(x) for x in jpk._boxmuller(u0, u0))
    z = np.empty((steps, 3, n), np.float32)
    z[:] = np.array([z_a, z_b, 0.0], np.float32)[None, :, None]
    u = np.ones((steps, n), np.float32)
    got = ptd.simulate_terminal_td(pp, th, xi, lam, _SPOT, _T, None, n, steps,
                                   companion=True,
                                   draws=(torch.from_numpy(z),
                                          torch.from_numpy(u)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert (r == r[:, :1]).all()                 # one path per branch
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-5)


# ── hazard 1: the Poisson-binomial count table ──────────────────────────────
@pytest.mark.parametrize("lam_T,steps", [(0.5, 16), (5.0, 63), (60.0, 512)])
def test_count_table_constant_lambda_equals_binomial(lam_T, steps):
    p = lam_T / steps
    a = ck.poisson_binom_count_table(np.full(steps, p))
    b = ck.binom_count_table(p, steps)
    assert a.size == b.size
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("total", [1.0, 30.0, 60.0, 150.0])
def test_count_table_mean_is_sum_of_p(total):
    """Mean from the table, Σₖ P(count > k), within 1e-6 of Σpᵢ for uneven
    pᵢ up to Σpᵢ = 150 (the reference's 64-entry float32 table is 5.6 %
    short at 60)."""
    steps = 512
    w = np.linspace(0.2, 1.8, steps)
    p = total * w / w.sum()
    cdf = ck.poisson_binom_count_table(p)
    assert cdf.size >= 64 and np.all(np.diff(cdf) >= 0) and cdf[-1] <= 1.0
    assert 1.0 - cdf[-1] < 2.0 ** -24
    assert abs(np.sum(1.0 - cdf) - total) < 1e-6
    # the variance too: Σ pᵢ(1 − pᵢ); the tail cut at 2⁻²⁴ weighs k² there
    k = np.arange(cdf.size)
    pmf = np.diff(np.concatenate([[0.0], cdf]))
    var = np.sum(pmf * k**2) - np.sum(pmf * k) ** 2
    assert abs(var - np.sum(p * (1 - p))) < 1e-2


def test_count_table_against_the_reference_table():
    """Where the reference's float32 table is itself within 1e-6 of a
    float64 convolution (few expected jumps), the port's agrees with it to
    1e-6; at 60 expected jumps the reference's mean is short by percents
    and the port's is not."""
    p = np.linspace(0.001, 0.02, 40)
    conv = np.array([1.0])
    for p_i in p:
        conv = np.convolve(conv, [1.0 - p_i, p_i])
    exact = np.cumsum(conv)[:64]
    ref = np.asarray(jpk._poisson_binom_cdf(jnp.asarray(p, jnp.float32)),
                     np.float64)
    exact = np.concatenate([exact, np.ones(64 - exact.size)])
    assert np.abs(ref - exact).max() < 1e-6
    got = ck.poisson_binom_count_table(p)
    np.testing.assert_allclose(got[:64], ref, rtol=0, atol=1e-6)
    heavy = np.full(512, 60.0 / 512)
    ref_mean = float(np.sum(1.0 - np.asarray(
        jpk._poisson_binom_cdf(jnp.asarray(heavy, jnp.float32)), np.float64)))
    assert ref_mean < 60.0 * 0.97
    assert abs(np.sum(1.0 - ck.poisson_binom_count_table(heavy)) - 60.0) < 1e-6


def test_count_table_edge_cases():
    assert (ck.poisson_binom_count_table(np.zeros(8)) == 1.0).all()
    sure = ck.poisson_binom_count_table(np.full(5, 7.0))   # clipped to 1
    assert (sure[:5] == 0.0).all() and (sure[5:] == 1.0).all()
    assert sure.size == 64


# ── K9's plain version ──────────────────────────────────────────────────────
def _plain(pp, levels, seed=11, n=1 << 12, steps=16, T=_T, **kw):
    before = dict(ck.launch_counts())
    out = ck.svj_terminal_td(pp, *levels, _SPOT, T, seed, num_paths=n,
                             num_steps=steps, device="cpu", **kw)
    assert ck.launch_counts() == before        # a CPU device: no launch
    return out


@pytest.mark.parametrize("steps", [16, 7])
@pytest.mark.parametrize("antithetic", [True, False])
def test_plain_equals_twin_on_its_own_philox_draws(steps, antithetic):
    """K9's plain version (what the card kernel is held bit-equal to) and
    the twin (pinned to the JAX scan above) on the same normals, path by
    path, over an even and an odd step count and three levels of θ, ξ, λ.
    The two place their jumps differently (one count per path against one
    Bernoulli test per step), so the twin runs with jump uniforms of 1 (no
    test fires; its drift keeps the compensator λᵢ·k) and the path's jump,
    μ_J·n ± σ_J·√n·z, is added from the plain version's own last call: the
    count through `poisson_binom_count_table`, whose law has its own tests
    above. S, v and G at rtol 2e-5 (atol 1e-7 for a v at the floor)."""
    _, pp = _both()
    n, seed = 2048, 11
    levels = _levels(steps)

    def words(call):
        return ck._pair_words(n, call, ck._TD_DOMAIN, seed, "cpu")

    z = []
    for call in range((steps + 1) // 2):
        u = words(call)
        z += [torch.stack(ck.box_muller(u[0], u[1])),
              torch.stack(ck.box_muller(u[2], u[3]))]
    z = torch.stack(z[:steps])
    z = torch.cat([z, torch.zeros(steps, 1, n)], dim=1)   # z_js: unused
    s_ref, v_ref, g_ref = ptd.simulate_terminal_td(
        pp, *levels, _SPOT, _T, None, n, steps, antithetic=antithetic,
        companion=True, draws=(z, torch.ones(steps, n)))
    u = words((steps + 1) // 2)
    count = ck.count_from_table(u[0], ck.poisson_binom_count_table(
        levels[2] * _T / steps))
    assert 0.3 < float((count > 0).float().mean()) < 0.95
    z_total, _ = ck.box_muller(u[1], u[2])
    sign = torch.tensor([1.0, -1.0][:2 if antithetic else 1])[:, None]
    s_ref = s_ref * torch.exp(pp.mu_j * count
                              + sign * pp.sigma_j * torch.sqrt(count) * z_total)
    got = ck.svj_terminal_td_plain(pp, *levels, _SPOT, _T, seed, num_paths=n,
                                   num_steps=steps, antithetic=antithetic,
                                   companion=True)
    for g, r in zip(got, (s_ref, v_ref, g_ref)):
        assert g.shape == (2 if antithetic else 1, n)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-5,
                                   atol=1e-7)


def test_plain_constant_levels_equal_k3_law():
    """Constant arrays: K9's plain version carries K3's recursion on K3's
    word layout in another domain, so means of log S, v and the call payoff
    agree with K3's plain version within 4 combined se, and the jump count
    table is K3's."""
    _, pp = _both(lambda_j=3.0)
    n, steps = 1 << 13, 16
    const = (np.full(steps, pp.theta), np.full(steps, pp.xi),
             np.full(steps, pp.lambda_j))
    a = [x.double().numpy() for x in _plain(pp, const, n=n, steps=steps)[:2]]
    b = [x.double().numpy() for x in ck.svj_terminal(
        pp, _SPOT, _T, 11, num_paths=n, num_steps=steps, device="cpu")[:2]]
    for f in (lambda s, v: np.log(s), lambda s, v: v,
              lambda s, v: np.maximum(s - _SPOT, 0.0)):
        x, y = f(*a).mean(axis=0), f(*b).mean(axis=0)
        assert abs(x.mean() - y.mean()) \
            < 4 * np.hypot(x.std(), y.std()) / np.sqrt(n)


def test_plain_law_matches_twin_and_cos_oracle():
    """Three segments of different theta, xi, lambda: the plain version's
    call prices within 4 se + 1 % of `cos_price_td`, and its moments within
    4 combined se of the JAX td scan's."""
    jp, pp = _both()
    n, steps = 1 << 13, 32
    levels = _levels(steps)
    s, v, g = (x.double().numpy() for x in _plain(pp, levels, n=n,
                                                  steps=steps,
                                                  companion=True))
    ref = [np.asarray(x, np.float64) for x in jtd.simulate_terminal_td(
        jp, *levels, _SPOT, _T, jax.random.key(3), n, steps, companion=True)]
    for got, r in ((np.log(s), np.log(ref[0])), (v, ref[1]), (g, ref[2])):
        x, y = got.mean(axis=0), r.mean(axis=0)
        assert abs(x.mean() - y.mean()) \
            < 4 * np.hypot(x.std(), y.std()) / np.sqrt(n)
    disc = np.exp(-pp.r * _T)
    exact = ptd.cos_price_td(pp, _SPOT, [90.0, 100.0, 110.0], _T, *_SEG)
    for k, want in zip((90.0, 100.0, 110.0), exact):
        pay = disc * np.maximum(s - k, 0.0).mean(axis=0)
        assert abs(pay.mean() - want) \
            < 4 * pay.std() / np.sqrt(n) + 0.01 * want


def test_hazard_negative_v0_is_clamped():
    """The TPU kernel starts v from v0 unclamped and takes sqrt(v) with no
    max; K9 starts its carry at max(v0, 0), as K3 does and as the scan twin
    reads it."""
    _, pp = _both(v0=-0.01)
    s, v, _ = _plain(pp, _levels(12), n=512, steps=12)
    assert bool(torch.isfinite(s).all()) and bool((v >= 0).all())
    _, zero = _both(v0=0.0)
    s0, v0, _ = _plain(zero, _levels(12), n=512, steps=12)
    np.testing.assert_array_equal(s.numpy(), s0.numpy())
    np.testing.assert_array_equal(v.numpy(), v0.numpy())


def test_plain_streams_and_arguments():
    _, pp = _both()
    a = _plain(pp, _levels(7), n=512, steps=7, companion=True)
    b = _plain(pp, _levels(7), n=512, steps=7, antithetic=False)
    assert b[2] is None and a[2].shape == (2, 512)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x[:1].numpy(), y.numpy())
    with pytest.raises(ValueError, match="theta_t has 7 entries"):
        _plain(pp, _levels(7), n=64, steps=8)
    consts, table, lam_dt = ck._td_consts(pp, *_levels(8), _SPOT, _T, 8)
    assert consts.shape == (12,) and table.shape == (4, 8)
    assert table.dtype == np.float32 and lam_dt.dtype == np.float64
    np.testing.assert_allclose(table[2], _levels(8)[2] * _T / 8, rtol=1e-6)


# ── engine ──────────────────────────────────────────────────────────────────
def _engines(**kw):
    jp, pp = _both()
    kw = dict(dict(num_paths=1 << 12, num_steps=32, seed=4), **kw)
    return (jterm.TDSVJEngine(jp, *_SEG, backend="scan", **kw),
            pterm.TDSVJEngine(pp, *_SEG, device="cpu", **kw))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_engine_price_batch_against_jax_and_cos(backend):
    jeng, _ = _engines()
    _, pp = _both()
    eng = pterm.TDSVJEngine(pp, *_SEG, num_paths=1 << 12, num_steps=32,
                            seed=4, backend=backend, device="cpu")
    strikes = [90.0, 100.0, 110.0]
    ref, got = (e.price_batch(_SPOT, strikes, _T) for e in (jeng, eng))
    exact = eng.cos_chain(_SPOT, strikes, _T)
    np.testing.assert_array_equal(exact, jeng.cos_chain(_SPOT, strikes, _T))
    for r, g, want in zip(ref, got, exact):
        assert g.keys() == r.keys()
        assert abs(g["price"] - r["price"]) \
            < 4 * np.hypot(g["std_error"], r["std_error"])
        assert abs(g["price"] - want) < 4 * g["std_error"] + 0.01 * want
    assert eng.price(_SPOT, 100.0, _T) == got[1]
    assert eng.segments_dict() == jeng.segments_dict()


def test_engine_greeks_forward_start_cliquet_varswap_against_jax():
    """The twin-backed methods: same keys as the JAX engine, deterministic
    fields equal, Monte Carlo fields within 4 combined se (Greeks within
    MC noise of other streams)."""
    jeng, eng = _engines()
    ref, got = (e.greeks(_SPOT, 100.0, _T) for e in (jeng, eng))
    assert got.keys() == ref.keys()
    for k, tol in (("price", 0.05), ("delta", 0.05), ("vega", 0.2)):
        assert abs(got[k] - ref[k]) < tol * abs(ref[k]), k

    ref, got = (e.price_forward_start(_SPOT, 0.2, _T) for e in (jeng, eng))
    assert got.keys() == ref.keys()
    assert got["t1_effective"] == ref["t1_effective"]
    assert abs(got["price"] - ref["price"]) \
        < 4 * np.hypot(got["std_error"], ref["std_error"])
    assert abs(got["cv_beta"] - ref["cv_beta"]) < 0.2
    with pytest.raises(ValueError):
        eng.price_forward_start(_SPOT, 0.6, _T)

    ref, got = (e.price_cliquet(_T, n_periods=3) for e in (jeng, eng))
    assert got.keys() == ref.keys()
    assert got["num_steps"] == ref["num_steps"] == 30
    assert abs(got["price"] - ref["price"]) \
        < 4 * np.hypot(got["std_error"], ref["std_error"])

    ref, got = (e.variance_swap(_T) for e in (jeng, eng))
    assert got.keys() == ref.keys()
    for k in ("fair_variance", "fair_vol_strike", "diffusion_leg",
              "jump_leg"):
        assert got[k] == ref[k]
    assert got["mc_vs_closed_sigmas"] < 4
    assert abs(got["mc_fair_variance"] - ref["mc_fair_variance"]) \
        < 4 * np.hypot(got["mc_std_error"], ref["mc_std_error"])


def test_engine_no_control_variate_and_refusals():
    jp, pp = _both()
    eng = pterm.TDSVJEngine(pp, *_SEG, num_paths=1 << 11, num_steps=16,
                            control_variate=False, device="cpu")
    row = eng.price(_SPOT, 100.0, _T)
    assert row["price"] == row["raw_mc_price"]
    assert "cv_beta" not in eng.price_forward_start(_SPOT, 0.2, _T)
    assert "cv_beta" not in eng.price_cliquet(_T, n_periods=2)
    # The American pricer, once a refusal, now prices: a put is worth at
    # least its no-early-date Bermudan on the same paths.
    amer = eng.price_american(_SPOT, 100.0, _T)
    euro = eng.price_american(_SPOT, 100.0, _T, exercise_every=16)
    assert np.isfinite(amer["price"]) and amer["std_error"] > 0
    assert amer["price"] >= euro["price"] - 3 * euro["std_error"]
    # The mesh, once refused, is slice N1's: without the control variate a
    # one-shard mesh prices the same raw estimator on the same K9 paths.
    from mcos_tpu_torch.parallel.mesh import make_mesh

    sharded = pterm.TDSVJEngine(pp, *_SEG, num_paths=1 << 11, num_steps=16,
                                control_variate=False,
                                mesh=make_mesh(["cpu"]), device="cpu")
    got = sharded.price(_SPOT, 100.0, _T)
    assert got["num_devices"] == 1
    assert got["price"] == pytest.approx(row["price"], rel=1e-6)
    assert got["std_error"] == pytest.approx(row["std_error"], rel=1e-6)
    with pytest.raises(ValueError):
        pterm.TDSVJEngine(pp, [0.1], [0.04, 0.05], [0.5], [1.0],
                          device="cpu")


def test_term_structure_round_trip_and_stripping():
    curves = dict(theta_curve={0.25: 0.04, 1.0: 0.06},
                  xi_curve={0.25: 0.5, 1.0: 0.7},
                  lambda_curve={0.25: 1.0, 1.0: 2.0})
    jts, pts = JTermStructureSVJ(**curves), TermStructureSVJ(**curves)
    assert TermStructureSVJ.from_numpy(pts.to_numpy()) == pts
    for T in (0.1, 0.5, 2.0):
        assert (pts.get_params_at_maturity(T).as_dict()
                == {k: float(v) for k, v in
                    jts.get_params_at_maturity(T).as_dict().items()})
    for a, b in zip(ptd.segments_from_term_structure(pts, 1.0, 4),
                    jtd.segments_from_term_structure(jts, 1.0, 4)):
        np.testing.assert_array_equal(a, b)
    eng = pterm.TDSVJEngine.from_term_structure(pts, 1.0, 4, num_paths=1024,
                                                num_steps=8, device="cpu")
    jeng = jterm.TDSVJEngine.from_term_structure(jts, 1.0, 4)
    assert eng.segments_dict() == jeng.segments_dict()
    with pytest.raises(KeyError):
        TermStructureSVJ.from_numpy({"kappa": 1.0})


def test_bootstrap_calibrate_recovers_segments():
    """Host only: market prices made by `cos_price_td` on known segments
    are repriced by the bootstrap's fit to 1e-4 of the spot."""
    _, pp = _both()
    mats, strikes = [0.25, 0.5], [95.0, 100.0, 105.0]
    truth = ([0.25, 0.5], [0.05, 0.08], [0.5, 0.8], [1.0, 2.0])
    market = [ptd.cos_price_td(pp, _SPOT, strikes, T, *truth) for T in mats]
    fit = pterm.bootstrap_calibrate_td(_SPOT, mats, strikes, market, pp,
                                       maxiter=15)
    model = [ptd.cos_price_td(pp, _SPOT, strikes, T, fit["seg_ends"],
                              fit["thetas"], fit["xis"], fit["lams"])
             for T in mats]
    assert np.abs(np.asarray(model) - np.asarray(market)).max() < 1e-2
    assert set(fit) == {"seg_ends", "thetas", "xis", "lams", "errors",
                        "shared"}
    with pytest.raises(ValueError):
        pterm.bootstrap_calibrate_td(_SPOT, [0.5, 0.25], strikes, market, pp)
