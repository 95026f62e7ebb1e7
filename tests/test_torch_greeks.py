"""The port's Greeks slice against the JAX package on CPU: the Black-Scholes
Greeks, the score and member twins, the Greeks programs and
`GreeksEngine.all_greeks`, all on draws replayed from the JAX key, plus the
GBM-degenerate law against the closed forms and the float-leaf twins' bits.

Tolerances: BS Greeks rtol 1e-5; twins rtol 2e-5; programs and all_greeks
rtol 1e-4 with atol 1e-5 × spot; the GBM law within 5 standard errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import greeks as jg
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.ops import bs as jbs
from mcos_tpu.ops import simulate as jsim
from mcos_tpu_torch.engine import greeks as pg
from mcos_tpu_torch.models.params import SVJParams, forward_price, gbm_params
from mcos_tpu_torch.ops import bs as pbs
from mcos_tpu_torch.ops import simulate as psim

torch.set_num_threads(1)

FIELDS = dict(kappa=2.0, theta=0.05, xi=0.5, rho=-0.6, v0=0.04, lambda_j=1.5,
              mu_j=-0.08, sigma_j=0.15, r=0.05, q=0.01)
SPOT, STRIKE, T = 100.0, 105.0, 0.5
N, STEPS, SEED = 4096, 16, 3
KW = dict(num_paths=N, num_steps=STEPS, is_call=True)
TOL = dict(rtol=1e-4, atol=1e-5 * SPOT)


def _replayed(seed=SEED, n=N, steps=STEPS):
    """The JAX twins' per-step draws for `jax.random.key(seed)`:
    fold_in(key, t) → split → normal (3, n), uniform (n,)."""
    key = jax.random.key(seed)

    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_norm, (3, n), jnp.float32),
                jax.random.uniform(k_unif, (n,), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return key, (torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u)))


@pytest.fixture(scope="module")
def replayed():
    return _replayed()


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


# ── Black-Scholes ────────────────────────────────────────────────────────────
@pytest.mark.parametrize("is_call", [True, False])
def test_bs_greeks_grid_matches_jax(is_call):
    K, T_, sig = np.meshgrid(np.linspace(70.0, 140.0, 8),
                             [0.0, 0.02, 0.25, 1.0, 3.0],
                             [0.0, 0.05, 0.2, 0.6], indexing="ij")
    K, T_, sig = (x.ravel().astype(np.float32) for x in (K, T_, sig))
    ref = jbs.bs_all_greeks(100.0, jnp.asarray(K), jnp.asarray(T_), 0.05,
                            0.01, jnp.asarray(sig), is_call)
    got = pbs.bs_all_greeks(100.0, torch.from_numpy(K), torch.from_numpy(T_),
                            0.05, 0.01, torch.from_numpy(sig), is_call)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == torch.float32
        # Beside rtol, float32's cancellation floor: an out-of-the-money
        # price or Greek is a difference of terms as large as the grid's
        # largest value, so its absolute error is ~1e-7 of that.
        scale = float(np.abs(np.asarray(ref[k])).max())
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6 * scale, err_msg=k)
    x = np.linspace(-4.0, 4.0, 17, dtype=np.float32)
    np.testing.assert_allclose(pbs.norm_pdf(torch.from_numpy(x)).numpy(),
                               np.asarray(jbs.norm_pdf(jnp.asarray(x))),
                               rtol=1e-5, atol=0)


def test_bs_greeks_are_autograd_of_the_price():
    """At a live point each closed form equals autograd of `bs_price`."""
    S, sig, T_, r = (torch.tensor(v, requires_grad=True)
                     for v in (100.0, 0.25, 0.7, 0.04))
    price = pbs.bs_price(S, 95.0, T_, r, 0.01, sig, True)
    (dS,) = torch.autograd.grad(price, [S], create_graph=True)
    (gam,) = torch.autograd.grad(dS, [S], retain_graph=True)
    d_sig, d_T, d_r = torch.autograd.grad(price, [sig, T_, r])
    ref = pbs.bs_all_greeks(100.0, 95.0, 0.7, 0.04, 0.01, 0.25, True)
    for got, k in ((dS, "delta"), (gam, "gamma"), (d_sig, "vega"),
                   (-d_T, "theta"), (d_r, "rho")):
        np.testing.assert_allclose(float(got.detach()), float(ref[k]),
                                   rtol=2e-4, err_msg=k)


def test_forward_price():
    from mcos_tpu.models.params import forward_price as jforward

    assert forward_price(100.0, 0.05, 0.01, 0.5) == pytest.approx(
        float(jforward(100.0, 0.05, 0.01, 0.5)), rel=1e-6)
    s = torch.tensor(100.0, requires_grad=True)
    f = forward_price(s, 0.05, 0.01, 0.5)
    (g,) = torch.autograd.grad(f, [s])
    assert float(g) == pytest.approx(np.exp(0.04 * 0.5), rel=1e-6)


# ── twins ────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("leaves", ["float", "tensor"])
def test_score_twin_matches_jax(replayed, antithetic, leaves):
    key, draws = replayed
    params = SVJParams(**FIELDS)
    if leaves == "tensor":
        params = params.replace(**{k: torch.tensor(v, requires_grad=True)
                                   for k, v in FIELDS.items()})
    ref = jsim.simulate_terminal_with_score(
        JSVJParams(**FIELDS), SPOT, T, key, num_paths=N, num_steps=STEPS,
        antithetic=antithetic, companion=True)
    got = psim.simulate_terminal_with_score(params, SPOT, T, draws=draws,
                                            antithetic=antithetic,
                                            companion=True)
    for name, a, b in zip(("S", "v", "G", "score"), ref, got):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=2e-5,
                                   atol=1e-6 if name == "v" else 0,
                                   err_msg=name)


def test_score_twin_is_the_generator_twin():
    """With a generator, the score twin draws what `simulate_terminal`
    draws: one seed gives both the same paths."""
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    p = SVJParams(**FIELDS)
    a = psim.simulate_terminal(p, SPOT, T, gen(), 512, 8, companion=True,
                               device="cpu")
    b = psim.simulate_terminal_with_score(p, SPOT, T, gen(), 512, 8,
                                          device="cpu")
    for x, y in zip(a, b[:3]):
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    with pytest.raises(ValueError):
        psim.simulate_terminal_with_score(
            p, SPOT, T, draws=(torch.zeros(4, 3, 8), torch.zeros(4, 8)),
            num_steps=5)


def test_member_twin_matches_jax(replayed):
    key, draws = replayed
    batch = {"v0": [0.05, 0.03, 0.04, 0.04], "lambda_j": [1.5, 1.5, 1.6, 1.4],
             "xi": [0.5, 0.6, 0.4, 0.5]}
    jbatch = JSVJParams(**{k: jnp.asarray(batch.get(k, [v] * 4), jnp.float32)
                           for k, v in FIELDS.items()})
    ref = jsim.simulate_terminal_members(jbatch, SPOT, T, key, num_paths=N,
                                         num_steps=STEPS)
    pbatch = SVJParams(**FIELDS).replace(
        **{k: torch.tensor(v) for k, v in batch.items()})
    got = psim.simulate_terminal_members(pbatch, SPOT, T, draws=draws)
    for name, a, b in zip(("S", "G", "score"), ref, got):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=2e-5,
                                   atol=0, err_msg=name)
    # Member m alone equals member m of the batch: the members share draws
    # and nothing else.
    one = psim.simulate_terminal_with_score(
        SVJParams(**FIELDS).replace(v0=0.03, xi=0.6), SPOT, T, draws=draws)
    torch.testing.assert_close(got[0][1], one[0], rtol=2e-6, atol=0)
    torch.testing.assert_close(got[2][1], one[3], rtol=0, atol=0)


def _old_step_core(params, dt, sqrt_dt, log_s, v, z1, z2, u_jump, z_js):
    """The Euler step as it stood before the tensor leaves, line for line."""
    p = params
    v_pos = torch.clamp(v, min=0.0)
    sqrt_v = psim._safe_sqrt(v_pos)
    k = torch.exp(psim._f32(p.mu_j + 0.5 * p.sigma_j**2, v.device)) - 1.0
    drift_comp = (p.r - p.q) - p.lambda_j * k
    dw1 = z1 * sqrt_dt
    rho_perp = float(np.sqrt(np.float32(1.0 - p.rho * p.rho)))
    dw2 = p.rho * dw1 + rho_perp * z2 * sqrt_dt
    jump = torch.where(u_jump < p.lambda_j * dt, p.mu_j + p.sigma_j * z_js,
                       torch.zeros_like(z_js))
    log_s = log_s + (drift_comp - 0.5 * v_pos) * dt + sqrt_v * dw1 + jump
    v = v_pos + p.kappa * (p.theta - v_pos) * dt + p.xi * sqrt_v * dw2
    v = torch.clamp(v, min=0.0)
    return log_s, v


def test_float_leaf_twins_keep_their_bits(monkeypatch):
    """Float leaves take the float32-rounded numpy arithmetic they took
    before the tensor path existed: every twin gives the same bits with
    the old step and the old variance start put back."""
    p = SVJParams(**FIELDS)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    z = torch.randn((4, 9, 300), generator=gen())
    u = torch.rand((9, 300), generator=gen())

    def run():
        return [
            psim.simulate_terminal(p, SPOT, T, gen(), 300, 9, companion=True,
                                   device="cpu"),
            psim.simulate_terminal_from_draws(p, SPOT, T, z[0], z[1], u,
                                              z[2], companion=True,
                                              steps_major=True),
            (psim.simulate_paths_recorded(p, SPOT, T, gen(), 300, 9,
                                          device="cpu"),),
            psim.simulate_terminal_qe(p, SPOT, T, gen(), 300, 9,
                                      companion=True, device="cpu"),
            psim.simulate_terminal_tilted(p, SPOT, T, gen(), 0.3, 300, 9,
                                          companion=True, device="cpu"),
        ]

    new = run()
    monkeypatch.setattr(psim, "_svj_step_core", _old_step_core)
    monkeypatch.setattr(psim, "_v0_like", lambda v0, like: torch.full_like(
        like, float(np.float32(v0))))
    old = run()
    for a, b in zip(new, old):
        for x, y in zip(a, b):
            if x is not None:
                torch.testing.assert_close(x, y, rtol=0, atol=0)


# ── programs ─────────────────────────────────────────────────────────────────
@pytest.fixture(scope="module")
def params():
    return JSVJParams(**FIELDS), SVJParams(**FIELDS)


def test_price_and_greeks_matches_jax(replayed, params):
    key, draws = replayed
    ref = jg.price_and_greeks(params[0], SPOT, STRIKE, T, key, **KW)
    got = pg.price_and_greeks(params[1], SPOT, STRIKE, T, draws, **KW)
    for name, a, b in zip(("price", "d_spot", "d_T"), ref[:3], got[:3]):
        np.testing.assert_allclose(_np(b), float(a), **TOL, err_msg=name)
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(got[3], f)),
                                   float(getattr(ref[3], f)), **TOL,
                                   err_msg=f)


def test_member_programs_match_jax(replayed, params):
    key, draws = replayed
    spots, v0s = [101.0, 99.0, 100.0, 100.0], [0.04, 0.04, 0.0441, 0.0361]
    ref = jg._ad_delta_vega_batch(params[0], spots, v0s, STRIKE, T, key, **KW)
    got = pg._ad_delta_vega_batch(params[1], spots, v0s, STRIKE, T, draws,
                                  **KW)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)
    Ts = [0.5, 0.5, 0.52, 0.48]
    ref = jg._ad_dsdv_T_batch(params[0], spots, v0s, Ts, STRIKE, key, **KW)
    got = pg._ad_delta_vega_batch(params[1], spots, v0s, STRIKE, Ts, draws,
                                  **KW)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(_np(b), np.asarray(a), **TOL)
    ref = jg._ad_delta_batch(params[0], spots[:2], STRIKE, T, key, **KW)
    got = pg._ad_delta_batch(params[1], spots[:2], STRIKE, T, draws, **KW)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_member_chunks_keep_the_values(replayed, params, monkeypatch):
    """Points split into several member batches give what one batch gives."""
    _, draws = replayed
    args = (params[1], [101.0, 99.0, 100.0], [0.04, 0.05, 0.03], STRIKE,
            [0.5, 0.52, 0.48], draws)
    whole = pg._ad_delta_vega_batch(*args, **KW)
    monkeypatch.setattr(pg, "MEMBER_ELEMENTS", 2 * N)
    assert len(pg._member_chunks(3, N)) == 3
    split = pg._ad_delta_vega_batch(*args, **KW)
    for a, b in zip(whole, split):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0)


def test_lambda_lr_estimate_matches_jax(replayed, params):
    key, draws = replayed
    ref = jg.lambda_lr_estimate(params[0], SPOT, STRIKE, T, key, **KW)
    got = pg.lambda_lr_estimate(params[1], SPOT, STRIKE, T, draws, **KW)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(_np(b), float(a), **TOL)


@pytest.mark.parametrize("is_call", [True, False])
def test_all_greeks_device_matches_jax(replayed, params, is_call):
    key, draws = replayed
    kw = dict(KW, is_call=is_call)
    ref = jg._all_greeks_device(params[0], SPOT, STRIKE, T, key,
                                with_lr=True, **kw)
    got = pg._all_greeks_device(params[1], SPOT, STRIKE, T, draws,
                                with_lr=True, **kw)
    assert got.keys() == ref.keys()
    for k in ref:
        a = (np.array([float(getattr(ref[k], f)) for f in FIELDS])
             if k == "d_params" else np.asarray(ref[k]))
        np.testing.assert_allclose(_np(got[k]), a, **TOL, err_msg=k)


# ── engine ───────────────────────────────────────────────────────────────────
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


def _engines(fields, num_paths=N, num_steps=2 * STEPS, seed=7):
    """The JAX engine and the port's with its draws swapped for the JAX
    engine's replayed ones (T = 0.5 → 16 steps)."""
    jeng = jg.GreeksEngine(JSVJParams(**fields), num_paths=num_paths,
                           num_steps=num_steps, seed=seed)
    peng = pg.GreeksEngine(SVJParams(**fields), num_paths=num_paths,
                           num_steps=num_steps, seed=seed, device="cpu")
    _, draws = _replayed(seed, num_paths, peng._steps(T))
    peng._draws = lambda steps: draws
    return jeng, peng


def test_engine_all_greeks_matches_jax():
    jeng, peng = _engines(FIELDS)
    ref = _flat(jeng.all_greeks(SPOT, STRIKE, T))
    got = _flat(peng.all_greeks(SPOT, STRIKE, T))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)
    # Each block alone (engines without the fused prefetch) runs its own
    # program: the same values, but for λ's LR estimate, which alone runs
    # one branch (`lambda_lr_estimate`), as the JAX engine's does.
    jsolo, solo = _engines(FIELDS)
    for name in ("delta", "vega", "gamma", "theta", "rho",
                 "jump_sensitivities", "model_sensitivities"):
        a = getattr(peng, name)(SPOT, STRIKE, T)
        b = getattr(solo, name)(SPOT, STRIKE, T)
        ref = getattr(jsolo, name)(SPOT, STRIKE, T)
        assert b.keys() == ref.keys() == a.keys(), name
        for k in a:
            np.testing.assert_allclose(b[k], ref[k], **TOL, err_msg=k)
            if k not in ("lambda_j_lr", "lambda_j_lr_se"):
                np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)


def test_engine_extra_blocks_match_jax():
    jeng, peng = _engines(FIELDS)
    for name in ("cross_greeks", "second_order_greeks",
                 "min_variance_delta"):
        ref = getattr(jeng, name)(SPOT, STRIKE, T)
        got = getattr(peng, name)(SPOT, STRIKE, T)
        assert got.keys() == ref.keys(), name
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], **TOL,
                                       err_msg=f"{name}.{k}")


def test_chain_equals_per_contract_and_the_memo_is_bounded(monkeypatch):
    _, peng = _engines(FIELDS)
    _, solo = _engines(FIELDS)
    chain = peng.all_greeks_chain(SPOT, [95.0, 105.0], T)
    for row in chain:
        one = solo.all_greeks(SPOT, row["strike"], T)
        assert _flat(row) == {"strike": row["strike"], **_flat(one)}
    monkeypatch.setattr(pg, "MEMO_MAX", 8)
    for k in (90.0, 95.0, 100.0):
        peng.all_greeks(SPOT, k, T)
        assert len(peng._memo) <= 8


def test_state_key_holds_every_field():
    eng = pg.GreeksEngine(SVJParams(), num_paths=1024, device="cpu")
    base = eng._state_key(eng.params)
    for f in dataclasses.fields(SVJParams):
        bumped = eng.params.replace(**{f.name: getattr(eng.params, f.name)
                                       + 0.01})
        assert eng._state_key(bumped) != base, f.name
    for attr, value in (("num_paths", 2048), ("num_steps", 64), ("seed", 1)):
        other = pg.GreeksEngine(SVJParams(), **{"num_paths": 1024,
                                                attr: value}, device="cpu")
        assert other._state_key(other.params) != base, attr


def test_gbm_degenerate_greeks_within_5_se_of_bs():
    """λ = 0, ξ = 0: the raw pathwise estimators (control variate off) of
    delta, vega, gamma, theta and rho, averaged over 16 seeds, lie within
    5 standard errors (the seeds' spread / 4) of `bs_all_greeks`; the
    engine's control-variate Greeks at one seed lie within the same 5 se."""
    sigma, r, q, T_ = 0.2, 0.05, 0.01, 0.5
    p = gbm_params(sigma, r=r, q=q)
    n, steps, b = 4096, 16, 0.01
    kw = dict(num_paths=n, num_steps=steps, is_call=True,
              control_variate=False)
    rows = []
    for seed in range(16):
        gen = torch.Generator().manual_seed(1000 + seed)
        draws = (torch.randn((steps, 3, n), generator=gen),
                 torch.rand((steps, n), generator=gen))
        _, d_s, d_T, d_p = pg.price_and_greeks(p, SPOT, STRIKE, T_, draws,
                                               **kw)
        d_up = pg.price_and_greeks(p, SPOT * (1 + b), STRIKE, T_, draws,
                                   **kw)[1]
        d_dn = pg.price_and_greeks(p, SPOT * (1 - b), STRIKE, T_, draws,
                                   **kw)[1]
        rows.append([float(d_s), float(d_p.v0) * 2 * sigma,
                     float(d_up - d_dn) / (2 * SPOT * b), -float(d_T),
                     float(d_p.r)])
    rows = np.asarray(rows)
    mean, se = rows.mean(0), rows.std(0, ddof=1) / 4.0
    ref = pbs.bs_all_greeks(SPOT, STRIKE, T_, r, q, sigma, True)
    bs = np.array([float(ref[k]) for k in ("delta", "vega", "gamma",
                                           "theta", "rho")])
    assert (se > 0).all()
    assert (np.abs(mean - bs) < 5 * se).all(), (mean, bs, se)

    eng = pg.GreeksEngine(p, num_paths=n, num_steps=2 * steps, seed=1,
                          device="cpu")
    g = eng.all_greeks(SPOT, STRIKE, T_)
    cv = np.array([g["delta"]["pathwise"], g["vega"]["vega_per_vol_point"],
                   g["gamma"]["gamma"], g["theta"]["theta_daily"],
                   g["rho"]["rho"]])
    assert (np.abs(cv - bs) < 5 * se).all(), (cv, bs, se)
