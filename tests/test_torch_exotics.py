"""The port's exotics ops and engine core against `mcos_tpu` on the same
inputs: the survival increments, the path-statistics twin on the JAX twin's
own draws, every payoff, the float32 closed forms, the payoff/control
algebra on one shared stats dict, and the autograd Greeks against
`jax.grad` on the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import exotics as jeng
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.ops import exotics as jox
from mcos_tpu_torch.engine import exotics as peng
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import exotics as pox

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=1.5, mu_j=-0.05, sigma_j=0.1)
_SPOT, _T, _N, _STEPS, _SEED = 100.0, 0.5, 4096, 32, 11
_LOG_B, _LOG_L = float(np.log(1.08)), float(np.log(0.92))

# The four variants of chip_smoke.py's K6 phase, plus a barrier below.
_VARIANTS = {
    "no_bridge": dict(),
    "up": dict(bridge=True, bridge_up=True, bridge_log_b=_LOG_B),
    "down": dict(bridge=True, bridge_up=False, bridge_log_b=_LOG_L),
    "corridor": dict(bridge=True, corridor=True, bridge_log_b=_LOG_B,
                     bridge_log_l=_LOG_L),
    "corridor_window": dict(bridge=True, corridor=True, bridge_log_b=_LOG_B,
                            bridge_log_l=_LOG_L, window=(5, 20),
                            companion=False),
}


def _jax_draws(seed, steps, n):
    """The draws of `mcos_tpu.ops.exotics.simulate_path_stats` for
    jax.random.key(seed): per step fold_in, split, normal (3, n), uniform."""
    key = jax.random.key(seed)
    zs, us = [], []
    for t in range(steps):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        zs.append(np.asarray(jax.random.normal(k_norm, (3, n), jnp.float32)))
        us.append(np.asarray(jax.random.uniform(k_unif, (n,), jnp.float32)))
    return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(us))


@pytest.fixture(scope="module")
def draws():
    return _jax_draws(_SEED, _STEPS, _N)


def _t(x):
    return torch.from_numpy(np.array(x))


# ── survival increments ─────────────────────────────────────────────────────
def _endpoints(seed):
    rng = np.random.default_rng(seed)
    x_old = rng.uniform(-0.12, 0.12, 4000).astype(np.float32)
    x_new = (x_old + rng.normal(0, 0.03, 4000)).astype(np.float32)
    var = rng.uniform(0.0, 0.2, 4000).astype(np.float32)
    # endpoints on a barrier and beyond it, on both sides
    x_old[:4] = [_LOG_B, _LOG_L, 0.2, -0.2]
    x_new[4:8] = [_LOG_B, _LOG_L, 0.2, -0.2]
    return x_old, x_new, var


@pytest.mark.parametrize("n_images", [1, 2, 3])
def test_corridor_increment_matches_jax(n_images):
    x_old, x_new, var = _endpoints(0)
    dt = np.float32(0.5 / 32)
    ref = np.asarray(jox.corridor_surv_increment(
        jnp.asarray(x_old), jnp.asarray(x_new), jnp.asarray(var), dt,
        jnp.float32(_LOG_L), jnp.float32(_LOG_B), n_images=n_images))
    got = pox.corridor_surv_increment(
        _t(x_old), _t(x_new), _t(var), torch.tensor(dt),
        torch.tensor(_LOG_L), torch.tensor(_LOG_B), n_images=n_images).numpy()
    dead = np.isneginf(ref)
    assert dead[:8].all() and 8 < dead.sum() < dead.size
    np.testing.assert_array_equal(np.isneginf(got), dead)
    np.testing.assert_allclose(got[~dead], ref[~dead], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bridge_up", [True, False])
def test_single_increment_is_the_one_sided_corridor(bridge_up):
    """The JAX single-barrier increment is a closure of its twin (pinned
    below through the twin); here against the corridor series with the
    other barrier 15 step-stdevs away, where its images vanish. The
    corridor measures from that far barrier, so its distances to the near
    one carry the rounding of numbers near 1: rtol 2e-4, atol 5e-6."""
    x_old, x_new, var = _endpoints(1)
    var = np.maximum(var, np.float32(0.01))
    dt = torch.tensor(np.float32(0.5 / 32))
    log_b = _LOG_B if bridge_up else _LOG_L
    got = pox.single_surv_increment(_t(x_old), _t(x_new), _t(var), dt,
                                    torch.tensor(log_b), bridge_up).numpy()
    far = (-1.0, log_b) if bridge_up else (log_b, 1.0)
    ref = np.asarray(jox.corridor_surv_increment(
        jnp.asarray(x_old), jnp.asarray(x_new), jnp.asarray(var),
        jnp.float32(0.5 / 32), jnp.float32(far[0]), jnp.float32(far[1])))
    dead = np.isneginf(ref)
    assert dead.any() and not dead.all()
    np.testing.assert_array_equal(np.isneginf(got), dead)
    # the corridor clips P_surv at 1e-7, the single barrier at 2^-23
    deep = ref < -15.0
    np.testing.assert_allclose(got[~dead & ~deep], ref[~dead & ~deep],
                               rtol=2e-4, atol=5e-6)


# ── the twin on the JAX twin's draws ────────────────────────────────────────
@pytest.mark.parametrize(
    "name,antithetic",
    [(name, True) for name in _VARIANTS] + [("corridor", False)])
def test_twin_matches_jax_twin_on_same_draws(draws, name, antithetic):
    """Every output, rtol 1e-5 (float32, same operations; XLA contracts
    some multiply-adds). log_surv: atol 1e-4 on the finite entries, beside
    rtol 2e-4 for the deep ones (an endpoint close to the barrier makes
    log(1 - p) ill-conditioned: a weight of e^-10 moves by 1e-3 in its log
    for an ulp of the distance), the weights themselves to atol 1e-5, and
    the dead/alive state equal on all paths but at most 2 (an endpoint
    within an ulp of the barrier)."""
    kw = dict(dict(companion=True), **_VARIANTS[name])
    ref = jox.simulate_path_stats(
        JSVJParams(**_FIELDS), _SPOT, _T, jax.random.key(_SEED),
        num_paths=_N, num_steps=_STEPS, antithetic=antithetic, **kw)
    got = pox.simulate_path_stats(
        SVJParams(**_FIELDS), _SPOT, _T, None, _N, _STEPS,
        antithetic=antithetic, draws=draws, **kw)
    assert set(got) == set(ref)
    for key, r in ref.items():
        r, g = np.asarray(r), got[key].numpy()
        assert g.shape == r.shape == (2 if antithetic else 1, _N), key
        if key.endswith("log_surv"):
            dead_r, dead_g = np.isneginf(r), np.isneginf(g)
            assert (dead_r != dead_g).sum() <= 2, key
            assert 0 < dead_r.sum() < dead_r.size, key
            live = ~(dead_r | dead_g)
            np.testing.assert_allclose(g[live], r[live], rtol=2e-4,
                                       atol=1e-4, err_msg=key)
            np.testing.assert_allclose(np.exp(g[live]), np.exp(r[live]),
                                       rtol=0, atol=1e-5, err_msg=key)
        elif key == "v_final":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=key)


def test_twin_window_gates_steps(draws):
    kw = dict(bridge=True, bridge_up=True, bridge_log_b=_LOG_B, draws=draws,
              companion=False)
    p = SVJParams(**_FIELDS)
    full = pox.simulate_path_stats(p, _SPOT, _T, None, _N, _STEPS, **kw)
    same = pox.simulate_path_stats(p, _SPOT, _T, None, _N, _STEPS,
                                   window=(0, _STEPS), **kw)
    part = pox.simulate_path_stats(p, _SPOT, _T, None, _N, _STEPS,
                                   window=(8, 9), **kw)
    np.testing.assert_array_equal(same["log_surv"].numpy(),
                                  full["log_surv"].numpy())
    assert bool((part["log_surv"] >= full["log_surv"]).all())
    assert bool((part["log_surv"] > full["log_surv"]).any())
    with pytest.raises(ValueError):
        pox.simulate_path_stats(p, _SPOT, _T, None, _N, _STEPS + 1,
                                draws=draws)


def test_twin_generator_draws_are_reproducible():
    p = SVJParams(**_FIELDS)
    outs = []
    for _ in range(2):
        g = torch.Generator(device="cpu")
        g.manual_seed(3)
        outs.append(pox.simulate_path_stats(p, _SPOT, _T, g, 512, 8,
                                            device="cpu"))
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k].numpy(), outs[1][k].numpy())
    assert outs[0]["s_final"].shape == (2, 512)


# ── payoffs on one shared stats dict ────────────────────────────────────────
@pytest.fixture(scope="module")
def stats():
    """The JAX twin's corridor stats (every key), as jax and torch dicts."""
    ref = jox.simulate_path_stats(
        JSVJParams(**_FIELDS), _SPOT, _T, jax.random.key(_SEED),
        num_paths=_N, num_steps=_STEPS, companion=True,
        **_VARIANTS["corridor"])
    return ref, {k: _t(v) for k, v in ref.items()}


def _close(got, ref, rtol=1e-5, atol=5e-5):
    np.testing.assert_allclose(got.numpy().astype(np.float32),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("averaging", ["arithmetic", "geometric"])
@pytest.mark.parametrize("leg", ["", "g_"])
def test_asian_payoff(stats, is_call, averaging, leg):
    j, p = stats
    _close(pox.asian_payoff(p, 101.0, is_call, averaging, leg),
           jox.asian_payoff(j, 101.0, is_call, averaging, leg))


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("knock", ["out", "in"])
@pytest.mark.parametrize("direction,barrier", [("up", 108.0), ("down", 93.0)])
@pytest.mark.parametrize("rebate", [0.0, 2.5])
def test_barrier_payoff(stats, is_call, knock, direction, barrier, rebate):
    j, p = stats
    _close(pox.barrier_payoff(p, 100.0, barrier, is_call, knock, direction,
                              rebate),
           jox.barrier_payoff(j, 100.0, barrier, is_call, knock, direction,
                              rebate))


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("knock", ["out", "in"])
@pytest.mark.parametrize("rebate", [0.0, 2.5])
def test_double_barrier_payoff(stats, is_call, knock, rebate):
    j, p = stats
    _close(pox.double_barrier_payoff(p, 100.0, 93.0, 108.0, is_call, knock,
                                     rebate),
           jox.double_barrier_payoff(j, 100.0, 93.0, 108.0, is_call, knock,
                                     rebate))


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("knock", ["out", "in"])
@pytest.mark.parametrize("leg", ["", "g"])
@pytest.mark.parametrize("rebate", [0.0, 2.5])
def test_barrier_bridge_payoff(stats, is_call, knock, leg, rebate):
    j, p = stats
    _close(pox.barrier_bridge_payoff(p, 100.0, is_call, knock, leg, rebate),
           jox.barrier_bridge_payoff(j, 100.0, is_call, knock, leg, rebate))


def test_one_touch_bridge_payoff(stats):
    j, p = stats
    _close(pox.one_touch_bridge_payoff(p), jox.one_touch_bridge_payoff(j))


@pytest.mark.parametrize("is_call", [True, False])
@pytest.mark.parametrize("strike", [None, 102.0])
def test_lookback_payoff(stats, is_call, strike):
    j, p = stats
    _close(pox.lookback_payoff(p, is_call, strike),
           jox.lookback_payoff(j, is_call, strike), rtol=1e-5, atol=1e-4)


# ── float32 closed forms ────────────────────────────────────────────────────
@pytest.mark.parametrize("is_call", [True, False])
def test_geometric_asian_bs(is_call):
    for S, K, T, r, q, sig, n in [(100.0, 100.0, 0.5, 0.05, 0.01, 0.2, 32),
                                  (22500.0, 24000.0, 0.25, 0.065, 0.012,
                                   0.3, 63),
                                  (50.0, 40.0, 2.0, 0.0, 0.03, 0.5, 1)]:
        ref = float(jox.geometric_asian_bs(S, K, T, r, q, sig, n, is_call))
        got = float(pox.geometric_asian_bs(S, K, T, r, q, sig, n, is_call))
        assert got == pytest.approx(ref, rel=2e-5, abs=1e-5 * S)


@pytest.mark.parametrize("is_call", [True, False])
def test_lookback_float_bs(is_call):
    for S, T, r, q, sig in [(100.0, 0.5, 0.05, 0.01, 0.2),
                            (22500.0, 0.25, 0.065, 0.012, 0.2),
                            (50.0, 2.0, 0.01, 0.03, 0.5)]:
        ref = float(jox.lookback_float_bs(S, T, r, q, sig, is_call))
        got = float(pox.lookback_float_bs(S, T, r, q, sig, is_call))
        assert got == pytest.approx(ref, rel=5e-5)


def test_geometric_asian_bs_is_differentiable():
    s = torch.tensor(100.0, requires_grad=True)
    price = pox.geometric_asian_bs(s, 100.0, 0.5, 0.05, 0.01, 0.2, 32)
    (delta,) = torch.autograd.grad(price, s)
    ref = jax.grad(lambda x: jox.geometric_asian_bs(
        x, 100.0, 0.5, 0.05, 0.01, 0.2, 32))(jnp.float32(100.0))
    assert float(delta) == pytest.approx(float(ref), rel=1e-4)


# ── payoff/control algebra and the CV estimate ──────────────────────────────
_KINDS = [
    ("asian", dict(is_call=True)),
    ("asian", dict(is_call=False, averaging="geometric")),
    ("asian", dict(is_call=True, control_variate=False)),
    ("barrier", dict(is_call=True, knock="out", direction="up")),
    ("barrier", dict(is_call=False, knock="in", direction="down",
                     rebate=1.5)),
    ("barrier", dict(is_call=True, monitoring="bridge",
                     bridge_ctrl_exact=3.25)),
    ("barrier", dict(is_call=True, monitoring="bridge", knock="in",
                     rebate=2.0, control_variate=False)),
    ("barrier", dict(is_call=True, one_touch=True, knock="in")),
    ("barrier", dict(is_call=True, one_touch=True, knock="in",
                     monitoring="bridge")),
    ("double_barrier", dict(is_call=True, monitoring="bridge",
                            bridge_ctrl_exact=2.5)),
    ("double_barrier", dict(is_call=False, knock="in", rebate=1.0)),
    ("double_barrier", dict(is_call=True, one_touch=True,
                            monitoring="bridge", bridge_ctrl_exact=0.4)),
    ("double_barrier", dict(is_call=True, one_touch=True, knock="in",
                            monitoring="bridge", control_variate=False)),
    ("double_barrier", dict(is_call=True, one_touch=True)),
    ("lookback", dict(is_call=True, floating=True)),
    ("lookback", dict(is_call=False, floating=False)),
]


@pytest.mark.parametrize("kind,kw", _KINDS)
def test_payoff_and_control_matches_jax(stats, kind, kw):
    j, p = stats
    barrier = 93.0 if kw.get("direction") == "down" else 108.0
    kw = dict(kw, kind=kind, num_steps=_STEPS, barrier_lo=92.0)
    ref = jeng.exotic_payoff_and_control(
        j, JSVJParams(**_FIELDS), _SPOT, 101.0, _T, barrier, **kw)
    got = peng.exotic_payoff_and_control(
        p, SVJParams(**_FIELDS), _SPOT, 101.0, _T, barrier, **kw)
    assert [x is None for x in got] == [x is None for x in ref]
    for g, r in zip(got, ref):
        if r is not None:
            _close(g, r, rtol=1e-5, atol=1e-5)
    if ref[1] is not None:
        pay, ctrl = (np.asarray(x).mean(axis=0) for x in ref[:2])
        r_cv = jeng._cv_adjust(jnp.asarray(pay), jnp.asarray(ctrl), ref[2])
        g_cv = peng._cv_adjust(_t(pay), _t(ctrl), got[2])
        for g, r in zip(g_cv, r_cv):
            assert float(g) == pytest.approx(float(r), rel=2e-4, abs=1e-6)


def test_unknown_kind_raises(stats):
    with pytest.raises(ValueError):
        peng.exotic_payoff_and_control(
            stats[1], SVJParams(), _SPOT, 100.0, _T, 0.0, kind="cliquet",
            num_steps=_STEPS, is_call=True)


@pytest.mark.parametrize("window", [(0.05, 0.2), (0.0, 0.5), (0.249, 0.251),
                                    (0.49, 0.5)])
def test_snap_window(window):
    assert (peng._snap_window(0.5, 126, window)
            == jeng._snap_window(0.5, 126, window))
    with pytest.raises(ValueError):
        peng._snap_window(0.5, 126, (0.3, 0.2))


def test_variance_swap_fair_strike():
    for T in (0.25, 2.0):
        assert (peng.variance_swap_fair_strike(SVJParams(**_FIELDS), T)
                == jeng.variance_swap_fair_strike(JSVJParams(**_FIELDS), T))


# ── Greeks: torch.autograd through the twin against jax.grad ────────────────
@pytest.mark.parametrize("kind,kw", [
    ("asian", dict(is_call=True, averaging="arithmetic")),
    ("barrier", dict(is_call=True, knock="out", direction="up",
                     monitoring="bridge", control_variate=False)),
    ("double_barrier", dict(is_call=True, one_touch=True, knock="out",
                            monitoring="bridge", control_variate=False)),
])
def test_autograd_greeks_match_jax_grad(draws, kind, kw):
    """Same draws, same estimator: price, dP/dspot, dP/dv0 and dP/dr at
    rtol 1e-3 (float32 sums in another order)."""
    barrier = 112.0 if kind != "asian" else 0.0
    args = (_SPOT, 100.0 if kind != "double_barrier" else 0.0, _T)
    kw = dict(kw, kind=kind, num_paths=_N, num_steps=_STEPS)
    price, d_spot, d_params = jeng._exotic_value_and_greeks(
        JSVJParams(**_FIELDS), *args, jax.random.key(_SEED), barrier, 90.0,
        **kw)
    got = peng._exotic_value_and_greeks(
        SVJParams(**_FIELDS), *args, _SEED, barrier, 90.0, draws=draws,
        device="cpu", **kw)
    assert got[0] == pytest.approx(float(price), rel=1e-4)
    assert got[1] == pytest.approx(float(d_spot), rel=1e-3, abs=1e-6)
    assert got[2]["v0"] == pytest.approx(float(d_params.v0), rel=1e-3)
    assert got[2]["r"] == pytest.approx(float(d_params.r), rel=1e-3)
