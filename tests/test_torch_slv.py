"""The port's particle-method SLV (`mcos_tpu_torch/engine/slv.py`) against
the JAX package's on CPU.

Tolerances:
- the step loop on the JAX key's normals replayed (fold_in(key, t) →
  normal (2, n)), every mode (terminal, snapshot, extremes, sheet): at 4
  steps path by path, rtol 2e-5 (float32 rounding). A path's bin is the
  integer part of its log-moneyness over the bin width, so once a path
  within rounding of a bin edge lands in the neighbouring bin in one
  package, that bin's E[v | S] moves for every path in it and the clouds
  part (at 24 steps ~40 % of paths differ by more than 1e-4, by up to
  4 %). The particle method is chaotic in that sense; what it promises is
  the law, so at 24 steps the pooled payoff means (a call and a put at
  the money, the mean spot, each step's under `emit_sheet`) are held to
  2e-4 relative. The bin sums are
  `torch.bincount`'s; on a CUDA device they are atomics in no fixed
  order, which the card's own check (`chip_smoke.py`) holds at 1 se.
- prices on each package's own stream by law: within 4 combined se of
  the JAX package; ξ → 0 within 3 combined se of the local-vol engine on
  the same surface; a flat surface at ξ > 0 within the JAX package's own
  pin of Black-Scholes, 4 se + 1 % (tests/test_slv.py: the particle
  binning's remainder), at 32 768 paths and strikes 0.85-1.05 × spot. At
  115 both packages sit 3-4.5 se (3-8 %) below Black-Scholes with clouds
  of 8 192-32 768 paths: the small-cloud bias of E[v | S].
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcos_tpu.engine.localvol as jlv
import mcos_tpu.engine.slv as jslv
import mcos_tpu.models.params as jparams
import mcos_tpu_torch.engine.localvol as plv
import mcos_tpu_torch.engine.slv as pslv
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.bs import bs_price

torch.set_num_threads(1)

SPOT, R, Q = 100.0, 0.05, 0.01
STRIKES = np.linspace(70.0, 130.0, 13)
MATS = np.array([0.25, 0.5, 1.0])
HESTON = dict(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04,
              lambda_j=0.0, r=R, q=Q)
N = 8192


def _iv():
    k = np.log(STRIKES / SPOT)
    return 0.2 - 0.15 * k[None, :] + 0.2 * k[None, :] ** 2 \
        + 0.01 * np.sqrt(MATS)[:, None]


def _surfaces(iv=None):
    iv = _iv() if iv is None else iv
    return (plv.LocalVolSurface.from_iv_points(SPOT, STRIKES, MATS, iv,
                                               r=R, q=Q),
            jlv.LocalVolSurface.from_iv_points(SPOT, STRIKES, MATS, iv,
                                               r=R, q=Q))


@pytest.mark.parametrize("steps", [4, 24])
@pytest.mark.parametrize("mode", [{}, {"k_snapshot": 2},
                                  {"track_extremes": True},
                                  {"emit_sheet": True}])
def test_step_loop_matches_jax_on_replayed_normals(mode, steps):
    surf, _ = _surfaces()
    T, seed = 0.6, 7
    rows, t_mid = surf.step_tables(T, steps)
    y0, dy = float(surf.y_grid[0]), float(surf.y_grid[1] - surf.y_grid[0])
    key = jax.random.key(seed)
    z = jax.vmap(lambda t: jax.random.normal(jax.random.fold_in(key, t),
                                             (2, N), jnp.float32))(
        jnp.arange(steps))
    heston = SVJParams(**HESTON).replace(sigma_j=1e-4)
    got = pslv.slv_terminal(heston, rows, t_mid, y0, dy, SPOT, T,
                            normals=torch.from_numpy(np.array(z)),
                            **mode).numpy()
    ref = np.asarray(jslv.slv_terminal(
        jparams.SVJParams(**heston.to_numpy()), jnp.asarray(rows),
        jnp.asarray(t_mid), y0, dy, SPOT, T, key, num_paths=N,
        num_steps=steps, **mode))
    assert got.shape == ref.shape
    if mode.get("emit_sheet"):
        got, ref = SPOT * np.exp(got), SPOT * np.exp(ref)
    if steps == 4:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=0)
        return
    for f in (lambda s: s, lambda s: np.maximum(s - SPOT, 0.0),
              lambda s: np.maximum(SPOT - s, 0.0)):
        np.testing.assert_allclose(f(got).mean(axis=-1),
                                   f(ref).mean(axis=-1), rtol=2e-4)


@pytest.fixture(scope="module")
def engines():
    surf_p, surf_j = _surfaces()
    kw = dict(num_paths=N, num_steps=32, seed=11)
    return (pslv.SLVEngine(surf_p, SVJParams(**HESTON), device="cpu", **kw),
            jslv.SLVEngine(surf_j, jparams.SVJParams(**HESTON), **kw))


def _within(a, b, se_a, se_b, k=4.0):
    assert abs(a - b) <= k * np.hypot(se_a, se_b), (a, b, se_a, se_b)


def test_price_matches_jax_by_law(engines):
    eng_p, eng_j = engines
    strikes = [85.0, 100.0, 115.0]
    got = eng_p.price(SPOT, strikes, 0.5)
    ref = eng_j.price(SPOT, strikes, 0.5)
    assert got.keys() == ref.keys()
    for a, b, sa, sb in zip(got["price"], ref["price"], got["std_error"],
                            ref["std_error"]):
        _within(a, b, sa, sb)
    one = eng_p.price(SPOT, 100.0, 0.5, is_call=False)
    assert isinstance(one["price"], float)


@pytest.mark.parametrize("kind", ["barrier_out", "barrier_in", "fwd_start"])
def test_path_products_match_jax_by_law(engines, kind):
    eng_p, eng_j = engines
    if kind == "fwd_start":
        got = eng_p.price_forward_start(SPOT, 0.2, 0.6, k=1.0)
        ref = eng_j.price_forward_start(SPOT, 0.2, 0.6, k=1.0)
        assert got["t1_effective"] == ref["t1_effective"]
    else:
        knock = kind.split("_")[1]
        got = eng_p.price_barrier(SPOT, 100.0, 0.5, 120.0, knock=knock)
        ref = eng_j.price_barrier(SPOT, 100.0, 0.5, 120.0, knock=knock)
        assert abs(got["hit_fraction"] - ref["hit_fraction"]) < 0.03
    assert got.keys() == ref.keys()
    _within(got["price"], ref["price"], got["std_error"], ref["std_error"])


def test_greeks_and_hedge_match_jax_by_law(engines):
    eng_p, eng_j = engines
    got = eng_p.greeks(SPOT, 100.0, 0.5)
    ref = eng_j.greeks(SPOT, 100.0, 0.5)
    assert got.keys() == ref.keys()
    _within(got["price"], ref["price"], got["std_error"], ref["std_error"])
    assert abs(got["delta"] - ref["delta"]) < 0.05
    hp = eng_p.hedging_backtest(SPOT, 100.0, 0.25, num_days=16)
    hj = eng_j.hedging_backtest(SPOT, 100.0, 0.25, num_days=16)
    assert hp.keys() == hj.keys()
    assert hp["pnl_percentiles"].keys() == hj["pnl_percentiles"].keys()
    n = 2 * N
    _within(hp["mean_pnl"], hj["mean_pnl"], hp["std_pnl"] / np.sqrt(n),
            hj["std_pnl"] / np.sqrt(n))
    assert abs(hp["std_pnl"] / hj["std_pnl"] - 1) < 0.1


def test_flat_surface_prices_black_scholes():
    flat = plv.LocalVolSurface.flat(0.25, R, Q)
    eng = pslv.SLVEngine(flat, SVJParams(**HESTON), num_paths=4 * N,
                         num_steps=32, device="cpu")
    strikes = [85.0, 95.0, 100.0, 105.0]
    res = eng.price(SPOT, strikes, 0.5)
    bs = bs_price(SPOT, np.array(strikes), 0.5, R, Q, 0.25).numpy()
    for p, se, ref in zip(res["price"], res["std_error"], bs):
        assert abs(p - ref) < 4 * se + 0.01 * ref, (p, ref, se)


def test_vanishing_xi_is_local_vol():
    surf, _ = _surfaces()
    slv = pslv.SLVEngine(surf, SVJParams(**dict(HESTON, xi=1e-4)),
                         num_paths=N, num_steps=32, device="cpu")
    lv = plv.LocalVolEngine(surf, num_paths=N, num_steps=64, device="cpu")
    strikes = [85.0, 100.0, 115.0]
    res = slv.price(SPOT, strikes, 0.5)
    for p, se, row in zip(res["price"], res["std_error"],
                          lv.price_batch(SPOT, strikes, 0.5)):
        _within(p, row["price"], se, row["std_error"], k=3.0)
