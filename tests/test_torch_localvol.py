"""The port's Dupire local-vol engine (`mcos_tpu_torch/engine/localvol.py`)
against the JAX package's on CPU.

Tolerances:
- the host float64 surface build (the Dupire formula, `from_iv_points`,
  `from_ssvi`, `flat`, the point lookup, the step tables): rtol 1e-9
  (`from_ssvi` samples the SSVI surface's float32 vols in both packages,
  whose last-ulp differences the Dupire formula's second differences
  amplify, so there rtol 1e-4);
- the step loop on the JAX key's normals replayed (fold_in(key, t) →
  normal (n,)): terminal spots rtol 5e-5 over 32 float32 steps;
- prices on each package's own stream by law: a flat surface within 3 se
  of Black-Scholes, the port within 4 combined se of the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mcos_tpu.engine.localvol as jlv
import mcos_tpu.engine.ssvi as jssvi
import mcos_tpu_torch.engine.localvol as plv
import mcos_tpu_torch.engine.ssvi as pssvi
from mcos_tpu_torch.ops.bs import bs_price

torch.set_num_threads(1)

SPOT, R, Q = 100.0, 0.05, 0.01
STRIKES = np.linspace(70.0, 130.0, 13)
MATS = np.array([0.25, 0.5, 1.0])
N = 8192


def _iv():
    k = np.log(STRIKES / SPOT)
    return 0.2 - 0.15 * k[None, :] + 0.2 * k[None, :] ** 2 \
        + 0.01 * np.sqrt(MATS)[:, None]


def _close_surface(a, b, rtol=1e-9):
    for f in ("t_grid", "y_grid", "local_var"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=rtol,
                                   atol=0, err_msg=f)
    assert (a.r, a.q) == (b.r, b.q)


def test_dupire_local_variance_matches_jax():
    rng = np.random.default_rng(0)
    shape = (5, 21)
    y = np.linspace(-1.0, 1.0, 21)[None, :]
    w = rng.uniform(-0.01, 0.2, shape)
    wy, wyy = rng.normal(0, 0.2, shape), rng.normal(0, 2.0, shape)
    wt = rng.uniform(-0.01, 0.2, shape)
    np.testing.assert_allclose(
        plv.dupire_local_variance(y, w, wy, wyy, wt),
        jlv.dupire_local_variance(y, w, wy, wyy, wt), rtol=1e-9, atol=0)


@pytest.mark.parametrize("kw", [{}, {"n_y": 41, "n_t": 17, "y_span": 0.6}])
def test_from_iv_points_matches_jax(kw):
    iv = _iv()
    iv[1, 2] = np.nan
    a = plv.LocalVolSurface.from_iv_points(SPOT, STRIKES, MATS, iv, r=R, q=Q,
                                           **kw)
    b = jlv.LocalVolSurface.from_iv_points(SPOT, STRIKES, MATS, iv, r=R, q=Q,
                                           **kw)
    _close_surface(a, b)
    for t, y in ((0.05, -0.3), (0.4, 0.0), (0.9, 0.25), (2.0, 5.0)):
        assert a.local_vol(t, y) == pytest.approx(b.local_vol(t, y),
                                                  rel=1e-9)
    for T, steps in ((0.5, 16), (1.3, 37)):
        ra, ta = a.step_tables(T, steps)
        rb, tb = b.step_tables(T, steps)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ta, tb)
        assert ra.dtype == np.float32 and ta.dtype == np.float32


def test_surface_refusals_match_jax():
    for args in ((STRIKES, MATS, _iv()[:, :5]),
                 (STRIKES, MATS[:1], _iv()[:1]),
                 (STRIKES, MATS, np.full((3, 13), np.nan))):
        with pytest.raises(ValueError) as got:
            plv.LocalVolSurface.from_iv_points(SPOT, *args)
        with pytest.raises(ValueError) as ref:
            jlv.LocalVolSurface.from_iv_points(SPOT, *args)
        assert str(got.value) == str(ref.value)


def test_flat_and_from_ssvi_match_jax():
    _close_surface(plv.LocalVolSurface.flat(0.3, R, Q, 1.5),
                   jlv.LocalVolSurface.flat(0.3, R, Q, 1.5))
    shape = dict(rho=-0.4, eta=1.1, gamma=0.45)
    theta = np.array([0.012, 0.022, 0.041])
    a = plv.LocalVolSurface.from_ssvi(pssvi.SSVISurface(MATS, theta, **shape),
                                      SPOT, R, Q, n_y=51, n_t=21)
    b = jlv.LocalVolSurface.from_ssvi(jssvi.SSVISurface(MATS, theta, **shape),
                                      SPOT, R, Q, n_y=51, n_t=21)
    _close_surface(a, b, rtol=1e-4)


def _replayed_normals(seed, n, steps):
    key = jax.random.key(seed)
    z = jax.vmap(lambda t: jax.random.normal(jax.random.fold_in(key, t), (n,),
                                             jnp.float32))(jnp.arange(steps))
    return torch.from_numpy(np.array(z))


@pytest.mark.parametrize("antithetic,n_y", [(True, 101), (False, 9)])
def test_step_loop_matches_jax_on_replayed_normals(antithetic, n_y):
    surf = plv.LocalVolSurface.from_iv_points(SPOT, STRIKES, MATS, _iv(),
                                              r=R, q=Q, n_y=n_y)
    T, steps, seed = 0.7, 32, 3
    rows, t_mid = surf.step_tables(T, steps)
    y0, dy = float(surf.y_grid[0]), float(surf.y_grid[1] - surf.y_grid[0])
    got = plv.simulate_terminal_localvol(
        rows, t_mid, y0, dy, SPOT, R, Q, T, antithetic=antithetic,
        normals=_replayed_normals(seed, N, steps)).numpy()
    ref = np.asarray(jlv.simulate_terminal_localvol(
        jnp.asarray(rows), jnp.asarray(t_mid), y0, dy, SPOT, R, Q, T,
        jax.random.key(seed), num_paths=N, num_steps=steps,
        antithetic=antithetic))
    assert got.shape == ref.shape == ((2 if antithetic else 1), N)
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=0)


def test_index_clamp_at_the_grid_top():
    # Paths far above the grid: pos clips to n_y − 1, and the integer
    # clamp keeps i + 1 inside the row (a float clip would gather past it).
    rows = np.tile(np.linspace(0.01, 0.09, 101, dtype=np.float32), (4, 1))
    rows[:, -1] = 0.25
    z = torch.full((4, 16), 40.0)
    s = plv.simulate_terminal_localvol(rows, np.full(4, 0.1, np.float32),
                                       -0.5, 0.01, SPOT, 0.0, 0.0, 0.4,
                                       normals=z)
    assert torch.isfinite(s).all()
    v = plv._local_var_lookup(torch.from_numpy(rows[0]),
                             torch.tensor([-9.0, 0.5, 9.0]),
                             torch.tensor(-0.5), torch.tensor(0.01))
    np.testing.assert_allclose(v.numpy(), [0.01, 0.25, 0.25], rtol=1e-6)


def test_flat_surface_prices_black_scholes():
    surf = plv.LocalVolSurface.flat(0.25, R, Q)
    eng = plv.LocalVolEngine(surf, num_paths=N, num_steps=32, device="cpu")
    strikes = [85.0, 100.0, 115.0]
    for is_call in (True, False):
        rows = eng.price_batch(SPOT, strikes, 0.5, is_call)
        bs = bs_price(SPOT, np.array(strikes), 0.5, R, Q, 0.25,
                      is_call).numpy()
        for row, ref in zip(rows, bs):
            assert abs(row["price"] - ref) < 3 * row["std_error"], (row, ref)


def test_engine_matches_jax_by_law():
    surf_p = plv.LocalVolSurface.from_iv_points(SPOT, STRIKES, MATS, _iv(),
                                                r=R, q=Q)
    surf_j = jlv.LocalVolSurface.from_iv_points(SPOT, STRIKES, MATS, _iv(),
                                                r=R, q=Q)
    kw = dict(num_paths=N, num_steps=32, seed=5)
    eng_p = plv.LocalVolEngine(surf_p, device="cpu", **kw)
    eng_j = jlv.LocalVolEngine(surf_j, **kw)
    strikes = [80.0, 95.0, 100.0, 110.0, 125.0]
    got = eng_p.price_batch(SPOT, strikes, 0.75, False)
    ref = eng_j.price_batch(SPOT, strikes, 0.75, False)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys() and a["strike"] == b["strike"]
        assert abs(a["price"] - b["price"]) < 4 * np.hypot(a["std_error"],
                                                           b["std_error"])
    assert eng_p.price(SPOT, 100.0, 0.75).keys() == \
        eng_j.price(SPOT, 100.0, 0.75).keys()
    # The round trip: the surface reprices its own input vols.
    err = eng_p.implied_surface_error(SPOT, STRIKES[3:10], 0.5,
                                      _iv()[1, 3:10])
    assert err < 0.01, err


def test_engine_refuses_a_mesh():
    """The mesh, once refused, is slice N1's: a one-shard mesh prices the
    unsharded path set."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    kw = dict(num_paths=1000, num_steps=32, device="cpu")
    surf = plv.LocalVolSurface.flat(0.2)
    ref = plv.LocalVolEngine(surf, **kw).price(100.0, 100.0, 0.5)
    got = plv.LocalVolEngine(surf, mesh=make_mesh(["cpu"]),
                             **kw).price(100.0, 100.0, 0.5)
    for k in ("price", "std_error"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
