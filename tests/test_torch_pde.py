"""`mcos_tpu_torch/engine/pde.py` against `mcos_tpu/engine/pde.py` on the
same grids and inputs.

Tolerance: the grids are float32 on both sides after 16 steps; the
reference solves each stage with LAPACK's pivoting tridiagonal `gtsv`, the
port multiplies by the same matrices' inverses, taken once. Grid values
agree to 1e-5 of the grid's largest value, prices to 1e-4 relative (1e-6
absolute); the host float64 jump tables are equal once cast to
float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.pde as jpde
import mcos_tpu_torch.engine.pde as ppde
from mcos_tpu.models.params import SVJParams as JSVJ
from mcos_tpu_torch.models.params import SVJParams

torch.set_num_threads(1)

N_X, N_V, N_T = 41, 21, 16


def _grid_close(got, ref, scale_tol=1e-5):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=scale_tol * np.nanmax(np.abs(ref)))


def _stars_close(got, ref):
    """The exercise edge: the same rows with (and without) an edge, the
    node equal (a one-node shift would be a whole grid spacing)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)


# ── the 1-D Crank-Nicolson grid ─────────────────────────────────────────────
_X = np.linspace(np.log(60.0), np.log(160.0), N_X).astype(np.float32)


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("is_call", [True, False])
def test_cn_solve_matches_jax(american, is_call):
    """Grid and boundary, with a 3 % proportional dividend at step 5."""
    sig2 = np.full((N_T, N_X), 0.04, np.float32)
    div = np.zeros(N_T, np.float32)
    div[5] = np.log1p(-0.03)
    args = (100.0, 0.7, 0.05, 0.02)
    ref_v, ref_s = jpde._cn_solve(
        jnp.asarray(sig2), *(jnp.float32(a) for a in args), jnp.asarray(_X),
        jnp.asarray(div), n_x=N_X, n_t=N_T, is_call=is_call,
        american=american)
    got_v, got_s = ppde._cn_solve(sig2, *args, _X, div, n_x=N_X, n_t=N_T,
                                  is_call=is_call, american=american,
                                  device="cpu")
    _grid_close(got_v, ref_v)
    if american:
        _stars_close(got_s, ref_s)
    else:
        assert torch.isnan(got_s).all() and got_s.shape == (N_T,)


def test_interp_is_jnp_interp():
    """The dividend jump condition's interpolation, clamped at both ends."""
    xp = np.linspace(-1.0, 1.0, 9).astype(np.float32)
    fp = np.cos(3 * xp).astype(np.float32)
    xq = np.linspace(-1.4, 1.3, 57).astype(np.float32)
    got = ppde._interp(*(torch.from_numpy(a) for a in (xq, xp, fp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.interp(xq, xp, fp)),
                               rtol=1e-6, atol=1e-7)


class _LocalVol:
    """A stand-in local-vol surface: what `PDEEngine._grids` reads (a
    Dupire table on y = x − log F, resampled per step), read the same way
    by both engines."""

    r, q = 0.04, 0.01

    def __init__(self):
        self.y_grid = np.linspace(-1.0, 1.0, 21)
        self.local_var = (0.04 + 0.05 * self.y_grid**2)[None, :] \
            * np.linspace(1.0, 1.5, 6)[:, None]

    def step_tables(self, T, n_t):
        t_mid = (np.arange(n_t) + 0.5) * T / n_t
        rows = np.stack([np.interp(t, np.linspace(0.0, T, 6),
                                   np.arange(6.0)) for t in t_mid])
        lo = np.floor(rows).astype(int).clip(0, 4)
        w = (rows - lo)[:, None]
        return (1 - w) * self.local_var[lo] + w * self.local_var[lo + 1], \
            t_mid


@pytest.mark.parametrize("american", [False, True])
def test_pde_engine_local_vol_per_step_table(american):
    """A per-step σ² table: up to n_t distinct rows, each inverted once."""
    lv = _LocalVol()
    kw = dict(n_x=N_X, n_t=N_T)
    jeng = jpde.PDEEngine(localvol=lv, **kw)
    peng = ppde.PDEEngine(localvol=lv, device="cpu", **kw)
    jx, jsig = jeng._grids(100.0, 95.0, 0.8)
    px, psig = peng._grids(100.0, 95.0, 0.8)
    np.testing.assert_array_equal(px, np.asarray(jx))
    np.testing.assert_array_equal(psig, np.asarray(jsig))
    assert len(np.unique(psig, axis=0)) == N_T
    ref = jeng.price(100.0, 95.0, 0.8, is_call=False, american=american)
    got = peng.price(100.0, 95.0, 0.8, is_call=False, american=american)
    assert got.keys() == ref.keys()
    for k in ("price", "delta", "gamma"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-6), k
    assert got["method"] == ref["method"]


def test_pde_engine_flat_price_and_boundary_match_jax():
    """Flat σ: two systems (θ = 1 and ½); price and Greeks of the grid,
    with proportional dividends; the boundary curve node for node."""
    jeng = jpde.PDEEngine(sigma=0.3, r=0.05, q=0.0, n_x=N_X, n_t=N_T)
    peng = ppde.PDEEngine(sigma=0.3, r=0.05, q=0.0, n_x=N_X, n_t=N_T,
                          device="cpu")
    divs = [(0.3, 0.04), (0.55, 0.02), (2.0, 0.5)]
    for kw in ({}, {"american": True}, {"dividends": divs},
               {"american": True, "dividends": divs}):
        ref = jeng.price(100.0, 100.0, 0.75, **kw)
        got = peng.price(100.0, 100.0, 0.75, **kw)
        for k in ("price", "delta", "gamma"):
            assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-6), (kw,
                                                                         k)
    for is_call, d in ((False, None), (True, divs)):
        ref = jeng.exercise_boundary(100.0, 100.0, 0.75, is_call, d)
        got = peng.exercise_boundary(100.0, 100.0, 0.75, is_call, d)
        assert got.keys() == ref.keys()
        assert got["t"] == ref["t"]
        assert got["price"] == pytest.approx(ref["price"], rel=1e-5)
        _stars_close(np.array(got["s_star"], float),
                     np.array(ref["s_star"], float))
    with pytest.raises(ValueError, match="fraction"):
        peng.price(100.0, 100.0, 0.75, dividends=[(0.3, 1.2)])
    with pytest.raises(ValueError, match="exactly one"):
        ppde.PDEEngine()


# ── the 2-D ADI Heston solve ────────────────────────────────────────────────
def _engines(lam=0.0, scheme="cs", **fields):
    jp = JSVJ(lambda_j=lam, **fields)
    pp = SVJParams(lambda_j=lam, **fields)
    kw = dict(n_x=N_X, n_v=N_V, n_t=N_T, scheme=scheme)
    return (jpde.HestonPDEEngine(jp, **kw),
            ppde.HestonPDEEngine(pp, device="cpu", **kw))


@pytest.mark.parametrize("scheme", ["cs", "douglas"])
@pytest.mark.parametrize("lam", [0.0, 2.0])
@pytest.mark.parametrize("american", [False, True])
def test_adi_heston_solve_matches_jax(scheme, lam, american):
    jeng, peng = _engines(lam, scheme)
    x, v, n_x, n_t = peng._grids(100.0, 105.0, 0.5)
    p = jeng.params
    ref_u, ref_s = jpde._adi_heston_solve(
        *(jnp.float32(a) for a in (105.0, 0.5, p.r, p.q, p.kappa, p.theta,
                                   p.xi, p.rho)),
        jnp.asarray(x), jnp.asarray(v), jump=jeng._jump_tables(x),
        n_x=n_x, n_v=N_V, n_t=n_t, is_call=False, american=american,
        scheme=scheme)
    got_u, got_s = ppde._adi_heston_solve(
        105.0, 0.5, p.r, p.q, p.kappa, p.theta, p.xi, p.rho, x, v,
        jump=peng._jump_tables(x), n_x=n_x, n_v=N_V, n_t=n_t,
        is_call=False, american=american, scheme=scheme, device="cpu")
    _grid_close(got_u, ref_u)
    if american:
        _stars_close(got_s, ref_s)
    ref = jeng.price(100.0, 105.0, 0.5, is_call=False, american=american)
    got = peng.price(100.0, 105.0, 0.5, is_call=False, american=american)
    assert got.keys() == ref.keys()
    for k in ("price", "delta", "gamma", "ad_vega_v0"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-6), k
    for k in ("n_x", "n_v", "n_t", "method"):
        assert got[k] == ref[k]


def test_merton_jump_tables_equal_jax():
    """Host float64 tables, equal to the reference's float32 tables once
    cast (float64 to 1e-12 of each other before the cast)."""
    x = np.linspace(3.9, 5.4, 57)
    got = ppde._merton_jump_tables(x, 2.5, -0.08, 0.12)
    ref = jpde._merton_jump_tables(x, 2.5, -0.08, 0.12)
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.float32(g).astype(np.float64),
                                   np.asarray(r, np.float64), rtol=1e-12,
                                   atol=0)
    w = got[2]
    np.testing.assert_allclose(w.sum(1) + got[3] + got[4], 1.0, atol=1e-12)
    with pytest.raises(ValueError, match="sigma_j must be > 0"):
        ppde._merton_jump_tables(x, 2.5, -0.08, 0.0)


def test_sigma_j_zero_raises_value_error():
    _, peng = _engines(2.0, sigma_j=0.0)
    with pytest.raises(ValueError, match="sigma_j"):
        peng.price(100.0, 100.0, 0.5)
    with pytest.raises(ValueError, match="scheme"):
        ppde.HestonPDEEngine(SVJParams(), scheme="adi", device="cpu")


@pytest.mark.parametrize("lam", [0.0, 3.0])
def test_resolution_and_grids_equal_jax(lam):
    jeng, peng = _engines(lam, sigma_j=0.05)
    for width, T in ((1.0, 0.5), (3.0, 10.0), (0.4, 0.01)):
        assert peng._resolution(width, T) == jeng._resolution(width, T)
    for spot, strike, T in ((100.0, 105.0, 0.5), (100.0, 80.0, 5.0)):
        jx, jv, jn_x, jn_t = jeng._grids(spot, strike, T)
        px, pv, pn_x, pn_t = peng._grids(spot, strike, T)
        assert (pn_x, pn_t) == (jn_x, jn_t)
        np.testing.assert_array_equal(px, np.asarray(jx))
        np.testing.assert_array_equal(pv, np.asarray(jv))


_BARRIERS = [
    dict(barrier=125.0, direction="up"),
    dict(barrier=80.0, direction="down", is_call=False),
    dict(barrier=130.0, barrier_lo=75.0),
    dict(barrier=125.0, direction="up", rebate=2.0, rebate_at_hit=True),
    dict(barrier=80.0, direction="down", rebate=2.0),
    dict(barrier=80.0, direction="down", is_call=False, american=True),
    dict(barrier=125.0, direction="up", knock="in"),
]


@pytest.mark.parametrize("case", range(len(_BARRIERS)))
@pytest.mark.parametrize("lam", [0.0, 2.0])
def test_price_barrier_matches_jax(case, lam):
    """Both absorbing edges, a corridor, rebates paid at hit and at
    expiry, an American knock-out, a knock-in by parity."""
    jeng, peng = _engines(lam)
    kw = _BARRIERS[case]
    ref = jeng.price_barrier(100.0, 100.0, 0.5, **kw)
    got = peng.price_barrier(100.0, 100.0, 0.5, **kw)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if isinstance(r, float):
            assert got[k] == pytest.approx(r, rel=1e-4, abs=1e-6), k
        else:
            assert got[k] == r, k


def test_price_barrier_refusals_match_jax():
    jeng, peng = _engines()
    for kw in (dict(barrier=95.0, direction="up"),
               dict(barrier=105.0, direction="down"),
               dict(barrier=120.0, barrier_lo=101.0),
               dict(barrier=120.0, knock="in", rebate=1.0),
               dict(barrier=120.0, knock="in", american=True),
               dict(barrier=120.0, knock="sideways"),
               dict(barrier=120.0, direction="left")):
        with pytest.raises(ValueError) as ref:
            jeng.price_barrier(100.0, 100.0, 0.5, **kw)
        with pytest.raises(ValueError) as got:
            peng.price_barrier(100.0, 100.0, 0.5, **kw)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("is_call,q", [(False, 0.02), (True, 0.08)])
def test_exercise_boundary_surface_matches_jax(is_call, q):
    """The American s_star surface (n_t, n_v) and its v0 slice."""
    jeng, peng = _engines(q=q)
    ref = jeng.exercise_boundary(100.0, 100.0, 0.5, is_call)
    got = peng.exercise_boundary(100.0, 100.0, 0.5, is_call)
    assert got.keys() == ref.keys()
    assert got["t"] == ref["t"] and got["v"] == ref["v"]
    _stars_close(np.array(got["s_star"], float),
                 np.array(ref["s_star"], float))
    a = np.array(got["s_star_at_v0"], float)
    b = np.array(ref["s_star_at_v0"], float)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=1e-6)
    assert np.isfinite(a).any()


def _op_count(fn) -> int:
    """The torch ops `fn` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def test_op_count_does_not_grow_with_the_grid(monkeypatch):
    """The same torch ops, as many, at any n_x and n_v: every implicit
    stage is one batched product, no loop over nodes or lines. The
    inverses are taken as on the card, in one batched call (safe on the
    CPU on one thread)."""
    monkeypatch.setattr(ppde, "_batched_inverse",
                        lambda a: torch.linalg.inv_ex(a)[0])
    def heston(n_x, n_v):
        return lambda: ppde.HestonPDEEngine(
            SVJParams(lambda_j=0.0), n_x=n_x, n_v=n_v, n_t=N_T,
            device="cpu").price(100.0, 100.0, 0.5, american=True)

    def bs(n_x):
        return lambda: ppde.PDEEngine(sigma=0.2, n_x=n_x, n_t=N_T,
                                      device="cpu").price(
            100.0, 100.0, 0.5, american=True, dividends=[(0.2, 0.02)])

    assert _op_count(heston(41, 21)) == _op_count(heston(81, 41))
    assert _op_count(bs(41)) == _op_count(bs(161))
