"""Port pins for rough Heston (slice L) against `mcos_tpu`: the lifted
Monte Carlo step loop on replayed JAX normals, its member axis and its
checkpointed chunks, and the engine's price, standard error, v_max, AD
delta and six-member FD sensitivities on the JAX key's normals; the
H = 1/2 engine against the port's Heston COS price."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import roughheston as jeng
from mcos_tpu.ops import roughheston as jr
from mcos_tpu_torch.engine import roughheston as peng
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import roughheston as pr
from mcos_tpu_torch.ops.cos_pricer import cos_price

torch.set_num_threads(1)

_FIELDS = dict(lam=1.5, theta=0.04, nu=0.35, rho=-0.7, v0=0.04, r=0.05,
               q=0.01)
_SPOT, _T = 100.0, 0.25
_PATHS = 512


def _both(**updates):
    fields = dict(_FIELDS, **updates)
    return jr.RoughHestonParams(**fields), pr.RoughHestonParams(**fields)


def _jax_normals(key, steps: int, paths: int) -> torch.Tensor:
    """The (steps, 2, paths) normals the JAX scan draws: step t from
    fold_in(key, t)."""
    z = jax.vmap(lambda t: jax.random.normal(jax.random.fold_in(key, t),
                                             (2, paths), jnp.float32))(
        jnp.arange(steps))
    return torch.from_numpy(np.array(z))


def _close(got, ref, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


# ─────────────────────────────────────────────────────────────────────────────
# lifted_terminal against the JAX scan
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("hurst,n_factors,steps,companion", [
    (0.1, 24, 64, True), (0.1, 8, 65, False), (0.1, 24, 65, True),
    (0.5, 24, 64, True), (0.5, 8, 65, False)])
def test_lifted_terminal_matches_jax(hurst, n_factors, steps, companion):
    """S and G path by path to rtol 2e-5; v to atol 5e-6 beside rtol 2e-5.
    The factor sum is one contraction, whose order differs from XLA's; at
    24 factors the JAX scan's own float32 v lies up to 1.9e-6 from the
    same recursion with the contraction in float64 (the port's: 2.7e-6),
    so 1e-6 would pin rounding, not the scheme. H = 1/2 is the
    one-factor, undamped full-truncation Euler scheme."""
    jp, pp = _both(hurst=hurst)
    c, x = jr.lifted_kernel_nodes(hurst, _T, _T / 256, n_factors)
    key = jax.random.key(11)
    S, v, G = jr.lifted_terminal(
        jp, _SPOT, _T, key, jnp.asarray(c, jnp.float32),
        jnp.asarray(x, jnp.float32), num_paths=_PATHS, num_steps=steps,
        companion=companion)
    s2, v2, g2 = pr.lifted_terminal(
        pp, _SPOT, _T, None, c, x, num_paths=_PATHS, num_steps=steps,
        companion=companion, draws=_jax_normals(key, steps, _PATHS),
        device="cpu")
    assert s2.shape == v2.shape == (2, _PATHS)
    _close(s2, S, 2e-5, what="S")
    _close(v2, v, 2e-5, 5e-6, what="v")
    if companion:
        _close(g2, G, 2e-5, what="G")
    else:
        assert g2 is None and G is None
    if hurst == 0.5:
        assert (c, x) == ((1.0,), (0.0,))


def test_lifted_terminal_one_branch_matches_jax():
    jp, pp = _both()
    c, x = jr.lifted_kernel_nodes(0.1, _T, _T / 256, 8)
    key = jax.random.key(3)
    S, v, _ = jr.lifted_terminal(
        jp, _SPOT, _T, key, jnp.asarray(c, jnp.float32),
        jnp.asarray(x, jnp.float32), num_paths=_PATHS, num_steps=32,
        antithetic=False)
    s2, v2, _ = pr.lifted_terminal(
        pp, _SPOT, _T, None, c, x, num_paths=_PATHS, num_steps=32,
        antithetic=False, draws=_jax_normals(key, 32, _PATHS), device="cpu")
    assert s2.shape == (1, _PATHS)
    _close(s2, S, 2e-5)
    _close(v2, v, 2e-5, 5e-6)


def test_lifted_member_axis_is_each_member_alone():
    """(M,) parameters run M members on one set of normals: each equals
    its own one-member run."""
    _, pp = _both()
    c, x = pr.lifted_kernel_nodes(0.1, _T, _T / 256, 8)
    z = torch.randn((32, 2, 256), generator=seeded_generator(5, "cpu"))
    lams, nus = [1.0, 1.5, 3.0], [0.2, 0.35, 0.6]
    pm = pp.replace(lam=torch.tensor(lams), nu=torch.tensor(nus))
    S, v, G = pr.lifted_terminal(pm, _SPOT, _T, None, c, x, num_paths=256,
                                 num_steps=32, companion=True, draws=z,
                                 device="cpu")
    assert S.shape == v.shape == G.shape == (3, 2, 256)
    for m, (lam, nu) in enumerate(zip(lams, nus)):
        s1, v1, g1 = pr.lifted_terminal(
            pp.replace(lam=lam, nu=nu), _SPOT, _T, None, c, x,
            num_paths=256, num_steps=32, companion=True, draws=z,
            device="cpu")
        _close(S[m], s1, 1e-6)
        _close(v[m], v1, 1e-6, 1e-8)
        _close(G[m], g1, 0.0)


def test_lifted_remat_chunks_equal_plain_loop():
    """Under autograd, remat_chunk runs checkpointed chunks on normals
    drawn before each chunk: the terminals and the gradient equal the
    plain loop's on the same generator."""
    _, pp = _both()
    c, x = pr.lifted_kernel_nodes(0.1, _T, _T / 256, 8)
    outs = []
    for remat in (0, 16):
        nu = torch.tensor(0.35, requires_grad=True)
        S, v, _ = pr.lifted_terminal(
            pp.replace(nu=nu), _SPOT, _T, seeded_generator(9, "cpu"), c, x,
            num_paths=256, num_steps=64, remat_chunk=remat, device="cpu")
        (g,) = torch.autograd.grad(S.mean(), (nu,))
        outs.append((S.detach(), v.detach(), g))
    (s0, v0, g0), (s1, v1, g1) = outs
    assert torch.equal(s0, s1) and torch.equal(v0, v1)
    _close(g1, g0, 1e-6)
    with pytest.raises(ValueError, match="multiple"):
        pr.lifted_terminal(pp.replace(nu=torch.tensor(0.3,
                                                      requires_grad=True)),
                           _SPOT, _T, seeded_generator(9, "cpu"), c, x,
                           num_paths=64, num_steps=30, remat_chunk=16,
                           device="cpu")


def test_lifted_draws_shape_checked():
    _, pp = _both()
    c, x = pr.lifted_kernel_nodes(0.1, _T, _T / 256, 4)
    with pytest.raises(ValueError, match="draws"):
        pr.lifted_terminal(pp, _SPOT, _T, None, c, x, num_paths=64,
                           num_steps=8, draws=torch.zeros(8, 3, 64),
                           device="cpu")


def _lifted_f64(f: dict, c, x, z: np.ndarray, T: float = _T,
                spot: float = _SPOT):
    """The lifted recursion in numpy float64 on normals z (steps, 2,
    paths): the referee both packages' float32 loops are held against."""
    n = z.shape[0]
    dt = T / n
    sign = np.array([1.0, -1.0])[:, None]
    c = np.asarray(c)[:, None, None]
    damp = 1.0 / (1.0 + np.asarray(x)[:, None, None] * dt)
    rho_perp = np.sqrt(1.0 - f["rho"] ** 2)
    log_s = np.zeros((2, z.shape[2]))
    v_fac = np.zeros((c.shape[0], *log_s.shape))
    log_g = np.zeros_like(log_s)
    for t in range(n):
        z1 = z[t, 0] * sign
        zv = f["rho"] * z1 + rho_perp * z[t, 1] * sign
        v = np.maximum(f["v0"] + (c * v_fac).sum(axis=0), 0.0)
        sv = np.sqrt(v)
        v_fac = (v_fac + f["lam"] * (f["theta"] - v) * dt
                 + f["nu"] * sv * zv * np.sqrt(dt)) * damp
        log_s = log_s + (f["r"] - f["q"] - 0.5 * v) * dt \
            + sv * z1 * np.sqrt(dt)
        log_g = log_g + (f["r"] - f["q"] - 0.5 * f["v0"]) * dt \
            + np.sqrt(f["v0"]) * z1 * np.sqrt(dt)
    return spot * np.exp(log_s), spot * np.exp(log_g)


def _cv_prices(S, G, strikes):
    S, G = np.asarray(S, np.float64), np.asarray(G, np.float64)
    k = np.asarray(strikes)
    return (np.maximum(S[..., None] - k, 0.0)
            - np.maximum(G[..., None] - k, 0.0)).mean(axis=(0, 1))


@pytest.mark.parametrize("n_factors", [8, 24])
def test_lifted_512_steps_as_close_to_float64_as_jax(n_factors):
    """At the engine's 512 steps the rough variance path amplifies float32
    rounding: on the same normals each package's control-variate payoff
    means move off the float64 recursion by up to ~6e-6 of the spot, and
    off each other by as much. Both stay within 1e-5 of the spot of the
    referee."""
    f = dict(_FIELDS, hurst=0.1)
    jp, pp = _both()
    c, x = jr.lifted_kernel_nodes(0.1, _T, _T / 256, n_factors)
    key = jax.random.key(7)
    z = _jax_normals(key, 512, 1000)
    S, _, G = jr.lifted_terminal(
        jp, _SPOT, _T, key, jnp.asarray(c, jnp.float32),
        jnp.asarray(x, jnp.float32), num_paths=1000, num_steps=512,
        companion=True)
    s2, _, g2 = pr.lifted_terminal(pp, _SPOT, _T, None, c, x,
                                   num_paths=1000, num_steps=512,
                                   companion=True, draws=z, device="cpu")
    strikes = [95.0, 100.0, 105.0]
    exact = _cv_prices(*_lifted_f64(f, c, x, z.numpy().astype(np.float64)),
                       strikes)
    err_jax = np.abs(_cv_prices(S, G, strikes) - exact)
    err_port = np.abs(_cv_prices(s2, g2, strikes) - exact)
    assert np.all(err_jax <= 1e-5 * _SPOT), err_jax
    assert np.all(err_port <= 1e-5 * _SPOT), err_port


# ─────────────────────────────────────────────────────────────────────────────
# The engine against the JAX engine on the JAX key's normals
# ─────────────────────────────────────────────────────────────────────────────
_ENG = dict(num_paths=1000, num_steps=64, n_factors=8, seed=7)
#: Price tolerance of the engine pins: 512 steps put both packages' float32
#: prices up to ~6e-6 of the spot off the float64 recursion (the test
#: above); the standard error, sqrt(E[x^2] - mean^2), carries mean^2/var
#: (~5 here) times a price's relative error.
_PRICE_RTOL, _SE_RTOL = 1e-4, 5e-4


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's, the port replaying the normals of
    jax.random.key(seed) (both engines draw every figure from that key)."""
    jp, pp = _both()
    j = jeng.RoughHestonEngine(jp, **_ENG)
    p = peng.RoughHestonEngine(pp, device="cpu", **_ENG)
    steps = p._steps(_T)
    assert steps == j._steps(_T) == 512
    z = _jax_normals(jax.random.key(_ENG["seed"]), steps, _ENG["num_paths"])
    p._draws = lambda n: z
    return j, p


def test_engine_price_matches_jax(engines):
    j, p = engines
    strikes = [95.0, 100.0, 105.0]
    ref, got = j.price(_SPOT, strikes, _T), p.price(_SPOT, strikes, _T)
    assert got.keys() == ref.keys()
    _close(got["price"], ref["price"], _PRICE_RTOL, what="price")
    _close(got["std_error"], ref["std_error"], _SE_RTOL, what="std_error")
    _close(got["bs_ref"], ref["bs_ref"], 1e-6, what="bs_ref")
    _close(got["v_max"], ref["v_max"], 1e-5, what="v_max")
    for k in ("num_paths_used", "num_steps", "n_factors", "frac_nonfinite"):
        assert got[k] == ref[k], k
    for a, b in zip(got["chain"], ref["chain"]):
        assert a["strike"] == b["strike"]
        _close(a["price"], b["price"], _PRICE_RTOL)
        _close(a["std_error"], b["std_error"], _SE_RTOL)


def test_engine_greeks_match_jax(engines):
    """The price and the AD delta against the JAX package's (the delta to
    rtol 1e-5: S_T/S0 does not feel the variance path's rounding); the
    price of the delta pass is the price's."""
    j, p = engines
    ref, got = j.greeks(_SPOT, 100.0, _T), p.greeks(_SPOT, 100.0, _T)
    assert got.keys() == ref.keys()
    _close(got["price"], ref["price"], _PRICE_RTOL, what="price")
    _close(got["delta"], ref["delta"], 1e-5, what="delta")
    _close(got["price"], p.price(_SPOT, 100.0, _T)["price"], 1e-6)
    _close(got["vega"], 2.0 * 0.2 * got["dP_dv0"], 1e-6)


@pytest.mark.parametrize("rho", [-0.7, -0.99])
def test_fd_sensitivities_match_jax(rho):
    """The six CRN members (v0 ± 5 %, nu ± 0.02, rho ± 0.02 clipped to
    ±0.999) priced on one member axis against the JAX package's members
    one by one (rtol 1e-4, the price pin); the port's three differences
    are its members' quotients (the rho span the clipped one, at -0.99),
    and each lies off the JAX package's by no more than its members'
    differences carry (float32 rounding over 512 steps, divided by a
    bump of 0.004-0.04)."""
    jp, pp = _both(rho=rho)
    c, x = pr.lifted_kernel_nodes(0.1, _T, _T / 256, 8)
    key = jax.random.key(2)
    z = _jax_normals(key, 512, 1000)
    kw = dict(num_paths=1000, num_steps=512, is_call=False)
    f32 = np.float32
    h_v0, h = f32(0.05) * f32(jp.v0), f32(0.02)
    rhos = [rho] * 4 + [min(f32(rho) + h, f32(0.999)),
                        max(f32(rho) - h, f32(-0.999))]
    members = list(zip([f32(jp.v0) + h_v0, f32(jp.v0) - h_v0] + [jp.v0] * 4,
                       [jp.nu] * 2 + [f32(jp.nu) + h, f32(jp.nu) - h]
                       + [jp.nu] * 2, rhos))
    ref_p = np.array([float(jeng._rh_mc_price(
        jp.replace(v0=a, nu=b, rho=r), _SPOT, 100.0, _T, key,
        jnp.asarray(c, jnp.float32), jnp.asarray(x, jnp.float32), **kw))
        for a, b, r in members])
    got_p = peng._rh_mc_price(
        pp.replace(v0=torch.tensor([m[0] for m in members]),
                   nu=torch.tensor([m[1] for m in members]),
                   rho=torch.tensor([m[2] for m in members])),
        _SPOT, 100.0, _T, None, c, x, draws=z, device="cpu", **kw).numpy()
    _close(got_p, ref_p, _PRICE_RTOL, what="member prices")
    spans = np.array([2 * h_v0, 2 * h, f32(rhos[4]) - f32(rhos[5])],
                     np.float32)
    if rho == -0.99:
        assert rhos[5] == f32(-0.999)
    got = np.array([float(g) for g in peng._rh_fd_sens(
        pp, _SPOT, 100.0, _T, None, c, x, draws=z, device="cpu", **kw)])
    ref = np.array([float(r) for r in jeng._rh_fd_sens(
        jp, _SPOT, 100.0, _T, key, jnp.asarray(c, jnp.float32),
        jnp.asarray(x, jnp.float32), **kw)])
    quot = (got_p[0::2] - got_p[1::2]) / spans
    _close(got, quot, 1e-5, what="quotients")
    carried = (np.abs(got_p - ref_p)[0::2] + np.abs(got_p - ref_p)[1::2]) \
        / spans
    assert np.all(np.abs(got - ref) <= 1.01 * carried + 1e-4 * np.abs(ref)), \
        (got, ref, carried)


def test_engine_compare_matches_jax(engines):
    j, p = engines
    ref, got = j.mc_vs_cos(_SPOT, [90.0, 100.0], _T), \
        p.mc_vs_cos(_SPOT, [90.0, 100.0], _T)
    assert got["num_steps"] == ref["num_steps"]
    assert got["kernel_fit_error"] == ref["kernel_fit_error"]
    for a, b in zip(got["rows"], ref["rows"]):
        assert a["cos_price"] == b["cos_price"]
        _close(a["mc_price"], b["mc_price"], _PRICE_RTOL)
        _close(a["std_error"], b["std_error"], _SE_RTOL)


def test_engine_mesh_is_slice_n():
    """The mesh, once refused, is slice N1's: a one-shard mesh prices the
    unsharded engine's lifted paths."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    kw = dict(num_paths=256, num_steps=1024, n_factors=6, device="cpu")
    ref = peng.RoughHestonEngine(pr.RoughHestonParams(), **kw).price(
        _SPOT, 100.0, _T)
    got = peng.RoughHestonEngine(pr.RoughHestonParams(),
                                 mesh=make_mesh(["cpu"]), **kw).price(
        _SPOT, 100.0, _T)
    for k in ("price", "std_error", "bs_ref"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k


def test_engine_steps_and_nodes_match_jax():
    for num_steps, T in ((8192, 0.25), (100, 1.0), (8192, 2.0), (3000, 0.4)):
        j = jeng.RoughHestonEngine(jr.RoughHestonParams(),
                                   num_steps=num_steps)
        p = peng.RoughHestonEngine(pr.RoughHestonParams(),
                                   num_steps=num_steps, device="cpu")
        assert p._steps(T) == j._steps(T) and p._steps(T) % 64 == 0
        assert p.kernel_fit_error(T) == j.kernel_fit_error(T)
    assert peng.RoughHestonEngine(pr.RoughHestonParams(),
                                  device="cpu")._steps(0.25) == 2048


def test_half_hurst_engine_reprices_heston_cos():
    """H = 1/2: one factor, full-truncation Euler; the engine reprices the
    Heston COS twin (kappa = lam, xi = nu) within 4 se + 0.4 %."""
    pp = pr.RoughHestonParams(lam=1.5, theta=0.04, nu=0.35, rho=-0.7,
                              v0=0.04, hurst=0.5)
    exact = float(cos_price(SVJParams(kappa=1.5, theta=0.04, xi=0.35,
                                      rho=-0.7, v0=0.04, lambda_j=0.0),
                            22500.0, [22500.0], _T, True)[0])
    out = peng.RoughHestonEngine(pp, num_paths=20_000, num_steps=2048,
                                 seed=1, device="cpu").price(
        22500.0, 22500.0, _T, True)
    assert out["n_factors"] == 1 and out["num_steps"] == 512
    assert abs(out["price"] - exact) < 4 * out["std_error"] + 0.004 * exact
