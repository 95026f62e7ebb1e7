"""Pins for kernels K10 (`cuda_kernels.rbergomi_lift_integrals`) and K11
(`rbergomi_lift_stats`) through their plain versions, the CPU side of the
wrappers: path by path against the lift twins on the plain versions' own
Philox normals, by law (E[I2], the martingale, the Black-Scholes limit),
and against the exact sampler's prices. The kernels themselves run only on
a CUDA device (tests/test_torch_cuda.py and chip_smoke.py, bit for bit
against the plain versions)."""

import math

import numpy as np
import pytest
import torch
from scipy.stats import norm

from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import rough as pr

torch.set_num_threads(1)

H = 0.07
_P = pr.RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, r=0.05, q=0.01,
                           hurst=H)
_SPOT, _T = 100.0, 0.25


def _vec(p, spot=_SPOT):
    return (p.eta, p.rho, p.r, p.q, p.xi, spot)


def _k10_normals(seed, steps, n):
    """(steps, 2, n) normals K10's plain version draws, rebuilt from the
    layout its docstring states: call i, Box-Muller(a0, a1) for step 2i and
    Box-Muller(a2, a3) for step 2i+1."""
    z = []
    for call in range((steps + 1) // 2):
        u = ck._pair_words(n, call, ck._ROUGH_DOMAIN, seed, "cpu")
        z.append(torch.stack(ck.box_muller(u[0], u[1])))
        if 2 * call + 1 < steps:
            z.append(torch.stack(ck.box_muller(u[2], u[3])))
    return torch.stack(z)


def _k11_normals(seed, steps, n):
    """(steps, 3, n) normals of K11's plain version: K7's layout."""
    def words(call):
        return ck._pair_words(n, call, ck._ROUGH_STATS_DOMAIN, seed, "cpu")

    z = []
    for i in range(0, steps - 1, 2):
        a, b = words(i), words(i + 1)
        z_a, z_b = ck.box_muller(a[0], a[1])
        z_c, z_d = ck.box_muller(a[2], a[3])
        z_e, z_f = ck.box_muller(b[0], b[1])
        z += [torch.stack([z_a, z_b, z_c]), torch.stack([z_d, z_e, z_f])]
    if steps % 2:
        a = words(steps - 1)
        z.append(torch.stack([*ck.box_muller(a[0], a[1]),
                              ck.box_muller(a[2], a[3])[0]]))
    return torch.stack(z)


@pytest.mark.parametrize("hurst", [H, 0.5])
@pytest.mark.parametrize("steps", [16, 7])
def test_k10_plain_equals_twin_on_its_own_philox_normals(hurst, steps):
    """K10's plain version (what the card kernel is held bit-equal to) and
    the lift twin (pinned to the JAX scan) on the same normals, path by
    path: I2 at rtol 2e-5, I1 at 2e-5 of the size of its terms (sqrt I2),
    at 25 factors and at one (H = 0.5), even and odd step counts. The
    kernel takes exp(±ηw + ln ξ − η²t^{2H}/2), the twin ξ·exp(ηw − ...)."""
    p = pr.RoughBergomiParams(**{**_P.__dict__, "hurst": hurst})
    n, seed = 2048, 11
    c, d, g, tail = pr.rbergomi_lift(hurst, _T, steps)
    assert len(c) == (1 if hurst == 0.5 else 25)
    before = ck.launch_counts()
    i1, i2 = ck.rbergomi_lift_integrals(p.eta, _T, seed, c, d, g, tail,
                                        hurst, num_paths=n, num_steps=steps,
                                        xi_flat=p.xi, device="cpu")
    assert ck.launch_counts() == before          # a CPU device: no launch
    _, r1, r2 = pr.rbergomi_core_lifted(p, _T, None, c, d, g, tail,
                                        num_paths=n, num_steps=steps,
                                        draws=_k10_normals(seed, steps, n))
    assert i1.shape == i2.shape == (2, n)
    np.testing.assert_allclose(i2.numpy(), r2.numpy(), rtol=2e-5)
    scale = torch.sqrt(r2) + r1.abs()
    assert bool(((i1 - r1).abs() <= 2e-5 * scale).all())


@pytest.mark.parametrize("hurst", [H, 0.5])
@pytest.mark.parametrize("steps", [16, 7])
def test_k11_plain_equals_twin_on_its_own_philox_normals(hurst, steps):
    """K11's plain version and the lift path-statistics twin on the same
    normals: the four statistics at rtol 2e-5, path by path."""
    p = pr.RoughBergomiParams(**{**_P.__dict__, "hurst": hurst})
    n, seed = 2048, 5
    c, d, g, tail = pr.rbergomi_lift(hurst, _T, steps)
    got = ck.rbergomi_lift_stats(_vec(p), _T, seed, c, d, g, tail, hurst,
                                 num_paths=n, num_steps=steps, device="cpu")
    ref = pr.rbergomi_path_stats_lifted(p, _SPOT, _T, None, c, d, g, tail,
                                        num_paths=n, num_steps=steps,
                                        draws=_k11_normals(seed, steps, n))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == (2, n)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=2e-5)
    assert bool((got["s_max"] >= got["s_min"]).all())


def test_plain_single_branch_is_the_base_branch_and_stream_shape_free():
    c, d, g, tail = pr.rbergomi_lift(H, _T, 9)
    kw = dict(num_steps=9, device="cpu")
    a = ck.rbergomi_lift_integrals(1.9, _T, 3, c, d, g, tail, H,
                                   num_paths=512, **kw)
    b = ck.rbergomi_lift_integrals(1.9, _T, 3, c, d, g, tail, H,
                                   num_paths=256, antithetic=False, **kw)
    for x, y in zip(a, b):
        assert y.shape == (1, 256)
        np.testing.assert_array_equal(x[:1, :256].numpy(), y.numpy())
    s = ck.rbergomi_lift_stats(_vec(_P), _T, 3, c, d, g, tail, H,
                               num_paths=512, **kw)
    s1 = ck.rbergomi_lift_stats(_vec(_P), _T, 3, c, d, g, tail, H,
                                num_paths=256, antithetic=False, **kw)
    for k in s:
        np.testing.assert_array_equal(s[k][:1, :256].numpy(), s1[k].numpy())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    c, d, g, tail = pr.rbergomi_lift(H, _T, 8)
    with pytest.raises(ValueError, match="factors"):
        ck.rbergomi_lift_integrals(1.9, _T, 1, np.ones(33), np.ones(33),
                                   np.ones(33), tail, H, num_paths=8,
                                   num_steps=8, device="cpu")
    with pytest.raises(ValueError, match="tail"):
        ck.rbergomi_lift_integrals(1.9, _T, 1, c, d, g, tail[:4], H,
                                   num_paths=8, num_steps=8, device="cpu")
    with pytest.raises(ValueError, match="xi_t"):
        ck.rbergomi_lift_stats(_vec(_P), _T, 1, c, d, g, tail, H,
                               num_paths=8, num_steps=8, xi_t=[0.04] * 3,
                               device="cpu")
    with pytest.raises(ValueError):
        ck.rbergomi_lift_integrals(1.9, _T, -1, c, d, g, tail, H,
                                   num_paths=8, num_steps=8, device="cpu")
    with pytest.raises(ValueError):
        ck.rbergomi_lift_stats(_vec(_P), _T, 1, c, d, g, tail, H,
                               num_paths=8, num_steps=8, device="meta")


def test_rough_tables_left_points():
    """The step table starts from the t_0 row: ln ξ with no Wick term and a
    zero tail; later rows carry ln ξ_i − η²t_i^{2H}/2 and √tail_{i−1}."""
    c, d, g, tail = pr.rbergomi_lift(H, _T, 8)
    xi_t = np.linspace(0.03, 0.05, 8)
    p, cdg, tab = ck._rough_tables(1.9, 0.04, H, _T, 8, c, d, g, tail, xi_t,
                                   spot_leg=(-0.6, 0.05, 0.01))
    dt = _T / 8
    assert p.dtype == cdg.dtype == tab.dtype == np.float32
    assert cdg.shape == (3, 25) and tab.shape == (2, 8)
    t = dt * np.arange(8)
    np.testing.assert_allclose(
        tab[0], np.log(xi_t) - 0.5 * 1.9**2 * t ** (2 * H), rtol=1e-6)
    np.testing.assert_allclose(tab[1, 1:], np.sqrt(tail[:-1]), rtol=1e-6)
    assert tab[1, 0] == 0.0
    np.testing.assert_allclose(
        p, [1.9, math.sqrt(dt), dt, -0.6, 0.8, 0.04 * dt, 1 / 8], rtol=1e-6)


# ─────────────────────────────────────────────────────────────────────────────
# By law
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("xi_curve", [False, True])
def test_k10_plain_mean_integrated_variance(xi_curve):
    """E[I2] = ∫ξ exactly under the lift (the tail top-up makes every
    Var[W~_t] exact, so E[v_t] = ξ(t)): within 4 se."""
    n, steps = 8192, 32
    c, d, g, tail = pr.rbergomi_lift(H, _T, steps)
    xi_t = np.linspace(0.02, 0.07, steps) if xi_curve else None
    _, i2 = ck.rbergomi_lift_integrals(1.9, _T, 21, c, d, g, tail, H,
                                       num_paths=n, num_steps=steps,
                                       xi_t=xi_t, xi_flat=0.04, device="cpu")
    want = (np.sum(xi_t) * _T / steps) if xi_curve else 0.04 * _T
    pair = i2.double().mean(dim=0)
    se = float(pair.std()) / math.sqrt(n)
    assert abs(float(pair.mean()) - want) < 4 * se


def test_k11_plain_martingale():
    """E[S_T] = S0 e^{(r−q)T} within 4 se."""
    n, steps = 8192, 32
    c, d, g, tail = pr.rbergomi_lift(H, _T, steps)
    st = ck.rbergomi_lift_stats(_vec(_P), _T, 22, c, d, g, tail, H,
                                num_paths=n, num_steps=steps, device="cpu")
    pair = st["s_terminal"].double().mean(dim=0)
    se = float(pair.std()) / math.sqrt(n)
    want = _SPOT * math.exp((_P.r - _P.q) * _T)
    assert abs(float(pair.mean()) - want) < 4 * se


def test_k10_plain_black_scholes_limit():
    """At η = 0 and ρ = 0 the variance is flat and the conditional Black
    price of every path is Black-Scholes at σ = √ξ (float32 rounding)."""
    p = pr.RoughBergomiParams(xi=0.04, eta=0.0, rho=0.0, r=0.05, q=0.01,
                              hurst=H)
    c, d, g, tail = pr.rbergomi_lift(H, _T, 16)
    i1, i2 = ck.rbergomi_lift_integrals(0.0, _T, 1, c, d, g, tail, H,
                                        num_paths=1024, num_steps=16,
                                        xi_flat=0.04, device="cpu")
    strikes = torch.tensor([90.0, 100.0, 110.0])
    pay = pr._conditional_black(p, torch.tensor(_SPOT), strikes,
                                torch.tensor(_T), i1, i2, True)
    sd = 0.2 * math.sqrt(_T)
    k = strikes.double().numpy()
    d1 = (np.log(_SPOT / k) + (p.r - p.q + 0.02) * _T) / sd
    bs = (_SPOT * math.exp(-p.q * _T) * norm.cdf(d1)
          - k * math.exp(-p.r * _T) * norm.cdf(d1 - sd))
    got = math.exp(-p.r * _T) * pay.double().numpy()
    np.testing.assert_allclose(got, np.broadcast_to(bs, got.shape),
                               rtol=1e-5)


def _mean_se(x: torch.Tensor):
    comb = x.double().mean(dim=0)
    return float(comb.mean()), float(comb.std()) / math.sqrt(comb.numel())


def test_plain_versions_settle_by_law_against_the_exact_sampler():
    """K10's smile within 5 joint se or 2 % of the exact sampler's, and
    K11's Asian and up-and-out within 6 joint se of the exact sheet's
    (as tests/test_rough.py pins the JAX lift scan)."""
    T, n, paths = 0.5, 128, 1 << 14
    strikes = torch.tensor([85.0, 95.0, 100.0, 105.0, 115.0])
    disc = math.exp(-_P.r * T)
    chol = pr.rbergomi_chol(H, T, n)
    gen = torch.Generator().manual_seed(5)
    pay_ex = pr.rbergomi_conditional_payoffs(
        _P, _SPOT, strikes, T, chol, gen, num_paths=paths, num_steps=n,
        is_call=True, device="cpu")
    c, d, g, tail = pr.rbergomi_lift(H, T, n)
    i1, i2 = ck.rbergomi_lift_integrals(_P.eta, T, 6, c, d, g, tail, H,
                                        num_paths=paths, num_steps=n,
                                        xi_flat=_P.xi, device="cpu")
    pay_li = pr._conditional_black(_P, torch.tensor(_SPOT), strikes,
                                   torch.tensor(T), i1, i2, True)
    for j in range(strikes.numel()):
        pe, se = _mean_se(pay_ex[..., j])
        pl, sl = _mean_se(pay_li[..., j])
        joint = disc * math.hypot(se, sl)
        assert abs(disc * (pe - pl)) < max(5 * joint, 0.02 * disc * pe)
    ex = pr.rbergomi_path_stats(_P, _SPOT, T, chol, gen, num_paths=paths,
                                num_steps=n, device="cpu")
    li = ck.rbergomi_lift_stats(_vec(_P), T, 7, c, d, g, tail, H,
                                num_paths=paths, num_steps=n, device="cpu")
    for fn in (lambda s: torch.clamp(s["s_mean"] - 100.0, min=0.0),
               lambda s: torch.clamp(s["s_terminal"] - 100.0, min=0.0)
               * (s["s_max"] < 115.0)):
        pe, se = _mean_se(fn(ex))
        pl, sl = _mean_se(fn(li))
        assert abs(pe - pl) < 6 * math.hypot(se, sl)
