"""Port pins for the Heston-Hull-White slice: the torch twin step for step
against the JAX scan on replayed draws, kernel K7's plain version (the CPU
side of `cuda_kernels.hhw_terminal`) by law and against the interpreted
Pallas kernel's known path, the 3x3 Cholesky hazard, and `HHWEngine`. The
kernel itself runs only on a CUDA device (tests/test_torch_cuda.py and
chip_smoke.py, word for word against the plain version)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine.hhw import HHWEngine as JHHWEngine
from mcos_tpu.ops import hhw as jhhw
from mcos_tpu.ops import pallas_kernels as jpk
from mcos_tpu_torch.engine.hhw import HHWEngine
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import hhw as phhw

torch.set_num_threads(1)

_FIELDS = dict(kappa=2.0, theta=0.05, xi=0.4, v0=0.04, a=0.1, b=0.05,
               sigma_r=0.012, r0=0.05, rho_sv=-0.6, rho_sr=0.3, rho_vr=0.1,
               q=0.01)
_SPOT, _T = 100.0, 2.0


def _both(**updates):
    fields = dict(_FIELDS, **updates)
    return jhhw.HHWParams(**fields), phhw.HHWParams(**fields)


def _replayed_normals(key, steps, n):
    """The (steps, 3, n) normals the JAX scan draws from `key`."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (3, n), jnp.float32))
        for i in range(steps)])


@pytest.mark.parametrize("antithetic", [True, False])
def test_twin_equals_jax_scan_on_replayed_draws(antithetic):
    """`hhw_terminal` on the JAX scan's own normals: S and D at rtol 2e-5
    (float32 on both sides, sums in another order)."""
    jp, pp = _both()
    steps, n = 16, 2048
    key = jax.random.key(5)
    ref = jhhw.hhw_terminal(jp, _SPOT, _T, key, num_paths=n, num_steps=steps,
                            antithetic=antithetic)
    z = torch.from_numpy(_replayed_normals(key, steps, n))
    got = phhw.hhw_terminal(pp, _SPOT, _T, None, num_paths=n,
                            num_steps=steps, antithetic=antithetic, draws=z)
    for g, r in zip(got, ref):
        assert g.shape == (2 if antithetic else 1, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5)


@pytest.mark.parametrize("steps", [6, 7])
def test_twin_steps_the_interpreted_pallas_kernel(steps):
    """Off a TPU the Pallas interpreter's generator returns zero bits, so
    `hhw_terminal_pallas` runs one known path per branch: every uniform is
    2^-24 and every Box-Muller pair the same (z_a, z_b); step 2i runs on
    (z_a, z_b, z_a), step 2i+1 on (z_b, z_a, z_b), an odd tail on (z_a,
    z_b, z_a). The port's twin on those normals gives the same S and D
    (rtol 2e-5), which pins the step algebra, the Cholesky mix and the
    draw layout against the TPU kernel itself."""
    jp, pp = _both()
    n = 1024
    s_ref, d_ref = jpk.hhw_terminal_pallas(jp, _SPOT, _T, 3, num_paths=n,
                                           num_steps=steps, rows=8)
    u0 = jnp.float32(2.0 ** -24)
    z_a, z_b = (float(x) for x in jpk._boxmuller(u0, u0))
    z = np.empty((steps, 3, n), np.float32)
    z[0::2] = np.array([z_a, z_b, z_a], np.float32)[None, :, None]
    z[1::2] = np.array([z_b, z_a, z_b], np.float32)[None, :, None]
    if steps % 2:
        z[steps - 1] = np.array([z_a, z_b, z_a], np.float32)[:, None]
    s, d = phhw.hhw_terminal(pp, _SPOT, _T, None, num_paths=n,
                             num_steps=steps, draws=torch.from_numpy(z))
    for got, ref in ((s, s_ref), (d, d_ref)):
        ref = np.asarray(ref)
        assert (ref == ref[:, :1]).all()             # one path per branch
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5)


def _plain(pp, seed=11, n=1 << 12, steps=16, T=_T, **kw):
    before = dict(ck.launch_counts())
    out = ck.hhw_terminal(pp, _SPOT, T, seed, num_paths=n, num_steps=steps,
                          device="cpu", **kw)
    assert ck.launch_counts() == before        # a CPU device: no launch
    return [x.double().numpy() for x in out]


def _plain_normals(seed, steps, n):
    """The (steps, 3, n) normals K7's plain version draws, rebuilt from the
    layout its docstring states."""
    def words(call):
        return ck._pair_words(n, call, ck._HHW_DOMAIN, seed, "cpu")

    z = []
    for i in range(0, steps - 1, 2):
        a, c = words(i), words(i + 1)
        z_a, z_b = ck.box_muller(a[0], a[1])
        z_c, z_d = ck.box_muller(a[2], a[3])
        z_e, z_f = ck.box_muller(c[0], c[1])
        z += [torch.stack([z_a, z_b, z_c]), torch.stack([z_d, z_e, z_f])]
    if steps % 2:
        a = words(steps - 1)
        z.append(torch.stack([*ck.box_muller(a[0], a[1]),
                              ck.box_muller(a[2], a[3])[0]]))
    return torch.stack(z)


@pytest.mark.parametrize("steps", [16, 7])
@pytest.mark.parametrize("antithetic", [True, False])
def test_plain_equals_twin_on_its_own_philox_normals(steps, antithetic):
    """K7's plain version (what the card kernel is held bit-equal to) and
    the twin (pinned to the JAX scan above) on the same normals: S and D at
    rtol 2e-5, path by path, over an even and an odd step count. Ties the
    plain version's recursion and word layout to the reference term by
    term, not only by law."""
    _, pp = _both()
    n, seed = 2048, 11
    ref = phhw.hhw_terminal(pp, _SPOT, _T, None, num_paths=n, num_steps=steps,
                            antithetic=antithetic,
                            draws=_plain_normals(seed, steps, n))
    got = ck.hhw_terminal_plain(pp, _SPOT, _T, seed, num_paths=n,
                                num_steps=steps, antithetic=antithetic)
    for g, r in zip(got, ref):
        assert g.shape == (2 if antithetic else 1, n)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-5)


def test_plain_martingale_and_bond():
    """K7's plain version: E[D S_T] = S0 e^{-qT} within 4 se at any step
    count (exact discrete martingale) and E[D] within the left-point O(dt)
    allowance of `vasicek_bond` (4 se + 2e-3 at 16 steps over 2 years)."""
    _, pp = _both()
    s, d = _plain(pp)
    ds = (s * d).mean(axis=0)
    assert abs(ds.mean() - _SPOT * np.exp(-pp.q * _T)) \
        < 4 * ds.std() / np.sqrt(ds.size)
    dm = d.mean(axis=0)
    assert abs(dm.mean() - phhw.vasicek_bond(pp, _T)) \
        < 4 * dm.std() / np.sqrt(dm.size) + 2e-3


def test_plain_law_matches_twin_moments():
    """Plain version (Philox) and JAX scan (threefry): means of log S, of D
    and of D·(S-K)+ within 4 combined se."""
    jp, pp = _both()
    n, steps = 1 << 12, 16
    s, d = _plain(pp, n=n, steps=steps)
    s_j, d_j = (np.asarray(x, np.float64) for x in jhhw.hhw_terminal(
        jp, _SPOT, _T, jax.random.key(3), num_paths=n, num_steps=steps))
    for f in (lambda s, d: np.log(s), lambda s, d: d,
              lambda s, d: d * np.maximum(s - _SPOT, 0.0)):
        a, b = f(s, d).mean(axis=0), f(s_j, d_j).mean(axis=0)
        se = np.hypot(a.std(), b.std()) / np.sqrt(n)
        assert abs(a.mean() - b.mean()) < 4 * se


@pytest.mark.parametrize("T,steps", [(1.0, 16), (10.0, 16)])
def test_plain_frozen_variance_matches_bsm_hullwhite(T, steps):
    """xi -> 0 and theta = v0: GBM + Vasicek rates. The spot and rate steps
    are exact then; the left-point rate integral leaves an O(dt) bias,
    allowed 0.5 % of the price at 16 steps beside 4 se."""
    sig = 0.2
    _, pp = _both(xi=1e-4, theta=sig**2, v0=sig**2, rho_sv=0.0, rho_vr=0.0)
    s, d = _plain(pp, n=1 << 12, steps=steps, T=T)
    pay = (d * np.maximum(s - _SPOT, 0.0)).mean(axis=0)
    ref = phhw.bsm_hullwhite(pp, _SPOT, _SPOT, T, sig, True)
    assert abs(pay.mean() - ref) < 4 * pay.std() / np.sqrt(pay.size) \
        + 5e-3 * ref


def test_plain_common_random_numbers():
    """The normals depend on (seed, pair, step) only: with sigma_r tiny the
    rate path is deterministic, D is one number, and the spot stays within
    some percent of the stochastic-rates spot path by path (the integrated
    rate has a standard deviation of 2 % over these 2 years)."""
    _, pp = _both()
    s, _ = _plain(pp)
    s0, d0 = _plain(dataclasses.replace(pp, sigma_r=1e-8))
    assert d0.std() < 1e-6
    assert np.abs(s / s0 - 1.0).max() < 0.15
    assert np.abs(s / s0 - 1.0).mean() > 1e-4


def test_odd_and_single_branch_streams():
    """An odd step count takes the tail call; the single-branch launch is
    the base branch of the antithetic one."""
    _, pp = _both()
    a = _plain(pp, n=512, steps=7)
    b = _plain(pp, n=512, steps=7, antithetic=False)
    for x, y in zip(a, b):
        assert x.shape == (2, 512) and y.shape == (1, 512)
        np.testing.assert_array_equal(x[:1], y)
    assert np.isfinite(a[0]).all()


def test_hazard_correlation_matrix_not_positive_definite():
    """Each correlation within (-1, 1) does not make the matrix positive
    definite. The reference returns NaN on every path, silently; the port
    raises ValueError naming the three correlations, in the twin and in
    K7's wrapper alike."""
    bad = dict(rho_sv=-0.999, rho_sr=0.999, rho_vr=0.999)
    jp, pp = _both(**bad)
    s_ref, d_ref = jhhw.hhw_terminal(jp, _SPOT, _T, jax.random.key(0),
                                     num_paths=64, num_steps=4)
    assert bool(jnp.isnan(s_ref).all()) or bool(jnp.isnan(d_ref).all())
    for call in (
            lambda: phhw.hhw_cholesky(pp),
            lambda: phhw.hhw_terminal(pp, _SPOT, _T, None, num_paths=64,
                                      num_steps=4, device="cpu"),
            lambda: ck.hhw_terminal(pp, _SPOT, _T, 0, num_paths=64,
                                    num_steps=4, device="cpu")):
        with pytest.raises(ValueError, match="rho_sv.*rho_sr.*rho_vr"):
            call()
    chol = phhw.hhw_cholesky(_both()[1])
    np.testing.assert_allclose(chol @ chol.T, [[1, -0.6, 0.3], [-0.6, 1, 0.1],
                                               [0.3, 0.1, 1]], atol=1e-15)


def test_s_ou_keeps_the_reference_divisor():
    """`_hhw_consts` divides by max(2a, 1e-12), as the reference packs it."""
    _, pp = _both(a=1e-3)
    consts = ck._hhw_consts(pp, _SPOT, _T, 16)
    dt = _T / 16
    e = np.exp(-1e-3 * dt)
    assert consts[9] == np.float32(0.012 * np.sqrt((1 - e * e) / 2e-3))
    assert consts[8] == np.float32(e) and consts.shape == (17,)


def test_params_round_trip():
    jp, pp = _both()
    assert phhw.HHWParams.from_numpy(pp.to_numpy()) == pp
    assert phhw.HHWParams.from_numpy(
        {k: np.float64(v) for k, v in dataclasses.asdict(jp).items()}) == pp
    with pytest.raises(KeyError):
        phhw.HHWParams.from_numpy({"kappa": 1.0})


def test_engine_price_keys_and_law_against_jax():
    jp, pp = _both()
    kw = dict(num_paths=1 << 12, num_steps=16, seed=4)
    ref = JHHWEngine(jp, backend="scan", **kw).price(_SPOT, [90.0, 100.0],
                                                     _T)
    for backend in ("cuda", "torch"):
        got = HHWEngine(pp, backend=backend, device="cpu", **kw).price(
            _SPOT, [90.0, 100.0], _T)
        assert got.keys() == ref.keys()
        assert got["zero_coupon_exact"] == ref["zero_coupon_exact"]
        for i in range(2):
            se = np.hypot(got["std_error"][i], ref["std_error"][i])
            assert abs(got["price"][i] - ref["price"][i]) < 4 * se
    scalar = HHWEngine(pp, device="cpu", **kw).price(_SPOT, 100.0, _T)
    assert isinstance(scalar["price"], float)
    with pytest.raises(ValueError):
        HHWEngine(pp, backend="pallas", device="cpu")


def test_engine_greeks_against_jax_and_a_bump():
    """One autograd pass: same keys as the JAX engine, each Greek within
    MC noise of it (different streams), delta within 0.03 of a central
    difference of K7's plain price on one seed."""
    jp, pp = _both()
    kw = dict(num_paths=1 << 12, num_steps=16, seed=4)
    ref = JHHWEngine(jp, backend="scan", **kw).greeks(_SPOT, 100.0, _T)
    eng = HHWEngine(pp, device="cpu", **kw)
    got = eng.greeks(_SPOT, 100.0, _T)
    assert got.keys() == ref.keys()
    for k, tol in (("price", 0.06), ("delta", 0.06),
                   ("vega_per_vol_point", 0.15), ("rate_vega", 0.15),
                   ("rho_rate", 0.06)):
        assert abs(got[k] - ref[k]) < tol * abs(ref[k]), k
    h = 0.01 * _SPOT
    fd = (eng.price(_SPOT + h, 100.0, _T)["price"]
          - eng.price(_SPOT - h, 100.0, _T)["price"]) / (2 * h)
    assert abs(got["delta"] - fd) < 0.03


def test_engine_rate_vol_impact():
    jp, pp = _both()
    kw = dict(num_paths=1 << 12, num_steps=16, seed=4)
    ref = JHHWEngine(jp, backend="scan", **kw).rate_vol_impact(_SPOT, 100.0,
                                                               10.0)
    got = HHWEngine(pp, device="cpu", **kw).rate_vol_impact(_SPOT, 100.0,
                                                            10.0)
    assert got.keys() == ref.keys()
    # common random numbers: the spread is far tighter than the joint se
    assert got["stochastic_rates_premium"] > 0
    assert abs(got["stochastic_rates_premium"]
               - ref["stochastic_rates_premium"]) < 0.5 * got["std_error"]
