"""Slice N1's family drivers (`mcos_tpu_torch/parallel/families.py`) on the
CPU, each against the JAX package's sharded driver on a 4-device JAX mesh:
every port shard replays the draws of the JAX shard's `fold_in(key, i)`
key through the family twin's `draws=` (backend "torch" where the family
has a kernel, SVCJ, HHW and the time-dependent SVJ), and the pooled
price and standard error must agree at rtol 1e-5 (the SLV and lifted rough
Heston at the pins their unsharded ports keep against JAX, rtol 2e-4 and
1e-4: their particle and lifted paths part in float32). The SLV's shards
pool each step's bin statistics: shards fed column blocks of one normal
sheet reproduce the one-cloud run of that sheet. The engines' `mesh=`
routes give their sharded driver's result; a one-shard mesh gives the
unsharded engine's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.autocallable as jauto
import mcos_tpu.engine.basket as jbasket
import mcos_tpu.engine.localvol as jlv
import mcos_tpu.models.params as jparams
import mcos_tpu.ops.hhw as jhhw
import mcos_tpu.ops.levy as jlevy
import mcos_tpu.ops.rough as jrough
import mcos_tpu.ops.roughheston as jrh
import mcos_tpu.ops.tdsvj as jtd
from mcos_tpu.parallel import families as jfam
from mcos_tpu.parallel import mesh as jmesh
import mcos_tpu_torch.engine.autocallable as pauto
import mcos_tpu_torch.engine.basket as pbasket
import mcos_tpu_torch.engine.localvol as plv
import mcos_tpu_torch.ops.hhw as phhw
import mcos_tpu_torch.ops.levy as plevy
import mcos_tpu_torch.ops.rough as prough
import mcos_tpu_torch.ops.roughheston as prh
import mcos_tpu_torch.ops.tdsvj as ptd
from mcos_tpu_torch.engine.slv import slv_terminal
from mcos_tpu_torch.models.params import SVCJParams, SVJParams
from mcos_tpu_torch.parallel import families as pfam
from mcos_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

SPOT, T, STEPS, N, SEED = 100.0, 0.5, 12, 4096, 11
PPD = N // 4
STRIKES = [90.0, 100.0, 112.0]
_SVJ = dict(kappa=2.5, theta=0.05, xi=0.5, rho=-0.65, v0=0.045,
            lambda_j=1.5, mu_j=-0.06, sigma_j=0.12, r=0.05, q=0.01)
_CORR = [[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]]


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(jax.devices()[:4])


@pytest.fixture(scope="module")
def cpu4():
    return pmesh.make_mesh(["cpu"] * 4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _steps(key, steps, z_shape, u_shape=None):
    """Per step t: fold_in(key, t), then normal(z_shape) (and, with
    `u_shape`, a split first and uniform(u_shape)): a JAX scan's own
    draws, stacked over steps."""
    def one(t):
        k = jax.random.fold_in(key, t)
        if u_shape is None:
            return jax.random.normal(k, z_shape, jnp.float32)
        k_n, k_u = jax.random.split(k)
        return (jax.random.normal(k_n, z_shape, jnp.float32),
                jax.random.uniform(k_u, u_shape, jnp.float32))

    out = jax.vmap(one)(jnp.arange(steps))
    return tuple(map(_t, out)) if u_shape is not None else _t(out)


def _svj_steps(steps, n=PPD):
    return lambda k: _steps(k, steps, (3, n), (n,))


def _replay(fn, seed=SEED):
    key = jax.random.key(seed)
    return lambda i: fn(jax.random.fold_in(key, i))


def _close(got, ref, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=0, err_msg=what)


def _prices_close(got, ref, rtol=1e-5, keys=("price", "std_error")):
    for k in keys:
        _close(got[k], jax.device_get(ref[k]), rtol=rtol, what=k)


def _both_svj(**updates):
    f = dict(_SVJ, **updates)
    return jparams.SVJParams(**f), SVJParams(**f)


# ─────────────────────────────────────────────────────────────────────────────
# Single-asset families
# ─────────────────────────────────────────────────────────────────────────────
def test_svcj(jax_mesh, cpu4):
    fields = dict(_SVJ, mu_v=0.04, rho_j=-0.4)
    jp = jparams.SVCJParams(**fields)
    pp = SVCJParams(**fields)
    kw = dict(num_paths=N, num_steps=STEPS)
    ref = jfam.sharded_svcj_price(jp, SPOT, STRIKES, T, jax.random.key(SEED),
                                  mesh=jax_mesh, **kw)
    got = pfam.sharded_svcj_price(
        pp, SPOT, STRIKES, T, SEED, mesh=cpu4, backend="torch",
        shard_draws=_replay(lambda k: _steps(k, STEPS, (3, PPD),
                                             (2, PPD))), **kw)
    _prices_close(got, ref)
    _close(got["v_max"], ref["v_max"], rtol=2e-5)


@pytest.mark.parametrize("model", ["VGParams", "NIGParams"])
def test_levy(jax_mesh, cpu4, model):
    fields = {"sigma": 0.3, "nu": 0.4, "theta": -0.2, "r": 0.05, "q": 0.02}
    jp, pp = getattr(jlevy, model)(**fields), getattr(plevy, model)(**fields)

    def draws(key):
        k_a, k_z = jax.random.split(key)
        if model == "VGParams":
            return (_t(jax.random.gamma(k_a, jnp.float32(T) / jp.nu, (PPD,),
                                        jnp.float32)),
                    _t(jax.random.normal(k_z, (PPD,), jnp.float32)))
        k_n, k_u = jax.random.split(k_a)
        return (_t(jax.random.normal(k_n, (PPD,), jnp.float32)),
                _t(jax.random.uniform(k_u, (PPD,), jnp.float32)),
                _t(jax.random.normal(k_z, (PPD,), jnp.float32)))

    ref = jfam.sharded_levy_price(jp, SPOT, STRIKES, T, jax.random.key(SEED),
                                  mesh=jax_mesh, num_paths=N)
    got = pfam.sharded_levy_price(pp, SPOT, STRIKES, T, SEED, mesh=cpu4,
                                  num_paths=N, shard_draws=_replay(draws))
    _prices_close(got, ref)


def test_roughheston(jax_mesh, cpu4):
    fields = dict(lam=1.5, theta=0.04, nu=0.35, rho=-0.7, v0=0.04, r=0.05,
                  q=0.01)
    jp, pp = jrh.RoughHestonParams(**fields), prh.RoughHestonParams(**fields)
    kw = dict(num_paths=N, num_steps=64, n_factors=8)
    ref = jfam.sharded_roughheston_price(
        jp, SPOT, STRIKES, 0.25, jax.random.key(SEED), mesh=jax_mesh, **kw)
    got = pfam.sharded_roughheston_price(
        pp, SPOT, STRIKES, 0.25, SEED, mesh=cpu4,
        shard_draws=_replay(lambda k: _steps(k, 64, (2, PPD))), **kw)
    _prices_close(got, ref, rtol=1e-4)


def test_localvol(jax_mesh, cpu4):
    strikes = np.linspace(80.0, 120.0, 5)
    mats = np.array([0.25, 0.5, 1.0])
    k = np.log(strikes / SPOT)
    iv = 0.2 - 0.15 * k[None, :] + 0.2 * k[None, :] ** 2 \
        + 0.01 * np.sqrt(mats)[:, None]
    ps = plv.LocalVolSurface.from_iv_points(SPOT, strikes, mats, iv,
                                            r=0.05, q=0.01)
    js = jlv.LocalVolSurface.from_iv_points(SPOT, strikes, mats, iv,
                                            r=0.05, q=0.01)
    ref = jfam.sharded_localvol_price(js, SPOT, STRIKES, T,
                                      jax.random.key(SEED), mesh=jax_mesh,
                                      num_paths=N, num_steps=16)
    got = pfam.sharded_localvol_price(
        ps, SPOT, STRIKES, T, SEED, mesh=cpu4, num_paths=N, num_steps=16,
        shard_draws=_replay(lambda k: _steps(k, 16, (PPD,))))
    _prices_close(got, ref)


def test_cliquet_and_quanto(jax_mesh, cpu4):
    jp, pp = _both_svj()
    kw = dict(num_paths=N, n_periods=3, steps_per_period=4, local_cap=0.06,
              global_cap=0.12)
    ref = jfam.sharded_cliquet_price(jp, 1.0, jax.random.key(SEED),
                                     mesh=jax_mesh, **kw)
    got = pfam.sharded_cliquet_price(pp, 1.0, SEED, mesh=cpu4,
                                     shard_draws=_replay(_svj_steps(12)),
                                     **kw)
    _prices_close(got, ref)
    # β* = cov/var of a weakly correlated control (≈ −0.15 here): the
    # reference's float32 Σpc − ΣpΣc/n leaves it ~1e-5 off its own value.
    _close(got["cv_beta"], ref["cv_beta"], rtol=1e-4)
    args = (0.03, 0.1, -0.3, SPOT, 100.0, T)
    ref = jfam.sharded_quanto_price(jp, *args, jax.random.key(SEED),
                                    mesh=jax_mesh, num_paths=N,
                                    num_steps=STEPS, fx_fixed=1.5)
    got = pfam.sharded_quanto_price(pp, *args, SEED, mesh=cpu4, num_paths=N,
                                    num_steps=STEPS, fx_fixed=1.5,
                                    shard_draws=_replay(_svj_steps(STEPS)))
    _prices_close(got, ref, keys=("price", "std_error", "cv_beta"))


def test_variance_swap(jax_mesh, cpu4):
    jp, pp = _both_svj()
    ref = jfam.sharded_variance_swap(jp, T, jax.random.key(SEED),
                                     mesh=jax_mesh, num_paths=N,
                                     num_steps=STEPS)
    got = pfam.sharded_variance_swap(pp, T, SEED, mesh=cpu4, num_paths=N,
                                     num_steps=STEPS,
                                     shard_draws=_replay(_svj_steps(STEPS)))
    assert got.keys() == ref.keys()
    for k in ("mc_fair_variance", "mc_std_error"):
        _close(got[k], ref[k], what=k)
    for k in ("fair_variance", "diffusion_leg", "jump_leg"):
        _close(got[k], ref[k], rtol=1e-12, what=k)


def test_rough_bergomi_exact_sampler(jax_mesh, cpu4):
    fields = dict(xi=0.04, eta=1.9, rho=-0.9, r=0.05, q=0.01, hurst=0.1)
    jp = jrough.RoughBergomiParams(**fields)
    pp = prough.RoughBergomiParams(**fields)
    ref = jfam.sharded_rough_price(jp, SPOT, STRIKES, T, jax.random.key(SEED),
                                   mesh=jax_mesh, num_paths=N, num_steps=16)
    got = pfam.sharded_rough_price(
        pp, SPOT, STRIKES, T, SEED, mesh=cpu4, num_paths=N, num_steps=16,
        shard_draws=_replay(lambda k: _t(
            jax.random.normal(k, (PPD, 32), jnp.float32))))
    _prices_close(got, ref)


def test_hhw(jax_mesh, cpu4):
    fields = dict(kappa=2.0, theta=0.05, xi=0.4, v0=0.04, a=0.1, b=0.05,
                  sigma_r=0.012, r0=0.05, rho_sv=-0.6, rho_sr=0.3,
                  rho_vr=0.1, q=0.01)
    jp, pp = jhhw.HHWParams(**fields), phhw.HHWParams(**fields)
    ref = jfam.sharded_hhw_price(jp, SPOT, STRIKES, 2.0, jax.random.key(SEED),
                                 mesh=jax_mesh, num_paths=N, num_steps=16)
    got = pfam.sharded_hhw_price(
        pp, SPOT, STRIKES, 2.0, SEED, mesh=cpu4, num_paths=N, num_steps=16,
        backend="torch", shard_draws=_replay(lambda k: _steps(
            k, 16, (3, PPD))))
    _prices_close(got, ref)


def test_time_dependent_svj(jax_mesh, cpu4):
    jp, pp = _both_svj()
    seg = ([0.25, 0.5], [0.04, 0.07], [0.3, 0.6], [1.0, 3.0])
    th, xi, lam = ptd.step_param_arrays(*map(np.asarray, seg), T, STEPS)
    jarr = jtd.step_param_arrays(*map(np.asarray, seg), T, STEPS)
    ref = jfam.sharded_td_price(jp, *jarr, SPOT, STRIKES, T,
                                jax.random.key(SEED), mesh=jax_mesh,
                                num_paths=N, num_steps=STEPS)
    got = pfam.sharded_td_price(pp, th, xi, lam, SPOT, STRIKES, T, SEED,
                                mesh=cpu4, num_paths=N, num_steps=STEPS,
                                backend="torch",
                                shard_draws=_replay(_svj_steps(STEPS)))
    _prices_close(got, ref, keys=("price", "std_error", "bs_ref"))


# ─────────────────────────────────────────────────────────────────────────────
# Multi-asset families
# ─────────────────────────────────────────────────────────────────────────────
def _asset_params(n=3):
    fs = [dict(_SVJ, v0=0.03 + 0.01 * i, r=0.05) for i in range(n)]
    return ([jparams.SVJParams(**f) for f in fs], [SVJParams(**f) for f in fs])


def test_worstof_autocall(jax_mesh, cpu4):
    jps, pps = _asset_params()
    jeng = jauto.WorstOfAutocallableEngine(jps, _CORR, num_paths=N,
                                           steps_per_period=4)
    peng = pauto.WorstOfAutocallableEngine(pps, _CORR, num_paths=N,
                                           steps_per_period=4, device="cpu")
    kw = dict(n_obs=3, coupon=0.03, protection_barrier=0.65)
    ref = jax.device_get(jfam.sharded_worstof_autocall(
        jeng, 1.0, jax.random.key(SEED), mesh=jax_mesh, **kw))
    got = pfam.sharded_worstof_autocall(
        peng, 1.0, SEED, mesh=cpu4,
        shard_draws=_replay(lambda k: _steps(k, 12, (3, 3, PPD), (3, PPD))),
        **kw)
    _prices_close(got, ref)
    for k in ("call_prob_by_date", "survival_prob", "loss_prob"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7)
    _close(got["expected_life"], ref["expected_life"])


def test_basket(jax_mesh, cpu4):
    jps, pps = _asset_params()
    jeng = jbasket.BasketEngine(jps, _CORR, num_paths=N, num_steps=24)
    peng = pbasket.BasketEngine(pps, _CORR, num_paths=N, num_steps=24,
                                device="cpu")
    args = ([100.0, 95.0, 105.0], [0.3, 0.3, 0.4], 100.0, T)
    ref = jfam.sharded_basket_price(jeng, *args, jax.random.key(SEED),
                                    mesh=jax_mesh)
    got = pfam.sharded_basket_price(
        peng, *args, SEED, mesh=cpu4,
        shard_draws=_replay(lambda k: _steps(k, 12, (3, 3, PPD), (3, PPD))))
    assert got.keys() == ref.keys() and got["num_steps"] == ref["num_steps"]
    _prices_close(got, ref, keys=("price", "std_error", "cv_beta"))


# ─────────────────────────────────────────────────────────────────────────────
# SLV: one cloud across the shards
# ─────────────────────────────────────────────────────────────────────────────
def _slv_setup():
    strikes = np.linspace(70.0, 130.0, 13)
    mats = np.array([0.25, 0.5, 1.0])
    k = np.log(strikes / SPOT)
    iv = np.tile(0.2 - 0.15 * k + 0.2 * k ** 2, (3, 1))
    surf = plv.LocalVolSurface.from_iv_points(SPOT, strikes, mats, iv,
                                              r=0.05, q=0.01)
    heston = SVJParams(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04,
                       lambda_j=0.0, sigma_j=1e-4, r=0.05, q=0.01)
    return surf, heston


def test_slv_pooled_cloud_matches_jax(jax_mesh, cpu4):
    surf, heston = _slv_setup()
    rows, t_mid = surf.step_tables(T, 16)
    y0, dy = float(surf.y_grid[0]), float(surf.y_grid[1] - surf.y_grid[0])
    ref = jfam.sharded_slv_price(
        jparams.SVJParams(**heston.to_numpy()), rows, t_mid, y0, dy, SPOT,
        STRIKES, T, jax.random.key(SEED), mesh=jax_mesh, num_paths=N,
        num_steps=16)
    got = pfam.sharded_slv_price(
        heston, rows, t_mid, y0, dy, SPOT, STRIKES, T, SEED, mesh=cpu4,
        num_paths=N, num_steps=16,
        shard_draws=_replay(lambda k: _steps(k, 16, (2, PPD))))
    _prices_close(got, ref, rtol=2e-4)


def test_slv_shards_are_one_cloud(cpu4):
    """Four shards fed the column blocks of one (steps, 2, 4·ppd) sheet
    step as the one cloud of that sheet: their pooled bin statistics are
    the whole cloud's (summed in another order, so a particle near a bin
    edge may land on the other side). Their call prices sit within 0.1 se
    of the one cloud's; four clouds that do not pool miss the wing by
    several se (the small-cloud flattening of E[v | S])."""
    from mcos_tpu_torch.ops.simulate import combine_antithetic

    surf, heston = _slv_setup()
    steps, ppd = 8, 512
    rows, t_mid = surf.step_tables(T, steps)
    y0, dy = float(surf.y_grid[0]), float(surf.y_grid[1] - surf.y_grid[0])
    sheet = torch.randn((steps, 2, 4 * ppd),
                        generator=torch.Generator().manual_seed(5))
    whole = slv_terminal(heston, rows, t_mid, y0, dy, SPOT, T,
                         normals=sheet)
    shards = pmesh.mesh_shards(cpu4, 0, shard_draws=lambda
                               i: sheet[:, :, i * ppd:(i + 1) * ppd])
    pooled = torch.cat(pmesh.run_lockstep(
        lambda shard, pool: slv_terminal(heston, rows, t_mid, y0, dy, SPOT,
                                         T, normals=shard.draws, pool=pool),
        shards), dim=1)
    alone = torch.cat([slv_terminal(heston, rows, t_mid, y0, dy, SPOT, T,
                                    normals=s.draws) for s in shards], dim=1)

    def call(s, k):
        pay = combine_antithetic(torch.clamp(s - k, min=0.0))
        return float(pay.mean()), float(pay.std()) / np.sqrt(pay.numel())

    for k in (80.0, 100.0, 120.0, 130.0):
        ref, se = call(whole, k)
        assert abs(call(pooled, k)[0] - ref) < 0.1 * se, k
    ref, se = call(whole, 120.0)
    assert abs(call(alone, 120.0)[0] - ref) > 2.0 * se
    # One shard with the hook is the unpooled run, bit for bit.
    one = pmesh.run_lockstep(
        lambda shard, pool: slv_terminal(heston, rows, t_mid, y0, dy, SPOT,
                                         T, normals=sheet, pool=pool),
        pmesh.mesh_shards(pmesh.make_mesh(["cpu"]), 0))[0]
    torch.testing.assert_close(one, whole, rtol=0, atol=0)


# ─────────────────────────────────────────────────────────────────────────────
# Engine routes: mesh= gives the driver's result; one shard, the engine's
# ─────────────────────────────────────────────────────────────────────────────
def test_engine_mesh_routes(cpu4):
    from mcos_tpu_torch.engine.cliquet import CliquetEngine
    from mcos_tpu_torch.engine.quanto import QuantoEngine
    from mcos_tpu_torch.engine.roughheston import RoughHestonEngine
    from mcos_tpu_torch.engine.svcj import SVCJEngine
    from mcos_tpu_torch.engine.termsvj import TDSVJEngine
    from mcos_tpu_torch.engine.volderivs import VolDerivsEngine

    one = pmesh.make_mesh(["cpu"])
    _, pp = _both_svj()
    _, pps = _asset_params()
    cases = [
        (lambda m: SVCJEngine(SVCJParams(**_SVJ), num_paths=1000,
                              num_steps=16, mesh=m, device="cpu"),
         lambda e: e.price(SPOT, 100.0, T), "price"),
        (lambda m: TDSVJEngine(pp, [0.5], [0.05], [0.5], [1.5],
                               num_paths=1000, num_steps=8, mesh=m,
                               control_variate=False, device="cpu"),
         lambda e: e.price(SPOT, 100.0, T), "price"),
        (lambda m: plv.LocalVolEngine(plv.LocalVolSurface.flat(0.2),
                                      num_paths=1000, num_steps=32, mesh=m,
                                      device="cpu"),
         lambda e: e.price(SPOT, 100.0, T), "price"),
        (lambda m: RoughHestonEngine(prh.RoughHestonParams(), num_paths=500,
                                     num_steps=1024, n_factors=6, mesh=m,
                                     device="cpu"),
         lambda e: e.price(SPOT, 100.0, 0.25), "price"),
        (lambda m: QuantoEngine(pp, 0.03, 0.1, -0.3, num_paths=1000,
                                num_steps=8, mesh=m, device="cpu"),
         lambda e: e.price(SPOT, 100.0, T), "price"),
        (lambda m: CliquetEngine(pp, num_paths=1000, steps_per_period=4,
                                 mesh=m, device="cpu"),
         lambda e: e.price_cliquet(1.0), "price"),
        (lambda m: pauto.WorstOfAutocallableEngine(
            pps, _CORR, num_paths=1000, steps_per_period=4, mesh=m,
            device="cpu"), lambda e: e.price(1.0), "price"),
        (lambda m: pbasket.BasketEngine(pps, _CORR, num_paths=1000,
                                        num_steps=16, mesh=m, device="cpu"),
         lambda e: e.price([100.0] * 3, [1 / 3] * 3, 100.0, T), "price"),
        (lambda m: VolDerivsEngine(pp, num_paths=1000, num_steps=16, mesh=m,
                                   device="cpu"),
         lambda e: e.variance_swap(T), "mc_fair_variance"),
    ]
    for build, run, key in cases:
        single = run(build(None))
        sharded_one = run(build(one))
        assert sharded_one[key] == pytest.approx(single[key], rel=1e-6), key
        four = run(build(cpu4))
        assert four[key] != sharded_one[key], key     # the other shards
        assert abs(four[key] - single[key]) < 6 * max(
            single.get("std_error", single.get("mc_std_error")), 1e-9), key
    gen = torch.Generator().manual_seed(3)
    vg = plevy.VGParams()
    got = plevy.levy_price_mc(vg, SPOT, STRIKES, T, gen, num_paths=1000,
                              mesh=one, device="cpu")
    ref = plevy.levy_price_mc(vg, SPOT, STRIKES, T,
                              torch.Generator().manual_seed(3),
                              num_paths=1000, device="cpu")
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0)


def test_levy_mesh_takes_an_undrawn_generator(cpu4, monkeypatch):
    """`levy_price_mc` seeds a mesh's shards from the generator's seed, not
    its state: a generator that has drawn is refused by an explicit mesh
    (it would restart its stream), and the MCOS_AUTO_MESH toggle's mesh
    leaves such a call, or one without a generator, on one device."""
    from mcos_tpu_torch.engine import pricer as ppricer

    vg = plevy.VGParams()
    kw = dict(num_paths=1000, device="cpu")
    used = torch.Generator().manual_seed(3)
    torch.randn(4, generator=used)
    with pytest.raises(ValueError, match="not drawn"):
        plevy.levy_price_mc(vg, SPOT, STRIKES, T, used, mesh=cpu4, **kw)
    with pytest.raises(ValueError, match="not drawn"):
        plevy.levy_price_mc(vg, SPOT, STRIKES, T, None, mesh=cpu4, **kw)
    monkeypatch.setattr(ppricer, "_AUTO_MESH", [cpu4])
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    state = used.get_state()
    got = plevy.levy_price_mc(vg, SPOT, STRIKES, T, used, **kw)
    used.set_state(state)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    ref = plevy.levy_price_mc(vg, SPOT, STRIKES, T, used, **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # A fresh generator under the toggle: the 4-shard driver.
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    got = plevy.levy_price_mc(vg, SPOT, STRIKES, T,
                              torch.Generator().manual_seed(3), **kw)
    ref = pfam.sharded_levy_price(vg, SPOT, STRIKES, T, 3, mesh=cpu4,
                                  num_paths=1000)
    torch.testing.assert_close(got[0], ref["price"], rtol=0, atol=0)
