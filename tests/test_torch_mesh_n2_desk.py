"""Slice N2 of the port's mesh on the CPU, part 3: the desk's sharded
programs, `sharded_portfolio_returns` with `portfolio_var(mesh=...)`,
`sharded_exposure_profile` and `sharded_basket_bounds`, against the JAX
package's sharded programs on a 4-device JAX mesh, each port shard fed
the JAX shard's `fold_in(key, i)` draws (`shard_draws=`); n shards against
their shards run alone, and one shard against the unsharded engine.

Tolerances, stated per check:
- portfolio moments and tails on replayed draws: rtol 1e-5 beside atol
  1e-6 × the scale of a return (a return is a difference of two
  terminals, each within 1e-5);
- the exposure profile: rtol 1e-4 beside atol 1e-5 × the largest EE, the
  tolerance tests/test_torch_desk.py holds the unsharded profile to (the
  closed-form revaluations round apart in float32);
- the basket bracket trains float32 regressions, whose flips move both
  bounds: each within half its standard error, as
  tests/test_torch_basket_american.py holds the unsharded bracket's
  parts; one shard against the unsharded bracket, rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.basket as jbasket
import mcos_tpu.engine.exposure as jexposure
import mcos_tpu.engine.risk as jrisk
import mcos_tpu_torch.engine.basket as pbasket
import mcos_tpu_torch.engine.basket_american as pba
import mcos_tpu_torch.engine.exposure as pexposure
import mcos_tpu_torch.engine.risk as prisk
from mcos_tpu.models import params as jparams
from mcos_tpu.parallel import mesh as jmesh
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models import params as pparams
from mcos_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

_FIELDS = dict(kappa=2.5, theta=0.05, xi=0.5, rho=-0.65, v0=0.045,
               lambda_j=1.5, mu_j=-0.06, sigma_j=0.12, r=0.05, q=0.01)
SPOT, T, SEED = 100.0, 0.5, 7


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(jax.devices()[:4])


@pytest.fixture(scope="module")
def cpu4():
    return pmesh.make_mesh(["cpu"] * 4)


def _both():
    return (jparams.SVJParams(**_FIELDS), pparams.SVJParams(**_FIELDS))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rtol=1e-5, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _fold(seed):
    key = jax.random.key(seed)
    return lambda i: jax.random.fold_in(key, i)


# ─────────────────────────────────────────────────────────────────────────────
# sharded_portfolio_returns and portfolio_var(mesh=...)
# ─────────────────────────────────────────────────────────────────────────────
PSPOTS, PSIG = [100.0, 50.0, 80.0], [0.2, 0.3, 0.25]
PCORR = np.array([[1.0, 0.3, 0.2], [0.3, 1.0, 0.4], [0.2, 0.4, 1.0]])
PW = [0.5, 0.3, 0.2]


def _gbm_normals(key, steps, n, assets=3):
    return _t(jax.vmap(lambda t: jax.random.normal(
        jax.random.fold_in(key, t), (n, assets), jnp.float32))(
        jnp.arange(steps)))


def test_sharded_portfolio_returns_matches_jax(jax_mesh, cpu4):
    n, steps, quota = 8192, 4, 40
    kw = dict(num_paths=n, num_steps=steps, r=0.05, q=0.01,
              tail_quota=quota)
    ref = jax.device_get(jmesh.sharded_portfolio_returns(
        PSPOTS, PSIG, PCORR, PW, 0.25, jax.random.key(SEED), mesh=jax_mesh,
        **kw))
    fold = _fold(SEED)
    got = pmesh.sharded_portfolio_returns(
        PSPOTS, PSIG, PCORR, PW, 0.25, SEED, mesh=cpu4,
        shard_draws=lambda i: _gbm_normals(fold(i), steps, n // 4), **kw)
    scale = float(np.sqrt(ref["sum2"] / ref["n"]))
    assert float(got["n"]) == float(ref["n"]) == n
    for k in (1, 2, 3, 4):
        _close(got[f"sum{k}"], ref[f"sum{k}"], rtol=1e-5,
               atol=1e-6 * n * scale ** k, what=f"sum{k}")
    assert got["tail"].shape == (4 * quota,)
    _close(got["tail"], ref["tail"], rtol=1e-5, atol=1e-6 * scale)


def test_portfolio_var_mesh_pools_its_shards(cpu4):
    """portfolio_var over 4 shards: the tail and moments of the shards run
    alone; one shard on the generator's seed is the unsharded returns'
    mean and std; a drawn generator or replayed draws refuse a mesh."""
    kw = dict(num_paths=4096, num_steps=4, confidence=0.99)
    got = prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25,
                              seeded_generator(3, "cpu"), mesh=cpu4,
                              device="cpu", **kw)
    jref = jrisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25,
                               jax.random.key(3), num_paths=4096,
                               num_steps=4, mesh=jmesh.make_mesh(
                                   jax.devices()[:4]))
    assert got.keys() == jref.keys() and got["num_devices"] == 4
    parts = [pmesh.sharded_portfolio_returns(
        PSPOTS, PSIG, PCORR, PW, 0.25, pmesh.shard_seed(3, i),
        mesh=pmesh.make_mesh(["cpu"]), num_paths=1024, num_steps=4, r=0.065,
        q=0.012, tail_quota=10_000) for i in range(4)]
    tail = np.sort(np.concatenate([p["tail"].numpy() for p in parts]))
    k = int(4096 * 0.01)
    assert got["var"] == pytest.approx(-float(tail[k]), rel=1e-6)
    assert got["cvar"] == pytest.approx(-float(tail[:k].mean()), rel=1e-6)
    one = prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25,
                              seeded_generator(3, "cpu"),
                              mesh=pmesh.make_mesh(["cpu"]), device="cpu",
                              **kw)
    ref = prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25,
                              seeded_generator(3, "cpu"), device="cpu", **kw)
    _close(one["mean"], ref["mean"], rtol=1e-4)
    _close(one["std"], ref["std"], rtol=1e-5)
    gen = seeded_generator(3, "cpu")
    torch.rand(1, generator=gen)
    with pytest.raises(ValueError, match="has not drawn"):
        prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25, gen, mesh=cpu4,
                            device="cpu", **kw)


def test_portfolio_var_implicit_mesh_leaves_replays_on_one_device(
        monkeypatch):
    """mesh=None on a host of several CUDA devices takes every device, as
    the JAX package does, but replayed draws or a generator that has
    drawn then leave the call on one device (their unsharded result)
    instead of raising; an explicit mesh still raises. Three cards are
    stood in for: the sharded driver is recorded, not run, and the
    one-device path runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    meshes, real_gbm = [], prisk.multi_asset_gbm_terminal
    monkeypatch.setattr(prisk, "_sharded_portfolio_var",
                        lambda *a: meshes.append(a[-2]) or {"sharded": 1})
    monkeypatch.setattr(prisk, "multi_asset_gbm_terminal",
                        lambda *a, device, **k: real_gbm(*a, device="cpu",
                                                         **k))
    kw = dict(num_paths=1024, num_steps=4, confidence=0.99)
    assert prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25,
                               seeded_generator(3, "cpu"), device="cuda",
                               **kw) == {"sharded": 1}
    assert meshes[0].devices == tuple(torch.device("cuda", i)
                                      for i in range(3))
    draws = torch.randn((4, 1024, 3), generator=seeded_generator(5, "cpu"))
    got = prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25, draws=draws,
                              device="cuda", **kw)
    assert got == prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25,
                                      draws=draws, device="cpu", **kw)
    gen, ref_gen = seeded_generator(3, "cpu"), seeded_generator(3, "cpu")
    torch.rand(1, generator=gen)
    torch.rand(1, generator=ref_gen)
    got = prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25, gen,
                              device="cuda", **kw)
    assert got == prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25, ref_gen,
                                      device="cpu", **kw)
    assert len(meshes) == 1
    monkeypatch.undo()
    with pytest.raises(ValueError, match="cannot be sharded"):
        prisk.portfolio_var(PSPOTS, PSIG, PCORR, PW, 0.25, draws=draws,
                            mesh=pmesh.make_mesh(["cpu"] * 2), device="cpu",
                            **kw)


# ─────────────────────────────────────────────────────────────────────────────
# sharded_exposure_profile
# ─────────────────────────────────────────────────────────────────────────────
XBOOK = [{"kind": "call", "strike": 100.0, "T": 1.0, "qty": 1.0, "asset": 0},
         {"kind": "put", "strike": 50.0, "T": 0.5, "qty": -2.0, "asset": 1},
         {"kind": "forward", "strike": 95.0, "T": 0.75, "qty": 0.5,
          "asset": 0}]
XARGS = ([100.0, 50.0], [0.25, 0.35], [[1.0, 0.5], [0.5, 1.0]], XBOOK)


def _date_normals(key, dates, n, assets=2):
    return _t(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (n, assets), jnp.float32))
        for i in range(dates)]))


def test_sharded_exposure_matches_jax(jax_mesh, cpu4):
    n, dates = 4096, 6
    jeng = jexposure.ExposureEngine(*XARGS, r=0.05, num_paths=n, seed=SEED)
    peng = pexposure.ExposureEngine(*XARGS, r=0.05, num_paths=n, seed=SEED,
                                    device="cpu")
    fold = _fold(SEED)
    for q in (0.975, 0.9):
        ref = jmesh.sharded_exposure_profile(jeng, mesh=jax_mesh,
                                             num_dates=dates, quantile=q)
        got = pmesh.sharded_exposure_profile(
            peng, mesh=cpu4, num_dates=dates, quantile=q,
            shard_draws=lambda i: _date_normals(fold(i), dates, n // 4))
        assert got.keys() == ref.keys()
        scale = max(ref["ee"])
        for k in ("ee", "ene", "pfe", "gross_ee", "epe", "ene_avg",
                  "netting_benefit"):
            _close(got[k], ref[k], rtol=1e-4, atol=1e-5 * scale, what=k)
        assert got["num_paths_used"] == ref["num_paths_used"] == n


def test_sharded_exposure_one_shard_is_the_engine():
    """One shard on the engine's seed: the engine's EE, ENE and gross
    profile (rtol 1e-6), and its PFE the k-th largest exposure of the
    engine's own paths (the sharded PFE is an order statistic where the
    engine interpolates); 4 shards: the mean of their shards run alone."""
    peng = pexposure.ExposureEngine(*XARGS, r=0.05, num_paths=2000,
                                    seed=SEED, device="cpu")
    got = pmesh.sharded_exposure_profile(peng, mesh=pmesh.make_mesh(["cpu"]),
                                         num_dates=5)
    ref = peng.profile(num_dates=5)
    for k in ("ee", "ene", "gross_ee", "epe", "ene_avg", "netting_benefit"):
        _close(got[k], ref[k], rtol=1e-6, atol=1e-7, what=k)
    net, _, _ = peng._values(peng._dates(5, None))
    pos = np.sort(np.maximum(net.numpy(), 0.0), axis=1)[:, ::-1]
    k = int(np.ceil((1.0 - 0.975) * 2000))
    _close(got["pfe"], pos[:, k - 1], rtol=0)
    # 4 shards: the mean of their one-shard profiles (each an engine on
    # the shard's seed).
    four = pmesh.sharded_exposure_profile(
        peng, mesh=pmesh.make_mesh(["cpu"] * 4), num_dates=5)
    alone = [pmesh.sharded_exposure_profile(pexposure.ExposureEngine(
        *XARGS, r=0.05, num_paths=500, seed=pmesh.shard_seed(SEED, i),
        device="cpu"), mesh=pmesh.make_mesh(["cpu"]), num_dates=5)
        for i in range(4)]
    for k in ("ee", "ene", "gross_ee"):
        _close(four[k], np.mean([a[k] for a in alone], axis=0), rtol=1e-6,
               atol=1e-7, what=k)


# ─────────────────────────────────────────────────────────────────────────────
# sharded_basket_bounds
# ─────────────────────────────────────────────────────────────────────────────
BFIELDS = [dict(kappa=3.0, theta=0.04, xi=0.3, rho=-0.5, v0=0.04,
                lambda_j=0.5, mu_j=-0.03, sigma_j=0.05, r=0.05, q=0.02),
           dict(kappa=1.5, theta=0.06, xi=0.5, rho=-0.7, v0=0.05,
                lambda_j=1.0, mu_j=-0.05, sigma_j=0.1, r=0.04, q=0.0)]
BCORR = np.array([[1.0, 0.3], [0.3, 1.0]])
BSPOTS, BK, BT, N_EX, SPP = [100.0, 95.0], 100.0, 1.0, 3, 2


def _sheet(key, steps, n, a=2):
    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (3, a, n), jnp.float32),
                jax.random.uniform(k_u, (a, n), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return _t(z), _t(u)


def _inner(k_inner, half, P, a=2):
    def one(k, j):
        kn, ku = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(k_inner, k), j))
        return (jax.random.normal(kn, (3, half, a, P), jnp.float32),
                jax.random.uniform(ku, (half, a, P), jnp.float32))

    z, u = jax.vmap(lambda k: jax.vmap(lambda j: one(k, j))(
        jnp.arange(SPP)))(jnp.arange(N_EX, dtype=jnp.int32))
    return _t(z), _t(u)


def test_sharded_basket_bounds_matches_jax(jax_mesh, cpu4):
    n, n_outer, n_inner = 2000, 64, 8
    jeng = jbasket.BasketEngine([jparams.SVJParams(**f) for f in BFIELDS],
                                BCORR, num_paths=n, seed=SEED)
    peng = pbasket.BasketEngine([pparams.SVJParams(**f) for f in BFIELDS],
                                BCORR, num_paths=n, seed=SEED, device="cpu")
    k_train, k_eval, k_dual = jax.random.split(jax.random.key(SEED), 3)
    steps = N_EX * SPP
    peng._draws = lambda k, s: _sheet(k_train, s, n) if k == 0 else None

    def shard_draws(i):
        k_outer, k_inner = jax.random.split(jax.random.fold_in(k_dual, i))
        return (_sheet(jax.random.fold_in(k_eval, i), steps, n // 4),
                (_sheet(k_outer, steps, n_outer // 4),
                 _inner(k_inner, n_inner // 2, n_outer // 2)))

    kw = dict(kind="max", n_ex=N_EX, steps_per_period=SPP, n_outer=n_outer,
              n_inner=n_inner)
    ref = jmesh.sharded_basket_bounds(jeng, BSPOTS, BK, BT, mesh=jax_mesh,
                                      **kw)
    got = pmesh.sharded_basket_bounds(peng, BSPOTS, BK, BT, mesh=cpu4,
                                      shard_draws=shard_draws, **kw)
    assert got.keys() == ref.keys()
    assert abs(got["lower_bound"] - ref["lower_bound"]) \
        < 0.5 * ref["lower_se"]
    assert abs(got["upper_bound"] - ref["upper_bound"]) \
        < 0.5 * ref["upper_se"]
    for k in ("n_exercise", "n_outer", "n_inner", "num_devices"):
        assert got[k] == ref[k], k


def test_sharded_basket_bounds_one_shard_is_the_bracket():
    peng = pbasket.BasketEngine([pparams.SVJParams(**f) for f in BFIELDS],
                                BCORR, num_paths=1000, seed=SEED,
                                device="cpu")
    kw = dict(kind="max", n_ex=N_EX, steps_per_period=SPP, n_outer=32,
              n_inner=8)
    got = pmesh.sharded_basket_bounds(peng, BSPOTS, BK, BT,
                                      mesh=pmesh.make_mesh(["cpu"]), **kw)
    ref = pba.price_bounds_basket(peng, BSPOTS, BK, BT, **kw)
    for k in ("lower_bound", "lower_se", "upper_bound", "upper_se"):
        _close(got[k], ref[k], rtol=1e-6, what=k)
