"""Slice N2 of the port's mesh on the CPU, part 2: `sharded_mlmc_price`
and `sharded_pde_chain` against the JAX package's sharded programs on a
4-device JAX mesh, each port shard fed the JAX shard's `fold_in(key, i)`
draws (`shard_draws=`); n shards against their shards run alone, and one
shard against the unsharded engine. Part 3 is
tests/test_torch_mesh_n2_desk.py.

Tolerances, stated per check:
- MLMC levels on replayed draws: rtol 1e-5, and the same level counts;
- the PDE chain: rel 1e-4 beside abs 1e-6, tests/test_torch_pde.py's pin
  of the unsharded ADI engine; against the port's own engine, exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.pde as jpde
import mcos_tpu_torch.engine.pde as ppde
from mcos_tpu.models import params as jparams
from mcos_tpu.parallel import mesh as jmesh
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


# ─────────────────────────────────────────────────────────────────────────────
# sharded_mlmc_price
# ─────────────────────────────────────────────────────────────────────────────
def _mlmc_draws(params, seed, n_dev, base_steps, Tm):
    """shard_draws(level, n, i) for the JAX sharded MLMC's key tree:
    fold_in(fold_in(key(seed), level·1000 + n % 997), i), then the level
    program's own per-step splits (tests/test_torch_mlmc.py's layout)."""
    root = jax.random.key(seed)
    lam = jnp.asarray(params.lambda_j, jnp.float32)

    def jumps(key, lam_dt, n):
        kc, kz = jax.random.split(key)
        return (jax.random.poisson(kc, lam_dt, (n,)).astype(jnp.float32),
                jax.random.normal(kz, (n,), jnp.float32))

    def draws(level, n, i):
        key = jax.random.fold_in(jax.random.fold_in(
            root, level * 1000 + n % 997), i)
        ppd = n // n_dev
        if level == 0:
            lam_dt = lam * (jnp.asarray(Tm, jnp.float32) / base_steps)

            def one(t):
                kn, kj = jax.random.split(jax.random.fold_in(key, t))
                return (jax.random.normal(kn, (2, ppd), jnp.float32),
                        *jumps(kj, lam_dt, ppd))
            return [_t(x) for x in jax.vmap(one)(jnp.arange(base_steps))]
        steps = base_steps * 2 ** (level - 1)
        lam_dt = lam * (jnp.asarray(Tm, jnp.float32) / (2 * steps))

        def one(t):
            ka, kb, kja, kjb = jax.random.split(jax.random.fold_in(key, t),
                                                4)
            return (jax.random.normal(ka, (2, ppd), jnp.float32),
                    jax.random.normal(kb, (2, ppd), jnp.float32),
                    *jumps(kja, lam_dt, ppd), *jumps(kjb, lam_dt, ppd))
        return [_t(x) for x in jax.vmap(one)(jnp.arange(steps))]
    return draws


def test_sharded_mlmc_matches_jax(jax_mesh, cpu4):
    jp, pp = _both()
    kw = dict(eps=2.0, base_steps=4, max_levels=3, pilot_paths=1024,
              seed=SEED)
    ref = jmesh.sharded_mlmc_price(jp, SPOT, 100.0, T, mesh=jax_mesh, **kw)
    got = pmesh.sharded_mlmc_price(
        pp, SPOT, 100.0, T, mesh=cpu4,
        shard_draws=_mlmc_draws(jp, SEED, 4, 4, T), **kw)
    assert got.keys() == ref.keys()
    for k in ("num_levels", "fine_steps", "total_path_steps",
              "num_devices"):
        assert got[k] == ref[k], k
    assert [lv["n"] for lv in got["levels"]] == \
        [lv["n"] for lv in ref["levels"]]
    for k in ("price", "std_error", "bias_estimate"):
        _close(got[k], ref[k], rtol=1e-5, what=k)


def test_sharded_mlmc_one_shard_is_mlmc_price_and_levels_pool():
    """One shard is `mlmc_price` (its seeds and counts); a 4-shard level is
    the pooled (n, Σ, Σ²) of its shards run alone."""
    from mcos_tpu_torch.engine.mlmc import _level_seed, mlmc_price

    pp = pparams.SVJParams(**_FIELDS)
    kw = dict(eps=0.5, base_steps=4, max_levels=3, pilot_paths=512, seed=3)
    got = pmesh.sharded_mlmc_price(pp, SPOT, 100.0, T,
                                   mesh=pmesh.make_mesh(["cpu"]), **kw)
    ref = mlmc_price(pp, SPOT, 100.0, T, device="cpu", **kw)
    assert [lv["n"] for lv in got["levels"]] == \
        [lv["n"] for lv in ref["levels"]]
    _close(got["price"], ref["price"], rtol=1e-6)
    seed = _level_seed(3, 1000 + 1024 % 997)
    shards = pmesh.mesh_shards(pmesh.make_mesh(["cpu"] * 4), seed,
                               backend="torch")
    parts = [pmesh._mlmc_level_sums(s, pp, SPOT, 100.0, T, ppd=256,
                                    level=1, base_steps=4, is_call=True,
                                    draws=None) for s in shards]
    alone = [pmesh._mlmc_level_sums(
        pmesh.mesh_shards(pmesh.make_mesh(["cpu"]),
                          pmesh.shard_seed(seed, i), backend="torch")[0],
        pp, SPOT, 100.0, T, ppd=256, level=1, base_steps=4, is_call=True,
        draws=None) for i in range(4)]
    for a, b in zip(parts, alone):
        assert all(torch.equal(a[k], b[k]) for k in a)


# ─────────────────────────────────────────────────────────────────────────────
# sharded_pde_chain
# ─────────────────────────────────────────────────────────────────────────────
def _pde_engines(lam):
    f = dict(_FIELDS, lambda_j=lam)
    kw = dict(n_x=41, n_v=17, n_t=12)
    return (jpde.HestonPDEEngine(jparams.SVJParams(**f), **kw),
            ppde.HestonPDEEngine(pparams.SVJParams(**f), device="cpu", **kw))


CONTRACTS = [(90.0, 0.25), (100.0, 0.5), (110.0, 0.5), (100.0, 1.0),
             (95.0, 2.0)]


def test_sharded_pde_chain_matches_jax():
    jeng, peng = _pde_engines(2.0)
    ref = jmesh.sharded_pde_chain(
        jeng, SPOT, CONTRACTS, is_call=False,
        mesh=jmesh.make_mesh(jax.devices()[:4], axis_name="batch"))
    got = pmesh.sharded_pde_chain(
        peng, SPOT, CONTRACTS, is_call=False,
        mesh=pmesh.make_mesh(["cpu"] * 4, axis_name="batch"))
    assert len(got) == len(ref) == len(CONTRACTS)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in ("price", "delta", "gamma", "ad_vega_v0"):
            assert g[k] == pytest.approx(r[k], rel=1e-4, abs=1e-6), k
        for k in ("n_x", "n_v", "n_t", "method", "strike", "T",
                  "num_devices"):
            assert g[k] == r[k], k
    assert pmesh.sharded_pde_chain(peng, SPOT, [], mesh=pmesh.make_mesh(
        ["cpu"], axis_name="batch")) == []


def test_sharded_pde_chain_is_the_engine_contract_by_contract():
    """Without jumps every contract keeps the engine's own resolution, so
    each row of the 4-shard (padded) chain is `engine.price`, exactly."""
    _, peng = _pde_engines(0.0)
    got = pmesh.sharded_pde_chain(
        peng, SPOT, CONTRACTS[:3], american=True,
        mesh=pmesh.make_mesh(["cpu"] * 4, axis_name="batch"))
    for row, (k, t) in zip(got, CONTRACTS[:3]):
        ref = peng.price(SPOT, k, t, american=True)
        assert {key: row[key] for key in ref} == ref

