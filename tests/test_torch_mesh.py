"""Slice N1's mesh (`mcos_tpu_torch/parallel/mesh.py`) on the CPU: the
mesh and its shards, the one pooling function (sums in shard order, `v_max`
as a max), `sharded_price` (Euler and QE) and `sharded_exotic_price`
against the JAX package's sharded drivers on a 4-device JAX mesh with each
port shard fed the draws of the JAX shard's `fold_in(key, i)` key (price
and standard error rtol 1e-5), an n-shard run against its shards' pooled
one-shard runs, the float32 moment contract at 1e8 payoffs, the engine
routes of `MonteCarloEngine` and the `MCOS_AUTO_MESH` toggle, and the
five sites that raised `not_ported("mesh")` until slice N2 routing to
their drivers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.parallel import mesh as jmesh
from mcos_tpu_torch.engine import pricer as ppricer
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

_FIELDS = dict(kappa=2.5, theta=0.05, xi=0.5, rho=-0.65, v0=0.045,
               lambda_j=1.5, mu_j=-0.06, sigma_j=0.12, r=0.05, q=0.01)
SPOT, T, STEPS, N = 100.0, 0.5, 12, 4096
STRIKES = [90.0, 100.0, 115.0]
SEED = 7


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(jax.devices()[:4])


@pytest.fixture(scope="module")
def cpu4():
    return pmesh.make_mesh(["cpu"] * 4)


def _both():
    return JSVJParams(**_FIELDS), SVJParams(**_FIELDS)


def _step_draws(key, steps, n, k=3, uniforms=()):
    """Per step t: fold_in(key, t), split, normal((k, n)) and uniform
    (uniforms + (n,)): the JAX scans' own draws, stacked over steps."""
    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (k, n), jnp.float32),
                jax.random.uniform(k_u, tuple(uniforms) + (n,),
                                   jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _shard_draws(seed, fn):
    """shard_draws for the port: shard i replays jax.random.key(seed)
    folded by i, as shard_map folds each device's key."""
    key = jax.random.key(seed)
    return lambda i: fn(jax.random.fold_in(key, i))


def _close(got, ref, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=0, err_msg=what)


# ─────────────────────────────────────────────────────────────────────────────
# The mesh and its shards
# ─────────────────────────────────────────────────────────────────────────────
def test_make_mesh_takes_cuda_devices_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError):
        pmesh.make_mesh([])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = pmesh.make_mesh()
    assert m.devices == tuple(torch.device("cuda", i) for i in range(3))
    assert m.shape == {"paths": 3} and m.size == 3


def test_mesh_shapes_axes_and_hash():
    m = pmesh.make_mesh(["cpu"] * 8)
    assert m.shape == {"paths": 8} and m == pmesh.make_mesh(["cpu"] * 8)
    assert hash(m) == hash(pmesh.make_mesh(["cpu"] * 8))
    m2 = pmesh.make_mesh_2d(2, ["cpu"] * 8)
    assert m2.shape == {"batch": 2, "paths": 4}
    assert len(m2.axis_devices("paths")) == 4
    assert len(m2.axis_devices("batch")) == 2
    with pytest.raises(ValueError):
        pmesh.make_mesh_2d(3, ["cpu"] * 8)
    shards = pmesh.mesh_shards(m2, 11)
    assert [s.index for s in shards] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        pmesh.mesh_shards(m, 11, backend="pallas")
    # Replayed draws reach every shard, whatever the backend; a kernel,
    # keyed on the shard's seed, refuses them.
    shards = pmesh.mesh_shards(m2, 11, shard_draws=lambda i: torch.full(
        (2,), float(i)))
    assert [float(s.draws[0]) for s in shards] == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="backend='torch'"):
        pmesh.sharded_price(SVJParams(**_FIELDS), SPOT, STRIKES, T, SEED,
                            mesh=pmesh.make_mesh(["cpu"]), num_paths=64,
                            num_steps=2, shard_draws=lambda i: torch.zeros(1))


def test_shard_seeds():
    """Shard 0 keeps the engine's seed; the others take 63-bit mixes that
    are neither seed + i (the engines' other streams) nor each other."""
    for seed in (0, 1, 42, 2**31 - 1):
        seeds = [pmesh.shard_seed(seed, i) for i in range(64)]
        assert seeds[0] == seed
        assert len(set(seeds)) == 64
        assert all(0 <= s < 2**63 for s in seeds)
        others = {seed + k for k in range(-8, 10000)}
        assert not others & set(seeds[1:])
    assert pmesh.shard_seed(42, 3) == pmesh.shard_seed(42, 3)


def test_pool_shards_sums_in_order_and_maxes_v_max():
    stats = [{"n": torch.tensor(float(n)), "sum": torch.tensor([s, 1.0]),
              "v_max": torch.tensor(v)}
             for n, s, v in ((3, 1.5, 0.2), (5, -2.0, 0.9), (4, 4.0, 0.4))]
    out = pmesh.pool_shards(stats)
    assert float(out["n"]) == 12.0
    torch.testing.assert_close(out["sum"], torch.tensor([3.5, 3.0]))
    assert float(out["v_max"]) == pytest.approx(0.9)    # a max, not 1.5


# ─────────────────────────────────────────────────────────────────────────────
# sharded_price and sharded_exotic_price against the JAX sharded drivers
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_sharded_price_matches_jax_on_replayed_shard_draws(jax_mesh, cpu4,
                                                           scheme):
    jp, pp = _both()
    ppd = N // 4
    kw = dict(num_paths=N, num_steps=STEPS, is_call=True, antithetic=True,
              control_variate=True, cv_mode="companion", scheme=scheme)
    ref = jax.device_get(jmesh.sharded_price(
        jp, SPOT, jnp.asarray(STRIKES), T, jax.random.key(SEED),
        mesh=jax_mesh, **kw))
    if scheme == "qe":
        fn = lambda k: _step_draws(k, STEPS, ppd, 2, (2,))  # noqa: E731
    else:
        fn = lambda k: _step_draws(k, STEPS, ppd)           # noqa: E731
    got = pmesh.sharded_price(pp, SPOT, STRIKES, T, SEED, mesh=cpu4,
                              backend="torch",
                              shard_draws=_shard_draws(SEED, fn), **kw)
    for k in ("price", "std_error", "bs_ref"):
        _close(got[k], ref[k], what=k)
    _close(got["v_max"], ref["v_max"], rtol=2e-5)
    assert float(got["num_paths_used"]) == float(ref["num_paths_used"]) == N
    assert float(got["frac_nonfinite"]) == float(ref["frac_nonfinite"]) == 0


@pytest.mark.parametrize("kind,extra", [
    ("asian", {}),
    ("barrier", {"barrier": 118.0, "knock": "out", "direction": "up",
                 "monitoring": "bridge"}),
])
def test_sharded_exotic_price_matches_jax(jax_mesh, cpu4, kind, extra):
    jp, pp = _both()
    kw = dict(kind=kind, num_paths=N, num_steps=STEPS, **extra)
    barrier = kw.pop("barrier", 0.0)
    ref = jax.device_get(jmesh.sharded_exotic_price(
        jp, SPOT, 100.0, T, jax.random.key(SEED), barrier, mesh=jax_mesh,
        **kw))
    got = pmesh.sharded_exotic_price(
        pp, SPOT, 100.0, T, SEED, barrier, mesh=cpu4, backend="torch",
        shard_draws=_shard_draws(SEED, lambda k: _step_draws(
            k, STEPS, N // 4)), **kw)
    for k in ("price", "std_error", "cv_beta"):
        _close(got[k], ref[k], what=k)


# ─────────────────────────────────────────────────────────────────────────────
# n shards = their one-shard runs pooled (backend "cuda": plain versions)
# ─────────────────────────────────────────────────────────────────────────────
def _one_shard_stats(payoff_fn, seed, args, statics, i):
    """Shard i run alone: a one-shard mesh keyed on that shard's seed."""
    return pmesh.sharded_moments(payoff_fn, pmesh.shard_seed(seed, i), args,
                                 mesh=pmesh.make_mesh(["cpu"]),
                                 statics=statics)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_sharded_price_equals_its_shards_pooled(cpu4, scheme):
    pp = SVJParams(**_FIELDS)
    kw = dict(num_paths=4 * 1000, num_steps=STEPS, is_call=True,
              antithetic=True, control_variate=True, cv_mode="companion",
              scheme=scheme)
    got = pmesh.sharded_price(pp, SPOT, STRIKES, T, SEED, mesh=cpu4, **kw)
    statics = (("paths_per_device", 1000), ("num_steps", STEPS),
               ("is_call", True), ("antithetic", True),
               ("control_variate", True), ("cv_mode", "companion"),
               ("scheme", scheme))
    parts = [_one_shard_stats(pmesh._local_price_stats, SEED,
                              (pp, SPOT, STRIKES, T), statics, i)
             for i in range(4)]
    pooled = pmesh.pool_moments(pmesh.pool_shards(parts),
                                torch.exp(torch.tensor(-0.05 * T)))
    for k in ("price", "std_error", "v_max"):
        torch.testing.assert_close(got[k], pooled[k], rtol=0, atol=0)
    # v_max pooled as the max of the shards' maxima.
    assert float(got["v_max"]) == max(float(p["v_max"]) for p in parts)
    # One shard of the mesh is the unsharded engine's path set.
    one = pmesh.sharded_price(pp, SPOT, STRIKES, T, SEED,
                              mesh=pmesh.make_mesh(["cpu"]), **dict(
                                  kw, num_paths=1000))
    ref = ppricer.mc_price_cuda(pp, SPOT, STRIKES, T, SEED, num_paths=1000,
                                num_steps=STEPS, scheme=scheme, device="cpu")
    for k in ("price", "std_error", "v_max", "bs_ref"):
        torch.testing.assert_close(one[k], ref[k], rtol=1e-6, atol=0)


def test_sharded_exotic_digital_equals_engine_and_pools(cpu4):
    """One shard of `sharded_exotic_price` prices the engine's path set
    (K6's plain version for the Asian, K3's for the digital); the 4-shard
    digital, which has no control, is the mean of its one-shard runs."""
    from mcos_tpu_torch.config import scaled_steps
    from mcos_tpu_torch.engine.exotics import ExoticEngine

    pp = SVJParams(**_FIELDS)
    eng = ExoticEngine(pp, num_paths=1000, num_steps=STEPS, seed=SEED,
                       device="cpu")
    kw = dict(num_paths=1000, num_steps=scaled_steps(STEPS, T))
    for kind, ref in (("digital", eng.price_digital(SPOT, 100.0, T)),
                      ("asian", eng.price_asian(SPOT, 100.0, T))):
        one = pmesh.sharded_exotic_price(pp, SPOT, 100.0, T, SEED,
                                         mesh=pmesh.make_mesh(["cpu"]),
                                         kind=kind, **kw)
        _close(one["price"], ref["price"], rtol=1e-6, what=kind)
        _close(one["std_error"], ref["std_error"], rtol=1e-6, what=kind)
    four = pmesh.sharded_exotic_price(pp, SPOT, 100.0, T, SEED, mesh=cpu4,
                                      kind="digital",
                                      **dict(kw, num_paths=4000))
    parts = [float(pmesh.sharded_exotic_price(
        pp, SPOT, 100.0, T, pmesh.shard_seed(SEED, i),
        mesh=pmesh.make_mesh(["cpu"]), kind="digital", **kw)["price"])
        for i in range(4)]
    _close(four["price"], np.mean(parts), rtol=1e-6)


# ─────────────────────────────────────────────────────────────────────────────
# The float32 moment contract at 1e8 payoffs
# ─────────────────────────────────────────────────────────────────────────────
def _audit_lognormal_payoffs(shard, scale, *, ppd):
    """Option-scale payoffs max(100·e^{sZ} − 100, 0): the heavy right tail
    whose second moment stresses float32 the hardest."""
    z = torch.randn((ppd,), generator=shard.generator(), dtype=torch.float32)
    return torch.clamp(100.0 * torch.exp(scale * z) - 100.0, min=0.0)[None]


def test_f32_moment_pools_hold_contract_at_1e8_paths():
    """Pooled price/stderr from the real float32 pooling at 1e8 payoffs
    over 8 shards against a float64 reduction of the SAME float32
    payoffs: within 1e-5 (price) and 1e-3 (stderr) relative."""
    m = pmesh.make_mesh(["cpu"] * 8)
    ppd = 100_000_000 // 8
    stats = pmesh.sharded_moments(_audit_lognormal_payoffs, 123, (0.2,),
                                  mesh=m, statics=(("ppd", ppd),))
    pooled = pmesh.pool_moments(stats)
    n_tot, s_tot, ss_tot = 0.0, 0.0, 0.0
    for shard in pmesh.mesh_shards(m, 123):
        eff = _audit_lognormal_payoffs(shard, 0.2, ppd=ppd).double()
        n_tot += eff.shape[-1]
        s_tot += float(eff.sum())
        ss_tot += float((eff * eff).sum())
        del eff
    mean64 = s_tot / n_tot
    se64 = np.sqrt(max(ss_tot / n_tot - mean64 * mean64, 0.0) / n_tot)
    assert float(pooled["num_paths_used"]) == 8 * ppd
    assert abs(float(pooled["price"][0]) - mean64) < 1e-5 * mean64
    assert abs(float(pooled["std_error"][0]) - se64) < 1e-3 * se64


# ─────────────────────────────────────────────────────────────────────────────
# Engine routes and the toggle
# ─────────────────────────────────────────────────────────────────────────────
def test_engine_routes_as_the_reference(cpu4, monkeypatch):
    """use_sobol=False with β = 1 and the companion CV shards through
    `sharded_price`; Sobol with Euler and antithetic (once refused, slice
    N2's) through `sharded_sobol_price`; Sobol QE, non-antithetic Sobol and
    the other estimators fall through to one device."""
    p = SVJParams(**_FIELDS)
    base = dict(num_paths=2000, num_steps=8, device="cpu", mesh=cpu4)
    sharded = ppricer.MonteCarloEngine(p, use_sobol=False, **base)
    res = sharded.price(SPOT, 100.0, T)
    assert "raw_mc_price" not in res and "bs_ref" in res
    direct = pmesh.sharded_price(p, SPOT, [100.0], T, 42, mesh=cpu4,
                                 num_paths=2000, num_steps=sharded._steps(T))
    assert res["price"] == pytest.approx(float(direct["price"][0]), rel=0)
    sobol = ppricer.MonteCarloEngine(p, **base)
    res = sobol.price(SPOT, 100.0, T)
    assert "raw_mc_price" not in res and "bs_ref" in res
    direct = pmesh.sharded_sobol_price(p, SPOT, [100.0], T, mesh=cpu4,
                                       num_paths=2000,
                                       num_steps=sobol._steps(T))
    assert res["price"] == pytest.approx(float(direct["price"][0]), rel=0)
    assert res["num_paths_used"] == 2048        # the 2^11-point net
    for kw in ({"scheme": "qe"}, {"use_antithetic": False},
               {"use_sobol": False, "cv_beta": "optimal"},
               {"use_sobol": False, "cv_mode": "reference"}):
        res = ppricer.MonteCarloEngine(p, **dict(base, **kw)).price(
            SPOT, 100.0, T)
        assert "raw_mc_price" in res, kw         # the one-device driver


def test_auto_mesh_toggle(monkeypatch):
    p = SVJParams(**_FIELDS)
    monkeypatch.setattr(ppricer, "_AUTO_MESH", [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    eng = ppricer.MonteCarloEngine(p, num_paths=1000, num_steps=8,
                                   use_sobol=False, device="cpu")
    assert eng._resolved_mesh() is None      # one card: no mesh
    one = eng.price(SPOT, 100.0, T)
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    assert one == eng.price(SPOT, 100.0, T)  # the unsharded price, exactly
    # Six cards: the largest power-of-two prefix, four.
    monkeypatch.setattr(ppricer, "_AUTO_MESH", [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    m = eng._resolved_mesh()
    assert m.shape == {"paths": 4}
    assert m.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert ppricer.resolve_mesh("auto") is m
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    assert eng._resolved_mesh() is None


def test_auto_mesh_leaves_the_sobol_engine_on_one_device(monkeypatch):
    """The toggle's mesh once left the default engine (Sobol, Euler,
    antithetic, β = 1 companion) on one device; since slice N2 it routes,
    as the reference routes it, to `sharded_sobol_price` over the largest
    power-of-two prefix of six cards: four. The cards are stood in for by
    CPU shards at the call."""
    p = SVJParams(**_FIELDS)
    monkeypatch.setattr(ppricer, "_AUTO_MESH", [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    monkeypatch.setenv("MCOS_AUTO_MESH", "1")
    calls, real = [], pmesh.sharded_sobol_price
    cpu4 = pmesh.make_mesh(["cpu"] * 4)

    def spy(*args, mesh, **kw):
        calls.append(mesh)
        return real(*args, mesh=cpu4, **kw)

    monkeypatch.setattr(pmesh, "sharded_sobol_price", spy)
    eng = ppricer.MonteCarloEngine(p, num_paths=1024, num_steps=8,
                                   device="cpu")
    got = eng.price(SPOT, 100.0, T)
    assert len(calls) == 1
    assert calls[0].devices == tuple(torch.device("cuda", i)
                                     for i in range(4))
    ref = real(p, SPOT, [100.0], T, mesh=cpu4, num_paths=1024,
               num_steps=eng._steps(T), seed=42)
    assert got["price"] == float(ref["price"][0])
    monkeypatch.setenv("MCOS_AUTO_MESH", "0")
    assert eng._resolved_mesh() is None
    assert "raw_mc_price" in eng.price(SPOT, 100.0, T)    # one device


def test_n2_sites_still_raise_not_ported(monkeypatch):
    """The five sites that raised `not_ported("mesh")` until slice N2 now
    route to their drivers: the default Sobol engine, `AmericanEngine`,
    `portfolio_var`, `calibrate(mesh=...)` (its populations) and
    `make_sharded_calibration_step`."""
    import dataclasses

    from mcos_tpu_torch.engine import american, calibration, risk

    assert not hasattr(ppricer, "NOT_PORTED")
    cpu2 = pmesh.make_mesh(["cpu"] * 2)
    seen = []

    def spy(name):
        real = getattr(pmesh, name)

        def fn(*args, **kw):
            seen.append(name)
            return real(*args, **kw)
        monkeypatch.setattr(pmesh, name, fn)

    for name in ("sharded_sobol_price", "sharded_american_price",
                 "sharded_portfolio_returns", "sharded_population"):
        spy(name)
    p = SVJParams(**_FIELDS)
    ppricer.MonteCarloEngine(p, num_paths=512, num_steps=4, mesh=cpu2,
                             device="cpu").price(SPOT, 100.0, T)
    american.AmericanEngine(p, num_paths=512, num_steps=16, mesh=cpu2,
                            device="cpu").price(SPOT, 100.0, T,
                                                is_call=False)
    var = risk.portfolio_var([100.0, 100.0], [0.2, 0.3], np.eye(2),
                             [0.5, 0.5], 0.1, num_paths=2048, num_steps=2,
                             mesh=cpu2, device="cpu")
    assert var["num_devices"] == 2
    cfg = dataclasses.replace(calibration.CALIBRATION_CONFIG,
                              stage1_max_iter=4, stage2_max_iter=4)
    calibration.CalibrationEngine(cfg, device="cpu").calibrate(
        SPOT, [95.0, 100.0, 105.0], T, [8.0, 5.0, 2.8], num_paths=256,
        num_steps=2, pop_size=2, polish=False, mesh=cpu2)
    assert seen[:3] == ["sharded_sobol_price", "sharded_american_price",
                        "sharded_portfolio_returns"]
    assert set(seen[3:]) == {"sharded_population"}
    step, init = calibration.make_sharded_calibration_step(
        pmesh.make_mesh_2d(1, ["cpu"] * 2), num_paths=256, num_steps=2)
    u, state = init([2.0, 0.05, 0.4, -0.6, 0.04])
    _, _, loss = step(u, state, SPOT, [95.0, 100.0, 105.0], T,
                      [8.0, 5.0, 2.8], [0.3, 0.4, 0.3], 0)
    assert torch.isfinite(loss)
