"""Slice N2 of the port's mesh on the CPU, part 1: the Sobol slice, the
optimizer layout of `SVJParams`, and `sharded_sobol_price`,
`sharded_all_greeks` and `sharded_american_price` against the JAX
package's sharded programs on a 4-device JAX mesh, each port shard fed
the JAX shard's `fold_in(key, i)` draws (`shard_draws=`). Part 2 is
tests/test_torch_mesh_n2_programs.py.

Tolerances, stated per check:
- the Sobol integers and uniforms are the JAX package's bit for bit at
  every slice offset; the port's slices put together are its whole net
  bit for bit; its normals are the JAX package's whole net's to atol 1e-5
  (the Acklam steps and the bridge product round apart, as
  tests/test_torch_sobol.py holds the whole net), and the JAX package's
  own slice's to 5e-4 (that slice runs its Acklam steps outside jit);
- prices and standard errors on replayed draws: rtol 1e-5; the Greeks'
  AD first-order sensitivities rtol 1e-4 beside atol 1e-5 × the block's
  largest value (the float32 backward passes sum apart; the Greeks
  engine's own pins), gamma and ∂P/∂λ, differences of two near-equal
  numbers, atol 1e-4 × their largest input;
- the LSM's fitted regressions are float32 normal equations: paths whose
  payoff sits within rounding of the continuation exercise in one package
  and not in the other, so the price is held within half a standard error
  and the port's sharded cashflows against its own unsharded LSM on the
  union sheet count their flips (≤ 3 % of paths, as
  tests/test_torch_american.py counts them);
- an n-shard run against its shards: the pooled dict of the union, price
  rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.models import params as jparams
from mcos_tpu.ops import sobol as jsobol
from mcos_tpu.parallel import mesh as jmesh
from mcos_tpu_torch.engine import american as pamerican
from mcos_tpu_torch.engine import pricer as ppricer
from mcos_tpu_torch.models import params as pparams
from mcos_tpu_torch.ops import sobol as psobol
from mcos_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

_FIELDS = dict(kappa=2.5, theta=0.05, xi=0.5, rho=-0.65, v0=0.045,
               lambda_j=1.5, mu_j=-0.06, sigma_j=0.12, r=0.05, q=0.01)
SPOT, T, STEPS, N, SEED = 100.0, 0.5, 8, 4096, 7
STRIKES = [90.0, 100.0, 115.0]


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


def _step_draws(key, steps, n):
    """The JAX Euler scans' per-step draws for `key`: (z (steps, 3, n),
    u (steps, n))."""
    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (3, n), jnp.float32),
                jax.random.uniform(k_u, (n,), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return _t(z), _t(u)


def _shard_draws(seed, fn):
    key = jax.random.key(seed)
    return lambda i: fn(jax.random.fold_in(key, i))


# ─────────────────────────────────────────────────────────────────────────────
# The Sobol slice and the optimizer layout
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("k", [0, 1, 3])
def test_sobol_slice_bits_against_jax(k):
    """Points [k·ppd, (k+1)·ppd) of a 2^12-point net: the integers and
    uniforms the JAX package's slice, bit for bit; the draws the port's
    whole net's columns bit for bit and JAX's slice to atol 1e-5."""
    total, ppd, steps, seed = 4096, 1024, 6, 11
    off = k * ppd
    sv = psobol.sobol_direction_numbers(3 * steps)
    shift = psobol._scramble_shift(seed, 3 * steps)
    ints = psobol._sobol_integers(torch.from_numpy(sv.astype(np.int64)),
                                  torch.from_numpy(shift.astype(np.int64)),
                                  ppd, 12, off)
    ref = jsobol._sobol_uniforms_slice_T(jnp.asarray(sv), jnp.asarray(shift),
                                         jnp.uint32(off), ppd, total)
    np.testing.assert_array_equal(psobol._uniforms(ints).numpy(),
                                  np.asarray(ref))
    got = psobol.sobol_svj_draws_slice(ppd, total, off, steps, seed=seed,
                                       device="cpu")
    whole = psobol.sobol_svj_draws(total, steps, seed=seed,
                                   jump_uniforms=False, device="cpu")
    jwhole = jsobol.sobol_svj_draws(total, steps, seed=seed,
                                    jump_uniforms=False)
    jref = jsobol.sobol_svj_draws_slice(ppd, total, off, steps, seed=seed)
    assert got[2] is None and jref[2] is None
    for g, w, jw, r in zip(got, whole, jwhole, jref):
        if g is None:
            continue
        assert g.shape == (steps, ppd) and g.dtype == torch.float32
        assert torch.equal(g, w[:, off:off + ppd])
        np.testing.assert_allclose(g.numpy(), np.asarray(jw)[:, off:off + ppd],
                                   rtol=0, atol=1e-5)
        # The reference's slice runs its Acklam steps outside jit, without
        # the fused multiply-adds of its own whole net: up to 3e-4 apart at
        # the central/tail seam (ops/sobol.py:_fma).
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=5e-4)


def test_sobol_slices_union_is_the_net_and_bad_slices_raise():
    total, ppd, steps = 2048, 512, 5
    parts = [psobol.sobol_svj_draws_slice(ppd, total, i * ppd, steps,
                                          seed=3, device="cpu")
             for i in range(4)]
    whole = psobol.sobol_svj_draws(total, steps, seed=3, jump_uniforms=False,
                                   device="cpu")
    for j in (0, 1, 3):
        assert torch.equal(torch.cat([p[j] for p in parts], dim=1),
                           whole[j])
    with pytest.raises(ValueError, match="power of two"):
        psobol.sobol_svj_draws_slice(8, 24, 0, 2, device="cpu")
    with pytest.raises(ValueError, match="not in"):
        psobol.sobol_svj_draws_slice(512, total, 1600, 2, device="cpu")
    with pytest.raises(ValueError, match="Owen"):
        psobol.sobol_svj_draws_slice(8, 16, 0, 2, scramble="shift",
                                     device="cpu")


def test_params_array_layout_equals_jax():
    """`_ARRAY_FIELDS`, `to_array` ((8,) float32, the same order and values)
    and `from_array` (r and q from the market) as the JAX package's."""
    assert pparams._ARRAY_FIELDS == jparams._ARRAY_FIELDS
    jp, pp = _both()
    got = pp.to_array()
    assert got.shape == (8,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.to_array()))
    back = pparams.SVJParams.from_array(got, r=0.03, q=0.02)
    ref = jparams.SVJParams.from_array(jp.to_array(), r=0.03, q=0.02)
    for name in pparams._ARRAY_FIELDS + ("r", "q"):
        assert getattr(back, name) == float(getattr(ref, name)), name


# ─────────────────────────────────────────────────────────────────────────────
# sharded_sobol_price
# ─────────────────────────────────────────────────────────────────────────────
def _jump_uniforms(seed, ppd, steps):
    """The JAX sharded Sobol driver's jump uniforms for shard i."""
    key = jax.random.key(seed + 1)
    return lambda i: _t(jax.random.uniform(jax.random.fold_in(key, i),
                                           (steps, ppd), jnp.float32))


def test_sharded_sobol_price_matches_jax(jax_mesh, cpu4):
    jp, pp = _both()
    kw = dict(num_paths=N, num_steps=STEPS, seed=SEED, is_call=False)
    ref = jax.device_get(jmesh.sharded_sobol_price(
        jp, SPOT, jnp.asarray(STRIKES), T, mesh=jax_mesh, **kw))
    got = pmesh.sharded_sobol_price(
        pp, SPOT, STRIKES, T, mesh=cpu4, backend="torch",
        shard_draws=_jump_uniforms(SEED, N // 4, STEPS), **kw)
    for k in ("price", "std_error", "bs_ref"):
        _close(got[k], ref[k], what=k)
    _close(got["v_max"], ref["v_max"], rtol=2e-5)
    assert float(got["num_paths_used"]) == N
    assert float(got["frac_nonfinite"]) == float(ref["frac_nonfinite"]) == 0
    with pytest.raises(ValueError, match="do not split"):
        pmesh.sharded_sobol_price(pp, SPOT, STRIKES, T, num_paths=N,
                                  num_steps=STEPS,
                                  mesh=pmesh.make_mesh(["cpu"] * 3))


def test_sharded_sobol_price_is_the_net_and_one_shard_the_engine(cpu4):
    """4 shards (K1's plain version, backend "cuda") price the union of
    their slices: the unsharded driver on the whole net with the shards'
    jump uniforms side by side; one shard at 2^m paths is the unsharded
    engine, K1's outputs bit for bit."""
    pp = pparams.SVJParams(**_FIELDS)
    got = pmesh.sharded_sobol_price(pp, SPOT, STRIKES, T, mesh=cpu4,
                                    num_paths=N, num_steps=STEPS, seed=SEED)
    z1, z2, _, z_js = psobol.sobol_svj_draws(N, STEPS, seed=SEED,
                                             jump_uniforms=False,
                                             device="cpu")
    from mcos_tpu_torch.ops import cuda_kernels as ck

    u = torch.cat([ck.philox_jump_uniforms(STEPS, N // 4,
                                           pmesh.shard_seed(SEED, i), "cpu")
                   for i in range(4)], dim=1)
    whole = ppricer.mc_price_from_draws(pp, SPOT, STRIKES, T, z1, z2, u,
                                        z_js, steps_major=True)
    for k in ("price", "std_error", "bs_ref"):
        _close(got[k], whole[k], rtol=1e-6, what=k)
    eng = ppricer.MonteCarloEngine(pp, num_paths=N, num_steps=STEPS,
                                   seed=SEED, device="cpu")
    steps = eng._steps(T)
    one = pmesh.sharded_sobol_price(pp, SPOT, [100.0], T,
                                    mesh=pmesh.make_mesh(["cpu"]),
                                    num_paths=N, num_steps=steps, seed=SEED)
    ref = eng.price(SPOT, 100.0, T)
    for k in ("price", "std_error", "bs_ref"):
        _close(one[k][0], ref[k], rtol=1e-6, what=k)
    a = ck.svj_terminal_from_draws(pp, SPOT, T, *psobol.sobol_svj_draws_slice(
        N, N, 0, steps, seed=SEED, device="cpu"), seed=SEED,
        companion=True, steps_major=True)
    b = ck.svj_terminal_from_draws(pp, SPOT, T, *eng._sobol_draws(steps),
                                   seed=SEED, companion=True,
                                   steps_major=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sharded_sobol_caches_its_slices_apart_from_the_engine(
        monkeypatch):
    """A repeated call reads each shard's slice from the bounded shard
    cache (the same bits as a fresh slice) and makes none anew; the
    engine's whole-net cache stays empty."""
    from collections import OrderedDict

    monkeypatch.setattr(pmesh, "_SHARD_DRAWS_CACHE", OrderedDict())
    monkeypatch.setattr(ppricer, "_SOBOL_DRAWS_CACHE", OrderedDict())
    made, real = [], psobol.sobol_svj_draws_slice

    def counted(*args, **kw):
        made.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(psobol, "sobol_svj_draws_slice", counted)
    pp = pparams.SVJParams(**_FIELDS)
    kw = dict(mesh=pmesh.make_mesh(["cpu"] * 4), num_paths=1024,
              num_steps=STEPS, seed=SEED)
    first = pmesh.sharded_sobol_price(pp, SPOT, STRIKES, T, **kw)
    assert made == [0, 256, 512, 768]
    again = pmesh.sharded_sobol_price(pp, SPOT, STRIKES, T, **kw)
    assert made == [0, 256, 512, 768]                   # all four hit
    assert torch.equal(first["price"], again["price"])
    assert len(pmesh._SHARD_DRAWS_CACHE) == 4
    assert not ppricer._SOBOL_DRAWS_CACHE
    cached = pmesh._SHARD_DRAWS_CACHE[(SEED, 1024, 512, 256, STEPS, "owen",
                                       "cpu")]
    fresh = real(256, 1024, 512, STEPS, seed=SEED, device="cpu")
    assert cached[2] is None and fresh[2] is None
    assert all(torch.equal(cached[i], fresh[i]) for i in (0, 1, 3))
    monkeypatch.setattr(pmesh, "_SHARD_DRAWS_CACHE_MAX", 3)
    pmesh.sharded_sobol_price(pp, SPOT, STRIKES, T, **dict(kw, seed=SEED + 1))
    assert len(pmesh._SHARD_DRAWS_CACHE) == 3           # oldest evicted


# ─────────────────────────────────────────────────────────────────────────────
# sharded_all_greeks
# ─────────────────────────────────────────────────────────────────────────────
def test_sharded_all_greeks_matches_jax(jax_mesh, cpu4):
    jp, pp = _both()
    n, steps = 1024, 4
    ref = jmesh.sharded_all_greeks(jp, SPOT, 100.0, T, jax.random.key(SEED),
                                   mesh=jax_mesh, num_paths=n,
                                   num_steps=steps)
    got = pmesh.sharded_all_greeks(
        pp, SPOT, 100.0, T, SEED, mesh=cpu4, num_paths=n, num_steps=steps,
        shard_draws=_shard_draws(SEED, lambda k: _step_draws(k, steps,
                                                             n // 4)))
    assert got.keys() == ref.keys()
    _close(got["price"], ref["price"], what="price")
    first = ("delta", "vega_per_vol_point", "ad_vega_v0", "theta_daily",
             "rho", "mu_j", "sigma_j", "kappa", "theta", "xi", "rho_corr")
    scale = max(abs(ref[k]) for k in first)
    for k in first:
        _close(got[k], ref[k], rtol=1e-4, atol=1e-5 * scale, what=k)
    _close(got["gamma"], ref["gamma"], rtol=0,
           atol=1e-4 * abs(ref["delta"]) / (0.02 * SPOT), what="gamma")
    _close(got["lambda_j"], ref["lambda_j"], rtol=0,
           atol=1e-4 * ref["price"] / 0.2, what="lambda_j")
    assert got["num_devices"] == 4


def test_sharded_all_greeks_one_shard_is_the_greeks_engine():
    """One shard on the engine's seed: the GreeksEngine's price and AD
    sensitivities on the same draws (rtol 1e-5: the pooled sum against the
    engine's mean)."""
    from mcos_tpu_torch.engine.greeks import GreeksEngine

    pp = pparams.SVJParams(**_FIELDS)
    eng = GreeksEngine(pp, num_paths=1000, num_steps=STEPS, seed=SEED,
                       device="cpu")
    steps = eng._steps(T)
    got = pmesh.sharded_all_greeks(pp, SPOT, 100.0, T, SEED,
                                   mesh=pmesh.make_mesh(["cpu"]),
                                   num_paths=1000, num_steps=steps)
    price, d_spot, d_T, d_params = eng._grads(SPOT, 100.0, T, True)
    _close(got["price"], price, rtol=1e-5)
    _close(got["delta"], d_spot, rtol=1e-5)
    _close(got["theta_daily"], -d_T, rtol=1e-5)
    _close(got["ad_vega_v0"], d_params.v0, rtol=1e-5)


# ─────────────────────────────────────────────────────────────────────────────
# sharded_american_price
# ─────────────────────────────────────────────────────────────────────────────
def test_sharded_american_matches_jax_and_pools_the_union(jax_mesh, cpu4):
    jp, pp = _both()
    n, steps, K = 4000, 12, 105.0
    key = jax.random.key(SEED)
    ref = jmesh.sharded_american_price(jp, SPOT, K, T, key, mesh=jax_mesh,
                                       num_paths=n, num_steps=steps,
                                       is_call=False)
    draws = _shard_draws(SEED, lambda k: _step_draws(k, steps, n // 4))
    got = pmesh.sharded_american_price(pp, SPOT, K, T, SEED, mesh=cpu4,
                                       num_paths=n, num_steps=steps,
                                       is_call=False, shard_draws=draws)
    assert got.keys() == ref.keys()
    assert abs(got["price"] - ref["price"]) < 0.5 * ref["std_error"]
    _close(got["std_error"], ref["std_error"], rtol=0.05)
    assert got["intrinsic"] == ref["intrinsic"]
    assert got["num_paths_used"] == ref["num_paths_used"] == n
    # The pooled regressions are the union sheet's: the sharded cashflows
    # against the unsharded LSM on the shards' sheets side by side.
    from functools import partial

    shards = pmesh.mesh_shards(cpu4, SEED, backend="torch",
                               shard_draws=draws)
    cfs = pmesh.run_lockstep(partial(
        pmesh._american_shard_cashflows, params=pp, spot=SPOT, strike=K, T=T,
        num_paths=n // 4, num_steps=steps, is_call=False, basis_degree=3,
        exercise_every=1), shards)
    z, u = (torch.cat([s.draws[j] for s in shards], dim=-1) for j in (0, 1))
    union = pamerican.lsm_price(pp, SPOT, K, T, draws=(z, u), is_call=False)
    sharded = torch.cat(cfs)
    assert abs(float(sharded.mean()) - float(union["mc_continuation"])) \
        < 0.1 * float(union["std_error"])
    payoff = pamerican._payoff_fn(torch.tensor(K), False)
    s = torch.exp(pamerican._record_log_paths(pp, SPOT, T, draws=(z, u)))
    cf_union = pamerican.lsm_backward_cashflows(
        payoff(s[-1]), s, s, pamerican._exercise_mask(steps, 1),
        pamerican._step_dfs(pp, T, steps, None, "cpu"), payoff,
        pamerican._basis_fn(torch.tensor(K), False, 3))
    assert int((~torch.isclose(sharded, cf_union, rtol=1e-5)).sum()) \
        <= 0.03 * n


def test_american_engine_routes_to_the_sharded_lsm():
    """`AmericanEngine(mesh=...)` prices through `sharded_american_price`;
    on one shard it is the unsharded engine (the same sheet and the same
    regressions), and a Bermudan keeps no t₀ floor."""
    pp = pparams.SVJParams(**_FIELDS)
    kw = dict(num_paths=2000, num_steps=16, seed=SEED, device="cpu")
    ref = pamerican.AmericanEngine(pp, **kw)
    one = pamerican.AmericanEngine(pp, mesh=pmesh.make_mesh(["cpu"]), **kw)
    for every in (1, 4):
        a = one.price(SPOT, 105.0, T, is_call=False, exercise_every=every)
        b = ref.price(SPOT, 105.0, T, is_call=False, exercise_every=every)
        assert a["num_devices"] == 1
        for k in ("price", "std_error", "mc_continuation", "intrinsic"):
            _close(a[k], b[k], rtol=1e-6, what=k)
        assert a["num_steps"] == b["num_steps"]
