"""Port pins for multilevel Monte Carlo (slice L) against `mcos_tpu`: the
base level and a coupled correction level on the JAX key tree's normals,
Poisson counts and jump normals replayed; the correction variance falling
over levels on the port's own draws; the Giles driver against the Bates
COS price."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import mlmc as jm
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu_torch.engine import mlmc as pm
from mcos_tpu_torch.engine.pricer import seeded_generator
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.cos_pricer import cos_price

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=1.0, mu_j=-0.05, sigma_j=0.1)
SVJ, JSVJ = SVJParams(**_FIELDS), JSVJParams(**_FIELDS)
SPOT, T = 22500.0, 0.25


def _jump_draws(key, lam_dt, n):
    kc, kz = jax.random.split(key)
    return (jax.random.poisson(kc, lam_dt, (n,)).astype(jnp.float32),
            jax.random.normal(kz, (n,), jnp.float32))


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _level_zero_draws(key, steps: int, n: int, p=JSVJ):
    """(z, counts, jump normals) as `_level_zero` draws them from `key`."""
    lam_dt = jnp.asarray(p.lambda_j, jnp.float32) * (
        jnp.asarray(T, jnp.float32) / steps)

    def one(t):
        kn, kj = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(kn, (2, n), jnp.float32),
                *_jump_draws(kj, lam_dt, n))
    return _t(jax.vmap(one)(jnp.arange(steps)))


def _coupled_draws(key, steps: int, n: int, p=JSVJ):
    """(z_a, z_b, n_a, zj_a, n_b, zj_b) as `_coupled_level` draws them."""
    lam_dt = jnp.asarray(p.lambda_j, jnp.float32) * (
        jnp.asarray(T, jnp.float32) / (2 * steps))

    def one(t):
        ka, kb, kja, kjb = jax.random.split(jax.random.fold_in(key, t), 4)
        return (jax.random.normal(ka, (2, n), jnp.float32),
                jax.random.normal(kb, (2, n), jnp.float32),
                *_jump_draws(kja, lam_dt, n), *_jump_draws(kjb, lam_dt, n))
    return _t(jax.vmap(one)(jnp.arange(steps)))


@pytest.mark.parametrize("is_call,steps", [(True, 8), (False, 16)])
def test_level_zero_matches_jax(is_call, steps):
    key = jax.random.key(4)
    ref = jm._level_zero(JSVJ, SPOT, SPOT, T, key, num_paths=1024,
                         num_steps=steps, is_call=is_call)
    draws = _level_zero_draws(key, steps, 1024)
    assert float(draws[1].sum()) > 0          # the draws hold jumps
    got = pm._level_zero(SVJ, SPOT, SPOT, T, None, num_paths=1024,
                         num_steps=steps, is_call=is_call, draws=draws,
                         device="cpu")
    np.testing.assert_allclose([float(g) for g in got],
                               [float(r) for r in ref], rtol=1e-5)


@pytest.mark.parametrize("is_call,steps", [(True, 8), (False, 16)])
def test_coupled_level_matches_jax(is_call, steps):
    """The correction's mean and second moment: two fine sub-steps each
    with its own exact jump, one coarse step on (z_a + z_b)/√2 with their
    sum. The mean, a difference of nearby payoffs, is held to rtol 1e-5
    of the payoffs' scale (the base level's mean)."""
    key = jax.random.key(5)
    ref = [float(r) for r in jm._coupled_level(
        JSVJ, SPOT, SPOT, T, key, num_paths=1024, num_coarse_steps=steps,
        is_call=is_call)]
    got = [float(g) for g in pm._coupled_level(
        SVJ, SPOT, SPOT, T, None, num_paths=1024, num_coarse_steps=steps,
        is_call=is_call, draws=_coupled_draws(key, steps, 1024),
        device="cpu")]
    scale = float(jm._level_zero(JSVJ, SPOT, SPOT, T, key, num_paths=1024,
                                 num_steps=steps, is_call=is_call)[0])
    assert abs(got[0] - ref[0]) <= 1e-5 * scale, (got, ref)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)


def test_level_draws_shape_checked():
    with pytest.raises(ValueError, match="draws"):
        pm._level_zero(SVJ, SPOT, SPOT, T, None, num_paths=64, num_steps=4,
                       is_call=True, draws=_t([np.zeros((4, 2, 64)),
                                               np.zeros((4, 64)),
                                               np.zeros((4, 65))]),
                       device="cpu")
    with pytest.raises(ValueError, match="draws"):
        pm._coupled_level(SVJ, SPOT, SPOT, T, None, num_paths=64,
                          num_coarse_steps=4, is_call=True,
                          draws=_t([np.zeros((4, 2, 64))] * 2
                                   + [np.zeros((4, 64))] * 3),
                          device="cpu")


def test_correction_variance_decays():
    """V_l falls geometrically over levels 1-3 on the port's own draws (a
    Bernoulli jump coupling would keep it flat)."""
    vs = []
    for lvl in (1, 2, 3):
        m, m2 = pm._coupled_level(
            SVJ, SPOT, SPOT, T, seeded_generator(lvl, "cpu"),
            num_paths=16_384, num_coarse_steps=4 * 2 ** (lvl - 1),
            is_call=True, device="cpu")
        vs.append(float(m2) - float(m) ** 2)
    assert vs[1] < 0.6 * vs[0]
    assert vs[2] < 0.6 * vs[1]


def test_fresh_draws_have_the_poisson_law():
    """The generator path draws exact Poisson counts at λ·dt_f a fine
    sub-step: at λ = 40 a year the level-zero jump sum has the compound
    Poisson mean."""
    p = SVJ.replace(lambda_j=40.0, xi=0.0, v0=0.0, theta=0.0, kappa=0.0)
    # With no diffusion, log S_T is drift + the jumps: E[e^{sum}] pins
    # the count law through the compensator (the payoff at K = 0).
    m, _ = pm._level_zero(p, 1.0, 0.0, T, seeded_generator(3, "cpu"),
                          num_paths=200_000, num_steps=8, is_call=True,
                          device="cpu")
    expected = np.exp(-p.q * T)              # the forward, discounted
    assert abs(float(m) - expected) < 3e-3


def test_level_seeds_follow_the_reference_tags():
    seeds = {pm._level_seed(0, lvl * 1000 + n % 997)
             for lvl in range(4) for n in (256, 4096, 1 << 20)}
    assert len(seeds) == 12
    assert pm._level_seed(0, 5) == pm._level_seed(0, 5) != \
        pm._level_seed(1, 5)


def test_mlmc_matches_cos_oracle():
    """The whole driver against the Bates COS price (the exact Poisson
    jumps are the law the oracle prices), at eps = 1.0 with path counts
    capped at 2^16 a level."""
    exact = float(cos_price(SVJ, SPOT, [SPOT], T, True)[0])
    out = pm.mlmc_price(SVJ, SPOT, SPOT, T, eps=1.0, seed=3,
                        max_paths_per_level=1 << 16, device="cpu")
    tol = 3 * (out["std_error"] + out["bias_estimate"]) + 1.0
    assert abs(out["price"] - exact) < tol, (out, exact)
    assert out["num_levels"] >= 3
    ns = [lv["n"] for lv in out["levels"]]
    assert ns[0] >= ns[-1]
    assert all(n & (n - 1) == 0 and 256 <= n <= 1 << 16 for n in ns)
