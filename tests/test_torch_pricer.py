"""Port pins: `mc_price_from_draws` and `MonteCarloEngine` against the JAX
package's pricer on identical draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import pricer as jpricer
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu_torch.engine import pricer as ppricer
from mcos_tpu_torch.models.params import SVJParams

torch.set_num_threads(1)

_FIELDS = dict(kappa=2.0, theta=0.05, xi=0.45, rho=-0.65, v0=0.045,
               lambda_j=2.0, mu_j=-0.06, sigma_j=0.12)
_KEYS = ("price", "std_error", "raw_mc_price", "bs_ref", "bs_cv_adjustment",
         "s_mean", "v_mean", "v_max", "frac_nonfinite")


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(11)
    n, steps = 2048, 20
    z1, z2, zjs = (rng.standard_normal((steps, n)).astype(np.float32)
                   for _ in range(3))
    uj = rng.uniform(size=(steps, n)).astype(np.float32)
    return z1, z2, uj, zjs


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("cfg", [
    dict(),
    dict(is_call=False),
    dict(cv_mode="reference"),
    dict(cv_beta="optimal"),
    dict(antithetic=False),
    dict(control_variate=False),
])
def test_mc_price_from_draws_matches_jax_scan(draws, backend, cfg):
    strikes = np.array([20000.0, 22500.0, 25000.0], np.float32)
    ref = jpricer.mc_price_from_draws(
        JSVJParams(**_FIELDS), 22500.0, jnp.asarray(strikes), 0.3,
        *(jnp.asarray(x) for x in draws), backend="scan", steps_major=True,
        **cfg)
    got = ppricer.mc_price_from_draws(
        SVJParams(**_FIELDS), 22500.0, strikes, 0.3,
        *(torch.from_numpy(x) for x in draws), backend=backend,
        steps_major=True, **cfg)
    assert set(got) == set(ref)
    # bs_cv_adjustment is a difference of two price-sized numbers, so its
    # float32 noise is relative to the price, not to itself.
    scale = float(np.abs(np.asarray(ref["raw_mc_price"])).max())
    for k in set(ref) & set(_KEYS + ("cv_beta",)):
        atol = 1e-5 * scale if k == "bs_cv_adjustment" else 1e-6
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=atol, err_msg=k)


def test_backends_agree_on_in_kernel_jumps(draws):
    """u_jump=None: the K1 path and the torch twin take one Philox stream."""
    z1, z2, _, zjs = (torch.from_numpy(x) for x in draws)
    kw = dict(seed=5, steps_major=True)
    a = ppricer.mc_price_from_draws(SVJParams(**_FIELDS), 22500.0, [22500.0],
                                    0.3, z1, z2, None, zjs, backend="cuda",
                                    **kw)
    b = ppricer.mc_price_from_draws(SVJParams(**_FIELDS), 22500.0, [22500.0],
                                    0.3, z1, z2, None, zjs, backend="torch",
                                    **kw)
    for k in _KEYS:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-5,
                                   err_msg=k)


def test_engine_price_and_batch_match_jax():
    """Engine on the shared Sobol net with λ=0 (jump streams irrelevant)."""
    fields = dict(_FIELDS, lambda_j=0.0)
    kw = dict(num_paths=2048, num_steps=80, seed=3)
    jeng = jpricer.MonteCarloEngine(JSVJParams(**fields), backend="scan",
                                    **kw)
    peng = ppricer.MonteCarloEngine(SVJParams(**fields), device="cpu", **kw)
    ref, got = jeng.price(22500.0, 23000.0, 0.2), peng.price(22500.0, 23000.0,
                                                            0.2)
    assert set(got) == set(ref)
    for k, v in ref.items():
        # bs_cv_adjustment: a difference of price-sized numbers (see above).
        atol = 1e-4 * ref["price"] if k == "bs_cv_adjustment" else 1e-6
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=atol,
                                   err_msg=k)
    strikes = [21000.0, 22500.0, 24000.0]
    for g, r in zip(peng.price_batch(22500.0, strikes, 0.2, False),
                    jeng.price_batch(22500.0, strikes, 0.2, False)):
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4)


def test_engine_viz_programs_shapes_and_law():
    eng = ppricer.MonteCarloEngine(SVJParams(**_FIELDS), num_paths=1024,
                                   device="cpu")
    paths = eng.sample_paths_device(22500.0, 0.1, num_samples=50).numpy()
    assert paths.shape == (50, 51) and (paths > 0).all()
    assert (paths[:, 0] == 22500.0).all()
    terms = eng.terminal_samples_device(22500.0, 0.1).numpy()
    assert terms.shape == (1024,) and (terms > 0).all()
    # Same seed, same samples (explicit generators, no global RNG state).
    np.testing.assert_array_equal(
        terms, eng.terminal_samples_device(22500.0, 0.1).numpy())
    fwd = 22500.0 * np.exp((0.065 - 0.012) * 0.1)
    assert abs(terms.mean() - fwd) < 5 * terms.std() / np.sqrt(1024)


def test_mesh_error_names_slice_n():
    """The sharded Sobol driver (Euler, antithetic, on a mesh), whose error
    once named slice N2, prices since that slice: a two-shard mesh prices
    the 256-point net through `sharded_sobol_price`, no error raised."""
    from mcos_tpu_torch.parallel.mesh import make_mesh, sharded_sobol_price

    mesh = make_mesh(["cpu"] * 2)
    eng = ppricer.MonteCarloEngine(SVJParams(), num_paths=256, mesh=mesh,
                                   device="cpu")
    res = eng.price(100.0, 100.0, 0.1)
    ref = sharded_sobol_price(SVJParams(), 100.0, [100.0], 0.1, mesh=mesh,
                              num_paths=256, num_steps=eng._steps(0.1))
    assert res["price"] == float(ref["price"][0])


def test_unported_options_raise():
    """Nothing is unported any more: the table of unported options is gone,
    and every option that raised before it was ported prices: PRNG-driven
    pricing, the QE draws path, the sharded PRNG driver and (slice N2) the
    sharded Sobol driver."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    p = SVJParams()
    assert not hasattr(ppricer, "NOT_PORTED")
    one = ppricer.MonteCarloEngine(p, num_paths=256, mesh=make_mesh(["cpu"]),
                                   device="cpu").price(100.0, 100.0, 0.1)
    ref = ppricer.MonteCarloEngine(p, num_paths=256,
                                   device="cpu").price(100.0, 100.0, 0.1)
    assert one["price"] == pytest.approx(ref["price"], rel=1e-6)
    res = ppricer.MonteCarloEngine(p, num_paths=256, use_sobol=False,
                                   device="cpu").price(100.0, 100.0, 0.1)
    assert np.isfinite(res["price"]) and res["std_error"] > 0
    sharded = ppricer.MonteCarloEngine(p, num_paths=256, use_sobol=False,
                                       mesh=make_mesh(["cpu"]),
                                       device="cpu").price(100.0, 100.0, 0.1)
    assert sharded["price"] == pytest.approx(res["price"], rel=1e-6)
    z = torch.zeros((4, 8))
    u = torch.full((4, 8), 0.5)
    res = ppricer.mc_price_from_draws(p, 1.0, [1.0], 0.1, z, u, None, z,
                                      scheme="qe", steps_major=True)
    assert bool(torch.isfinite(res["price"]).all())
    with pytest.raises(ValueError):
        ppricer.mc_price_from_draws(p, 1.0, [1.0], 0.1, z, u, None, z,
                                    scheme="milstein")
