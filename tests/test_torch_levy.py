"""`mcos_tpu_torch/ops/levy.py` and `ops/cos_bermudan.py` against the JAX
package's.

The host parts (characteristic functions, COS prices, the COS Bermudan and
American inductions, the calibrations) are numpy float64 copies: equal to
1e-12. The samplers replay the JAX key's variates (`split(key)` → the
clock's key and the Brownian leg's; the IG clock splits its key again
into a normal and a uniform): float32 on both sides, rtol 1e-5. On the
port's own generator they are held to the COS prices by law, within 4
standard errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.ops.cos_bermudan as jcb
import mcos_tpu.ops.levy as jlevy
import mcos_tpu_torch.ops.cos_bermudan as pcb
import mcos_tpu_torch.ops.levy as plevy
from mcos_tpu_torch.engine.pricer import seeded_generator

torch.set_num_threads(1)

N = 4096
STRIKES = [80.0, 95.0, 100.0, 105.0, 125.0]
_FIELDS = [{}, {"sigma": 0.3, "nu": 0.5, "theta": -0.3, "r": 0.05,
                "q": 0.02}]


def _both(model, fields):
    return (getattr(jlevy, model)(**fields), getattr(plevy, model)(**fields))


@pytest.mark.parametrize("fields", _FIELDS)
@pytest.mark.parametrize("model", ["VGParams", "NIGParams"])
def test_cfs_and_cos_prices_equal_jax(model, fields):
    jp, pp = _both(model, fields)
    # The reference's omega is a float32 array, the port's a float.
    assert pp.omega == pytest.approx(float(jp.omega), rel=1e-5)
    cf, cos = (("vg_cf", "vg_cos_price") if model == "VGParams"
               else ("nig_cf", "nig_cos_price"))
    u = np.linspace(0.0, 40.0, 101)
    np.testing.assert_allclose(getattr(plevy, cf)(u, pp, 0.7, 100.0),
                               getattr(jlevy, cf)(u, jp, 0.7, 100.0),
                               rtol=1e-12, atol=1e-15)
    for is_call in (True, False):
        np.testing.assert_allclose(
            getattr(plevy, cos)(pp, 100.0, STRIKES, 0.7, is_call),
            getattr(jlevy, cos)(jp, 100.0, STRIKES, 0.7, is_call),
            rtol=1e-12, atol=1e-12)


def _vg_draws(key, p, T, n=N):
    k_g, k_z = jax.random.split(key)
    g = jax.random.gamma(k_g, jnp.float32(T) / p.nu, (n,), jnp.float32)
    z = jax.random.normal(k_z, (n,), jnp.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in (g, z))


def _nig_draws(key, n=N):
    k_i, k_z = jax.random.split(key)
    k_n, k_u = jax.random.split(k_i)
    return tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.normal(k_n, (n,), jnp.float32),
        jax.random.uniform(k_u, (n,), jnp.float32),
        jax.random.normal(k_z, (n,), jnp.float32)))


@pytest.mark.parametrize("fields", _FIELDS)
@pytest.mark.parametrize("model", ["VGParams", "NIGParams"])
def test_samplers_and_mc_prices_on_replayed_draws(model, fields):
    """The terminal sheet (both antithetic branches) and the per-strike
    price and standard error, rtol 1e-5."""
    jp, pp = _both(model, fields)
    key, T = jax.random.key(11), 0.7
    if model == "VGParams":
        draws = _vg_draws(key, jp, T)
        ref_s = jlevy.vg_terminal(jp, 100.0, T, key, num_paths=N)
        got_s = plevy.vg_terminal(pp, 100.0, T, num_paths=N, draws=draws)
    else:
        draws = _nig_draws(key)
        ref_s = jlevy.nig_terminal(jp, 100.0, T, key, num_paths=N)
        got_s = plevy.nig_terminal(pp, 100.0, T, num_paths=N, draws=draws)
    assert got_s.shape == (2, N)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-5)
    for is_call in (True, False):
        ref = jlevy.levy_price_mc(jp, 100.0, STRIKES, T, key, num_paths=N,
                                  is_call=is_call)
        got = plevy.levy_price_mc(pp, 100.0, STRIKES, T, num_paths=N,
                                  is_call=is_call, draws=draws)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-6)


def test_inverse_gaussian_sampler_on_replayed_draws():
    key = jax.random.key(5)
    k_n, k_u = jax.random.split(key)
    z = jax.random.normal(k_n, (N,), jnp.float32)
    u = jax.random.uniform(k_u, (N,), jnp.float32)
    ref = jlevy._sample_inverse_gaussian(key, jnp.float32(0.5),
                                         jnp.float32(1.25), (N,))
    got = plevy._sample_inverse_gaussian(
        None, torch.tensor(0.5), torch.tensor(1.25), (N,),
        draws=(torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("fields", _FIELDS)
@pytest.mark.parametrize("model", ["VGParams", "NIGParams"])
def test_samplers_by_law_against_cos(model, fields):
    """The port's own generator (torch._standard_gamma for the gamma clock,
    Michael-Schucany-Haas for the IG clock): within 4 standard errors of
    the COS prices, and the terminal mean within 4 of the forward."""
    pp = getattr(plevy, model)(**fields)
    T, n = 0.7, 1 << 16
    cos = (plevy.vg_cos_price if model == "VGParams"
           else plevy.nig_cos_price)
    for is_call in (True, False):
        price, se = plevy.levy_price_mc(
            pp, 100.0, STRIKES, T, seeded_generator(3, "cpu"), num_paths=n,
            is_call=is_call, device="cpu")
        exact = cos(pp, 100.0, STRIKES, T, is_call)
        assert np.all(np.abs(price.numpy() - exact) <= 4 * se.numpy() + 1e-9)
    s = (plevy.vg_terminal if model == "VGParams" else plevy.nig_terminal)(
        pp, 100.0, T, seeded_generator(4, "cpu"), num_paths=n,
        antithetic=False, device="cpu")
    assert s.shape == (1, n) and torch.isfinite(s).all()
    fwd = 100.0 * np.exp((pp.r - pp.q) * T)
    se = float(s.std()) / np.sqrt(n)
    assert abs(float(s.mean()) - fwd) < 4 * se


def test_levy_price_mc_mesh_is_not_ported():
    """The mesh, once refused, is slice N1's: a one-shard mesh seeded from
    the generator prices what the fresh generator prices."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    for p in (plevy.VGParams(), plevy.NIGParams()):
        ref = plevy.levy_price_mc(p, 100.0, [90.0, 100.0], 0.5,
                                  seeded_generator(4, "cpu"), num_paths=N,
                                  device="cpu")
        got = plevy.levy_price_mc(p, 100.0, [90.0, 100.0], 0.5,
                                  seeded_generator(4, "cpu"), num_paths=N,
                                  mesh=make_mesh(["cpu"]), device="cpu")
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("calibrate", ["calibrate_vg", "calibrate_nig"])
def test_calibrations_equal_jax(calibrate):
    """The host trust-region fits: the same starts, the same answer."""
    model = "VGParams" if calibrate == "calibrate_vg" else "NIGParams"
    jp, pp = _both(model, {"sigma": 0.25, "nu": 0.3, "theta": -0.2})
    cos = jlevy.vg_cos_price if model == "VGParams" else jlevy.nig_cos_price
    market = cos(jp, 100.0, STRIKES, 0.5)
    ref = getattr(jlevy, calibrate)(100.0, STRIKES, 0.5, market, n_starts=2)
    got = getattr(plevy, calibrate)(100.0, STRIKES, 0.5, market, n_starts=2)
    for k in ("sigma", "nu", "theta", "rmse_price", "n_quotes"):
        assert got[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-12), k
    assert isinstance(got["params"], type(pp))


# ── the COS Bermudan / American oracle ──────────────────────────────────────
def _models(mod, lev):
    return {
        "gbm": mod.gbm_model(0.25, 0.05, 0.01),
        "merton": mod.merton_model(0.2, 2.0, -0.08, 0.12, 0.05, 0.01),
        "vg": mod.vg_model(lev.VGParams()),
        "nig": mod.nig_model(lev.NIGParams()),
    }


@pytest.mark.parametrize("name", ["gbm", "merton", "vg", "nig"])
@pytest.mark.parametrize("is_call", [False, True])
def test_bermudan_and_american_cos_equal_jax(name, is_call):
    pm, jm = _models(pcb, plevy)[name], _models(jcb, jlevy)[name]
    ref = jcb.bermudan_cos(jm, 100.0, 105.0, 0.5, 6, is_call, n_terms=128)
    got = pcb.bermudan_cos(pm, 100.0, 105.0, 0.5, 6, is_call, n_terms=128)
    assert got.keys() == ref.keys()
    assert got["price"] == pytest.approx(ref["price"], rel=1e-12)
    np.testing.assert_allclose(got["boundary"], ref["boundary"],
                               rtol=1e-12, equal_nan=True)
    assert got["boundary_times"] == ref["boundary_times"]
    ref = jcb.american_cos(jm, 100.0, 105.0, 0.5, is_call, n_terms=128,
                           levels=3)
    got = pcb.american_cos(pm, 100.0, 105.0, 0.5, is_call, n_terms=128,
                           levels=3)
    assert got.keys() == ref.keys()
    assert got["price"] == pytest.approx(ref["price"], rel=1e-12)
    np.testing.assert_allclose(got["ladder_prices"], ref["ladder_prices"],
                               rtol=1e-12)
    assert got["price"] > 0
