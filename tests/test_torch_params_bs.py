"""Port pins: parameters, Black-Scholes and guards against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import guards as jguards
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.models.params import gbm_params as jgbm_params
from mcos_tpu.ops.bs import bs_price as jbs_price
from mcos_tpu_torch.engine import guards as pguards
from mcos_tpu_torch.models.params import SVJParams, gbm_params
from mcos_tpu_torch.ops.bs import bs_price

torch.set_num_threads(1)

_CASES = [
    dict(),
    dict(kappa=0.5, theta=0.09, xi=1.2, rho=-0.9, v0=0.02, lambda_j=3.0,
         mu_j=-0.1, sigma_j=0.2, r=0.03, q=0.0),
    dict(v0=12.0, theta=11.0, rho=-0.9995),
]


def _from_jax(jp) -> SVJParams:
    """JAX SVJParams → numpy → port SVJParams (how the tests carry models)."""
    return SVJParams.from_numpy({k: np.asarray(v) for k, v in
                                 jp.as_dict().items()})


@pytest.mark.parametrize("fields", _CASES)
def test_params_round_trip_and_validate(fields):
    jp = JSVJParams(**fields)
    pp = _from_jax(jp)
    assert pp.as_dict() == jp.as_dict()
    assert SVJParams.from_numpy(pp.to_numpy()) == pp
    assert pp.validate() == jp.validate()
    assert pp.feller_satisfied == jp.feller_satisfied
    assert abs(pp.jump_compensation - float(jp.jump_compensation)) < 1e-6
    assert pp.replace(xi=0.1).xi == 0.1 and pp.xi == jp.xi


def test_gbm_params_and_missing_field():
    assert gbm_params(0.2).as_dict() == jgbm_params(0.2).as_dict()
    with pytest.raises(KeyError):
        SVJParams.from_numpy({"kappa": 1.0})


@pytest.mark.parametrize("is_call", [True, False])
def test_bs_price_grid_matches_jax(is_call):
    K, T, sig = np.meshgrid(np.linspace(15000, 30000, 7),
                            [0.0, 0.02, 0.25, 1.0, 3.0],
                            [0.0, 0.05, 0.2, 0.6], indexing="ij")
    K, T, sig = (x.ravel().astype(np.float32) for x in (K, T, sig))
    ref = np.asarray(jbs_price(22500.0, jnp.asarray(K), jnp.asarray(T), 0.065,
                               0.012, jnp.asarray(sig), is_call))
    got = bs_price(22500.0, torch.from_numpy(K), torch.from_numpy(T), 0.065,
                   0.012, torch.from_numpy(sig), is_call).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fields,spot,strike,T", [
    (dict(), 22500.0, 22500.0, 0.1),
    (dict(v0=11.0, xi=5.0), 22500.0, 40000.0, 6.0),
    (dict(rho=-0.9999, theta=-0.1), 22500.0, 22000.0, -1.0),
])
def test_guards_match_jax(fields, spot, strike, T):
    jp = JSVJParams(**fields)
    pp = _from_jax(jp)
    assert (pguards.PricingGuard(pp).check_pre_price(spot, strike, T)
            == jguards.PricingGuard(jp).check_pre_price(spot, strike, T))
    result = {"price": 650.0, "std_error": 2.0, "frac_nonfinite": 0.0,
              "v_max": 12.0}
    for is_call in (True, False):
        assert (pguards.PricingGuard(pp).check_post_price(
                    result, spot, strike, abs(T), is_call)
                == jguards.PricingGuard(jp).check_post_price(
                    result, spot, strike, abs(T), is_call))


def test_validate_simulation_output_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.lognormal(10.0, 0.2, 512).astype(np.float32)
    v = rng.uniform(0.0, 0.2, 512).astype(np.float32)
    s[:3] = [np.nan, np.inf, -1.0]
    v[5:7] = [11.0, -1.0]
    ref = jguards.validate_simulation_output(jnp.asarray(s), jnp.asarray(v))
    got = pguards.validate_simulation_output(torch.from_numpy(s),
                                             torch.from_numpy(v))
    assert got["valid"] == ref["valid"] and got["issues"] == ref["issues"]
    for k, x in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], x, rtol=1e-5)
