"""Port pins for the Andersen QE scheme: the QE constants, K5's plain
version (`svj_terminal_qe_from_draws` on CPU tensors), the QE draws twin and
`sobol_qe_draws`, against `mcos_tpu` on the same numpy inputs. K5 itself
runs only on a CUDA device (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.ops import simulate as jsim
from mcos_tpu.ops import sobol as jsobol
from mcos_tpu.ops.pallas_kernels import (_pack_qe_params,
                                         svj_terminal_qe_from_draws_pallas)
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import simulate as psim
from mcos_tpu_torch.ops import sobol as psobol

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=1.5, mu_j=-0.05, sigma_j=0.1)
_N, _STEPS = 2048, 20


@pytest.fixture(scope="module")
def draws():
    """(z_x, u_v, u_jump, z_js), steps-major, as in the reference's
    test_qe_draws_kernel_matches_scan_exactly."""
    rng = np.random.default_rng(0)
    z_x = rng.standard_normal((_STEPS, _N)).astype(np.float32)
    u_v = rng.uniform(0.01, 0.99, (_STEPS, _N)).astype(np.float32)
    uj = rng.uniform(size=(_STEPS, _N)).astype(np.float32)
    zjs = rng.standard_normal((_STEPS, _N)).astype(np.float32)
    return z_x, u_v, uj, zjs


def _torch(draws, steps_major=True):
    return [torch.from_numpy(x if steps_major else x.T.copy())
            for x in draws]


def _assert_terminal(got, ref, rtol_s=1e-5):
    """S and G: float32 noise of two orders of summation (the port adds the
    K-scheme drift terms in another order); v: rtol 1e-4 beside atol 1e-6,
    since v sits at or near the exponential branch's 0."""
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None:
            assert r is None
            continue
        r = np.asarray(r)
        if i == 1:
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=rtol_s)


@pytest.mark.parametrize("fields", [
    _FIELDS,
    dict(_FIELDS, kappa=0.5, xi=0.9, rho=0.3),
    dict(_FIELDS, lambda_j=0.0, xi=0.0),
])
def test_qe_consts_equal_pack_qe_params(fields):
    ref = np.asarray(_pack_qe_params(JSVJParams(**fields), 22500.0, 0.5,
                                     20))[:17]
    got = ck._qe_consts(SVJParams(**fields), 22500.0, 0.5, 20)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("steps_major", [True, False])
def test_k5_plain_matches_interpreted_pallas(draws, antithetic, steps_major):
    before = ck.svj_terminal_qe_from_draws.launches
    kw = dict(antithetic=antithetic, companion=True, steps_major=steps_major)
    got = ck.svj_terminal_qe_from_draws(SVJParams(**_FIELDS), 22500.0, 0.5,
                                        *_torch(draws, steps_major), **kw)
    assert ck.svj_terminal_qe_from_draws.launches == before  # CPU: no launch
    ref = svj_terminal_qe_from_draws_pallas(
        JSVJParams(**_FIELDS), 22500.0, 0.5,
        *(x if steps_major else x.T for x in draws), rows=8, chunk=8, **kw)
    assert got[0].shape == (2 if antithetic else 1, _N)
    _assert_terminal(got, ref)


def test_port_qe_twin_matches_jax_twin(draws):
    p = JSVJParams(**_FIELDS)
    ref = jsim.simulate_terminal_qe_from_draws(
        p, 22500.0, 0.5, *(jnp.asarray(x) for x in draws), antithetic=True,
        companion=True, steps_major=True)
    got = psim.simulate_terminal_qe_from_draws(
        SVJParams(**_FIELDS), 22500.0, 0.5, *_torch(draws), antithetic=True,
        companion=True, steps_major=True)
    _assert_terminal(got, ref)
    # paths-major input is the same program on the transposes.
    again = psim.simulate_terminal_qe_from_draws(
        SVJParams(**_FIELDS), 22500.0, 0.5, *_torch(draws, False),
        antithetic=True, companion=True)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_k5_plain_matches_port_twin(draws):
    """2e-3 on S, the reference's own window (test_pallas.py:353): K5
    inverts u_v with Acklam, the twin with `torch.special.ndtri`, a
    few-ulp gap that compounds through v. G does not see u_v."""
    kw = dict(antithetic=True, companion=True, steps_major=True)
    a = ck.svj_terminal_qe_from_draws(SVJParams(**_FIELDS), 22500.0, 0.5,
                                      *_torch(draws), **kw)
    b = psim.simulate_terminal_qe_from_draws(SVJParams(**_FIELDS), 22500.0,
                                             0.5, *_torch(draws), **kw)
    np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=2e-3)
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), rtol=1e-5)
    # Shared u_v: both branches carry one variance path.
    np.testing.assert_array_equal(a[1][0].numpy(), a[1][1].numpy())


def test_k5_in_kernel_jumps_use_the_philox_stream(draws):
    """u_jump=None ≡ u_jump = philox_jump_uniforms(seed), K1's stream."""
    z_x, u_v, _, zjs = _torch(draws)
    u = ck.philox_jump_uniforms(_STEPS, _N, 13, "cpu")
    kw = dict(seed=13, steps_major=True, companion=True)
    a = ck.svj_terminal_qe_from_draws(SVJParams(**_FIELDS), 22500.0, 0.5,
                                      z_x, u_v, None, zjs, **kw)
    b = ck.svj_terminal_qe_from_draws(SVJParams(**_FIELDS), 22500.0, 0.5,
                                      z_x, u_v, u, zjs, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_k5_wrapper_rejects_bad_inputs():
    z = torch.zeros((4, 8))
    p = SVJParams(**_FIELDS)
    with pytest.raises(TypeError):
        ck.svj_terminal_qe_from_draws(p, 1.0, 1.0, z, z.double(), None, z)
    with pytest.raises(ValueError):
        ck.svj_terminal_qe_from_draws(p, 1.0, 1.0, z, z, None, z[:3])
    zm = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        ck.svj_terminal_qe_from_draws(p, 1.0, 1.0, zm, zm, None, zm)


def _qe_step_against_the_reference_algebra(step):
    """`step` (a plain QE transition) against `_qe_variance_step` on a
    (v, u) grid that crosses ψ = 1.5 and the exponential branch's mass at
    0 (inputs as the reference takes them: z_v = Acklam(u))."""
    from mcos_tpu.ops.pallas_kernels import _qe_variance_step

    # ξ = 1.2 over quarter-year steps, so ψ crosses 1.5 inside the grid.
    p = SVJParams(**dict(_FIELDS, xi=1.2))
    c = ck._qe_dict(ck._qe_consts(p, 100.0, 1.0, 4))
    v, u = np.meshgrid(np.geomspace(1e-6, 0.5, 61),
                       np.linspace(0.001, 0.999, 67))
    v, u = v.astype(np.float32).ravel(), u.astype(np.float32).ravel()
    # Under jit, as inside the kernels: XLA contracts the Acklam Horner
    # steps into FMAs, which `ndtri_acklam` reproduces. Run eagerly, the
    # reference rounds each step twice and moves z_v by up to 5e-5, which
    # the quadratic branch's (√b² + z_v)² magnifies where the two cancel.
    jstep = jax.jit(_qe_variance_step)
    ref = np.asarray(jstep(jnp.asarray(v), jnp.asarray(u), c["theta"],
                           c["e_kdt"], c["var1"], c["var2"]))
    vt, ut = torch.from_numpy(v), torch.from_numpy(u)
    got = step(vt, psobol.ndtri_acklam(ut), ut, c).numpy()
    # rtol 1e-4 + atol 1e-6, the v window used throughout: XLA also
    # contracts the transition's own multiply-adds, a few ulps that the
    # cancellation above can magnify.
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    m = c["theta"] + (v - c["theta"]) * c["e_kdt"]
    quadratic = v * c["var1"] + c["var2"] <= 1.5 * m * m
    assert quadratic.any() and not quadratic.all()   # both branches
    assert (got[quadratic] > 0).all()
    assert (got[~quadratic] == 0).any()              # the mass at 0
    assert (got[~quadratic] > 0).any()               # the tail


def test_qe_variance_step_matches_the_reference_algebra():
    """K5's and the scan twins' transition, `qe_variance_step`."""
    _qe_step_against_the_reference_algebra(ck.qe_variance_step)


def test_qe_step_folded_matches_the_reference_algebra():
    """K4's transition, `_qe_step_folded` (the division-folded algebra):
    the same law, held to the same grid and window."""
    _qe_step_against_the_reference_algebra(ck._qe_step_folded)


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("steps", [4, 20])
def test_sobol_qe_draws_match(seed, steps):
    """u_v: the same Owen-hashed integers, so bit-identical; z_x and z_js:
    Acklam normals (and the bridge for z_x) within float32 noise."""
    n = 3000
    ref = jsobol.sobol_qe_draws(n, steps, seed=seed, jump_uniforms=False)
    got = psobol.sobol_qe_draws(n, steps, seed=seed, jump_uniforms=False,
                                device="cpu")
    assert ref[2] is None and got[2] is None
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for i in (0, 3):
        assert got[i].shape == (steps, n) and got[i].dtype == torch.float32
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=0, atol=1e-6)
    u = psobol.sobol_qe_draws(n, steps, seed=seed, device="cpu")[2].numpy()
    assert u.shape == (steps, n) and 0.0 <= u.min() and u.max() < 1.0
