"""Port pins: the Sobol net (scramble words, integers, normals, draws,
bridge) against `mcos_tpu.ops.sobol`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.ops import sobol as jsobol
from mcos_tpu.ops.pallas_kernels import _ndtri_kernel
from mcos_tpu_torch.ops import sobol as psobol

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 123456789])
@pytest.mark.parametrize("dims", [1, 7, 75])
def test_scramble_words_equal_threefry(seed, dims):
    ref = np.asarray(jsobol._scramble_shift(jax.random.key(seed), dims))
    np.testing.assert_array_equal(psobol._scramble_shift(seed, dims), ref)


def _jax_integers(sv, shift, n, n_bits):
    """The reference's XOR expansion + Owen hash, stopped before the float
    conversion (mcos_tpu/ops/sobol.py:_sobol_uniforms_core)."""
    idx = jnp.arange(n, dtype=jnp.uint32)
    gray = idx ^ (idx >> 1)
    acc = jnp.zeros((sv.shape[0], 1), jnp.uint32)
    for b in range(n_bits):
        bit = ((gray >> jnp.uint32(b)) & jnp.uint32(1)).astype(bool)
        acc = acc ^ jnp.where(bit[None, :], jnp.asarray(sv)[:, b][:, None],
                              jnp.uint32(0))
    return np.asarray(jsobol._owen_scramble30(acc, jnp.asarray(shift)[:, None]))


@pytest.mark.parametrize("seed,dims,n", [(42, 30, 3000), (7, 5, 1 << 12)])
def test_owen_integers_equal(seed, dims, n):
    n_bits = int(np.ceil(np.log2(n)))
    sv = jsobol.sobol_direction_numbers(dims)
    shift = np.asarray(jsobol._scramble_shift(jax.random.key(seed), dims))
    ref = _jax_integers(sv, shift, n, n_bits)
    got = psobol._sobol_integers(torch.from_numpy(sv.astype(np.int64)),
                                 torch.from_numpy(shift.astype(np.int64)), n,
                                 n_bits)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_acklam_normals_match():
    # Dense sweep incl. the central/tail seam at 0.02425 / 0.97575.
    u = np.concatenate([np.linspace(1e-7, 1 - 1e-7, 100_001),
                        np.linspace(0.024, 0.0245, 1001),
                        np.linspace(0.9755, 0.976, 1001)]).astype(np.float32)
    ref = np.asarray(jax.jit(_ndtri_kernel)(jnp.asarray(u)))
    got = psobol.ndtri_acklam(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("n,steps,seed", [(3000, 20, 42), (2048, 7, 3)])
def test_sobol_svj_draws_match(n, steps, seed):
    ref = jsobol.sobol_svj_draws(n, steps, seed=seed, layout="steps",
                                 jump_uniforms=False)
    got = psobol.sobol_svj_draws(n, steps, seed=seed, layout="steps",
                                 jump_uniforms=False, device="cpu")
    assert ref[2] is None and got[2] is None
    for r, g in ((ref[0], got[0]), (ref[1], got[1]), (ref[3], got[3])):
        assert g.shape == (steps, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)
    # paths layout is the transpose; jump uniforms come from a Generator.
    paths = psobol.sobol_svj_draws(n, steps, seed=seed, layout="paths",
                                   device="cpu")
    np.testing.assert_array_equal(paths[0].numpy(), got[0].numpy().T)
    u = paths[2].numpy()
    assert u.shape == (n, steps) and 0.0 <= u.min() and u.max() < 1.0


def test_bridge_matrix_and_ordering_identical():
    for steps in (1, 2, 7, 25, 63):
        np.testing.assert_array_equal(psobol.bb_ordering(steps),
                                      jsobol.bb_ordering(steps))
        np.testing.assert_array_equal(psobol.brownian_bridge_matrix(steps),
                                      jsobol.brownian_bridge_matrix(steps))
    np.testing.assert_array_equal(psobol.sobol_direction_numbers(9),
                                  jsobol.sobol_direction_numbers(9))


def test_uniforms_equal_and_bad_layout():
    sv = psobol.sobol_direction_numbers(4)
    shift = psobol._scramble_shift(5, 4)
    got = psobol._sobol_integers(torch.from_numpy(sv.astype(np.int64)),
                                 torch.from_numpy(shift.astype(np.int64)),
                                 64, 6)
    ref = jsobol._sobol_uniforms_T(jnp.asarray(sv), jnp.asarray(shift), 64)
    np.testing.assert_array_equal(psobol._uniforms(got).numpy(),
                                  np.asarray(ref))
    with pytest.raises(ValueError):
        psobol.sobol_svj_draws(16, 4, layout="diagonal")
