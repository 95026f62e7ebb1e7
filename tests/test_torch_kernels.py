"""Port pins for the modules that hold kernels: K1's and K2's plain torch
versions (the CPU side of `mcos_tpu_torch.ops.cuda_kernels`), the plain
Philox4x32-10, and the wrapper rule. The kernels themselves run only on a
CUDA device: tests/test_torch_cuda.py and chip_smoke.py compare them with
these plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.ops import simulate as jsim
from mcos_tpu.ops.pallas_kernels import svj_terminal_from_draws_pallas
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import simulate as psim
from mcos_tpu_torch.ops.bs import bs_price

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=1.5, mu_j=-0.05, sigma_j=0.1)


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(0)
    n, steps = 2048, 20   # deliberately not multiples of anything
    z1, z2, zjs = (rng.standard_normal((n, steps)).astype(np.float32)
                   for _ in range(3))
    uj = rng.uniform(size=(n, steps)).astype(np.float32)
    return z1, z2, uj, zjs


@pytest.fixture(scope="module")
def pallas_out(draws):
    """The JAX kernel on the same draws, in the Pallas interpreter."""
    z1, z2, uj, zjs = draws
    out = svj_terminal_from_draws_pallas(
        JSVJParams(**_FIELDS), 22500.0, 0.5, z1, z2, uj, zjs,
        antithetic=True, companion=True, rows=8, chunk=8)
    return [np.asarray(x) for x in out]


def _port(draws, steps_major=False, **kw):
    z1, z2, uj, zjs = (torch.from_numpy(x.T.copy() if steps_major else x)
                       for x in draws)
    return ck.svj_terminal_from_draws(
        SVJParams(**_FIELDS), 22500.0, 0.5, z1, z2, uj, zjs,
        antithetic=True, companion=True, steps_major=steps_major, **kw)


def test_k1_plain_matches_interpreted_pallas(draws, pallas_out):
    before = ck.svj_terminal_from_draws.launches
    got = _port(draws)
    assert ck.svj_terminal_from_draws.launches == before  # CPU: no launch
    for g, r in zip(got, pallas_out):
        assert g.shape == (2, 2048)
        np.testing.assert_allclose(g.numpy(), r, rtol=5e-5)


def test_k1_plain_matches_scan_twin(draws):
    z1, z2, uj, zjs = (jnp.asarray(x) for x in draws)
    p = JSVJParams(**_FIELDS)
    base = jsim.simulate_terminal_from_draws(p, 22500.0, 0.5, z1, z2, uj, zjs,
                                             companion=True)
    anti = jsim.simulate_terminal_from_draws(p, 22500.0, 0.5, -z1, -z2, uj,
                                             -zjs, companion=True)
    got = _port(draws)
    for i, ref in enumerate((base, anti)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(r),
                                       rtol=5e-5)


def test_k1_steps_major_equals_paths_major(draws):
    a = _port(draws, steps_major=False)
    b = _port(draws, steps_major=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_port_scan_twin_matches_jax_scan_twin(draws):
    """ops/simulate.simulate_terminal_from_draws (the torch backend)."""
    p = JSVJParams(**_FIELDS)
    ref = jsim.simulate_terminal_from_draws(p, 22500.0, 0.5,
                                            *(jnp.asarray(x) for x in draws),
                                            companion=True)
    got = psim.simulate_terminal_from_draws(SVJParams(**_FIELDS), 22500.0,
                                            0.5,
                                            *(torch.from_numpy(x)
                                              for x in draws),
                                            companion=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-5)


def test_k1_in_kernel_jumps_use_the_philox_stream(draws):
    """u_jump=None ≡ u_jump = philox_jump_uniforms(seed); the stream is
    independent of the path count (a prefix of paths sees a prefix)."""
    z1, z2, _, zjs = (torch.from_numpy(x.T.copy()) for x in draws)
    params = SVJParams(**_FIELDS)
    u = ck.philox_jump_uniforms(20, 2048, 11, "cpu")
    a = ck.svj_terminal_from_draws(params, 22500.0, 0.5, z1, z2, None, zjs,
                                   seed=11, steps_major=True)
    b = ck.svj_terminal_from_draws(params, 22500.0, 0.5, z1, z2, u, zjs,
                                   seed=11, steps_major=True)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(
        ck.philox_jump_uniforms(20, 100, 11, "cpu").numpy(), u[:, :100].numpy())


def test_k1_wrapper_rejects_bad_inputs(draws):
    z = torch.zeros((4, 8))
    params = SVJParams(**_FIELDS)
    with pytest.raises(TypeError):
        ck.svj_terminal_from_draws(params, 1.0, 1.0, z.double(), z, None, z)
    with pytest.raises(ValueError):
        ck.svj_terminal_from_draws(params, 1.0, 1.0, z, z[:2], None, z)
    with pytest.raises(ValueError):
        ck.svj_terminal_from_draws(params, 1.0, 1.0, z, z, None, z, seed=-1)


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    def run(ctr, key):
        c = [torch.tensor([x], dtype=torch.int64) for x in ctr]
        return [int(w) for w in ck.philox4x32_10(*c, *key)]
    assert run((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_uniforms_distinct_inside_and_uniform():
    u = ck.philox_jump_uniforms(4, 1 << 14, 5, "cpu").reshape(-1)  # 2^16
    words = ck.philox4x32_10(torch.arange(1 << 14), 0, 0, 0, 5, 0)
    flat = torch.stack(words).reshape(-1)
    assert flat.unique().numel() == flat.numel()   # neighbours distinct
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 5 * np.sqrt(1 / 12 / n)
    assert abs(float(u.var()) - 1 / 12) < 5 * np.sqrt(1 / 180 / n)
    assert scipy.stats.kstest(u.double().numpy(), "uniform").pvalue > 1e-3
    # The extreme words map strictly inside (0, 1).
    edge = ck.bits_to_uniform(torch.tensor([0, 0xFFFFFFFF]))
    assert 0.0 < float(edge[0]) and float(edge[1]) < 1.0


def test_k2_plain_by_law():
    spot, sigma, r, q, T, steps = 22500.0, 0.2, 0.065, 0.012, 1.0, 13
    n = 1 << 14
    before = ck.gbm_terminal.launches
    s = ck.gbm_terminal(spot, sigma, r, q, T, 7, num_paths=n,
                        num_steps=steps, device="cpu")
    assert ck.gbm_terminal.launches == before
    assert s.shape == (2, n) and bool(torch.isfinite(s).all())
    lr = torch.log(s / spot).double()
    drift = (r - q - 0.5 * sigma**2) * T
    # Antithetic mirror about the drift: lr0 + lr1 = 2·Σ drift_dt.
    np.testing.assert_allclose((lr[0] + lr[1]).numpy(), 2 * drift, atol=2e-5)
    se_mean = sigma * np.sqrt(T / n)
    assert abs(float(lr[0].mean()) - drift) < 5 * se_mean
    assert abs(float(lr[0].std()) - sigma * np.sqrt(T)) < \
        5 * sigma * np.sqrt(T / (2 * n))
    pay = torch.clamp(s.double() - spot, min=0.0).mean(dim=0)
    disc = np.exp(-r * T)
    mc = disc * float(pay.mean())
    se = disc * float(pay.std()) / np.sqrt(n)
    ref = float(bs_price(spot, spot, T, r, q, sigma, True))
    assert abs(mc - ref) < 3 * se
    one = ck.gbm_terminal(spot, sigma, r, q, T, 7, num_paths=n,
                          num_steps=steps, antithetic=False, device="cpu")
    np.testing.assert_array_equal(one.numpy(), s[:1].numpy())


def test_k2_odd_tail_uses_the_stream_prefix():
    """Step counts off a multiple of 4 use the first normals of the last
    quad: 5 steps = the 4-step run plus one more normal."""
    kw = dict(num_paths=64, device="cpu")
    s4 = ck.gbm_terminal(100.0, 0.3, 0.0, 0.0, 4.0, 3, num_steps=4, **kw)
    s5 = ck.gbm_terminal(100.0, 0.3, 0.0, 0.0, 5.0, 3, num_steps=5, **kw)
    step5 = torch.log(s5.double() / s4.double())
    # Step 5 is drift + σ√dt·z with z the cosine normal of quad 1 (dt = 1).
    w = ck.philox4x32_10(torch.arange(64), 0, 1, 1, 3, 0)
    u1, u2 = (ck.bits_to_uniform(x).double() for x in w[:2])
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * np.pi * u2)
    drift = -0.5 * 0.3**2
    np.testing.assert_allclose(step5[0].numpy(), (drift + 0.3 * z).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(step5[1].numpy(), (drift - 0.3 * z).numpy(),
                               atol=1e-5)


def test_wrapper_rule_rejects_other_devices():
    with pytest.raises(ValueError):
        ck.gbm_terminal(1.0, 0.2, 0.0, 0.0, 1.0, 0, num_paths=8, num_steps=4,
                        device="meta")
    z = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        ck.svj_terminal_from_draws(SVJParams(), 1.0, 1.0, z, z, None, z)


# ─────────────────────────────────────────────────────────────────────────────
# K1 over a population: P parameter sets on one draw set
# ─────────────────────────────────────────────────────────────────────────────
_POPULATION = (
    SVJParams(**_FIELDS),
    SVJParams(kappa=1.0, theta=0.09, xi=0.9, rho=-0.2, v0=0.06, lambda_j=0.0,
              mu_j=0.0, sigma_j=0.01),
    SVJParams(kappa=6.0, theta=0.02, xi=1.2, rho=0.3, v0=0.01, lambda_j=4.0,
              mu_j=-0.15, sigma_j=0.25),
)


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("companion", [True, False])
@pytest.mark.parametrize("explicit_u", [True, False])
def test_k1_population_plain_equals_each_member(draws, members, antithetic,
                                                companion, explicit_u):
    """Member p of the population's plain version is, word for word, the
    one-member plain version on its parameters (the third member's ξ = 1.2
    floors v at 0 on some paths)."""
    z1, z2, uj, zjs = (torch.from_numpy(x.T.copy()) for x in draws)
    u = uj if explicit_u else None
    kw = dict(seed=5, antithetic=antithetic, companion=companion,
              steps_major=True)
    pop = _POPULATION[:members]
    got = ck.svj_terminal_from_draws_population(pop, 22500.0, 0.5, z1, z2,
                                                u, zjs, **kw)
    assert (got[2] is None) == (not companion)
    nb = 2 if antithetic else 1
    for p, params in enumerate(pop):
        ref = ck.svj_terminal_from_draws_plain(params, 22500.0, 0.5, z1, z2,
                                               u, zjs, **kw)
        for g, r in zip(got, ref):
            if r is None:
                continue
            assert g.shape == (members, nb, 2048)
            np.testing.assert_array_equal(g[p].numpy(), r.numpy())
    if members == 3:
        assert (got[1][2] == 0).any()


def test_k1_population_takes_a_consts_table(draws):
    z1, z2, uj, zjs = (torch.from_numpy(x.T.copy()) for x in draws)
    table = np.stack([ck._svj_consts(p, 22500.0, 0.5, 20)
                      for p in _POPULATION])
    a = ck.svj_terminal_from_draws_population(
        _POPULATION, 22500.0, 0.5, z1, z2, uj, zjs, steps_major=True)
    b = ck.svj_terminal_from_draws_population(
        table, 22500.0, 0.5, z1, z2, uj, zjs, steps_major=True)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    with pytest.raises(ValueError):
        ck.svj_terminal_from_draws_population(table[:, :14], 1.0, 1.0, z1,
                                              z2, uj, zjs, steps_major=True)
    with pytest.raises(ValueError):
        ck.svj_terminal_from_draws_population([], 1.0, 1.0, z1, z2, uj, zjs,
                                              steps_major=True)


def test_k1_consts_table_matches_pack_params():
    """The population's (P, 15) table, built in one numpy pass, against the
    JAX package's `_pack_params` member by member (the scalars the TPU
    kernel reads), and each row bit for bit the one-member table of its
    parameters: a member's launch constants do not depend on its
    neighbours."""
    from mcos_tpu.ops import pallas_kernels as jpk

    order = [jpk._P_SPOT, jpk._P_V0, jpk._P_DT, jpk._P_SQRT_DT, jpk._P_KAPPA,
             jpk._P_THETA, jpk._P_XI, jpk._P_RHO, jpk._P_RHO_PERP,
             jpk._P_LAM_DT, jpk._P_MU_J, jpk._P_SIG_J, jpk._P_DRIFT_DT,
             jpk._P_G_DRIFT_DT, jpk._P_SIG_CV]
    fields = ("kappa", "theta", "xi", "rho", "v0", "lambda_j", "mu_j",
              "sigma_j", "r", "q")
    table = ck._svj_consts_table(_POPULATION, 22500.0, 0.5, 63)
    assert table.dtype == np.float32 and table.shape == (3, 15)
    for row, params in zip(table, _POPULATION):
        ref = np.asarray(jpk._pack_params(
            JSVJParams(**{k: getattr(params, k) for k in fields}), 22500.0,
            0.5, 63))
        np.testing.assert_allclose(row, ref[order], rtol=2e-6)
        np.testing.assert_array_equal(
            row, ck._svj_consts(params, 22500.0, 0.5, 63))
