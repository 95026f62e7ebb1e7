"""The port's CUDA kernels against their plain torch versions, on the card.

These need a CUDA device and skip without one. The file imports torch and
the port only (no JAX), so on the card it runs without the JAX suite's
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import re

import numpy as np
import pytest
import torch

from mcos_tpu_torch.engine.pricer import MonteCarloEngine
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import sobol

torch.set_num_threads(1)

_P = SVJParams(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=1.5, mu_j=-0.05, sigma_j=0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _draws(device, steps=20, n=10_007, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    z = torch.randn((3, steps, n), generator=g, device=device)
    u = torch.rand((steps, n), generator=g, device=device)
    return z[0], z[1], u, z[2]


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("companion", [True, False])
@pytest.mark.parametrize("explicit_u", [True, False])
def test_k1_kernel_matches_plain(cuda, antithetic, companion, explicit_u):
    z1, z2, u, zjs = _draws(cuda)
    u = u if explicit_u else None
    kw = dict(seed=9, antithetic=antithetic, companion=companion,
              steps_major=True)
    n0 = ck.svj_terminal_from_draws.launches
    ker = ck.svj_terminal_from_draws(_P, 22500.0, 0.5, z1, z2, u, zjs, **kw)
    torch.cuda.synchronize()
    assert ck.svj_terminal_from_draws.launches == n0 + 1
    ref = ck.svj_terminal_from_draws_plain(_P, 22500.0, 0.5, z1, z2, u, zjs,
                                           **kw)
    assert (ker[2] is None) == (not companion)
    # Bit for bit: the kernel performs the plain version's IEEE operations
    # (csrc/svj_draws.cu).
    for got, want in zip(ker, ref):
        if want is not None:
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_k1_paths_major_input(cuda):
    z1, z2, u, zjs = _draws(cuda, steps=7, n=3000)
    a = ck.svj_terminal_from_draws(_P, 100.0, 0.1, z1, z2, u, zjs,
                                   steps_major=True)
    b = ck.svj_terminal_from_draws(_P, 100.0, 0.1, z1.T, z2.T, u.T, zjs.T,
                                   steps_major=False)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


def test_k1_rejects_what_it_does_not_take(cuda):
    z1, z2, u, zjs = _draws(cuda, steps=4, n=64)
    with pytest.raises(TypeError):
        ck.svj_terminal_from_draws(_P, 1.0, 1.0, z1.double(), z2, u, zjs)
    with pytest.raises(ValueError):
        ck.svj_terminal_from_draws(_P, 1.0, 1.0, z1, z2.cpu(), u, zjs)


def _k1_population(members, seed=0):
    """`members` SVJ parameter sets inside the calibration's bounds (the
    first the module's `_P`), made with numpy from `seed`."""
    from mcos_tpu_torch.config import PARAM_BOUNDS

    rng = np.random.default_rng(seed)
    names = ("kappa", "theta", "xi", "rho", "v0", "lambda_j", "mu_j",
             "sigma_j")
    rows = [_P]
    for _ in range(members - 1):
        rows.append(SVJParams(**{
            k: float(np.float32(lo + (hi - lo) * rng.random()))
            for k, (lo, hi) in ((k, PARAM_BOUNDS[k]) for k in names)}))
    return rows[:members]


# One block holds 8 member groups x 3 members: 25 takes two member chunks.
K1_BLOCK_MEMBERS = 24


@pytest.mark.parametrize("members", [1, 3, K1_BLOCK_MEMBERS,
                                     K1_BLOCK_MEMBERS + 1])
@pytest.mark.parametrize("paths", [100_000, 100_001, 37])
@pytest.mark.parametrize("steps", [50, 63, 1])
@pytest.mark.parametrize("explicit_u", [True, False])
def test_k1_population_matches_plain(cuda, members, paths, steps,
                                     explicit_u):
    """One K1 launch for the population against its plain version on the
    same draws, bit for bit (the kernel performs the plain version's IEEE
    operations); ragged tiles (100 001, 37 paths: rows not 16-B aligned), a
    step count that is no multiple of any stage (63), one step, and a
    population past one block's members."""
    z1, z2, u, zjs = _draws(cuda, steps=steps, n=paths, seed=members)
    u = u if explicit_u else None
    pop = _k1_population(members, seed=steps)
    kw = dict(seed=7, antithetic=True, companion=True, steps_major=True)
    n0 = ck.svj_terminal_from_draws.launches
    ker = ck.svj_terminal_from_draws_population(pop, 100.0, 0.5, z1, z2, u,
                                                zjs, **kw)
    torch.cuda.synchronize()
    assert ck.svj_terminal_from_draws.launches == n0 + 1
    ref = ck.svj_terminal_from_draws_population_plain(pop, 100.0, 0.5, z1,
                                                      z2, u, zjs, **kw)
    assert ker[0].shape == (members, 2, paths)
    for got, want in zip(ker, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("members", [K1_BLOCK_MEMBERS,
                                     K1_BLOCK_MEMBERS + 1])
@pytest.mark.parametrize("antithetic,companion,explicit_u",
                         [(True, True, True), (True, False, False),
                          (False, True, False)])
def test_k1_population_members_equal_single_launches(
        cuda, members, antithetic, companion, explicit_u):
    """Member p of a P-member launch is, word for word, the one-member
    launch on its parameters (other member counts per thread, other
    instantiations)."""
    z1, z2, u, zjs = _draws(cuda, steps=63, n=100_001, seed=3)
    u = u if explicit_u else None
    pop = _k1_population(members, seed=11)
    kw = dict(seed=9, antithetic=antithetic, companion=companion,
              steps_major=True)
    ker = ck.svj_terminal_from_draws_population(pop, 22500.0, 0.25, z1, z2,
                                                u, zjs, **kw)
    for p, params in enumerate(pop):
        one = ck.svj_terminal_from_draws(params, 22500.0, 0.25, z1, z2, u,
                                         zjs, **kw)
        for got, ref in zip(ker, one):
            if ref is not None:
                assert torch.equal(got[p], ref), p


def _k1_generation(members, seed):
    """A stage-2 DE generation as `/api/calibrate` prices it: the chain's
    Heston core, jump parameters drawn in the calibration's bounds."""
    from mcos_tpu_torch.profile_price import CHAIN_PARAMS

    core = {k: CHAIN_PARAMS[k] for k in ("kappa", "theta", "xi", "rho", "v0",
                                         "r", "q")}
    return [SVJParams(**core, lambda_j=float(a), mu_j=float(b),
                      sigma_j=float(c))
            for a, b, c in _calibration_population(members, 2, seed)]


@pytest.mark.parametrize("case", ["price", "calibration"])
def test_k1_matches_reference_algebra_twin(cuda, case):
    """K1 against the Euler twin (the JAX package's step algebra, per step,
    `simulate.simulate_terminal_from_draws` on both branches) path by path,
    at `/api/price`'s one member x 500 000 paths x 63 steps (in-kernel jump
    uniforms; the twin takes the same Philox stream) and at
    `/api/calibrate`'s 24-member generation x 100 000 x 50 (streamed
    uniforms): S and G to rtol 1e-5. Only the roundings of the two
    algebras differ."""
    from mcos_tpu_torch.engine.pricer import _euler_twin_pair

    if case == "price":
        pop, spot, T, steps, n = [SVJParams()], 22500.0, 0.25, 63, 500_000
    else:
        pop, spot, T, steps, n = _k1_generation(24, 16), 100.0, 0.5, 50, \
            100_000
    z1, z2, u, zjs = _draws(cuda, steps=steps, n=n, seed=4)
    if case == "price":
        u_kernel, u = None, ck.philox_jump_uniforms(steps, n, 7, cuda)
    else:
        u_kernel = u
    kw = dict(seed=7, antithetic=True, companion=True, steps_major=True)
    ker = ck.svj_terminal_from_draws_population(pop, spot, T, z1, z2,
                                                u_kernel, zjs, **kw)
    for p, params in enumerate(pop):
        twin = _euler_twin_pair(params, spot, T, z1, z2, u, zjs, True, True,
                                True)
        for i in (0, 2):
            torch.testing.assert_close(ker[i][p], twin[i], rtol=1e-5,
                                       atol=0)


@pytest.mark.parametrize("steps", [1, 5, 13, 252])
def test_k2_kernel_matches_plain(cuda, steps):
    kw = dict(num_paths=50_001, num_steps=steps, device=cuda)
    n0 = ck.gbm_terminal.launches
    ker = ck.gbm_terminal(22500.0, 0.2, 0.065, 0.012, 1.0, 3, **kw)
    torch.cuda.synchronize()
    assert ck.gbm_terminal.launches == n0 + 1
    ref = ck.gbm_terminal_plain(22500.0, 0.2, 0.065, 0.012, 1.0, 3, **kw)
    torch.testing.assert_close(ker, ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("steps", [4, 8, 11, 18, 1024])
@pytest.mark.parametrize("antithetic", [True, False])
def test_k2_unrolled_quads_match_plain(cuda, steps, antithetic):
    """K2 takes two quads an iteration, then at most one full quad and one
    partial one: step counts that end on each, at an odd pair count that
    fills no whole block, against the plain version (rtol 1e-5)."""
    kw = dict(num_paths=65_537, num_steps=steps, antithetic=antithetic,
              device=cuda)
    n0 = ck.gbm_terminal.launches
    ker = ck.gbm_terminal(22500.0, 0.2, 0.065, 0.012, 1.0, 5, **kw)
    torch.cuda.synchronize()
    assert ck.gbm_terminal.launches == n0 + 1
    assert ker.shape == (2 if antithetic else 1, 65_537)
    ref = ck.gbm_terminal_plain(22500.0, 0.2, 0.065, 0.012, 1.0, 5, **kw)
    torch.testing.assert_close(ker, ref, rtol=1e-5, atol=0)


def test_k2_box_muller_and_k9_sincos_on_every_uniform(cuda):
    """Over all 2^23 uniforms of the grid: K2's radius (hardware log2 and
    rsqrt, the series near u1 = 1) is finite, positive and within 1e-5 of
    float64, and so are its cosine and sine (hardware __sincosf on the
    centred angle); K9's sincosf gives the bits of sinf and cosf and of
    torch's sin and cos, which the plain version calls."""
    from mcos_tpu_torch import kernel_lab

    built = kernel_lab.build({"new": ck.CSRC_DIR})["new"]
    res = kernel_lab.probes(kernel_lab._load(built["probe_lib"]), cuda)
    assert res["k2_radius_finite_positive"]
    assert res["k2_radius_max_abs_err"] < 1e-5
    assert res["k2_cos_max_abs_err"] < 1e-5
    assert res["k2_sin_max_abs_err"] < 1e-5
    for key in ("k9_sincosf_equals_sinf", "k9_sincosf_equals_cosf",
                "k9_sincosf_equals_torch_sin", "k9_sincosf_equals_torch_cos"):
        assert res[key], key


def test_sobol_on_card_equals_cpu(cuda):
    a = sobol.sobol_svj_draws(5000, 9, seed=4, jump_uniforms=False,
                              device=cuda)
    b = sobol.sobol_svj_draws(5000, 9, seed=4, jump_uniforms=False,
                              device="cpu")
    for x, y in zip((a[0], a[1], a[3]), (b[0], b[1], b[3])):
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=1e-5)


def test_engine_on_card_matches_cpu(cuda):
    p = _P.replace(lambda_j=0.0)
    kw = dict(num_paths=20_000, num_steps=252, seed=5)
    a = MonteCarloEngine(p, device=cuda, **kw).price(22500.0, 22500.0, 0.2)
    b = MonteCarloEngine(p, device="cpu", **kw).price(22500.0, 22500.0, 0.2)
    for k in ("price", "std_error", "raw_mc_price", "bs_ref"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def _assert_terminal_close(ker, ref, companion):
    """Kernel against plain on the same words. rtol 1e-5 on S and G: the
    kernel's multiply-adds are contracted to FMAs and the plain version's
    are not; v can sit at 0, so rtol 1e-4 beside atol 1e-6."""
    assert (ker[2] is None) == (not companion)
    torch.testing.assert_close(ker[0], ref[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(ker[1], ref[1], rtol=1e-4, atol=1e-6)
    if companion:
        torch.testing.assert_close(ker[2], ref[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["svj_terminal", "svj_terminal_qe"])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("companion", [True, False])
@pytest.mark.parametrize("steps", [1, 16, 63])
def test_prng_kernels_match_plain(cuda, name, antithetic, companion, steps):
    """K3 and K4 against their plain versions on the same Philox words, bit
    for bit on S, v and G: both write every operation on their carries as
    the plain versions do (csrc/philox.cuh: fmul, fadd)."""
    kernel, plain = getattr(ck, name), getattr(ck, name + "_plain")
    kw = dict(num_paths=10_007, num_steps=steps, antithetic=antithetic,
              companion=companion, device=cuda)
    n0 = kernel.launches
    ker = kernel(_P, 22500.0, 0.25, 11, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref = plain(_P, 22500.0, 0.25, 11, **kw)
    assert (ker[2] is None) == (not companion)
    for a, b in zip(ker, ref):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["svj_terminal", "svj_terminal_qe"])
@pytest.mark.parametrize("pairs", [10_007, 200_003])
@pytest.mark.parametrize("steps", [13, 63])
def test_prng_kernels_bit_equal_at_ragged_pair_counts(cuda, name, pairs,
                                                      steps):
    """K3 and K4 at pair counts that fill no whole block or wave and odd
    step counts (K3's last step on the first half of a call), at the
    route's parameters: S, v and G bit for bit, one launch a call."""
    kernel, plain = getattr(ck, name), getattr(ck, name + "_plain")
    kw = dict(num_paths=pairs, num_steps=steps, antithetic=True,
              companion=True, device=cuda)
    n0 = kernel.launches
    ker = kernel(SVJParams(), 22500.0, 0.25, 42, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref = plain(SVJParams(), 22500.0, 0.25, 42, **kw)
    for a, b in zip(ker, ref):
        assert a.shape == (2, pairs) and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("steps", [4, 8])
@pytest.mark.parametrize("antithetic", [True, False])
def test_k4_bit_equal_where_both_qe_branches_run(cuda, steps, antithetic):
    """K4 at kernel_lab.K5_PSI (T = 1), where its QE transition takes the
    quadratic branch, the exponential branch and its mass at zero along
    the plain version's path (tests/test_torch_acklam_converged.py): each
    branch is computed only under its own test, and S, v and G keep the
    plain version's bits."""
    from mcos_tpu_torch.kernel_lab import K5_PSI

    params = SVJParams(**K5_PSI)
    kw = dict(num_paths=200_003, num_steps=steps, antithetic=antithetic,
              companion=True, device=cuda)
    ker = ck.svj_terminal_qe(params, 22500.0, 1.0, 42, **kw)
    ref = ck.svj_terminal_qe_plain(params, 22500.0, 1.0, 42, **kw)
    assert bool((ker[1] == 0).any()) and bool((ker[1] > 0).any())
    for a, b in zip(ker, ref):
        assert a.shape == (2 if antithetic else 1, 200_003)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["svj_terminal", "svj_terminal_qe"])
def test_prng_kernel_stream_is_shape_free(cuda, name):
    """The first n pairs of a 2n launch are the n launch, bit for bit."""
    kernel = getattr(ck, name)
    kw = dict(num_steps=9, companion=True, device=cuda)
    a = kernel(_P, 100.0, 0.5, 3, num_paths=5000, **kw)
    b = kernel(_P, 100.0, 0.5, 3, num_paths=10_000, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y[:, :5000], rtol=0, atol=0)


def test_k3_negative_v0_is_clamped(cuda):
    p = _P.replace(v0=-0.01)
    s, v, _ = ck.svj_terminal(p, 100.0, 0.5, 1, num_paths=4096,
                              num_steps=12, device=cuda)
    assert bool(torch.isfinite(s).all()) and bool((v >= 0).all())


@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("companion", [True, False])
@pytest.mark.parametrize("explicit_u", [True, False])
def test_k5_kernel_matches_plain(cuda, antithetic, companion, explicit_u):
    """K5 on a Sobol QE net against its plain version."""
    z_x, u_v, u, z_js = sobol.sobol_qe_draws(10_007, 20, seed=6,
                                             jump_uniforms=explicit_u,
                                             device=cuda)
    kw = dict(seed=9, antithetic=antithetic, companion=companion,
              steps_major=True)
    n0 = ck.svj_terminal_qe_from_draws.launches
    ker = ck.svj_terminal_qe_from_draws(_P, 22500.0, 0.5, z_x, u_v, u, z_js,
                                        **kw)
    torch.cuda.synchronize()
    assert ck.svj_terminal_qe_from_draws.launches == n0 + 1
    ref = ck.svj_terminal_qe_from_draws_plain(_P, 22500.0, 0.5, z_x, u_v, u,
                                              z_js, **kw)
    _assert_terminal_close(ker, ref, companion)


def _k5_case(case: str, device):
    """(params, T, z_x, u_v, z_js) of a K5 case on a Sobol QE net of 65 537
    paths: the route's defaults (63 steps); the psi cases of kernel_lab
    (T = 1, 4 and 8 steps, where the QE transition takes both branches);
    u_v moved into Acklam's tails (below 0.024 or above 0.976), and a
    net whose even paths are in the tails and odd ones in the centre."""
    from mcos_tpu_torch import kernel_lab

    steps = {"psi_4": 4, "psi_8": 8}.get(case, 63)
    z_x, u_v, _, z_js = sobol.sobol_qe_draws(65_537, steps, seed=42,
                                             jump_uniforms=False,
                                             device=device)
    if case.startswith("psi"):
        return SVJParams(**kernel_lab.K5_PSI), 1.0, z_x, u_v, z_js
    tail = torch.clamp(
        torch.where(u_v < 0.5, u_v * 0.048, 1.0 - (1.0 - u_v) * 0.048),
        max=float(np.float32(1.0 - 2.0 ** -24)))
    if case == "tail":
        u_v = tail
    elif case == "mixed":
        even = torch.arange(u_v.shape[1], device=device) % 2 == 0
        u_v = torch.where(even, tail, 0.03 + u_v * 0.94)
    return SVJParams(), 0.25, z_x, u_v, z_js


@pytest.mark.parametrize("case", ["route", "psi_4", "psi_8", "tail",
                                  "mixed"])
@pytest.mark.parametrize("explicit_u", [True, False])
def test_k5_variance_bit_for_bit(cuda, case, explicit_u):
    """K5 computes Acklam's two regions as one sequence of float FMAs and
    each QE branch only under its own test; the variance path keeps the
    plain version's bits (rtol 0) where the route runs, where both QE
    branches run, and where u_v sits in Acklam's tails, all of a warp or
    half of it; S and G keep the Euler tolerance (rtol 1e-5)."""
    params, T, z_x, u_v, z_js = _k5_case(case, cuda)
    qc = (u_v - 0.5).abs()
    central = qc <= float(np.float32(0.47575))
    if case == "tail":
        assert not bool(central.any())
    if case == "mixed":
        assert bool(central[:, 1::2].all()) and not bool(
            central[:, ::2].any())
    u = None
    if explicit_u:
        g = torch.Generator(device=cuda)
        g.manual_seed(2)
        u = torch.rand(z_x.shape, generator=g, device=cuda)
    kw = dict(seed=42, antithetic=True, companion=True, steps_major=True)
    ker = ck.svj_terminal_qe_from_draws(params, 22500.0, T, z_x, u_v, u,
                                        z_js, **kw)
    ref = ck.svj_terminal_qe_from_draws_plain(params, 22500.0, T, z_x, u_v,
                                              u, z_js, **kw)
    torch.testing.assert_close(ker[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(ker[0], ref[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(ker[2], ref[2], rtol=1e-5, atol=0)


def test_k5_acklam_on_every_float32(cuda):
    """Over all 1 065 353 215 float32 in (0, 1): Acklam's inverse with a
    float FMA for each Horner step, in two regions and as K5's one
    converged sequence (svj_qe_draws.cu:acklam_converged), gives the bits
    of mcos::acklam_ndtri's double steps, the plain version's arithmetic."""
    from mcos_tpu_torch import kernel_lab

    built = kernel_lab.build({"new": ck.CSRC_DIR}, ("k5",))["new"]
    res = kernel_lab.acklam_probe(kernel_lab._load(built["k5_lib"]), cuda,
                                  True)
    assert res["fmaf_step"]["mismatches"] == 0
    assert res["k5"]["mismatches"] == 0


def test_sobol_qe_on_card_equals_cpu(cuda):
    a = sobol.sobol_qe_draws(5000, 9, seed=4, jump_uniforms=False,
                             device=cuda)
    b = sobol.sobol_qe_draws(5000, 9, seed=4, jump_uniforms=False,
                             device="cpu")
    for x, y in zip((a[0], a[1], a[3]), (b[0], b[1], b[3])):
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=1e-5)


@pytest.mark.parametrize("extra, kernel", [
    ({"use_sobol": False}, "svj_terminal"),
    ({"use_sobol": False, "scheme": "qe"}, "svj_terminal_qe"),
    ({"scheme": "qe"}, "svj_terminal_qe_from_draws"),
    ({"rqmc_randomizations": 2}, "svj_terminal_from_draws"),
    ({"use_importance": True, "strike": 28000.0}, None),
])
def test_handle_price_options_on_card(cuda, extra, kernel):
    from mcos_tpu_torch.api import coalesce, server

    body = dict({"spot": 22500.0, "strike": 22500.0, "T": 0.1,
                 "num_paths": 20_000}, **extra)
    window, coalesce.coalescer.window_s = coalesce.coalescer.window_s, 0.0
    try:
        before = ck.launch_counts()
        res = server.handle_price(body, device=cuda)
        after = ck.launch_counts()
    finally:
        coalesce.coalescer.window_s = window
    assert np.isfinite(res["price"]) and res["std_error"] > 0
    assert res["post_checks"]["pass"], res["post_checks"]
    if kernel is not None:
        n = extra.get("rqmc_randomizations", 1)
        assert after[kernel] - before[kernel] == n


def test_handle_convergence_on_card(cuda):
    from mcos_tpu_torch.api import server

    res = server.handle_convergence(
        {"spot": 22500.0, "strike": 22500.0, "T": 0.1, "num_paths": 20_000},
        device=cuda)
    assert res["num_paths"][-1] == 20_000
    assert all(np.isfinite(res["price"])) and res["std_error"][-1] > 0


@pytest.mark.parametrize("scheme, kernel", [("euler", "svj_terminal"),
                                            ("qe", "svj_terminal_qe")])
def test_price_to_tolerance_on_card(cuda, scheme, kernel):
    """The adaptive entry point at its own batch shapes (2^18 pairs and up):
    one K3 (or K4) launch per batch, the pooled price within 4 se + 1 % of
    the COS oracle (the 1 % covers the Euler/QE discretisation bias at 63
    steps)."""
    from mcos_tpu_torch.ops.cos_pricer import cos_price

    eng = MonteCarloEngine(SVJParams(), scheme=scheme, device=cuda)
    before = ck.launch_counts()
    res = eng.price_to_tolerance(22500.0, 22500.0, 0.25, tolerance=5e-4,
                                 max_paths=1 << 21, batch_paths=1 << 18)
    after = ck.launch_counts()
    assert res["num_batches"] >= 2
    assert after[kernel] - before[kernel] == res["num_batches"]
    cos = float(cos_price(SVJParams(), 22500.0, [22500.0], 0.25, True)[0])
    assert abs(res["price"] - cos) < 4 * res["std_error"] + 0.01 * cos


# ── K6 `svj_path_stats` and the exotics engine ──────────────────────────────
_K6_VARIANTS = {
    "no_bridge": dict(),
    "up": dict(bridge=True, bridge_up=True, bridge_log_b=0.08),
    "down": dict(bridge=True, bridge_up=False, bridge_log_b=-0.08),
    "corridor": dict(bridge=True, corridor=True, bridge_log_b=0.09,
                     bridge_log_l=-0.09),
}


def _assert_stats_close(ker, ref):
    """K6 against its plain version on the same words, bit for bit: the
    kernel rounds each operation as the plain version does and its library
    functions are the plain version's on the card, so the dead/alive state
    is equal on every path and every output is the same float (-inf equal
    to -inf)."""
    assert set(ker) == set(ref)
    for key in ker:
        a, b = ker[key], ref[key]
        if key.endswith("log_surv"):
            assert bool((torch.isinf(a) == torch.isinf(b)).all()), key
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# (variant, steps, window); a window needs a bridge
_K6_CASES = [(v, steps, window) for v in _K6_VARIANTS
             for steps, window in ((1, None), (16, None), (63, None),
                                   (63, (13, 50)))
             if window is None or v != "no_bridge"]


@pytest.mark.parametrize("variant,steps,window", _K6_CASES)
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("companion", [True, False])
def test_k6_kernel_matches_plain(cuda, variant, antithetic, companion, steps,
                                 window):
    kw = dict(_K6_VARIANTS[variant], num_paths=20_011, num_steps=steps,
              antithetic=antithetic, companion=companion, window=window,
              device=cuda)
    n0 = ck.svj_path_stats.launches
    ker = ck.svj_path_stats(_P, 22500.0, 0.25, 11, **kw)
    torch.cuda.synchronize()
    assert ck.svj_path_stats.launches == n0 + 1
    ref = ck.svj_path_stats_plain(_P, 22500.0, 0.25, 11, **kw)
    assert len(ker) == (5 if variant == "no_bridge" else 6) * (
        2 if companion else 1)
    _assert_stats_close(ker, ref)


def test_k6_stream_is_shape_free_and_v0_clamped(cuda):
    kw = dict(_K6_VARIANTS["corridor"], num_steps=9, device=cuda)
    a = ck.svj_path_stats(_P, 100.0, 0.5, 3, num_paths=5000, **kw)
    b = ck.svj_path_stats(_P, 100.0, 0.5, 3, num_paths=10_000, **kw)
    for k in a:
        torch.testing.assert_close(a[k], b[k][:, :5000], rtol=0, atol=0)
    # no companion: its volatility is sqrt(v0), as in the reference
    neg = ck.svj_path_stats(_P.replace(v0=-0.01), 100.0, 0.5, 1,
                            num_paths=4096, num_steps=12, companion=False,
                            device=cuda)
    assert all(bool(torch.isfinite(v).all()) for v in neg.values())
    with pytest.raises(ValueError):
        ck.svj_path_stats(_P, 100.0, 0.5, 1, num_paths=64, num_steps=4,
                          window=(0, 2), device=cuda)


@pytest.mark.parametrize("method, args, kernel, launches", [
    ("price_asian", (22500.0, 22500.0, 0.25), "svj_path_stats", 1),
    ("price_barrier", (22500.0, 22500.0, 0.25, 24500.0), "svj_path_stats", 1),
    ("price_one_touch", (22500.0, 0.25, 24500.0), "svj_path_stats", 1),
    ("price_double_barrier", (22500.0, 22500.0, 0.25, 20500.0, 24500.0),
     "svj_path_stats", 1),
    ("price_double_no_touch", (22500.0, 0.25, 20500.0, 24500.0),
     "svj_path_stats", 1),
    ("price_lookback", (22500.0, 0.25), "svj_path_stats", 1),
    ("price_digital", (22500.0, 22500.0, 0.25), "svj_terminal", 1),
])
def test_exotic_engine_launch_counts(cuda, method, args, kernel, launches):
    """Each pricing method launches its kernel once: K6, or K3 for the
    digital; and the card's price is the CPU's (same words, plain version)
    to float32 sums."""
    from mcos_tpu_torch.engine.exotics import ExoticEngine

    before = ck.launch_counts()
    res = getattr(ExoticEngine(_P, num_paths=20_000, device=cuda),
                  method)(*args)
    after = ck.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {kernel: launches}
    ref = getattr(ExoticEngine(_P, num_paths=20_000, device="cpu"),
                  method)(*args)
    assert ck.launch_counts() == after
    assert res.keys() == ref.keys()
    np.testing.assert_allclose(res["price"], ref["price"], rtol=2e-4)
    np.testing.assert_allclose(res["std_error"], ref["std_error"], rtol=2e-3)


def test_exotic_greeks_on_card(cuda):
    """Autograd Greeks run the twin (no launch); discrete-barrier Greeks
    re-price five times on K6."""
    from mcos_tpu_torch.engine.exotics import ExoticEngine

    eng = ExoticEngine(_P, num_paths=20_000, device=cuda)
    before = ck.launch_counts()
    g = eng.greeks(22500.0, 22500.0, 0.25, kind="asian")
    assert ck.launch_counts() == before
    assert g["method"] == "pathwise_ad" and 0.3 < g["delta"] < 0.8
    g = eng.greeks(22500.0, 22500.0, 0.25, kind="barrier", barrier=24500.0,
                   monitoring="bridge")
    assert ck.launch_counts() == before and np.isfinite(g["vega"])
    g = eng.greeks(22500.0, 22500.0, 0.25, kind="barrier", barrier=24500.0)
    assert ck.launch_counts()["svj_path_stats"] \
        == before["svj_path_stats"] + 5
    assert g["method"] == "crn_fd_homogeneity" and np.isfinite(g["delta"])


def test_handle_exotic_on_card(cuda):
    from mcos_tpu_torch.api import server

    before = ck.launch_counts()
    res = server.handle_exotic(
        {"spot": 22500.0, "T": 0.25, "kind": "double_barrier",
         "strike": 22500.0, "barrier": 24500.0, "barrier_lo": 20500.0,
         "num_paths": 20_000}, device=cuda)
    assert ck.launch_counts()["svj_path_stats"] \
        == before["svj_path_stats"] + 1
    assert np.isfinite(res["price"]) and res["std_error"] > 0
    assert res["monitoring"] == "bridge"


# ── K7 `hhw_terminal`, K8 `svcj_terminal`, K9 `svj_terminal_td` ─────────────
def _family_case(name, steps):
    """(kernel, plain, positional arguments) of one model-family kernel."""
    from mcos_tpu_torch.models.params import SVCJParams
    from mcos_tpu_torch.ops.hhw import HHWParams

    if name == "hhw_terminal":
        return ck.hhw_terminal, ck.hhw_terminal_plain, (
            HHWParams(rho_vr=0.2), 22500.0, 2.0, 11)
    if name == "svcj_terminal":
        # lambda_j = 8: a few jumps on most paths, so the jump branch runs
        return ck.svcj_terminal, ck.svcj_terminal_plain, (
            SVCJParams(lambda_j=8.0), 22500.0, 0.5, 11)
    idx = np.arange(steps)
    levels = (np.where(idx < steps // 2, 0.04, 0.09),
              np.where(idx < steps // 3, 0.5, 0.9),
              np.where(idx < steps // 2, 1.0, 6.0))
    return ck.svj_terminal_td, ck.svj_terminal_td_plain, (
        _P, *levels, 22500.0, 0.5, 11)


@pytest.mark.parametrize("name", ["hhw_terminal", "svcj_terminal",
                                  "svj_terminal_td"])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("steps", [1, 2, 7, 128])
def test_family_kernels_match_plain(cuda, name, antithetic, steps):
    """K7, K8 and K9 against their plain versions on the same Philox words.
    Their carries are written with uncontracted IEEE operations in the
    plain versions' order, so the tolerance is tight: K7 bit for bit on S
    and D (torch's exp gives expf's bits); K8 and K9 rtol 2e-6, and on v,
    which no exp touches, equality."""
    kernel, plain, args = _family_case(name, steps)
    kw = dict(num_paths=10_007, num_steps=steps, antithetic=antithetic,
              device=cuda)
    if name != "hhw_terminal":
        kw["companion"] = True
    n0 = kernel.launches
    ker = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref = plain(*args, **kw)
    assert kernel.launches == n0 + 1
    rtol = 0 if name == "hhw_terminal" else 2e-6
    for a, b in zip(ker, ref):
        assert a.shape == (2 if antithetic else 1, 10_007)
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=rtol, atol=0)
    if name != "hhw_terminal":
        torch.testing.assert_close(ker[1], ref[1], rtol=0, atol=0)
        no_g = kernel(*args, **dict(kw, companion=False))
        assert no_g[2] is None
        torch.testing.assert_close(no_g[0], ker[0], rtol=0, atol=0)


@pytest.mark.parametrize("lam", [0.0, 1.0, 8.0])
@pytest.mark.parametrize("steps", [7, 63, 252])
@pytest.mark.parametrize("companion", [True, False])
def test_k8_bit_equal_at_each_jump_rate(cuda, lam, steps, companion):
    """K8 draws the jump sizes' normals and the exponential only for a step
    pair in which a jump lands; S, v and G stay bit for bit with the plain
    version where that never happens (lambda = 0), at the route's default
    (lambda = 1: 22 % of a warp's step pairs) and where most step pairs of
    a warp take it (lambda = 8)."""
    from mcos_tpu_torch.models.params import SVCJParams

    args = (SVCJParams(lambda_j=lam), 22500.0, steps / 252, 11)
    kw = dict(num_paths=20_011, num_steps=steps, companion=companion,
              device=cuda)
    ker = ck.svcj_terminal(*args, **kw)
    ref = ck.svcj_terminal_plain(*args, **kw)
    assert (ker[2] is None) == (not companion)
    for a, b in zip(ker, ref):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["hhw_terminal", "svcj_terminal",
                                  "svj_terminal_td"])
def test_family_kernel_stream_is_shape_free(cuda, name):
    """The first n pairs of a 2n launch are the n launch, bit for bit."""
    kernel, _, args = _family_case(name, 9)
    a = kernel(*args, num_paths=5000, num_steps=9, device=cuda)
    b = kernel(*args, num_paths=10_000, num_steps=9, device=cuda)
    for x, y in zip(a, b):
        if x is not None:
            torch.testing.assert_close(x, y[:, :5000], rtol=0, atol=0)


def test_k7_common_random_numbers_and_bad_correlation(cuda):
    """Two parameter sets on one seed share their normals: with sigma_r
    tiny the discount factor is the deterministic one on every path, and
    the spot moves little. A correlation matrix that is not positive
    definite raises before any launch."""
    from mcos_tpu_torch.ops.hhw import HHWParams

    p = HHWParams()
    kw = dict(num_paths=4096, num_steps=16, device=cuda)
    s, _ = ck.hhw_terminal(p, 100.0, 1.0, 3, **kw)
    s0, d0 = ck.hhw_terminal(HHWParams(sigma_r=1e-8), 100.0, 1.0, 3, **kw)
    assert float(d0.std()) < 1e-6
    assert float((s / s0 - 1).abs().max()) < 0.05
    n0 = ck.hhw_terminal.launches
    with pytest.raises(ValueError, match="positive definite"):
        ck.hhw_terminal(HHWParams(rho_sv=-0.999, rho_sr=0.999, rho_vr=0.999),
                        100.0, 1.0, 3, **kw)
    assert ck.hhw_terminal.launches == n0


@pytest.mark.parametrize("pairs", [10_007, 200_003])
@pytest.mark.parametrize("steps", [127, 128])
@pytest.mark.parametrize("antithetic", [True, False])
def test_k7_bit_equal_at_ragged_pair_counts(cuda, pairs, steps, antithetic):
    """K7 at pair counts that fill no whole block or wave, at the route's
    128 steps and an odd count (the last step on a call of its own), one
    and two branches: S and D bit for bit, one launch a call."""
    kernel, plain, args = _family_case("hhw_terminal", steps)
    kw = dict(num_paths=pairs, num_steps=steps, antithetic=antithetic,
              device=cuda)
    n0 = kernel.launches
    ker = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref = plain(*args, **kw)
    for a, b in zip(ker, ref):
        assert a.shape == (2 if antithetic else 1, pairs)
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("pairs", [10_007, 200_003])
@pytest.mark.parametrize("steps", [63, 64])
def test_k9_bit_equal_at_ragged_pair_counts(cuda, pairs, steps):
    """K9 at pair counts that fill no whole block or wave, even and odd
    step counts: S and G within rtol 2e-6, v equal bit for bit; one launch
    a call, and a warm call with the same table finds it on the device
    (no host-to-device copy of the step table)."""
    kernel, plain, args = _family_case("svj_terminal_td", steps)
    kw = dict(num_paths=pairs, num_steps=steps, antithetic=True,
              companion=True, device=cuda)
    n0 = kernel.launches
    ker = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref = plain(*args, **kw)
    for a, b in zip(ker, ref):
        assert a.shape == (2, pairs) and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=2e-6, atol=0)
    torch.testing.assert_close(ker[1], ref[1], rtol=0, atol=0)
    info = ck._device_step_table.cache_info()
    again = kernel(*args, **kw)
    assert kernel.launches == n0 + 2
    assert ck._device_step_table.cache_info().hits == info.hits + 1
    assert ck._device_step_table.cache_info().misses == info.misses
    for a, b in zip(again, ker):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k9_negative_v0_is_clamped(cuda):
    levels = (np.full(12, 0.04), np.full(12, 0.5), np.full(12, 1.0))
    s, v, _ = ck.svj_terminal_td(_P.replace(v0=-0.01), *levels, 100.0, 0.5,
                                 1, num_paths=4096, num_steps=12,
                                 device=cuda)
    assert bool(torch.isfinite(s).all()) and bool((v >= 0).all())


@pytest.mark.parametrize("family", ["hhw", "svcj", "termsvj"])
def test_family_engines_launch_once(cuda, family):
    """`HHWEngine.price`, `SVCJEngine.price` and `TDSVJEngine.price` each
    launch their kernel once and no other; the card's price is the CPU's
    (same words, plain version) to float32 sums."""
    from mcos_tpu_torch.engine.hhw import HHWEngine
    from mcos_tpu_torch.engine.svcj import SVCJEngine
    from mcos_tpu_torch.engine.termsvj import TDSVJEngine
    from mcos_tpu_torch.models.params import SVCJParams
    from mcos_tpu_torch.ops.hhw import HHWParams

    def engine(device):
        if family == "hhw":
            return HHWEngine(HHWParams(), num_paths=20_000, num_steps=32,
                             device=device), "hhw_terminal"
        if family == "svcj":
            return SVCJEngine(SVCJParams(), num_paths=20_000,
                              device=device), "svcj_terminal"
        return TDSVJEngine(_P, [0.1, 0.25], [0.04, 0.09], [0.5, 0.8],
                           [1.0, 3.0], num_paths=20_000, num_steps=32,
                           device=device), "svj_terminal_td"

    eng, kernel = engine(cuda)
    before = ck.launch_counts()
    res = eng.price(22500.0, 22500.0, 0.25)
    after = ck.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {kernel: 1}
    ref = engine("cpu")[0].price(22500.0, 22500.0, 0.25)
    assert ck.launch_counts() == after
    assert res.keys() == ref.keys()
    np.testing.assert_allclose(res["price"], ref["price"], rtol=2e-4)
    np.testing.assert_allclose(res["std_error"], ref["std_error"], rtol=2e-3)


def _rough_case(name, hurst, steps, T=0.25, seed=7):
    from mcos_tpu_torch.ops.rough import rbergomi_lift

    c, d, g, tail = rbergomi_lift(hurst, T, steps)
    kernel, plain = getattr(ck, name), getattr(ck, name + "_plain")
    if name == "rbergomi_lift_integrals":
        args = (1.9, T, seed, c, d, g, tail, hurst)
        kw = {"xi_flat": 0.04}
    else:
        args = ((1.9, -0.9, 0.05, 0.01, 0.04, 100.0), T, seed, c, d, g, tail,
                hurst)
        kw = {}
    return kernel, plain, args, kw, len(c)


def _as_tuple(out):
    return tuple(out.values()) if isinstance(out, dict) else tuple(out)


@pytest.mark.parametrize("name", ["rbergomi_lift_integrals",
                                  "rbergomi_lift_stats"])
@pytest.mark.parametrize("hurst", [0.07, 0.5])
@pytest.mark.parametrize("antithetic", [True, False])
@pytest.mark.parametrize("steps", [1, 2, 7, 64])
def test_rough_kernels_match_plain(cuda, name, hurst, antithetic, steps):
    """K10 and K11 against their plain versions on the same Philox words, at
    25 factors (H = 0.07) and one (H = 0.5), even and odd step counts: every
    operation on the carries is the plain version's IEEE operation in its
    order, and the exps and square roots are the same library calls, so
    every output is equal bit for bit."""
    kernel, plain, args, kw, m = _rough_case(name, hurst, steps)
    assert m == (1 if hurst == 0.5 else 25)
    kw = dict(kw, num_paths=10_007, num_steps=steps, antithetic=antithetic,
              device=cuda)
    n0 = kernel.launches
    ker = _as_tuple(kernel(*args, **kw))
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref = _as_tuple(plain(*args, **kw))
    assert kernel.launches == n0 + 1
    for a, b in zip(ker, ref):
        assert a.shape == (2 if antithetic else 1, 10_007)
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["rbergomi_lift_integrals",
                                  "rbergomi_lift_stats"])
def test_rough_kernel_stream_is_shape_free(cuda, name):
    """The first n pairs of a 2n launch are the n launch, bit for bit, and
    the single-branch launch is the antithetic one's base branch."""
    kernel, _, args, kw, _ = _rough_case(name, 0.07, 9)
    a = _as_tuple(kernel(*args, num_paths=5000, num_steps=9, device=cuda,
                         **kw))
    b = _as_tuple(kernel(*args, num_paths=10_000, num_steps=9, device=cuda,
                         **kw))
    c = _as_tuple(kernel(*args, num_paths=5000, num_steps=9,
                         antithetic=False, device=cuda, **kw))
    for x, y, z in zip(a, b, c):
        torch.testing.assert_close(x, y[:, :5000], rtol=0, atol=0)
        torch.testing.assert_close(x[:1], z, rtol=0, atol=0)


def test_rough_kernels_take_a_curve_and_refuse_many_factors(cuda):
    """A forward-variance curve rides the step table (kernel equal to its
    plain version); more than 32 factors raise before any launch."""
    kernel, plain, args, kw, _ = _rough_case("rbergomi_lift_integrals",
                                             0.1, 16)
    xi_t = np.linspace(0.02, 0.06, 16)
    kw = dict(num_paths=4096, num_steps=16, xi_t=xi_t, device=cuda)
    for a, b in zip(kernel(*args, **kw), plain(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = np.ones(33, np.float32)
    n0 = kernel.launches
    with pytest.raises(ValueError, match="factors"):
        kernel(1.9, 0.25, 1, c, c, c, np.zeros(16, np.float32), 0.1,
               num_paths=64, num_steps=16, device=cuda)
    assert kernel.launches == n0


def _rough_call_at_m(name, m, steps, pairs, device, fn="kernel"):
    """K10/K11 (or, with fn="plain", its plain version) on the H = 0.07
    tables cut or repeated to m factors: bit-equality needs no law, only
    the same tables."""
    kernel, plain, args, kw, _ = _rough_case(name, 0.07, steps)
    c, d, g = (np.resize(np.asarray(x, np.float32), m) for x in args[3:6])
    args = (*args[:3], c, d, g, *args[6:])
    f = kernel if fn == "kernel" else plain
    return _as_tuple(f(*args, num_paths=pairs, num_steps=steps,
                       device=device, **kw))


@pytest.mark.parametrize("name", ["rbergomi_lift_integrals",
                                  "rbergomi_lift_stats"])
@pytest.mark.parametrize("m", [24, 2, 7, 32])
@pytest.mark.parametrize("steps", [7, 64])
def test_rough_kernels_bit_equal_at_each_factor_count(cuda, name, m, steps):
    """m = 24 (the route's tables without the top-up node) runs the exact
    24-factor instantiation; m = 2, 7 and 32 the guarded fallback. Each is
    its plain version bit for bit."""
    n0 = getattr(ck, name).launches
    ker = _rough_call_at_m(name, m, steps, 10_007, cuda)
    torch.cuda.synchronize()
    assert getattr(ck, name).launches == n0 + 1
    ref = _rough_call_at_m(name, m, steps, 10_007, cuda, fn="plain")
    for a, b in zip(ker, ref):
        assert a.shape == (2, 10_007)
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["rbergomi_lift_integrals",
                                  "rbergomi_lift_stats"])
@pytest.mark.parametrize("pairs", [131_071, 131_073, 135_169])
def test_rough_kernels_bit_equal_at_ragged_pair_counts(cuda, name, pairs):
    """Pair counts just below and above the route's 131 072 (512 blocks of
    256) and at 528 blocks plus one pair (one more than 4 blocks an SM on
    132 SMs): the last block's idle threads write nothing and every pair
    is its plain version's, bit for bit, at 25 factors."""
    ker = _rough_call_at_m(name, 25, 16, pairs, cuda)
    torch.cuda.synchronize()
    ref = _rough_call_at_m(name, 25, 16, pairs, cuda, fn="plain")
    for a, b in zip(ker, ref):
        assert a.shape == (2, pairs)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rough_route_instantiations_fit_one_wave(cuda):
    """The route's instantiations (two branches, exact m = 25) spill
    nothing and hold at most 64 registers: 4 blocks of 256 an SM, so the
    route's 512 blocks run in one wave on the card's 132 SMs."""
    from mcos_tpu_torch import kernel_lab

    built = kernel_lab.build({"new": ck.CSRC_DIR}, ("k10", "k11"))["new"]
    res = {}
    for text in built["ptxas"].values():
        res.update(kernel_lab.ptxas_resources(text))
    route = {fn: r for fn, r in res.items()
             if re.search(r"rbergomi_(lift|stats)_kernelILi2ELi25ELb1E", fn)}
    assert len(route) == 2
    for fn, r in route.items():
        assert r["spill_stores"] == r["spill_loads"] == 0, fn
        assert r["registers"] <= 64, fn
        occ = kernel_lab.occupancy(r["registers"], 256, 512)
        assert occ["blocks_per_sm"] >= 4 and occ["waves"] <= 1, fn


def test_stats_and_svcj_route_instantiations_fit(cuda):
    """K6's route instantiations (two branches: the Asian, the barrier
    above and the corridor with the companion, the corridor without it)
    and K8's spill nothing and hold the registers of their redesign, so
    the exotic and family routes' 200 000 pairs (782 blocks of 256) take
    the waves below on the card's 132 SMs. K6's need no fewer: at a
    minimum of 5 or 4 blocks an SM ptxas spills them, and the time per
    pair does not fall where its launch fits one wave (PERF.md)."""
    from mcos_tpu_torch import kernel_lab

    built = kernel_lab.build({"new": ck.CSRC_DIR}, ("k6", "k8"))["new"]
    res = {}
    for text in built["ptxas"].values():
        res.update(kernel_lab.ptxas_resources(text))
    # (instantiation, most registers, blocks of 256 an SM, waves at 782)
    want = [("svj_stats_kernelILi2ELi0ELb1E", 57, 4, 1.481),
            ("svj_stats_kernelILi2ELi1ELb1E", 61, 4, 1.481),
            ("svj_stats_kernelILi2ELi3ELb1E", 76, 3, 1.975),
            ("svj_stats_kernelILi2ELi3ELb0E", 64, 4, 1.481),
            ("svcj_kernelILi2E", 40, 6, 0.987)]
    for pattern, registers, per_sm, waves in want:
        (fn,) = [fn for fn in res if pattern in fn]
        r = res[fn]
        assert r["spill_stores"] == r["spill_loads"] == 0, fn
        assert r["registers"] <= registers, (fn, r["registers"])
        occ = kernel_lab.occupancy(r["registers"], 256, 782)
        assert occ["blocks_per_sm"] >= per_sm, fn
        assert occ["waves"] <= waves + 1e-3, fn


def test_qe_draws_and_hhw_route_instantiations_fit(cuda):
    """K5's route instantiations (two branches; the jump uniforms drawn in
    the kernel or loaded) and K7's (two branches) spill nothing and hold
    the registers of their redesign, so the QE route's 500 000 paths (1954
    blocks of 256) and the families' 200 000 pairs (782 blocks) take the
    waves below on the card's 132 SMs. K5 needs no more blocks an SM: a
    minimum of 7 cost it 2.6 %, and its time per path is the same at two
    and at three whole waves as at the route's 2.47 (PERF.md)."""
    from mcos_tpu_torch import kernel_lab

    built = kernel_lab.build({"new": ck.CSRC_DIR}, ("k5", "k7"))["new"]
    res = {}
    for text in built["ptxas"].values():
        res.update(kernel_lab.ptxas_resources(text))
    # (instantiation, most registers, blocks of 256 an SM, blocks, waves)
    want = [("svj_qe_draws_kernelILi2ELb1E", 40, 6, 1954, 2.467),
            ("svj_qe_draws_kernelILi2ELb0E", 34, 6, 1954, 2.467),
            ("hhw_kernelILi2E", 38, 6, 782, 0.987)]
    for pattern, registers, per_sm, blocks, waves in want:
        (fn,) = [fn for fn in res if pattern in fn]
        r = res[fn]
        assert r["spill_stores"] == r["spill_loads"] == 0, fn
        assert r["registers"] <= registers, (fn, r["registers"])
        occ = kernel_lab.occupancy(r["registers"], 256, blocks)
        assert occ["blocks_per_sm"] >= per_sm, fn
        assert occ["waves"] <= waves + 1e-3, fn


@pytest.mark.parametrize("mode", ["price", "asian"])
def test_rough_engine_launches_once(cuda, mode):
    """At 512 steps `RoughBergomiEngine.price` launches K10 once and
    `price_asian` K11 once, and no other kernel; the card's price is the
    CPU's (same words, plain version) to float32 sums."""
    from mcos_tpu_torch.engine.rough import RoughBergomiEngine
    from mcos_tpu_torch.ops.rough import RoughBergomiParams

    def run(device):
        eng = RoughBergomiEngine(RoughBergomiParams(), num_paths=8192,
                                 num_steps=512, device=device)
        if mode == "price":
            return eng.price(100.0, [95.0, 100.0], 0.25)
        return eng.price_asian(100.0, 100.0, 0.25)

    kernel = ("rbergomi_lift_integrals" if mode == "price"
              else "rbergomi_lift_stats")
    before = ck.launch_counts()
    res = run(cuda)
    after = ck.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {kernel: 1}
    ref = run("cpu")
    assert res.keys() == ref.keys()
    np.testing.assert_allclose(res["price"], ref["price"], rtol=2e-4)
    np.testing.assert_allclose(res["std_error"], ref["std_error"], rtol=2e-3)


def test_handle_rough_on_card(cuda):
    """Every mode of /api/rough answers on the card at a small width; the
    lift requests launch K10 or K11 once each."""
    from mcos_tpu_torch.api import server

    body = {"spot": 100.0, "T": 0.25, "num_paths": 4096}
    before = ck.launch_counts()
    for extra in ({}, {"num_steps": 512}, {"use_sobol": True},
                  {"mode": "smile", "num_steps": 512},
                  {"mode": "skew"}, {"mode": "greeks"},
                  {"mode": "greeks", "num_steps": 512},
                  {"mode": "asian", "num_steps": 512},
                  {"mode": "barrier", "barrier": 110.0, "num_steps": 512},
                  {"mode": "lookback", "num_steps": 512}):
        res = server.handle_rough(dict(body, **extra), device=cuda)
        assert "elapsed_ms" in res
    after = ck.launch_counts()
    assert after["rbergomi_lift_integrals"] \
        - before["rbergomi_lift_integrals"] == 2
    assert after["rbergomi_lift_stats"] - before["rbergomi_lift_stats"] == 3


def test_prng_route_instantiations_fit(cuda):
    """K3's and K4's route instantiations (two branches) spill nothing and
    hold at most 32 registers, as before their redesign: 8 blocks of 256
    an SM, so the PRNG route's 500 000 pairs (1954 blocks) take 1.85 waves
    on the card's 132 SMs. They need no minimum of blocks an SM for it:
    `__launch_bounds__(256, 8)` changed K3's time by -0.2 % and K4's by
    +0.6 % (PERF.md)."""
    from mcos_tpu_torch import kernel_lab

    built = kernel_lab.build({"new": ck.CSRC_DIR}, ("k3", "k4"))["new"]
    res = {}
    for text in built["ptxas"].values():
        res.update(kernel_lab.ptxas_resources(text))
    for pattern in (kernel_lab._SASS_PATTERN["k3"] + "Li2E",
                    kernel_lab._SASS_PATTERN["k4"] + "Li2E"):
        (fn,) = [fn for fn in res if pattern in fn]
        r = res[fn]
        assert r["spill_stores"] == r["spill_loads"] == 0, fn
        assert r["registers"] <= 32, (fn, r["registers"])
        occ = kernel_lab.occupancy(r["registers"], 256, 1954)
        assert occ["blocks_per_sm"] == 8, fn
        assert occ["waves"] <= 1.851, fn


def _kernel_deltas(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def test_smile_mc_launches_k1_once_and_term_structure_k3_per_maturity(cuda):
    """`/api/smile` `mc` launches K1 once a request and nothing else; the
    card's prices are the CPU's plain version's on the same Sobol net (the
    jump uniforms are Philox words in both) to float32 sums.
    `price_term_structure` launches K3 once a maturity."""
    from mcos_tpu_torch.api import server
    from mcos_tpu_torch.engine.pricer import price_term_structure
    from mcos_tpu_torch.models.params import TermStructureSVJ

    body = {"spot": 100.0, "T": 0.25, "num_paths": 8192, "num_strikes": 7}
    before = ck.launch_counts()
    res = server.handle_smile(dict(body), device=cuda)
    assert _kernel_deltas(before, ck.launch_counts()) == {
        "svj_terminal_from_draws": 1}
    ref = server.handle_smile(dict(body), device="cpu")
    for a, b in zip(res["smile"], ref["smile"]):
        np.testing.assert_allclose(a["price"], b["price"], rtol=1e-4,
                                   atol=1e-4)
    ts = TermStructureSVJ(theta_curve={0.25: 0.04, 1.0: 0.06})
    before = ck.launch_counts()
    out = price_term_structure(ts, 100.0, [95.0, 100.0, 105.0],
                               [0.1, 0.25, 0.5], num_paths=8192,
                               device=cuda)
    assert _kernel_deltas(before, ck.launch_counts()) == {"svj_terminal": 3}
    assert all(np.isfinite(r["price"]) for m in out for r in m["chain"])


def test_greeks_engine_on_card_matches_cpu(cuda):
    """The Greeks programs run on the card through the twins (no kernel):
    on the same draws every block of `all_greeks`, `cross_greeks` and
    `second_order_greeks` agrees with the CPU's to float32 sums: rtol 1e-4
    beside an atol of 1e-5 × the largest |value| of the key's block (the
    `diff_pct` keys, 100 × a relative difference, at 1e-3 points), so a
    key near 0 (speed, color_daily) is held to its block's scale."""
    from mcos_tpu_torch.engine.greeks import GreeksEngine

    g = torch.Generator().manual_seed(4)
    draws = (torch.randn((25, 3, 8192), generator=g),
             torch.rand((25, 8192), generator=g))
    out = {}
    for device in (cuda, torch.device("cpu")):
        eng = GreeksEngine(_P, num_paths=8192, device=device)
        eng._draws = lambda steps, d=device: tuple(x.to(d) for x in draws)
        before = ck.launch_counts()
        res = eng.all_greeks(100.0, 100.0, 0.1)
        res["cross"] = eng.cross_greeks(100.0, 100.0, 0.1)
        res["second"] = eng.second_order_greeks(100.0, 100.0, 0.1)
        assert ck.launch_counts() == before
        out[device.type] = res
    for block, vals in out["cpu"].items():
        scale = max(abs(v) for k, v in vals.items() if k != "diff_pct")
        for k, v in vals.items():
            atol = 1e-3 if k == "diff_pct" else 1e-5 * scale
            np.testing.assert_allclose(out["cuda"][block][k], v, rtol=1e-4,
                                       atol=atol, err_msg=f"{block}.{k}")


# ── slice G: the risk desk ──────────────────────────────────────────────────
def test_stress_k3_per_member_matches_plain(cuda):
    """The cuda stress engine on the card: one K3 launch for the spot axis,
    one a shocked vol member (report: the base member is the spot axis's
    unshocked price) and one a vol row (matrix), each member's
    terminals bit for bit with K3's plain version on the same seed (the
    Philox words do not depend on the member), so every price equals the
    CPU engine's to float32 sums."""
    from mcos_tpu_torch.engine.risk import StressTestEngine

    out, k3 = {}, []
    for device in (cuda, torch.device("cpu")):
        eng = StressTestEngine(_P, num_paths=20_000, seed=7, device=device)
        before = ck.launch_counts()
        rep = eng.full_stress_report(100.0, 101.0, 0.1)
        mat = eng.scenario_matrix(100.0, 101.0, 0.1,
                                  vol_shocks=[-0.1, 0.05, 0.2])
        after = ck.launch_counts()
        k3.append(after["svj_terminal"] - before["svj_terminal"])
        assert {k: after[k] - before[k] for k in after
                if k != "svj_terminal"} == {k: 0 for k in after
                                             if k != "svj_terminal"}
        out[device.type] = (rep, mat)
    assert k3 == [1 + 2 + 4, 0]
    for m in eng._vol_members()[0]:
        kw = dict(num_paths=20_000, num_steps=25, companion=True)
        a = ck.svj_terminal(m, 100.0, 0.1, 7, device=cuda, **kw)
        b = ck.svj_terminal_plain(m, 100.0, 0.1, 7, device=cuda, **kw)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    for got, ref in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(_leaves(got), _leaves(ref), rtol=1e-5,
                                   atol=1e-4)


def _leaves(obj):
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves(v)]
    return [float(obj)]


def test_stress_twins_on_card_match_cpu(cuda):
    """backend="torch" (the member twin and the spot-axis twin) on the card
    against the CPU on shared draws: every number within float32 sums."""
    from mcos_tpu_torch.engine.risk import StressTestEngine

    g = torch.Generator().manual_seed(2)
    draws = (torch.randn((25, 3, 8192), generator=g),
             torch.rand((25, 8192), generator=g))
    out = {}
    for device in (cuda, torch.device("cpu")):
        eng = StressTestEngine(_P, num_paths=8192, backend="torch",
                               device=device)
        eng._draws = lambda steps, d=device: tuple(x.to(d) for x in draws)
        before = ck.launch_counts()
        out[device.type] = (eng.full_stress_report(100.0, 101.0, 0.1),
                            eng.scenario_matrix(100.0, 101.0, 0.1))
        assert ck.launch_counts() == before
    np.testing.assert_allclose(_leaves(out["cuda"]), _leaves(out["cpu"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dynamics", ["gbm", "svj"])
@pytest.mark.parametrize("hedge", ["bs_delta", "mv_delta", "ww_band"])
def test_hedge_day_loop_on_card_matches_cpu(cuda, dynamics, hedge):
    from mcos_tpu_torch.engine.risk import _hedge_paths

    g = torch.Generator().manual_seed(3)
    z = (torch.randn((20, 3, 4096), generator=g) if dynamics == "svj"
         else torch.randn((20, 4096), generator=g))
    u = torch.rand((20, 4096), generator=g) if dynamics == "svj" else None
    kw = dict(num_days=20, num_scenarios=4096, is_call=True,
              txn_cost_bps=5.0, slippage_bps=2.0, dynamics=dynamics,
              hedge=hedge, risk_aversion=1e-2)
    res = {}
    for device in (cuda, torch.device("cpu")):
        draws = (z.to(device), None if u is None else u.to(device))
        res[device.type] = [x.cpu() for x in _hedge_paths(
            _P, 100.0, 100.0, 20 / 252, 2.7, draws=draws, **kw)]
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


def test_hedge_backtest_on_card(cuda):
    """Every world of `run_backtest` on the card: finite figures, one K3
    launch for the gbm/svj premium and none for the rough world; the
    gamma sampler and the t-copula run with a CUDA generator."""
    from mcos_tpu_torch.engine.risk import (HedgingBacktest,
                                            multi_asset_t_copula_terminal)

    bt = HedgingBacktest(_P, device=cuda)
    for dyn, n3 in (("gbm", 1), ("svj", 1), ("rough", 0)):
        before = ck.launch_counts()["svj_terminal"]
        out = bt.run_backtest(100.0, 100.0, 0.1, num_scenarios=500,
                              dynamics=dyn)
        assert ck.launch_counts()["svj_terminal"] - before == n3
        assert np.isfinite(out["mean_pnl"]) and out["std_pnl"] > 0
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    s = multi_asset_t_copula_terminal([100.0, 50.0], [0.2, 0.3],
                                      [[1.0, 0.4], [0.4, 1.0]], 0.05, 0.0,
                                      0.25, gen, num_paths=200_000, nu=4.0,
                                      device=cuda)
    lr = torch.log(s / torch.tensor([100.0, 50.0], device=cuda)).double()
    for i, sig in enumerate((0.2, 0.3)):
        sd = sig * 0.5
        assert abs(float(lr[:, i].mean()) - (0.05 - 0.5 * sig**2) * 0.25) \
            < 4 * sd / np.sqrt(2e5)
        assert abs(float(lr[:, i].std()) - sd) < 4 * sd / np.sqrt(4e5)


def test_portfolio_programs_on_card_match_cpu(cuda):
    """The correlated-GBM loop, the Euler contributions and the float64 t
    CDF on the card against the CPU on shared draws."""
    from mcos_tpu_torch.engine import risk

    g = torch.Generator().manual_seed(5)
    spots, sigmas = [100.0, 80.0, 120.0], [0.2, 0.35, 0.15]
    corr = [[1.0, 0.5, 0.1], [0.5, 1.0, 0.3], [0.1, 0.3, 1.0]]
    z = torch.randn((8, 50_000, 3), generator=g)
    zt = torch.randn((50_000, 3), generator=g)
    gt = 2.0 * torch._standard_gamma(torch.full((50_000, 1), 1.5),
                                     generator=g)
    out = {}
    for device in (cuda, torch.device("cpu")):
        s = risk.multi_asset_gbm_terminal(spots, sigmas, corr, 0.05, 0.01,
                                          0.05, num_paths=50_000,
                                          num_steps=8, draws=z.to(device))
        c = risk.portfolio_risk_contributions(
            spots, sigmas, corr, [0.4, 0.35, 0.25], 0.05, num_paths=50_000,
            num_steps=8, draws=z.to(device))
        t = risk.multi_asset_t_copula_terminal(
            spots, sigmas, corr, 0.05, 0.01, 0.05, num_paths=50_000,
            nu=3.0, draws=(zt.to(device), gt.to(device)))
        out[device.type] = (s.cpu(), c, t.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for k in ("var", "cvar"):
        assert out["cuda"][1][k] == pytest.approx(out["cpu"][1][k], rel=1e-5)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-5,
                               atol=0)
    x = torch.linspace(-40.0, 40.0, 100_001, dtype=torch.float64)
    for nu in (1.0, 5.0, 300.0):
        torch.testing.assert_close(risk.student_t_cdf(x.to(cuda), nu).cpu(),
                                   risk.student_t_cdf(x, nu), rtol=0,
                                   atol=1e-13)


def test_risk_desk_handlers_on_card(cuda):
    """Each risk-desk route's handler on the card at a small width: finite
    figures, the launch counts of the slice (K3 for stress and gbm/svj
    hedges, nothing else), a 400 for a corr that is not positive
    definite."""
    from mcos_tpu_torch.api import server

    body = {"spot": 100.0, "strike": 100.0, "T": 0.1}
    ck.reset_launch_counts()
    rep = server.handle_stress(dict(body, num_paths=20_000), device=cuda)
    server.handle_hedge(dict(body, dynamics="svj", hedge="mv_delta"),
                        device=cuda)
    book = {"spots": [100.0, 50.0], "sigmas": [0.2, 0.3],
            "weights": [0.5, 0.5], "corr": [[1.0, 0.3], [0.3, 1.0]],
            "T": 0.1, "num_paths": 100_000}
    var = server.handle_var(book, device=cuda)
    tvar = server.handle_var(dict(book, copula="student_t", nu=3.0),
                             device=cuda)
    assert ck.launch_counts() == dict(
        {k: 0 for k in ck.launch_counts()}, svj_terminal=3 + 1)
    assert all(np.isfinite(_leaves(rep)))
    assert var["cvar"] >= var["var"] > 0 and tvar["var"] > var["var"]
    with pytest.raises(server.ApiError) as e:
        server.handle_var(dict(book, corr=[[1.0, 1.5], [1.5, 1.0]]),
                          device=cuda)
    assert e.value.status == 400


# ── slice H: American exercise and the PDE solvers ──────────────────────────
def _sheet_draws(device, steps=32, n=20_000, seed=3):
    """CPU-generated (z, u) and the same on `device`."""
    g = torch.Generator().manual_seed(seed)
    z, u = torch.randn((steps, 3, n), generator=g), torch.rand((steps, n),
                                                               generator=g)
    return (z, u), (z.to(device), u.to(device))


def test_lsm_programs_on_card_match_cpu(cuda):
    """The recorded sheet (plain and td) to rtol 1e-5; the in-sample LSM
    within half a standard error (its float32 regressions may flip a few
    exercise decisions); the CPU's policy on both sides to rtol 1e-4, and
    its Greeks and the two-spot delta batch to rtol 1e-4."""
    from mcos_tpu_torch.engine import american

    cpu, card = _sheet_draws(cuda)
    td = np.stack([np.linspace(0.03, 0.09, 32), np.linspace(0.4, 0.9, 32),
                   np.linspace(0.5, 4.0, 32)])
    for table in (None, td):
        a = american._record_log_paths(_P, 100.0, 0.5, draws=cpu,
                                       td_table=table)
        b = american._record_log_paths(_P, 100.0, 0.5, draws=card,
                                       td_table=table)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-6)
    kw = dict(is_call=False)
    ref = american.lsm_price(_P, 100.0, 100.0, 0.5, draws=cpu, **kw)
    got = american.lsm_price(_P, 100.0, 100.0, 0.5, draws=card, **kw)
    assert abs(float(got["price"]) - float(ref["price"])) \
        < 0.5 * float(ref["std_error"])
    coefs = american.lsm_train(_P, 100.0, 100.0, 0.5, draws=cpu,
                               **kw)["policy"]
    lo_ref = american.lsm_lower_bound(_P, 100.0, 100.0, 0.5, None, coefs,
                                      draws=cpu, **kw)
    lo = american.lsm_lower_bound(_P, 100.0, 100.0, 0.5, None,
                                  coefs.to(cuda), draws=card, **kw)
    assert float(lo["price"]) == pytest.approx(float(lo_ref["price"]),
                                               rel=1e-4)
    p_ref, g_ref = american.american_greeks_ad(_P, 100.0, 100.0, 0.5, None,
                                               coefs, draws=cpu, **kw)
    p, g = american.american_greeks_ad(_P, 100.0, 100.0, 0.5, None,
                                       coefs.to(cuda), draws=card, **kw)
    torch.testing.assert_close(torch.stack([p, *g]).cpu(),
                               torch.stack([p_ref, *g_ref]), rtol=1e-4,
                               atol=1e-6)
    d_ref = american._american_delta_batch(_P, [101.0, 99.0], 100.0, 0.5,
                                           None, coefs, draws=cpu, **kw)
    d = american._american_delta_batch(_P, [101.0, 99.0], 100.0, 0.5, None,
                                       coefs.to(cuda), draws=card, **kw)
    torch.testing.assert_close(d.cpu(), d_ref, rtol=1e-4, atol=1e-6)


def test_dual_on_card_matches_cpu(cuda):
    from mcos_tpu_torch.engine import american

    cpu, _ = _sheet_draws("cpu", steps=16, n=20_000)
    value = american.lsm_train(_P, 100.0, 100.0, 0.5, draws=cpu,
                               is_call=False)["value"]
    g = torch.Generator().manual_seed(9)
    draws = ((torch.randn((16, 3, 1024), generator=g),
              torch.rand((16, 1024), generator=g)),
             (torch.randn((16, 3, 32, 1024), generator=g),
              torch.rand((16, 32, 1024), generator=g)))
    on = tuple(tuple(t.to(cuda) for t in pair) for pair in draws)
    kw = dict(n_outer=1024, n_inner=65, num_steps=16, is_call=False)
    ref = american.dual_upper_bound(_P, 100.0, 100.0, 0.5, None, value,
                                    draws=draws, **kw)
    got = american.dual_upper_bound(_P, 100.0, 100.0, 0.5, None,
                                    value.to(cuda), draws=on, **kw)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-4)


@pytest.mark.parametrize("scheme", ["cs", "douglas"])
@pytest.mark.parametrize("lam", [0.0, 2.0])
@pytest.mark.parametrize("american", [False, True])
def test_adi_on_card_matches_cpu(cuda, scheme, lam, american):
    """The default 201 x 101 x 128 grid, the inverses from cuSOLVER against
    the CPU's LAPACK: 1e-4 of the grid's largest value; the exercise edge
    on the same node but where continuation ties intrinsic to rounding
    (at most 0.1 % of the (step, v) entries, each one node away)."""
    from mcos_tpu_torch.engine import pde

    p = SVJParams(lambda_j=lam)
    out = {}
    for dev in ("cpu", cuda):
        eng = pde.HestonPDEEngine(p, scheme=scheme, device=dev)
        x, v, n_x, n_t = eng._grids(100.0, 105.0, 0.5)
        u, s = eng._solve(x, v, n_x, n_t, 105.0, 0.5, False, american,
                          jump=eng._jump_tables(x))
        out[str(dev)] = (u.cpu(), s.cpu())
    (u_c, s_c), (u_g, s_g) = out["cpu"], out[str(cuda)]
    assert float((u_g - u_c).abs().max()) < 1e-4 * float(u_c.abs().max())
    if american:
        assert torch.equal(torch.isfinite(s_g), torch.isfinite(s_c))
        fin = torch.isfinite(s_c)
        step = float(x[1] - x[0])
        shift = torch.log(s_g[fin].double() / s_c[fin].double()).abs()
        moved = shift > 1e-6
        assert int(moved.sum()) <= 1e-3 * s_c.numel()
        assert torch.allclose(shift[moved], torch.full_like(
            shift[moved], step), rtol=1e-3)


@pytest.mark.parametrize("american", [False, True])
def test_cn_on_card_matches_cpu(cuda, american):
    from mcos_tpu_torch.engine import pde

    x = np.linspace(np.log(40.0), np.log(250.0), 401).astype(np.float32)
    sig2 = np.repeat(np.linspace(0.03, 0.08, 256, dtype=np.float32)[:, None],
                     401, 1)
    div = np.zeros(256, np.float32)
    div[[60, 170]] = np.log1p(-0.02)
    out = [pde._cn_solve(sig2, 100.0, 1.0, 0.05, 0.01, x, div, n_x=401,
                         n_t=256, is_call=False, american=american,
                         device=d) for d in ("cpu", cuda)]
    v_c, v_g = out[0][0], out[1][0].cpu()
    assert float((v_g - v_c).abs().max()) < 1e-4 * float(v_c.abs().max())


def test_levy_samplers_on_card_by_law(cuda):
    """VG on the card's gamma sampler and NIG on its IG transform: within
    4 standard errors of the COS prices."""
    from mcos_tpu_torch.engine.pricer import seeded_generator
    from mcos_tpu_torch.ops import levy

    for p, cos in ((levy.VGParams(), levy.vg_cos_price),
                   (levy.NIGParams(), levy.nig_cos_price)):
        price, se = levy.levy_price_mc(
            p, 100.0, [90.0, 100.0, 110.0], 0.5,
            seeded_generator(1, cuda), num_paths=1 << 20, device=cuda)
        exact = cos(p, 100.0, [90.0, 100.0, 110.0], 0.5)
        assert np.all(np.abs(price.cpu().numpy() - exact)
                      <= 4 * se.cpu().numpy())


def test_slice_h_handlers_on_card(cuda):
    """/api/american with every block, /api/pde in both models and
    /api/termsvj american on the card at small widths: finite figures, the
    400s, and no kernel of the repo launched."""
    from mcos_tpu_torch.api import server

    ck.reset_launch_counts()
    am = {"spot": 100.0, "strike": 100.0, "T": 0.25, "is_call": False,
          "num_paths": 20_000}
    res = server.handle_american(dict(am, with_bounds=True, with_greeks=True,
                                      with_cos_oracle=True,
                                      with_boundary=True, n_outer=512),
                                 device=cuda)
    assert np.isfinite([res["price"], res["bounds"]["upper_bound"],
                        res["greeks"]["delta"],
                        res["cos_oracle"]["price"]]).all()
    res = server.handle_american(dict(am, is_call=True, dividends=[
        {"t": 0.1, "amount": 2.0}], rate_curve=[{"t": 1.0, "r": 0.05}]),
        device=cuda)
    assert np.isfinite(res["price"])
    pde_body = {"spot": 100.0, "strike": 100.0, "T": 0.5, "n_x": 101,
                "n_v": 41, "n_t": 32}
    for extra in ({"with_oracle": True}, {"american": True, "is_call": False,
                                          "with_boundary": True},
                  {"barrier": 120.0, "rebate": 1.0},
                  {"model": "bs", "american": True, "with_boundary": True}):
        res = server.handle_pde(dict(pde_body, **extra), device=cuda)
        assert np.isfinite(res["price"])
    td = {"spot": 100.0, "T": 0.2, "num_paths": 20_000, "num_steps": 32,
          "mode": "american",
          "segments": [{"t_end": 0.1, "theta": 0.04},
                       {"t_end": 0.2, "theta": 0.09, "lambda_j": 3.0}]}
    assert np.isfinite(server.handle_termsvj(td, device=cuda)["price"])
    with pytest.raises(server.ApiError) as e:
        server.handle_pde(dict(pde_body, params={"lambda_j": 1.0,
                                                 "sigma_j": 0.0}),
                          device=cuda)
    assert e.value.status == 400
    assert all(n == 0 for n in ck.launch_counts().values())


# ─────────────────────────────────────────────────────────────────────────────
# Slice I: calibration and surfaces
# ─────────────────────────────────────────────────────────────────────────────
def _calibration_population(n, stage, seed=0):
    """A numpy-seeded DE population inside the stage's bounds."""
    from mcos_tpu_torch.engine import calibration as cal

    bounds = cal.HESTON_BOUNDS if stage == 1 else cal.JUMP_BOUNDS
    rng = np.random.default_rng(seed)
    lo, hi = bounds[:, 0], bounds[:, 1]
    return (lo + (hi - lo) * rng.random((n, len(lo)))).astype(np.float32)


@pytest.mark.parametrize("stage,lam", [(1, 0.0), (2, 0.0), (2, 1.0)])
def test_k1_calibration_objective_matches_twin(cuda, stage, lam):
    """The DE objective of `/api/calibrate` at its shape (24 members × 100 000
    paths × 50 steps): through one K1 launch for the population against
    the Euler twin on the same draws.
    Float32 rounding: the chain prices to rtol 2e-5 (K1's S to 1e-5 a path,
    averaged over 200 000), the objectives to rtol 1e-4 (a squared
    residual amplifies the prices' relative error by 2·price/residual)."""
    from mcos_tpu_torch.engine import calibration as cal
    from mcos_tpu_torch.engine.pricer import seeded_generator
    from mcos_tpu_torch.ops.cos_pricer import cos_price

    spot, T = 100.0, 0.5
    strikes = np.linspace(80.0, 120.0, 11)
    market = cos_price(SVJParams(), spot, strikes, T).astype(np.float32)
    draws = cal._calibration_draws(100_000, 50, seeded_generator(3, cuda))
    data = {"spot": spot, "T": T, "r": 0.065, "q": 0.012, "draws": draws,
            "strikes": torch.as_tensor(strikes, dtype=torch.float32,
                                       device=cuda),
            "market_prices": torch.as_tensor(market, device=cuda),
            "weights": cal.compute_vega_weights(spot, strikes, T, 0.065,
                                                0.012, 0.15, device=cuda),
            "heston_x": [2.0, 0.05, 0.4, -0.6, 0.045]}
    pop = _calibration_population(24, stage)
    if stage == 2:
        pop[:, 0] = lam
    x = torch.as_tensor(pop, device=cuda)
    fn = cal.heston_objective if stage == 1 else cal.svj_objective
    n0 = ck.svj_terminal_from_draws.launches
    with torch.no_grad():
        ker = fn(x, data, backend="cuda")
        torch.cuda.synchronize()
        assert ck.svj_terminal_from_draws.launches == n0 + 1
        twin = fn(x, data, backend="torch")
    torch.testing.assert_close(ker, twin, rtol=1e-4, atol=1e-7)
    assert ck.svj_terminal_from_draws.launches == n0 + 1


def test_localvol_and_slv_on_card_match_cpu(cuda):
    """The local-vol and SLV step loops on the card against the CPU on the
    same normals: local-vol spots to rtol 2e-4 (float32; the card's and the
    CPU's exp and sqrt differ by an ulp, which the local-vol feedback
    carries over 64 steps: 3 of 200 000 paths part by 8e-5 on an H100),
    SLV prices within 1 se (the bin sums are atomics on the card)."""
    from mcos_tpu_torch.engine import localvol as lv
    from mcos_tpu_torch.engine import slv
    from mcos_tpu_torch.engine.pricer import seeded_generator

    k = np.log(np.linspace(70.0, 130.0, 13) / 100.0)
    mats = np.array([0.25, 0.5, 1.0])
    iv = 0.2 - 0.15 * k[None, :] + 0.2 * k[None, :] ** 2 + 0.0 * mats[:, None]
    surf = lv.LocalVolSurface.from_iv_points(100.0, np.linspace(70, 130, 13),
                                             mats, iv, r=0.05, q=0.01)
    rows, t_mid = surf.step_tables(0.5, 64)
    y0, dy = float(surf.y_grid[0]), float(surf.y_grid[1] - surf.y_grid[0])
    z = torch.randn((64, 2, 100_000), generator=seeded_generator(4, "cpu"))
    s = {dev: lv.simulate_terminal_localvol(
        rows, t_mid, y0, dy, 100.0, 0.05, 0.01, 0.5,
        normals=z[:, 0].to(dev)).cpu() for dev in ("cpu", cuda)}
    torch.testing.assert_close(s[cuda], s["cpu"], rtol=2e-4, atol=0)
    heston = SVJParams(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04,
                       lambda_j=0.0, r=0.05, q=0.01)
    out = {}
    for dev in ("cpu", cuda):
        st = slv.slv_terminal(heston, rows, t_mid, y0, dy, 100.0, 0.5,
                              normals=z.to(dev)).cpu()
        pay = torch.clamp(st - 100.0, min=0.0).mean(dim=0)
        out[dev] = (float(pay.mean()), float(pay.std() / pay.numel() ** 0.5))
    assert abs(out[cuda][0] - out["cpu"][0]) < out["cpu"][1], out


# ── slice K: multi-asset and path products (torch ops, no kernel) ───────────
def _shared(shape, steps, seed=12):
    """CPU draws (steps, 3, *shape) and (steps, *shape)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((steps, 3, *shape), generator=g),
            torch.rand((steps, *shape), generator=g))


def _on(draws, dev):
    return tuple(x.to(dev) for x in draws)


def test_slice_k_simulators_on_card_match_cpu(cuda):
    """The period loop, the quanto terminal and the basket terminal and
    states on the card against the CPU on the same draws (rtol 1e-5,
    beside 1e-6 for log returns and variance states near 0)."""
    from mcos_tpu_torch.engine import basket as bk
    from mcos_tpu_torch.engine import cliquet as cl
    from mcos_tpu_torch.engine import quanto as qu
    from mcos_tpu_torch.models.params import _stack_params

    n = 20_000
    d1 = _shared((n,), 32)
    out = [cl.simulate_period_log_returns(
        _P, 1.0, None, num_paths=n, n_periods=4, steps_per_period=8,
        draws=_on(d1, dev)) for dev in (cuda, "cpu")]
    for a, b in zip(*out):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    out = [qu._quanto_terminal(_P, 100.0, 0.5, 0.03, 0.12, -0.4, None,
                               num_paths=n, num_steps=32,
                               draws=_on(d1, dev)) for dev in (cuda, "cpu")]
    for a, b in zip(*out):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=0)
    batch = _stack_params([_P, SVJParams(v0=0.06, rho=-0.3, q=0.03)])
    chol = np.linalg.cholesky(np.array([[1.0, 0.4], [0.4, 1.0]]))
    d2 = _shared((2, n), 32)
    out = [bk.simulate_basket_terminal(
        batch, [100.0, 95.0], chol, 0.5, None, num_paths=n, num_steps=32,
        draws=_on(d2, dev)) for dev in (cuda, "cpu")]
    for a, b in zip(*out):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=0)
    out = [bk.simulate_basket_states(
        batch, [100.0, 95.0], chol, 0.5, None, num_paths=n, n_obs=4,
        steps_per_period=8, draws=_on(d2, dev)) for dev in (cuda, "cpu")]
    for a, b in zip(*out):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


def test_slice_k_fixed_policy_programs_on_card_match_cpu(cuda):
    """The lower bound and the dual on one fitted policy (the CPU's), on
    the same outer and inner draws: the lower bound's pairs at rtol 1e-5
    but for stopping decisions within rounding of their boundary (at most
    0.1 %), the dual's at rtol 1e-4."""
    from mcos_tpu_torch.engine import basket_american as ba
    from mcos_tpu_torch.models.params import gbm_params, _stack_params

    b2 = _stack_params([gbm_params(0.2, r=0.05, q=0.1)] * 2)
    eye = np.eye(2)
    kw = dict(n_ex=9, steps_per_period=1, kind="max", is_call=True)
    args = (b2, [100.0, 100.0], eye, 100.0, 3.0, 0.05, None)
    coefs = ba.lsm_basket_train(*args, num_paths=20_000,
                                draws=_shared((2, 20_000), 9, 3), **kw)
    d = _shared((2, 20_000), 9, 4)
    lb = [ba._lower_bound_pairs(*args, coefs["policy"].to(dev),
                                num_paths=20_000, draws=_on(d, dev), **kw)
          .cpu() for dev in (cuda, "cpu")]
    jump = (lb[0] - lb[1]).abs() > 1e-3 * float(lb[1].abs().max())
    assert int(jump.sum()) <= 20
    torch.testing.assert_close(lb[0][~jump], lb[1][~jump], rtol=1e-5,
                               atol=1e-5)
    outer = _shared((2, 512), 9, 5)
    g = torch.Generator().manual_seed(6)
    inner = (torch.randn((9, 1, 3, 16, 2, 1024), generator=g),
             torch.rand((9, 1, 16, 2, 1024), generator=g))
    dual = [ba._dual_pairs(*args, coefs["value"].to(dev), n_outer=512,
                           n_inner=32, draws=_on(outer, dev),
                           inner_draws=_on(inner, dev), **kw).cpu()
            for dev in (cuda, "cpu")]
    torch.testing.assert_close(dual[0], dual[1], rtol=1e-4, atol=1e-5)


def test_slice_k_handlers_on_card_launch_no_kernel(cuda):
    """The four routes on the card from their engines' generators: every
    number finite, no kernel launched."""
    from mcos_tpu_torch.api import server

    two = {"spots": [100.0, 95.0], "weights": [0.5, 0.5], "strike": 100.0,
           "T": 0.5, "corr": [[1.0, 0.3], [0.3, 1.0]], "num_paths": 20_000}
    bodies = [
        ("basket", two), ("basket", dict(two, payoff="worst_of")),
        ("basket", dict(two, payoff="spread", strike=5.0)),
        ("basket", dict(two, american=True, payoff="best_of",
                        with_bounds=True, n_outer=256, n_inner=16)),
        ("cliquet", {"T": 1.0, "num_paths": 20_000}),
        ("cliquet", {"T": 1.0, "kind": "forward_start", "num_paths": 20_000}),
        ("quanto", {"spot": 100.0, "strike": 100.0, "T": 0.5,
                    "num_paths": 20_000}),
        ("autocall", {"T": 1.0, "num_paths": 20_000, "solve_par": True}),
        ("autocall", {"T": 1.0, "num_paths": 20_000, "params_list": [{}, {}],
                      "corr": [[1.0, 0.5], [0.5, 1.0]]})]
    ck.reset_launch_counts()
    for route, body in bodies:
        res = getattr(server, f"handle_{route}")(dict(body), device=cuda)
        flat = [v for v in res.values() if isinstance(v, float)]
        assert flat and all(np.isfinite(flat)), (route, res)
    assert all(n == 0 for n in ck.launch_counts().values())


# ─────────────────────────────────────────────────────────────────────────────
# Slice N1: the path-sharded mesh on the card
# ─────────────────────────────────────────────────────────────────────────────
_MESH_CASES = {          # driver → the kernel its shards launch
    "euler": "svj_terminal", "qe": "svj_terminal_qe",
    "asian": "svj_path_stats", "digital": "svj_terminal",
    "hhw": "hhw_terminal", "svcj": "svcj_terminal",
    "td": "svj_terminal_td"}
_TD_STEPS = np.arange(128)
_TD = (np.where(_TD_STEPS < 64, 0.04, 0.09),
       np.where(_TD_STEPS < 42, 0.5, 0.9),
       np.where(_TD_STEPS < 64, 1.0, 6.0))


def _mesh_price(case, mesh, seed, n):
    """(price, std_error) of `case`'s sharded driver on `mesh`."""
    from mcos_tpu_torch.models.params import SVCJParams
    from mcos_tpu_torch.ops.hhw import HHWParams
    from mcos_tpu_torch.parallel import families as pf
    from mcos_tpu_torch.parallel import mesh as pm

    if case in ("euler", "qe"):
        res = pm.sharded_price(_P, 22500.0, [22500.0], 0.25, seed,
                               mesh=mesh, num_paths=n, num_steps=63,
                               scheme=case)
    elif case in ("asian", "digital"):
        res = pm.sharded_exotic_price(_P, 22500.0, 22500.0, 0.25, seed,
                                      mesh=mesh, kind=case, num_paths=n,
                                      num_steps=63)
    elif case == "hhw":
        res = pf.sharded_hhw_price(HHWParams(), 100.0, [100.0], 1.0, seed,
                                   mesh=mesh, num_paths=n, num_steps=128)
    elif case == "svcj":
        res = pf.sharded_svcj_price(SVCJParams(), 22500.0, [22500.0], 0.25,
                                    seed, mesh=mesh, num_paths=n,
                                    num_steps=63)
    else:
        res = pf.sharded_td_price(_P, *_TD, 22500.0, [22500.0], 0.5, seed,
                                  mesh=mesh, num_paths=n, num_steps=128)
    return (float(res["price"].reshape(-1)[0]),
            float(res["std_error"].reshape(-1)[0]))


def _engine_price(case, seed, n, device):
    """(price, std_error) of the unsharded engine core `case` shards."""
    from mcos_tpu_torch.engine import pricer, termsvj
    from mcos_tpu_torch.engine.exotics import ExoticEngine
    from mcos_tpu_torch.engine.hhw import HHWEngine
    from mcos_tpu_torch.engine.svcj import SVCJEngine
    from mcos_tpu_torch.models.params import SVCJParams
    from mcos_tpu_torch.ops.hhw import HHWParams

    if case in ("euler", "qe"):
        res = pricer.mc_price_cuda(_P, 22500.0, [22500.0], 0.25, seed,
                                   num_paths=n, num_steps=63, scheme=case,
                                   device=device)
        return float(res["price"][0]), float(res["std_error"][0])
    if case == "td":   # the sharded driver pools the β = 1 estimator
        res = termsvj.mc_price_td_cuda(_P, *_TD, 22500.0, [22500.0], 0.5,
                                       seed, num_paths=n, num_steps=128,
                                       cv_beta="one", device=device)
        return float(res["price"][0]), float(res["std_error"][0])
    if case == "hhw":
        out = HHWEngine(HHWParams(), num_paths=n, num_steps=128, seed=seed,
                        device=device).price(100.0, 100.0, 1.0)
    elif case == "svcj":
        out = SVCJEngine(SVCJParams(), num_paths=n, num_steps=252,
                         seed=seed, device=device).price(22500.0, 22500.0,
                                                         0.25)
    else:
        eng = ExoticEngine(_P, num_paths=n, num_steps=252, seed=seed,
                           device=device)
        out = (eng.price_asian if case == "asian" else eng.price_digital)(
            22500.0, 22500.0, 0.25)
    return out["price"], out["std_error"]


@pytest.mark.parametrize("case", sorted(_MESH_CASES))
def test_one_shard_mesh_equals_unsharded_on_card(cuda, case):
    """A one-shard mesh on the card launches its kernel once, on the
    engine's seed: price and standard error within float32 rounding of the
    unsharded engine's (rtol 1e-6)."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    kernel = getattr(ck, _MESH_CASES[case])
    n0 = kernel.launches
    got = _mesh_price(case, make_mesh([cuda]), 17, 100_000)
    assert kernel.launches == n0 + 1
    ref = _engine_price(case, 17, 100_000, cuda)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", sorted(_MESH_CASES))
def test_four_shard_mesh_equals_its_shards_pooled_on_card(cuda, case):
    """Four shards of cuda:0 launch four kernels, and their pooled result
    is the moments of the four one-shard runs (each on its shard's seed)
    pooled in shard order: the price is their mean to float32 rounding."""
    from mcos_tpu_torch.parallel.mesh import make_mesh, shard_seed

    kernel = getattr(ck, _MESH_CASES[case])
    n0 = kernel.launches
    four = _mesh_price(case, make_mesh([cuda] * 4), 17, 4 * 25_000)
    assert kernel.launches == n0 + 4
    parts = [_mesh_price(case, make_mesh([cuda]), shard_seed(17, i), 25_000)
             for i in range(4)]
    if case != "asian":      # the optimal-β control pools cross moments
        assert four[0] == pytest.approx(np.mean([p[0] for p in parts]),
                                        rel=1e-6)
    se_pooled_bound = np.sqrt(np.mean([p[1] ** 2 for p in parts]) / 4)
    assert four[1] == pytest.approx(se_pooled_bound, rel=0.05)


# ─────────────────────────────────────────────────────────────────────────────
# Slice N2: the sharded Sobol default and two ranks on the card
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("n", [1 << 16, 60_000])
def test_one_shard_sobol_equals_the_engine_on_card(cuda, n):
    """A one-shard mesh routes the default engine through
    `sharded_sobol_price`: one K1 launch on the 2^m-point net whose first n
    paths are the unsharded engine's launch bit for bit (S, v, G); at
    n = 2^m the price within rtol 1e-6."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    outs = {}
    for tag, mesh in (("engine", None), ("one shard", make_mesh([cuda]))):
        eng = MonteCarloEngine(_P, num_paths=n, num_steps=63, seed=5,
                               mesh=mesh, device=cuda)
        real = ck.svj_terminal_from_draws
        got = []

        def spy(*args, **kw):
            out = real(*args, **kw)
            got.append(out)
            return out

        spy.launches = real.launches
        ck.svj_terminal_from_draws = spy
        try:
            res = eng.price(22500.0, 22500.0, 0.25)
        finally:
            ck.svj_terminal_from_draws = real
            real.launches = spy.launches
        assert len(got) == 1
        outs[tag] = (res, got[0])
    (ref, k_ref), (one, k_one) = outs["engine"], outs["one shard"]
    for a, b in zip(k_one, k_ref):
        assert torch.equal(a[..., :n], b)
    if n & (n - 1) == 0:
        for k in ("price", "std_error"):
            assert one[k] == pytest.approx(ref[k], rel=1e-6, abs=0)


def test_two_ranks_on_card_equal_one_process_two_shards(cuda):
    """Two processes on cuda:0 (gloo: NCCL refuses two ranks on one GPU)
    pricing `parallel/distributed.py:_demo_price`: both ranks and the
    in-process 2-shard mesh give the same bits."""
    import json
    import socket
    import subprocess
    import sys

    from mcos_tpu_torch.parallel import distributed as pdist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "mcos_tpu_torch.parallel.distributed",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--backend", "gloo", "--device", "cuda", "--num-paths", "65536",
           "--num-steps", "32", "--timeout", "60"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            assert p.returncode == 0, stderr[-2000:]
            outs.append(json.loads([ln for ln in stdout.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    one = pdist._demo_price(65536, 32, local_devices=[cuda, cuda])
    for o in outs:
        assert (o["price"], o["std_error"]) == (one["price"],
                                                one["std_error"])


def test_request_spans_share_the_device_trace_clock(cuda):
    """A warm solo `/api/price` under `torch.profiler` (CUDA activity):
    moved by `profiler_clock_offset_ns()`, every device→host copy lies
    inside a `host.sync` span of the request within 0.2 ms, and no kernel
    starts before the request's `http.request` opened."""
    import json
    import threading
    import time
    import urllib.request
    from http.server import ThreadingHTTPServer

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mcos_tpu_torch.api import coalesce, server
    from mcos_tpu_torch.utils import spans

    ck.load_library()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server._Handler)
    httpd.device = cuda
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/price"
    body = json.dumps({"spot": 22500.0, "strike": 22500.0,
                       "T": 0.1}).encode()
    window, coalesce.coalescer.window_s = coalesce.coalescer.window_s, 0.0
    try:
        urllib.request.urlopen(url, data=body, timeout=300).read()
        torch.cuda.synchronize()
        mark = spans.RECORDER.snapshot()[-1].span_id
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            urllib.request.urlopen(url, data=body, timeout=300).read()
            torch.cuda.synchronize()
        deadline = time.monotonic() + 30
        while True:
            mine = [s for s in spans.RECORDER.snapshot()
                    if s.span_id > mark]
            roots = [s for s in mine if s.name == "http.request"]
            if (roots and roots[0].t_end_ns is not None) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.01)
    finally:
        coalesce.coalescer.window_s = window
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    offset = spans.profiler_clock_offset_ns()
    root, = roots
    syncs = [s for s in mine if s.name == "host.sync"
             and s.request_id == root.span_id]
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns() if hasattr(e, "start_ns") \
                else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") \
                else e.duration_us() * 1000
            events.append((e.name(), int(start), int(dur)))
    copies = [e for e in events if e[0].startswith("Memcpy DtoH")]
    kernels = [e for e in events
               if not e[0].startswith(("Memcpy", "Memset"))]
    assert syncs and copies and kernels
    tol = 200_000
    for name, start, dur in copies:
        assert any(s.t_start_ns + offset - tol <= start
                   and start + dur <= s.t_end_ns + offset + tol
                   for s in syncs), (name, start, dur, [
                       (s.t_start_ns + offset, s.t_end_ns + offset)
                       for s in syncs])
    assert min(k[1] for k in kernels) >= root.t_start_ns + offset


# ── the viz kernel (csrc/svj_viz.cu): /api/price's recorder and sampler ────
# The quote cell's step counts (recorder 50 and 62 at 50 paths, sampler 10,
# 19 and 62 at 1 024) and an odd one, each at the maturity it serves.
_VIZ_SHAPES = [(True, 50, 50, 28 / 365), (True, 50, 62, 91 / 365),
               (True, 50, 51, 51 / 252), (False, 1024, 10, 7 / 365),
               (False, 1024, 19, 28 / 365), (False, 1024, 62, 91 / 365),
               (False, 1024, 51, 51 / 252)]
# Spots rtol 2e-6: the kernel takes the twin's operations in its order,
# uncontracted, on the constants the torch loop forms on the card; only
# the last bits of k = exp(mu_J + sigma_J^2 / 2) - 1 (numpy's exp on the
# host against torch's on the card) and of expf may differ.
_VIZ_RTOL = 2e-6


@pytest.mark.parametrize("record, paths, steps, T", _VIZ_SHAPES)
def test_viz_kernel_matches_the_torch_loop(cuda, record, paths, steps, T):
    p = SVJParams()
    g = torch.Generator(device=cuda)
    g.manual_seed(steps)
    z = torch.randn((steps, 3, paths), generator=g, device=cuda)
    u = torch.rand((steps, paths), generator=g, device=cuda)
    n0 = ck.svj_viz.launches
    ker = ck.svj_viz(p, 22500.0, T, z, u, record=record)
    torch.cuda.synchronize()
    assert ck.svj_viz.launches == n0 + 1
    ref = ck.svj_viz_plain(p, 22500.0, T, z, u, record=record)
    assert ker.shape == ref.shape == ((paths, steps + 1) if record
                                      else (paths,))
    # dt, sqrt(dt) and lambda dt bit for bit with the loop's tensors, so
    # every jump indicator is the loop's.
    c = ck._viz_consts(p, 22500.0, T, steps)
    dt = torch.as_tensor(T, dtype=torch.float32, device=cuda) / steps
    loop = [dt, torch.sqrt(dt), p.lambda_j * dt]
    assert [np.float32(x.item()) for x in loop] == list(c[[2, 3, 9]])
    assert torch.equal(u < torch.as_tensor(c[9], device=cuda), u < loop[2])
    torch.testing.assert_close(ker, ref, rtol=_VIZ_RTOL, atol=0)


def test_viz_kernel_rejects_what_it_does_not_take(cuda):
    import dataclasses

    z = torch.randn((4, 3, 64), device=cuda)
    u = torch.rand((4, 64), device=cuda)
    with pytest.raises(TypeError):
        ck.svj_viz(dataclasses.replace(SVJParams(), xi=torch.tensor(0.5)),
                   1.0, 1.0, z, u, record=True)
    with pytest.raises(TypeError):
        ck.svj_viz(SVJParams(), 1.0, 1.0, z.double(), u, record=False)
    with pytest.raises(ValueError):
        ck.svj_viz(SVJParams(), 1.0, 1.0, z, u.cpu(), record=False)


def test_api_price_launches_the_viz_kernel_twice(cuda):
    """One `/api/price`: the recorder and the sampler, one launch each."""
    import json

    from mcos_tpu_torch.api import server
    from mcos_tpu_torch.utils import spans

    body = {"spot": 22500.0, "strike": 22500.0, "T": 0.1,
            "num_paths": 20_000}
    server.handle_price(dict(body), device=cuda)
    before = ck.launch_counts()["svj_viz"]
    counted = spans.RECORDER.counters().get("viz_kernel_launches", 0)
    res = server.handle_price(dict(body), device=cuda)
    assert ck.launch_counts()["svj_viz"] - before == 2
    assert spans.RECORDER.counters()["viz_kernel_launches"] - counted == 2
    assert len(json.loads(res["terminal_samples"].raw)) == 1024
