"""The single Horner sequence that csrc/svj_qe_draws.cu:acklam_converged
runs for both regions of Acklam's inverse normal CDF, transcribed to
torch, against ops/sobol.py:ndtri_acklam (the plain version's two regions)
bit for bit: x = r or qt, each coefficient selected by region, the tail's
denominator led by a 0, and the numerator scaled by qc or by -1 or 1
before the one divide. Each Horner step is taken in the plain version's
form (float64 a x + c, then float32) and in the kernel's (one float32 FMA,
rounded once from the exact value). Every float32 of the two seams of the
regions is covered, and 2^20 seeded uniforms. Then the K5 cases that take
the QE transition's exponential branch: they do, on the plain path, and
on K4's plain path too (down to its mass at zero), where the route's
defaults never do. Needs
no card."""

import numpy as np
import pytest
import torch

from mcos_tpu_torch import kernel_lab
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import sobol

torch.set_num_threads(1)

_F32 = np.float32
# (central, tail) coefficients of each Horner step, as the kernel selects
# them: the numerator's six, and the denominator's six (central: five and
# the closing 1; tail: a leading 0, four and the closing 1).
_NUM = tuple(zip(sobol._ACK_A, sobol._ACK_C))
_DEN = tuple(zip((*sobol._ACK_B, 1.0), (0.0, *sobol._ACK_D, 1.0)))
_LOW29 = (1 << 29) - 1


def _step_double(acc, x, c):
    """The plain version's step: float64 a x + c (the product is exact),
    then float32."""
    return (acc.double() * x.double() + c).float()


def _step_fmaf(acc, x, c):
    """fmaf(acc, x, c): a x + c rounded once to float32, ties to even. The
    float64 sum s and its error e (TwoSum) hold the exact value s + e; it
    rounds as s does unless s lies exactly halfway between two float32
    values and e is not 0, where it rounds to e's side."""
    p = acc.double() * x.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    mid = ((bits & _LOW29) == (1 << 28)) & (err != 0)
    toward_zero = (bits & ~_LOW29).view(torch.float64).float()
    away = torch.nextafter(toward_zero, torch.where(
        s > 0, torch.tensor(np.inf, dtype=torch.float32),
        torch.tensor(-np.inf, dtype=torch.float32)))
    nudged = torch.where(torch.sign(err) == torch.sign(s), away, toward_zero)
    return torch.where(mid, nudged, s.float())


def _pick(central, a, t):
    """A coefficient by region, as float64 of its float32 value."""
    return torch.where(central, torch.tensor(float(_F32(a)), dtype=torch.float64),
                       torch.tensor(float(_F32(t)), dtype=torch.float64))


def acklam_converged(u: torch.Tensor, step) -> torch.Tensor:
    qc = u - 0.5
    central = torch.abs(qc) <= float(_F32(0.5 - sobol._ACK_PLOW))
    pm = torch.minimum(u, 1.0 - u)
    qt = torch.sqrt(-2.0 * torch.log(pm))
    x = torch.where(central, qc * qc, qt)
    num = _pick(central, *_NUM[0]).float()
    for a, t in _NUM[1:]:
        num = step(num, x, _pick(central, a, t))
    den = _pick(central, *_DEN[0]).float()
    for a, t in _DEN[1:]:
        den = step(den, x, _pick(central, a, t))
    sign = torch.where(qc < 0.0, 1.0, -1.0).float()
    return (num * torch.where(central, qc, sign)) / den


def _floats_between(lo: float, hi: float) -> torch.Tensor:
    a, b = (int(_F32(v).view(np.uint32)) for v in (lo, hi))
    return torch.from_numpy(np.arange(a, b + 1, dtype=np.uint32).view(_F32))


def _uniforms(n: int = 1 << 20) -> torch.Tensor:
    k = np.random.default_rng(20).integers(0, 1 << 24, n)
    return torch.from_numpy(((k + 0.5) * 2.0 ** -24).astype(_F32))


_INPUTS = {
    # every float32 across the seam below and above the central region
    # (|u - 1/2| <= float32(0.47575), i.e. u in [0.02425, 0.97575])
    "seam_low": lambda: _floats_between(0.0235, 0.0250),
    "seam_high": lambda: _floats_between(0.9750, 0.9765),
    "uniform": _uniforms,
}


@pytest.mark.parametrize("step", [_step_double, _step_fmaf],
                         ids=["double_step", "fmaf_step"])
@pytest.mark.parametrize("inputs", list(_INPUTS))
def test_converged_sequence_is_ndtri_acklam_bit_for_bit(inputs, step):
    u = _INPUTS[inputs]()
    qc = u - 0.5
    central = torch.abs(qc) <= float(_F32(0.5 - sobol._ACK_PLOW))
    assert 0 < int(central.sum()) < u.numel()     # both regions are in it
    got = acklam_converged(u, step)
    want = sobol.ndtri_acklam(u)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_fmaf_step_rounds_once():
    """The emulated FMA against exact rationals on a case where rounding
    the float64 sum to float32 rounds twice: a x + c = 1 + 2^-24 + 2^-60
    rounds up to 1 + 2^-23 once, but to 1 (a tie, to even) through the
    float64 1 + 2^-24."""
    acc = torch.tensor([2.0 ** -24 + 2.0 ** -47], dtype=torch.float32)
    x = torch.tensor([1.0 + 2.0 ** -13], dtype=torch.float32)
    # exact product 2^-24 + 2^-37 + 2^-47 + 2^-60: fits float64
    c = torch.tensor([1.0], dtype=torch.float64)
    exact = 1.0 + 2.0 ** -24 + 2.0 ** -37 + 2.0 ** -47 + 2.0 ** -60
    assert float(_step_fmaf(acc, x, c)) == float(_F32(exact)) == (
        1.0 + 2.0 ** -23)
    assert float(_step_double(acc, x, c)) == float(_F32(1.0 + 2.0 ** -24
                                                        + 2.0 ** -37
                                                        + 2.0 ** -47))


def _psi_shares(params: SVJParams, T: float, steps: int):
    """Per step, the share of 4096 Sobol paths whose QE transition takes
    the exponential branch (psi > 1.5) along the plain version's path."""
    from mcos_tpu_torch.ops.simulate import qe_variance_step

    c = ck._qe_dict(ck._qe_consts(params, 22500.0, T, steps))
    _, u_v, _, _ = sobol.sobol_qe_draws(4096, steps, seed=42,
                                        jump_uniforms=False, device="cpu")
    v = torch.full((4096,), c["v0"])
    shares = []
    for t in range(steps):
        m = c["theta"] + (v - c["theta"]) * c["e_kdt"]
        psi = (v * c["var1"] + c["var2"]) / torch.clamp(m * m, min=1e-20)
        shares.append(float((psi > 1.5).float().mean()))
        v = qe_variance_step(v, sobol.ndtri_acklam(u_v[t]), u_v[t], c)
    return shares


@pytest.mark.parametrize("steps", [4, 8])
def test_psi_cases_take_both_qe_branches(steps):
    """kernel_lab's K5 cases "psi_4" and "psi_8" (T = 1, v0 = 0.005, xi
    raised, kappa lowered) put the QE transition on both sides of
    psi = 1.5 along the plain version's path."""
    shares = _psi_shares(SVJParams(**kernel_lab.K5_PSI), 1.0, steps)
    assert 0.05 < float(np.mean(shares)) < 0.95, shares


def test_route_defaults_never_take_the_exponential_branch():
    """At SVJParams' defaults psi <= xi^2 / (2 kappa theta) = 1.04 at any v
    and dt: the route's QE requests run the quadratic branch only, at 63
    steps and at the psi cases' T = 1 and v0 = 0.005 alike."""
    p = SVJParams()
    assert p.xi ** 2 / (2 * p.kappa * p.theta) < 1.5
    assert max(_psi_shares(p, 0.25, 63)) == 0.0
    assert max(_psi_shares(SVJParams(v0=0.005), 1.0, 8)) == 0.0


def _k4_plain_branches(params: SVJParams, T: float, steps: int,
                       pairs: int = 4096, seed: int = 42):
    """Along K4's plain version's own path (its Philox words, its
    Box-Muller z_v, its transition `_qe_step_folded`), per step: the share
    of pairs whose QE transition takes the exponential branch (its test:
    s^2 > 1.5 m^2, i.e. psi > 1.5) and the share that lands on its mass at
    zero (v' = 0). Also the path's terminal v."""
    c = ck._qe_dict(ck._qe_consts(params, 22500.0, T, steps))
    v = torch.full((pairs,), c["v0"])
    exp_share, zero_share = [], []
    for t in range(steps):
        u = ck._pair_words(pairs, t, ck._QE_DOMAIN, seed, "cpu")
        _, z_v = ck.box_muller(u[0], u[1])
        m = c["theta"] + (v - c["theta"]) * c["e_kdt"]
        s2 = v * c["var1"] + c["var2"]
        exponential = ~(s2 <= 1.5 * (m * m))
        v = ck._qe_step_folded(v, z_v, u[2], c)
        exp_share.append(float(exponential.double().mean()))
        zero_share.append(float((exponential & (v == 0)).double().mean()))
    return exp_share, zero_share, v


@pytest.mark.parametrize("steps", [4, 8])
def test_k4_plain_path_takes_both_qe_branches(steps):
    """At kernel_lab.K5_PSI (T = 1, 4 and 8 steps, the cases chip_smoke.py
    and tests/test_torch_cuda.py hold K4 at) the plain version's own path
    takes the quadratic branch, the exponential branch and its mass at
    zero, so the card's bit-for-bit v covers each lazy branch of the
    kernel. The path traced here is the plain version's: same terminal v."""
    params = SVJParams(**kernel_lab.K5_PSI)
    exp_share, zero_share, v = _k4_plain_branches(params, 1.0, steps)
    _, v_plain, _ = ck.svj_terminal_qe_plain(
        params, 22500.0, 1.0, 42, num_paths=4096, num_steps=steps,
        device="cpu")
    assert torch.equal(v_plain[0], v) and torch.equal(v_plain[1], v)
    assert 0.05 < float(np.mean(exp_share)) < 0.95, exp_share
    assert max(zero_share) > 0.01, zero_share
    assert bool((v == 0).any()) and bool((v > 0).any())


def test_k4_route_defaults_never_take_the_exponential_branch():
    """At SVJParams' defaults (the PRNG QE route, 63 steps over T = 0.25)
    K4's plain path runs the quadratic branch only: the lazy kernel's
    exponential branch is never taken there, and only the psi cases pin
    it."""
    exp_share, zero_share, v = _k4_plain_branches(SVJParams(), 0.25, 63)
    assert max(exp_share) == 0.0 and max(zero_share) == 0.0
    assert bool((v > 0).all())
