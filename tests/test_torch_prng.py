"""Port pins for the PRNG kernels K3 `svj_terminal` and K4 `svj_terminal_qe`
through their plain versions (the CPU side of the wrappers) and for the
jump-count table they invert. The JAX PRNG kernels give zeros in the Pallas
interpreter (`pallas_kernels._interpret`), and the streams differ anyway
(Philox here), so the plain versions are held by law against the JAX scan
twins. The kernels run only on a CUDA device (tests/test_torch_cuda.py,
chip_smoke.py, word for word against these plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.ops import simulate as jsim
from mcos_tpu.ops.pallas_kernels import _binom_count_cdf
from mcos_tpu_torch import kernel_lab
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=1.5, mu_j=-0.05, sigma_j=0.1)
_N = 1 << 15
_PLAIN = {"euler": ck.svj_terminal, "qe": ck.svj_terminal_qe}
_TWIN = {"euler": jsim.simulate_terminal, "qe": jsim.simulate_terminal_qe}


def _law(scheme, fields, num_steps=16, seed=17, T=0.5):
    """(port plain version, JAX scan twin) terminal (S, v, G) as numpy."""
    before = dict(ck.launch_counts())
    got = _PLAIN[scheme](SVJParams(**fields), 22500.0, T, seed,
                         num_paths=_N, num_steps=num_steps, companion=True,
                         device="cpu")
    assert ck.launch_counts() == before    # CPU tensors: no launch
    ref = _TWIN[scheme](JSVJParams(**fields), 22500.0, T,
                        jax.random.key(seed), num_paths=_N,
                        num_steps=num_steps, companion=True)
    return ([x.numpy() for x in got], [np.asarray(x) for x in ref])


@pytest.mark.parametrize("scheme, fields, steps, T", [
    pytest.param("euler", _FIELDS, 16, 0.5, id="euler"),
    pytest.param("qe", _FIELDS, 16, 0.5, id="qe"),
    # kernel_lab.K5_PSI over a year: psi crosses 1.5, so K4's transition
    # takes its exponential branch and the mass at zero as well
    pytest.param("qe", kernel_lab.K5_PSI, 8, 1.0, id="qe-psi")])
def test_prng_plain_law_matches_scan_twin(scheme, fields, steps, T):
    """The reference's kernel-vs-twin pins (test_pallas.py:67-85,
    :242-262): mean S and G within 6 se, mean v within 0.005, v ≥ 0; and
    for QE the dispersion of S within 2 %."""
    (s, v, g), (s_ref, v_ref, g_ref) = _law(scheme, fields, steps, T=T)
    assert s.shape == v.shape == g.shape == (2, _N)
    se = s_ref.std() / np.sqrt(s_ref.size)
    assert abs(s.mean() - s_ref.mean()) < 6 * se
    g_se = g_ref.std() / np.sqrt(g_ref.size)
    assert abs(g.mean() - g_ref.mean()) < 6 * g_se
    assert abs(v.mean() - v_ref.mean()) < 0.005
    assert (v >= 0).all() and np.isfinite(s).all()
    if scheme == "qe":
        assert s.std() == pytest.approx(s_ref.std(), rel=0.02)
        np.testing.assert_array_equal(v[0], v[1])   # one variance path
        if fields is kernel_lab.K5_PSI:
            assert (v == 0).any() and (v_ref == 0).any()   # mass at zero


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_prng_plain_degenerate_gbm(scheme):
    """ξ = 0, λ = 0, v0 = θ = σ²: log-returns are N((r−q−σ²/2)T, σ²T);
    mean and std within 5 se of the exact values."""
    sigma, r, q, T = 0.2, 0.065, 0.012, 1.0
    p = SVJParams(kappa=1.0, theta=sigma**2, xi=0.0, rho=0.0, v0=sigma**2,
                  lambda_j=0.0, mu_j=0.0, sigma_j=0.0, r=r, q=q)
    s, _, _ = _PLAIN[scheme](p, 100.0, T, 5, num_paths=_N, num_steps=12,
                             antithetic=False, device="cpu")
    lr = np.log(s[0].double().numpy() / 100.0)
    n = lr.size
    assert abs(lr.mean() - (r - q - 0.5 * sigma**2) * T) < \
        5 * sigma * np.sqrt(T / n)
    assert abs(lr.std() - sigma * np.sqrt(T)) < \
        5 * sigma * np.sqrt(T / (2 * n))


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("steps", [7, 16])
def test_prng_plain_stream_is_shape_free(scheme, steps):
    """The stream depends on (pair, step, seed) only: the first n pairs of
    a 2n run are the n run, and antithetic=False is row 0 of the pair."""
    kw = dict(num_steps=steps, companion=True, device="cpu")
    p = SVJParams(**_FIELDS)
    a = _PLAIN[scheme](p, 100.0, 0.5, 9, num_paths=4096, **kw)
    b = _PLAIN[scheme](p, 100.0, 0.5, 9, num_paths=8192, **kw)
    one = _PLAIN[scheme](p, 100.0, 0.5, 9, num_paths=4096, antithetic=False,
                         **kw)
    for x, y, z in zip(a, b, one):
        np.testing.assert_array_equal(x.numpy(), y[:, :4096].numpy())
        np.testing.assert_array_equal(z.numpy(), x[:1].numpy())
    other = _PLAIN[scheme](p, 100.0, 0.5, 10, num_paths=4096, **kw)
    assert not np.array_equal(other[0].numpy(), a[0].numpy())


# Pairs of the reference's table test (test_pallas.py:152-153).
_REF_PAIRS = [(1024, 1e-3), (16, 0.3), (250, 0.004), (1024, 0.0), (64, 0.15),
              (512, 0.02)]


@pytest.mark.parametrize("n,lam_dt", _REF_PAIRS)
def test_count_table_matches_reference_table(n, lam_dt):
    """Where `_binom_count_cdf` is within 1e-6 of scipy (all of the
    reference test's pairs), the port's table equals it within 1e-6 on the
    reference's 64 entries."""
    ref = np.asarray(_binom_count_cdf(lam_dt, n), np.float64)
    exact = scipy.stats.binom.cdf(np.arange(64), n, lam_dt)
    assert np.abs(ref - exact).max() < 1e-6
    got = ck.binom_count_table(lam_dt, n)
    assert got.size >= 64
    np.testing.assert_allclose(got[:64], ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,lam_dt", _REF_PAIRS + [
    (252, 60 / 252), (252, 90 / 252), (63, 0.5), (1, 0.7), (40, 1.0)])
def test_count_table_matches_scipy(n, lam_dt):
    """float64 and exact: entries before the cut within 1e-9 of scipy; the
    cut is the first k whose upper tail is below 2⁻²⁴ (above the largest
    uniform, 1 − 2⁻²⁴), and entries past it are 1."""
    got = ck.binom_count_table(lam_dt, n)
    k = np.arange(got.size)
    exact = scipy.stats.binom.cdf(k, n, lam_dt)
    tail = scipy.stats.binom.sf(k, n, lam_dt)
    window = np.where(tail < 2.0 ** -24, 2.0 ** -24, 1e-9)
    assert (np.abs(got - exact) <= window).all()
    # The last entry lies above every uniform: no count past the table.
    assert np.all(np.diff(got) >= 0) and got[-1] > 1.0 - 2.0 ** -24
    assert got.size >= 64
    # The length is what the tail needs, no more.
    cut = int(np.argmax(tail < 2.0 ** -24))
    assert got.size == max(cut + 1, 64)


@pytest.mark.parametrize("lam_t,ref_mean", [(30, 30.0), (60, 56.62),
                                            (73, 60.25), (74, None),
                                            (90, None)])
def test_count_table_mean_where_the_reference_table_fails(lam_t, ref_mean):
    """Mean jump count Σₖ (1 − cdf_k) over 252 steps. The port's table is
    exact to 1e-6; the reference's, conditioned on count < 64, falls short
    from λT ≈ 45 on (by 3.4 at λT = 60), and from λT = 74 its float32
    (1−p)ⁿ underflows and the table is NaN (the kernel draws no jumps)."""
    p_dt = lam_t / 252
    got = ck.binom_count_table(p_dt, 252)
    assert np.sum(1.0 - got) == pytest.approx(lam_t, abs=1e-6)
    ref = np.asarray(_binom_count_cdf(p_dt, 252), np.float64)
    if ref_mean is None:
        assert np.isnan(ref).any()
    else:
        assert np.sum(1.0 - ref) == pytest.approx(ref_mean, abs=0.01)


def test_count_table_inverts_to_the_binomial_pmf():
    """Σₖ 1{u > cdf_k} on the kernels' 23-bit uniform grid reproduces the
    Binomial pmf (the reference's inverse-transport check)."""
    n, lam_dt = 252, 0.006
    grid = torch.from_numpy(((np.arange(1 << 17) * 64 + 0.5)
                             * 2.0 ** -23).astype(np.float32))
    counts = ck.count_from_table(grid, ck.binom_count_table(lam_dt, n))
    pmf = np.bincount(counts.numpy().astype(int), minlength=12)[:12] / grid.numel()
    np.testing.assert_allclose(pmf, scipy.stats.binom.pmf(np.arange(12), n,
                                                          lam_dt), atol=1e-4)


def test_k3_mean_jump_count_at_high_lambda():
    """λT = 60 over 252 steps. With no diffusion (v ≡ 0) and fixed jump
    size μ_J (σ_J = 0), log(S/S0) = Σ drift + n·μ_J, so K3's plain version
    shows its jump count n. Its mean is within 5 se of n·λ·dt = 60; the
    reference table, normalized by its 64th entry, implies 56.6."""
    steps, lam, mu = 252, 60.0, 0.01
    p = SVJParams(kappa=0.0, theta=0.0, xi=0.0, rho=0.0, v0=0.0,
                  lambda_j=lam, mu_j=mu, sigma_j=0.0, r=0.0, q=0.0)
    n_paths = 1 << 14
    s, _, _ = ck.svj_terminal(p, 100.0, 1.0, 3, num_paths=n_paths,
                              num_steps=steps, antithetic=False, device="cpu")
    # The float32 carry of the drift alone (the compensated drift_dt).
    drift = ck._svj_prng_consts(p, 100.0, 1.0, steps)[12]
    ls = np.float32(0.0)
    for _ in range(steps):
        ls = np.float32(ls + drift)
    raw = (np.log(s[0].double().numpy() / 100.0) - float(ls)) / mu
    counts = np.rint(raw)
    assert np.abs(raw - counts).max() < 1e-2 and counts.min() >= 0
    p_dt = lam / steps
    se = np.sqrt(steps * p_dt * (1 - p_dt) / n_paths)
    assert abs(counts.mean() - steps * p_dt) < 5 * se
    ref = np.asarray(_binom_count_cdf(p_dt, steps), np.float64)
    assert np.sum(1.0 - ref) < steps * p_dt - 3.0   # the reference's fault


def test_k3_negative_v0_is_clamped_as_the_twin_reads_it():
    """v0 = −0.01: the TPU kernel would take √v0 = NaN; K3 starts its
    carry at max(v0, 0), as the scan twin reads v (full truncation)."""
    fields = dict(_FIELDS, v0=-0.01)
    (s, v, _), (s_ref, v_ref, _) = _law("euler", fields)
    assert np.isfinite(s).all() and (v >= 0).all()
    se = s_ref.std() / np.sqrt(s_ref.size)
    assert abs(s.mean() - s_ref.mean()) < 6 * se
    assert abs(v.mean() - v_ref.mean()) < 0.005


def test_prng_wrappers_reject_what_they_do_not_take():
    p = SVJParams(**_FIELDS)
    for fn in _PLAIN.values():
        with pytest.raises(ValueError):
            fn(p, 1.0, 1.0, -1, num_paths=8, num_steps=4, device="cpu")
        with pytest.raises(ValueError):
            fn(p, 1.0, 1.0, 0, num_paths=0, num_steps=4, device="cpu")
        with pytest.raises(ValueError):
            fn(p, 1.0, 1.0, 0, num_paths=8, num_steps=4, device="meta")


def test_qe_consts_and_twin_constants_agree():
    """The packed QE scalars and the torch twin's `_qe_constants` are one
    arithmetic (both float32, in the reference's order)."""
    from mcos_tpu_torch.ops import simulate as psim

    p = SVJParams(**_FIELDS)
    packed = ck._qe_dict(ck._qe_consts(p, 100.0, 0.5, 20))
    twin = psim._qe_constants(p, torch.tensor(0.5, dtype=torch.float32) / 20)
    for k in ("theta", "e_kdt", "var1", "var2", "k0", "k1", "k2"):
        assert packed[k] == pytest.approx(float(twin[k]), rel=1e-6), k
    assert packed["k34"] == pytest.approx(float(twin["k3"]), rel=1e-6)
    np.testing.assert_allclose(
        jnp.asarray(packed["drift_dt"]), float(twin["drift_dt"]), rtol=1e-6)
