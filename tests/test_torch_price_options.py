"""Port pins for the `/api/price` options beyond the default and for
`/api/convergence`: the PRNG pricers (`mc_price_core`, `mc_price_cuda`),
importance sampling, the QE branch of `mc_price_from_draws`, and the
engine's `price_to_tolerance`, `price_rqmc` and `convergence`, against
`mcos_tpu` on CPU. PRNG-driven results come from different streams on the
two sides (threefry there, Philox or a torch.Generator here), so they agree
within 4 combined standard errors; draw-driven ones within float32 noise."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import pricer as jpricer
from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.ops import simulate as jsim
from mcos_tpu_torch.api import coalesce as pcoalesce
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.engine import pricer as ppricer
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import simulate as psim

torch.set_num_threads(1)

_FIELDS = dict(kappa=2.0, theta=0.05, xi=0.45, rho=-0.65, v0=0.045,
               lambda_j=2.0, mu_j=-0.06, sigma_j=0.12)
_STRIKES = np.array([20000.0, 22500.0, 25000.0], np.float32)
_KW = dict(num_paths=1 << 14, num_steps=16)


def _close_in_se(got, ref, k=4.0):
    """Prices within k combined standard errors, strike by strike."""
    p, q = np.asarray(got["price"], np.float64), np.asarray(ref["price"])
    se = np.hypot(np.asarray(got["std_error"], np.float64),
                  np.asarray(ref["std_error"]))
    assert (np.abs(p - q) < k * se).all(), (p, q, se)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("cfg", [dict(), dict(is_call=False),
                                 dict(control_variate=False)])
def test_prng_pricers_match_jax(scheme, cfg):
    """`mc_price_core` (torch twins on a Generator) and `mc_price_cuda` (K3
    or K4's plain version on CPU) against the JAX `mc_price_core`."""
    ref = jpricer.mc_price_core(
        JSVJParams(**_FIELDS), 22500.0, jnp.asarray(_STRIKES), 0.3,
        jax.random.key(7), scheme=scheme, **_KW, **cfg)
    core = ppricer.mc_price_core(SVJParams(**_FIELDS), 22500.0, _STRIKES,
                                 0.3, _gen(7), scheme=scheme, device="cpu",
                                 **_KW, **cfg)
    before = ck.launch_counts()
    cuda = ppricer.mc_price_cuda(SVJParams(**_FIELDS), 22500.0, _STRIKES,
                                 0.3, 7, scheme=scheme, device="cpu", **_KW,
                                 **cfg)
    assert ck.launch_counts() == before
    for got in (core, cuda):
        assert set(got) == set(ref)
        assert got["price"].shape == (3,)
        _close_in_se(got, ref)
        assert float(got["frac_nonfinite"]) == 0.0
        assert abs(float(got["v_mean"]) - float(ref["v_mean"])) < 0.005


def test_mc_price_cuda_rejects_unknown_scheme():
    with pytest.raises(ValueError):
        ppricer.mc_price_cuda(SVJParams(), 1.0, [1.0], 0.1, 0, num_paths=8,
                              num_steps=2, scheme="milstein", device="cpu")


@pytest.mark.parametrize("strike,is_call", [(28000.0, True), (17000.0, False)])
def test_importance_matches_jax(strike, is_call):
    """Deep OTM both ways: same shift, prices within 4 combined se; the
    tilt is the JAX formula to float64 rounding."""
    p, jp_ = SVJParams(**_FIELDS), JSVJParams(**_FIELDS)
    shift = psim.optimal_tilt(p, 22500.0, strike, 0.3, 16)
    assert shift == pytest.approx(
        jsim.optimal_tilt(jp_, 22500.0, strike, 0.3, 16), rel=1e-15)
    assert (shift > 0) == is_call
    ref = jpricer.mc_price_importance(
        jp_, 22500.0, jnp.asarray([strike], jnp.float32), 0.3,
        jax.random.key(3), shift, is_call=is_call, **_KW)
    got = ppricer.mc_price_importance(p, 22500.0, [strike], 0.3, _gen(3),
                                      shift, is_call=is_call, device="cpu",
                                      **_KW)
    assert set(got) == set(ref)
    _close_in_se(got, ref)
    assert 0 < float(got["ess"]) <= 2 * _KW["num_paths"]
    assert float(got["frac_nonfinite"]) == 0.0


def test_tilted_twin_weights_are_a_likelihood_ratio():
    """E[L] = 1 and, on the GBM companion leg, E[L·(G−K)⁺] is the BS price
    the control variate assumes."""
    p = SVJParams(**_FIELDS)
    s, v, g, log_w = psim.simulate_terminal_tilted(
        p, 22500.0, 0.3, _gen(5), 0.4, 1 << 15, 16, companion=True,
        device="cpu")
    w = torch.exp(log_w).double()
    assert s.shape == v.shape == g.shape == log_w.shape == (2, 1 << 15)
    assert abs(float(w.mean()) - 1.0) < 5 * float(w.std()) / np.sqrt(w.numel())
    # Same draws, shift 0: the untilted twin (weights 1).
    s0, _, _, lw0 = psim.simulate_terminal_tilted(p, 22500.0, 0.3, _gen(5),
                                                  0.0, 1024, 16,
                                                  device="cpu")
    s1, _, _ = psim.simulate_terminal(p, 22500.0, 0.3, _gen(5), 1024, 16,
                                      device="cpu")
    np.testing.assert_array_equal(lw0.numpy(), 0.0)
    np.testing.assert_array_equal(s0.numpy(), s1.numpy())


@pytest.fixture(scope="module")
def qe_draws():
    rng = np.random.default_rng(11)
    n, steps = 2048, 20
    z_x, z_js = (rng.standard_normal((steps, n)).astype(np.float32)
                 for _ in range(2))
    u_v = rng.uniform(0.01, 0.99, (steps, n)).astype(np.float32)
    u_j = rng.uniform(size=(steps, n)).astype(np.float32)
    return z_x, u_v, u_j, z_js


@pytest.mark.parametrize("jax_backend,backend", [("scan", "torch"),
                                                 ("pallas", "cuda")])
def test_mc_price_from_draws_qe_matches_jax(qe_draws, jax_backend, backend):
    """scheme="qe" on identical draws: the torch twin against the JAX scan,
    K5's plain version against the JAX kernel in the Pallas interpreter.
    rtol 1e-5 (float32 noise of the two orders of summation); the CV
    adjustment is a difference of price-sized numbers, so its noise is
    relative to the price."""
    ref = jpricer.mc_price_from_draws(
        JSVJParams(**_FIELDS), 22500.0, jnp.asarray(_STRIKES), 0.3,
        *(jnp.asarray(x) for x in qe_draws), backend=jax_backend,
        steps_major=True, scheme="qe")
    got = ppricer.mc_price_from_draws(
        SVJParams(**_FIELDS), 22500.0, _STRIKES, 0.3,
        *(torch.from_numpy(x) for x in qe_draws), backend=backend,
        steps_major=True, scheme="qe")
    assert set(got) == set(ref)
    scale = float(np.abs(np.asarray(ref["raw_mc_price"])).max())
    for k in ref:
        atol = 1e-5 * scale if k == "bs_cv_adjustment" else 1e-6
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=atol, err_msg=k)


def test_qe_backends_agree_on_in_kernel_jumps(qe_draws):
    """u_jump=None: K5's plain version and the QE twin take one Philox
    stream; they differ only by the u_v inverse (Acklam against
    torch.special.ndtri), well inside 1e-4 on prices."""
    z_x, u_v, _, z_js = (torch.from_numpy(x) for x in qe_draws)
    a, b = (ppricer.mc_price_from_draws(
        SVJParams(**_FIELDS), 22500.0, _STRIKES, 0.3, z_x, u_v, None, z_js,
        seed=5, backend=be, steps_major=True, scheme="qe")
        for be in ("cuda", "torch"))
    np.testing.assert_allclose(a["price"].numpy(), b["price"].numpy(),
                               rtol=1e-4)


def test_price_to_tolerance_matches_jax():
    """Same doubling schedule (4096, 8192, then the 4096 left to the cap),
    pooled price within 4 combined se of the JAX engine's."""
    kw = dict(num_paths=4096, num_steps=16, seed=11)
    args = (22500.0, 22500.0, 0.25, True, 1e-9, 1 << 14, 4096)
    ref = jpricer.MonteCarloEngine(JSVJParams(**_FIELDS), use_sobol=False,
                                   backend="scan",
                                   **kw).price_to_tolerance(*args)
    for backend in ("cuda", "torch"):
        got = ppricer.MonteCarloEngine(SVJParams(**_FIELDS), use_sobol=False,
                                       backend=backend, device="cpu",
                                       **kw).price_to_tolerance(*args)
        assert set(got) == set(ref)
        for k in ("num_paths_used", "num_batches", "num_steps",
                  "tolerance_met"):
            assert got[k] == ref[k], k
        assert got["num_batches"] == 3 and got["num_paths_used"] == 1 << 14
        _close_in_se(got, ref)
        assert got["bs_ref"] == pytest.approx(ref["bs_ref"], rel=1e-5)


def test_price_to_tolerance_batch_seeds():
    """Each batch runs the PRNG driver with (seed·1 000 003 + 7919·b) mod
    2³¹, the reference's per-batch seeds, and stops once the tolerance
    holds."""
    eng = ppricer.MonteCarloEngine(SVJParams(**_FIELDS), num_paths=4096,
                                   num_steps=16, seed=11, device="cpu")
    seen = []
    real = ppricer.mc_price_cuda

    def spy(*a, **k):
        seen.append((a[4], k["num_paths"]))
        return real(*a, **k)

    ppricer.mc_price_cuda = spy
    try:
        res = eng.price_to_tolerance(22500.0, 22500.0, 0.25, tolerance=0.5,
                                     max_paths=1 << 14, batch_paths=4096)
    finally:
        ppricer.mc_price_cuda = real
    assert res["tolerance_met"] and res["num_batches"] == 1
    assert seen == [((11 * 1_000_003) & 0x7FFFFFFF, 4096)]


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_price_rqmc_matches_jax(scheme, backend):
    """R = 2 Owen scrambles of the same nets, λ = 0 so the jump streams
    play no part: each replicate equals the JAX one within float32 noise
    (QE through K5 inverts u_v with Acklam, the scan with jax.scipy's
    ndtri: still far inside rtol 1e-5 on a price). The spread-based error
    is a difference of two prices, so its noise is relative to the price."""
    fields = dict(_FIELDS, lambda_j=0.0)
    kw = dict(num_paths=4096, num_steps=80, seed=3, scheme=scheme)
    ref = jpricer.MonteCarloEngine(JSVJParams(**fields), backend="scan",
                                   **kw).price_rqmc(22500.0, 23000.0, 0.2,
                                                    randomizations=2)
    got = ppricer.MonteCarloEngine(SVJParams(**fields), backend=backend,
                                   device="cpu", **kw).price_rqmc(
        22500.0, 23000.0, 0.2, randomizations=2)
    assert set(got) == set(ref)
    assert got["randomizations"] == 2 and got["num_paths_used"] == 8192
    for k in ("price", "price_min", "price_max", "bs_ref"):
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    assert got["std_error"] == pytest.approx(ref["std_error"],
                                             abs=1e-5 * ref["price"])


def test_price_rqmc_needs_two():
    eng = ppricer.MonteCarloEngine(SVJParams(), num_paths=64, device="cpu")
    with pytest.raises(ValueError):
        eng.price_rqmc(100.0, 100.0, 0.1, randomizations=1)


def test_convergence_matches_jax():
    """Identical checkpoint counts; the full-sample point within 4 combined
    se; the series is prefix means of one path set (the error bars shrink
    like 1/√n)."""
    kw = dict(num_paths=1 << 14, num_steps=16, use_sobol=False)
    ref = jpricer.MonteCarloEngine(JSVJParams(**_FIELDS), backend="scan",
                                   **kw).convergence(22500.0, 22500.0, 0.25)
    got = ppricer.MonteCarloEngine(SVJParams(**_FIELDS), device="cpu",
                                   **kw).convergence(22500.0, 22500.0, 0.25)
    assert got["num_paths"] == ref["num_paths"]
    assert len(got["price"]) == len(got["std_error"]) == len(ref["price"])
    se = np.hypot(got["std_error"][-1], ref["std_error"][-1])
    assert abs(got["price"][-1] - ref["price"][-1]) < 4 * se
    err = np.asarray(got["std_error"])
    n = np.asarray(got["num_paths"], np.float64)
    ratio = err * np.sqrt(n) / (err[-1] * np.sqrt(n[-1]))
    assert np.all(np.abs(ratio - 1.0) < 0.5)


def test_convergence_prefix_means_are_exact():
    """Each checkpoint is the mean and population error of the first n
    antithetic-combined payoffs of the twin's one path set."""
    p = SVJParams(**_FIELDS)
    counts = (64, 100, 1000, 4096)
    prices, errors = ppricer._convergence_core(
        p, 22500.0, 22500.0, 0.25, _gen(4), num_paths=4096, num_steps=16,
        is_call=True, antithetic=True, counts=counts, device="cpu")
    s, _, _ = psim.simulate_terminal(p, 22500.0, 0.25, _gen(4), 4096, 16,
                                     device="cpu")
    pay = torch.clamp(s.double() - 22500.0, min=0.0).mean(dim=0).numpy()
    disc = np.exp(-0.065 * 0.25)
    for i, n in enumerate(counts):
        assert prices[i].item() == pytest.approx(disc * pay[:n].mean(),
                                                 rel=1e-5)
        assert errors[i].item() == pytest.approx(
            disc * pay[:n].std() / np.sqrt(n), rel=1e-4)


@pytest.fixture
def solo(monkeypatch):
    monkeypatch.setattr(pcoalesce.coalescer, "window_s", 0.0)


@pytest.mark.parametrize("extra", [{"use_sobol": False},
                                   {"use_sobol": False, "scheme": "qe"},
                                   {"scheme": "qe"}])
def test_coalesced_option_request_equals_solo(solo, monkeypatch, extra):
    """A coalesced PRNG or QE request prices exactly as a solo one: both
    build an engine with the serving seed 42 (the reference's promise,
    mcos_tpu/api/coalesce.py:124-127)."""
    bodies = [dict({"spot": 22500.0, "strike": k, "T": 0.05,
                    "num_paths": 2048}, **extra) for k in (22000.0, 23000.0)]
    solos = [pserver.handle_price(dict(b), device="cpu") for b in bodies]
    monkeypatch.setattr(pcoalesce.coalescer, "window_s", 0.5)
    runs0 = pcoalesce.coalescer.batches_run
    out = [None] * len(bodies)

    def call(i):
        out[i] = pserver.handle_price(dict(bodies[i]), device="cpu")

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert pcoalesce.coalescer.batches_run == runs0 + 1
    for got, ref in zip(out, solos):
        for k in ("price", "std_error", "raw_mc_price", "bs_ref", "v_max"):
            assert got[k] == ref[k], k
        assert got["sample_paths"].raw == ref["sample_paths"].raw


def test_importance_and_rqmc_are_not_coalesced():
    from mcos_tpu_torch.api import schemas

    base = {"spot": 100.0, "strike": 100.0, "T": 0.1}
    assert pcoalesce.bucket_key(schemas.PriceRequest(**base), "cpu")
    for extra in ({"use_importance": True}, {"rqmc_randomizations": 2}):
        req = schemas.PriceRequest(**dict(base, **extra))
        assert pcoalesce.bucket_key(req, "cpu") is None
