"""Port pins for the SVCJ slice: the torch twin step for step against the
JAX scan on replayed draws, kernel K8's plain version (the CPU side of
`cuda_kernels.svcj_terminal`) by law and against the interpreted Pallas
kernel's known path, and `SVCJEngine`. The kernel itself runs only on a
CUDA device (tests/test_torch_cuda.py and chip_smoke.py, word for word
against the plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine.svcj import SVCJEngine as JSVCJEngine
from mcos_tpu.models.params import SVCJParams as JSVCJParams
from mcos_tpu.ops import pallas_kernels as jpk
from mcos_tpu.ops import svcj as jsvcj
from mcos_tpu_torch.engine.svcj import SVCJEngine
from mcos_tpu_torch.models.params import SVCJParams
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import svcj as psvcj

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=2.0, mu_j=-0.04, sigma_j=0.08, mu_v=0.04,
               rho_j=-0.4, r=0.05, q=0.01)
_SPOT, _T = 100.0, 0.5


def _both(**updates):
    fields = dict(_FIELDS, **updates)
    jp = JSVCJParams(**fields)
    return jp, SVCJParams.from_numpy(
        {k: np.asarray(getattr(jp, k), np.float64) for k in fields})


def _replayed_draws(key, steps, n):
    """The JAX scan's own (steps, 3, n) normals and (steps, 2, n) uniforms
    (ops/svcj.py: fold_in by step, then one split)."""
    z, u = [], []
    for i in range(steps):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, i))
        z.append(np.asarray(jax.random.normal(k_norm, (3, n), jnp.float32)))
        u.append(np.asarray(jax.random.uniform(k_unif, (2, n), jnp.float32)))
    return torch.from_numpy(np.stack(z)), torch.from_numpy(np.stack(u))


@pytest.mark.parametrize("antithetic", [True, False])
def test_twin_equals_jax_scan_on_replayed_draws(antithetic):
    """`svcj_terminal` on the JAX scan's own draws: S, v and G at rtol 2e-5
    (v can sit at the truncation floor: atol 1e-7 beside it). lambda_j = 40
    lands a jump on most paths."""
    jp, pp = _both(lambda_j=40.0)
    steps, n = 16, 2048
    key = jax.random.key(7)
    ref = jsvcj.svcj_terminal(jp, _SPOT, _T, key, n, steps,
                              antithetic=antithetic, companion=True)
    got = psvcj.svcj_terminal(pp, _SPOT, _T, None, n, steps,
                              antithetic=antithetic, companion=True,
                              draws=_replayed_draws(key, steps, n))
    for g, r in zip(got, ref):
        assert g.shape == (2 if antithetic else 1, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=1e-7)
    assert psvcj.svcj_terminal(pp, _SPOT, _T, None, n, steps, companion=False,
                               draws=_replayed_draws(key, steps, n))[2] is None


@pytest.mark.parametrize("steps", [6, 7])
def test_twin_steps_the_interpreted_pallas_kernel(steps):
    """Off a TPU the Pallas interpreter's generator returns zero bits, so
    `svcj_terminal_pallas` runs one known path per branch: every uniform is
    2^-24, so every step jumps with the variance jump -mu_v log(2^-24);
    steps 2i and 2i+1 run on (z_a, z_b) with jump normals z_a and z_b, an
    odd tail on (z_a, z_b, z_a). The port's twin draws its exponential as
    -log1p(-u), so it is fed u = 1 - 2^-24, which is the same number. S, v
    and G agree at rtol 2e-5."""
    jp, pp = _both()
    n = 1024
    ref = jpk.svcj_terminal_pallas(jp, _SPOT, _T, 3, num_paths=n,
                                   num_steps=steps, companion=True, rows=8)
    u0 = jnp.float32(2.0 ** -24)
    z_a, z_b = (float(x) for x in jpk._boxmuller(u0, u0))
    z = np.empty((steps, 3, n), np.float32)
    z[0::2] = np.array([z_a, z_b, z_a], np.float32)[None, :, None]
    z[1::2] = np.array([z_a, z_b, z_b], np.float32)[None, :, None]
    if steps % 2:
        z[steps - 1] = np.array([z_a, z_b, z_a], np.float32)[:, None]
    u = np.empty((steps, 2, n), np.float32)
    u[:, 0] = 2.0 ** -24
    u[:, 1] = 1.0 - 2.0 ** -24
    got = psvcj.svcj_terminal(pp, _SPOT, _T, None, n, steps, companion=True,
                              draws=(torch.from_numpy(z),
                                     torch.from_numpy(u)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert (r == r[:, :1]).all()                 # one path per branch
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-5)


def _plain(pp, seed=11, n=1 << 12, steps=16, T=_T, **kw):
    before = dict(ck.launch_counts())
    out = ck.svcj_terminal(pp, _SPOT, T, seed, num_paths=n, num_steps=steps,
                           device="cpu", **kw)
    assert ck.launch_counts() == before        # a CPU device: no launch
    return out


def _plain_draws(seed, steps, n):
    """The (steps, 3, n) normals (z1, z2, z_js) and (steps, 2, n) uniforms
    (jump, exponential) K8's plain version draws, rebuilt from the layout
    its docstring states. The exponential uniform is handed over as 1 − u
    (exact in float32 on the generator's grid), so that the twin's
    −log1p(−·) is the plain version's −log(u)."""
    def words(call):
        return ck._pair_words(n, call, ck._SVCJ_DOMAIN, seed, "cpu")

    z, u, call = [], [], 0
    for _ in range(steps // 2):
        a, b, c = words(call), words(call + 1), words(call + 2)
        z1a, z2a = ck.box_muller(a[0], a[1])
        z1b, z2b = ck.box_muller(a[2], a[3])
        zja, zjb = ck.box_muller(b[0], b[1])
        z += [torch.stack([z1a, z2a, zja]), torch.stack([z1b, z2b, zjb])]
        u += [torch.stack([b[2], 1.0 - c[0]]), torch.stack([b[3], 1.0 - c[1]])]
        call += 3
    if steps % 2:
        a, b = words(call), words(call + 1)
        z.append(torch.stack([*ck.box_muller(a[0], a[1]),
                              ck.box_muller(a[2], a[3])[0]]))
        u.append(torch.stack([b[0], 1.0 - b[1]]))
    return torch.stack(z), torch.stack(u)


@pytest.mark.parametrize("steps", [16, 7])
@pytest.mark.parametrize("antithetic", [True, False])
def test_plain_equals_twin_on_its_own_philox_draws(steps, antithetic):
    """K8's plain version (what the card kernel is held bit-equal to) and
    the twin (pinned to the JAX scan above) on the same normals, jump
    uniforms and exponentials: S, v and G at rtol 2e-5 (atol 1e-7 for a v at
    the truncation floor), path by path, over an even and an odd step
    count. lambda_j = 12 fires a jump on some steps and not on others."""
    _, pp = _both(lambda_j=12.0)
    n, seed = 2048, 11
    z, u = _plain_draws(seed, steps, n)
    assert 0.2 < float((u[:, 0] < 12.0 * _T / steps).float().mean()) < 0.95
    ref = psvcj.svcj_terminal(pp, _SPOT, _T, None, n, steps,
                              antithetic=antithetic, companion=True,
                              draws=(z, u))
    got = ck.svcj_terminal_plain(pp, _SPOT, _T, seed, num_paths=n,
                                 num_steps=steps, antithetic=antithetic,
                                 companion=True)
    for g, r in zip(got, ref):
        assert g.shape == (2 if antithetic else 1, n)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-5,
                                   atol=1e-7)


def test_plain_law_matches_twin_moments():
    """Plain version (Philox, -log u) and JAX scan (threefry, -log1p(-u)):
    the same law on other streams. Means of log S, v, G and the call
    payoff within 4 combined se; the martingale E[S_T] = S0 e^{(r-q)T}."""
    jp, pp = _both(lambda_j=6.0)
    n, steps = 1 << 13, 16
    got = [x.double().numpy() for x in _plain(pp, n=n, steps=steps,
                                              companion=True)]
    ref = [np.asarray(x, np.float64) for x in jsvcj.svcj_terminal(
        jp, _SPOT, _T, jax.random.key(3), n, steps, companion=True)]
    stats = (lambda s, v, g: np.log(s), lambda s, v, g: v,
             lambda s, v, g: g,
             lambda s, v, g: np.maximum(s - _SPOT, 0.0))
    for f in stats:
        a, b = f(*got).mean(axis=0), f(*ref).mean(axis=0)
        se = np.hypot(a.std(), b.std()) / np.sqrt(n)
        assert abs(a.mean() - b.mean()) < 4 * se
    s = got[0].mean(axis=0)
    fwd = _SPOT * np.exp((pp.r - pp.q) * _T)
    assert abs(s.mean() - fwd) < 4 * s.std() / np.sqrt(n) + 1e-3 * fwd
    assert (got[1] >= 0).all()


@pytest.mark.parametrize("is_call", [True, False])
def test_plain_price_matches_cos_oracle(is_call):
    """`_svcj_price_core` on K8's plain version against `svcj_cos_price`:
    4 se + 1 % (the Euler bias at 32 steps)."""
    from mcos_tpu_torch.engine.svcj import _svcj_price_core

    _, pp = _both()
    strikes = np.array([90.0, 100.0, 110.0], np.float32)
    res = _svcj_price_core(pp, _SPOT, strikes, _T, 5, num_paths=1 << 13,
                           num_steps=32, is_call=is_call, backend="cuda",
                           device="cpu")
    exact = psvcj.svcj_cos_price(pp, _SPOT, strikes, _T, is_call)
    for i in range(3):
        assert abs(float(res["price"][i]) - exact[i]) \
            < 4 * float(res["std_error"][i]) + 0.01 * exact[i] + 1e-3
    assert float(res["frac_nonfinite"]) == 0.0


def test_odd_single_branch_and_no_companion_streams():
    _, pp = _both(lambda_j=30.0)
    a = _plain(pp, n=512, steps=7, companion=True)
    b = _plain(pp, n=512, steps=7, antithetic=False)
    assert b[2] is None and a[2].shape == (2, 512)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x[:1].numpy(), y.numpy())
    # jump uniforms and exponential jumps are shared by the pair: with the
    # diffusion off, both branches carry the same variance
    _, calm = _both(lambda_j=30.0, xi=0.0)
    _, v, _ = _plain(calm, n=512, steps=7)
    np.testing.assert_array_equal(v[0].numpy(), v[1].numpy())
    assert float(v.max()) > 0.05                 # some variance jumps landed


def test_params_round_trip_and_properties():
    jp, pp = _both()
    assert SVCJParams.from_numpy(pp.to_numpy()) == pp
    assert pp.as_dict() == {k: float(getattr(jp, k)) for k in _FIELDS}
    assert pp.jump_compensation == pytest.approx(
        float(jp.jump_compensation), rel=1e-6)
    assert pp.stationary_variance == pytest.approx(
        float(jp.stationary_variance))
    assert pp.svj_part().as_dict() == {
        k: float(getattr(jp.svj_part(), k)) for k in pp.svj_part().as_dict()}
    assert pp.validate() == jp.validate()
    bad = pp.replace(rho_j=30.0, mu_v=-0.1).validate()
    assert bad == jp.replace(rho_j=30.0, mu_v=-0.1).validate() and bad
    with pytest.raises(KeyError):
        SVCJParams.from_numpy({"kappa": 1.0})


def test_engine_against_jax_engine():
    """Same keys as the JAX engine for price (one and many strikes),
    mc_vs_cos, smile and greeks; deterministic fields equal, MC fields
    within 4 combined se."""
    jp, pp = _both()
    kw = dict(num_paths=1 << 12, num_steps=64, seed=4)
    jeng = JSVCJEngine(jp, **kw)
    for backend in ("cuda", "torch"):
        eng = SVCJEngine(pp, backend=backend, device="cpu", **kw)
        ref, got = jeng.price(_SPOT, 100.0, _T), eng.price(_SPOT, 100.0, _T)
        assert got.keys() == ref.keys()
        assert got["num_steps"] == ref["num_steps"] == 32
        assert got["bs_ref"] == pytest.approx(ref["bs_ref"], rel=1e-5)
        assert abs(got["price"] - ref["price"]) \
            < 4 * np.hypot(got["std_error"], ref["std_error"])
    chain = eng.price(_SPOT, [95.0, 105.0], _T)
    assert [r["strike"] for r in chain["chain"]] == [95.0, 105.0]
    assert chain.keys() == jeng.price(_SPOT, [95.0, 105.0], _T).keys()
    ref, got = (e.mc_vs_cos(_SPOT, [95.0, 105.0], _T) for e in (jeng, eng))
    for r, g in zip(ref["rows"], got["rows"]):
        assert g.keys() == r.keys()
        assert g["cos_price"] == pytest.approx(r["cos_price"], abs=1e-12)
        assert g["err_sigmas"] < 5
    ref, got = (e.smile(_SPOT, _T, [90.0, 100.0, 110.0]) for e in (jeng, eng))
    assert got.keys() == ref.keys()
    np.testing.assert_allclose(got["iv"], ref["iv"], rtol=0, atol=1e-12)
    ref, got = (e.greeks(_SPOT, 100.0, _T) for e in (jeng, eng))
    assert got.keys() == ref.keys()
    for k, tol in (("price", 0.05), ("delta", 0.05), ("vega", 0.15)):
        assert abs(got[k] - ref[k]) < tol * abs(ref[k]), k
    assert got["vega"] == pytest.approx(
        2.0 * np.sqrt(pp.v0) * got["dP_dv0"], rel=1e-6)


def test_engine_refuses_a_mesh():
    """The mesh, once refused, is slice N1's: a one-shard mesh launches K8
    (its plain version here) on the engine's seed, the unsharded path
    set."""
    from mcos_tpu_torch.parallel.mesh import make_mesh

    _, pp = _both()
    kw = dict(num_paths=2000, num_steps=16, device="cpu")
    ref = SVCJEngine(pp, **kw).price(100.0, [95.0, 105.0], 0.5)
    got = SVCJEngine(pp, mesh=make_mesh(["cpu"]), **kw).price(
        100.0, [95.0, 105.0], 0.5)
    for k in ("price", "std_error", "bs_ref", "v_max"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
