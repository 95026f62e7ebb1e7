"""Port pins for kernel K6 `svj_path_stats` through its plain version (the
CPU side of the wrapper). The streams differ (Philox here, threefry or the
TPU's generator there), so the plain version is held by law against the JAX
scan twin and the closed forms; the port's twin, which shares the step
algebra, is held step for step against the interpreted Pallas kernel, whose
generator gives zero bits off a TPU, on the draws those bits make. The
kernel itself runs only on a CUDA device
(tests/test_torch_cuda.py and chip_smoke.py, word for word against this
plain version)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.models.params import SVJParams as JSVJParams
from mcos_tpu.ops import exotics as jox
from mcos_tpu.ops import pallas_kernels as jpk
from mcos_tpu_torch.engine.exotics import ExoticEngine
from mcos_tpu_torch.models.params import SVJParams, gbm_params
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import exotics as pox

torch.set_num_threads(1)

_FIELDS = dict(kappa=3.0, theta=0.06, xi=0.4, rho=-0.6, v0=0.04,
               lambda_j=1.5, mu_j=-0.05, sigma_j=0.1)
_SPOT, _T, _N, _STEPS = 100.0, 0.5, 1 << 14, 16
_LOG_B, _LOG_L = float(np.log(1.10)), float(np.log(0.90))
_VARIANTS = {
    "no_bridge": dict(),
    "up": dict(bridge=True, bridge_up=True, bridge_log_b=_LOG_B),
    "down": dict(bridge=True, bridge_up=False, bridge_log_b=_LOG_L),
    "corridor": dict(bridge=True, corridor=True, bridge_log_b=_LOG_B,
                     bridge_log_l=_LOG_L),
    "corridor_window": dict(bridge=True, corridor=True, bridge_log_b=_LOG_B,
                            bridge_log_l=_LOG_L, window=(3, 11),
                            companion=False),
}


def _plain(fields=_FIELDS, seed=17, n=_N, steps=_STEPS, **kw):
    before = dict(ck.launch_counts())
    out = ck.svj_path_stats(SVJParams(**fields), _SPOT, _T, seed,
                            num_paths=n, num_steps=steps, device="cpu", **kw)
    assert ck.launch_counts() == before    # a CPU device: no launch
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_plain_law_matches_scan_twin(name):
    """Mean of every output within 4 se of the JAX twin's (both sampled);
    the survival weights compared as exp(log_surv), whose dead paths are 0."""
    kw = dict(dict(companion=True), **_VARIANTS[name])
    got = _plain(**kw)
    ref = jox.simulate_path_stats(
        JSVJParams(**_FIELDS), _SPOT, _T, jax.random.key(17), num_paths=_N,
        num_steps=_STEPS, **kw)
    ref = {k: np.asarray(v) for k, v in ref.items() if k != "v_final"}
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key]
        assert g.shape == (2, _N)
        if key.endswith("log_surv"):
            g, r = np.exp(g), np.exp(r)
        # antithetic pairs are dependent: the se of the pair means
        g, r = g.mean(axis=0), r.mean(axis=0)
        se = np.hypot(g.std(), r.std()) / np.sqrt(_N)
        assert abs(g.mean() - r.mean()) < 4 * se + 1e-7, key
    assert (got["max_s"] >= got["s_final"]).all()
    assert (got["min_s"] <= got["s_final"]).all()
    assert (got["max_s"] >= got["avg"]).all()
    assert (got["avg"] >= np.exp(got["log_avg"]) * (1 - 1e-6)).all()


def test_twin_steps_the_interpreted_pallas_kernel():
    """Off a TPU the Pallas interpreter's generator returns zero bits, so
    `svj_path_stats_pallas` runs one known path per branch: every uniform is
    2^-24, every Box-Muller pair the same (z_a, z_b), and a jump lands on
    every step. The port's twin on those draws gives the same twelve
    outputs (rtol 1e-5; log_surv atol 1e-4), which pins the step algebra,
    the draw layout of steps 2i / 2i+1 / the odd tail, and the bridge
    against the TPU kernel itself."""
    steps, n = 7, 1024
    p_fields = dict(_FIELDS, lambda_j=3.0)
    kw = dict(bridge=True, bridge_up=True, bridge_log_b=0.9)
    ref = jpk.svj_path_stats_pallas(
        JSVJParams(**p_fields), _SPOT, _T, 3, num_paths=n, num_steps=steps,
        companion=True, rows=8, **kw)
    u0 = jnp.float32(2.0 ** -24)
    z_a, z_b = (float(x) for x in jpk._boxmuller(u0, u0))
    z = np.empty((steps, 3, n), np.float32)
    z[0::2] = np.array([z_a, z_b, z_a], np.float32)[None, :, None]
    z[1::2] = np.array([z_b, z_a, z_b], np.float32)[None, :, None]
    z[steps - 1] = np.array([z_a, z_b, z_a], np.float32)[:, None]  # odd tail
    u = np.full((steps, n), 2.0 ** -24, np.float32)
    got = pox.simulate_path_stats(
        SVJParams(**p_fields), _SPOT, _T, None, n, steps, companion=True,
        draws=(torch.from_numpy(z), torch.from_numpy(u)), **kw)
    for key, r in ref.items():
        r, g = np.asarray(r), got[key].numpy()
        assert (r == r[:, :1]).all(), key            # one path per branch
        if key.endswith("log_surv"):
            np.testing.assert_array_equal(np.isneginf(g), np.isneginf(r))
            live = np.isfinite(r)
            np.testing.assert_allclose(g[live], r[live], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("is_call,knock,barrier", [
    (True, "out", 110.0), (False, "in", 92.0)])
def test_gbm_bridge_barrier_within_3_se_of_closed_form(is_call, knock,
                                                       barrier):
    """Degenerate GBM, control variate off (with it on, the companion leg
    is the priced leg and the check is vacuous): the bridge estimator on
    K6's plain version is exact at any step count."""
    sigma, r, q = 0.2, 0.065, 0.012
    eng = ExoticEngine(gbm_params(sigma, r, q), num_paths=1 << 15,
                       num_steps=32, use_control_variate=False, device="cpu")
    res = eng.price_barrier(_SPOT, 100.0, _T, barrier, is_call, knock=knock,
                            monitoring="bridge")
    ref = pox.barrier_bs(_SPOT, 100.0, _T, r, q, sigma, barrier, is_call,
                         knock, "up" if barrier > _SPOT else "down")
    assert res["num_steps"] == 16
    assert abs(res["price"] - ref) < 3 * res["std_error"]


def test_gbm_corridor_within_3_se_of_closed_form():
    sigma, r, q = 0.2, 0.065, 0.012
    eng = ExoticEngine(gbm_params(sigma, r, q), num_paths=1 << 15,
                       num_steps=32, use_control_variate=False, device="cpu")
    res = eng.price_double_no_touch(_SPOT, _T, 85.0, 118.0)
    assert abs(res["price"] - res["closed_form_gbm"]) < 3 * res["std_error"]
    assert res["closed_form_gbm"] == pytest.approx(
        pox.double_no_touch_bs(_SPOT, _T, r, q, sigma, 85.0, 118.0))


@pytest.mark.parametrize("steps", [1, 2, 7, 16])
def test_plain_stream_is_shape_free(steps):
    """The stream depends on (pair, step, seed) only: the first n pairs of
    a 2n run are the n run, antithetic=False is row 0, and the SVJ leg does
    not depend on the companion or on the bridge mode."""
    kw = dict(_VARIANTS["up"], steps=steps)
    a = _plain(n=2048, seed=9, companion=True, **kw)
    b = _plain(n=4096, seed=9, companion=True, **kw)
    one = _plain(n=2048, seed=9, companion=True, antithetic=False, **kw)
    bare = _plain(n=2048, seed=9, companion=False, steps=steps)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k][:, :2048])
        np.testing.assert_array_equal(one[k], a[k][:1])
    assert set(bare) == {"s_final", "avg", "log_avg", "max_s", "min_s"}
    for k in bare:
        np.testing.assert_array_equal(bare[k], a[k])
    other = _plain(n=2048, seed=10, companion=True, **kw)
    assert not np.array_equal(other["s_final"], a["s_final"])
    if steps == 1:     # one observation: every functional is the terminal
        for k in ("avg", "max_s", "min_s"):
            np.testing.assert_allclose(a[k], a["s_final"], rtol=1e-6)
        np.testing.assert_allclose(np.exp(a["log_avg"]), a["s_final"],
                                   rtol=1e-5)
        assert np.isfinite(a["min_s"]).all()


def test_plain_negative_v0_is_read_clamped():
    """The carry starts at v0 and every step reads max(v, 0), as the twin
    does: a negative v0 runs the first step at zero variance."""
    neg = _plain(dict(_FIELDS, v0=-0.01, lambda_j=0.0), steps=4, n=2048,
                 companion=False)
    assert all(np.isfinite(v).all() for v in neg.values())
    ref = jox.simulate_path_stats(
        JSVJParams(**dict(_FIELDS, v0=-0.01, lambda_j=0.0)), _SPOT, _T,
        jax.random.key(0), num_paths=2048, num_steps=4, companion=False)
    # step 1 is deterministic at v = 0: the same first-step move in both
    drift = (0.065 - 0.012) * _T / 4
    assert np.log(neg["min_s"] / _SPOT).max() <= drift + 1e-6
    assert np.isfinite(np.asarray(ref["s_final"])).all()
    se = np.hypot(neg["avg"].std(), np.asarray(ref["avg"]).std()) / 32.0
    assert abs(neg["avg"].mean() - np.asarray(ref["avg"]).mean()) < 4 * se


def test_plain_lambda_zero_never_jumps():
    """u < λ·dt is never true at λ = 0 (the uniforms are strictly inside
    (0, 1)), so the jump size's law cannot matter."""
    a = _plain(dict(_FIELDS, lambda_j=0.0), n=2048, **_VARIANTS["corridor"])
    b = _plain(dict(_FIELDS, lambda_j=0.0, mu_j=-0.9, sigma_j=0.7), n=2048,
               **_VARIANTS["corridor"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert float(ck.bits_to_uniform(torch.tensor([0])).item()) > 0.0
    assert float(ck.bits_to_uniform(torch.tensor([0xFFFFFFFF])).item()) < 1.0


def test_plain_window_and_arguments():
    full = _plain(n=2048, **_VARIANTS["up"])
    same = _plain(n=2048, window=(0, _STEPS), **_VARIANTS["up"])
    part = _plain(n=2048, window=(4, 5), **_VARIANTS["up"])
    np.testing.assert_array_equal(same["log_surv"], full["log_surv"])
    assert (part["log_surv"] >= full["log_surv"]).all()
    assert (part["g_log_surv"] > full["g_log_surv"]).any()
    for bad in (dict(window=(0, 4)),                         # no bridge
                dict(corridor=True),                         # no bridge
                dict(bridge=True, window=(5, 5)),
                dict(bridge=True, window=(0, _STEPS + 1))):
        with pytest.raises(ValueError):
            _plain(n=64, **bad)
    with pytest.raises(ValueError):
        ck.svj_path_stats(SVJParams(), 1.0, 1.0, -1, num_paths=8,
                          num_steps=2, device="cpu")


def test_stats_consts_match_pack_params():
    """`_stats_consts` against `_pack_params` (the scalars the TPU kernel
    reads), with the barrier logs; then the launch constants after them
    against the plain version's own float32 operations on those scalars
    (the corridor's width and image products, the companion's step
    variance, its double and their reciprocals), bit for bit."""
    got = ck._stats_consts(SVJParams(**_FIELDS), _SPOT, _T, 63, _LOG_B,
                           _LOG_L)
    assert got.dtype == np.float32 and got.shape == (33,)
    ref = np.asarray(jpk._pack_params(JSVJParams(**_FIELDS), _SPOT, _T, 63,
                                      bridge_log_b=_LOG_B,
                                      bridge_log_l=_LOG_L))
    order = [jpk._P_SPOT, jpk._P_V0, jpk._P_DT, jpk._P_SQRT_DT, jpk._P_KAPPA,
             jpk._P_THETA, jpk._P_XI, jpk._P_RHO, jpk._P_RHO_PERP,
             jpk._P_LAM_DT, jpk._P_MU_J, jpk._P_SIG_J, jpk._P_DRIFT_DT,
             jpk._P_G_DRIFT_DT, jpk._P_SIG_CV, jpk._P_BRIDGE_B,
             jpk._P_BRIDGE_L]
    np.testing.assert_allclose(got[:17], ref[order], rtol=2e-6)
    assert got[17] == np.float32(1.0) / np.float32(63)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    width = f32(got[15]) - f32(got[16])
    assert got[18] == width.item()
    for j, n in enumerate(range(-2, 3)):
        assert got[19 + j] == (2.0 * n * width).item()
        assert got[24 + j] == (n * width).item()
    for consts in (got, ck._stats_consts(SVJParams(**dict(_FIELDS, v0=-0.01)),
                                         _SPOT, _T, 63, _LOG_B, _LOG_L)):
        g_s = torch.clamp(f32(consts[14]) * f32(consts[14]) * f32(consts[2]),
                          min=1e-20)
        if torch.isnan(g_s):        # sigma_cv = sqrt(v0 < 0): fmaxf's floor
            g_s = f32(1e-20)
        assert consts[29] == g_s.item()
        assert consts[30] == (2.0 * g_s).item()
        assert consts[31] == (1.0 / g_s).item()
        assert consts[32] == (1.0 / (2.0 * g_s)).item()


def test_new_entry_points_default_to_cuda():
    from mcos_tpu_torch.api import server
    from mcos_tpu_torch.engine import exotics as peng

    for fn in (ck.svj_path_stats, pox.simulate_path_stats,
               peng._price_exotic_core, peng._exotic_value_and_greeks,
               peng._digital_core, peng.ExoticEngine.__init__,
               server.handle_exotic):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn
    assert inspect.signature(
        ck.svj_path_stats_plain).parameters["device"].default == "cpu"
    assert "svj_path_stats" in ck.launch_counts()
