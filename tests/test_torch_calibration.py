"""The port's calibration stack (`mcos_tpu_torch/engine/calibration.py`,
`engine/quotegreeks.py`, `utils/optim.py`'s warm start and
`models/params.py`'s surface bootstrap) against the JAX package's on CPU.

Tolerances:
- host float64 parts at rtol 1e-9: `calibrate_fast`'s objectives at the
  same x, `parameter_uncertainty`, `calibrate_term_structure`,
  `calibrate_from_chain` and the quote Greeks. Their vega weights are
  float32 in both packages (`bs_vega`), and the two float32 `bs_vega`s
  differ in the last ulp, so the weights are held at rtol 1e-6 and the
  float64 parts are compared on the JAX package's weights (the port's
  `compute_vega_weights` swapped for them); the de-Americanized chain's
  float32 European prices likewise on the JAX package's `bs_price`. scipy's differential
  evolution is swapped for a stub that evaluates the objective at fixed
  points, so both packages' engines run every line but the search.
- the Monte Carlo objectives at fixed x on the JAX key's draws replayed
  (fold_in(k_price, t) → split → normal (3, n), uniform (n,)): the chain
  prices to float32 rounding over 10 steps (rtol 2e-5), the objectives
  rtol 1e-4 (a squared residual amplifies the prices' relative error by
  2·price/residual, ≤ 5 here), through the twin (backend "torch") and K1's
  plain version (backend "cuda" on the CPU).
- the differential-evolution fits, whose streams differ (threefry against
  a torch generator), by outcome: each stage's fitted objective within 2×
  the JAX package's (each on its own 4096-path draws) and the fitted
  parameters repricing the chain by COS within 2× the JAX fit's RMS + 0.02
  (the 10-step Euler bias and the MC error bound both fits alike).
"""

import numpy as np
import pytest
import scipy.optimize
import torch

import mcos_tpu.engine.calibration as jcal
import mcos_tpu.engine.quotegreeks as jqg
import mcos_tpu.models.params as jparams
import mcos_tpu_torch.engine.calibration as pcal
import mcos_tpu_torch.engine.quotegreeks as pqg
import mcos_tpu_torch.models.params as pparams
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.cos_pricer import cos_price
from mcos_tpu_torch.utils.optim import differential_evolution

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TRUE = dict(kappa=2.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.045, lambda_j=0.8,
            mu_j=-0.08, sigma_j=0.12, r=0.065, q=0.012)
SPOT, T = 100.0, 0.5
STRIKES = np.linspace(80.0, 120.0, 11)
N, STEPS, SEED = 4096, 10, 42


def _market():
    return np.asarray(cos_price(SVJParams(**TRUE), SPOT, STRIKES, T, True),
                      np.float64)


def _jparams(p: SVJParams):
    return jparams.SVJParams(**p.to_numpy())


# ─────────────────────────────────────────────────────────────────────────────
# The slice's modules: the JAX package's public names
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("name", [
    "engine.surface", "engine.ssvi", "engine.calibration", "engine.localvol",
    "engine.slv", "engine.quotegreeks", "models.params", "utils.optim"])
def test_public_names_match_jax(name):
    import importlib
    import inspect

    def public(mod):
        out = set()
        for n in dir(mod):
            obj = getattr(mod, n)
            if (n.startswith("_") or inspect.ismodule(obj)
                    or n in ("jax", "jnp", "torch", "Array")):
                continue
            if getattr(obj, "__module__", mod.__name__) == mod.__name__:
                out.add(n)
        return out

    jmod = importlib.import_module(f"mcos_tpu.{name}")
    pmod = importlib.import_module(f"mcos_tpu_torch.{name}")
    assert public(pmod) == public(jmod)


# ─────────────────────────────────────────────────────────────────────────────
# Differential evolution's warm start
# ─────────────────────────────────────────────────────────────────────────────
def _sphere(x):
    return torch.sum((x - 0.3) ** 2, dim=-1)


def test_de_x0_replaces_member_zero():
    seen = []

    def obj(x):
        seen.append(x.clone())
        return _sphere(x)

    bounds = np.array([[-1.0, 1.0], [-1.0, 1.0], [0.0, 2.0]], np.float32)
    gen = torch.Generator().manual_seed(3)
    differential_evolution(obj, bounds, gen, pop_size=6, iters=2,
                           x0=[0.25, -5.0, 1.5])
    # Member 0 is x0, clipped to the bounds; the others are the same
    # uniform draws a run without x0 makes.
    assert seen[0][0].tolist() == [0.25, -1.0, 1.5]
    ref = []
    differential_evolution(lambda x: (ref.append(x.clone()), _sphere(x))[1],
                           bounds, torch.Generator().manual_seed(3),
                           pop_size=6, iters=2)
    assert torch.equal(seen[0][1:], ref[0][1:])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_de_never_worse_than_x0(seed):
    # A rugged objective where x0 is the global minimum: DE keeps it.
    def rugged(x):
        return torch.sum(x**2 - 0.5 * torch.cos(12.0 * x), dim=-1)

    bounds = np.array([[-2.0, 2.0]] * 3, np.float32)
    x0 = [0.0, 0.0, 0.0]
    f_x0 = float(rugged(torch.zeros(1, 3))[0])
    res = differential_evolution(rugged, bounds,
                                 torch.Generator().manual_seed(seed),
                                 pop_size=5, iters=3, x0=x0)
    assert float(res.fun) <= f_x0
    assert float(res.history[0]) <= f_x0


def test_de_callers_without_x0_unchanged():
    # The rough engine's call (no x0) draws the same population as before.
    bounds = np.array([[0.0, 1.0], [-1.0, 1.0]], np.float32)
    a = differential_evolution(_sphere, bounds,
                               torch.Generator().manual_seed(9), pop_size=4,
                               iters=5)
    b = differential_evolution(_sphere, bounds,
                               torch.Generator().manual_seed(9), pop_size=4,
                               iters=5, x0=None)
    assert torch.equal(a.x, b.x) and torch.equal(a.history, b.history)


# ─────────────────────────────────────────────────────────────────────────────
# models/params.py: the surface bootstrap
# ─────────────────────────────────────────────────────────────────────────────
def test_term_structure_from_surface_matches_jax():
    mats = np.array([1 / 365, 0.1, 0.5, 2.0])
    atm = np.array([0.25, 0.22, 0.2, 0.19])
    skew = np.array([-0.01, -0.05, 0.08, 0.02])
    base = SVJParams(**TRUE)
    got = pparams.build_term_structure_from_surface(mats, atm, skew, base)
    ref = jparams.build_term_structure_from_surface(mats, atm, skew,
                                                    _jparams(base))
    _close(got, ref)
    assert pparams.extract_forward_variance(0.21, 0.1) == \
        jparams.extract_forward_variance(0.21, 0.1)


# ─────────────────────────────────────────────────────────────────────────────
# Weights and penalties
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("spreads", [None, np.linspace(0.05, 0.5, 11)])
def test_vega_weights_match_jax(spreads):
    got = pcal.compute_vega_weights(SPOT, STRIKES, T, 0.05, 0.01, 0.18,
                                    spreads).numpy()
    ref = np.asarray(jcal.compute_vega_weights(SPOT, STRIKES, T, 0.05, 0.01,
                                               0.18, spreads))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_feller_penalty_matches_jax():
    rng = np.random.default_rng(0)
    k, th, xi = (rng.uniform(0.05, 3.0, 50).astype(np.float32)
                 for _ in range(3))
    got = pcal._feller_penalty(torch.from_numpy(k), torch.from_numpy(th),
                               torch.from_numpy(xi)).numpy()
    ref = np.asarray(jcal._feller_penalty(k, th, xi))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert (got == 0).any() and (got > 0).any()


# ─────────────────────────────────────────────────────────────────────────────
# The Monte Carlo objectives on replayed draws
# ─────────────────────────────────────────────────────────────────────────────
@pytest.fixture(scope="module")
def replayed():
    """The JAX objectives' data and the same draws as the port's
    (z1, z2, u_jump, z_js), each (steps, paths)."""
    k_price = jax.random.split(jax.random.key(SEED), 3)[0]

    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(k_price, t))
        return (jax.random.normal(k_norm, (3, N), jnp.float32),
                jax.random.uniform(k_unif, (N,), jnp.float32))

    z, u = (np.asarray(a) for a in jax.vmap(one)(jnp.arange(STEPS)))
    draws = tuple(torch.from_numpy(np.array(a))
                  for a in (z[:, 0], z[:, 1], u, z[:, 2]))
    return k_price, draws


def _data(k_price, draws, strikes, weights):
    market = _market()[np.isin(STRIKES, strikes)].astype(np.float32)
    jdata = {"spot": jnp.float32(SPOT), "strikes": jnp.asarray(strikes,
                                                               jnp.float32),
             "T": jnp.float32(T), "market_prices": jnp.asarray(market),
             "weights": jnp.asarray(weights), "r": jnp.float32(0.065),
             "q": jnp.float32(0.012), "key": k_price}
    pdata = {"spot": SPOT, "T": T, "r": 0.065, "q": 0.012, "draws": draws,
             "strikes": torch.from_numpy(strikes.astype(np.float32)),
             "market_prices": torch.from_numpy(market),
             "weights": torch.from_numpy(np.array(weights, np.float32))}
    return jdata, pdata


HESTON_X = np.array([[3.0, 0.04, 0.5, -0.7, 0.04],
                     [1.0, 0.09, 0.9, -0.2, 0.06],
                     [6.0, 0.02, 0.3, 0.3, 0.02]], np.float32)
JUMP_X = np.array([[1.0, -0.05, 0.10], [3.0, -0.15, 0.25],
                   [0.2, 0.05, 0.05]], np.float32)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_heston_objective_matches_jax_on_replayed_draws(replayed, backend):
    k_price, draws = replayed
    strikes = STRIKES[3:8]
    w = np.asarray(jcal.compute_vega_weights(SPOT, strikes, T, 0.065, 0.012,
                                             0.15))
    jdata, pdata = _data(k_price, draws, strikes, w)
    got = pcal.heston_objective(torch.from_numpy(HESTON_X), pdata,
                                backend=backend).numpy()
    ref = np.array([float(jcal.heston_objective(
        jnp.asarray(x), jdata, num_paths=N, num_steps=STEPS))
        for x in HESTON_X])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)
    # The chain prices themselves, member 0, to float32 rounding.
    p0 = SVJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
                   lambda_j=0.0, mu_j=0.0, sigma_j=0.01, r=0.065, q=0.012)
    got_p = pcal._chain_prices(p0, SPOT, pdata["strikes"], T, draws,
                               is_call=True, backend=backend).numpy()
    ref_p = np.asarray(jcal._chain_prices(
        _jparams(p0), SPOT, jnp.asarray(strikes, jnp.float32), T, k_price,
        num_paths=N, num_steps=STEPS, is_call=True))
    np.testing.assert_allclose(got_p, ref_p, rtol=2e-5, atol=0)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_svj_objective_matches_jax_on_replayed_draws(replayed, backend):
    k_price, draws = replayed
    w = np.asarray(jcal.compute_vega_weights(SPOT, STRIKES, T, 0.065, 0.012,
                                             0.15))
    jdata, pdata = _data(k_price, draws, STRIKES, w)
    core = [2.0, 0.05, 0.4, -0.6, 0.045]
    jdata["heston_x"] = jnp.asarray(core, jnp.float32)
    pdata["heston_x"] = core
    got = pcal.svj_objective(torch.from_numpy(JUMP_X), pdata,
                             backend=backend).numpy()
    ref = np.array([float(jcal.svj_objective(
        jnp.asarray(x), jdata, num_paths=N, num_steps=STEPS))
        for x in JUMP_X])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("stage", [1, 2])
def test_population_objectives_match_jax_vmap(replayed, monkeypatch, stage):
    """The DE's objective (backend "cuda"): one K1 population call and one
    (P, K, paths) pricing tail for the whole generation, against the JAX
    package's vmapped objective, as its differential evolution calls it
    (rtol 1e-4, as above)."""
    from mcos_tpu_torch.ops import cuda_kernels as ck

    k_price, draws = replayed
    strikes = STRIKES if stage == 2 else STRIKES[3:8]
    w = np.asarray(jcal.compute_vega_weights(SPOT, strikes, T, 0.065, 0.012,
                                             0.15))
    jdata, pdata = _data(k_price, draws, strikes, w)
    core = [2.0, 0.05, 0.4, -0.6, 0.045]
    jdata["heston_x"] = jnp.asarray(core, jnp.float32)
    pdata["heston_x"] = core
    base = HESTON_X if stage == 1 else JUMP_X
    x = np.concatenate([base, base * np.float32(0.5)]).astype(np.float32)
    jfn, pfn = ((jcal.heston_objective, pcal.heston_objective) if stage == 1
                else (jcal.svj_objective, pcal.svj_objective))
    calls = []
    real = ck.svj_terminal_from_draws_population
    monkeypatch.setattr(ck, "svj_terminal_from_draws_population",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = pfn(torch.from_numpy(x), pdata, backend="cuda").numpy()
    assert len(calls) == 1
    ref = np.asarray(jax.vmap(lambda xx: jfn(
        xx, jdata, num_paths=N, num_steps=STEPS))(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=0)


@pytest.mark.parametrize("budget_members", [1, 2])
def test_population_tail_chunks_keep_every_bit(replayed, monkeypatch,
                                               budget_members):
    """The population tail a few members at a time (a budget forced below
    the generation's tables) gives the prices of the whole-generation tail,
    word for word."""
    from mcos_tpu_torch.engine import pricer

    _, draws = replayed
    members = [SVJParams(**dict(zip(pcal._HESTON_NAMES, row)), lambda_j=0.8,
                         mu_j=-0.08, sigma_j=0.12, r=0.065, q=0.012)
               for row in HESTON_X.tolist() * 2]
    strikes = torch.from_numpy(STRIKES.astype(np.float32))
    whole = pricer.population_prices_from_draws(members, SPOT, strikes, T,
                                                *draws, is_call=True)
    per_member = 16 * len(STRIKES) * N
    monkeypatch.setattr(pricer, "POPULATION_TAIL_BUDGET",
                        budget_members * per_member)
    parts = pricer.population_prices_from_draws(members, SPOT, strikes, T,
                                                *draws, is_call=True)
    assert whole.shape == (6, len(STRIKES))
    assert torch.equal(parts, whole)


def test_polish_objective_is_differentiable(replayed):
    k_price, draws = replayed
    strikes = STRIKES[3:8]
    w = np.asarray(jcal.compute_vega_weights(SPOT, strikes, T, 0.065, 0.012,
                                             0.15))
    jdata, pdata = _data(k_price, draws, strikes, w)
    x = torch.from_numpy(HESTON_X[:1].copy()).requires_grad_(True)
    val = pcal.heston_objective(x, pdata, backend="torch")[0]
    (grad,) = torch.autograd.grad(val, x)
    ref = np.asarray(jax.grad(lambda xx: jcal.heston_objective(
        xx, jdata, num_paths=N, num_steps=STEPS))(jnp.asarray(HESTON_X[0])))
    np.testing.assert_allclose(grad[0].numpy(), ref, rtol=2e-3,
                               atol=1e-4 * np.abs(ref).max())


# ─────────────────────────────────────────────────────────────────────────────
# calibrate: by outcome
# ─────────────────────────────────────────────────────────────────────────────
@pytest.fixture(scope="module")
def fits():
    market = _market()
    kw = dict(num_paths=N, num_steps=STEPS, pop_size=8)
    got = pcal.CalibrationEngine(device="cpu").calibrate(
        SPOT, STRIKES, T, market, **kw)
    ref = jcal.CalibrationEngine().calibrate(SPOT, STRIKES, T, market, **kw)
    return market, got, ref


def _cos_rms(p, market):
    return float(np.sqrt(np.mean(
        (np.asarray(cos_price(p, SPOT, STRIKES, T, True)) - market) ** 2)))


def test_calibrate_by_outcome(fits):
    market, got, ref = fits
    assert got.keys() == ref.keys()
    for stage in ("stage1_result", "stage2_result"):
        assert got[stage].keys() == ref[stage].keys()
        assert got[stage]["nit"] == ref[stage]["nit"]
        assert got[stage]["success"]
        assert got[stage]["error"] <= 2.0 * ref[stage]["error"], stage
    rms_got = _cos_rms(got["params"], market)
    rms_ref = _cos_rms(SVJParams(**ref["params"].as_dict()), market)
    assert rms_got <= 2.0 * rms_ref + 0.02, (rms_got, rms_ref)
    assert got["uncertainty"].keys() == ref["uncertainty"].keys()
    assert got["warnings"] == got["params"].validate()


def test_calibrate_refuses_a_mesh(fits):
    """The mesh, once refused, is slice N2's: `calibrate` on a one-shard
    mesh is the unsharded fit exactly, and the sharded training step
    builds (tests/test_torch_distributed.py holds both against JAX and
    over two shards)."""
    from mcos_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    market, got, _ = fits
    one = pcal.CalibrationEngine(device="cpu").calibrate(
        SPOT, STRIKES, T, market, num_paths=N, num_steps=STEPS, pop_size=8,
        mesh=make_mesh(["cpu"]))
    assert one["params"] == got["params"]
    for stage in ("stage1_result", "stage2_result"):
        assert one[stage] == got[stage]
    step, init = pcal.make_sharded_calibration_step(
        make_mesh_2d(1, ["cpu"]), num_paths=8, num_steps=2)
    assert callable(step) and len(init(HESTON_X[0])) == 2


# ─────────────────────────────────────────────────────────────────────────────
# Host float64 parts
# ─────────────────────────────────────────────────────────────────────────────
class _Stub:
    """scipy's differential evolution replaced: record the objective's
    values at fixed points inside the bounds, return the first."""

    def __init__(self):
        self.values = []

    def __call__(self, fn, bounds, **kw):
        lo, hi = np.asarray(bounds, np.float64).T
        pts = [lo + (hi - lo) * f for f in (0.37, 0.61, 0.12)]
        vals = [fn(p) for p in pts]
        self.values.append(vals)
        return scipy.optimize.OptimizeResult(x=pts[0], fun=vals[0], nit=1,
                                             success=True)


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's vega weights and de-Americanized prices swapped for the
    JAX package's (the float32 `bs_vega`s and `bs_price`s differ in the
    last ulp), and scipy's DE for stubs."""
    import mcos_tpu_torch.engine.surface as psurf
    from mcos_tpu.ops.bs import bs_price as jbs_price

    def weights(*a, **k):
        k.pop("device", None)
        return torch.from_numpy(np.array(jcal.compute_vega_weights(*a, **k)))

    monkeypatch.setattr(pcal, "compute_vega_weights", weights)
    monkeypatch.setattr(psurf, "bs_price", jbs_price)
    stubs = {"port": _Stub(), "jax": _Stub()}
    return monkeypatch, stubs


def _run_both(jax_weights, call):
    monkeypatch, stubs = jax_weights
    out = {}
    for name, mod in (("port", pcal), ("jax", jcal)):
        monkeypatch.setattr(scipy.optimize, "differential_evolution",
                            stubs[name])
        out[name] = call(mod)
    return out, stubs


def _close(got, ref, path=""):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys(), path
        for k in ref:
            _close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(ref, (float, np.floating)) and not isinstance(ref, bool):
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-14,
                                   err_msg=path)
    elif hasattr(ref, "as_dict"):
        _close(got.as_dict(), ref.as_dict(), path)
    elif hasattr(ref, "__dict__"):       # TermStructureSVJ: scalars, curves
        _close(vars(got), vars(ref), path)
    else:
        assert got == ref, path


@pytest.mark.parametrize("case", [
    {},
    {"is_call": False, "bid_ask_spreads": list(np.linspace(0.1, 0.6, 11))},
    {"regime_adjustments": {"xi_bounds": (0.2, 1.0), "rho_bounds": (-0.9, 0.0),
                            "lambda_bounds": (0.0, 2.0),
                            "regularization_scale": 3.0}},
])
def test_calibrate_fast_matches_jax(jax_weights, case):
    market = _market() if case.get("is_call", True) else np.asarray(
        cos_price(SVJParams(**TRUE), SPOT, STRIKES, T, False))
    out, stubs = _run_both(jax_weights, lambda m: m.CalibrationEngine()
                           .calibrate_fast(SPOT, STRIKES, T, market, **case))
    # The objectives at the same points, then every field of the result
    # (the COS-oracle error bars included).
    np.testing.assert_allclose(stubs["port"].values, stubs["jax"].values,
                               rtol=1e-9, atol=0)
    _close(out["port"], out["jax"])


def test_parameter_uncertainty_matches_jax(jax_weights):
    p = SVJParams(**TRUE)
    market = _market() * (1 + 0.002 * np.sin(np.arange(11)))
    got = pcal.CalibrationEngine().parameter_uncertainty(
        p, SPOT, STRIKES, T, market, atm_vol=0.2)
    ref = jcal.CalibrationEngine().parameter_uncertainty(
        _jparams(p), SPOT, STRIKES, T, market, atm_vol=0.2)
    _close(got, ref)


def test_term_structure_matches_jax(jax_weights):
    mats = np.array([0.25, 0.5, 1.0])
    market = np.stack([cos_price(SVJParams(**TRUE), SPOT, STRIKES, t, True)
                       for t in mats])
    out, stubs = _run_both(jax_weights, lambda m: m.CalibrationEngine()
                           .calibrate_term_structure(SPOT, STRIKES, mats,
                                                     market))
    np.testing.assert_allclose(np.concatenate(stubs["port"].values),
                               np.concatenate(stubs["jax"].values),
                               rtol=1e-9, atol=0)
    _close(out["port"], out["jax"])


def _write_chain(path, is_american: bool):
    """A CSV chain: expiry_years, strike, is_call, bid, ask, open_interest
    at the calibration's T, priced by COS (or the CRR tree)."""
    from mcos_tpu_torch.engine.american import binomial_american_bs

    rows = ["expiry_years,strike,is_call,bid,ask,open_interest"]
    for K in STRIKES:
        for is_call in (True, False):
            if is_american:
                mid = binomial_american_bs(SPOT, K, T, 0.065, 0.012, 0.22,
                                           steps=256, is_call=is_call)
            else:
                mid = float(cos_price(SVJParams(**TRUE), SPOT, [K], T,
                                      is_call)[0])
            half = 0.01 + 0.002 * mid
            rows.append(f"{T},{K},{int(is_call)},{mid - half:.6f},"
                        f"{mid + half:.6f},{1000 + int(K)}")
    rows.append(f"{T},100.0,1,0.0,0.0,5")        # illiquid: screened out
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("exercise", ["european", "american"])
def test_calibrate_from_chain_matches_jax(jax_weights, tmp_path, exercise):
    csv = _write_chain(tmp_path / "chain.csv", exercise == "american")
    out, stubs = _run_both(
        jax_weights, lambda m: m.CalibrationEngine().calibrate_from_chain(
            csv, SPOT, T, is_call=exercise == "european",
            exercise=exercise))
    np.testing.assert_allclose(stubs["port"].values, stubs["jax"].values,
                               rtol=1e-9, atol=0)
    _close(out["port"], out["jax"])
    assert out["port"]["n_quotes"] >= 4


def test_calibrate_from_chain_refusals_match_jax(tmp_path):
    csv = _write_chain(tmp_path / "chain.csv", False)
    for kw in ({"exercise": "bermudan"}, {"min_strikes": 50}):
        with pytest.raises(ValueError) as got:
            pcal.CalibrationEngine().calibrate_from_chain(csv, SPOT, T, **kw)
        with pytest.raises(ValueError) as ref:
            jcal.CalibrationEngine().calibrate_from_chain(csv, SPOT, T, **kw)
        assert str(got.value) == str(ref.value)


def test_history_matches_jax(jax_weights):
    out, _ = _run_both(jax_weights, lambda m: (lambda e: (
        e.calibrate_fast(SPOT, STRIKES, T, _market()), e.get_history())[1])(
            m.CalibrationEngine()))
    _close(out["port"], out["jax"])


# ─────────────────────────────────────────────────────────────────────────────
# Quote Greeks (host float64)
# ─────────────────────────────────────────────────────────────────────────────
@pytest.mark.parametrize("product,free,surface", [
    ({"kind": "vanilla", "T": 0.5, "strike": 103.0}, pqg.CORE4, False),
    ({"kind": "digital", "T": 0.5, "strike": 97.0, "is_call": False},
     pqg.HESTON_CORE, False),
    ({"kind": "varswap", "T": 0.75, "notional": 2.0}, pqg.ALL_PARAMS, True),
])
def test_quote_bucket_greeks_match_jax(product, free, surface):
    p = SVJParams(**TRUE)
    if surface:
        strikes = [STRIKES[::2], STRIKES[1::2]]
        Ts = [0.25, 1.0]
    else:
        strikes, Ts = STRIKES, 0.5
    got = pqg.quote_bucket_greeks(p, SPOT, strikes, Ts, product, free=free)
    ref = jqg.quote_bucket_greeks(_jparams(p), SPOT, strikes, Ts, product,
                                  free=free)
    _close(got, ref)
    assert pqg.ALL_PARAMS == jqg.ALL_PARAMS and pqg.CORE4 == jqg.CORE4


def test_quote_greeks_refusals_match_jax():
    p = SVJParams(**TRUE)
    for args in ((STRIKES, [0.5, 1.0]),):
        with pytest.raises(ValueError) as got:
            pqg.quote_transfer_matrix(p, SPOT, *args)
        with pytest.raises(ValueError) as ref:
            jqg.quote_transfer_matrix(_jparams(p), SPOT, *args)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as got:
        pqg.product_price_and_gradient(p, SPOT, {"kind": "asian", "T": 1.0})
    with pytest.raises(ValueError) as ref:
        jqg.product_price_and_gradient(_jparams(p), SPOT,
                                       {"kind": "asian", "T": 1.0})
    assert str(got.value) == str(ref.value)
