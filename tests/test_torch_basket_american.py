"""`mcos_tpu_torch/engine/basket_american.py` against
`mcos_tpu/engine/basket_american.py` on the JAX keys' own draws, replayed
into the port: the outer sheets per step (`fold_in(key, step)` → `split`
→ `normal(3, A, n)`, `uniform(A, n)`), the dual's inner blocks per date
and sub-step (`split(key)` → `fold_in(k_inner, k)` → `fold_in(ki, j)` →
`split` → `normal(3, n_inner/2, A, P)`, `uniform(n_inner/2, A, P)`).

Tolerances: the bases and every fixed-policy program (the lower bound and
the dual on the JAX package's own fitted coefficients) are float32 on both
sides: rtol 1e-5, path for path, beside atol 1e-6 for the bases' columns
near 0 and 1e-7 × K for discounted payoffs near 0 (a few float32 ulps of
a payoff of the strike's size). The regressions that fit a policy are
float32 normal equations whose solutions differ by rounding; a path whose
payoff sits that close to its continuation exercises in one package and
not in the other. Those flips are counted (≤ 3 % of pairs) and the prices
held within half a standard error, as tests/test_torch_american.py holds
the single-asset LSM."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.basket as jb
import mcos_tpu.engine.basket_american as jba
import mcos_tpu_torch.engine.basket as pb
import mcos_tpu_torch.engine.basket_american as pba
from mcos_tpu.models.params import SVJParams as JSVJ
from mcos_tpu_torch.models.params import SVJParams, _stack_params

torch.set_num_threads(1)

N, N_EX, SPP, SEED = 2000, 4, 2, 7
STEPS = N_EX * SPP
FIELDS = [dict(kappa=3.0, theta=0.04, xi=0.3, rho=-0.5, v0=0.04,
               lambda_j=0.5, mu_j=-0.03, sigma_j=0.05, r=0.05, q=0.02),
          dict(kappa=1.5, theta=0.06, xi=0.5, rho=-0.7, v0=0.05,
               lambda_j=1.0, mu_j=-0.05, sigma_j=0.1, r=0.04, q=0.0)]
CORR = np.array([[1.0, 0.3], [0.3, 1.0]])
CHOL = np.linalg.cholesky(CORR).astype(np.float32)
SPOTS = [100.0, 95.0]
T, K = 1.0, 100.0
R_NUM = FIELDS[0]["r"]
W = [0.6, 0.4]
CASES = [("max", True, None), ("min", False, None), ("basket", False, W)]


def _batches():
    jp = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x, jnp.float32) for x in xs]),
        *[JSVJ(**f) for f in FIELDS])
    return jp, _stack_params([SVJParams(**f) for f in FIELDS])


def _replayed(key, steps, n, a=2):
    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (3, a, n), jnp.float32),
                jax.random.uniform(k_u, (a, n), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _inner_replayed(k_inner, n_ex, spp, half, P, a=2):
    """The dual's inner halves for every (date, sub-step)."""
    def one(k, j):
        kj = jax.random.fold_in(jax.random.fold_in(k_inner, k), j)
        kn, ku = jax.random.split(kj)
        return (jax.random.normal(kn, (3, half, a, P), jnp.float32),
                jax.random.uniform(ku, (half, a, P), jnp.float32))

    z, u = jax.vmap(lambda k: jax.vmap(lambda j: one(k, j))(
        jnp.arange(spp)))(jnp.arange(n_ex, dtype=jnp.int32))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def _jw(w):
    return None if w is None else jnp.asarray(w, jnp.float32)


def _static(kind, is_call):
    return dict(n_ex=N_EX, steps_per_period=SPP, kind=kind, is_call=is_call)


@pytest.fixture(scope="module")
def keys():
    return jax.random.split(jax.random.key(SEED), 3)


@pytest.mark.parametrize("kind,is_call,w", CASES)
def test_bases_match_jax(kind, is_call, w):
    """The 13-column policy basis on a date slice and the 8-column value
    basis on a slice and on an (n_inner, A, P) block (atol 1e-6 for the
    polynomial columns near 0)."""
    rng = np.random.default_rng(0)
    s = (100.0 * np.exp(0.2 * rng.standard_normal((3, 2, 500)))).astype(
        np.float32)
    wj = jnp.full((2,), 0.5, jnp.float32) if w is None else _jw(w)
    wp = torch.from_numpy(np.array(wj))
    k = jnp.float32(K)
    ref = jba._ma_basis_fn(k, kind, is_call, wj)(jnp.asarray(s[0]))
    got = pba._ma_basis_fn(torch.tensor(K), kind, is_call, wp)(
        torch.from_numpy(s[0]))
    assert got.shape == (500, 13)
    _close(got, ref, atol=1e-6)
    for block in (s[0], s):
        ref = jba._ma_value_basis_fn(k, wj)(jnp.asarray(block))
        got = pba._ma_value_basis_fn(torch.tensor(K), wp)(
            torch.from_numpy(block))
        assert got.shape == block.shape[:-2] + (500, 8)
        _close(got, ref, atol=1e-6)


@pytest.mark.parametrize("kind,is_call,w", CASES)
def test_lsm_price_and_policy_flips_against_jax(keys, kind, is_call, w):
    """In-sample price within half a standard error of the JAX package's
    on its draws; the two packages' trained policies, run on one
    evaluation sheet, part on at most 3 % of the pairs and price within
    half a standard error."""
    jp, pp = _batches()
    args_j = (jp, jnp.asarray(SPOTS, jnp.float32), jnp.asarray(CHOL), K, T,
              R_NUM)
    args_p = (pp, SPOTS, CHOL, K, T, R_NUM, None)
    key = jax.random.key(SEED)
    ref = jba.lsm_basket_price(*args_j, key, num_paths=N, weights=_jw(w),
                               **_static(kind, is_call))
    got = pba.lsm_basket_price(*args_p, num_paths=N, weights=w,
                               draws=_replayed(key, STEPS, N),
                               **_static(kind, is_call))
    assert got.keys() == ref.keys()
    assert abs(float(got["price"]) - float(ref["price"])) \
        < 0.5 * float(ref["std_error"])
    _close(got["intrinsic"], ref["intrinsic"])

    k_train, k_eval = keys[0], keys[1]
    ref_c = jba.lsm_basket_train(*args_j, k_train, num_paths=N,
                                 weights=_jw(w), **_static(kind, is_call))
    got_c = pba.lsm_basket_train(*args_p, num_paths=N, weights=w,
                                 draws=_replayed(k_train, STEPS, N),
                                 **_static(kind, is_call))
    assert got_c["policy"].shape == (N_EX - 1, 13)
    assert got_c["value"].shape == (N_EX - 1, 8)
    ev = _replayed(k_eval, STEPS, N)
    pairs = [pba._lower_bound_pairs(*args_p, c, num_paths=N, weights=w,
                                    draws=ev, **_static(kind, is_call))
             for c in (got_c["policy"],
                       torch.from_numpy(np.array(ref_c["policy"])))]
    flips = int((pairs[0] != pairs[1]).sum())
    assert flips <= 0.03 * N, flips
    se = float(torch.std(pairs[1], correction=0)) / np.sqrt(N)
    assert abs(float(pairs[0].mean() - pairs[1].mean())) < 0.5 * se


@pytest.mark.parametrize("kind,is_call,w", CASES)
def test_lower_bound_on_jax_policy_matches_jax(keys, kind, is_call, w):
    """The fixed stopping rule (the JAX package's fitted coefficients) on
    the evaluation key's paths: every pair's value at rtol 1e-5."""
    jp, pp = _batches()
    args_j = (jp, jnp.asarray(SPOTS, jnp.float32), jnp.asarray(CHOL), K, T,
              R_NUM)
    coefs = jba.lsm_basket_train(*args_j, keys[0], num_paths=N,
                                 weights=_jw(w),
                                 **_static(kind, is_call))["policy"]
    lb = jax.jit(jba._lower_bound_pairs, static_argnames=(
        "num_paths", "n_ex", "steps_per_period", "kind", "is_call"))
    ref = lb(*args_j, keys[1], coefs, num_paths=N, weights=_jw(w),
             **_static(kind, is_call))
    got = pba._lower_bound_pairs(
        pp, SPOTS, CHOL, K, T, R_NUM, None, torch.from_numpy(np.array(coefs)),
        num_paths=N, weights=w, draws=_replayed(keys[1], STEPS, N),
        **_static(kind, is_call))
    assert got.shape == (N,)
    _close(got, ref, atol=1e-7 * K)
    res = pba.lsm_basket_lower_bound(
        pp, SPOTS, CHOL, K, T, R_NUM, None, torch.from_numpy(np.array(coefs)),
        num_paths=N, weights=w, draws=_replayed(keys[1], STEPS, N),
        **_static(kind, is_call))
    ref = jba.lsm_basket_lower_bound(*args_j, keys[1], coefs, num_paths=N,
                                     weights=_jw(w), **_static(kind, is_call))
    for k in ("price", "std_error"):
        _close(res[k], ref[k])


@pytest.mark.parametrize("kind,is_call,w", CASES)
def test_dual_on_jax_value_fit_matches_jax(keys, kind, is_call, w):
    """The dual on the JAX package's value coefficients, its outer sheet
    and its nested inner blocks replayed: every outer pair at rtol 1e-5."""
    n_outer, n_inner = 128, 16
    jp, pp = _batches()
    args_j = (jp, jnp.asarray(SPOTS, jnp.float32), jnp.asarray(CHOL), K, T,
              R_NUM)
    coefs_v = jba.lsm_basket_train(*args_j, keys[0], num_paths=N,
                                   weights=_jw(w),
                                   **_static(kind, is_call))["value"]
    dual = jax.jit(jba._dual_pairs, static_argnames=(
        "n_outer", "n_inner", "n_ex", "steps_per_period", "kind",
        "is_call"))
    ref = dual(*args_j, keys[2], coefs_v, n_outer=n_outer, n_inner=n_inner,
               weights=_jw(w), **_static(kind, is_call))
    k_outer, k_inner = jax.random.split(keys[2])
    got = pba._dual_pairs(
        pp, SPOTS, CHOL, K, T, R_NUM, None,
        torch.from_numpy(np.array(coefs_v)), n_outer=n_outer,
        n_inner=n_inner, weights=w,
        draws=_replayed(k_outer, STEPS, n_outer),
        inner_draws=_inner_replayed(k_inner, N_EX, SPP, n_inner // 2,
                                    2 * n_outer),
        **_static(kind, is_call))
    assert got.shape == (n_outer,)
    _close(got, ref, atol=1e-7 * K)


def test_bracket_and_engine_price():
    """The port's generators (seed, seed + 1, seed + 2): the bracket holds
    (lower ≤ upper within 3 combined se), the Bermudan price's keys are the
    JAX package's, and n_ex = 1 is the European max-call."""
    eng = pb.BasketEngine([SVJParams(**f) for f in FIELDS], CORR,
                          num_paths=N, seed=3, device="cpu")
    out = eng.price_bounds_american(SPOTS, K, T, kind="max", n_ex=N_EX,
                                    steps_per_period=SPP, n_outer=128,
                                    n_inner=16)
    assert out["lower_bound"] <= out["upper_bound"] + 3 * np.hypot(
        out["lower_se"], out["upper_se"])
    assert out.keys() == {"lower_bound", "lower_se", "upper_bound",
                          "upper_se", "duality_gap", "price", "n_exercise",
                          "n_outer", "n_inner"}
    jeng = jb.BasketEngine([JSVJ(**f) for f in FIELDS], CORR,
                           num_paths=1000, seed=3)
    ref = jeng.price_american(SPOTS, K, T, n_ex=2, steps_per_period=1)
    got = eng.price_american(SPOTS, K, T, n_ex=2, steps_per_period=1)
    assert got.keys() == ref.keys()
    one = eng.price_american(SPOTS, K, T, n_ex=1, steps_per_period=4)
    eur = eng.price_rainbow(SPOTS, K, T, kind="best_of")
    assert abs(one["price"] - eur["price"]) < 4 * one["std_error"]


@pytest.mark.parametrize("call", [
    lambda e: e.price_american(SPOTS, K, T, kind="rainbow"),
    lambda e: e.price_american(SPOTS, K, T, kind="basket"),
    lambda e: e.price_bounds_american(SPOTS, K, T, kind="basket"),
    lambda e: e.price_bounds_american(SPOTS, K, T, kind="spread")])
def test_validation_matches_jax(call):
    jeng = jb.BasketEngine([JSVJ(**f) for f in FIELDS], CORR, num_paths=1000)
    peng = pb.BasketEngine([SVJParams(**f) for f in FIELDS], CORR,
                           num_paths=1000, device="cpu")
    with pytest.raises(ValueError) as a:
        call(jeng)
    with pytest.raises(ValueError) as b:
        call(peng)
    assert str(a.value) == str(b.value)


def test_single_asset_refused_as_jax():
    for call in (lambda e: e.price_american([100.0], K, T),
                 lambda e: e.price_bounds_american([100.0], K, T)):
        with pytest.raises(ValueError) as a:
            call(jb.BasketEngine([JSVJ()], [[1.0]], num_paths=1000))
        with pytest.raises(ValueError) as b:
            call(pb.BasketEngine([SVJParams()], [[1.0]], num_paths=1000,
                                 device="cpu"))
        assert str(a.value) == str(b.value)
