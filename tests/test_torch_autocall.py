"""`mcos_tpu_torch/engine/autocallable.py` against
`mcos_tpu/engine/autocallable.py` on the JAX keys' own draws, replayed into
the port: the single-asset note on the cliquet's period loop, the worst-of
note on the correlated basket's observation loop, the redemption
accounting, and the par coupon.

Tolerances: float32 programs on both sides: the price, its standard error
and the expected life rtol 1e-5; the redemption probabilities are the same
counts of paths over 2·paths, divided in float32 (rtol 1e-6, atol 1e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.engine.autocallable as ja
import mcos_tpu_torch.engine.autocallable as pa
from mcos_tpu.models.params import SVJParams as JSVJ
from mcos_tpu_torch.models.params import SVJParams, gbm_params

torch.set_num_threads(1)

N, SEED, SPP = 2000, 42, 4
FIELDS = dict(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.04,
              lambda_j=1.0, mu_j=-0.05, sigma_j=0.1, r=0.05, q=0.01)
FIELDS2 = dict(FIELDS, kappa=2.0, v0=0.06, rho=-0.3, q=0.02)
CORR = [[1.0, 0.6], [0.6, 1.0]]
TERMS = [dict(n_obs=4), dict(n_obs=3, autocall_barrier=1.05,
                             coupon_barrier=0.9, protection_barrier=0.6,
                             coupon=0.03, final_coupon=0.05,
                             notional=100.0)]


def _replayed(key, steps, shape):
    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (3, *shape), jnp.float32),
                jax.random.uniform(k_u, shape, jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _note_close(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if k in ("call_prob_by_date", "survival_prob", "loss_prob", "n_obs",
                 "num_paths_used", "n_assets"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-9,
                                       err_msg=k)


def _single(monkeypatch, fields=FIELDS):
    jeng = ja.AutocallableEngine(JSVJ(**fields), num_paths=N,
                                 steps_per_period=SPP, seed=SEED)
    peng = pa.AutocallableEngine(SVJParams(**fields), num_paths=N,
                                 steps_per_period=SPP, seed=SEED,
                                 device="cpu")
    monkeypatch.setattr(peng, "_draws", lambda steps: _replayed(
        jax.random.key(SEED), steps, (N,)))
    return jeng, peng


def _worst(monkeypatch, corr=CORR):
    jeng = ja.WorstOfAutocallableEngine(
        [JSVJ(**FIELDS), JSVJ(**FIELDS2)], corr, num_paths=N,
        steps_per_period=SPP, seed=SEED)
    peng = pa.WorstOfAutocallableEngine(
        [SVJParams(**FIELDS), SVJParams(**FIELDS2)], corr, num_paths=N,
        steps_per_period=SPP, seed=SEED, device="cpu")
    monkeypatch.setattr(peng, "_draws", lambda steps: _replayed(
        jax.random.key(SEED), steps, (2, N)))
    return jeng, peng


@pytest.mark.parametrize("terms", TERMS)
def test_single_asset_note_matches_jax(monkeypatch, terms):
    jeng, peng = _single(monkeypatch)
    _note_close(peng.price(1.0, **terms), jeng.price(1.0, **terms))


@pytest.mark.parametrize("terms", TERMS)
def test_worst_of_note_matches_jax(monkeypatch, terms):
    jeng, peng = _worst(monkeypatch)
    _note_close(peng.price(1.0, **terms), jeng.price(1.0, **terms))


@pytest.mark.parametrize("worst", [False, True])
def test_par_coupon_matches_jax(monkeypatch, worst):
    """Three evaluations on one path set: the coupon, the note's price at
    it (the target) and the sensitivity, as the JAX package solves them."""
    jeng, peng = (_worst if worst else _single)(monkeypatch)
    ref = jeng.solve_par_coupon(1.0, target=0.98, n_obs=4)
    got = peng.solve_par_coupon(1.0, target=0.98, n_obs=4)
    _note_close(got, ref)
    assert got["price_at_par_coupon"] == pytest.approx(0.98, abs=1e-5)


def test_note_path_values_first_crossing():
    """The first crossing is the first date at the barrier (argmax of the
    cast, torch's first maximal index); a note called at date i = 1..m
    pays 1 + i·c discounted from t_i, one never called its terminal leg."""
    ratio = torch.tensor([[[0.9, 1.1, 0.5]], [[1.2, 1.3, 0.5]],
                          [[1.0, 0.8, 0.75]]]).expand(3, 2, 3).contiguous()
    pay, (ever, first, r_t, dts) = pa._note_path_values(
        ratio, 0.75, 0.04, 3, 1.0, 0.8, 0.7, 0.02, 0.06, 1.0)
    ref, ref_aux = ja._note_path_values(jnp.asarray(ratio.numpy()), 0.75,
                                        0.04, 3, 1.0, 0.8, 0.7, 0.02, 0.06,
                                        1.0)
    assert first[0].tolist() == [1, 0, 0]
    assert ever[0].tolist() == [True, True, False]
    np.testing.assert_array_equal(first.numpy(), np.asarray(ref_aux[1]))
    np.testing.assert_allclose(pay.numpy(), np.asarray(ref), rtol=1e-6)
    df = np.exp(-0.04 * np.array([0.25, 0.5, 0.75]))
    np.testing.assert_allclose(pay.numpy(), [df[1] * 1.04, df[0] * 1.02,
                                             df[2] * 1.0], rtol=1e-6)


def test_unreachable_autocall_by_law():
    """The port's generator under GBM, barrier unreachable: within 4 se of
    `no_call_note_bs`, every path survives."""
    eng = pa.AutocallableEngine(gbm_params(0.2, r=0.05, q=0.01),
                                num_paths=4000, steps_per_period=4, seed=1,
                                device="cpu")
    res = eng.price(1.0, n_obs=4, autocall_barrier=50.0)
    cf = pa.no_call_note_bs(1.0, 0.05, 0.01, 0.2, 0.8, 0.7, 0.08)
    assert abs(res["price"] - cf) < 4 * res["std_error"] + 5e-4
    assert res["survival_prob"] == pytest.approx(1.0)


def test_worst_of_refusals_match_jax():
    """Mixed rates, a corr of the wrong shape or not PSD: ValueError with
    the JAX package's message; a mesh, once refused, prices (slice N1): a
    one-shard mesh gives the unsharded note value."""
    bad = [
        (lambda m: [m.SVJParams(**FIELDS), m.SVJParams(**FIELDS2)], [[1]]),
        (lambda m: [m.SVJParams(**FIELDS), m.SVJParams(**dict(FIELDS2,
                                                             r=0.07))],
         CORR),
        (lambda m: [m.SVJParams(**FIELDS), m.SVJParams(**FIELDS2)],
         [[1.0, 2.0], [2.0, 1.0]]),
    ]
    import mcos_tpu.models.params as jm
    import mcos_tpu_torch.models.params as pm

    for plist, corr in bad:
        with pytest.raises(ValueError) as a:
            ja.WorstOfAutocallableEngine(plist(jm), corr, num_paths=N)
        with pytest.raises(ValueError) as b:
            pa.WorstOfAutocallableEngine(plist(pm), corr, num_paths=N,
                                         device="cpu")
        assert str(a.value) == str(b.value)
    from mcos_tpu_torch.parallel.mesh import make_mesh

    kw = dict(num_paths=N, steps_per_period=4, device="cpu")
    ref = pa.WorstOfAutocallableEngine([SVJParams()] * 2, CORR,
                                       **kw).price(1.0)
    got = pa.WorstOfAutocallableEngine([SVJParams()] * 2, CORR,
                                       mesh=make_mesh(["cpu"]),
                                       **kw).price(1.0)
    assert got["price"] == pytest.approx(ref["price"], rel=1e-6)
    assert got["call_prob_by_date"] == pytest.approx(
        ref["call_prob_by_date"], rel=1e-6)


def test_no_feasible_par_coupon_raises_as_jax():
    """A note whose coupon never pays (coupon barrier and autocall barrier
    unreachable) has no par coupon: ValueError in both packages."""
    terms = dict(n_obs=2, autocall_barrier=90.0, coupon_barrier=90.0,
                 protection_barrier=0.7)
    for eng in (ja.AutocallableEngine(JSVJ(**FIELDS), num_paths=1000),
                pa.AutocallableEngine(SVJParams(**FIELDS), num_paths=1000,
                                      device="cpu")):
        with pytest.raises(ValueError, match="no feasible par coupon"):
            eng.solve_par_coupon(0.5, **terms)
