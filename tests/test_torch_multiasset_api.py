"""The port's multi-asset and path-product handlers (`/api/basket`,
`/api/cliquet`, `/api/quanto`, `/api/autocall`) against the JAX package's
handlers on CPU: the same keys and values on draws replayed from the JAX
handlers' keys (the engine the port's handler builds is swapped for one
that replays them), every 400 with the same status and detail, the bodies
both packages let through to an exception (500 over HTTP), no kernel on
the path, and the four routes over HTTP on `device="cpu"`.

Tolerances as in the engines' tests: prices, standard errors and every
other float rtol 1e-5 (the redemption probabilities 1e-6); the in-sample
Bermudan within half a standard error (its float32 regressions flip
exercise decisions, tests/test_torch_basket_american.py)."""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcos_tpu.api.server as jserver
import mcos_tpu_torch.api.server as pserver
from mcos_tpu_torch.engine import autocallable as pauto
from mcos_tpu_torch.engine import basket as pbasket
from mcos_tpu_torch.engine import cliquet as pcliquet
from mcos_tpu_torch.engine import quanto as pquanto
from mcos_tpu_torch.ops import cuda_kernels

torch.set_num_threads(1)

N = 1000                       # the schemas' least num_paths
PARAMS = {"kappa": 2.0, "theta": 0.05, "xi": 0.5, "rho": -0.6, "v0": 0.045,
          "lambda_j": 1.0, "mu_j": -0.05, "sigma_j": 0.1, "r": 0.05,
          "q": 0.01}
PARAMS2 = dict(PARAMS, kappa=3.0, v0=0.06, rho=-0.3, q=0.02)
BASKET = {"spots": [100.0, 95.0], "weights": [0.5, 0.5], "strike": 100.0,
          "T": 0.25, "corr": [[1.0, 0.4], [0.4, 1.0]],
          "params": [PARAMS, PARAMS2], "num_paths": N}
CLIQUET = {"T": 1.0, "params": PARAMS, "num_paths": N,
           "steps_per_period": 4}
QUANTO = {"spot": 100.0, "strike": 100.0, "T": 0.5, "params": PARAMS,
          "num_paths": N, "num_steps": 16}
AUTOCALL = {"T": 1.0, "params": PARAMS, "num_paths": N,
            "steps_per_period": 4}
WORST = dict(AUTOCALL, params_list=[PARAMS, PARAMS2],
             corr=[[1.0, 0.6], [0.6, 1.0]])


def _replayed(seed, steps, shape):
    """The JAX engines' step draws on key(seed)."""
    key = jax.random.key(seed)

    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (3, *shape), jnp.float32),
                jax.random.uniform(k_u, shape, jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


class _ReplayBasket(pbasket.BasketEngine):
    def _draws(self, k, steps):
        return _replayed(self.seed, steps,
                         (len(self.params_list), self.num_paths))


class _ReplayCliquet(pcliquet.CliquetEngine):
    def _draws(self, steps):
        return _replayed(self.seed, steps, (self.num_paths,))


class _ReplayQuanto(pquanto.QuantoEngine):
    def _draws(self, steps):
        return _replayed(self.seed, steps, (self.num_paths,))


class _ReplayNote(pauto.AutocallableEngine):
    def _draws(self, steps):
        return _replayed(self.seed, steps, (self.num_paths,))


class _ReplayWorst(pauto.WorstOfAutocallableEngine):
    def _draws(self, steps):
        return _replayed(self.seed, steps, (self.n_assets, self.num_paths))


@pytest.fixture
def replay(monkeypatch):
    for name, cls in (("BasketEngine", _ReplayBasket),
                      ("CliquetEngine", _ReplayCliquet),
                      ("QuantoEngine", _ReplayQuanto),
                      ("AutocallableEngine", _ReplayNote),
                      ("WorstOfAutocallableEngine", _ReplayWorst)):
        monkeypatch.setattr(pserver, name, cls)


def _compare(got, ref, rtol=1e-5):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if k == "elapsed_ms":
            continue
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            tol = 1e-6 if k in ("call_prob_by_date", "survival_prob",
                                "loss_prob") else rtol
            np.testing.assert_allclose(got[k], v, rtol=tol, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("route,body", [
    ("basket", BASKET),
    ("basket", dict(BASKET, payoff="worst_of", is_call=False)),
    ("basket", dict(BASKET, payoff="best_of")),
    ("basket", dict(BASKET, payoff="spread", strike=0.0)),
    ("cliquet", CLIQUET),
    ("cliquet", dict(CLIQUET, kind="forward_start", t1=0.4, k=0.95)),
    ("quanto", QUANTO),
    ("quanto", dict(QUANTO, is_call=False, fx_fixed=0.8, rho_fx=0.4)),
    ("autocall", AUTOCALL),
    ("autocall", dict(AUTOCALL, solve_par=True, par_target=0.99)),
    ("autocall", WORST),
    ("autocall", dict(WORST, solve_par=True)),
])
def test_handler_equals_jax(replay, route, body):
    ref = getattr(jserver, f"handle_{route}")(dict(body))
    got = getattr(pserver, f"handle_{route}")(dict(body), device="cpu")
    if route == "quanto":
        # A difference of two float32 Black-Scholes prices
        # (tests/test_torch_cliquet_quanto.py): atol 2e-6 × the spot.
        np.testing.assert_allclose(got.pop("quanto_adjustment_bs"),
                                   ref.pop("quanto_adjustment_bs"), rtol=0,
                                   atol=2e-6 * body["spot"])
    _compare(got, ref)


def test_bermudan_handler_against_jax(replay):
    """The in-sample Bermudan on the JAX handler's key: the same keys, the
    price within half a standard error; with bounds, the bracket's keys."""
    body = dict(BASKET, payoff="best_of", american=True, n_exercise=3,
                steps_per_period=2, T=0.5)
    ref = jserver.handle_basket(dict(body))
    got = pserver.handle_basket(dict(body), device="cpu")
    assert got.keys() == ref.keys()
    assert abs(got["price"] - ref["price"]) < 0.5 * ref["std_error"]
    body = dict(body, with_bounds=True, n_outer=128, n_inner=16)
    ref = jserver.handle_basket(dict(body))
    got = pserver.handle_basket(dict(body), device="cpu")
    assert got["bounds"].keys() == ref["bounds"].keys()
    b = got["bounds"]
    assert b["lower_bound"] <= b["upper_bound"] + 3 * np.hypot(
        b["lower_se"], b["upper_se"])


def _detail(handler, body, **kw):
    try:
        handler(dict(body), **kw)
    except (pserver.ApiError, jserver.ApiError) as e:
        return e.status, e.detail
    return 200, None


_SEVENTEEN = [PARAMS] * 17


@pytest.mark.parametrize("route,bad", [
    ("basket", {"corr": [[1.0, 0.4], [0.4, 1.0], [0.0, 0.0]]}),
    ("basket", {"weights": [1.0]}),
    ("basket", {"payoff": "spread", "spots": [100.0, 95.0, 90.0],
                "corr": np.eye(3).tolist(), "params": []}),
    ("basket", {"params": [PARAMS]}),
    ("basket", {"payoff": "worst_of", "implied_corr_from_price": 3.0}),
    ("basket", {"payoff": "spread", "american": True}),
    ("basket", {"american": True, "spots": [100.0], "corr": [[1.0]],
                "weights": [1.0], "params": []}),
    ("basket", {"payoff": "rainbow"}),
    ("cliquet", {"kind": "forward_start", "t1": 1.0}),
    ("cliquet", {"kind": "forward_start", "t1": 0.0}),
    ("cliquet", {"kind": "ratchet"}),
    ("autocall", {"coupon_barrier": 1.2}),
    ("autocall", {"protection_barrier": 0.9}),
    ("autocall", {"params_list": [PARAMS, PARAMS2]}),
    ("autocall", {"params_list": [PARAMS, PARAMS2], "corr": [[1.0]]}),
    ("autocall", {"params_list": _SEVENTEEN,
                  "corr": np.eye(17).tolist()}),
])
def test_400s_match_jax(route, bad):
    body = dict({"basket": BASKET, "cliquet": CLIQUET,
                 "autocall": AUTOCALL}[route], **bad)
    got = _detail(getattr(pserver, f"handle_{route}"), body, device="cpu")
    ref = _detail(getattr(jserver, f"handle_{route}"), body)
    assert got == ref and got[0] == 400, (got, ref)


def test_unattainable_implied_correlation_answers_400_in_both():
    """The bisection's range check: 400 in both packages; the detail
    names the attainable range, which each package's own paths set."""
    body = dict(BASKET, implied_corr_from_price=50.0)
    got = _detail(pserver.handle_basket, body, device="cpu")
    ref = _detail(jserver.handle_basket, body)
    assert got[0] == ref[0] == 400
    assert got[1].startswith("market price 50.0000 outside the attainable")
    assert ref[1].startswith("market price 50.0000 outside the attainable")


@pytest.mark.parametrize("route,bad,exc", [
    ("basket", {"corr": [[1.0, 1.2], [1.2, 1.0]]}, ValueError),
    ("basket", {"corr": [[1.0, 0.4], [0.4]]}, ValueError),
    ("basket", {"spots": [100.0], "weights": [1.0], "corr": [[1.0]],
                "params": [], "implied_corr_from_price": 5.0},
     ZeroDivisionError),
    ("autocall", dict(WORST, params_list=[PARAMS, dict(PARAMS2, r=0.07)]),
     ValueError),
    ("autocall", dict(WORST, corr=[[1.0, 1.5], [1.5, 1.0]]), ValueError),
    ("autocall", {"solve_par": True, "autocall_barrier": 90.0,
                  "coupon_barrier": 90.0, "n_obs": 2}, ValueError),
])
def test_reference_500s_kept(route, bad, exc):
    """Bodies the schemas and the handlers' checks let through, which both
    packages refuse with the same exception (their transports answer 500):
    a basket `corr` that is not PSD or has rows of the wrong length, the
    implied correlation of one asset (−1/(A−1)), a worst-of book with
    mixed rates or a `corr` that is not PSD, a par coupon the note cannot
    reach."""
    body = dict({"basket": BASKET, "autocall": AUTOCALL}[route], **bad)
    with pytest.raises(exc) as a:
        getattr(jserver, f"handle_{route}")(dict(body))
    with pytest.raises(exc) as b:
        getattr(pserver, f"handle_{route}")(dict(body), device="cpu")
    assert str(a.value) == str(b.value)


def test_routes_run_no_kernel(monkeypatch):
    """32 POST routes (the reference's); the four run torch step loops
    only: no kernel's plain version is called on the CPU, no wrapper counts
    a launch."""
    assert len(pserver._POST_ROUTES) == 32
    for route in ("basket", "cliquet", "quanto", "autocall"):
        assert pserver._POST_ROUTES[f"/api/{route}"] is getattr(
            pserver, f"handle_{route}")
    calls = []
    for name in dir(cuda_kernels):
        if name.endswith("_plain"):
            monkeypatch.setattr(cuda_kernels, name,
                                lambda *a, _n=name, **k: calls.append(_n))
    cuda_kernels.reset_launch_counts()
    for route, body in (("basket", BASKET), ("cliquet", CLIQUET),
                        ("quanto", QUANTO), ("autocall", WORST)):
        getattr(pserver, f"handle_{route}")(dict(body), device="cpu")
    pserver.handle_basket(dict(BASKET, american=True, payoff="best_of",
                               n_exercise=2, steps_per_period=1,
                               with_bounds=True, n_outer=128, n_inner=16),
                          device="cpu")
    assert calls == []
    assert all(n == 0 for n in cuda_kernels.launch_counts().values())


def test_multiasset_routes_over_http():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), pserver._Handler)
    httpd.device = torch.device("cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        for path, body, key in (("/api/basket", BASKET, "price"),
                                ("/api/cliquet", CLIQUET, "price"),
                                ("/api/quanto", QUANTO, "price"),
                                ("/api/autocall", WORST, "price")):
            status, res = call(path, body)
            assert status == 200, (path, res)
            assert np.isfinite(res[key]) and np.isfinite(res["elapsed_ms"])
        assert call("/api/basket", dict(BASKET, weights=[1.0]))[0] == 400
        assert call("/api/cliquet", dict(CLIQUET, kind="x"))[0] == 400
        assert call("/api/autocall", dict(AUTOCALL,
                                          coupon_barrier=2.0))[0] == 400
        assert call("/api/basket", dict(
            BASKET, corr=[[1.0, 1.2], [1.2, 1.0]]))[0] == 500
        assert call("/api/quanto", dict(QUANTO, spot=-1.0))[0] == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
