"""The port's desk handlers (`/api/book`, `/api/pnl`, `/api/margin`,
`/api/replicate`, `/api/exposure`, `/api/volderivs`, `/api/modelrisk`)
against the JAX package's handlers on CPU: the same keys, the same values
(on draws replayed from the JAX handler's keys where the route simulates:
the engine the port's handler builds is swapped for one that replays them;
modelrisk's Monte Carlo legs and the VIX Monte Carlo check within 5
combined se across streams), every 400 with the same status, a `corr` that
is not positive definite raising `np.linalg.LinAlgError` in both (500 over
HTTP), and the seven routes over HTTP on `device="cpu"`.

Tolerances as in tests/test_torch_desk.py: pnl and the host legs 1e-10;
the simulated tables and summaries rtol 1e-4 beside small absolute floors
stated at each check; AD Greeks and the CVA delta rtol 1e-3."""

import functools
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
from mcos_tpu_torch.engine import book as pbook
from mcos_tpu_torch.engine import exposure as pexposure
from mcos_tpu_torch.engine import hedge as phedge
from mcos_tpu_torch.engine import margin as pmargin
from mcos_tpu_torch.engine import volderivs as pvol
from mcos_tpu_torch.ops import cuda_kernels

torch.set_num_threads(1)

PARAMS = {"kappa": 2.0, "theta": 0.04, "xi": 0.5, "rho": -0.6, "v0": 0.05,
          "lambda_j": 0.5, "mu_j": -0.05, "sigma_j": 0.1, "r": 0.06,
          "q": 0.0}
N = 1000                       # the schemas' least num_paths
SEED = 42                      # every desk engine's default seed


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_step_draws(key, n, steps):
    def one(t):
        k_norm, k_unif = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_norm, (3, n), jnp.float32),
                jax.random.uniform(k_unif, (n,), jnp.float32))

    return jax.vmap(one)(jnp.arange(steps))


def _step_draws(key, n, steps):
    z, u = _jax_step_draws(key, n, steps)
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        elif isinstance(v, (list, tuple)) and v and not isinstance(v[0],
                                                                   str):
            for i, x in enumerate(v):
                out[f"{name}[{i}]"] = x
        else:
            out[name] = v
    return out


def _compare(got, ref, rtol, atol=1e-9, loose=(), loose_rtol=1e-3,
             skip=("elapsed_ms",)):
    a, b = _flat(got), _flat(ref)
    assert a.keys() == b.keys()
    for k in b:
        if k in skip:
            continue
        if isinstance(b[k], (str, list, bool)) or b[k] is None:
            assert a[k] == b[k], k
        else:
            tol = loose_rtol if any(k.startswith(x) for x in loose) else rtol
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=tol,
                                       atol=atol, err_msg=k)


def _status(handler, body, **kw):
    try:
        handler(dict(body), **kw)
    except (pserver.ApiError, jserver.ApiError) as e:
        return e.status
    return 200


# ── pnl ──────────────────────────────────────────────────────────────────────
PNL = {"strike": 22500.0, "spot_old": 22500.0, "spot_new": 22275.0,
       "T_old": 0.25, "T_new": 0.25 - 1 / 252, "quantity": -2.0,
       "params_old": PARAMS, "params_new": dict(PARAMS, v0=0.052, xi=0.55)}


def test_pnl_handler_equals_jax():
    got = pserver.handle_pnl(dict(PNL), device="cpu")
    ref = jserver.handle_pnl(dict(PNL))
    _compare(got, ref, 0.0, atol=1e-10 * abs(ref["price_old"]))


# ── margin ───────────────────────────────────────────────────────────────────
MARGIN = {"spot": 100.0, "strikes": [95.0, 100.0, 105.0],
          "Ts": [0.05, 0.05, 0.1], "is_calls": [False, True, True],
          "quantities": [-1.0, 2.0, -3.0], "num_paths": N, "params": PARAMS}


class _ReplayMargin(pmargin.MarginEngine):
    """The handler's engine on the torch backend, on the JAX handler's
    draws (key(42) folded with round(T·1e4))."""

    def __init__(self, *a, **k):
        super().__init__(*a, backend="torch", **k)

    def _draws(self, steps, T):
        return _step_draws(jax.random.fold_in(jax.random.key(SEED),
                                              int(round(T * 1e4))),
                           self.num_paths, steps)


def test_margin_handler_equals_jax(monkeypatch):
    ref = jserver.handle_margin(dict(MARGIN))
    monkeypatch.setattr(pserver, "MarginEngine", _ReplayMargin)
    got = pserver.handle_margin(dict(MARGIN), device="cpu")
    _compare(got, ref, 1e-3, atol=1e-4 * MARGIN["spot"])
    monkeypatch.undo()
    k3 = pserver.handle_margin(dict(MARGIN), device="cpu")
    assert k3.keys() == ref.keys()
    assert k3["scenario_labels"] == ref["scenario_labels"]
    bad = dict(MARGIN, quantities=[1.0])
    assert _status(pserver.handle_margin, bad, device="cpu") == 400
    assert _status(jserver.handle_margin, bad) == 400


# ── replicate ────────────────────────────────────────────────────────────────
REPLICATE = {"spot": 100.0, "T": 0.05, "kind": "barrier", "strike": 100.0,
             "barrier": 104.0, "num_paths": N, "params": PARAMS,
             "n_hedge": 7}


class _ReplayHedge(phedge.StaticHedgeEngine):
    def __init__(self, *a, **k):
        super().__init__(*a, backend="torch", **k)
        self.draws = _step_draws(jax.random.key(SEED), self.num_paths,
                                 12)                  # 252 a year × 0.05


def test_replicate_handler_equals_jax(monkeypatch):
    ref = jserver.handle_replicate(dict(REPLICATE))
    monkeypatch.setattr(pserver, "StaticHedgeEngine", _ReplayHedge)
    got = pserver.handle_replicate(dict(REPLICATE), device="cpu")
    # The near-collinear strip's weights are compared through their fitted
    # values in tests/test_torch_desk.py; here only the summaries.
    _compare({k: v for k, v in got.items() if k != "weights"},
             {k: v for k, v in ref.items() if k != "weights"}, 1e-4,
             atol=1e-4)
    assert len(got["weights"]["calls"]) == len(ref["weights"]["calls"])


@pytest.mark.parametrize("bad", [
    {"kind": "digital", "strike": 0.0},
    {"kind": "asian", "strike": 0.0},
    {"kind": "barrier", "barrier": 0.0},
    {"kind": "lookback", "strike": 0.0, "floating": False},
])
def test_replicate_400s(bad):
    body = dict(REPLICATE, **bad)
    assert _status(pserver.handle_replicate, body, device="cpu") == 400
    assert _status(jserver.handle_replicate, body) == 400


# ── volderivs ────────────────────────────────────────────────────────────────
def test_volderivs_handler_equals_jax(monkeypatch):
    body = {"kind": "variance_swap", "T": 0.05, "params": PARAMS,
            "num_paths": N}
    ref = jserver.handle_volderivs(dict(body))
    monkeypatch.setattr(pvol.VolDerivsEngine, "_rv_draws",
                        lambda self, s: _step_draws(jax.random.key(SEED),
                                                    self.num_paths, s))
    _compare(pserver.handle_volderivs(dict(body), device="cpu"), ref, 1e-4)
    body = dict(body, kind="vol_swap")
    _compare(pserver.handle_volderivs(dict(body), device="cpu"),
             jserver.handle_volderivs(dict(body)), 1e-4)
    for kind, extra in (("vix_option", {"strike": 0.2, "is_call": False}),
                        ("vix_future", {"convention":
                                        "quadratic_variation"})):
        body = {"kind": kind, "T": 0.5, "params": PARAMS, **extra}
        _compare(pserver.handle_volderivs(dict(body), device="cpu"),
                 jserver.handle_volderivs(dict(body)), 0.0, atol=1e-10)
    bad = {"kind": "vix_option", "T": 0.5, "params": PARAMS}
    assert _status(pserver.handle_volderivs, bad, device="cpu") == 400
    assert _status(jserver.handle_volderivs, bad) == 400


def test_vix_mc_check_by_law():
    body = {"kind": "vix_future", "T": 0.5, "params": PARAMS,
            "num_paths": 4000, "with_mc_check": True}
    got = pserver.handle_volderivs(dict(body), device="cpu")
    ref = jserver.handle_volderivs(dict(body))
    a, b = got.pop("mc_check"), ref.pop("mc_check")
    assert a.keys() == b.keys()
    assert abs(a["future_mc"] - b["future_mc"]) < 5 * np.hypot(
        a["std_error"], b["std_error"])
    _compare(got, ref, 0.0, atol=1e-10)


# ── book ─────────────────────────────────────────────────────────────────────
BOOK = {"spots": [100.0, 100.0], "strikes": [100.0, 95.0],
        "Ts": [0.1, 0.25], "is_calls": [True, False],
        "quantities": [2.0, -1.0], "num_paths": N, "params": PARAMS}


class _ReplayBook(pbook.BookEngine):
    def _draws(self, generator, first, count):
        zs, us = zip(*(_step_draws(jax.random.fold_in(jax.random.key(SEED),
                                                      i), self.num_paths,
                                   self.num_steps)
                       for i in range(first, first + count)))
        return torch.stack(zs, dim=2), torch.stack(us, dim=1)


def test_book_handler_equals_jax(monkeypatch):
    ref = jserver.handle_book(dict(BOOK))
    monkeypatch.setattr(pserver, "BookEngine", _ReplayBook)
    got = pserver.handle_book(dict(BOOK), device="cpu")
    _compare(got, ref, 1e-4, atol=1e-5,
             loose=("delta", "theta", "vega", "rho", "book_"))
    bad = dict(BOOK, Ts=[0.1])
    assert _status(pserver.handle_book, bad, device="cpu") == 400
    assert _status(jserver.handle_book, bad) == 400


# ── modelrisk ────────────────────────────────────────────────────────────────
def test_modelrisk_handler_against_jax():
    body = {"spot": 100.0, "strike": 100.0, "T": 0.25, "num_paths": 4096,
            "params": dict(PARAMS, v0=0.04)}
    got = pserver.handle_modelrisk(dict(body), device="cpu")
    ref = jserver.handle_modelrisk(dict(body))
    assert got.keys() == ref.keys()
    for block in ("prices", "implied_vols", "mc_std_errors"):
        assert got[block].keys() == ref[block].keys()
    for k in ("heston", "svj", "vg"):
        assert got["prices"][k] == pytest.approx(ref["prices"][k], rel=0,
                                                 abs=1e-10)
    assert got["prices"]["bs"] == pytest.approx(
        ref["prices"]["bs"], abs=4 * np.finfo(np.float32).eps * 100.0)
    for k in ("rough", "hhw"):
        assert abs(got["prices"][k] - ref["prices"][k]) < 5 * np.hypot(
            got["mc_std_errors"][k], ref["mc_std_errors"][k]), k


# ── exposure ─────────────────────────────────────────────────────────────────
EXPOSURE = {"spots": [100.0, 50.0], "sigmas": [0.25, 0.35],
            "corr": [[1.0, 0.4], [0.4, 1.0]],
            "positions": [{"kind": "call", "strike": 100.0, "T": 0.5},
                          {"kind": "put", "strike": 50.0, "T": 0.25,
                           "qty": -2.0, "asset": 1}],
            "r": 0.05, "num_paths": N, "num_dates": 6, "own_hazard": 0.01,
            "with_cva_delta": True, "collateral_threshold": 1.0,
            "wwr_gamma": 2.0}


class _ReplayExposure(pexposure.ExposureEngine):
    def _date_normals(self):
        key = jax.random.key(SEED)
        shape = (self.num_paths, self.spots.shape[0])
        return lambda i: torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key, i), shape, jnp.float32)))


def test_exposure_handler_equals_jax(monkeypatch):
    ref = jserver.handle_exposure(dict(EXPOSURE))
    monkeypatch.setattr(pserver, "ExposureEngine", _ReplayExposure)
    got = pserver.handle_exposure(dict(EXPOSURE), device="cpu")
    _compare(got, ref, 1e-4, atol=1e-5, loose=("cva_delta",))


@pytest.mark.parametrize("bad", [
    {"positions": []},
    {"sigmas": [0.25]},
    {"corr": [[1.0, 0.0]]},
])
def test_exposure_400s(bad):
    body = dict(EXPOSURE, **bad)
    assert _status(pserver.handle_exposure, body, device="cpu") == 400
    assert _status(jserver.handle_exposure, body) == 400


def test_reference_500s_kept():
    """Bodies the schemas let through and both packages refuse with an
    exception their transports answer 500: a negative maturity in a margin
    book (fold_in's uint32 word), an exposure position of unknown kind."""
    bad = dict(MARGIN, Ts=[0.05, -0.1, 0.1])
    with pytest.raises(OverflowError):
        jserver.handle_margin(dict(bad))
    with pytest.raises(OverflowError):
        pserver.handle_margin(dict(bad), device="cpu")
    bad = dict(EXPOSURE, positions=[{"kind": "straddle", "strike": 100.0,
                                     "T": 0.5}])
    with pytest.raises(KeyError):
        jserver.handle_exposure(dict(bad))
    with pytest.raises(KeyError):
        pserver.handle_exposure(dict(bad), device="cpu")


def test_exposure_corr_not_positive_definite_raises_in_both():
    """The JAX handler lets `np.linalg.cholesky`'s error through (its
    transport answers 500); the port's handler does the same."""
    body = dict(EXPOSURE, corr=[[1.0, 1.2], [1.2, 1.0]])
    with pytest.raises(np.linalg.LinAlgError):
        jserver.handle_exposure(dict(body))
    with pytest.raises(np.linalg.LinAlgError):
        pserver.handle_exposure(dict(body), device="cpu")


# ── routing and kernels ──────────────────────────────────────────────────────
def test_desk_routes_and_kernel_launches(monkeypatch):
    """32 POST routes (the reference's); on the CPU the desk's cuda
    backends run the plain versions of K3 (3 a maturity group), K6 (1 a
    replicate), K4 (1 a VIX check) and K7 (1 a modelrisk), and no wrapper
    counts a launch."""
    desk = ("/api/book", "/api/pnl", "/api/margin", "/api/replicate",
            "/api/exposure", "/api/volderivs", "/api/modelrisk")
    assert len(pserver._POST_ROUTES) == 32
    for route in desk:
        assert pserver._POST_ROUTES[route] is getattr(
            pserver, "handle_" + route.rsplit("/", 1)[1])
    calls = {}
    for name in ("svj_terminal", "svj_path_stats", "svj_terminal_qe",
                 "hhw_terminal", "svj_terminal_from_draws", "gbm_terminal",
                 "svcj_terminal", "svj_terminal_td"):
        calls[name] = 0

        def count(*a, _plain=getattr(cuda_kernels, name + "_plain"),
                  _name=name, **k):
            calls[_name] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(cuda_kernels, name + "_plain", count)
    cuda_kernels.reset_launch_counts()
    pserver.handle_margin(dict(MARGIN), device="cpu")      # two maturities
    pserver.handle_replicate(dict(REPLICATE), device="cpu")
    pserver.handle_volderivs({"kind": "vix_future", "T": 0.5,
                              "params": PARAMS, "num_paths": N,
                              "with_mc_check": True}, device="cpu")
    pserver.handle_volderivs({"kind": "variance_swap", "T": 0.05,
                              "num_paths": N}, device="cpu")
    pserver.handle_modelrisk({"spot": 100.0, "strike": 100.0, "T": 0.1,
                              "num_paths": N}, device="cpu")
    pserver.handle_book(dict(BOOK), device="cpu")
    pserver.handle_pnl(dict(PNL), device="cpu")
    pserver.handle_exposure(dict(EXPOSURE, with_cva_delta=False),
                            device="cpu")
    assert calls == {"svj_terminal": 6, "svj_path_stats": 1,
                     "svj_terminal_qe": 1, "hhw_terminal": 1,
                     "svj_terminal_from_draws": 0, "gbm_terminal": 0,
                     "svcj_terminal": 0, "svj_terminal_td": 0}
    assert all(n == 0 for n in cuda_kernels.launch_counts().values())


def test_desk_routes_over_http():
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
        for path, body in (
                ("/api/pnl", PNL), ("/api/margin", MARGIN),
                ("/api/replicate", REPLICATE), ("/api/book", BOOK),
                ("/api/exposure", EXPOSURE),
                ("/api/volderivs", {"kind": "vix_future", "T": 0.5,
                                    "num_paths": N, "with_mc_check": True}),
                ("/api/modelrisk", {"spot": 100.0, "strike": 95.0,
                                    "T": 0.1, "num_paths": N})):
            status, res = call(path, body)
            assert status == 200, (path, res)
            assert np.isfinite(res["elapsed_ms"])
        assert call("/api/margin", dict(MARGIN, Ts=[0.1]))[0] == 400
        assert call("/api/replicate", dict(REPLICATE, barrier=0.0))[0] == 400
        assert call("/api/book", dict(BOOK, spots=[1.0]))[0] == 400
        assert call("/api/exposure", dict(EXPOSURE, positions=[]))[0] == 400
        assert call("/api/volderivs", {"kind": "vix_option",
                                       "T": 0.5})[0] == 400
        assert call("/api/exposure", dict(
            EXPOSURE, corr=[[1.0, 1.2], [1.2, 1.0]]))[0] == 500
        assert call("/api/pnl", dict(PNL, strike=-1.0))[0] == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
