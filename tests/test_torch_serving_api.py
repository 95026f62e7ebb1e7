"""Slices L and M of the port over its handlers and transport, on the CPU:
`/api/roughheston` in every mode against the JAX handler (the Monte Carlo
modes on the JAX key's normals replayed), its 400s; the GET routes
(`/api/metrics`, `/api/quote`, `/api/symbols`), the static UI and its
traversal guard over HTTP; the client; the calibration checkpoints (a
directory the port saves loads in the JAX package and back); the timing
harness; the CLI; the serverless entry and the fastapi app."""

import importlib
import io
import json
import os
import threading
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from urllib.parse import urlparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.api import client as jclient
from mcos_tpu.api import quotes as jquotes
from mcos_tpu.api import server as jserver
from mcos_tpu.engine import roughheston as jeng
from mcos_tpu.utils import checkpoint as jckpt
from mcos_tpu_torch import cli
from mcos_tpu_torch.api import client as pclient
from mcos_tpu_torch.api import quotes as pquotes
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.engine import roughheston as peng
from mcos_tpu_torch.engine.pricer import MonteCarloEngine
from mcos_tpu_torch.engine.rough import RoughBergomiEngine
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels
from mcos_tpu_torch.ops.rough import RoughBergomiParams
from mcos_tpu_torch.ops.roughheston import (RoughHestonParams,
                                            rough_heston_cos_price)
from mcos_tpu_torch.utils import checkpoint as pckpt
from mcos_tpu_torch.utils import timing

torch.set_num_threads(1)

S, T = 22500.0, 0.25
_RH = {"spot": S, "T": T, "num_paths": 1000, "num_steps": 64,
       "n_factors": 8}
_REAL_URLOPEN = urllib.request.urlopen


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Any urlopen to a host other than this machine's loopback fails at
    once (the quote service then answers from its static universe)."""
    def guarded(req, *args, **kwargs):
        url = req.full_url if isinstance(req, urllib.request.Request) \
            else req
        if urlparse(url).hostname not in ("127.0.0.1", "localhost"):
            raise urllib.error.URLError("offline")
        return _REAL_URLOPEN(req, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", guarded)


# ─────────────────────────────────────────────────────────────────────────────
# /api/roughheston against the JAX handler
# ─────────────────────────────────────────────────────────────────────────────
@pytest.fixture
def replay(monkeypatch):
    """The port's engines replay the normals of jax.random.key(seed), the
    key every Monte Carlo figure of the JAX engine draws from."""
    def draws(self, steps):
        key = jax.random.key(self.seed)
        z = jax.vmap(lambda t: jax.random.normal(
            jax.random.fold_in(key, t), (2, self.num_paths),
            jnp.float32))(jnp.arange(steps))
        return torch.from_numpy(np.array(z))

    monkeypatch.setattr(peng.RoughHestonEngine, "_draws", draws)


def _both(body):
    return (pserver.handle_roughheston(dict(body), device="cpu"),
            jserver.handle_roughheston(dict(body)))


def _close(got, ref, rtol, what=""):
    np.testing.assert_allclose(got, ref, rtol=rtol, err_msg=what)


def test_roughheston_price_and_compare_match_jax(replay):
    """price (strike 0 → ATM) and compare (the five default moneyness
    strikes) on the same normals, at the float32 floor of 512 steps
    (tests/test_torch_roughheston.py): prices rtol 1e-4, standard errors
    5e-4."""
    got, ref = _both(_RH)
    assert got.keys() == ref.keys()
    _close(got["price"], ref["price"], 1e-4, "price")
    _close(got["std_error"], ref["std_error"], 5e-4, "std_error")
    for k in ("num_paths_used", "num_steps", "n_factors", "bs_ref"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
    got, ref = _both(dict(_RH, mode="compare", is_call=False))
    assert got.keys() == ref.keys()
    assert [r["strike"] for r in got["rows"]] == \
        [r["strike"] for r in ref["rows"]] == [m * S for m in
                                               (0.9, 0.95, 1.0, 1.05, 1.1)]
    for a, b in zip(got["rows"], ref["rows"]):
        assert a["cos_price"] == b["cos_price"]
        _close(a["mc_price"], b["mc_price"], 1e-4)


def test_roughheston_greeks_match_jax(replay):
    """The price and the AD delta on the same normals; the FD
    sensitivities (pinned member by member in
    tests/test_torch_roughheston.py) within 5 % of the JAX handler's."""
    got, ref = _both(dict(_RH, mode="greeks", strike=22000.0))
    assert got.keys() == ref.keys() >= {"delta", "vega", "dP_dv0",
                                        "dP_dnu", "dP_drho",
                                        "elapsed_ms"}
    _close(got["price"], ref["price"], 1e-4, "price")
    _close(got["delta"], ref["delta"], 1e-5, "delta")
    for k in ("vega", "dP_dv0", "dP_dnu", "dP_drho"):
        _close(got[k], ref[k], 0.05, k)


def test_roughheston_host_modes_equal_jax(monkeypatch):
    """smile (explicit strikes), skew (default and given maturities) and
    calibrate (COS prices made from known parameters; both packages' fits
    at a reduced COS grid, 96 terms and 64 Adams steps) are host float64:
    equal to the JAX handler's."""
    import functools

    for mod in (pserver, jeng):
        monkeypatch.setattr(mod, "calibrate_rough_heston", functools.partial(
            mod.calibrate_rough_heston, n_terms=96, n_adams=64))
    body = dict(_RH, mode="smile", strikes=[0.9 * S, S, 1.1 * S])
    got, ref = _both(body)
    for k in ("strikes", "prices", "iv"):
        _close(got[k], ref[k], 1e-12, k)
    assert got["iv"][0] > got["iv"][2]
    got, ref = _both(dict(_RH, mode="skew", maturities=[0.05, 0.25]))
    assert got["hurst"] == ref["hurst"] and len(got["rows"]) == 2
    for a, b in zip(got["rows"], ref["rows"]):
        assert a["T"] == b["T"]
        _close(a["atm_skew"], b["atm_skew"], 1e-10)
    strikes = [0.94 * S, S, 1.06 * S]
    market = rough_heston_cos_price(
        RoughHestonParams(nu=0.3, rho=-0.6, v0=0.05, theta=0.05),
        S, strikes, T, True, n_terms=96, n_steps=64).tolist()
    got, ref = _both(dict(_RH, mode="calibrate", strikes=strikes,
                          market_prices=market))
    assert got.keys() == ref.keys()
    for k in ("hurst", "nu", "rho", "v0", "lam", "theta", "rmse_price"):
        _close(got[k], ref[k], 1e-9, k)
    assert got["n_quotes"] == 3 and got["rmse_price"] < 0.5


def test_roughheston_smile_default_strikes_and_skew_default_grid():
    got, ref = _both(dict(_RH, mode="smile"))
    assert got["strikes"] == ref["strikes"] == [m * S for m in
                                                (0.9, 0.95, 1.0, 1.05, 1.1)]
    got = pserver.handle_roughheston(dict(_RH, mode="skew"), device="cpu")
    assert [r["T"] for r in got["rows"]] == [0.02, 0.05, 0.1, 0.25, 0.5,
                                             1.0]


@pytest.mark.parametrize("body", [
    {"mode": "nope"},
    {"mode": "calibrate"},
    {"mode": "calibrate", "strikes": [S]},
    {"mode": "calibrate", "market_prices": [100.0]},
    {"mode": "calibrate", "strikes": [S, 1.05 * S],
     "market_prices": [100.0]},
])
def test_roughheston_400s_match_jax(body):
    with pytest.raises(pserver.ApiError) as got:
        pserver.handle_roughheston(dict(_RH, **body), device="cpu")
    with pytest.raises(jserver.ApiError) as ref:
        jserver.handle_roughheston(dict(_RH, **body))
    assert got.value.status == ref.value.status == 400
    assert got.value.detail == ref.value.detail


def test_roughheston_failed_fit_answers_400_as_jax(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("rough-Heston calibration failed on every start")

    monkeypatch.setattr(pserver, "calibrate_rough_heston", fail)
    monkeypatch.setattr(jeng, "calibrate_rough_heston", fail)
    body = dict(_RH, mode="calibrate", strikes=[S], market_prices=[400.0])
    with pytest.raises(pserver.ApiError) as got:
        pserver.handle_roughheston(dict(body), device="cpu")
    with pytest.raises(jserver.ApiError) as ref:
        jserver.handle_roughheston(dict(body))
    assert (got.value.status, got.value.detail) == \
        (ref.value.status, ref.value.detail) == \
        (400, "rough-Heston calibration failed on every start")


def test_roughheston_validation_matches_jax():
    from pydantic import ValidationError

    for bad in ({"hurst": 0.6}, {"rho": -1.0}, {"num_steps": 4},
                {"n_factors": 65}):
        with pytest.raises(ValidationError):
            pserver.handle_roughheston(dict(_RH, **bad), device="cpu")
        with pytest.raises(ValidationError):
            jserver.handle_roughheston(dict(_RH, **bad))


def test_roughheston_launches_no_kernel():
    before = cuda_kernels.launch_counts()
    pserver.handle_roughheston(dict(_RH, num_steps=8), device="cpu")
    assert cuda_kernels.launch_counts() == before


# ─────────────────────────────────────────────────────────────────────────────
# The transport: GET routes, static UI, metrics, the client
# ─────────────────────────────────────────────────────────────────────────────
@pytest.fixture(scope="module")
def base():
    real_warm = pserver.warm
    pserver.warm = lambda device: None
    try:
        httpd = pserver.serve("127.0.0.1", 0, device="cpu")
    finally:
        pserver.warm = real_warm
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_get_routes(base):
    status, _, body = _get(base, "/api/health")
    assert status == 200 and json.loads(body)["status"] == "healthy"
    status, _, body = _get(base, "/api/quote?symbol=NIFTY")
    quote = json.loads(body)
    assert status == 200 and quote["source"] == "CACHED"
    assert quote == jquotes.fetch_quote("NIFTY")
    assert quote["price"] == pquotes.get_fallback_price("NIFTY") == 22500.0
    assert _get(base, "/api/quote")[0] == 400
    assert _get(base, "/api/quote?symbol=NOSUCH")[0] == 503
    status, _, body = _get(base, "/api/symbols?q=bank")
    rows = json.loads(body)["symbols"]
    assert status == 200 and rows == jserver.handle_symbols({"q": ["bank"]})[
        "symbols"]
    assert {"HDFCBANK", "ICICIBANK", "AXISBANK"} <= {r["symbol"]
                                                     for r in rows}
    status, _, body = _get(base, "/api/symbols")
    assert status == 200 and len(json.loads(body)["symbols"]) == 51
    assert _get(base, "/api/nosuchroute")[0] == 404


_CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
         "Access-Control-Allow-Headers")


def _raw(url, method, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.headers


def test_cors_preflight_and_headers_match_jax(base):
    """A browser's preflight OPTIONS /api/price answers 204 with the JAX
    handler's three Access-Control-* headers, and POST answers carry the
    same three (the JAX server answers these without pricing)."""
    jhttpd = jserver.serve("127.0.0.1", 0)
    thread = threading.Thread(target=jhttpd.serve_forever, daemon=True)
    thread.start()
    jbase = f"http://127.0.0.1:{jhttpd.server_address[1]}"
    try:
        preflight = {"Origin": "http://elsewhere.example",
                     "Access-Control-Request-Method": "POST",
                     "Access-Control-Request-Headers": "content-type"}
        got = _raw(base + "/api/price", "OPTIONS", headers=preflight)
        ref = _raw(jbase + "/api/price", "OPTIONS", headers=preflight)
        assert got[0] == ref[0] == 204
        assert [got[1][k] for k in _CORS] == [ref[1][k] for k in _CORS] \
            == ["*", "*", "*"]
        for path, body in (("/api/price", b'{"spot": -1}'),
                           ("/api/nosuchroute", b"{}")):
            got = _raw(base + path, "POST", body,
                       {"Content-Type": "application/json"})
            ref = _raw(jbase + path, "POST", body,
                       {"Content-Type": "application/json"})
            assert got[0] == ref[0] and got[0] in (404, 422), path
            assert [got[1][k] for k in _CORS] == [ref[1][k] for k in _CORS]
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_static_ui_and_traversal_guard(base):
    with open(os.path.join(pserver.WEB_DIR, "index.html"), "rb") as f:
        index = f.read()
    for path in ("/", "/index.html", "/advanced"):
        status, mime, body = _get(base, path)
        assert status == 200 and mime == "text/html" and body == index
    status, mime, body = _get(base, "/static/app.js")
    assert status == 200 and mime == "application/javascript"
    assert len(body) == os.path.getsize(os.path.join(pserver.WEB_DIR,
                                                      "app.js"))
    assert _get(base, "/static/style.css")[1] == "text/css"
    for path in ("/static/../README.md", "/static/../../etc/passwd",
                 "/static/nosuch.js", "/static/"):
        assert _get(base, path)[0] == 404, path


def test_static_file_keeps_sibling_directories_out(tmp_path, monkeypatch):
    web = tmp_path / "web"
    web.mkdir()
    (web / "a.css").write_text("body {}")
    (tmp_path / "webapp").mkdir()
    (tmp_path / "webapp" / "b.js").write_text("x")
    monkeypatch.setattr(pserver, "WEB_DIR", str(web))
    assert pserver._static_file("a.css") == (b"body {}", "text/css")
    assert pserver._static_file("../webapp/b.js") is None
    assert pserver._static_file("../web/a.css") is not None
    assert pserver._static_file("") is None


def test_metrics_count_the_requests_made(base):
    snap0 = json.loads(_get(base, "/api/metrics")[2])
    assert snap0.keys() == {"uptime_s", "endpoints", "coalescer", "counters",
                            "spans"}
    body = dict(_RH, mode="smile", strikes=[S])
    for _ in range(2):
        assert _post(base, "/api/roughheston", body)[0] == 200
    assert _post(base, "/api/roughheston", dict(body, mode="nope"))[0] == 400
    assert _post(base, "/api/roughheston", dict(body, hurst=0.7))[0] == 422
    after = json.loads(_get(base, "/api/metrics")[2])["endpoints"]
    before = snap0["endpoints"].get("/api/roughheston",
                                    {"count": 0, "errors": 0})
    now = after["/api/roughheston"]
    assert now["count"] - before["count"] == 4
    assert now["errors"] - before["errors"] == 2
    assert now.keys() == {"count", "errors", "max_ms", "p50_ms", "p95_ms",
                          "p99_ms"}
    assert now["max_ms"] >= now["p99_ms"] >= now["p95_ms"] >= \
        now["p50_ms"] > 0
    assert json.loads(_get(base, "/api/metrics")[2])["coalescer"] == \
        {"window_ms": pserver.coalesce.coalescer.window_s * 1000,
         "batches_run": pserver.coalesce.coalescer.batches_run,
         "requests_coalesced":
             pserver.coalesce.coalescer.requests_coalesced}


def test_client_against_the_port_server(base):
    c = pclient.McosClient(base)
    assert c.health()["status"] == "healthy"
    assert "endpoints" in c.metrics()
    assert c.quote("RELIANCE")["source"] == "CACHED"
    assert any("BANK" in s["symbol"] for s in c.symbols("bank")["symbols"])
    res = c.roughheston(spot=S, T=T, mode="smile", strikes=[S])
    assert len(res["iv"]) == 1 and res["iv"][0] > 0
    res = c.price(spot=S, strike=S, T=0.05, num_paths=2048, num_steps=8)
    assert res["price"] > 0 and res["post_checks"]["pass"]
    with pytest.raises(pclient.ApiClientError) as e:
        c.roughheston(spot=S, T=T, mode="nope")
    assert e.value.status == 400 and "unknown mode" in e.value.detail
    with pytest.raises(pclient.ApiClientError) as e:
        c.price(spot=S, strike=S)              # missing T → 422
    assert e.value.status == 422


def test_client_covers_every_route():
    """One client method per POST route of the port's server, the same
    methods as the JAX package's client; the port serves the JAX
    server's routes."""
    assert set(pserver._POST_ROUTES) == set(jserver.POST_ROUTES)
    for route in pserver._POST_ROUTES:
        assert callable(getattr(pclient.McosClient,
                                route.rsplit("/", 1)[-1], None)), route

    def methods(cls):
        return {n for n in vars(cls) if not n.startswith("_")}
    assert methods(pclient.McosClient) == methods(jclient.McosClient)


def test_quotes_offline_equal_jax():
    assert pquotes.fetch_live_quote("TCS") is None
    for sym in ("NIFTY", "tcs", "BAJAJ-AUTO", "NOSUCH"):
        assert pquotes.fetch_quote(sym) == jquotes.fetch_quote(sym)
        assert pquotes.get_stock_by_symbol(sym) == \
            jquotes.get_stock_by_symbol(sym)
        assert pquotes.get_fallback_price(sym) == \
            jquotes.get_fallback_price(sym)
    assert pquotes.list_symbols() == jquotes.list_symbols()
    closes = [100.0, 101.0, None, 99.5, 102.0, 0.0, 103.2]
    assert pquotes.realized_vol_from_closes(closes) == \
        jquotes.realized_vol_from_closes(closes)
    assert np.isnan(pquotes.realized_vol_from_closes([1.0, 2.0]))


# ─────────────────────────────────────────────────────────────────────────────
# Checkpoints, timing, the CLI, serverless, fastapi
# ─────────────────────────────────────────────────────────────────────────────
def test_calibration_checkpoint_round_trips(tmp_path):
    """A directory the port saves loads in the port and in the JAX package
    (both read the JSON sidecar); the float32 params file holds the
    params."""
    p = SVJParams(kappa=2.5, theta=0.05, xi=0.45, rho=-0.65, v0=0.041,
                  lambda_j=0.7, mu_j=-0.06, sigma_j=0.11)
    hist = [{"stage": 1, "rmse": 0.12}]
    meta = {"spot": 22500.0, "source": "chain.csv"}
    d = pckpt.save_calibration(str(tmp_path / "cal"), p, hist, meta)
    assert d == str(tmp_path / "cal")
    got, h, m = pckpt.load_calibration(d)
    assert got == p and h == hist and m == meta
    ref, h, m = jckpt.load_calibration(d)
    assert ref.as_dict() == p.as_dict() and h == hist and m == meta
    npz = np.load(os.path.join(d, "params.npz"))
    for k, v in p.as_dict().items():
        assert npz[k].dtype == np.float32 and npz[k] == np.float32(v)
    got, h, m = pckpt.load_calibration(pckpt.save_calibration(
        str(tmp_path / "bare"), p))
    assert got == p and h == [] and m == {}


def test_jax_saved_checkpoint_loads_in_the_port(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from mcos_tpu.models.params import SVJParams as JSVJParams

    jp = JSVJParams(kappa=1.8, v0=0.05)
    d = jckpt.save_calibration(str(tmp_path / "jcal"), jp, [{"i": 1}],
                               {"m": "x"})
    got, h, m = pckpt.load_calibration(d)
    assert got.as_dict() == jp.as_dict() and h == [{"i": 1}]
    assert m == {"m": "x"}


def test_enable_compilation_cache_moves_the_build_dir(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", cuda_kernels.BUILD_DIR)
    home = cuda_kernels.BUILD_DIR
    monkeypatch.setenv("MCOS_DISABLE_JIT_CACHE", "1")
    pckpt.enable_compilation_cache(str(tmp_path / "kc"))
    assert cuda_kernels.BUILD_DIR == home and not (tmp_path / "kc").exists()
    monkeypatch.delenv("MCOS_DISABLE_JIT_CACHE")
    pckpt.enable_compilation_cache(str(tmp_path / "kc"))
    assert cuda_kernels.BUILD_DIR == str(tmp_path / "kc")
    assert (tmp_path / "kc").is_dir()


def test_timing_harness(tmp_path):
    x = torch.arange(4.0)
    out, ms = timing.timed_call(lambda: {"a": [x * 2, (x, 1.0)]})
    assert torch.equal(out["a"][0], x * 2) and ms >= 0.0
    stats = timing.benchmark(torch.cumsum, x, 0, warmup=1, trials=3)
    assert stats["trials"] == 3
    assert stats["min_ms"] <= stats["median_ms"] <= max(stats["mean_ms"] * 3,
                                                        stats["min_ms"])
    res = {}
    with timing.device_timer("step", res) as rec:
        timing._sync(x + 1)
    assert rec["elapsed_ms"] == res["step"] >= 0.0
    with timing.trace(str(tmp_path / "prof")) as d:
        torch.ones(8).sum()
    assert json.load(open(os.path.join(d, "trace.json")))["traceEvents"]


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue())


def test_cli_price_and_rough_on_cpu():
    """The JSON the CLI prints is the engine's own result on the same
    arguments (the Sobol net and the seeded generators are
    deterministic on the CPU)."""
    got = _cli(["price", "--spot", "100", "--strike", "95", "--T", "0.1",
                "--num-paths", "2048", "--num-steps", "16", "--put",
                "--device", "cpu"])
    cli_defaults = SVJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7,
                             v0=0.04, lambda_j=1.0, mu_j=-0.05, sigma_j=0.1,
                             r=0.065, q=0.012)
    ref = MonteCarloEngine(cli_defaults, num_paths=2048, num_steps=16,
                           seed=42, device="cpu").price(
        100.0, 95.0, 0.1, False)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-6), k
    got = _cli(["rough", "--spot", "100", "--T", "0.1", "--num-paths",
                "2048", "--num-steps", "16", "--mode", "smile",
                "--device", "cpu"])
    ref = RoughBergomiEngine(RoughBergomiParams(r=0.065, q=0.012),
                             num_paths=2048, num_steps=16, seed=42,
                             device="cpu").smile(100.0, 0.1)
    assert got.keys() == ref.keys()
    np.testing.assert_allclose(got["prices"], ref["prices"], rtol=1e-6)


def test_cli_commands_match_jax_cli():
    import mcos_tpu.cli as jcli

    def commands(mod):
        buf = io.StringIO()
        with redirect_stdout(buf), pytest.raises(SystemExit):
            mod.main(["--help"])
        line = [ln for ln in buf.getvalue().splitlines()
                if ln.strip().startswith("{")][0]
        return set(line.strip().strip("{}").split(","))
    assert commands(cli) == commands(jcli) >= {"price", "rough", "bench",
                                               "smoke"}


def test_serverless_entry(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", cuda_kernels.BUILD_DIR)
    monkeypatch.setenv("MCOS_JIT_CACHE", str(tmp_path / "jit"))
    monkeypatch.setenv("MCOS_DEVICE", "cpu")
    mod = importlib.reload(importlib.import_module(
        "mcos_tpu_torch.api.serverless"))
    assert cuda_kernels.BUILD_DIR == str(tmp_path / "jit")
    assert mod.DEVICE == "cpu"
    try:
        import fastapi  # noqa: F401
    except ImportError:
        assert mod.app is None
    served = {}

    class Fake:
        def serve_forever(self):
            served["ran"] = True

    monkeypatch.setattr(pserver, "serve", lambda host, port, device:
                        served.update(host=host, port=port,
                                      device=device) or Fake())
    monkeypatch.setenv("PORT", "8123")
    mod.serve_wsgi()
    assert served == {"host": "0.0.0.0", "port": 8123, "device": "cpu",
                      "ran": True}


def test_fastapi_app_routes():
    pytest.importorskip("fastapi")
    app = pserver.create_fastapi_app(device="cpu")
    paths = {r.path for r in app.routes}
    assert set(pserver._POST_ROUTES) | {"/api/health"} <= paths
