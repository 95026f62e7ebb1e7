"""The port's slice end to end on CPU: `/api/price` against the JAX
package's handler, the coalescer, the HTTP routes, and no JAX in the port."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mcos_tpu.api import coalesce as jcoalesce
from mcos_tpu.api import server as jserver
from mcos_tpu_torch.api import coalesce as pcoalesce
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.engine import calibration as pcal
from mcos_tpu_torch.ops import cuda_kernels

torch.set_num_threads(1)

_BODY = {"spot": 22500.0, "strike": 22500.0, "T": 0.1, "num_paths": 4096}


@pytest.fixture
def solo(monkeypatch):
    """Coalescing off on both sides (the modules read MCOS_BATCH_WINDOW_MS
    only at import), single-device JAX pricing."""
    monkeypatch.setattr(jcoalesce.coalescer, "window_s", 0.0)
    monkeypatch.setattr(pcoalesce.coalescer, "window_s", 0.0)
    monkeypatch.delenv("MCOS_AUTO_MESH", raising=False)


def _both(body):
    return (pserver.handle_price(dict(body), device="cpu"),
            jserver.handle_price(dict(body)))


def test_handle_price_matches_jax_without_jumps(solo):
    body = dict(_BODY, params={"lambda_j": 0.0})
    got, ref = _both(body)
    assert got.keys() == ref.keys()
    for k in ("price", "std_error"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    for k in ("raw_mc_price", "bs_ref", "v_max"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    assert got["num_steps"] == ref["num_steps"] == 25
    assert got["num_paths_used"] == ref["num_paths_used"]
    assert got["pre_checks"] == ref["pre_checks"]
    assert got["post_checks"]["pass"] and ref["post_checks"]["pass"]
    assert got["params_used"] == ref["params_used"]
    for r in (got, ref):
        paths = np.asarray(json.loads(r["sample_paths"].raw))
        terms = np.asarray(json.loads(r["terminal_samples"].raw))
        assert paths.shape == (50, 51) and (paths > 0).all()
        assert terms.shape == (1024,) and (terms > 0).all()


def test_handle_price_default_svj_within_errors(solo):
    got, ref = _both(_BODY)
    se = np.hypot(got["std_error"], ref["std_error"])
    assert abs(got["price"] - ref["price"]) < 4 * se
    assert got["post_checks"]["pass"] and ref["post_checks"]["pass"]


def test_coalesced_batch_equals_solo(solo, monkeypatch):
    bodies = [dict(_BODY, strike=k, T=0.05) for k in (22000.0, 22500.0,
                                                      23000.0)]
    solos = [pserver.handle_price(dict(b), device="cpu") for b in bodies]
    monkeypatch.setattr(pcoalesce.coalescer, "window_s", 0.5)
    runs0 = pcoalesce.coalescer.batches_run
    out = [None] * 3

    def call(i):
        out[i] = pserver.handle_price(dict(bodies[i]), device="cpu")

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
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
        assert got["terminal_samples"].raw == ref["terminal_samples"].raw


@pytest.mark.parametrize("extra", [
    {"use_sobol": False}, {"scheme": "qe"}, {"use_importance": True},
    {"rqmc_randomizations": 4},
])
def test_unported_options_answer_501(solo, extra):
    """The options that answered 501 before they were ported now answer as
    the JAX handler does: the same keys, and prices within 4 combined
    standard errors (PRNG streams differ between the two packages)."""
    got, ref = _both(dict(_BODY, **extra))
    assert got.keys() == ref.keys()
    se = np.hypot(got["std_error"], ref["std_error"])
    assert abs(got["price"] - ref["price"]) < 4 * se
    assert got["post_checks"]["pass"] and ref["post_checks"]["pass"]
    for k in ("num_paths_used", "randomizations"):
        assert got.get(k) == ref.get(k), k
    paths = np.asarray(json.loads(got["sample_paths"].raw))
    assert paths.shape == (50, 51) and (paths > 0).all()


def test_http_routes(solo, monkeypatch):
    monkeypatch.setattr(pserver, "warm", lambda device: None)
    # /api/calibrate's differential evolution cut to 4 steps, 4 members and
    # 25 generations a stage: the route, not the fit.
    calibrate = pcal.CalibrationEngine.calibrate

    def small_calibrate(self, *a, **k):
        self.config = dataclasses.replace(
            self.config, stage1_max_iter=100, stage2_max_iter=100)
        return calibrate(self, *a, num_steps=4, pop_size=4, **k)

    monkeypatch.setattr(pcal.CalibrationEngine, "calibrate", small_calibrate)
    httpd = pserver.serve("127.0.0.1", 0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(base + path, data=data)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        assert call("/api/health")[0] == 200
        assert call("/api/nosuchroute")[0] == 404
        # A route neither package serves answers 404; the ported
        # calibration and surface, American, PDE, Greeks, smile and stress
        # routes answer 200.
        assert call("/api/nosuchroute", _BODY)[0] == 404
        strikes = [90.0, 95.0, 100.0, 105.0, 110.0]
        iv = [[0.22, 0.21, 0.2, 0.2, 0.21], [0.23, 0.22, 0.21, 0.21, 0.215]]
        grid = {"spot": 100.0, "strikes": strikes, "maturities": [0.25, 0.5],
                "iv": iv, "price_strikes": [95.0, 105.0], "T": 0.4,
                "num_paths": 2000, "num_steps": 16}
        status, res = call("/api/localvol", grid)
        assert status == 200 and len(res["chain"]) == 2
        status, res = call("/api/slv", dict(grid, mode="barrier",
                                            barrier=120.0))
        assert status == 200 and np.isfinite(res["price"])
        assert call("/api/slv", dict(grid, mode="cliquet"))[0] == 400
        status, res = call("/api/quotegreeks", {
            "spot": 100.0, "T": 0.5, "strikes": strikes,
            "product": {"kind": "vanilla", "T": 0.5}})
        assert status == 200 and len(res["buckets"]) == 5
        chain = {"spot": 100.0, "strikes": strikes, "maturities": [0.5],
                 "call_prices": [[11.9, 8.1, 5.0, 2.8, 1.4]],
                 "put_prices": [[0.9, 2.1, 4.0, 6.8, 10.3]],
                 "fit_sabr": False}
        status, res = call("/api/surface", chain)
        assert status == 200 and len(res["iv_call"][0]) == 5
        status, res = call("/api/calibrate", {
            "spot": 100.0, "strikes": strikes, "T": 0.5,
            "market_prices": chain["call_prices"][0], "num_paths": 1000})
        assert status == 200 and res["params"].keys() >= {"kappa", "v0"}
        assert call("/api/calibrate", {
            "spot": 100.0, "strikes": strikes, "T": 0.5,
            "market_prices": chain["call_prices"][0],
            "exercise": "bermudan"})[0] == 400
        status, res = call("/api/american", dict(_BODY, num_paths=2000,
                                                 T=0.1))
        assert status == 200 and np.isfinite(res["price"])
        status, res = call("/api/pde", {"spot": 100.0, "strike": 100.0,
                                        "T": 0.25, "n_x": 51, "n_v": 21,
                                        "n_t": 16})
        assert status == 200 and np.isfinite(res["price"])
        status, res = call("/api/stress", dict(_BODY, num_paths=1024,
                                               T=0.05))
        assert status == 200 and len(res["spot_shocks"]) == 6
        status, res = call("/api/greeks", dict(_BODY, num_paths=2048))
        assert status == 200 and np.isfinite(res["delta"]["pathwise"])
        assert res.keys() >= {"delta", "vega", "gamma", "theta", "rho",
                              "jumps", "model"}
        status, res = call("/api/smile", {"spot": 22500.0, "T": 0.25,
                                          "method": "cos"})
        assert status == 200 and len(res["smile"]) == 21
        assert call("/api/price", dict(_BODY, num_paths=10))[0] == 422
        status, res = call("/api/price", dict(_BODY, num_paths=1024, T=0.05))
        assert status == 200 and res["post_checks"]["pass"]
        assert len(res["sample_paths"]) == 50
        small = dict(_BODY, num_paths=1024, T=0.05)
        status, res = call("/api/price", dict(small, scheme="qe"))
        assert status == 200 and res["post_checks"]["pass"]
        status, res = call("/api/convergence", small)
        assert status == 200 and res["num_paths"][-1] == 1024
        assert len(res["price"]) == len(res["std_error"]) == \
            len(res["num_paths"])
        assert call("/api/convergence", dict(small, num_paths=10))[0] == 422
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_handle_convergence_matches_jax(solo, monkeypatch):
    body = dict(_BODY, num_paths=8192)
    got = pserver.handle_convergence(dict(body), device="cpu")
    ref = jserver.handle_convergence(dict(body))
    assert got.keys() == ref.keys()
    assert got["num_paths"] == ref["num_paths"]
    se = np.hypot(got["std_error"][-1], ref["std_error"][-1])
    assert abs(got["price"][-1] - ref["price"][-1]) < 4 * se
    # num_paths is capped at 500 000 and the PRNG driver is used.
    monkeypatch.setattr(pserver.MonteCarloEngine, "convergence",
                        lambda self, *a: (self.num_paths, self.use_sobol))
    assert pserver.handle_convergence(dict(body, num_paths=600_000),
                                      device="cpu") == (500_000, False)


def test_cpu_price_launches_no_kernel(solo):
    before = cuda_kernels.launch_counts()
    pserver.handle_price(dict(_BODY, num_paths=1024, T=0.05), device="cpu")
    assert cuda_kernels.launch_counts() == before


def test_port_imports_no_jax():
    code = ("import sys, mcos_tpu_torch, mcos_tpu_torch.api.server, "
            "mcos_tpu_torch.bench, mcos_tpu_torch.ops.cuda_kernels, "
            "mcos_tpu_torch.engine.roughheston, mcos_tpu_torch.engine.mlmc, "
            "mcos_tpu_torch.cli, mcos_tpu_torch.api.client, "
            "mcos_tpu_torch.api.quotes, mcos_tpu_torch.api.serverless, "
            "mcos_tpu_torch.utils.timing, mcos_tpu_torch.utils.checkpoint; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'mcos_tpu' or "
            "m.startswith('mcos_tpu.')]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
