#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mcos_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Device: needs `torch.cuda.is_available()`; prints the card's
   `nvidia-smi --query-gpu=name,power.limit` line.
2. Build: compiles the CUDA kernels from mcos_tpu_torch/csrc (sm_90a) and
   prints how long it took.
3. Kernels against their plain torch versions, at the main path's shapes:
   K1 `svj_terminal_from_draws` at 500 000 paths × 63 steps on the real
   Sobol net (explicit jump uniforms, then in-kernel Philox jumps), and
   K2 `gbm_terminal` at 2^20 pairs × 252 steps (word-for-word against the
   plain version, antithetic mirror, moments, Black-Scholes within 3σ).
4. Main path, with every launch count set to 0 first: the port's HTTP
   server on 127.0.0.1 (GET /api/health; the default POST /api/price solo
   and as 4 concurrent requests that the coalescer batches; a degenerate
   GBM request against Black-Scholes; the default SVJ request against the
   COS oracle; 5 warm requests for latency) and the benchmark entry point
   (`mcos_tpu_torch.bench`), then reads the launch counts.
5. Prints the kernels' JSON line, the card line and, last, the result line
   {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line is
printed. Long output goes to chiprun_out/chip_smoke.json.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

SPOT = STRIKE = 22500.0
T_DEFAULT = 0.25          # 63 steps at the schema's 252 steps/year
NUM_PATHS = 500_000       # PriceRequest default
GBM_PAIRS, GBM_STEPS = 1 << 20, 252


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


# ─────────────────────────────────────────────────────────────────────────────
# Kernels against their plain versions
# ─────────────────────────────────────────────────────────────────────────────
def check_k1(device, ck, sobol, params):
    steps = int(252 * T_DEFAULT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z1, z2, _, zjs = sobol.sobol_svj_draws(NUM_PATHS, steps, seed=42,
                                           jump_uniforms=False, device=device)
    torch.cuda.synchronize()
    sobol_ms = (time.perf_counter() - t0) * 1e3
    check(all(bool(torch.isfinite(x).all()) for x in (z1, z2, zjs)),
          "Sobol draws finite")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    uj = torch.rand(z1.shape, generator=gen, device=device)
    kw = dict(seed=42, antithetic=True, companion=True, steps_major=True)
    # Tolerance: float32 on both sides; the kernel's multiply-adds are
    # contracted to FMAs and the plain version's are not, which moves the
    # log-spot carry by a few ulps per step: rtol 1e-5 on S and G. v can sit
    # at the truncation floor 0, so it gets atol 1e-6 beside rtol 1e-4.
    errs = {}
    for mode, u in (("explicit u_jump", uj), ("in-kernel jumps", None)):
        ker = ck.svj_terminal_from_draws(params, SPOT, T_DEFAULT, z1, z2, u,
                                         zjs, **kw)
        torch.cuda.synchronize()
        ref = ck.svj_terminal_from_draws_plain(params, SPOT, T_DEFAULT, z1,
                                               z2, u, zjs, **kw)
        torch.cuda.synchronize()
        s_err, g_err = rel_err(ker[0], ref[0]), rel_err(ker[2], ref[2])
        v_ok = torch.allclose(ker[1], ref[1], rtol=1e-4, atol=1e-6)
        log(f"K1 {mode}: S rel err {s_err:.3e}, G rel err {g_err:.3e}, "
            f"v allclose {v_ok} (rtol 1e-5 on S and G)")
        check(bool(torch.isfinite(ker[0]).all()), f"K1 {mode}: S finite")
        check(s_err < 1e-5 and g_err < 1e-5 and v_ok, f"K1 {mode} vs plain")
        errs[mode] = float((ker[0] - ref[0]).abs().max())
    ms = cuda_ms(lambda: ck.svj_terminal_from_draws(
        params, SPOT, T_DEFAULT, z1, z2, None, zjs, **kw))
    plain_ms = cuda_ms(lambda: ck.svj_terminal_from_draws_plain(
        params, SPOT, T_DEFAULT, z1, z2, None, zjs, **kw), reps=3)
    log(f"K1 at {NUM_PATHS} paths x {steps} steps: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms; Sobol net (cold, 3 x {steps} dims) "
        f"{sobol_ms:.2f} ms")
    return {"max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "sobol_ms": sobol_ms, "shape": [steps, NUM_PATHS]}


def check_k2(device, ck, bs_price):
    sigma, r, q, T = 0.2, 0.065, 0.012, 1.0
    kw = dict(num_paths=GBM_PAIRS, num_steps=GBM_STEPS, device=device)
    ker = ck.gbm_terminal(SPOT, sigma, r, q, T, 7, **kw)
    torch.cuda.synchronize()
    ref = ck.gbm_terminal_plain(SPOT, sigma, r, q, T, 7, **kw)
    torch.cuda.synchronize()
    err = rel_err(ker, ref)
    log(f"K2 vs plain (same Philox words): S rel err {err:.3e} (rtol 1e-5: "
        "float32, sincospif against sin/cos of a float64 angle)")
    check(err < 1e-5, "K2 vs plain")
    lr = torch.log(ker.double() / SPOT)
    drift = (r - q - 0.5 * sigma**2) * T
    mirror = float((lr[0] + lr[1] - 2 * drift).abs().max())
    mean, std = float(lr[0].mean()), float(lr[0].std())
    log(f"K2 mirror |lr0+lr1-2*drift| max {mirror:.2e}; log-return mean "
        f"{mean:.6f} (exact {drift:.6f}), std {std:.6f} "
        f"(exact {sigma * np.sqrt(T):.6f})")
    check(mirror < 2e-5, "K2 antithetic mirror")
    check(abs(mean - drift) < 5 * sigma * np.sqrt(T / GBM_PAIRS), "K2 mean")
    check(abs(std - sigma * np.sqrt(T)) < 5 * sigma * np.sqrt(T / (2 * GBM_PAIRS)),
          "K2 std")
    pay = torch.clamp(ker.double() - STRIKE, min=0).mean(dim=0)
    disc = np.exp(-r * T)
    mc, se = disc * float(pay.mean()), disc * float(pay.std()) / np.sqrt(GBM_PAIRS)
    bs = float(bs_price(SPOT, STRIKE, T, r, q, sigma, True))
    log(f"K2 call {mc:.4f} vs BS {bs:.4f} (3 se = {3 * se:.4f})")
    check(abs(mc - bs) < 3 * se, "K2 BS 3-sigma gate")
    ms = cuda_ms(lambda: ck.gbm_terminal(SPOT, sigma, r, q, T, 8, **kw))
    plain_ms = cuda_ms(lambda: ck.gbm_terminal_plain(SPOT, sigma, r, q, T, 8,
                                                     **kw), reps=2)
    rate = 2 * GBM_PAIRS * GBM_STEPS / (ms * 1e-3)
    log(f"K2 at {GBM_PAIRS} pairs x {GBM_STEPS} steps: kernel {ms:.4f} ms "
        f"({rate:.4e} path-steps/s), plain {plain_ms:.4f} ms")
    return {"max_abs_err": float((ker - ref).abs().max()), "ms": ms,
            "plain_ms": plain_ms}


# ─────────────────────────────────────────────────────────────────────────────
# Main path
# ─────────────────────────────────────────────────────────────────────────────
def post(base: str, body: dict):
    req = urllib.request.Request(base + "/api/price",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, res = r.status, json.loads(r.read())
    return status, res, (time.perf_counter() - t0) * 1e3


def check_response(status, res, what):
    check(status == 200, f"{what}: status {status}")
    for k in ("price", "std_error", "bs_ref", "raw_mc_price"):
        check(np.isfinite(res.get(k, 0.0)), f"{what}: {k} finite")
    check(res["frac_nonfinite"] == 0.0, f"{what}: all paths finite")
    check(res["post_checks"]["pass"], f"{what}: post_checks {res['post_checks']}")
    paths = np.asarray(res["sample_paths"], dtype=float)
    check(paths.ndim == 2 and paths.shape[0] == 50, f"{what}: sample_paths")
    check(np.isfinite(paths).all() and len(res["terminal_samples"]) == 1024,
          f"{what}: viz samples")


def main_path(device, ck, bench, cos_price, bs_price, SVJParams, server):
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    warm_s = time.perf_counter() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    priced = 0
    out = {"server_warm_s": warm_s}
    try:
        with urllib.request.urlopen(base + "/api/health", timeout=60) as r:
            check(r.status == 200 and json.loads(r.read())["status"]
                  == "healthy", "GET /api/health")
        body = {"spot": SPOT, "strike": STRIKE, "T": T_DEFAULT}
        status, solo, first_ms = post(base, body)
        check_response(status, solo, "default /api/price")
        priced += 1
        log(f"default /api/price: {solo['price']:.4f} ± {solo['std_error']:.4f}"
            f" ({solo['num_steps']} steps, first request {first_ms:.1f} ms)")

        # A 100 ms window for this burst, so all 4 land in one batch
        # whatever the threads' start-up spread; the default is restored
        # before the latency runs.
        coalescer = server.coalesce.coalescer
        batches0, window = coalescer.batches_run, coalescer.window_s
        coalescer.window_s = 0.1
        results = [None] * 4

        def one(i):
            results[i] = post(base, body)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            coalescer.window_s = window
        check(not any(t.is_alive() for t in threads), "concurrent requests done")
        for i, (status, res, ms) in enumerate(results):
            check_response(status, res, f"concurrent request {i}")
            check(res["price"] == solo["price"], "coalesced price == solo")
        priced += 4
        n_batches = coalescer.batches_run - batches0
        log(f"4 concurrent /api/price: all 200, price == solo, in {n_batches} "
            f"coalesced batch(es); latencies "
            f"{[round(r[2], 1) for r in results]} ms")
        check(n_batches == 1, "the 4 concurrent requests form one batch")

        # Control variate off: with it on, the degenerate model's companion
        # leg is the priced path itself and the check would be vacuous.
        sigma = 0.2
        gbm_body = dict(body, use_control_variate=False,
                        params={"kappa": 0.0, "theta": sigma**2,
                                      "xi": 0.0, "rho": 0.0, "v0": sigma**2,
                                      "lambda_j": 0.0, "mu_j": 0.0,
                                      "sigma_j": 0.0})
        status, res, _ = post(base, gbm_body)
        check_response(status, res, "GBM /api/price")
        priced += 1
        bs = float(bs_price(SPOT, STRIKE, T_DEFAULT, 0.065, 0.012, sigma, True))
        log(f"GBM /api/price {res['price']:.4f} vs BS {bs:.4f} "
            f"(3 se = {3 * res['std_error']:.4f})")
        check(abs(res["price"] - bs) < 3 * res["std_error"], "GBM vs BS")

        cos = float(cos_price(SVJParams(), SPOT, [STRIKE], T_DEFAULT, True)[0])
        tol = 4 * solo["std_error"] + 0.01 * cos
        log(f"default SVJ /api/price {solo['price']:.4f} vs COS {cos:.4f} "
            f"(tol 4 se + 1% = {tol:.4f})")
        check(abs(solo["price"] - cos) < tol, "SVJ vs COS")

        lat = []
        for _ in range(5):
            status, res, ms = post(base, body)
            check_response(status, res, "warm /api/price")
            lat.append(ms)
        priced += 5
        out["warm_latency_ms"] = statistics.median(lat)
        out["warm_latencies_ms"] = lat
        out["server_elapsed_ms"] = res["elapsed_ms"]
        log(f"warm default /api/price latency: median {out['warm_latency_ms']:.2f}"
            f" ms over 5 ({[round(x, 2) for x in lat]}); server-side "
            f"elapsed_ms {res['elapsed_ms']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    gate = bench.bs_gate(device)
    check(gate["ok"], f"bench BS gate {gate}")
    rate = bench.throughput(device)
    out["bench_path_steps_per_s"] = rate
    log(f"bench (mcos_tpu_torch.bench): BS gate ok ({gate['mc']:.4f} vs "
        f"{gate['bs']:.4f}), {rate:.4e} path-steps/s")
    counts = ck.launch_counts()
    log(f"launch counts over the main path: {counts} ({priced} priced "
        "requests)")
    check(counts["svj_terminal_from_draws"] >= priced,
          "K1 launched for every priced request")
    check(all(n > 0 for n in counts.values()), "every kernel launched")
    out["launches"] = counts
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    from mcos_tpu_torch import bench
    from mcos_tpu_torch.api import server
    from mcos_tpu_torch.models.params import SVJParams
    from mcos_tpu_torch.ops import cuda_kernels as ck
    from mcos_tpu_torch.ops import sobol
    from mcos_tpu_torch.ops.bs import bs_price
    from mcos_tpu_torch.ops.cos_pricer import cos_price

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ck.load_library()
    log(f"kernel build (nvcc sm_90a) + load: {ck.build_seconds():.2f} s")

    k1 = check_k1(device, ck, sobol, SVJParams())
    k2 = check_k2(device, ck, bs_price)
    mp = main_path(device, ck, bench, cos_price, bs_price, SVJParams, server)

    kernels = [
        {"name": "svj_terminal_from_draws", "route": "cuda",
         "source": "mcos_tpu_torch/csrc/svj_draws.cu",
         "replaces": "mcos_tpu/ops/pallas_kernels.py:490",
         "launches": mp["launches"]["svj_terminal_from_draws"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "gbm_terminal", "route": "cuda",
         "source": "mcos_tpu_torch/csrc/gbm.cu",
         "replaces": "mcos_tpu/ops/pallas_kernels.py:1386",
         "launches": mp["launches"]["gbm_terminal"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": ck.build_seconds(), "k1": k1,
                   "k2": k2, "main_path": mp}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # the nvidia-smi line as it came
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
