"""Headline benchmark of the port: GBM path-steps/s on one CUDA device, from
kernel K2 (`ops/cuda_kernels.gbm_terminal`).

    python -m mcos_tpu_torch.bench

Prints ONE JSON line with the root `bench.py`'s contract and metric name:
{"metric", "value", "unit", "vs_baseline"}, plus the device it ran on.
`vs_baseline` is the ratio to the 1e9 path-steps/s north star
(BASELINE.md). The run gates on correctness first: the kernel's MC call
price at 25k antithetic pairs × 250 steps must land within 3σ of
Black-Scholes, or the value is 0. Without a CUDA device it fails: a CPU
number is never reported under this metric.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

TARGET = 1e9  # path-steps/s (BASELINE.md north star)
SPOT, STRIKE, SIGMA, R, Q, T = 22500.0, 22500.0, 0.2, 0.065, 0.012, 1.0


def bs_gate(device) -> dict:
    """MC call vs Black-Scholes at 25k pairs × 250 steps (3σ gate)."""
    from mcos_tpu_torch.ops.bs import bs_price
    from mcos_tpu_torch.ops.cuda_kernels import gbm_terminal

    s = gbm_terminal(SPOT, SIGMA, R, Q, T, 7, num_paths=25_000,
                     num_steps=250, antithetic=True, device=device)
    pay = torch.clamp(s - STRIKE, min=0.0).mean(dim=0)  # antithetic pairs
    disc = float(np.exp(-R * T))
    mc = disc * float(pay.mean())
    se = disc * float(pay.std(correction=0)) / np.sqrt(pay.shape[0])
    ref = float(bs_price(SPOT, STRIKE, T, R, Q, SIGMA, True))
    return {"mc": mc, "se": se, "bs": ref, "ok": abs(mc - ref) < 3.0 * se}


def throughput(device) -> float:
    """Sustained path-steps/s: 4 chained launches of 2^22 antithetic pairs
    × 1024 steps per timing, each reduced on device, best of 3 timings."""
    from mcos_tpu_torch.ops.cuda_kernels import gbm_terminal

    num_paths, num_steps, chain, trials = 1 << 22, 1024, 4, 3

    def run(seed0):
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(chain):
            s = gbm_terminal(SPOT, SIGMA, R, Q, T, seed0 + i,
                             num_paths=num_paths, num_steps=num_steps,
                             device=device)
            acc = acc + torch.clamp(s - STRIKE, min=0.0).sum()
        return float(acc)  # scalar fetch = full sync

    run(0)  # warm-up (and build)
    times = []
    for trial in range(trials):
        t0 = time.perf_counter()
        run(100 * (trial + 1))
        times.append(time.perf_counter() - t0)
    return chain * 2 * num_paths * num_steps / min(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mcos_tpu_torch.bench needs a CUDA device")
    device = torch.device("cuda", 0)
    gate = bs_gate(device)
    rate = throughput(device)
    value = rate if gate["ok"] else 0.0
    print(json.dumps({
        "metric": "gbm_path_steps_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "path-steps/s",
        "vs_baseline": round(value / TARGET, 3),
        "device": torch.cuda.get_device_name(device),
    }))


if __name__ == "__main__":
    main()
