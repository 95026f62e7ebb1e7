"""Timing and profiling harness (counterpart of `mcos_tpu/utils/timing.py`).

- `device_timer`: a wall-clock context; call `_sync` on the body's device
  values before it ends.
- `timed_call`: (result, elapsed ms) with a device sync before the clock
  stops, so asynchronous CUDA launches do not fake sub-ms latencies.
- `benchmark`: warmup + repeated timed calls, min/median/mean.
- `trace`: a `torch.profiler` scope (CPU and, where present, CUDA
  activity) that writes a Chrome trace into `log_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def _sync(x):
    """Wait for every CUDA device that holds a tensor of the result `x` (a
    tensor, or dicts, lists and tuples of them); CPU tensors and host
    values need no wait."""
    devices = {t.device for t in _leaves(x) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)
    return x


@contextlib.contextmanager
def device_timer(label: str = "", results: dict | None = None):
    """Context manager yielding a dict that receives `elapsed_ms` after the
    body; call `_sync(x)` on any device values the body produced first."""
    record: Dict[str, float] = {}
    start = time.perf_counter()
    yield record
    record["elapsed_ms"] = round((time.perf_counter() - start) * 1000, 3)
    if results is not None:
        results[label] = record["elapsed_ms"]


def timed_call(fn: Callable, *args, **kwargs):
    """(result, elapsed_ms) with a device sync before the clock stops."""
    start = time.perf_counter()
    out = _sync(fn(*args, **kwargs))
    return out, (time.perf_counter() - start) * 1000.0


def benchmark(fn: Callable, *args, warmup: int = 1, trials: int = 5,
              **kwargs) -> Dict[str, float]:
    """Warm-up-excluded repeated timing; returns ms statistics."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(trials):
        _, ms = timed_call(fn, *args, **kwargs)
        times.append(ms)
    times.sort()
    return {
        "min_ms": times[0],
        "median_ms": times[len(times) // 2],
        "mean_ms": sum(times) / len(times),
        "trials": trials,
    }


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """A `torch.profiler` scope; on exit the Chrome trace is written to
    `log_dir/trace.json` (default: mcos_tpu_profile in the temporary
    directory; open it in Perfetto or chrome://tracing)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "mcos_tpu_profile")

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
