"""Request coalescing (micro-batching) for `/api/price`
(counterpart of `mcos_tpu/api/coalesce.py`).

Concurrent requests that share one program shape — same (device,
num_paths, step counts, estimator flags, scheme, is_call) — join one batch:
the first request into an empty bucket becomes the leader, waits one
batching window (`MCOS_BATCH_WINDOW_MS`, default 3 ms), drains the bucket,
runs every member and hands each its slice; followers wait on a Future.
The leader/Future machinery is host code, unchanged from the JAX package.

A batch runs its members one after another on the device, as the JAX
version unrolls them: each member runs the exact program the solo path runs
(an engine with the serving seed: the shared Sobol net through K1 or K5,
or the in-kernel generator of K3 or K4, then the two visualisation
programs), so a coalesced response equals a solo one, and the whole batch
pays one device→host copy. PyTorch runs eagerly, so there is no compiled
program per batch size to bound, and batches are not padded.

Spans (`utils/spans.py`): each request's `coalesce.submit`; its
`coalesce.queue`, from its submit until the batch that holds it starts to
run (the leader stamps it for every member); the batch's
`coalesce.batch`, whose request is the tuple of its members' ids, and
inside it each member's `program.*` spans under that member's id.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Sequence, Tuple

import torch

from mcos_tpu_torch.config import DEFAULT_NUM_STEPS, scaled_steps
from mcos_tpu_torch.engine.pricer import MonteCarloEngine, to_host
from mcos_tpu_torch.utils import spans

__all__ = ["PriceCoalescer", "coalescer", "bucket_key", "batch_price_viz"]

_VIZ_SAMPLES = 50           # matches handle_price's sample_paths_device call
_TERM_SAMPLES = 1024        # matches terminal_samples_device default
#: Largest batch; deeper queues split into several batches.
MAX_BATCH = 8


def bucket_key(req, device) -> Tuple:
    """Program shape of a PriceRequest on `device` (None = not coalescible:
    importance sampling and RQMC run multi-program host logic)."""
    if req.use_importance or req.rqmc_randomizations:
        return None
    num_steps = (req.num_steps if req.num_steps is not None
                 else DEFAULT_NUM_STEPS)
    steps = scaled_steps(num_steps, req.T)
    viz_steps = max(int(num_steps * req.T), 50)
    return (str(torch.device(device)), req.num_paths, num_steps, steps,
            viz_steps, req.use_sobol, req.use_antithetic,
            req.use_control_variate, req.cv_mode, req.scheme, req.is_call)


def batch_price_viz(key: Tuple, members: List[Tuple],
                    request_ids: Sequence = ()) -> List[Dict]:
    """Run one batch over `members` = [(params, spot, strike, T)], the
    `i`-th working for request `request_ids[i]` (None where not given).

    Returns one dict per member: {"res": result dict of numpy arrays
    (strike axis), "paths": (viz, steps+1) array, "terms": (n,) array}.
    """
    (device, num_paths, num_steps, _steps, _viz_steps, use_sobol,
     use_antithetic, use_control_variate, cv_mode, scheme, is_call) = key
    rids = list(request_ids) or [None] * len(members)
    device_out = {}
    with spans.span("coalesce.batch", request=tuple(rids)):
        for i, (params, spot, strike, T) in enumerate(members):
            with spans.RECORDER.acting_for(rids[i]):
                # Serving engines use the default seed, as the solo path
                # does.
                eng = MonteCarloEngine(
                    params, num_paths=num_paths, num_steps=num_steps,
                    use_sobol=use_sobol, use_antithetic=use_antithetic,
                    use_control_variate=use_control_variate,
                    cv_mode=cv_mode, scheme=scheme, device=device)
                res = eng.price_device(spot, strike, T, is_call)
                device_out.update({f"{i}/res/{k}": v
                                   for k, v in res.items()})
                device_out[f"{i}/paths"] = eng.sample_paths_device(
                    spot, T, num_samples=_VIZ_SAMPLES)
                device_out[f"{i}/terms"] = eng.terminal_samples_device(
                    spot, T, num_samples=_TERM_SAMPLES)
        host = to_host(device_out)
    out = []
    for i in range(len(members)):
        prefix = f"{i}/res/"
        out.append({
            "res": {k[len(prefix):]: v for k, v in host.items()
                    if k.startswith(prefix)},
            "paths": host[f"{i}/paths"],
            "terms": host[f"{i}/terms"],
        })
    return out


class PriceCoalescer:
    """Leader-elected micro-batcher. Thread-safe; one instance per server."""

    def __init__(self, window_s: float = 0.003, max_batch: int = MAX_BATCH):
        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        # A few batches in flight at once: leaders held at the semaphore
        # let their buckets keep filling while earlier batches run.
        try:
            n_slots = max(int(os.environ.get("MCOS_BATCH_SLOTS", "4")), 1)
        except ValueError:
            n_slots = 4
        self._slots = threading.BoundedSemaphore(n_slots)
        self._buckets: Dict[Tuple, List] = {}
        self.batches_run = 0
        self.requests_coalesced = 0

    def submit(self, key: Tuple, member: Tuple) -> Dict:
        """Block until this member's slice of a batched run is ready."""
        with spans.span("coalesce.submit"):
            fut: Future = Future()
            # What the leader needs to stamp this request's queue span.
            waiter = (time.monotonic_ns(), spans.RECORDER.current_request(),
                      spans.RECORDER.current_span())
            with self._lock:
                queue = self._buckets.setdefault(key, [])
                queue.append((member, fut, waiter))
                leader = len(queue) == 1
            if not leader:
                return fut.result(timeout=600)

            if self._slots.acquire(blocking=False):
                # Idle server: a brief window lets co-arriving requests
                # join.
                time.sleep(self.window_s)
            else:
                # Busy server: the wait for a free slot is the batching
                # window.
                self._slots.acquire()
            try:
                return self._drain_and_run(key, fut)
            finally:
                self._slots.release()

    def _drain_and_run(self, key: Tuple, fut: Future) -> Dict:
        with self._lock:
            queue = self._buckets.pop(key, [])
        for lo in range(0, len(queue), self.max_batch):
            chunk = queue[lo:lo + self.max_batch]
            started = time.monotonic_ns()
            for _, _, (t_submit, rid, parent) in chunk:
                spans.RECORDER.record("coalesce.queue", t_submit, started,
                                      request=rid, parent=parent)
            try:
                results = batch_price_viz(key, [m for m, _, _ in chunk],
                                          [w[1] for _, _, w in chunk])
            except Exception as exc:  # noqa: BLE001 — fan the error out
                for _, f, _ in chunk:
                    f.set_exception(exc)
                continue
            with self._lock:
                self.batches_run += 1
                self.requests_coalesced += len(chunk)
            for (_, f, _), r in zip(chunk, results):
                f.set_result(r)
        return fut.result(timeout=600)


def _default_window_s() -> float:
    try:
        ms = float(os.environ.get("MCOS_BATCH_WINDOW_MS", "3"))
    except ValueError:
        ms = 3.0
    return max(ms, 0.0) / 1000.0


#: Process-wide coalescer; window 0 disables coalescing at the call site.
coalescer = PriceCoalescer(window_s=_default_window_s())


def enabled() -> bool:
    return coalescer.window_s > 0.0
