"""One run of one cell of the benchmark, driven by the data beside it.

`BENCHMARK.json` names each cell's configuration (`perfbench/configs/`)
and traffic mix (`perfbench/traffic/<mix>.json`); the mix names its
route, the generator that turns it into requests
(`perfbench/traffic/<generator>.py`: `generate`, `warm_bodies` and,
optionally, `length`) and the oracle that judges the answers
(`perfbench/oracles/<oracle>.py`); each per-layer metric is read by
`perfbench/metrics/<metric>.py`. A new cell, mix, generator, configuration,
oracle or metric is new files and new entries, never an edit.

A run, in one process:

1. load the kernels' library from the program's build directory in the
   checkout (it compiles only where none is built);
2. serve the port's `_Handler` from a stdlib ThreadingHTTPServer on
   127.0.0.1, with its coalescer at its defaults, and the route's handler
   wrapped in a span of this benchmark's own (and, with `--trace 1`, kernel
   K1's launches recorded);
3. warm the cell's request shapes through that server;
4. start the load generator (`perfbench/loadgen.py`) as a child process
   and measure for `--seconds`; with `--trace 1`, profile the device over a
   further fixed slice of load (the mix's `trace_seconds`);
5. compare what the window's requests returned with the plain reference,
   once the window is closed, the peak memory read and the server stopped;
6. print the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np

from perfbench import stats, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level modules no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "mcos_tpu")
#: Seconds the load outlasts a traced slice, so the slice never runs dry.
SLICE_MARGIN_S = 2.0
#: A request's longest wait before it counts as failed.
REQUEST_TIMEOUT_S = 300.0


class NoDevice(RuntimeError):
    pass


def cache_env(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, and
    the coalescer at its defaults whatever the environment says."""
    base = os.path.join(root, ".perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)
    for var in ("MCOS_BATCH_WINDOW_MS", "MCOS_BATCH_SLOTS", "MCOS_AUTO_MESH"):
        os.environ.pop(var, None)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A file found by name (metric names hold dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def forbidden_modules() -> list:
    """Forbidden top-level names in sys.modules, compared whole: the
    port's own name begins with the JAX package's."""
    held = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(held & set(FORBIDDEN))


def sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


class Cell:
    """A cell with its configuration and mix, read from `root`."""

    def __init__(self, workload: str, root: str = ROOT,
                 mix_overrides: dict | None = None):
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        self.workload = find(self.bench["workloads"], workload)
        cfg_entry = find(self.bench["configs"], self.workload["config"])
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.mix = load_json(os.path.join(
            root, "perfbench", "traffic", self.workload["traffic"] + ".json"))
        for key, value in (mix_overrides or {}).items():
            if key == "request":
                self.mix["request"] = {**self.mix.get("request", {}), **value}
            else:
                self.mix[key] = value
        self.generator = load_module(
            os.path.join(root, "perfbench", "traffic",
                         self.mix["generator"] + ".py"),
            "perfbench_traffic_" + self.mix["generator"])
        self.oracle = load_module(
            os.path.join(root, "perfbench", "oracles",
                         self.mix["oracle"] + ".py"),
            "perfbench_oracle_" + self.mix["oracle"])

    def metrics(self, kind: str) -> list:
        name = self.workload["name"]
        if kind == "end_to_end":
            return [m for m in self.bench["end_to_end"]
                    if name in m.get("workloads", [name])]
        return [m for m in self.bench["per_layer"]
                if name in m.get("workloads", [name])]


class ServedProgram:
    """The port's `_Handler` on a stdlib ThreadingHTTPServer, as `serve()`
    builds it but without its warm-everything, with the route's entry of
    `_POST_ROUTES` wrapped in a span."""

    def __init__(self, api, device, route: str):
        import torch

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 128

        self.api, self.route = api, route
        self.httpd = Server(("127.0.0.1", 0), api._Handler)
        self.httpd.device = torch.device(device)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.spans = []
        lock = threading.Lock()
        self._inner = inner = api._POST_ROUTES[route]

        def spanned(body, device):
            t = time.monotonic()
            try:
                return inner(body, device=device)
            finally:
                done = time.monotonic()
                with lock:
                    self.spans.append((t, done))

        api._POST_ROUTES[route] = spanned
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       kwargs={"poll_interval": 0.05},
                                       daemon=True)
        self.thread.start()

    def post(self, body: dict) -> dict:
        req = urllib.request.Request(
            self.url + self.route, data=json.dumps(body).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as resp:
            return json.loads(resp.read())

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()
        self.api._POST_ROUTES[self.route] = self._inner


def warm(program: ServedProgram, bodies: list, clients: int) -> None:
    """Each shape once in turn, then one round of `clients` at once, so
    that concurrency's first allocations land here too."""
    for body in bodies:
        program.post(body)
    threads = [threading.Thread(target=program.post,
                                args=(bodies[i % len(bodies)],))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def check_numbers(cell: Cell, requests: list, records: list, seed: int,
                  device) -> tuple:
    """({name: (value, limit)}, failed answers): the oracle's numbers over
    the window's answers (every one, or a sample drawn from the seed with
    the longest request in it, by the generator's `length`) against the
    mix's limits. `requests` are the run's bodies, JSON-encoded."""
    bodies, served, failed = [], [], 0
    for r in records:
        if r[4] != 200:
            failed += 1
            continue
        bodies.append(json.loads(requests[r[0]]))
        served.append(cell.oracle.served(json.loads(r[5])))
    check = cell.mix.get("check", "all")
    if check != "all" and len(bodies) > check["sample"]:
        rng = np.random.default_rng([int(seed), 1])
        length = getattr(cell.generator, "length", None)
        longest = max(range(len(bodies)),
                      key=lambda i: length(bodies[i])) if length else 0
        rest = [i for i in range(len(bodies)) if i != longest]
        picked = [longest] + [rest[int(i)] for i in rng.choice(
            len(rest), size=check["sample"] - 1, replace=False)]
        bodies = [bodies[i] for i in sorted(picked)]
        served = [served[i] for i in sorted(picked)]
    engine = cell.config["engine"]
    numbers = cell.oracle.compare(served, cell.oracle.reference(
        engine, bodies, device)) if bodies else {}
    return held_to_limits(cell, numbers), failed


def held_to_limits(cell: Cell, numbers: dict) -> dict:
    """{name: (value, limit)} for every limit of the mix; a number the
    oracle did not give reads infinite."""
    return {k: (numbers.get(k, math.inf), lim)
            for k, lim in cell.mix["limits"].items()}


def verdict(checks: dict, failed: int, answered: list) -> bool:
    """`correct`: some answers, none failed, and every number compared
    finite and within its limit. `checks` maps a name to (value, limit)."""
    return failed == 0 and bool(answered) and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             root: str = ROOT, device: str = "cuda",
             t_start: float | None = None,
             mix_overrides: dict | None = None) -> dict:
    """One run; returns the result line's object. Raises NoDevice where the
    cell's chips are not there, RuntimeError where the run is unsound."""
    t_start = time.monotonic() if t_start is None else t_start
    cache_env(root)
    cell = Cell(workload, root, mix_overrides)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count()
                             < cell.workload["chips"]):
        raise NoDevice(f"{cell.workload['chips']} CUDA device(s) needed, "
                       f"{torch.cuda.device_count()} present")
    phases = [("imports", time.monotonic())]
    mix = cell.mix
    bodies = cell.generator.generate(cell.config, mix, seed)
    requests = [json.dumps(b) for b in bodies]

    from mcos_tpu_torch.api import coalesce
    from mcos_tpu_torch.api import server as api
    from mcos_tpu_torch.ops import cuda_kernels

    on_card = device == "cuda"
    phases.append(("program import", time.monotonic()))
    if on_card:
        torch.cuda.init()
        cuda_kernels.load_library()
    phases.append(("device and kernels' library", time.monotonic()))
    k1 = trace.K1Launches(cuda_kernels) if traced else None
    program = ServedProgram(api, device, mix["route"])
    child = None
    try:
        warm(program, cell.generator.warm_bodies(cell.config, mix),
             mix["clients"])
        if on_card:
            if traced:
                trace.prepare()
            torch.cuda.synchronize()
        phases.append(("warm-up", time.monotonic()))
        slice_s = float(mix["trace_seconds"]) if traced else 0.0
        job = {"url": program.url, "clients": mix["clients"],
               "requests": [[mix["route"], b] for b in requests],
               "seconds": seconds + (slice_s + SLICE_MARGIN_S if traced
                                     else 0.0),
               "timeout": REQUEST_TIMEOUT_S}
        child = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "loadgen.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        child.stdin.write(json.dumps(job) + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        setup_s = time.monotonic() - t_start
        last = t_start
        for name, t in phases:
            print(f"set-up: {name} {t - last:.3f} s", file=sys.stderr)
            last = t
        child.stdin.write("go\n")
        child.stdin.flush()
        t0 = float(child.stdout.readline().split()[1])
        t1 = t0 + seconds
        counters = {"start": (coalesce.coalescer.batches_run,
                              coalesce.coalescer.requests_coalesced)}
        sleep_until(t1)
        counters["end"] = (coalesce.coalescer.batches_run,
                           coalesce.coalescer.requests_coalesced)
        device_slice = None
        if traced:
            device_slice = trace.DeviceSlice(k1)
            device_slice.start()
            sleep_until(device_slice.t_start + slice_s)
            device_slice.stop()
        out = child.stdout.readline()
        child.wait(timeout=REQUEST_TIMEOUT_S)
        child = None
        records = json.loads(out)["records"]
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    finally:
        if child is not None:
            child.kill()
            child.wait()
        program.stop()
        if k1 is not None:
            k1.restore()
    reduced = device_slice.reduce() if traced else None
    del device_slice
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    window = stats.sent_in(records, t0, t1)
    checks, failed = check_numbers(cell, requests, window, seed, device)
    held = forbidden_modules()
    if held:
        raise RuntimeError("modules that no run may load: " + ", ".join(held))
    correct = verdict(checks, failed, window)

    # What a per-layer metric's reader reads.
    run = SimpleNamespace(records=records, t0=t0, t1=t1, window=window,
                          spans=program.spans, counters=counters,
                          setup_s=setup_s, slice=reduced,
                          k1_shapes=k1.shapes if traced else [])
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.workload["chips"] if on_card else 0,
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv: list, t_start: float) -> int:
    parser = argparse.ArgumentParser(
        description="One run of one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=t_start)
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
