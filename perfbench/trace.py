"""The traced slice: `torch.profiler` on the device's activity alone, over a
fixed slice of load after the measured window, reduced to what the
per-layer readers take.

Only device activity is recorded (kernels, copies, sets), so the profiler
adds no work to the host's operator calls; its cost is CUPTI's.
"""

from __future__ import annotations

import threading
import time

#: Longest name a breakdown entry keeps.
NAME_CHARS = 96


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


class K1Launches:
    """Kernel K1's launches, with their shapes, in the order they were
    enqueued, installed in a traced run only: the port's population
    wrapper, which every K1 launch goes through, runs under `gate` and is
    recorded while `on`. Holding the gate
    while the slice opens and closes (with a device synchronise) makes the
    K1 kernels in the trace exactly the launches recorded, in order."""

    def __init__(self, module):
        self.gate = threading.Lock()
        self.on = False
        self.shapes = []
        self._module = module
        self._inner = module.svj_terminal_from_draws_population

        def launch(consts_or_params, spot, T, z1, z2, u_jump, z_js, **kw):
            with self.gate:
                out = self._inner(consts_or_params, spot, T, z1, z2, u_jump,
                                  z_js, **kw)
                if self.on and z1.device.type == "cuda":
                    steps, paths = (z1.shape if kw.get("steps_major")
                                    else z1.shape[::-1])
                    self.shapes.append({
                        "members": int(out[0].shape[0]),
                        "steps": int(steps), "paths": int(paths),
                        "n_branch": int(out[0].shape[1]),
                        "companion": bool(kw.get("companion", False)),
                        "streamed_u": u_jump is not None})
            return out

        module.svj_terminal_from_draws_population = launch

    def restore(self) -> None:
        self._module.svj_terminal_from_draws_population = self._inner


def prepare() -> None:
    """Open and close one profiling session on an idle device: the first
    one in a process loads and starts CUPTI, which takes seconds and stalls
    every launch meanwhile, so it belongs to set-up, not to the slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class DeviceSlice:
    """Start and stop the profiler around a slice; `reduce()` afterwards."""

    def __init__(self, k1: K1Launches):
        self.k1 = k1
        self.prof = None
        self.t_start = self.t_end = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with self.k1.gate:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self.t_start = time.monotonic()
            self.k1.on = True

    def stop(self) -> None:
        import torch

        with self.k1.gate:
            self.k1.on = False
            torch.cuda.synchronize()
            self.t_end = time.monotonic()
            self.prof.stop()

    def device_events(self) -> list:
        """(name, start_ns, duration_ns) of every device activity."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns(), e.duration_ns()
            else:
                start, dur = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), int(start), int(dur)))
        return sorted(out, key=lambda ev: ev[1])

    def reduce(self) -> dict:
        events = self.device_events()
        kernels = [ev for ev in events
                   if not ev[0].startswith(("Memcpy", "Memset"))]
        merged = []              # [start, end, name of the last event]
        for name, start, dur in events:
            end = start + dur
            if merged and start <= merged[-1][1]:
                if end > merged[-1][1]:
                    merged[-1][1], merged[-1][2] = end, name
            else:
                merged.append([start, end, name])
        busy_ns = sum(e - s for s, e, _ in merged)
        by_name = {}
        for name, _, dur in events:
            by_name[name] = by_name.get(name, 0) + dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][2])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        return {
            "t_start": self.t_start, "t_end": self.t_end,
            "window_s": self.t_end - self.t_start,
            "busy_s": busy_ns / 1e9,
            "kernels": kernels,
            "n_kernels": len(kernels),
            "device_ops": [[_short(n), d / 1e9] for n, d in top],
            "idle_gaps": [[_short("after " + n), g / 1e9] for g, n in gaps],
        }
