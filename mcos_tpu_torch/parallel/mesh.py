"""Device-mesh parallelism of the port: path-sharded Monte Carlo with pooled
moment sums (counterpart of `mcos_tpu/parallel/mesh.py`, slice N1).

The JAX package runs one controller over many devices: `shard_map` gives
each device a key folded by its index and `psum` pools the moment sums
over the interconnect. The port's counterpart runs in one process:

- a `Mesh` is an ordered tuple of torch devices with the axis names
  ("paths",) or ("batch", "paths"). Devices may repeat: a CPU test builds
  8 shards of "cpu", one card 4 shards of "cuda:0". `make_mesh()` takes
  every CUDA device and raises when there is none;
- each position on the sharded axis is a `Shard`: its index, device,
  seed and backend. Shard 0 keeps the caller's seed, so a one-shard mesh
  prices exactly what the unsharded engine prices; shard i > 0 takes
  `shard_seed(seed, i)`. Where a program has a kernel, backend="cuda"
  runs it (its plain version on a CPU shard) and backend="torch" the
  step-loop twin, on the shard's generator or on draws a test replays
  (`shard_draws=`, a callable from the shard index to the twin's
  `draws=`);
- a shard's payoffs reduce to a moment dict (`shard_moments`), and
  `pool_shards`, the one place where shards meet, sums the dicts in shard
  order on shard 0's device, with `v_max` pooled as a max (the
  reference's `psum` and `pmax`). `pool_moments` turns pooled sums into
  price and standard error.

Moments stay float32 sums. Each shard adds its second moments about its
own mean, Σ(x − x̄ᵢ)², with (Σx)²/nᵢ beside them; the pooled central
moment is Σᵢ[Σ(x − x̄ᵢ)² + (Σx)²/nᵢ] − (Σx)²/n, the reference's
Σx² − (Σx)²/n regrouped. On one shard the last two terms cancel exactly,
so a one-shard mesh keeps the unsharded engine's two-pass standard error
to float32 rounding.

Shards run one after another, except where a program pools inside its
step loop (the SLV's bin statistics): `run_lockstep` runs those shards on
one thread each, and a `StepPool` pools each step through `pool_shards`.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mcos_tpu_torch.engine.pricer import (_control, _cv_payoffs,
                                          _payoff_table, seeded_generator)
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels, simulate
from mcos_tpu_torch.ops.bs import bs_price

_M64 = (1 << 64) - 1


# ─────────────────────────────────────────────────────────────────────────────
# The mesh and its shards
# ─────────────────────────────────────────────────────────────────────────────
@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices (row-major over `dims`) with one name per axis; hashable."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if (not self.devices or len(self.axis_names) != len(self.dims)
                or int(np.prod(self.dims)) != len(self.devices)):
            raise ValueError(f"mesh of {len(self.devices)} devices cannot "
                             f"take axes {self.axis_names} x {self.dims}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_devices(self, axis_name: str) -> Tuple[torch.device, ...]:
        """The devices along `axis_name`, every other axis at index 0 (the
        other axes replicate a path-sharded program, as in shard_map)."""
        k = self.axis_names.index(axis_name)
        stride = int(np.prod(self.dims[k + 1:]))
        return tuple(self.devices[i * stride] for i in range(self.dims[k]))


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _mesh_devices(devices) -> Tuple[torch.device, ...]:
    devs = tuple(torch.device(d) for d in (
        _cuda_devices() if devices is None else devices))
    if not devs:
        raise RuntimeError("a mesh needs devices: make_mesh() takes every "
                           "CUDA device, and this process sees none")
    return devs


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "paths") -> Mesh:
    """1-D mesh over the given devices, else over every CUDA device."""
    devs = _mesh_devices(devices)
    return Mesh(devs, (axis_name,), (len(devs),))


def make_mesh_2d(batch: int, devices: Optional[Sequence] = None,
                 axis_names=("batch", "paths")) -> Mesh:
    """2-D mesh: contract/strike batch axis × path axis."""
    devs = _mesh_devices(devices)
    if batch < 1 or len(devs) % batch:
        raise ValueError(f"{len(devs)} devices do not split into {batch} "
                         "batch rows")
    return Mesh(devs, tuple(axis_names), (int(batch), len(devs) // batch))


def shard_seed(seed: int, index: int) -> int:
    """Seed of shard `index`: the caller's own for shard 0, else a
    SplitMix64 mix of (seed, index) cut to 63 bits. Never seed + index:
    engines already take seed + 1, seed + 2, ... for their other
    streams."""
    seed, index = int(seed), int(index)
    if index == 0:
        return seed
    x = (seed * 0x9E3779B97F4A7C15 + index * 0xD1B54A32D192ED03) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard of a sharded run, as its payoff function sees it."""

    index: int
    device: torch.device
    seed: int
    backend: str = "cuda"
    draws: Any = None       # replayed draws for the twin (tests), or None

    def generator(self) -> torch.Generator:
        return seeded_generator(self.seed, self.device)


def _kernel_shard(shard: Shard) -> bool:
    """Whether the shard runs its program's kernel (backend "cuda") rather
    than the step-loop twin. A kernel keys on the shard's seed and reads
    no draws, so replayed draws there are an error."""
    if shard.backend != "cuda":
        return False
    if shard.draws is not None:
        raise ValueError("shard_draws replays the twins' draws: "
                         "backend='torch'")
    return True


def _on(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_on(y, device) for y in x)
    return x


def mesh_shards(mesh: Mesh, seed: int, *, axis_name: str = "paths",
                backend: str = "cuda",
                shard_draws: Optional[Callable[[int], Any]] = None
                ) -> List[Shard]:
    """The shards of `mesh` along `axis_name`. `shard_draws(i)` gives
    shard i's draws, moved to its device, for the twin to replay (a
    kernel keys on the shard's seed and reads none)."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend: {backend!r}")
    return [Shard(i, dev, shard_seed(seed, i), backend,
                  None if shard_draws is None else _on(shard_draws(i), dev))
            for i, dev in enumerate(mesh.axis_devices(axis_name))]


# ─────────────────────────────────────────────────────────────────────────────
# Moments and THE pooling
# ─────────────────────────────────────────────────────────────────────────────
#: Keys pooled as a max across shards (a summed max would report ~n_dev×
#: the true value and fire the variance-explosion guard); every other key
#: pools as a sum.
MAX_KEYS = frozenset({"v_max"})


def pool_shards(stats: Sequence[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """Pool the shards' moment dicts: each key summed in shard order (a
    max for `MAX_KEYS`) on shard 0's device. Every sharded driver pools
    through this function and nothing else."""
    stats = list(stats)
    device = next(iter(stats[0].values())).device
    out = {}
    for key in stats[0]:
        acc = stats[0][key].to(device)
        for s in stats[1:]:
            part = s[key].to(device)
            acc = torch.maximum(acc, part) if key in MAX_KEYS else acc + part
        out[key] = acc
    return out


def _second(sums: Dict[str, torch.Tensor], tag: str, x: torch.Tensor,
            y: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
            n: torch.Tensor) -> None:
    """Σ(x − x̄)(y − ȳ) over the last axis as m2{tag}, with Σx·Σy/n as
    sq{tag} (the term that regroups shards' central moments)."""
    sums[f"m2{tag}"] = torch.sum((x - (sx / n)[..., None])
                                 * (y - (sy / n)[..., None]), dim=-1)
    sums[f"sq{tag}"] = sx * sy / n


def shard_moments(out) -> Dict[str, torch.Tensor]:
    """One shard's moment dict from a payoff function's output: ``eff``
    (last axis = the shard's paths; leading axes, e.g. strikes, ride
    along) or ``(eff, ctrl, aux)``, where ``ctrl`` (or None) adds the
    optimal-β control variate's cross moments and ``aux`` holds extra
    per-shard scalars (`v_max` pools as a max, the rest as sums)."""
    eff, ctrl, aux = out if isinstance(out, tuple) else (out, None, {})
    n = torch.tensor(float(eff.shape[-1]), dtype=torch.float32,
                     device=eff.device)
    sums = {"n": n}
    if ctrl is None:
        s = torch.sum(eff, dim=-1)
        sums["sum"] = s
        _second(sums, "", eff, eff, s, s, n)
    else:
        sp, sc = torch.sum(eff, dim=-1), torch.sum(ctrl, dim=-1)
        sums.update(sum_p=sp, sum_c=sc)
        _second(sums, "_p", eff, eff, sp, sp, n)
        _second(sums, "_c", ctrl, ctrl, sc, sc, n)
        _second(sums, "_pc", eff, ctrl, sp, sc, n)
    sums.update(aux)
    return sums


def _central(stats: Dict[str, torch.Tensor], tag: str, sx: str,
             sy: str) -> torch.Tensor:
    """Pooled Σ(x − x̄)(y − ȳ): the shards' central sums plus their
    between-shard term; 0 exactly on one shard."""
    return stats[f"m2{tag}"] + (stats[f"sq{tag}"]
                                - stats[sx] * stats[sy] / stats["n"])


def sharded_moments(payoff_fn, seed: int, args, *, mesh: Mesh, statics=(),
                    axis_name: str = "paths", backend: str = "cuda",
                    shard_draws: Optional[Callable[[int], Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Pool `payoff_fn`'s per-shard payoffs into global moments.

    `payoff_fn(shard, *args, **dict(statics))` runs once per shard (a
    `Shard`: device, seed, backend, replayed draws) and returns what
    `shard_moments` takes. Returns the pooled dict (`pool_shards`) on
    shard 0's device; `pool_moments` prices it."""
    fn = partial(payoff_fn, **dict(statics)) if statics else payoff_fn
    shards = mesh_shards(mesh, seed, axis_name=axis_name, backend=backend,
                         shard_draws=shard_draws)
    return pool_shards([shard_moments(fn(shard, *args)) for shard in shards])


def _pooled_cv_price(stats: Dict[str, torch.Tensor], ctrl_exact):
    """(mean, stderr, β|None) from pooled (n, Σp, Σc and the central
    second moments) with the optimal-β control variate computed on the
    POOLED sample: the single-device `_cv_adjust` estimator
    (engine/exotics.py) reassembled from sums."""
    n = stats["n"]
    mean_p = stats["sum_p"] / n
    var_p = torch.clamp(_central(stats, "_p", "sum_p", "sum_p") / n, min=0.0)
    if ctrl_exact is None:
        return mean_p, torch.sqrt(var_p / n), None
    ctrl_exact = torch.as_tensor(ctrl_exact, dtype=torch.float32,
                                 device=n.device)
    mean_c = stats["sum_c"] / n
    var_c = torch.clamp(_central(stats, "_c", "sum_c", "sum_c") / n, min=0.0)
    cov = _central(stats, "_pc", "sum_p", "sum_c") / n
    beta = torch.where(var_c > 1e-12, cov / torch.clamp(var_c, min=1e-12),
                       torch.zeros_like(var_c))
    mean_adj = mean_p - beta * (mean_c - ctrl_exact)
    # var(p − βc) at β* = var_p − cov²/var_c = var_p − β·cov
    var_adj = torch.clamp(var_p - beta * cov, min=0.0)
    return mean_adj, torch.sqrt(var_adj / n), beta


def pool_moments(stats: Dict[str, torch.Tensor], discount=1.0,
                 ctrl_exact=None) -> Dict[str, torch.Tensor]:
    """Pooled sums → price/std_error: the single-device estimator
    reassembled. With control-variate cross moments present,
    ``ctrl_exact`` is the control's exact expectation in undiscounted
    payoff units (`_pooled_cv_price`)."""
    out = {"num_paths_used": stats["n"]}
    if "sum_c" in stats:
        mean, se, beta = _pooled_cv_price(stats, ctrl_exact)
        out["cv_beta"] = beta
    else:
        n = stats["n"]
        mean = stats["sum"] / n
        var = torch.clamp(_central(stats, "", "sum", "sum") / n, min=0.0)
        se = torch.sqrt(var / n)
    out["price"] = discount * mean
    out["std_error"] = discount * se
    if "v_max" in stats:
        out["v_max"] = stats["v_max"]
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Lockstep shards (programs that pool inside their step loop)
# ─────────────────────────────────────────────────────────────────────────────
class StepPool:
    """In-process all-reduce of one tensor per step across the threads of
    a lockstep run: a shard's call blocks until every shard has given its
    tensor for the step, then returns their `pool_shards` sum on the
    caller's device. Every shard calls it once a step, in the same order.
    """

    def __init__(self, n_shards: int, timeout: float = 600.0):
        self._slots: List[Optional[torch.Tensor]] = [None] * n_shards
        self._barrier = threading.Barrier(n_shards, timeout=timeout)

    def __call__(self, index: int, x: torch.Tensor) -> torch.Tensor:
        self._slots[index] = x
        self._barrier.wait()
        pooled = pool_shards([{"x": s} for s in self._slots])["x"]
        self._barrier.wait()     # every shard has read before a refill
        return pooled.to(x.device)

    def abort(self) -> None:
        self._barrier.abort()


def run_lockstep(fn, shards: Sequence[Shard]) -> list:
    """`fn(shard, pool)` on one thread per shard, `pool(x)` the shard's
    all-reduce of a step's tensor; results in shard order. A shard that
    raises breaks the barrier so the others stop waiting, and its error
    is raised here."""
    step_pool = StepPool(len(shards))

    def work(shard):
        try:
            return fn(shard, partial(step_pool, shard.index))
        except BaseException:
            step_pool.abort()
            raise

    with ThreadPoolExecutor(max_workers=len(shards),
                            thread_name_prefix="shard") as pool:
        futures = [pool.submit(work, shard) for shard in shards]
        errors = [f.exception() for f in futures]
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return [f.result() for f in futures]


# ─────────────────────────────────────────────────────────────────────────────
# European and exotic drivers
# ─────────────────────────────────────────────────────────────────────────────
def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _local_price_stats(shard: Shard, params: SVJParams, spot, strikes, T, *,
                       paths_per_device, num_steps, is_call, antithetic,
                       control_variate, cv_mode, scheme="euler"):
    """One shard of `sharded_price`: K3 (Euler) or K4 (QE) keyed on the
    shard's seed, or the twin; the β = 1 companion-CV effective payoffs of
    `pricer._finalize_price`, (K, paths), with the guards' diagnostics."""
    device = shard.device
    want_g = control_variate and cv_mode == "companion"
    kw = dict(num_paths=paths_per_device, num_steps=num_steps,
              antithetic=antithetic, companion=want_g, device=device)
    if _kernel_shard(shard):
        sim = (cuda_kernels.svj_terminal_qe if scheme == "qe"
               else cuda_kernels.svj_terminal)
        s_final, v_final, g_final = sim(params, spot, T, shard.seed, **kw)
    else:
        sim = (simulate.simulate_terminal_qe if scheme == "qe"
               else simulate.simulate_terminal)
        s_final, v_final, g_final = sim(params, spot, T, shard.generator(),
                                        draws=shard.draws, **kw)
    return beta_one_payoffs(params, spot, strikes, T, s_final, v_final,
                            g_final, is_call=is_call,
                            control_variate=control_variate, cv_mode=cv_mode)


def _guards(s_final: torch.Tensor, v_final: torch.Tensor):
    """A shard's guard diagnostics: its largest terminal variance (pooled
    as a max) and its count of spots that are not finite."""
    return {"v_max": torch.max(v_final),
            "nonfinite": torch.sum(~torch.isfinite(s_final)).to(
                torch.float32)}


def beta_one_payoffs(params, spot, strikes, T, s_final, v_final, g_final, *,
                     is_call: bool, control_variate: bool,
                     cv_mode: str = "companion"):
    """(K, paths) effective payoffs of (branch, paths) terminals with the
    β = 1 control folded in, by `pricer._finalize_price`'s own `_control`
    and `_cv_payoffs`, and the guards' diagnostics: what `sharded_price`
    and `families.sharded_td_price` pool."""
    device = s_final.device
    strikes = torch.atleast_1d(_f32(strikes, device))
    pay = _payoff_table(s_final, strikes, is_call)
    if control_variate:
        ctrl, bs_ref = _control(params, spot, strikes, T, s_final, g_final,
                                is_call, cv_mode)
        pay = _cv_payoffs(pay, ctrl, bs_ref,
                          torch.exp(-params.r * _f32(T, device)),
                          torch.ones_like(bs_ref))
    return pay, None, _guards(s_final, v_final)


def sharded_price(
    params: SVJParams,
    spot,
    strikes,
    T,
    seed: int,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    antithetic: bool = True,
    control_variate: bool = True,
    cv_mode: str = "companion",
    scheme: str = "euler",
    axis_name: str = "paths",
    backend: str = "cuda",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Mesh-sharded European pricing; the estimator of `mc_price_cuda`.

    `num_paths` is the global path count, split evenly over the
    `axis_name` axis (rounded up to a multiple of it). shard_draws: the
    twin's (z, u) for shard i (backend "torch")."""
    if scheme not in ("euler", "qe"):
        raise ValueError(f"unknown scheme: {scheme!r}")
    n_dev = mesh.shape[axis_name]
    stats = sharded_moments(
        _local_price_stats, seed, (params, spot, strikes, T), mesh=mesh,
        axis_name=axis_name, backend=backend, shard_draws=shard_draws,
        statics=(("paths_per_device", -(-int(num_paths) // n_dev)),
                 ("num_steps", num_steps), ("is_call", is_call),
                 ("antithetic", antithetic),
                 ("control_variate", control_variate),
                 ("cv_mode", cv_mode), ("scheme", scheme)))
    device = stats["n"].device
    out = pool_moments(stats, torch.exp(-params.r * _f32(T, device)))
    # nonfinite counts every simulated terminal spot (both antithetic
    # branches): a fraction of spots, as mc_price_cuda reports it.
    out["frac_nonfinite"] = stats["nonfinite"] / (
        (2.0 if antithetic else 1.0) * stats["n"])
    if control_variate:
        out["bs_ref"] = bs_price(
            spot, torch.atleast_1d(_f32(strikes, device)), T, params.r,
            params.q, torch.sqrt(_f32(params.v0, device)), is_call,
            device=device)
    return out


def sharded_exotic_price(
    params: SVJParams,
    spot,
    strike,
    T,
    seed: int,
    barrier=0.0,
    *,
    mesh: Mesh,
    kind: str,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    averaging: str = "arithmetic",
    knock: str = "out",
    direction: str = "up",
    floating: bool = False,
    one_touch: bool = False,
    control_variate: bool = True,
    axis_name: str = "paths",
    monitoring: str = "discrete",
    bridge_ctrl_exact: float = 0.0,
    barrier_lo=0.0,
    rebate=0.0,
    window=None,
    backend: str = "cuda",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Mesh-sharded exotic pricing (Asian/barrier/lookback/double-barrier,
    and kind="digital").

    Each shard takes its path statistics from kernel K6 keyed on its seed
    (backend "cuda") or from the twin `ops/exotics.simulate_path_stats`
    (backend "torch"; `shard_draws(i)` its (z, u)); the payoff/control
    algebra is the single-device engine's `exotic_payoff_and_control`,
    and the optimal-β control variate comes from the pooled moments: the
    single-device estimator on the union sample. kind="digital" prices
    the cash-or-nothing digital of `ExoticEngine.price_digital` at
    `strike` on K3's terminal spots (the Euler twin's with backend
    "torch"), without a control."""
    from mcos_tpu_torch.engine.exotics import exotic_payoff_and_control
    from mcos_tpu_torch.ops import exotics as ops_exotics

    ppd = -(-int(num_paths) // mesh.shape[axis_name])
    held = {}

    def digital(shard: Shard):
        kw = dict(num_paths=ppd, num_steps=num_steps, antithetic=True,
                  companion=False, device=shard.device)
        if _kernel_shard(shard):
            s_final, _, _ = cuda_kernels.svj_terminal(params, spot, T,
                                                      shard.seed, **kw)
        else:
            s_final, _, _ = simulate.simulate_terminal(
                params, spot, T, shard.generator(), draws=shard.draws, **kw)
        k = _f32(strike, shard.device)
        hit = (s_final > k) if is_call else (s_final < k)
        return simulate.combine_antithetic(hit.to(torch.float32))

    def local(shard: Shard):
        if kind == "digital":
            return digital(shard)
        device = shard.device
        sim = dict(num_paths=ppd, num_steps=num_steps, antithetic=True,
                   companion=control_variate,
                   bridge=(monitoring == "bridge"),
                   bridge_up=(direction == "up"),
                   corridor=(kind == "double_barrier"
                             and monitoring == "bridge"), window=window)
        if _kernel_shard(shard):
            f = np.float32
            with np.errstate(all="ignore"):
                log_b, log_l = (np.log(np.maximum(f(x), f(1e-30)) / f(spot))
                                for x in (barrier, barrier_lo))
            stats = cuda_kernels.svj_path_stats(
                params, spot, T, shard.seed, bridge_log_b=log_b,
                bridge_log_l=log_l, device=device, **sim)
        else:
            spot_t = _f32(spot, device)
            stats = ops_exotics.simulate_path_stats(
                params, spot_t, T, shard.generator(),
                bridge_log_b=torch.log(torch.clamp(
                    _f32(barrier, device), min=1e-30) / spot_t),
                bridge_log_l=torch.log(torch.clamp(
                    _f32(barrier_lo, device), min=1e-30) / spot_t),
                draws=shard.draws, device=device, **sim)
        pay_b, ctrl_b, ctrl_exact = exotic_payoff_and_control(
            stats, params, spot, strike, T, barrier, kind=kind,
            num_steps=num_steps, is_call=is_call, averaging=averaging,
            knock=knock, direction=direction, floating=floating,
            one_touch=one_touch, control_variate=control_variate,
            monitoring=monitoring, bridge_ctrl_exact=bridge_ctrl_exact,
            barrier_lo=barrier_lo, rebate=rebate)
        held.setdefault("ctrl_exact", ctrl_exact)   # the same on every shard
        pay = simulate.combine_antithetic(pay_b)
        if ctrl_b is None:
            return pay, None, {}
        return pay, simulate.combine_antithetic(ctrl_b), {}

    stats = sharded_moments(local, seed, (), mesh=mesh, axis_name=axis_name,
                            backend=backend, shard_draws=shard_draws)
    device = stats["n"].device
    discount = torch.exp(-params.r * _f32(T, device))
    pooled = pool_moments(stats, discount,
                          ctrl_exact=held.get("ctrl_exact"))
    out = {"price": pooled["price"], "std_error": pooled["std_error"],
           "num_paths_used": stats["n"]}
    if pooled.get("cv_beta") is not None:
        out["cv_beta"] = pooled["cv_beta"]
    return out
