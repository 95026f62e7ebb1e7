"""Device-mesh parallelism of the port: path-sharded Monte Carlo with pooled
moment sums (counterpart of `mcos_tpu/parallel/mesh.py`, slices N1 and N2).

The JAX package runs one controller over many devices: `shard_map` gives
each device a key folded by its index and `psum` pools the moment sums
over the interconnect. The port's counterpart runs a process's shards in
that process, and meets other processes only where it pools:

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
  price and standard error;
- on a mesh across processes (`parallel/distributed.py:global_mesh`,
  `Mesh.ranks`) a process runs its own rank's shards, and `gather_shards`
  brings every rank's items (one `all_gather_object`) before the same
  sum, so every rank gets the bits one process holding every shard gets.

Moments stay float32 sums. Each shard adds its second moments about its
own mean, Σ(x − x̄ᵢ)², with (Σx)²/nᵢ beside them; the pooled central
moment is Σᵢ[Σ(x − x̄ᵢ)² + (Σx)²/nᵢ] − (Σx)²/n, the reference's
Σx² − (Σx)²/n regrouped. On one shard the last two terms cancel exactly,
so a one-shard mesh keeps the unsharded engine's two-pass standard error
to float32 rounding.

Shards run one after another, except where a program pools inside its
step loop (the SLV's bin statistics, the LSM's regressions): `run_lockstep`
runs those shards on one thread each, and a `StepPool` pools each step
through `pool_shards`.

Slice N2 adds the programs whose pooling is their own: the sharded Sobol
default (a slice of one net a shard), Greeks through the pooled sums,
the LSM, MLMC levels, exact-tail gathers (VaR, exposure), the basket
bracket, the PDE chain by contract, and a DE population split.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
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
    #: The process-group rank that runs each device, non-decreasing along
    #: the one axis (`parallel/distributed.py:global_mesh`), or None: this
    #: process runs every device.
    ranks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if (not self.devices or len(self.axis_names) != len(self.dims)
                or int(np.prod(self.dims)) != len(self.devices)):
            raise ValueError(f"mesh of {len(self.devices)} devices cannot "
                             f"take axes {self.axis_names} x {self.dims}")
        if self.ranks is not None and (
                len(self.dims) != 1 or len(self.ranks) != len(self.devices)
                or list(self.ranks) != sorted(self.ranks)):
            raise ValueError("a mesh across processes is 1-D, with one "
                             "rank a device in rank order")

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
    """`x` (a tensor, or tuples, lists and dicts of them) on `device`,
    out of any autograd graph."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_on(y, device) for y in x)
    if isinstance(x, dict):
        return {k: _on(y, device) for k, y in x.items()}
    return x


def _rank() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh across processes needs the process group "
                           "(parallel/distributed.py:initialize)")
    return dist.get_rank()


def mesh_shards(mesh: Mesh, seed: int, *, axis_name: str = "paths",
                backend: str = "cuda",
                shard_draws: Optional[Callable[[int], Any]] = None
                ) -> List[Shard]:
    """The shards of `mesh` along `axis_name`. `shard_draws(i)` gives
    shard i's draws, moved to its device, for the twin to replay (a
    kernel keys on the shard's seed and reads none)."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend: {backend!r}")
    positions = list(enumerate(mesh.axis_devices(axis_name)))
    if mesh.ranks is not None:      # a process runs its own rank's shards
        me = _rank()
        positions = [(i, dev) for (i, dev), rank in zip(positions, mesh.ranks)
                     if rank == me]
    return [Shard(i, dev, shard_seed(seed, i), backend,
                  None if shard_draws is None else _on(shard_draws(i), dev))
            for i, dev in positions]


# ─────────────────────────────────────────────────────────────────────────────
# Moments and THE pooling
# ─────────────────────────────────────────────────────────────────────────────
#: Keys pooled as a max across shards (a summed max would report ~n_dev×
#: the true value and fire the variance-explosion guard); every other key
#: pools as a sum.
MAX_KEYS = frozenset({"v_max"})


#: Collectives this process has issued (`gather_shards` across processes)
#: and the seconds they took, staging through the host included.
COLLECTIVES = {"calls": 0, "seconds": 0.0}


def gather_shards(items: Sequence[Any], mesh: Optional[Mesh] = None
                  ) -> List[Any]:
    """Every shard's item in global shard order. `items` are this process's
    shards' items, in their order (`mesh_shards`). On a mesh across
    processes (`Mesh.ranks`) one `all_gather_object` brings every rank's
    list, staged through the host, and this process's own items stay as
    they were (live tensors, on their devices); otherwise `items` is every
    shard already."""
    items = list(items)
    if mesh is None or mesh.ranks is None:
        return items
    import torch.distributed as dist

    t0 = time.perf_counter()
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, [_on(x, "cpu") for x in items])
    parts[dist.get_rank()] = items
    COLLECTIVES["calls"] += 1
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    return [x for part in parts for x in part]


def _first_device(items) -> torch.device:
    """The device of this process's first shard item (where it pools), or
    the CPU for a process that holds none."""
    for x in items:
        for t in (x.values() if isinstance(x, dict) else [x]):
            if isinstance(t, torch.Tensor):
                return t.device
    return torch.device("cpu")


def pool_shards(stats: Sequence[Dict[str, torch.Tensor]],
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Pool the shards' moment dicts: each key summed in global shard order
    (a max for `MAX_KEYS`) on the device of this process's first shard
    (shard 0's in one process). `stats` are this process's shards' dicts;
    on a mesh across processes `gather_shards` brings the others', so
    every rank sums the same values in the same order and gets the same
    bits as one process holding every shard. Every sharded driver pools
    through this function and nothing else."""
    stats = list(stats)
    device = _first_device(stats)
    stats = gather_shards(stats, mesh)
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
    return pool_shards([shard_moments(fn(shard, *args)) for shard in shards],
                       mesh)


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
    """All-reduce of one tensor per step across the threads of a lockstep
    run: a shard's call blocks until every local shard has given its
    tensor for the step, then returns their `pool_shards` sum on the
    caller's device. The last thread to arrive pools, so a process issues
    one collective a step on a mesh across processes. Every shard calls it
    once a step, in the same order; `slot` is its position among this
    process's shards."""

    def __init__(self, n_shards: int, timeout: float = 600.0,
                 mesh: Optional[Mesh] = None):
        self._slots: List[Optional[torch.Tensor]] = [None] * n_shards
        self._mesh = mesh
        self._pooled: Optional[torch.Tensor] = None
        # A step's pooled tensor is replaced only when every thread has
        # come back with the next step's, so each has read it by then.
        self._barrier = threading.Barrier(n_shards, action=self._pool,
                                          timeout=timeout)

    def _pool(self) -> None:
        self._pooled = pool_shards([{"x": s} for s in self._slots],
                                   self._mesh)["x"]

    def __call__(self, slot: int, x: torch.Tensor) -> torch.Tensor:
        self._slots[slot] = x
        self._barrier.wait()
        return self._pooled.to(x.device)

    def abort(self) -> None:
        self._barrier.abort()


def run_lockstep(fn, shards: Sequence[Shard],
                 mesh: Optional[Mesh] = None) -> list:
    """`fn(shard, pool)` on one thread per shard, `pool(x)` the shard's
    all-reduce of a step's tensor (across processes on such a `mesh`);
    results in shard order. A shard that raises breaks the barrier so the
    others stop waiting, and its error is raised here."""
    step_pool = StepPool(len(shards), mesh=mesh)

    def work(slot, shard):
        try:
            return fn(shard, partial(step_pool, slot))
        except BaseException:
            step_pool.abort()
            raise

    with ThreadPoolExecutor(max_workers=len(shards),
                            thread_name_prefix="shard") as pool:
        futures = [pool.submit(work, slot, shard)
                   for slot, shard in enumerate(shards)]
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


# ─────────────────────────────────────────────────────────────────────────────
# Slice N2: the programs whose pooling is their own
# ─────────────────────────────────────────────────────────────────────────────
def _ppd(mesh: Mesh, num_paths: int, axis_name: str) -> int:
    return -(-int(num_paths) // mesh.shape[axis_name])


def _host_moments(stats: Dict[str, torch.Tensor]) -> Tuple[float, float,
                                                           float]:
    """(mean, standard error, n) on the host from pooled (n, sum, central
    second moments)."""
    host = pool_moments(stats)
    return (float(host["price"].reshape(-1)[0]),
            float(host["std_error"].reshape(-1)[0]),
            float(stats["n"]))


# Shard slices of the Sobol net, apart from the engine's whole nets
# (`pricer._SOBOL_DRAWS_CACHE`, which hold a net's first num_paths points,
# not the 2^m points the shards split): serving re-hits the same few
# (seed, net, slice, steps, device) shapes, and a slice costs tens of
# times the K1 launch that reads it. Each slot holds 3 (steps, ppd)
# float32 tensors on its device (~99 MB at 2^19 / 4 × 63). Guarded for
# the threaded HTTP server.
_SHARD_DRAWS_CACHE: "OrderedDict" = OrderedDict()
_SHARD_DRAWS_CACHE_MAX = 16
_SHARD_DRAWS_LOCK = threading.Lock()


def _sobol_shard_draws(ppd: int, n_global: int, offset: int, steps: int,
                       seed: int, scramble: str, device: torch.device):
    """`sobol_svj_draws_slice` through the shard-slice cache."""
    from mcos_tpu_torch.ops.sobol import sobol_svj_draws_slice

    key = (seed, n_global, offset, ppd, steps, scramble, str(device))
    with _SHARD_DRAWS_LOCK:
        hit = _SHARD_DRAWS_CACHE.get(key)
        if hit is not None:
            _SHARD_DRAWS_CACHE.move_to_end(key)
            return hit
    draws = sobol_svj_draws_slice(ppd, n_global, offset, steps, seed=seed,
                                  scramble=scramble, device=device)
    with _SHARD_DRAWS_LOCK:
        _SHARD_DRAWS_CACHE[key] = draws
        while len(_SHARD_DRAWS_CACHE) > _SHARD_DRAWS_CACHE_MAX:
            _SHARD_DRAWS_CACHE.popitem(last=False)
    return draws


def sharded_sobol_price(
    params: SVJParams,
    spot,
    strikes,
    T,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    seed: int = 42,
    is_call: bool = True,
    control_variate: bool = True,
    scramble: str = "owen",
    axis_name: str = "paths",
    backend: str = "cuda",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Mesh-sharded scrambled-Sobol pricing: the serving default (Euler,
    antithetic, β = 1 companion control) past one device.

    ONE Owen-scrambled net of 2^m ≥ num_paths points is split by index:
    shard i takes points [i·ppd, (i+1)·ppd) (`sobol_svj_draws_slice`), so
    the shards' union is the unsharded engine's net and the estimator
    keeps its QMC convergence. Each shard runs one K1 launch on its slice
    (backend "cuda"; the plain version on a CPU shard) with the jump
    uniforms drawn in the kernel from the shard's seed, as the unsharded
    `u_jump=None` route draws them, so a one-shard mesh at num_paths = 2^m
    prices the unsharded engine's paths. backend "torch" runs the Euler
    twin on the same uniforms (`philox_jump_uniforms`), or on the shard's
    replayed (steps, ppd) jump uniforms (`shard_draws(i)`, tests). The
    slices are cached in `_SHARD_DRAWS_CACHE`, never in the engine's
    `_SOBOL_DRAWS_CACHE`."""
    from mcos_tpu_torch.engine.pricer import _euler_twin_pair

    n_dev = mesh.shape[axis_name]
    m = int(np.ceil(np.log2(max(int(num_paths), 2))))
    n_global = 2 ** m
    if n_global % n_dev:
        raise ValueError(f"2^{m} Sobol points do not split over {n_dev} "
                         "devices: use a power-of-two device count")
    ppd = n_global // n_dev

    def local(shard: Shard):
        z1, z2, _, z_js = _sobol_shard_draws(
            ppd, n_global, shard.index * ppd, num_steps, seed, scramble,
            shard.device)
        if _kernel_shard(shard):
            s_f, v_f, g_f = cuda_kernels.svj_terminal_from_draws(
                params, spot, T, z1, z2, None, z_js, seed=shard.seed,
                antithetic=True, companion=control_variate, steps_major=True)
        else:
            u_jump = (shard.draws if shard.draws is not None else
                      cuda_kernels.philox_jump_uniforms(
                          num_steps, ppd, shard.seed, shard.device))
            s_f, v_f, g_f = _euler_twin_pair(params, spot, T, z1, z2, u_jump,
                                             z_js, True, control_variate,
                                             True)
        return beta_one_payoffs(params, spot, strikes, T, s_f, v_f, g_f,
                                is_call=is_call,
                                control_variate=control_variate)

    stats = sharded_moments(local, seed, (), mesh=mesh, axis_name=axis_name,
                            backend=backend, shard_draws=shard_draws)
    device = stats["n"].device
    out = pool_moments(stats, torch.exp(-params.r * _f32(T, device)))
    out["frac_nonfinite"] = stats["nonfinite"] / (2.0 * stats["n"])
    if control_variate:
        out["bs_ref"] = bs_price(
            spot, torch.atleast_1d(_f32(strikes, device)), T, params.r,
            params.q, torch.sqrt(_f32(params.v0, device)), is_call,
            device=device)
    return out


def _rank_sum(mesh: Optional[Mesh], tensors: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of a mesh across processes, in rank
    order (the transpose of the forward gather); as given otherwise."""
    if mesh is None or mesh.ranks is None:
        return tensors
    device = tensors[0].device
    parts = gather_shards([torch.stack(tensors)], mesh)   # one a rank
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return list(total)


def sharded_all_greeks(
    params: SVJParams,
    spot,
    strike,
    T,
    seed: int,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    bump: float = 0.01,
    lambda_bump: float = 0.1,
    axis_name: str = "paths",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, float]:
    """All Greeks with the path simulation sharded over the mesh.

    Each shard builds its moment sums of the β = 1 companion-CV payoffs
    on the Euler twin under autograd (K3 has no backward kernel), on its
    generator's (z, u) or its replayed ones (`shard_draws(i)`, the
    GreeksEngine layout (steps, 3, ppd), (steps, ppd)); the price is a
    function of the pooled sums, P = e^(−rT)·Σsum/n. In one process
    autograd runs through `pool_shards` (`.to(device)` is
    differentiable). Across processes the other ranks' sums arrive
    detached, so the gradient splits in two: ∂P through this rank's own
    sums (the discount held fixed), summed over the ranks (the chain rule
    that the reference's psum transpose applies), plus the discount's own
    term (−T·P for r, −r·P for T), taken once.
    Gamma is the central difference of the sharded AD delta at
    spot·(1 ± bump); ∂P/∂λ a forward difference at λ ± lambda_bump (the
    jump indicator has no pathwise derivative), both on the same draws."""
    from mcos_tpu_torch.ops.simulate import _euler_draws

    fields = [f.name for f in dataclasses.fields(SVJParams)]
    ppd = _ppd(mesh, num_paths, axis_name)
    shards = mesh_shards(mesh, seed, axis_name=axis_name, backend="torch",
                         shard_draws=shard_draws)
    draws = [_euler_draws(s.draws, None if s.draws is not None
                          else s.generator(), ppd, num_steps, s.device)
             for s in shards]
    home = shards[0].device if shards else torch.device("cpu")
    strikes = [strike]

    def scalar_price(pp: Dict[str, torch.Tensor], spot_t, T_t):
        parts = []
        for shard, dr in zip(shards, draws):
            dev = shard.device
            p_dev = SVJParams(**{n: pp[n].to(dev) for n in fields})
            spot_d, T_d = spot_t.to(dev), T_t.to(dev)
            s_f, v_f, g_f = simulate.simulate_terminal(
                p_dev, spot_d, T_d, None, ppd, num_steps, antithetic=True,
                companion=True, draws=dr, device=dev)
            parts.append(shard_moments(beta_one_payoffs(
                p_dev, spot_d, strikes, T_d, s_f, v_f, g_f, is_call=is_call,
                control_variate=True)))
        stats = pool_shards(parts, mesh)
        dev = stats["n"].device
        disc = torch.exp(-pp["r"].to(dev) * T_t.to(dev))
        return disc, (stats["sum"] / stats["n"])[0]

    def leaf(x):
        return torch.tensor(float(x), dtype=torch.float32, device=home,
                            requires_grad=True)

    def grad(out, inputs):
        got = torch.autograd.grad(out, inputs, allow_unused=True)
        return [torch.zeros((), device=home) if g is None else g.to(home)
                for g in got]

    def grads(disc, mean, inputs):
        """∂(disc·mean)/∂inputs: through the pooled mean (this rank's sums)
        summed over the ranks, plus the discount's term once."""
        through_sums = _rank_sum(mesh, grad(disc.detach() * mean, inputs))
        if not disc.requires_grad:
            return through_sums
        direct = grad(disc * mean.detach(), inputs)
        return [a + b for a, b in zip(through_sums, direct)]

    base = {n: float(getattr(params, n)) for n in fields}
    with torch.enable_grad():
        pp = {n: leaf(base[n]) for n in fields}
        spot_t, T_t = leaf(spot), leaf(T)
        disc, mean = scalar_price(pp, spot_t, T_t)
        price = disc * mean
        g = grads(disc, mean, [spot_t, T_t] + [pp[n] for n in fields])
        d_spot, d_T, d_params = g[0], g[1], dict(zip(fields, g[2:]))
        fixed = {n: torch.tensor(base[n], dtype=torch.float32, device=home)
                 for n in fields}
        T_f = torch.tensor(float(T), dtype=torch.float32, device=home)
        d_bumped = []
        for rel in (1.0 + bump, 1.0 - bump):
            s_b = leaf(np.float32(spot) * np.float32(rel))
            d_bumped.append(grads(*scalar_price(fixed, s_b, T_f), [s_b])[0])
    spot_f = float(np.float32(spot))
    gamma = (float(d_bumped[0]) - float(d_bumped[1])) / (
        2.0 * spot_f * bump)
    with torch.no_grad():
        lam = base["lambda_j"]
        lam_up, lam_dn = lam + lambda_bump, max(lam - lambda_bump, 0.0)
        spot_c = torch.tensor(spot_f, device=home)
        p_up, p_dn = (float(torch.mul(*scalar_price(dict(
            fixed, lambda_j=torch.tensor(x, dtype=torch.float32,
                                         device=home)), spot_c, T_f)))
            for x in (lam_up, lam_dn))
    lam_fd = (p_up - p_dn) / max(lam_up - lam_dn, 1e-12)
    d = {n: float(v) for n, v in d_params.items()}
    sigma = float(np.sqrt(float(params.v0)))
    return {
        "price": float(price.detach()),
        "delta": float(d_spot),
        "gamma": gamma,
        "vega_per_vol_point": d["v0"] * 2.0 * sigma,
        "ad_vega_v0": d["v0"],
        "theta_daily": -float(d_T),    # the reference's key convention
        "rho": d["r"],
        "lambda_j": lam_fd,
        "mu_j": d["mu_j"],
        "sigma_j": d["sigma_j"],
        "kappa": d["kappa"],
        "theta": d["theta"],
        "xi": d["xi"],
        "rho_corr": d["rho"],
        "num_devices": int(mesh.shape[axis_name]),
    }


def _american_shard_cashflows(shard: Shard, pool, params: SVJParams, spot,
                             strike, T, *, num_paths: int, num_steps: int,
                             is_call: bool, basis_degree: int,
                             exercise_every: int) -> torch.Tensor:
    """One shard of `sharded_american_price`: its (num_paths,) cashflows
    discounted to t₀, the regression blocks pooled through `pool` (a
    lockstep `StepPool` call; the identity for one shard)."""
    from mcos_tpu_torch.engine.american import (_basis_fn, _exercise_mask,
                                                _payoff_fn, _record_log_paths,
                                                _step_dfs,
                                                lsm_backward_cashflows)

    dev = shard.device
    strike_t = _f32(strike, dev)
    payoff = _payoff_fn(strike_t, is_call)
    basis = _basis_fn(strike_t, is_call, basis_degree)
    s = torch.exp(_record_log_paths(
        params, spot, T, None if shard.draws is not None
        else shard.generator(), num_paths=num_paths, num_steps=num_steps,
        draws=shard.draws, device=dev))
    sdf = _step_dfs(params, T, num_steps, None, dev)
    return lsm_backward_cashflows(
        payoff(s[-1]), s, s, _exercise_mask(num_steps, exercise_every), sdf,
        payoff, basis, pool=pool)


def sharded_american_price(
    params: SVJParams,
    spot,
    strike,
    T,
    seed: int,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    is_call: bool = True,
    basis_degree: int = 3,
    exercise_every: int = 1,
    axis_name: str = "paths",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, float]:
    """Mesh-sharded Longstaff-Schwartz American pricing.

    Each shard records its own sheet (its generator's (z, u), the
    `AmericanEngine._draws` layout, or `shard_draws(i)`), and the
    continuation regression of every exercise date pools its stacked
    ``[gram | rhs]`` block (`lsm_backward_cashflows`' `pool=` hook) through
    a lockstep `StepPool`: the normal equations are sums over paths, so
    every shard solves the regression one device would fit on the union
    of the paths, then stops its own paths by it
    (`_american_shard_cashflows`). The cashflows pool as (n, Σ, central
    Σ²). The t₀ intrinsic floor applies only to the American schedule
    (exercise_every == 1)."""
    every = min(int(exercise_every), int(num_steps))
    fn = partial(_american_shard_cashflows, params=params, spot=spot,
                 strike=strike, T=T,
                 num_paths=_ppd(mesh, num_paths, axis_name),
                 num_steps=num_steps, is_call=is_call,
                 basis_degree=basis_degree, exercise_every=every)
    cfs = run_lockstep(fn, mesh_shards(mesh, seed, axis_name=axis_name,
                                       backend="torch",
                                       shard_draws=shard_draws), mesh)
    stats = pool_shards([shard_moments(cf[None]) for cf in cfs], mesh)
    mean, se, n = _host_moments(stats)
    intrinsic = (max(spot - strike, 0.0) if is_call
                 else max(strike - spot, 0.0))
    return {
        "price": max(mean, intrinsic) if every == 1 else mean,
        "std_error": se,
        "mc_continuation": mean,
        "intrinsic": intrinsic,
        "num_paths_used": n,
        "num_devices": int(mesh.shape[axis_name]),
    }


def _mlmc_level_sums(shard: Shard, params, spot, strike, T, *, ppd, level,
                     base_steps, is_call, draws):
    """One shard of an MLMC level: (n, Σ, Σ²) of its ppd correction pairs,
    from the level's own program on the shard's generator or draws."""
    from mcos_tpu_torch.engine.mlmc import _coupled_level, _level_zero

    gen = None if draws is not None else shard.generator()
    if level == 0:
        m, m2 = _level_zero(params, spot, strike, T, gen, num_paths=ppd,
                            num_steps=base_steps, is_call=is_call,
                            draws=draws, device=shard.device)
    else:
        m, m2 = _coupled_level(params, spot, strike, T, gen, num_paths=ppd,
                               num_coarse_steps=base_steps * 2 ** (level - 1),
                               is_call=is_call, draws=draws,
                               device=shard.device)
    n = torch.tensor(float(ppd), dtype=torch.float32, device=m.device)
    return {"n": n, "sum": m * n, "sumsq": m2 * n}


def sharded_mlmc_price(
    params: SVJParams,
    spot,
    strike,
    T,
    *,
    mesh: Mesh,
    is_call: bool = True,
    eps: float = 0.05,
    base_steps: int = 4,
    max_levels: int = 8,
    pilot_paths: int = 8_192,
    max_paths_per_level: int = 4_000_000,
    seed: int = 0,
    axis_name: str = "paths",
    shard_draws: Optional[Callable[[int, int, int], Any]] = None,
) -> Dict[str, object]:
    """Mesh-sharded multilevel Monte Carlo: `engine/mlmc.py:giles_driver`
    unchanged, with a `run_level` whose shards each run n/n_dev coupled
    pairs and pool (n, Σ, Σ²) through `pool_shards`. A level's path count
    rounds to a power of two ≥ 256·n_dev; its seed is the unsharded
    engine's (`_level_seed` of the reference's tag level·1000 + n % 997),
    and its shard i takes `shard_seed` of it, so a one-shard mesh is
    `mlmc_price`. `shard_draws(level, n, i)` gives shard i's replayed
    level draws (tests)."""
    from mcos_tpu_torch.engine.mlmc import _level_seed, giles_driver

    n_dev = mesh.shape[axis_name]

    def run_level(level: int, n: int):
        n = int(min(max(n, 256 * n_dev), max_paths_per_level))
        n = 1 << int(np.ceil(np.log2(n)))
        ppd = max(n // n_dev, 1)
        shards = mesh_shards(mesh, _level_seed(seed, level * 1000 + n % 997),
                             axis_name=axis_name, backend="torch")
        parts = [_mlmc_level_sums(
            shard, params, spot, strike, T, ppd=ppd, level=level,
            base_steps=base_steps, is_call=is_call,
            draws=None if shard_draws is None else _on(
                shard_draws(level, n, shard.index), shard.device))
            for shard in shards]
        stats = pool_shards(parts, mesh)
        host = torch.stack([stats["n"], stats["sum"],
                            stats["sumsq"]]).cpu().tolist()
        return int(host[0]), host[1] / host[0], host[2] / host[0]

    out = giles_driver(run_level, eps=eps, base_steps=base_steps,
                       max_levels=max_levels, pilot_paths=pilot_paths)
    out["num_devices"] = int(n_dev)
    return out


def sharded_portfolio_returns(
    spots,
    sigmas,
    corr,
    weights,
    T,
    seed: int,
    *,
    mesh: Mesh,
    num_paths: int,
    num_steps: int,
    r: float,
    q: float,
    tail_quota: int,
    axis_name: str = "paths",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Correlated-GBM portfolio returns, path-sharded, with an exact tail.

    Each shard simulates ppd paths (`engine/risk.py:multi_asset_gbm_
    terminal` on its generator, or its replayed (steps, ppd, A) normals),
    sums the powers 1-4 of its portfolio returns and keeps its worst
    `quota = min(tail_quota, ppd)` returns. The global worst k ≤ quota
    returns are among the union of the shards' worst quota, which the
    shards gather in shard order. Returns n, sum1-sum4 (pooled on shard
    0's device) and `tail`, (n_dev·quota,)."""
    from mcos_tpu_torch.engine.risk import (_portfolio_returns,
                                            multi_asset_gbm_terminal)

    ppd = _ppd(mesh, num_paths, axis_name)
    quota = min(int(tail_quota), ppd)
    sums, tails = [], []
    for shard in mesh_shards(mesh, seed, axis_name=axis_name,
                             backend="torch", shard_draws=shard_draws):
        s_t = multi_asset_gbm_terminal(
            spots, sigmas, corr, r, q, T,
            None if shard.draws is not None else shard.generator(),
            num_paths=ppd, num_steps=num_steps, draws=shard.draws,
            device=shard.device)
        ret = _portfolio_returns(s_t, spots, weights)
        n = torch.tensor(float(ret.shape[0]), dtype=torch.float32,
                         device=ret.device)
        sums.append({"n": n, **{f"sum{k}": torch.mean(ret ** k) * n
                                for k in (1, 2, 3, 4)}})
        tails.append(-torch.topk(-ret, quota).values)
    out = pool_shards(sums, mesh)
    out["tail"] = torch.cat([t.to(out["n"].device)
                             for t in gather_shards(tails, mesh)])
    return out


def sharded_exposure_profile(
    engine,
    *,
    mesh: Mesh,
    num_dates: int = 32,
    horizon: Optional[float] = None,
    quantile: float = 0.975,
    num_paths: Optional[int] = None,
    axis_name: str = "paths",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, object]:
    """Mesh-sharded EE/ENE/PFE/EPE profile of an `ExposureEngine` book.

    Each shard runs the engine's date algebra (`engine/exposure.py:
    _exposure_values`) on ppd paths of its generator (the engine's
    `_date_normals` order) or of its replayed (dates, ppd, A) normals.
    EE, ENE and gross exposure pool as sums; PFE by the exact-tail union:
    each shard keeps its top quota = min(ppd, max(⌈1.6·k/n_dev⌉ + 64, 64))
    exposures a date, and the k-th largest of the gathered union is the
    global k-th order statistic whenever no shard holds more than quota of
    the top k (always when quota ≥ k). Uncollateralized, as the
    reference's; the keys of `ExposureEngine.profile`."""
    from mcos_tpu_torch.engine.exposure import _exposure_values

    mat = engine.pos_arrays[2]
    horizon = float(horizon or mat.max())
    n_dev = mesh.shape[axis_name]
    total = int(num_paths or engine.num_paths)
    ppd = -(-total // n_dev)
    k = max(int(np.ceil((1.0 - quantile) * ppd * n_dev)), 1)
    quota = int(min(ppd, max(np.ceil(1.6 * k / n_dev) + 64, 64)))
    dates = np.linspace(horizon / num_dates, horizon,
                        num_dates).astype(np.float32)
    kind, strike, mat_a, qty, asset = engine.pos_arrays
    n_assets = engine.spots.shape[0]
    sums, tails = [], []
    for shard in mesh_shards(mesh, engine.seed, axis_name=axis_name,
                             backend="torch", shard_draws=shard_draws):
        dev = shard.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        if shard.draws is not None:
            normals = shard.draws.__getitem__
        else:
            gen = shard.generator()
            normals = (lambda i, gen=gen, dev=dev: torch.randn(
                (ppd, n_assets), generator=gen, dtype=torch.float32,
                device=dev))
        with torch.no_grad():
            net, gross, _ = _exposure_values(
                t(engine.spots), t(engine.sigmas), t(engine.chol),
                float(np.float32(engine.r)), t(engine.q), t(dates), normals,
                t(kind, torch.int32), t(strike), t(mat_a), t(qty),
                t(asset, torch.int64), num_paths=ppd)
            pos = torch.clamp(net, min=0.0)
            n = torch.tensor(float(ppd), dtype=torch.float32, device=dev)
            sums.append({
                "n": n,
                "ee_sum": torch.mean(pos, dim=1) * n,
                "ene_sum": torch.mean(torch.clamp(-net, min=0.0), dim=1) * n,
                "gross_sum": torch.mean(torch.clamp(gross, min=0.0),
                                        dim=1) * n})
            tails.append(torch.topk(pos, quota, dim=1).values)
    stats = pool_shards(sums, mesh)
    tail = torch.cat([x.cpu() for x in gather_shards(tails, mesh)], dim=1)
    host = {key: v.cpu().numpy() for key, v in stats.items()}
    n = float(host["n"])
    ee, ene, gross_ee = (host[key] / n for key in ("ee_sum", "ene_sum",
                                                   "gross_sum"))
    tail = np.sort(tail.numpy(), axis=1)[:, ::-1]
    k_eff = min(max(int(np.ceil((1.0 - quantile) * n)), 1), tail.shape[1])
    pfe = tail[:, k_eff - 1]
    disc = np.exp(-engine.r * dates)
    return {
        "dates": dates.tolist(),
        "ee": ee.tolist(),
        "ene": ene.tolist(),
        "pfe": pfe.tolist(),
        "pfe_quantile": quantile,
        "gross_ee": gross_ee.tolist(),
        "epe": float(np.mean(disc * ee)),
        "ene_avg": float(np.mean(disc * ene)),
        "netting_benefit": float(np.mean(disc * (gross_ee - ee))),
        "num_paths_used": int(n),
        "num_devices": int(n_dev),
    }


def sharded_basket_bounds(
    engine,
    spots,
    strike,
    T,
    *,
    mesh: Mesh,
    kind: str = "max",
    is_call: bool = True,
    weights=None,
    n_ex: int = 9,
    steps_per_period: int = 1,
    n_outer: int = 2048,
    n_inner: int = 64,
    axis_name: str = "paths",
    shard_draws: Optional[Callable[[int], Any]] = None,
) -> Dict[str, float]:
    """Mesh-sharded Bermudan duality bracket (`price_bounds_basket` over a
    mesh).

    The regressions train ONCE on the engine's training sheet
    (`lsm_basket_train` on generator seed, the unsharded bracket's); what
    shards is the out-of-sample lower bound (`_lower_bound_pairs`, shard
    i on `shard_seed(seed + 1, i)`) and the Andersen-Broadie dual's nested
    inner simulations (`_dual_pairs` on the outer paths, shard i on
    `shard_seed(seed + 2, i)`), each pooling its (n, Σ, central Σ²) pair
    moments. `shard_draws(i)` gives shard i's replayed
    (lower-bound draws, (dual outer draws, dual inner draws)) (tests)."""
    from mcos_tpu_torch.engine.basket_american import (
        _check_kind, _dual_pairs, _lower_bound_pairs, _ma_payoff_fn,
        _prepare, lsm_basket_train)

    _check_kind(engine, kind, weights)
    n_dev = mesh.shape[axis_name]
    n_ex, spp = int(n_ex), int(steps_per_period)
    r_num = float(engine.params_list[0].r)
    static = dict(n_ex=n_ex, steps_per_period=spp, kind=kind,
                  is_call=is_call, weights=weights)
    args = (engine._batch, spots, engine._chol, strike, T, r_num)
    coefs = lsm_basket_train(*args, engine._generator(0),
                             num_paths=engine.num_paths,
                             draws=engine._draws(0, n_ex * spp),
                             device=engine.device, **static)
    ppd_lo = _ppd(mesh, engine.num_paths, axis_name)
    ppd_hi = max(_ppd(mesh, n_outer, axis_name), 2)
    n_inner = int(n_inner) - int(n_inner) % 2

    def draws_of(shard, part):
        return None if shard.draws is None else shard.draws[part]

    lo, hi = [], []
    for shard_lo, shard_hi in zip(
            mesh_shards(mesh, engine.seed + 1, axis_name=axis_name,
                        backend="torch", shard_draws=shard_draws),
            mesh_shards(mesh, engine.seed + 2, axis_name=axis_name,
                        backend="torch")):
        dev = shard_lo.device
        lo_draws = draws_of(shard_lo, 0)
        pair = _lower_bound_pairs(
            *args, None if lo_draws is not None else shard_lo.generator(),
            coefs["policy"].to(dev), num_paths=ppd_lo, draws=lo_draws,
            device=dev, **static)
        lo.append(shard_moments(pair[None]))
        hi_draws = draws_of(shard_lo, 1) or (None, None)
        pair = _dual_pairs(
            *args, None if hi_draws[0] is not None
            else shard_hi.generator(), coefs["value"].to(dev),
            n_outer=ppd_hi, n_inner=n_inner, draws=hi_draws[0],
            inner_draws=hi_draws[1], device=dev, **static)
        hi.append(shard_moments(pair[None]))
    lo_m, lo_se, _ = _host_moments(pool_shards(lo, mesh))
    hi_m, hi_se, n_hi = _host_moments(pool_shards(hi, mesh))
    spots_t, strike_t, w = _prepare(spots, strike, weights, engine.device)
    intrinsic = float(_ma_payoff_fn(strike_t, kind, is_call, w)(
        spots_t[:, None])[0])
    lower = max(lo_m, intrinsic)
    return {
        "lower_bound": lower,
        "lower_se": lo_se,
        "upper_bound": hi_m,
        "upper_se": hi_se,
        "duality_gap": hi_m - lower,
        "price": 0.5 * (lower + hi_m),
        "n_exercise": n_ex,
        "n_outer": int(n_hi),
        "n_inner": n_inner,
        "num_devices": int(n_dev),
    }


def sharded_pde_chain(
    engine,
    spot,
    contracts,
    *,
    mesh: Mesh,
    is_call: bool = True,
    american: bool = False,
    axis_name: str = "batch",
):
    """Mesh-sharded ADI solve of an option chain (`HestonPDEEngine.price`
    over a contract batch).

    Every (strike, T) contract's 2-D Heston/Bates solve is independent:
    the chain pads to a multiple of the mesh with its last contract, on
    the `axis_name` axis, and each shard solves its chunk one contract at
    a time through `engine/pde.py:_adi_heston_solve` at ONE resolution,
    the batch max of the engine's per-contract guards (`_resolution`,
    `_grids`). The solved (n_v, n_x) grids come back in contract order
    for the engine's own `_extract`. Returns one dict a contract (the
    keys of `engine.price`, with strike, T and num_devices)."""
    from mcos_tpu_torch.engine.pde import _adi_heston_solve

    contracts = [(float(k), float(t)) for k, t in contracts]
    if not contracts:
        return []
    n_dev = mesh.shape[axis_name]
    p = engine.params
    grids = [engine._grids(float(spot), k, t) for k, t in contracts]
    n_x = max(g[2] for g in grids)
    n_t = max(g[3] for g in grids)
    if any(g[2] != n_x for g in grids):   # widen coarser grids to n_x
        save = engine.n_x
        try:
            engine.n_x = n_x
            grids = [engine._grids(float(spot), k, t) for k, t in contracts]
        finally:
            engine.n_x = save
        n_t = max(n_t, max(g[3] for g in grids))
    pad = (-len(contracts)) % n_dev
    idx = list(range(len(contracts))) + [len(contracts) - 1] * pad
    per_dev = len(idx) // n_dev
    solved = []
    for shard in mesh_shards(mesh, 0, axis_name=axis_name, backend="torch"):
        chunk = []
        for i in idx[shard.index * per_dev:(shard.index + 1) * per_dev]:
            x, v = grids[i][0], grids[i][1]
            u, _ = _adi_heston_solve(
                contracts[i][0], contracts[i][1], p.r, p.q, p.kappa,
                p.theta, p.xi, p.rho, x, v, jump=engine._jump_tables(x),
                n_x=n_x, n_v=engine.n_v, n_t=n_t, is_call=is_call,
                american=american, scheme=engine.scheme,
                device=shard.device)
            chunk.append(u)
        solved.append(torch.stack(chunk))
    u_all = torch.cat([u.cpu() for u in gather_shards(solved, mesh)])
    out = []
    for i, (k, t) in enumerate(contracts):
        row = engine._extract(u_all[i], grids[i][0], grids[i][1],
                              float(spot), american, n_t)
        row["strike"], row["T"] = k, t
        row["num_devices"] = int(n_dev)
        out.append(row)
    return out


def sharded_population(obj_fn, pop: torch.Tensor, *, mesh: Mesh,
                       axis_name: str = "paths") -> torch.Tensor:
    """(P,) objective values of a (P, D) population split over the mesh:
    shard i evaluates rows [i·P/n, (i+1)·P/n), moved to its device, with
    `obj_fn` (which reads its data on the rows' device), and the values
    come back in member order on the population's device. P must be a
    multiple of the axis size (`differential_evolution` rounds it up)."""
    n_dev = mesh.shape[axis_name]
    if pop.shape[0] % n_dev:
        raise ValueError(f"{pop.shape[0]} members do not split over "
                         f"{n_dev} shards")
    per = pop.shape[0] // n_dev
    vals = [obj_fn(pop[s.index * per:(s.index + 1) * per].to(s.device))
            for s in mesh_shards(mesh, 0, axis_name=axis_name,
                                 backend="torch")]
    return torch.cat([v.to(pop.device) for v in gather_shards(vals, mesh)])
