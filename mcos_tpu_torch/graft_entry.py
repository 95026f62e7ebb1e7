"""Driver entry points of the port (counterpart of the root
`__graft_entry__.py`): a one-device compile check and a multi-device dry
run.

- `entry()` returns the flagship pricing step with example arguments: the
  fused European price core (`engine/pricer.py:mc_price_cuda`, kernel K3:
  SVJ Monte Carlo with antithetic pairs and the companion control variate)
  over a strike chain, on the card unless the caller asks for the CPU.
- `dryrun_multichip(n)` builds a (batch × paths) mesh over n devices and
  runs ONE sharded calibration training step (strikes data-parallel, paths
  sharded with pooled sums, the gradient through the pooling, an Adam
  update), then every sharded driver once at tiny shapes. Devices may
  repeat: with one card it takes cuda:0 n times, on the CPU "cpu" n times.

    python -m mcos_tpu_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import argparse
from functools import partial

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args): the pricing step on the flagship model; call
    fn(*example_args)."""
    from mcos_tpu_torch.engine.pricer import mc_price_cuda
    from mcos_tpu_torch.models.params import SVJParams

    fn = partial(mc_price_cuda, num_paths=8192, num_steps=32, is_call=True,
                 antithetic=True, control_variate=True, cv_mode="companion",
                 device=device)
    params = SVJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
                       lambda_j=1.0, mu_j=-0.05, sigma_j=0.10)
    strikes = np.asarray([21000.0, 22500.0, 24000.0], np.float32)
    return fn, (params, 22500.0, strikes, 0.25, 0)


def _devices(n_devices: int, device: str):
    """n devices: distinct CUDA devices when there are enough, else the
    first one repeated; "cpu" n times for device="cpu"."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n_devices
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("dryrun_multichip on CUDA needs a CUDA device")
    if count >= n_devices:
        return [f"cuda:{i}" for i in range(n_devices)]
    return ["cuda:0"] * n_devices


def _finite(x, what: str) -> None:
    arr = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                     np.float64)
    if not np.all(np.isfinite(arr)):
        raise AssertionError(f"{what} not finite: {arr}")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One sharded calibration step over an n-device (batch × paths) mesh,
    then each sharded driver once at tiny shapes; every result checked
    finite. Returns {driver: a headline value}."""
    from mcos_tpu_torch.engine.autocallable import WorstOfAutocallableEngine
    from mcos_tpu_torch.engine.basket import BasketEngine
    from mcos_tpu_torch.engine.calibration import (
        HESTON_BOUNDS, _data_at, heston_objective,
        make_sharded_calibration_step)
    from mcos_tpu_torch.engine.exposure import ExposureEngine
    from mcos_tpu_torch.engine.localvol import LocalVolSurface
    from mcos_tpu_torch.engine.pde import HestonPDEEngine
    from mcos_tpu_torch.engine.pricer import MonteCarloEngine
    from mcos_tpu_torch.engine.risk import portfolio_var
    from mcos_tpu_torch.models.params import SVCJParams, SVJParams
    from mcos_tpu_torch.ops.hhw import HHWParams
    from mcos_tpu_torch.ops.levy import NIGParams, VGParams
    from mcos_tpu_torch.ops.rough import RoughBergomiParams
    from mcos_tpu_torch.ops.roughheston import RoughHestonParams
    from mcos_tpu_torch.parallel import families as pf
    from mcos_tpu_torch.parallel import mesh as pm
    from mcos_tpu_torch.utils.optim import differential_evolution

    devs = _devices(n_devices, device)
    batch = 2 if n_devices % 2 == 0 else 1
    out = {}

    # 1) The sharded calibration step.
    step_fn, init_fn = make_sharded_calibration_step(
        pm.make_mesh_2d(batch, devs), num_paths=512, num_steps=8, lr=0.05)
    u, opt_state = init_fn([3.0, 0.04, 0.5, -0.7, 0.04])
    u, opt_state, loss = step_fn(
        u, opt_state, 22500.0, np.linspace(21000.0, 24000.0, 4),
        0.25, [1600.0, 900.0, 400.0, 150.0], np.full(4, 0.25), 0)
    _finite(loss, "sharded calibration loss")
    out["calibration_step"] = float(loss)

    m = pm.make_mesh(devs)
    paths = n_devices * 256
    p = SVJParams()

    def record(name, value):
        _finite(value, name)
        out[name] = float(np.asarray(value.detach().cpu() if isinstance(
            value, torch.Tensor) else value).reshape(-1)[0])

    # 2) The moment-pooled European, exotic and family drivers.
    record("price", pm.sharded_price(p, 22500.0, [22500.0], 0.25, 1, mesh=m,
                                     num_paths=paths, num_steps=8)["price"])
    record("sobol", pm.sharded_sobol_price(
        p, 22500.0, [22500.0], 0.25, mesh=m, num_paths=paths,
        num_steps=8)["price"])
    record("exotic", pm.sharded_exotic_price(
        p, 100.0, 100.0, 0.25, 4, mesh=m, kind="asian", num_paths=paths,
        num_steps=8)["price"])
    record("corridor", pm.sharded_exotic_price(
        p, 100.0, 100.0, 0.25, 5, 125.0, mesh=m, kind="double_barrier",
        barrier_lo=85.0, monitoring="bridge", num_paths=paths, num_steps=8,
        window=(2, 6))["price"])
    record("rough", pf.sharded_rough_price(
        RoughBergomiParams(), 100.0, [100.0], 0.25, 2, mesh=m,
        num_paths=paths, num_steps=8)["price"])
    record("hhw", pf.sharded_hhw_price(
        HHWParams(), 100.0, [100.0], 0.25, 5, mesh=m, num_paths=paths,
        num_steps=8)["price"])
    surf = LocalVolSurface.from_iv_points(
        100.0, [100.0 * x for x in (0.8, 0.9, 1.0, 1.1, 1.2)], [0.25, 0.5],
        np.full((2, 5), 0.2), r=0.065, q=0.012)
    rows, t_mid = surf.step_tables(0.25, 8)
    record("slv", pf.sharded_slv_price(
        SVJParams(lambda_j=0.0), rows, t_mid, float(surf.y_grid[0]),
        float(surf.y_grid[1] - surf.y_grid[0]), 100.0, [100.0], 0.25, 6,
        mesh=m, num_paths=paths, num_steps=8)["price"])
    ones = np.ones(8, np.float32)
    record("td", pf.sharded_td_price(
        p, ones * 0.04, ones * 0.5, ones * 1.0, 22500.0, [22500.0], 0.25, 7,
        mesh=m, num_paths=paths, num_steps=8)["price"])
    beng = BasketEngine([SVJParams(), SVJParams()], [[1.0, 0.5], [0.5, 1.0]],
                        num_paths=paths, num_steps=32, device=devs[0])
    record("basket", pf.sharded_basket_price(
        beng, [100.0, 120.0], [0.5, 0.5], 110.0, 0.25, 9, mesh=m)["price"])
    record("svcj", pf.sharded_svcj_price(
        SVCJParams(), 100.0, [100.0], 0.25, 20, mesh=m, num_paths=paths,
        num_steps=8)["price"])
    for name, lp in (("vg", VGParams()), ("nig", NIGParams())):
        record(name, pf.sharded_levy_price(lp, 100.0, [100.0], 0.25, 21,
                                           mesh=m,
                                           num_paths=paths)["price"])
    record("roughheston", pf.sharded_roughheston_price(
        RoughHestonParams(), 100.0, [100.0], 0.25, 23, mesh=m,
        num_paths=n_devices * 128, num_steps=64, n_factors=8)["price"])
    record("localvol", pf.sharded_localvol_price(
        surf, 100.0, [100.0], 0.25, 24, mesh=m, num_paths=paths,
        num_steps=8)["price"])
    record("cliquet", pf.sharded_cliquet_price(
        p, 1.0, 25, mesh=m, num_paths=paths, n_periods=4,
        steps_per_period=2)["price"])
    record("quanto", pf.sharded_quanto_price(
        p, 0.03, 0.1, -0.3, 22500.0, 22500.0, 0.25, 26, mesh=m,
        num_paths=paths, num_steps=8)["price"])
    weng = WorstOfAutocallableEngine(
        [SVJParams(), SVJParams()], [[1.0, 0.5], [0.5, 1.0]],
        num_paths=paths, steps_per_period=2, device=devs[0])
    record("autocall", pf.sharded_worstof_autocall(weng, 1.0, 27, mesh=m,
                                                   n_obs=4)["price"])
    record("varswap", pf.sharded_variance_swap(
        p, 0.25, 28, mesh=m, num_paths=paths,
        num_steps=8)["mc_fair_variance"])

    # 3) The programs whose pooling is their own (slice N2).
    record("greeks_delta", pm.sharded_all_greeks(
        p, 22500.0, 22500.0, 0.25, 3, mesh=m, num_paths=paths,
        num_steps=8)["delta"])
    var = portfolio_var([100.0, 200.0], [0.2, 0.3],
                        np.array([[1.0, 0.3], [0.3, 1.0]]), [0.6, 0.4], 0.1,
                        num_paths=n_devices * 2048, num_steps=4, mesh=m,
                        device=devs[0])
    if var["num_devices"] != n_devices:
        raise AssertionError(f"sharded VaR on {var['num_devices']} devices")
    record("var", var["var"])
    record("american", pm.sharded_american_price(
        p, 100.0, 105.0, 0.25, 8, mesh=m, num_paths=paths, num_steps=8,
        is_call=False)["price"])
    bb = pm.sharded_basket_bounds(
        beng, [100.0, 120.0], 110.0, 0.25, mesh=m, kind="max", n_ex=3,
        steps_per_period=1, n_outer=n_devices * 16, n_inner=4)
    record("basket_bounds", bb["price"])
    record("mlmc", pm.sharded_mlmc_price(
        p, 100.0, 100.0, 0.25, mesh=m, eps=1.0, pilot_paths=256,
        max_levels=3)["price"])
    xeng = ExposureEngine(
        [100.0], [0.25], [[1.0]],
        [{"kind": "call", "strike": 100.0, "T": 0.5, "qty": 1.0}],
        num_paths=paths, seed=12, device=devs[0])
    record("exposure_epe", pm.sharded_exposure_profile(
        xeng, mesh=m, num_dates=4)["epe"])
    de_data = {"spot": 100.0, "T": 0.25, "r": 0.065, "q": 0.012,
               "strikes": torch.tensor([95.0, 100.0, 105.0]),
               "market_prices": torch.tensor([7.0, 4.0, 2.0]),
               "weights": torch.tensor([0.3, 0.4, 0.3])}
    gen = torch.Generator(device=devs[0])
    gen.manual_seed(13)
    z = torch.randn((3, 4, 512), generator=gen, device=devs[0])
    de_data["draws"] = (z[0], z[1], torch.rand((4, 512), generator=gen,
                                               device=devs[0]), z[2])
    at = _data_at(de_data)

    def objective(x):
        return heston_objective(x, at(x.device))

    gen.manual_seed(14)
    with torch.no_grad():
        de = differential_evolution(objective, HESTON_BOUNDS, gen,
                                    pop_size=n_devices * 2, iters=2, mesh=m)
    record("de_population", de.fun)
    rows_pde = pm.sharded_pde_chain(
        HestonPDEEngine(p, n_x=51, n_v=21, n_t=8, device=devs[0]), 22500.0,
        [(22000.0 + 250.0 * i, 0.25) for i in range(n_devices)],
        mesh=pm.make_mesh(devs, axis_name="batch"), is_call=True)
    record("pde_chain", rows_pde[0]["price"])

    # 4) The engines' mesh routes.
    record("auto_engine", MonteCarloEngine(
        p, num_paths=paths, num_steps=32, mesh=m, device=devs[0]).price(
            22500.0, 22500.0, 0.25)["price"])
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    fn, example = entry(args.device)
    res = fn(*example)
    print("entry():", {k: v.cpu().tolist() for k, v in res.items()
                       if v.dim() <= 1})
    print(f"dryrun_multichip({args.n}):", dryrun_multichip(args.n,
                                                           args.device))


if __name__ == "__main__":
    main()
