"""Model-risk report: one contract, every model family, one table
(counterpart of `mcos_tpu/engine/modelrisk.py`).

The question a desk actually asks before quoting something illiquid:
"how much of this price is model choice?" This report prices the SAME
European contract under each model family the framework carries —

    bs          flat-vol Black-Scholes (closed form)
    heston      Heston core, jumps off (COS, semi-analytic)
    svj         full SVJ = Heston + Merton jumps (COS, semi-analytic)
    vg          Variance Gamma pure-jump Levy (COS, semi-analytic)
    rough       rough Bergomi (conditional-Black MC)
    hhw         Heston-Hull-White (3-factor MC, stochastic rates)

— all anchored to the same ATM vol level (v0 = theta = xi_fwd = sigma²,
so every model agrees on the at-the-money variance budget and the spread
isolates *dynamics*: skew from leverage, tails from jumps, short-dated
curvature from roughness, long-dated variance from rates). Each price is
inverted back to a Black-Scholes IV so the band reads in vol points.

Where it runs: bs, heston, svj and vg on the host (the COS legs in
float64); rough on `RoughBergomiEngine(num_steps=64)`, whose exact sampler
is a matmul (no kernel at 64 steps); hhw on `HHWEngine(num_steps=96)`, one
K7 launch with backend="cuda" (`cuda_kernels.hhw_terminal`: the kernel on
a CUDA device, its plain version on the CPU) or the step-loop twin on a
generator with backend="torch".
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mcos_tpu_torch.engine.hhw import HHWEngine
from mcos_tpu_torch.engine.rough import RoughBergomiEngine
from mcos_tpu_torch.engine.surface import implied_vol
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.bs import bs_price
from mcos_tpu_torch.ops.cos_pricer import cos_price, heston_price
from mcos_tpu_torch.ops.hhw import HHWParams
from mcos_tpu_torch.ops.levy import VGParams, vg_cos_price
from mcos_tpu_torch.ops.rough import RoughBergomiParams


def model_risk_report(spot: float, strike: float, T: float,
                      is_call: bool = True,
                      atm_vol: float = 0.2,
                      r: float = 0.065, q: float = 0.012,
                      svj: Optional[SVJParams] = None,
                      num_paths: int = 65_536,
                      seed: int = 7, *, backend: str = "cuda",
                      device="cuda") -> Dict[str, object]:
    """Price one European contract under every model family.

    `svj` optionally supplies calibrated SVJ parameters; the other models
    inherit its vol level (sqrt(v0)) so the comparison stays anchored.
    The two Monte Carlo legs run on `device` with `backend`.
    """
    if svj is None:
        v0 = atm_vol ** 2
        svj = SVJParams(kappa=3.0, theta=v0, xi=0.5, rho=-0.7, v0=v0,
                        lambda_j=1.0, mu_j=-0.05, sigma_j=0.10, r=r, q=q)
    else:
        r, q = float(svj.r), float(svj.q)
        atm_vol = float(np.sqrt(float(svj.v0)))
    v0 = atm_vol ** 2

    prices: Dict[str, float] = {}
    prices["bs"] = float(bs_price(spot, strike, T, r, q, atm_vol, is_call))

    heston = svj.replace(lambda_j=0.0, mu_j=0.0, sigma_j=1e-4)
    prices["heston"] = float(heston_price(heston, spot, [strike], T,
                                          is_call)[0])
    prices["svj"] = float(cos_price(svj, spot, [strike], T, is_call)[0])

    # VG anchored to the same total variance: sigma² + nu·theta² = v0.
    vg_theta = -0.14
    vg_nu = 0.2
    vg_sigma = float(np.sqrt(max(v0 - vg_nu * vg_theta**2, 1e-6)))
    prices["vg"] = float(vg_cos_price(
        VGParams(sigma=vg_sigma, nu=vg_nu, theta=vg_theta, r=r, q=q),
        spot, [strike], T, is_call)[0])

    rough = RoughBergomiEngine(
        RoughBergomiParams(xi=v0, eta=1.9, rho=-0.9, r=r, q=q, hurst=0.07),
        num_paths=num_paths, num_steps=64, seed=seed, backend=backend,
        device=device)
    r_res = rough.price(spot, strike, T, is_call=is_call)
    prices["rough"] = float(r_res["price"])

    hw = HHWEngine(HHWParams(kappa=float(svj.kappa),
                             theta=float(svj.theta), xi=float(svj.xi),
                             v0=v0, a=0.1, b=r, sigma_r=0.01, r0=r,
                             rho_sv=float(svj.rho), rho_sr=0.3, q=q),
                   num_paths=num_paths, num_steps=96, seed=seed,
                   backend=backend, device=device)
    h_res = hw.price(spot, strike, T, is_call)
    prices["hhw"] = float(h_res["price"])

    ivs = {name: implied_vol(px, spot, strike, T, r, q, is_call)
           for name, px in prices.items()}
    valid_ivs = {k: v for k, v in ivs.items() if v is not None}
    band_vol = (max(valid_ivs.values()) - min(valid_ivs.values())
                if len(valid_ivs) >= 2 else float("nan"))
    vals = list(prices.values())
    return {
        "prices": prices,
        "implied_vols": ivs,
        "model_risk_band_price": float(max(vals) - min(vals)),
        "model_risk_band_volpts": float(band_vol),
        "anchor_atm_vol": atm_vol,
        "mc_std_errors": {"rough": float(r_res["std_error"]),
                          "hhw": float(h_res["std_error"])},
    }
