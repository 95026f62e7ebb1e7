"""Model parameters of the port (counterpart of `mcos_tpu/models/params.py`).

`SVJParams` is a frozen dataclass of plain floats. The JAX package's version
is a pytree whose leaves may be traced arrays; here the engine turns the
floats into float32 constants where it launches work, so the class itself
stays free of torch and of device state.

Carrying a model across packages: `to_numpy()` gives a `{field: float64}`
dict and `SVJParams.from_numpy(d)` rebuilds from one. The tests build the
JAX `SVJParams`, turn it into numpy and build the port's from that, so both
packages price the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np

from mcos_tpu_torch.config import (
    DIVIDEND_YIELD,
    MAX_VARIANCE,
    RISK_FREE_RATE,
    check_feller,
)


@dataclasses.dataclass(frozen=True)
class SVJParams:
    """SVJ (Heston + Merton lognormal jumps) parameters, one maturity slice.

    Dynamics:
        dS = (r - q - λk) S dt + √v S dW₁ + S (e^J - 1) dN
        dv = κ(θ - v) dt + ξ √v dW₂,   dW₁·dW₂ = ρ dt
        J ~ N(μ_J, σ_J²),  k = E[e^J - 1]
    """

    # Heston core
    kappa: float = 3.0        # mean-reversion speed
    theta: float = 0.04       # long-run variance
    xi: float = 0.5           # vol-of-vol
    rho: float = -0.7         # spot-vol correlation
    v0: float = 0.04          # initial variance

    # Jump component
    lambda_j: float = 1.0     # jump intensity (events/year)
    mu_j: float = -0.05       # mean log jump size
    sigma_j: float = 0.10     # jump size std

    # Market
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def jump_compensation(self) -> float:
        """k = E[e^J - 1], in float32 as the device computes it."""
        arg = np.float32(self.mu_j + 0.5 * self.sigma_j**2)
        return float(np.exp(arg) - np.float32(1.0))

    @property
    def feller_satisfied(self) -> bool:
        """Feller condition 2κθ > ξ²."""
        return check_feller(float(self.kappa), float(self.theta),
                            float(self.xi))

    def replace(self, **updates) -> "SVJParams":
        return dataclasses.replace(self, **updates)

    def validate(self) -> List[str]:
        """Host-side validation warnings (same messages as the JAX package)."""
        warnings = []
        kappa, theta, xi = float(self.kappa), float(self.theta), float(self.xi)
        if not check_feller(kappa, theta, xi):
            warnings.append(
                f"Feller violated: 2κθ={2 * kappa * theta:.4f} ≤ ξ²={xi**2:.4f}"
            )
        if abs(float(self.rho)) > 0.999:
            warnings.append(f"|ρ|={abs(float(self.rho)):.4f} exceeds 0.999")
        if float(self.v0) > MAX_VARIANCE:
            warnings.append(
                f"v0={float(self.v0):.4f} exceeds MAX_VARIANCE={MAX_VARIANCE}")
        if float(self.theta) > MAX_VARIANCE:
            warnings.append(
                f"θ={float(self.theta):.4f} exceeds MAX_VARIANCE={MAX_VARIANCE}")
        return warnings

    def as_dict(self) -> Dict[str, float]:
        """Plain-float dict (for JSON serialization in the API layer)."""
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """{field: 0-d float64 array}, the form parameters cross packages in."""
        return {name: np.asarray(value, np.float64)
                for name, value in self.as_dict().items()}

    @classmethod
    def from_numpy(cls, values: Mapping[str, object]) -> "SVJParams":
        """Build from a {field: number or 0-d array} mapping (every field)."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = [n for n in names if n not in values]
        if missing:
            raise KeyError(f"missing SVJ fields: {missing}")
        return cls(**{n: float(np.asarray(values[n])) for n in names})


def gbm_params(sigma: float, r: float = RISK_FREE_RATE,
               q: float = DIVIDEND_YIELD) -> SVJParams:
    """Degenerate SVJ that reduces exactly to GBM with volatility `sigma`
    (v0 = θ = σ², ξ = 0, λ = 0)."""
    var = sigma * sigma
    return SVJParams(kappa=0.0, theta=var, xi=0.0, rho=0.0, v0=var,
                     lambda_j=0.0, mu_j=0.0, sigma_j=0.0, r=r, q=q)
