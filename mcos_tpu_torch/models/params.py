"""Model parameters of the port (counterpart of `mcos_tpu/models/params.py`).

`SVJParams` and `SVCJParams` are frozen dataclasses of plain floats. The JAX
package's versions are pytrees whose leaves may be traced arrays; here the
engine turns the floats into float32 constants where it launches work, so
the classes themselves stay free of torch and of device state. The one
exception is autograd: the Greeks engine (`engine/greeks.py`) puts float32
tensor leaves into the fields it differentiates, and the SVJ twins
(`ops/simulate.py`) take the tensor path for those fields only.
`TermStructureSVJ` is the host-side container of maturity curves.

Carrying a model across packages: `to_numpy()` gives a `{field: float64}`
dict and `from_numpy(d)` rebuilds from one. The tests build the JAX class,
turn it into numpy and build the port's from that, so both packages price
the same model.
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

# Field order of to_array/from_array: the optimizer layout (the Heston core,
# then the jumps), as in the JAX package.
_ARRAY_FIELDS = ("kappa", "theta", "xi", "rho", "v0", "lambda_j", "mu_j",
                 "sigma_j")


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

    def to_array(self):
        """The 8-element optimizer layout (`_ARRAY_FIELDS`), a (8,) float32
        CPU tensor."""
        import torch

        return torch.tensor([float(getattr(self, f)) for f in _ARRAY_FIELDS],
                            dtype=torch.float32)

    @classmethod
    def from_array(cls, arr, r: float = RISK_FREE_RATE,
                   q: float = DIVIDEND_YIELD) -> "SVJParams":
        """Rebuild from the optimizer layout, with the market's r and q."""
        return cls(r=r, q=q, **{f: float(arr[i])
                                for i, f in enumerate(_ARRAY_FIELDS)})

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


@dataclasses.dataclass(frozen=True)
class SVCJParams:
    """SVCJ (Duffie-Pan-Singleton 2000): contemporaneous jumps in price and
    variance, correlated through the variance jump size.

    Dynamics:
        dS/S = (r − q − λ k̄) dt + √v dW₁ + (e^{Z_s} − 1) dN
        dv   = κ(θ − v) dt + ξ √v dW₂ + Z_v dN
        Z_v ~ Exp(μ_v),  Z_s | Z_v ~ N(μ_j + ρ_J Z_v, σ_j²)
        k̄ = E[e^{Z_s}] − 1 = e^{μ_j + σ_j²/2} / (1 − ρ_J μ_v) − 1

    One Poisson clock drives both jumps. Requires ρ_J μ_v < 1 for the
    compensator to exist.
    """

    kappa: float = 3.0
    theta: float = 0.04
    xi: float = 0.5
    rho: float = -0.7
    v0: float = 0.04
    lambda_j: float = 1.0
    mu_j: float = -0.05
    sigma_j: float = 0.10
    mu_v: float = 0.05        # mean variance jump  E[Z_v]
    rho_j: float = -0.5       # jump-size correlation loading  (Z_s on Z_v)
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    @property
    def jump_compensation(self) -> float:
        """k̄ = E[e^{Z_s} − 1], in float32 as the device computes it."""
        f = np.float32
        num = np.exp(f(self.mu_j) + f(0.5) * f(self.sigma_j) ** 2)
        return float(num / (f(1.0) - f(self.rho_j) * f(self.mu_v)) - f(1.0))

    @property
    def stationary_variance(self) -> float:
        """E[v_∞] = θ + λ μ_v / κ: variance jumps raise the long-run mean."""
        return self.theta + self.lambda_j * self.mu_v / self.kappa

    def svj_part(self) -> SVJParams:
        """The μ_v → 0 projection (drops variance jumps; Bates limit)."""
        return SVJParams(kappa=self.kappa, theta=self.theta, xi=self.xi,
                         rho=self.rho, v0=self.v0, lambda_j=self.lambda_j,
                         mu_j=self.mu_j, sigma_j=self.sigma_j,
                         r=self.r, q=self.q)

    def replace(self, **updates) -> "SVCJParams":
        return dataclasses.replace(self, **updates)

    def validate(self) -> List[str]:
        warnings = self.svj_part().validate()
        if float(self.rho_j) * float(self.mu_v) >= 1.0:
            warnings.append(
                f"ρ_J·μ_v={float(self.rho_j) * float(self.mu_v):.3f} ≥ 1: "
                "jump compensator diverges")
        if float(self.mu_v) < 0.0:
            warnings.append(f"μ_v={float(self.mu_v):.4f} < 0: variance jump "
                            "mean must be non-negative")
        return warnings

    def as_dict(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """{field: 0-d float64 array}, the form parameters cross packages in."""
        return {name: np.asarray(value, np.float64)
                for name, value in self.as_dict().items()}

    @classmethod
    def from_numpy(cls, values: Mapping[str, object]) -> "SVCJParams":
        """Build from a {field: number or 0-d array} mapping (every field)."""
        names = [f.name for f in dataclasses.fields(cls)]
        missing = [n for n in names if n not in values]
        if missing:
            raise KeyError(f"missing SVCJ fields: {missing}")
        return cls(**{n: float(np.asarray(values[n])) for n in names})


def gbm_params(sigma: float, r: float = RISK_FREE_RATE,
               q: float = DIVIDEND_YIELD) -> SVJParams:
    """Degenerate SVJ that reduces exactly to GBM with volatility `sigma`
    (v0 = θ = σ², ξ = 0, λ = 0)."""
    var = sigma * sigma
    return SVJParams(kappa=0.0, theta=var, xi=0.0, rho=0.0, v0=var,
                     lambda_j=0.0, mu_j=0.0, sigma_j=0.0, r=r, q=q)


def _stack_params(params_list) -> SVJParams:
    """One `SVJParams` whose every field is the (A,) float32 array of the
    A sets' values, in order: the asset axis of the multi-asset engines
    (the JAX package stacks the pytree leaves with `jnp.stack`)."""
    return SVJParams(**{
        f.name: np.asarray([getattr(p, f.name) for p in params_list],
                           np.float32)
        for f in dataclasses.fields(SVJParams)})


def forward_price(spot, r, q, T):
    """Forward price F = S₀·e^{(r−q)T} for float r, q and T; a tensor spot
    gives a tensor, differentiable in it."""
    return spot * float(np.exp((r - q) * T))


_TS_SCALARS = ("kappa", "rho", "mu_j", "sigma_j", "v0", "r", "q")
_TS_CURVES = ("theta_curve", "xi_curve", "lambda_curve")


@dataclasses.dataclass
class TermStructureSVJ:
    """Maturity-dependent SVJ parameters θ(T), ξ(T), λ(T) with fixed κ, ρ,
    μ_J, σ_J. Host-side container: the curves are piecewise-linear in T;
    `get_params_at_maturity` gives the per-maturity `SVJParams`."""

    kappa: float = 3.0
    rho: float = -0.7
    mu_j: float = -0.05
    sigma_j: float = 0.10
    v0: float = 0.04
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD

    theta_curve: Dict[float, float] = dataclasses.field(default_factory=dict)
    xi_curve: Dict[float, float] = dataclasses.field(default_factory=dict)
    lambda_curve: Dict[float, float] = dataclasses.field(default_factory=dict)

    def get_params_at_maturity(self, T: float) -> SVJParams:
        theta = self._interp(self.theta_curve, T, default=0.04)
        xi = self._interp(self.xi_curve, T, default=0.5)
        lambda_j = self._interp(self.lambda_curve, T, default=1.0)
        return SVJParams(
            kappa=self.kappa, theta=theta, xi=xi, rho=self.rho, v0=self.v0,
            lambda_j=lambda_j, mu_j=self.mu_j, sigma_j=self.sigma_j,
            r=self.r, q=self.q,
        )

    @staticmethod
    def _interp(curve: Dict[float, float], T: float, default: float) -> float:
        """Piecewise-linear interpolation with flat extrapolation."""
        if not curve:
            return default
        mats = sorted(curve.keys())
        vals = [curve[m] for m in mats]
        if T <= mats[0]:
            return vals[0]
        if T >= mats[-1]:
            return vals[-1]
        idx = int(np.searchsorted(mats, T) - 1)
        w = (T - mats[idx]) / (mats[idx + 1] - mats[idx])
        return vals[idx] * (1 - w) + vals[idx + 1] * w

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """{scalar field: 0-d float64 array, curve: (n, 2) float64 array of
        (maturity, value) rows sorted by maturity}."""
        out = {n: np.asarray(getattr(self, n), np.float64)
               for n in _TS_SCALARS}
        for n in _TS_CURVES:
            curve = getattr(self, n)
            out[n] = np.asarray([(m, curve[m]) for m in sorted(curve)],
                                np.float64).reshape(-1, 2)
        return out

    @classmethod
    def from_numpy(cls, values: Mapping[str, object]) -> "TermStructureSVJ":
        """Build from the mapping `to_numpy` gives (every field)."""
        missing = [n for n in _TS_SCALARS + _TS_CURVES if n not in values]
        if missing:
            raise KeyError(f"missing term-structure fields: {missing}")
        kw = {n: float(np.asarray(values[n])) for n in _TS_SCALARS}
        for n in _TS_CURVES:
            rows = np.asarray(values[n], np.float64).reshape(-1, 2)
            kw[n] = {float(m): float(v) for m, v in rows}
        return cls(**kw)


def extract_forward_variance(atm_iv: float, T_shortest: float) -> float:
    """v₀ ≈ σ²_ATM(T_min): the surface-consistent initial variance."""
    del T_shortest  # kept for signature parity; the heuristic uses the IV
    return atm_iv**2


def build_term_structure_from_surface(
    maturities: np.ndarray,
    atm_ivs: np.ndarray,
    skew_slopes: np.ndarray,
    base_params: SVJParams,
) -> TermStructureSVJ:
    """Bootstrap a term structure from observed surface data (host
    float64, the JAX package's heuristics):
      θ(T) = ATM_IV(T)², ξ(T) = ξ·min(3, 1/√T), λ(T) = λ·max(1, |skew|/0.03).
    """
    ts = TermStructureSVJ(
        kappa=float(base_params.kappa), rho=float(base_params.rho),
        mu_j=float(base_params.mu_j), sigma_j=float(base_params.sigma_j),
        v0=extract_forward_variance(float(atm_ivs[0]), float(maturities[0])),
        r=float(base_params.r), q=float(base_params.q),
    )
    for i, T in enumerate(maturities):
        ts.theta_curve[float(T)] = float(atm_ivs[i] ** 2)
        xi_scale = min(3.0, 1.0 / np.sqrt(max(float(T), 1 / 252)))
        ts.xi_curve[float(T)] = float(base_params.xi) * xi_scale
        skew_scale = max(1.0, abs(float(skew_slopes[i])) / 0.03)
        ts.lambda_curve[float(T)] = float(base_params.lambda_j) * skew_scale
    return ts
