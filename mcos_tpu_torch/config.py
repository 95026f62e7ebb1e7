"""Copy of `mcos_tpu/config.py` (JAX-free), so the port never imports the
JAX package. tests/test_torch_copies.py holds the two equal.

Configuration substrate: market constants, parameter bounds, regime thresholds,
calibration settings, stress grids.

TPU-native re-design of the reference's constants module
(reference: engine/config.py:15-165). Everything here is a *static* Python value or a
frozen dataclass — values feed jit-compiled functions as compile-time constants or
ordinary traced scalars; nothing here carries device state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# ─────────────────────────────────────────────────────────────────────────────
# Market constants (NIFTY / Indian market; reference engine/config.py:15-18)
# ─────────────────────────────────────────────────────────────────────────────
RISK_FREE_RATE: float = 0.065        # ~6.5% RBI repo-linked
DIVIDEND_YIELD: float = 0.012        # ~1.2% NIFTY dividend yield
TRADING_DAYS_PER_YEAR: int = 252
MINUTES_PER_DAY: int = 375           # NSE session length

# ─────────────────────────────────────────────────────────────────────────────
# Monte Carlo defaults (reference engine/config.py:23-26)
# ─────────────────────────────────────────────────────────────────────────────
DEFAULT_NUM_PATHS: int = 500_000
DEFAULT_NUM_STEPS: int = 252         # per year; scaled by maturity at price time
DEFAULT_TOLERANCE: float = 0.001     # 0.1% of premium (stderr alert threshold)
MAX_PATHS: int = 2_000_000
MIN_STEPS: int = 10                  # floor on maturity-scaled step count

# TPU-specific: path counts are padded up to a multiple of this so path blocks
# tile cleanly onto (8, 128) fp32 vregs and Pallas path blocks.
PATH_ALIGNMENT: int = 1024

# ─────────────────────────────────────────────────────────────────────────────
# SVJ parameter bounds (reference engine/config.py:32-44)
# ─────────────────────────────────────────────────────────────────────────────
PARAM_BOUNDS: Dict[str, Tuple[float, float]] = {
    # Heston core
    "kappa":   (0.1,   15.0),
    "theta":   (0.005, 1.50),
    "xi":      (0.05,  3.00),
    "rho":     (-0.999, 0.0),
    "v0":      (0.005, 1.50),
    # Jump parameters
    "lambda_j": (0.0,  10.0),
    "mu_j":     (-0.20, 0.05),
    "sigma_j":  (0.01, 0.50),
}

# Term-structure bounds (reference engine/config.py:47-51)
TERM_STRUCTURE_BOUNDS: Dict[str, Tuple[float, float]] = {
    "theta_T":  (0.005, 2.00),
    "xi_T":     (0.05,  5.00),
    "lambda_T": (0.0,   20.0),
}

# ─────────────────────────────────────────────────────────────────────────────
# Tikhonov regularization weights (reference engine/config.py:56-60)
# ─────────────────────────────────────────────────────────────────────────────
REGULARIZATION: Dict[str, float] = {
    "xi":       0.01,
    "rho":      0.005,
    "lambda_j": 0.01,
}

# ─────────────────────────────────────────────────────────────────────────────
# SABR bounds (reference engine/config.py:65-71)
# ─────────────────────────────────────────────────────────────────────────────
SABR_BOUNDS: Dict[str, Tuple[float, float]] = {
    "alpha": (0.01, 5.0),
    "beta":  (0.5,  1.0),
    "rho":   (-0.999, 0.999),
    "nu":    (0.01, 5.0),
}
SABR_BETA_DEFAULT: float = 0.8

# ─────────────────────────────────────────────────────────────────────────────
# Stability guards (reference engine/config.py:76-80)
# ─────────────────────────────────────────────────────────────────────────────
MAX_VARIANCE: float = 10.0
MAX_CORRELATION: float = 0.999
VOL_OF_VOL_ALERT_THRESHOLD: float = 4.0
SAFE_STRIKE_RANGE: Tuple[float, float] = (0.70, 1.30)
JUMP_COMPENSATION_TOL: float = 1e-6

# ─────────────────────────────────────────────────────────────────────────────
# Regime detection thresholds (reference engine/config.py:85-101)
# ─────────────────────────────────────────────────────────────────────────────
@dataclasses.dataclass(frozen=True)
class RegimeThresholds:
    """Thresholds for CALM / EVENT / CRISIS classification."""
    calm_rvol_upper: float = 0.15
    event_rvol_upper: float = 0.30
    calm_iv_pctile_upper: float = 30.0
    event_iv_pctile_upper: float = 70.0
    calm_skew_upper: float = 0.03
    event_skew_upper: float = 0.08


REGIME_THRESHOLDS = RegimeThresholds()

# ─────────────────────────────────────────────────────────────────────────────
# Calibration configuration (reference engine/config.py:106-129)
# ─────────────────────────────────────────────────────────────────────────────
@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Two-stage calibration settings.

    Unlike the reference (derivative-free differential evolution with
    `workers=1`, engine/calibration.py:195-227), the TPU engine's inner loop is
    gradient-based (Adam over a sigmoid-reparameterized box), with a vmapped
    multi-start sweep replacing the DE population. These settings carry both.
    """
    # Stage 1: Heston core (ATM + near-money)
    stage1_moneyness_range: Tuple[float, float] = (0.95, 1.05)
    stage1_max_iter: int = 200

    # Stage 2: jumps (full strike range)
    stage2_moneyness_range: Tuple[float, float] = (0.80, 1.20)
    stage2_max_iter: int = 300

    # Gradient optimizer settings (TPU path)
    learning_rate: float = 0.05
    num_restarts: int = 8            # vmapped multi-start (replaces DE population)
    ftol: float = 1e-12
    gtol: float = 1e-8

    # Liquidity filtering
    min_open_interest: int = 100
    max_bid_ask_spread_pct: float = 0.10

    # Recalibration interval (seconds)
    recalib_interval: int = 300


CALIBRATION_CONFIG = CalibrationConfig()

# ─────────────────────────────────────────────────────────────────────────────
# Stress scenarios (reference engine/config.py:134-136)
# ─────────────────────────────────────────────────────────────────────────────
SPOT_SHOCKS = (-0.08, -0.05, -0.02, 0.02, 0.05, 0.08)
VOL_SHOCKS = (-0.05, 0.05)
JUMP_SCENARIO_SIZE = 0.04


# ─────────────────────────────────────────────────────────────────────────────
# Validation helpers (reference engine/config.py:141-165)
# ─────────────────────────────────────────────────────────────────────────────
def check_feller(kappa: float, theta: float, xi: float) -> bool:
    """Feller condition 2κθ > ξ² (variance process stays strictly positive)."""
    return 2.0 * kappa * theta > xi * xi


def _bounds_of(name: str):
    return PARAM_BOUNDS.get(name)


def check_params_in_bounds(params: Dict[str, float]) -> Dict[str, bool]:
    """{name: in-bounds?} for every parameter that has a PARAM_BOUNDS entry."""
    return {
        name: _bounds_of(name)[0] <= value <= _bounds_of(name)[1]
        for name, value in params.items() if _bounds_of(name) is not None
    }


def clamp_params(params: Dict[str, float]) -> Dict[str, float]:
    """Project each parameter onto its bound interval (unknown keys pass
    through untouched)."""
    def clip(name, value):
        b = _bounds_of(name)
        return value if b is None else min(max(value, b[0]), b[1])

    return {name: clip(name, value) for name, value in params.items()}


def round_up(n: int, multiple: int) -> int:
    """Round `n` up to the next multiple of `multiple` (TPU tile alignment)."""
    return ((n + multiple - 1) // multiple) * multiple


def scaled_steps(num_steps_per_year: int, T: float, floor: int = MIN_STEPS) -> int:
    """Maturity-scaled step count: max(int(steps·T), floor).

    Mirrors the reference's step scaling (engine/monte_carlo.py:287) so that a
    1-year contract at 252 steps/yr integrates daily while a weekly option never
    drops below `floor` steps.
    """
    return max(int(num_steps_per_year * T), floor)
