"""Copy of `mcos_tpu/engine/regime.py` (numpy only); the `/api/regime`
classifier of the port. tests/test_torch_copies.py and
tests/test_torch_regime.py hold the two equal.

Market regime detection: CALM / EVENT / CRISIS.

TPU-native re-design of the reference's regime classifier
(reference: engine/regime.py:19-165). The scoring logic is tiny scalar math —
it stays as pure Python/numpy (putting it on device would be a kernel launch
for six comparisons); the *windowed realized-vol* helper is vectorized so it
can run over whole price histories at once.

Classification semantics preserved exactly: per-indicator scores 0/1/2 against
the thresholds (regime.py:49-66), weighted 0.40/0.35/0.25 (regime.py:69),
CRISIS ≥ 1.5, EVENT ≥ 0.7 (regime.py:71-76), and the per-regime calibration
bound adjustments (regime.py:95-126).
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

import numpy as np

from mcos_tpu_torch.config import REGIME_THRESHOLDS, RegimeThresholds


class MarketRegime(enum.Enum):
    CALM = "calm"
    EVENT = "event"
    CRISIS = "crisis"


class RegimeDetector:
    """Three-input regime classifier (regime.py:25-130 API).

    Structure: each indicator is one row of a scoring table —
    (result key, weight, value extractor, (calm ceiling, event ceiling)) —
    bucketed 0/1/2 by which ceiling the value clears; the weighted bucket
    sum maps onto CALM/EVENT/CRISIS bands. Semantics pinned to the
    reference's thresholds/weights/bands exactly (tests).
    """

    # (total-score lower bound, regime) — checked top-down.
    _BANDS = ((1.5, MarketRegime.CRISIS), (0.7, MarketRegime.EVENT),
              (0.0, MarketRegime.CALM))

    def __init__(self, thresholds: Optional[RegimeThresholds] = None):
        self.thresholds = thresholds or REGIME_THRESHOLDS
        self.history: List[Dict] = []

    def _scoring_table(self):
        th = self.thresholds
        return (
            ("vol_score", 0.40, lambda rv, iv, sk: rv,
             (th.calm_rvol_upper, th.event_rvol_upper)),
            ("iv_score", 0.35, lambda rv, iv, sk: iv,
             (th.calm_iv_pctile_upper, th.event_iv_pctile_upper)),
            ("skew_score", 0.25, lambda rv, iv, sk: abs(sk),
             (th.calm_skew_upper, th.event_skew_upper)),
        )

    @staticmethod
    def _bucket(value: float, ceilings) -> int:
        """0 below the calm ceiling, 1 below the event ceiling, else 2."""
        return sum(value > c for c in ceilings)

    def classify(self, realized_vol: float, iv_percentile: float,
                 skew_slope: float) -> Dict:
        scores = {}
        total = 0.0
        for key, weight, extract, ceilings in self._scoring_table():
            bucket = self._bucket(
                extract(realized_vol, iv_percentile, skew_slope), ceilings)
            scores[key] = bucket
            total += weight * bucket

        regime = next(r for floor, r in self._BANDS if total >= floor)

        result = {
            "regime": regime.value,
            "score": float(total),
            **scores,
            "inputs": {
                "realized_vol": realized_vol,
                "iv_percentile": iv_percentile,
                "skew_slope": skew_slope,
            },
            "calibration_adjustments": self._get_adjustments(regime),
        }
        self.history.append(result)
        return result

    @staticmethod
    def _get_adjustments(regime: MarketRegime) -> Dict:
        """Per-regime calibration constraint switches (regime.py:95-126)."""
        if regime == MarketRegime.CALM:
            return {
                "xi_bounds": (0.05, 1.5),
                "lambda_bounds": (0.0, 3.0),
                "rho_bounds": (-0.95, -0.1),
                "regularization_scale": 1.5,
                "description": "Calm tape: clamp the fit hard and lean on "
                               "regularization",
            }
        if regime == MarketRegime.EVENT:
            return {
                "xi_bounds": (0.1, 3.0),
                "lambda_bounds": (0.5, 10.0),
                "rho_bounds": (-0.999, 0.0),
                "regularization_scale": 1.0,
                "description": "Event window: widen the jump/vol-of-vol box "
                               "so the fit can chase the move",
            }
        return {
            "xi_bounds": (0.2, 5.0),
            "lambda_bounds": (1.0, 20.0),
            "rho_bounds": (-0.999, 0.0),
            "regularization_scale": 0.5,
            "description": "Crisis mode: open the box fully and let the data "
                           "dominate the prior",
        }

    def get_regime_history(self) -> List[Dict]:
        return self.history


def compute_realized_vol(prices, window: int = 20,
                         annualize: int = 252) -> float:
    """Annualized realized vol from a trailing window of closes
    (regime.py:133-148 contract)."""
    prices = np.asarray(prices, np.float64)
    if len(prices) < window + 1:
        returns = np.diff(np.log(prices))
    else:
        returns = np.diff(np.log(prices[-window - 1:]))
    return float(returns.std() * np.sqrt(annualize))


def rolling_realized_vol(prices, window: int = 20,
                         annualize: int = 252) -> np.ndarray:
    """Vectorized rolling realized vol over the full history (new; the
    reference only exposes the point-in-time version)."""
    prices = np.asarray(prices, np.float64)
    returns = np.diff(np.log(prices))
    if len(returns) < window:
        return np.array([])
    sw = np.lib.stride_tricks.sliding_window_view(returns, window)
    return sw.std(axis=-1) * np.sqrt(annualize)


def compute_iv_percentile(current_iv: float, historical_ivs) -> float:
    """Percentile rank of current IV vs its history (regime.py:151-160)."""
    historical_ivs = np.asarray(historical_ivs, np.float64)
    if historical_ivs.size == 0:
        return 50.0
    return float((historical_ivs <= current_iv).sum()
                 / historical_ivs.size * 100)


def compute_skew_slope(put_25d_iv: float, call_25d_iv: float) -> float:
    """25Δ put-call skew slope (regime.py:163-165)."""
    return put_25d_iv - call_25d_iv
