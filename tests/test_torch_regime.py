"""The port's regime classifier (`mcos_tpu_torch/engine/regime.py`, numpy on
the host) against the JAX package's: `classify` on a grid that covers every
bucket of every indicator and every band, the calibration adjustments, the
history, and the four helpers, all equal."""

import itertools

import numpy as np
import pytest
import torch

from mcos_tpu.engine import regime as jregime
from mcos_tpu_torch.config import REGIME_THRESHOLDS
from mcos_tpu_torch.engine import regime as pregime

torch.set_num_threads(1)

TH = REGIME_THRESHOLDS


def _around(*ceilings):
    """Values below, at and above each ceiling."""
    out = [0.0]
    for c in ceilings:
        out += [c * 0.5, c, np.nextafter(c, np.inf), c * 1.5]
    return sorted(set(out))


RVOLS = _around(TH.calm_rvol_upper, TH.event_rvol_upper)
IVS = _around(TH.calm_iv_pctile_upper, TH.event_iv_pctile_upper)
SKEWS = sorted(set(_around(TH.calm_skew_upper, TH.event_skew_upper)
                   + [-s for s in _around(TH.calm_skew_upper,
                                          TH.event_skew_upper)]))


def test_classify_grid_equal_and_covers_every_bucket():
    port, ref = pregime.RegimeDetector(), jregime.RegimeDetector()
    seen = {"regime": set(), "vol_score": set(), "iv_score": set(),
            "skew_score": set()}
    for rv, iv, sk in itertools.product(RVOLS, IVS, SKEWS):
        a, b = port.classify(rv, iv, sk), ref.classify(rv, iv, sk)
        assert a == b, (rv, iv, sk)
        for k in seen:
            seen[k].add(a[k])
    assert seen["regime"] == {"calm", "event", "crisis"}
    for k in ("vol_score", "iv_score", "skew_score"):
        assert seen[k] == {0, 1, 2}, k
    assert port.get_regime_history() == ref.get_regime_history()
    assert len(port.history) == len(RVOLS) * len(IVS) * len(SKEWS)


@pytest.mark.parametrize("inputs,regime", [((0.12, 25, 0.02), "calm"),
                                           ((0.22, 60, 0.06), "event"),
                                           ((0.35, 85, 0.12), "crisis")])
def test_canned_inputs(inputs, regime):
    """The reference's three canned inputs (tests/test_risk_regime_guards.py)."""
    out = pregime.RegimeDetector().classify(*inputs)
    assert out["regime"] == regime
    assert out == jregime.RegimeDetector().classify(*inputs)


def test_adjustments_and_enum_equal():
    assert ([m.value for m in pregime.MarketRegime]
            == [m.value for m in jregime.MarketRegime])
    for mp, mj in zip(pregime.MarketRegime, jregime.MarketRegime):
        assert (pregime.RegimeDetector._get_adjustments(mp)
                == jregime.RegimeDetector._get_adjustments(mj))
    for v in RVOLS:
        ceil = (TH.calm_rvol_upper, TH.event_rvol_upper)
        assert (pregime.RegimeDetector._bucket(v, ceil)
                == jregime.RegimeDetector._bucket(v, ceil))
    custom = dict(TH.__dict__, calm_rvol_upper=0.05)
    th = type(TH)(**custom)
    assert (pregime.RegimeDetector(th).classify(0.1, 10, 0.0)
            == jregime.RegimeDetector(th).classify(0.1, 10, 0.0))


@pytest.mark.parametrize("n,window", [(100, 20), (15, 20), (300, 60),
                                      (21, 20)])
def test_realized_vol_helpers_equal(n, window):
    prices = 100 * np.exp(np.cumsum(np.random.default_rng(n).normal(
        0, 0.01, n)))
    assert (pregime.compute_realized_vol(prices, window)
            == jregime.compute_realized_vol(prices, window))
    assert (pregime.compute_realized_vol(prices, window, annualize=365)
            == jregime.compute_realized_vol(prices, window, annualize=365))
    np.testing.assert_array_equal(
        pregime.rolling_realized_vol(prices, window),
        jregime.rolling_realized_vol(prices, window))


def test_iv_percentile_and_skew_equal():
    hist = np.random.default_rng(3).uniform(0.1, 0.4, 250)
    for iv in (0.05, 0.1, 0.2, float(hist[7]), 0.5):
        assert (pregime.compute_iv_percentile(iv, hist)
                == jregime.compute_iv_percentile(iv, hist))
    assert pregime.compute_iv_percentile(0.2, []) == 50.0
    assert (pregime.compute_iv_percentile(0.2, np.array([]))
            == jregime.compute_iv_percentile(0.2, np.array([])))
    for put, call in ((0.25, 0.2), (0.18, 0.22), (0.2, 0.2)):
        assert (pregime.compute_skew_slope(put, call)
                == jregime.compute_skew_slope(put, call))
