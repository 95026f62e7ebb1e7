"""`POST /api/rough` in the port against the JAX handler, on the CPU at a
small width: the response keys of every mode, the estimator strings, every
400, and which body runs which kernel's plain version (K10 for price,
smile and skew at 512 steps; K11 for asian, barrier and lookback at 512
steps; none below 512 steps)."""

import numpy as np
import pytest
import torch
from pydantic import ValidationError

from mcos_tpu.api import server as jserver
from mcos_tpu_torch.api import schemas
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

_BODY = {"spot": 100.0, "T": 0.25, "num_paths": 1000, "num_steps": 8}
_MODES = [{}, {"use_sobol": True}, {"mode": "greeks"}, {"mode": "smile"},
          {"mode": "skew"}, {"mode": "asian"},
          {"mode": "barrier", "barrier": 110.0, "knock": "in"},
          {"mode": "lookback"}, {"mode": "lookback", "strike": 95.0},
          {"mode": "calibrate", "maturities": [0.1, 0.5],
           "cal_strikes": [[95.0, 105.0]] * 2,
           "market_prices": [[6.0, 2.0], [9.0, 5.0]], "hurst_grid": [0.1]}]


@pytest.fixture(scope="module")
def responses():
    """{mode index: (port response, JAX response)}, one JAX handler call
    per mode."""
    out = {}
    for i, extra in enumerate(_MODES):
        body = dict(_BODY, **extra)
        out[i] = (pserver.handle_rough(dict(body), device="cpu"),
                  jserver.handle_rough(dict(body)))
    return out


@pytest.mark.parametrize("i", range(len(_MODES)))
def test_response_keys_equal_the_reference(responses, i):
    got, ref = responses[i]
    assert set(got) == set(ref)
    if "params" in ref:
        assert set(got["params"]) == set(ref["params"])
    if "estimator" in ref:
        assert got["estimator"] == ref["estimator"]


def test_prices_agree_with_the_reference_by_law(responses):
    """Different generators (Philox/torch against threefry): the PRNG
    prices within 4 joint se; the RQMC price runs the same Owen streams, so
    it agrees to float32 sums."""
    got, ref = responses[0]
    joint = np.hypot(got["std_error"], ref["std_error"])
    assert abs(got["price"] - ref["price"]) < 4 * joint
    got, ref = responses[1]
    assert got["price"] == pytest.approx(ref["price"], rel=1e-4)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of K10's and K11's plain versions."""
    calls = {"rbergomi_lift_integrals": 0, "rbergomi_lift_stats": 0}
    for name in calls:
        orig = getattr(ck, name + "_plain")

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(ck, name + "_plain", counted)
    return calls


@pytest.mark.parametrize("extra,kernel", [
    ({}, "rbergomi_lift_integrals"),
    ({"mode": "smile", "moneyness": [0.9, 1.0, 1.1]},
     "rbergomi_lift_integrals"),
    ({"mode": "skew"}, "rbergomi_lift_integrals"),
    ({"mode": "asian"}, "rbergomi_lift_stats"),
    ({"mode": "barrier", "barrier": 105.0}, "rbergomi_lift_stats"),
    ({"mode": "lookback"}, "rbergomi_lift_stats"),
    ({"mode": "greeks"}, None),
    ({"use_sobol": True}, None),
])
def test_which_body_runs_which_kernel(plain_calls, extra, kernel):
    """At 512 steps without Sobol the lift requests run K10's or K11's
    plain version once (the CPU side of the wrappers; no launch is
    counted); greeks ride the lift twin and Sobol stays exact. At 128 steps
    no kernel runs."""
    before = ck.launch_counts()
    res = pserver.handle_rough(dict(_BODY, num_paths=1000, num_steps=512,
                                    **extra), device="cpu")
    want = {k: int(k == kernel) for k in plain_calls}
    assert plain_calls == want
    assert ck.launch_counts() == before
    if "estimator" in res:
        assert res["estimator"] == ("conditional-black+lift-cuda" if kernel
                                    else "conditional-black+rqmc")
    for k in plain_calls:
        plain_calls[k] = 0
    pserver.handle_rough(dict(_BODY, num_paths=1000, num_steps=128, **extra),
                         device="cpu")
    assert plain_calls == {k: 0 for k in plain_calls}


@pytest.mark.parametrize("extra,needle", [
    ({"mode": "smile", "moneyness": [1.0] * 257}, "moneyness grid > 256"),
    ({"mode": "barrier"}, "barrier mode needs barrier > 0"),
    ({"mode": "calibrate"}, "calibrate mode needs maturities"),
    ({"mode": "calibrate", "maturities": [0.1, 0.5],
      "cal_strikes": [[100.0]], "market_prices": [[1.0], [2.0]]},
     "must be (m, k)"),
    ({"mode": "calibrate", "maturities": [0.5],
      "cal_strikes": [[100.0] * 2049], "market_prices": [[1.0] * 2049]},
     "calibration grid too large"),
    ({"mode": "american"}, "unknown mode"),
])
def test_every_400_of_the_reference(extra, needle):
    body = dict(_BODY, **extra)
    for call, error in (
            (lambda: pserver.handle_rough(dict(body), device="cpu"),
             pserver.ApiError),
            (lambda: jserver.handle_rough(dict(body)), jserver.ApiError)):
        with pytest.raises(error) as e:
            call()
        assert e.value.status == 400 and needle in str(e.value.detail)


def test_route_and_schema():
    assert pserver._POST_ROUTES["/api/rough"] is pserver.handle_rough
    with pytest.raises(ValidationError):
        schemas.RoughRequest(spot=100.0, T=0.5, num_steps=1024)
    with pytest.raises(ValidationError):
        schemas.RoughRequest(spot=100.0, T=0.5, hurst=0.6)
