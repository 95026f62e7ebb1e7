"""The viz kernel's wrapper (`cuda_kernels.svj_viz`) on the CPU: its plain
version is the step loops the recorder and the histogram sampler ran
before the kernel existed, so `/api/price` answers as it did.

The card's side (the kernel against the torch loop on the same draws) is
in tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from mcos_tpu_torch.api import coalesce as pcoalesce
from mcos_tpu_torch.api import server as pserver
from mcos_tpu_torch.engine.pricer import MonteCarloEngine
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck
from mcos_tpu_torch.ops import simulate as psim
from mcos_tpu_torch.utils import fastjson, spans

torch.set_num_threads(1)

_P = SVJParams(kappa=3.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04,
               lambda_j=1.0, mu_j=-0.05, sigma_j=0.1, r=0.065, q=0.012)
SPOT = 22500.0
#: The quote cell's step counts (recorder 50 and 62; sampler 10, 19, 62)
#: and an odd one.
STEPS = [10, 19, 50, 51, 62]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _old_recorder(params, spot, T, generator, num_paths, num_steps):
    """`simulate_paths_recorded` as it was before its loop became a kernel,
    line for line."""
    device = torch.device("cpu")
    spot = psim._f32(spot, device)
    dt = psim._f32(T, device) / num_steps
    sqrt_dt = torch.sqrt(dt)
    z = torch.randn((num_steps, 3, num_paths), generator=generator,
                    device=device, dtype=torch.float32)
    u = torch.rand((num_steps, num_paths), generator=generator,
                   device=device, dtype=torch.float32)
    log_s = torch.zeros(num_paths, dtype=torch.float32, device=device)
    v = psim._v0_like(params.v0, log_s)
    rows = []
    for t in range(num_steps):
        log_s, v = psim._svj_step_core(params, dt, sqrt_dt, log_s, v,
                                       z[t, 0], z[t, 1], u[t], z[t, 2])
        rows.append(log_s)
    paths = spot * torch.exp(torch.stack(rows, dim=1))
    return torch.cat([spot.expand(num_paths, 1), paths], dim=1)


def _old_sampler(params, spot, T, generator, num_paths, num_steps):
    """`terminal_samples_device`'s program before the kernel."""
    s_final, _, _ = psim.simulate_terminal(
        params, spot, T, generator, num_paths=num_paths,
        num_steps=num_steps, antithetic=False, device="cpu")
    return s_final[0]


def _exact(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("steps", STEPS)
def test_recorder_is_the_loop_it_replaced(steps):
    T = steps / 252.0
    got = psim.simulate_paths_recorded(_P, SPOT, T, _gen(7), 50, steps,
                                       device="cpu")
    assert got.shape == (50, steps + 1)
    _exact(got, _old_recorder(_P, SPOT, T, _gen(7), 50, steps))


@pytest.mark.parametrize("steps", STEPS)
def test_sampler_is_the_loop_it_replaced(steps):
    T = steps / 252.0
    got = psim.simulate_terminal_samples(_P, SPOT, T, _gen(8), 1024, steps,
                                         device="cpu")
    assert got.shape == (1024,)
    _exact(got, _old_sampler(_P, SPOT, T, _gen(8), 1024, steps))


@pytest.mark.parametrize("record", [True, False])
def test_wrapper_on_cpu_draws_is_its_plain_version(record):
    g = _gen(3)
    z = torch.randn((19, 3, 300), generator=g)
    u = torch.rand((19, 300), generator=g)
    got = ck.svj_viz(_P, SPOT, 0.08, z, u, record=record)
    _exact(got, ck.svj_viz_plain(_P, SPOT, 0.08, z, u, record=record))
    if record:
        _exact(got, psim.recorded_from_draws(_P, SPOT, 0.08, z, u))


def test_engine_viz_programs_answer_as_before():
    """The engine's seeds (42 + 999, 42 + 1234) and step counts, through
    `get_sample_paths` and `terminal_samples`."""
    eng = MonteCarloEngine(_P, num_paths=4096, device="cpu")
    T = 28 / 365
    _exact(torch.from_numpy(eng.get_sample_paths(SPOT, T)),
           _old_recorder(_P, SPOT, T, _gen(42 + 999), 50, 50))
    _exact(torch.from_numpy(eng.terminal_samples(SPOT, T)),
           _old_sampler(_P, SPOT, T, _gen(42 + 1234), 1024, eng._steps(T)))


def _draws(steps=6, paths=40):
    g = _gen(1)
    return (torch.randn((steps, 3, paths), generator=g),
            torch.rand((steps, paths), generator=g))


@pytest.mark.parametrize("case", ["non_contiguous", "wrong_shape",
                                  "float64", "tensor_leaf", "u_mismatch"])
@pytest.mark.parametrize("record", [True, False])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, record):
    z, u = _draws()
    params = _P
    error = ValueError
    if case == "non_contiguous":
        z = torch.randn((3, 6, 40)).transpose(0, 1)
        assert z.shape == (6, 3, 40) and not z.is_contiguous()
    elif case == "wrong_shape":
        z = z[:, :2].contiguous()
    elif case == "float64":
        z, error = z.double(), TypeError
    elif case == "tensor_leaf":
        params = dataclasses.replace(_P, rho=torch.tensor(-0.7))
        error = TypeError
    else:
        u = u[:, :39].contiguous()
    with pytest.raises(error):
        ck.svj_viz(params, SPOT, 0.1, z, u, record=record)


def test_no_kernel_launch_counted_on_the_cpu():
    before = spans.RECORDER.counters().get("viz_kernel_launches", 0)
    n0 = ck.launch_counts()["svj_viz"]
    eng = MonteCarloEngine(_P, num_paths=4096, device="cpu")
    eng.get_sample_paths(SPOT, 0.05)
    eng.terminal_samples(SPOT, 0.05)
    assert ck.launch_counts()["svj_viz"] == n0
    assert spans.RECORDER.counters().get("viz_kernel_launches", 0) == before


def test_viz_consts_are_the_twins_roundings():
    """Every scalar the kernel takes, against the twin's own arithmetic on
    the CPU; dt is T times the reciprocal of the step count, which is how
    torch divides a CUDA tensor by a number (the CPU divides: one ulp
    apart at most)."""
    T, steps = 28 / 365, 19
    c = ck._viz_consts(_P, SPOT, T, steps)
    f = np.float32
    dt = torch.tensor(T, dtype=torch.float32) / steps
    assert abs(float(c[2]) - float(dt)) <= float(np.spacing(f(dt)))
    assert c[2] == f(T) * (f(1) / f(steps))
    assert c[3] == np.sqrt(c[2])
    assert c[9] == f(_P.lambda_j) * c[2]
    assert c[8] == f(np.sqrt(np.float32(1.0 - _P.rho * _P.rho)))
    k = f(_P.jump_compensation)
    assert c[12] == f(_P.r - _P.q) - f(_P.lambda_j) * k
    assert list(c[[0, 1, 4, 5, 6, 7, 10, 11]]) == [
        f(x) for x in (SPOT, _P.v0, _P.kappa, _P.theta, _P.xi, _P.rho,
                       _P.mu_j, _P.sigma_j)]


_BODY = {"spot": SPOT, "strike": SPOT, "T": 0.05, "num_paths": 4096}


def test_api_price_solo_and_coalesced_viz_unchanged(monkeypatch):
    """Solo and coalesced `/api/price` give the same `sample_paths` and
    `terminal_samples`, and both are the JSON of the loops they replaced."""
    monkeypatch.setattr(pcoalesce.coalescer, "window_s", 0.0)
    bodies = [dict(_BODY, strike=k) for k in (22000.0, 23000.0)]
    solos = [pserver.handle_price(dict(b), device="cpu") for b in bodies]
    monkeypatch.setattr(pcoalesce.coalescer, "window_s", 0.5)
    runs0 = pcoalesce.coalescer.batches_run
    out = [None] * len(bodies)

    def call(i):
        out[i] = pserver.handle_price(dict(bodies[i]), device="cpu")

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert pcoalesce.coalescer.batches_run == runs0 + 1
    T = _BODY["T"]
    eng = MonteCarloEngine(SVJParams(), num_paths=4096, device="cpu")
    paths = fastjson.float_array_json(
        _old_recorder(SVJParams(), SPOT, T, _gen(42 + 999), 50, 50).numpy(),
        decimals=2)
    terms = fastjson.float_array_json(
        _old_sampler(SVJParams(), SPOT, T, _gen(42 + 1234), 1024,
                     eng._steps(T)).numpy(), decimals=2)
    for got, ref in zip(out, solos):
        assert got["sample_paths"].raw == ref["sample_paths"].raw \
            == paths.raw
        assert got["terminal_samples"].raw == ref["terminal_samples"].raw \
            == terms.raw
