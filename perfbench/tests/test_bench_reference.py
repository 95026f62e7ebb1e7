"""The plain reference agrees with the port on the CPU at small sizes, and
its control (the reference in bfloat16, put in the program's place) comes
out not correct by the run's own verdict, where the port comes out
correct."""

import json

import numpy as np
import pytest
import torch

from perfbench import control, harness
from perfbench.reference import qmc

SMALL = {"svj_nifty.quote_c8": 4096, "rough_heston_lift.price_c2": 2048,
         "svj_nifty.greeks_wide_c2": 8192}


def test_sobol_integers_and_jump_uniforms_equal_the_ports():
    from mcos_tpu_torch.ops import cuda_kernels, sobol

    steps, n = 19, 3000
    sv = torch.as_tensor(sobol.sobol_direction_numbers(3 * steps).astype(
        np.int64))
    shift = torch.as_tensor(sobol._scramble_shift(42, 3 * steps).astype(
        np.int64))
    port = sobol._sobol_integers(sv, shift, n, 12)
    words = torch.as_tensor(qmc.scramble_words(42, 3 * steps).astype(
        np.int64))[:, None]
    v = torch.as_tensor(qmc.direction_numbers(3 * steps, 12))
    idx = torch.arange(n)
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((3 * steps, n), dtype=torch.int64)
    for b in range(12):
        acc ^= v[:, b:b + 1] * ((gray >> b) & 1)[None, :]
    assert torch.equal(qmc.owen_scramble(acc, words), port)
    assert np.array_equal(
        qmc.jump_uniforms(steps, n, 42),
        cuda_kernels.philox_jump_uniforms(steps, n, 42, "cpu").double()
        .numpy())


def _served(cell, bodies):
    from mcos_tpu_torch.api import server
    from mcos_tpu_torch.utils import fastjson

    fn = server._POST_ROUTES[cell.mix["route"]]
    return [cell.oracle.served(json.loads(fastjson.dumps(fn(dict(b),
                                                            device="cpu"))))
            for b in bodies]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_reference_agrees_with_the_port_and_the_control_does_not(workload):
    cell = harness.Cell(workload, mix_overrides={
        "request": {"num_paths": SMALL[workload]}})
    count = 3 if "greeks" in workload else 8
    bodies = control.window_bodies(cell, 20260001, count)
    if "rough" in workload:
        for b in bodies:
            b["num_steps"] = 2048
    ref = cell.oracle.reference(cell.config["engine"], bodies, "cpu")
    port = harness.held_to_limits(
        cell, cell.oracle.compare(_served(cell, bodies), ref))
    assert harness.verdict(port, 0, bodies) is True, port
    low = control.control_checks(cell, bodies, "cpu")
    assert set(low) == set(port)
    assert harness.verdict(low, 0, bodies) is False, low
