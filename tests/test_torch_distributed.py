"""The port's processes and entry points on the CPU:
`parallel/distributed.py` on `torch.distributed` (one two-process gloo
run, the counterpart of tests/test_distributed.py), the population-sharded
`calibrate(mesh=...)`, `make_sharded_calibration_step` against the JAX
package's step on a 2 × 2 mesh, and `graft_entry`.

Tolerances: the two processes' result equals the one-process two-shard
mesh's bit for bit, on both ranks (the pooling gathers, then sums in one
order); a population split over shards changes no bit of a DE fit (each
member's K1 rows are its own); the sharded step's loss and parameters
against the JAX package's on replayed draws rtol 1e-5, its Adam moments
(a gradient through a float32 simulation) rtol 1e-4 beside atol 1e-6 ×
the largest."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcos_tpu.engine import calibration as jcal
from mcos_tpu_torch.engine import calibration as pcal
from mcos_tpu_torch.parallel import distributed as pdist
from mcos_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
#: Seconds the two workers may take before they are killed.
WORKER_LIMIT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(num_processes: int, argv):
    """Start `num_processes` workers, `argv(port, i)` the command of
    process i, and return each one's last JSON line; a worker that has
    not ended within WORKER_LIMIT seconds is killed and fails the test."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable] + argv(port, i), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env, cwd=str(REPO), text=True)
        for i in range(num_processes)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=WORKER_LIMIT)
            assert p.returncode == 0, f"worker failed:\n{stderr[-2000:]}"
            line = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            outs.append(json.loads(line[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _spawn_workers(num_processes: int, num_paths: int, num_steps: int):
    return _run_workers(num_processes, lambda port, i: [
        "-m", "mcos_tpu_torch.parallel.distributed",
        "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", str(num_processes), "--process-id", str(i),
        "--num-paths", str(num_paths), "--num-steps", str(num_steps),
        "--backend", "gloo", "--device", "cpu",
        "--timeout", str(WORKER_LIMIT // 2)])


def test_two_processes_equal_one_process_two_shards_bit_for_bit():
    outs = _spawn_workers(2, num_paths=8192, num_steps=16)
    assert [o["process_id"] for o in outs] == [0, 1]
    assert all(o["num_processes"] == 2 and o["global_devices"] == 2
               for o in outs)
    # One collective a process: the pooled moment dicts, gathered once.
    assert all(o["collectives"] == 1 for o in outs)
    assert outs[0]["price"] == outs[1]["price"]
    assert outs[0]["std_error"] == outs[1]["std_error"]
    one = pdist._demo_price(8192, 16, local_devices=["cpu", "cpu"])
    assert one["num_processes"] == 1 and one["global_devices"] == 2
    assert one["collectives"] == 0
    assert outs[0]["price"] == one["price"]
    assert outs[0]["std_error"] == one["std_error"]


#: One rank of `sharded_all_greeks` on a two-process mesh, one CPU shard a
#: rank: argv[1] the rendezvous port, argv[2] the rank, argv[3] the
#: call's keywords as JSON.
_GREEKS_WORKER = """
import json, sys
import torch
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.parallel import distributed as pdist
from mcos_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)
port, rank, kw = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
pdist.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                 timeout=float(sys.argv[4]))
try:
    mesh = pdist.global_mesh(local_devices=["cpu"])
    params = SVJParams(**kw.pop("params"))
    print(json.dumps(pmesh.sharded_all_greeks(params, mesh=mesh, **kw)))
finally:
    torch.distributed.destroy_process_group()
"""

_GREEKS_CALL = dict(
    params=dict(kappa=2.5, theta=0.05, xi=0.5, rho=-0.65, v0=0.045,
                lambda_j=1.5, mu_j=-0.06, sigma_j=0.12, r=0.05, q=0.01),
    spot=100.0, strike=100.0, T=0.5, seed=7, num_paths=2048, num_steps=8)


def test_two_processes_greeks_equal_one_process_two_shards():
    """Every Greek of `sharded_all_greeks` on two processes × one shard
    against one process × two shards. The price is the same bits (the
    pooled sums gather, then sum in one order); the AD sensitivities
    rtol 1e-5 beside atol 1e-6 × the largest (one process accumulates its
    shards' gradient terms into the shared leaves in autograd's order,
    two processes sum each rank's whole gradient). The discount's own
    terms in rho and theta_daily are counted once, not once a rank."""
    outs = _run_workers(2, lambda port, i: [
        "-c", _GREEKS_WORKER, str(port), str(i), json.dumps(_GREEKS_CALL),
        str(WORKER_LIMIT // 2)])
    assert outs[0] == outs[1]                     # both ranks, bit for bit
    from mcos_tpu_torch.models.params import SVJParams

    kw = dict(_GREEKS_CALL)
    params = SVJParams(**kw.pop("params"))
    one = pmesh.sharded_all_greeks(params, mesh=pmesh.make_mesh(["cpu"] * 2),
                                   **kw)
    got = outs[0]
    assert got.keys() == one.keys()
    assert got["price"] == one["price"]
    assert got["num_devices"] == one["num_devices"] == 2
    scale = max(abs(v) for v in one.values())
    for k, v in one.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=k)


def test_global_mesh_and_process_state_without_a_group():
    """Without a process group: no distribution, a local mesh, and a mesh
    that names ranks refuses to run (it needs the group)."""
    assert not pdist.is_distributed()
    m = pdist.global_mesh(local_devices=["cpu", "cpu"])
    assert m.ranks is None and m.shape == {"paths": 2}
    assert pdist._default_backend(2) == "gloo"      # no CUDA device here
    ranked = pmesh.Mesh((torch.device("cpu"),) * 2, ("paths",), (2,),
                        (0, 1))
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.mesh_shards(ranked, 0)
    with pytest.raises(ValueError, match="rank order"):
        pmesh.Mesh((torch.device("cpu"),) * 2, ("paths",), (2,), (1, 0))
    with pytest.raises(ValueError, match="backend"):
        pdist.initialize("127.0.0.1:1", 1, 0, backend="mpi")


# ─────────────────────────────────────────────────────────────────────────────
# Calibration over a mesh
# ─────────────────────────────────────────────────────────────────────────────
SPOT, T = 100.0, 0.25
STRIKES = np.array([90.0, 95.0, 100.0, 105.0, 110.0], np.float32)


def _market():
    from mcos_tpu_torch.models.params import SVJParams
    from mcos_tpu_torch.ops.cos_pricer import cos_price

    return np.asarray(cos_price(SVJParams(kappa=2.0, theta=0.05, xi=0.4,
                                          rho=-0.6, v0=0.05), SPOT, STRIKES,
                                T, True), np.float32)


def test_calibrate_population_shards_change_no_bit():
    """Two shards of "cpu", each pricing its half of every DE generation
    with one K1 population launch (the plain version here), give the
    unsharded fit bit for bit, Adam polish included."""
    import dataclasses

    kw = dict(num_paths=1000, num_steps=4, pop_size=4, polish=True)
    eng = pcal.CalibrationEngine(config=dataclasses.replace(
        pcal.CALIBRATION_CONFIG, stage1_max_iter=8, stage2_max_iter=8),
        device="cpu")
    ref = eng.calibrate(SPOT, STRIKES, T, _market(), **kw)
    got = eng.calibrate(SPOT, STRIKES, T, _market(),
                        mesh=pmesh.make_mesh(["cpu"] * 2), **kw)
    assert got["params"] == ref["params"]
    for stage in ("stage1_result", "stage2_result"):
        assert got[stage] == ref[stage]


def _jax_step_draws(key, steps, n):
    def one(t):
        k_n, k_u = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.normal(k_n, (3, n), jnp.float32),
                jax.random.uniform(k_u, (n,), jnp.float32))

    z, u = jax.vmap(one)(jnp.arange(steps))
    return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


def test_sharded_calibration_step_matches_jax():
    from jax.sharding import Mesh

    n, steps, seed = 1024, 4, 3
    jm = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
              ("batch", "paths"))
    strikes = np.linspace(90.0, 110.0, 4).astype(np.float32)
    market = np.array([11.0, 6.0, 2.5, 0.8], np.float32)
    weights = np.full(4, 0.25, np.float32)
    x0 = [2.0, 0.05, 0.5, -0.6, 0.04]
    j_step, j_init = jcal.make_sharded_calibration_step(
        jm, num_paths=n, num_steps=steps, lr=0.05, r=0.05, q=0.01)
    ju, jstate = j_init(jnp.asarray(x0, jnp.float32))
    ju, jstate, jloss = j_step(ju, jstate, jnp.float32(SPOT),
                               jnp.asarray(strikes), jnp.float32(T),
                               jnp.asarray(market), jnp.asarray(weights),
                               jax.random.key(seed))
    key = jax.random.key(seed)
    p_step, p_init = pcal.make_sharded_calibration_step(
        pmesh.make_mesh_2d(2, ["cpu"] * 4), num_paths=n, num_steps=steps,
        lr=0.05, r=0.05, q=0.01,
        shard_draws=lambda j: _jax_step_draws(jax.random.fold_in(key, j),
                                              steps, n // 2))
    pu, pstate = p_init(x0)
    np.testing.assert_allclose(pu.numpy(), np.asarray(j_init(
        jnp.asarray(x0, jnp.float32))[0]), rtol=1e-6)
    pu, pstate, ploss = p_step(pu, pstate, SPOT, strikes, T, market,
                               weights, seed)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=1e-5)
    adam = jstate[0]
    assert pstate[0] == int(adam.count) == 1
    for got, ref in ((pstate[1], adam.mu), (pstate[2], adam.nu)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())


# ─────────────────────────────────────────────────────────────────────────────
# graft_entry
# ─────────────────────────────────────────────────────────────────────────────
def test_graft_entry_and_dryrun_multichip_on_the_cpu():
    from mcos_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    res = fn(*args)
    assert res["price"].shape == (3,) and torch.isfinite(res["price"]).all()
    assert res["price"].device.type == "cpu"
    out = graft_entry.dryrun_multichip(4, device="cpu")
    for name in ("calibration_step", "sobol", "greeks_delta", "var",
                 "american", "basket_bounds", "mlmc", "exposure_epe",
                 "de_population", "pde_chain", "slv", "auto_engine"):
        assert np.isfinite(out[name]), name
