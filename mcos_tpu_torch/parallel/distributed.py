"""Multi-process initialization and global meshes on `torch.distributed`
(counterpart of `mcos_tpu/parallel/distributed.py`).

One process runs a rank; a rank runs the shards of its own devices, and
the shards meet only where `parallel/mesh.py` pools them:

- `initialize(...)` brings up the process group (idempotent, with a
  timeout) over a TCP rendezvous at the coordinator's address. The
  backend is an explicit choice, logged: "nccl" when every rank has a
  CUDA device of its own, "gloo" otherwise (NCCL refuses two ranks on one
  GPU). Nothing switches it afterwards.
- `global_mesh(...)` is a 1-D mesh over every rank's devices in rank order
  (`Mesh.ranks` says which rank runs each). Every rank builds the same
  one.
- On such a mesh `mesh.pool_shards` (and the lockstep `StepPool`, one
  collective a process a step) gathers every rank's shard dicts with one
  `all_gather_object`, staged through the host, and each rank sums them
  in global shard order through the same `pool_shards`. A gather and not
  an `all_reduce`: the sum then has one order whatever the layout, so
  N processes × 1 shard return the bits of 1 process × N shards, on every
  rank (an all_reduce's order of summation is the backend's).

A CPU two-process run (what the tests run), each process i of N:

    python -m mcos_tpu_torch.parallel.distributed \\
        --coordinator 127.0.0.1:9955 --num-processes N --process-id i \\
        --backend gloo --device cpu

On one card both ranks take cuda:0 with `--backend gloo --device cuda`.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import time
from typing import Optional, Sequence

import torch

logger = logging.getLogger("mcos_tpu_torch.distributed")

#: Seconds a rendezvous or a collective may wait before it fails.
_DEFAULT_TIMEOUT = 120.0


def _dist():
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    return dist


def _default_backend(num_processes: int) -> str:
    """"nccl" when each of the `num_processes` ranks of this host can have a
    CUDA device of its own, "gloo" otherwise."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= int(num_processes):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: float = _DEFAULT_TIMEOUT) -> None:
    """Bring up the process group (a no-op when it is up already).

    coordinator_address: "host:port" of the rendezvous, which rank 0
    serves; num_processes and process_id: the world size and this rank.
    Without them, torch's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK, as torchrun sets them) gives them. backend: "gloo"
    or "nccl", or None for `_default_backend`. A rendezvous or collective
    that waits `timeout` seconds fails instead of hanging."""
    dist = _dist()
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    backend = backend or _default_backend(num_processes)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend: {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)))
    logger.info("distributed: rank %d/%d on backend %s via %s",
                dist.get_rank(), dist.get_world_size(), backend,
                coordinator_address)


def is_distributed() -> bool:
    """Whether this process belongs to a process group of more than one."""
    dist = _dist()
    return dist.is_initialized() and dist.get_world_size() > 1


def _local_devices(devices: Optional[Sequence]) -> list:
    """This rank's devices: as given, else its own CUDA device
    (rank mod the device count) or the CPU without one."""
    if devices is not None:
        return [str(torch.device(d)) for d in devices]
    if torch.cuda.is_available():
        rank = _dist().get_rank() if _dist().is_initialized() else 0
        return [f"cuda:{rank % torch.cuda.device_count()}"]
    return ["cpu"]


def global_mesh(axis_name: str = "paths",
                local_devices: Optional[Sequence] = None):
    """1-D mesh over every rank's devices in rank order (call it on every
    rank). `local_devices` are this rank's (default: `_local_devices`);
    the mesh records each device's rank, and a rank runs only its own
    shards. Without a process group, the mesh of this process's devices."""
    from mcos_tpu_torch.parallel.mesh import Mesh, make_mesh

    mine = _local_devices(local_devices)
    dist = _dist()
    if not dist.is_initialized():
        return make_mesh(mine, axis_name)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    devices = tuple(torch.device(d) for part in every for d in part)
    ranks = tuple(rank for rank, part in enumerate(every) for _ in part)
    return Mesh(devices, (axis_name,), (len(devices),), ranks)


def _demo_price(num_paths: int, num_steps: int,
                local_devices: Optional[Sequence] = None) -> dict:
    """The smoke workload: `sharded_price` of three SVJ calls over the
    global mesh (K3 a shard on CUDA, its plain version on the CPU). Every
    rank returns the same pooled result."""
    from mcos_tpu_torch.models.params import SVJParams
    from mcos_tpu_torch.parallel import mesh as pmesh

    mesh = global_mesh(local_devices=local_devices)
    calls0, secs0 = pmesh.COLLECTIVES["calls"], pmesh.COLLECTIVES["seconds"]
    t0 = time.perf_counter()
    res = pmesh.sharded_price(
        SVJParams(), 22500.0, [22000.0, 22500.0, 23000.0], 0.25, 7,
        mesh=mesh, num_paths=num_paths, num_steps=num_steps)
    price = res["price"].cpu().tolist()
    wall = time.perf_counter() - t0
    dist = _dist()
    return {
        "process_id": dist.get_rank() if dist.is_initialized() else 0,
        "num_processes": (dist.get_world_size() if dist.is_initialized()
                          else 1),
        "global_devices": mesh.size,
        "devices": [str(d) for d in mesh.devices],
        "price": price,
        "std_error": res["std_error"].cpu().tolist(),
        "wall_s": wall,
        "collectives": pmesh.COLLECTIVES["calls"] - calls0,
        "collective_s": pmesh.COLLECTIVES["seconds"] - secs0,
    }


def main() -> None:
    parser = argparse.ArgumentParser(
        description="mcos_tpu_torch multi-process worker (smoke demo)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of the rendezvous (default: "
                             "MASTER_ADDR:MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--num-paths", type=int, default=8192)
    parser.add_argument("--num-steps", type=int, default=16)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="this rank's device (default: its own CUDA "
                             "device, else the CPU)")
    parser.add_argument("--timeout", type=float, default=_DEFAULT_TIMEOUT)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

    initialize(args.coordinator, args.num_processes, args.process_id,
               backend=args.backend, timeout=args.timeout)
    try:
        local = None
        if args.device == "cpu":
            local = ["cpu"]
        elif args.device == "cuda":
            local = [f"cuda:{_dist().get_rank() % torch.cuda.device_count()}"]
        out = _demo_price(args.num_paths, args.num_steps, local)
        print(json.dumps(out), flush=True)
    finally:
        _dist().destroy_process_group()


if __name__ == "__main__":
    main()
