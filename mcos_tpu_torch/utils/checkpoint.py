"""Checkpoint / resume of calibration state, and the kernels' build cache
(counterpart of `mcos_tpu/utils/checkpoint.py`).

- `save_calibration` / `load_calibration`: durable SVJParams + history.
  The params go to `params.npz` as float32 (the JAX package keeps them in
  an orbax checkpoint), and both packages write and read the same
  `calibration.json` sidecar, so a directory either package saved loads
  in the other.
- `enable_compilation_cache`: the role JAX's persistent compilation cache
  plays there, build once and reuse across restarts: it points the CUDA
  kernels' build directory at `path`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from mcos_tpu_torch.models.params import SVJParams


def enable_compilation_cache(path: str) -> None:
    """Build (and look for) the CUDA kernels' shared library under `path`:
    the library is keyed by its sources' hash, so a restart, or another
    process on the same filesystem, loads it instead of running nvcc
    again. Call it before the first kernel launch. MCOS_DISABLE_JIT_CACHE=1
    leaves the build directory where it is (the package's `_build/`)."""
    if os.environ.get("MCOS_DISABLE_JIT_CACHE") == "1":
        return
    from mcos_tpu_torch.ops import cuda_kernels

    os.makedirs(path, exist_ok=True)
    cuda_kernels.BUILD_DIR = os.path.abspath(path)


def save_calibration(directory: str, params: SVJParams,
                     history: Optional[List[Dict]] = None,
                     metadata: Optional[Dict] = None) -> str:
    """Persist calibrated params (+ history) to `directory`: `params.npz`
    (float32) and the JSON sidecar. Returns the directory path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)

    np.savez(os.path.join(directory, "params.npz"),
             **{k: np.float32(v) for k, v in params.as_dict().items()})
    sidecar = {
        "params": params.as_dict(),
        "history": history or [],
        "metadata": metadata or {},
    }
    with open(os.path.join(directory, "calibration.json"), "w") as f:
        json.dump(sidecar, f, indent=2)
    return directory


def load_calibration(directory: str) -> Tuple[SVJParams, List[Dict], Dict]:
    """Restore (params, history, metadata) saved by `save_calibration` of
    either package (the sidecar holds them)."""
    directory = os.path.abspath(directory)
    with open(os.path.join(directory, "calibration.json")) as f:
        sidecar = json.load(f)
    params = SVJParams(**{k: float(v) for k, v in sidecar["params"].items()})
    return params, sidecar.get("history", []), sidecar.get("metadata", {})
