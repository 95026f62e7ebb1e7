"""Rough Heston, host part only (counterpart of the kernel-fit half of
`mcos_tpu/ops/roughheston.py`): the exponential-sum fit of the fractional
kernel that the rough Bergomi lift (`ops/rough.py:rbergomi_lift`) reuses.

The power kernel K(t) = t^{alpha-1} / Gamma(alpha), alpha = H + 1/2, is a
Laplace mixture, K(t) = int e^{-xt} mu(dx) with
mu(dx) = x^{-alpha} dx / (Gamma(alpha) Gamma(1-alpha)). `lifted_kernel_nodes`
matches the 0th and 1st moments of mu on a zeroth cell plus a geometric
grid, so K(t) ~= sum_i c_i e^{-x_i t}. Host float64, copied unchanged;
tests/test_torch_copies.py holds both functions equal to the JAX package's.

The rest of rough Heston (the fractional-Riccati COS oracle and the lifted
Monte Carlo) is not ported yet (ROADMAP.md queue 1, slice L: rough
Heston).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=64)
def lifted_kernel_nodes(hurst: float, T: float, resolution: float,
                        n_factors: int = 24) -> Tuple[Tuple[float, ...],
                                                      Tuple[float, ...]]:
    """Moment-matched (c_i, x_i) with K(t) ~= sum_i c_i e^{-x_i t}.

    The x-axis is cut into a zeroth cell [0, eta_0] (the quasi-constant
    slow mass) plus a geometric grid over [0.02/T, 20/resolution]; per
    cell c_i = int mu(dx) and x_i = (1/c_i) int x mu(dx). Sup relative
    error on [resolution, T] below 0.8 % for H in [0.05, 0.4] at the
    default 24 factors (`lifted_kernel_error`).

    `resolution` is the finest time scale the lifted model resolves, a
    model constant rather than the simulation dt. H = 1/2 degenerates to
    the constant kernel: one factor (c, x) = (1, 0).
    """
    h = float(hurst)
    if abs(h - 0.5) < 1e-12:
        return (1.0,), (0.0,)
    alpha = h + 0.5
    n = int(n_factors)
    eta = np.concatenate([[0.0],
                          np.geomspace(0.02 / T, 20.0 / resolution, n)])
    norm = math.gamma(alpha) * math.gamma(1.0 - alpha)
    p0 = 1.0 - alpha                       # int x^-alpha = x^p0 / p0
    p1 = 2.0 - alpha
    c = (eta[1:] ** p0 - eta[:-1] ** p0) / (p0 * norm)
    x = (p0 / p1) * (eta[1:] ** p1 - eta[:-1] ** p1) \
        / (eta[1:] ** p0 - eta[:-1] ** p0)
    return tuple(float(v) for v in c), tuple(float(v) for v in x)


def lifted_kernel_error(hurst: float, T: float, resolution: float,
                        n_factors: int = 24) -> float:
    """Sup relative error of the exponential-sum kernel on [resolution, T]."""
    c, x = lifted_kernel_nodes(hurst, T, resolution, n_factors)
    t = np.geomspace(resolution, T, 400)
    k_exact = t ** (hurst - 0.5) / math.gamma(hurst + 0.5)
    k_hat = (np.asarray(c)[:, None]
             * np.exp(-np.asarray(x)[:, None] * t[None, :])).sum(axis=0)
    return float(np.max(np.abs(k_hat - k_exact) / k_exact))
