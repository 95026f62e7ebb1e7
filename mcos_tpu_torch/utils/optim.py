"""Optimizers for calibration (counterpart of `mcos_tpu/utils/optim.py`):
differential evolution with the whole population evaluated in one batched
objective call, and an Adam polish in a box-reparameterized space.

The objective takes a (P, D) batch of candidates and returns their (P,)
values: the counterpart of the reference's `vmap` over members, so a
Monte Carlo objective prices every member in one batched program. The
generations draw from an explicit `torch.Generator` on the population's
device; the Adam steps draw nothing.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import torch


class DEResult(NamedTuple):
    x: torch.Tensor          # best member, shape (D,)
    fun: torch.Tensor        # best objective value
    nit: int                 # generations run
    history: torch.Tensor    # best value per generation, shape (iters,)


def _bounds(bounds, device=None) -> torch.Tensor:
    return torch.as_tensor(bounds, dtype=torch.float32, device=device)


def differential_evolution(
    obj_fn: Callable[[torch.Tensor], torch.Tensor],
    bounds,
    generator: torch.Generator,
    pop_size: int = 32,
    iters: int = 100,
    mutation: float = 0.7,
    crossover: float = 0.9,
    x0=None,
    mesh=None,
    pop_axis: str = "paths",
) -> DEResult:
    """DE/rand/1/bin with a vectorized population.

    obj_fn: (P, D) candidates → (P,) values, one call per generation.
    bounds: (D, 2) [lo, hi] per dimension; the population lives on
    `generator`'s device. Deterministic given the generator's seed.
    x0: optional (D,) warm start, clipped to the bounds; it replaces
    member 0 of the initial population, so the result is never worse than
    f(x0).
    mesh: optional `parallel.mesh.Mesh`: the population splits over its
    `pop_axis` shards (`parallel/mesh.py:sharded_population`), each shard
    evaluating its members with one `obj_fn` call on its device, which
    must then read its data on the rows' device. pop_size rounds up to a
    multiple of the axis size; the generations themselves stay here.
    """
    if mesh is not None:
        from mcos_tpu_torch.parallel.mesh import sharded_population

        n_dev = mesh.shape[pop_axis]
        pop_size = -(-int(pop_size) // n_dev) * n_dev
        obj_fn = partial(sharded_population, obj_fn, mesh=mesh,
                         axis_name=pop_axis)
    device = generator.device
    bounds = _bounds(bounds, device)
    lo, hi = bounds[:, 0], bounds[:, 1]
    dim = bounds.shape[0]
    pop = lo + (hi - lo) * torch.rand((pop_size, dim), generator=generator,
                                      device=device)
    if x0 is not None:
        pop[0] = torch.clamp(_bounds(x0, device), lo, hi)
    fitness = obj_fn(pop)
    history = []
    for _ in range(iters):
        # rand/1 mutation: x_a + F (x_b − x_c), indices drawn iid (a rare
        # self-pick only wastes that member's trial).
        idx = torch.randint(0, pop_size, (3, pop_size), generator=generator,
                            device=device)
        mutant = torch.clamp(pop[idx[0]] + mutation * (pop[idx[1]]
                                                       - pop[idx[2]]),
                             lo, hi)
        # Binomial crossover with one forced dimension per member.
        cross = torch.rand((pop_size, dim), generator=generator,
                           device=device) < crossover
        forced = torch.nn.functional.one_hot(
            torch.randint(0, dim, (pop_size,), generator=generator,
                          device=device), dim).bool()
        trial = torch.where(cross | forced, mutant, pop)
        f_trial = obj_fn(trial)
        improved = f_trial < fitness
        pop = torch.where(improved[:, None], trial, pop)
        fitness = torch.where(improved, f_trial, fitness)
        history.append(torch.min(fitness))
    best = torch.argmin(fitness)
    return DEResult(x=pop[best], fun=fitness[best], nit=int(iters),
                    history=torch.stack(history) if history
                    else torch.empty(0, device=device))


# ─────────────────────────────────────────────────────────────────────────────
# Box reparameterization (for gradient-based polish inside bounds)
# ─────────────────────────────────────────────────────────────────────────────
def to_box(u: torch.Tensor, bounds) -> torch.Tensor:
    """Unconstrained ℝᴰ → box via sigmoid: x = lo + (hi−lo)·σ(u)."""
    bounds = _bounds(bounds, u.device)
    return bounds[:, 0] + (bounds[:, 1] - bounds[:, 0]) * torch.sigmoid(u)


def from_box(x: torch.Tensor, bounds, eps: float = 1e-6) -> torch.Tensor:
    """Box → unconstrained (logit), clipped away from the faces."""
    x = torch.as_tensor(x, dtype=torch.float32)
    bounds = _bounds(bounds, x.device)
    t = (x - bounds[:, 0]) / (bounds[:, 1] - bounds[:, 0])
    t = torch.clamp(t, eps, 1.0 - eps)
    return torch.log(t) - torch.log1p(-t)


def adam_polish(
    obj_fn: Callable[[torch.Tensor], torch.Tensor],
    x0,
    bounds,
    steps: int = 50,
    lr: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam (optax's defaults) in the box-reparameterized space from a DE
    solution, on the pathwise gradient of the Monte Carlo objective.
    `obj_fn` takes a (P, D) batch, as in `differential_evolution`; each
    step evaluates the single current point. Returns (x_best, f_best) over
    the visited points; never leaves the bounds."""
    if steps < 1:
        raise ValueError(f"adam_polish needs steps >= 1, got {steps}")
    b1, b2, eps = 0.9, 0.999, 1e-8
    u = from_box(x0, bounds).detach().clone()
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    best_u = best_f = None
    for t in range(1, steps + 1):
        u_req = u.clone().requires_grad_(True)
        val = obj_fn(to_box(u_req, bounds)[None])[0]
        (grad,) = torch.autograd.grad(val, u_req)
        val = val.detach()
        if best_f is None or bool(val < best_f):
            best_u, best_f = u.clone(), val
        m = b1 * m + (1.0 - b1) * grad
        v = b2 * v + (1.0 - b2) * grad * grad
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
        u = u - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return to_box(best_u, bounds), best_f
