"""Portfolio ("book") pricing and Greeks: many heterogeneous contracts in
one step loop (counterpart of `mcos_tpu/engine/book.py`).

A desk books hundreds of positions across strikes, expiries, and sides.
Here the whole book is a leading position axis of the Euler member twin
(`ops/simulate.py:simulate_terminal_members`), each position on its own
draws:

- one step loop prices every contract off its own path set (T varies per
  contract — the step grid is shared at `num_steps`, with per-contract
  dt = T/num_steps);
- call/put handled branchlessly via the sign trick φ ∈ {+1, −1},
  payoff = max(φ·(S_T − K), 0), with the companion-leg control variate
  against Black-Scholes at σ = √v0;
- book Greeks come from one backward pass: spot, T, v0 and r are (N,)
  autograd leaves and the positions are independent, so the gradient of
  the summed prices gives every position's delta, theta (−∂P/∂T),
  vega_v0 and rho — the JAX package's `vmap` of `value_and_grad`.

No kernel: the Greeks need the gradient, as in `/api/greeks`. Position i
draws (steps, 3, paths) normals then (steps, paths) uniforms from one
generator seeded with the engine's seed, in position order, so a
position's paths do not depend on how the book is cut into chunks. The
draws take 16 B a path-step a position, so positions run in chunks of at
most _BOOK_CHUNK_BYTES of draws and recorded activations.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from mcos_tpu_torch.engine.pricer import seeded_generator, to_host
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import simulate
from mcos_tpu_torch.ops.bs import bs_price

#: Device bytes a chunk of positions may take: 16 B of draws and about
#: 32 B of autograd-recorded activations a path-step a position.
_BOOK_CHUNK_BYTES = 4 << 30
_BYTES_PER_PATH_STEP = 48


def _book_prices(params: SVJParams, spots, strikes, Ts, phis, draws):
    """(price, se) of each position, each (M,), by the CV estimator of the
    JAX package's `_price_one` (companion control, β = 1): differentiable
    in `spots`, `Ts` and the (M,) leaves of `params`."""
    s_final, g_final, _ = simulate.simulate_terminal_members(
        params, spots, Ts, draws=draws)
    k, phi = strikes[:, None, None], phis[:, None, None]
    r = params.r
    discount = torch.exp(-r * Ts)
    pay = simulate.combine_antithetic(
        torch.clamp(phi * (s_final - k), min=0.0).transpose(0, 1))
    ctrl = simulate.combine_antithetic(
        torch.clamp(phi * (g_final - k), min=0.0).transpose(0, 1))
    sigma = torch.sqrt(params.v0)
    bs_call = bs_price(spots, strikes, Ts, r, params.q, sigma, True)
    bs_put = bs_price(spots, strikes, Ts, r, params.q, sigma, False)
    bs_ref = torch.where(phis > 0, bs_call, bs_put)
    cv_pay = pay - (ctrl - (bs_ref / discount)[:, None])
    mean, se = simulate.mc_mean_stderr(cv_pay)
    return discount * mean, discount * se


class BookEngine:
    """Vectorized portfolio pricer/risk over heterogeneous contracts, on
    `device`."""

    def __init__(self, params: SVJParams, num_paths: int = 100_000,
                 num_steps: int = 64, seed: int = 42, *, device="cuda"):
        self.params = params
        self.num_paths = int(num_paths)
        self.num_steps = int(num_steps)
        self.seed = int(seed)
        self.device = torch.device(device)

    def _chunk(self) -> int:
        """Positions a chunk."""
        per = _BYTES_PER_PATH_STEP * self.num_paths * self.num_steps
        return max(1, _BOOK_CHUNK_BYTES // per)

    def _draws(self, generator: torch.Generator, first: int, count: int):
        """(z, u) of positions first..first+count−1 with a member axis,
        (steps, 3, M, paths) and (steps, M, paths): each position's
        normals then uniforms from `generator`, in position order."""
        shape = (self.num_steps, 3, count, self.num_paths)
        z = torch.empty(shape, dtype=torch.float32, device=self.device)
        u = torch.empty((self.num_steps, count, self.num_paths),
                        dtype=torch.float32, device=self.device)
        for j in range(count):
            z[:, :, j], u[:, j] = simulate._euler_draws(
                None, generator, self.num_paths, self.num_steps, self.device)
        return z, u

    def price_book(self, spots: Sequence[float], strikes: Sequence[float],
                   Ts: Sequence[float], is_calls: Sequence[bool],
                   quantities: Sequence[float] | None = None) -> Dict:
        """Price + delta/vega/theta/rho for every position, plus aggregates.

        quantities: signed position sizes (long +, short −); default +1 each.
        """
        dev = self.device

        def col(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        spots, strikes, Ts = col(spots), col(strikes), col(Ts)
        phis = col(np.where(np.asarray(is_calls, bool), 1.0, -1.0))
        n = spots.shape[0]
        qty = (torch.ones(n, dtype=torch.float32, device=dev)
               if quantities is None else col(quantities))
        gen = seeded_generator(self.seed, dev)
        v0, r = float(self.params.v0), float(self.params.r)
        rows = []
        for first in range(0, n, self._chunk()):
            sl = slice(first, min(first + self._chunk(), n))
            m = sl.stop - sl.start
            s0, t0 = (spots[sl].clone().requires_grad_(),
                      Ts[sl].clone().requires_grad_())
            v0_t, r_t = (torch.full((m,), x, dtype=torch.float32, device=dev,
                                    requires_grad=True) for x in (v0, r))
            price, se = _book_prices(
                self.params.replace(v0=v0_t, r=r_t), s0, strikes[sl], t0,
                phis[sl], self._draws(gen, sl.start, m))
            grads = torch.autograd.grad(price.sum(), (s0, t0, v0_t, r_t))
            rows.append(torch.stack([price.detach(), se.detach(),
                                     grads[0], -grads[1], grads[2],
                                     grads[3]]))
        price, se, delta, theta, vega_v0, rho = torch.cat(rows, dim=1)
        # ∂P/∂v0 → per-vol-point convention (chain rule through σ = √v0,
        # same convention as GreeksEngine.vega).
        vega = vega_v0 * 2.0 * float(np.sqrt(np.float32(v0)))
        host = to_host({
            "price": price, "std_error": se, "delta": delta, "theta": theta,
            "vega": vega, "vega_v0": vega_v0, "rho": rho,
            "book": torch.stack([torch.sum(qty * x) for x in
                                 (price, delta, theta, vega, rho)])})
        book = host.pop("book")
        return {
            **host,
            "book_value": float(book[0]),
            "book_delta": float(book[1]),
            "book_theta": float(book[2]),
            "book_vega": float(book[3]),
            "book_rho": float(book[4]),
            "num_positions": int(n),
        }
