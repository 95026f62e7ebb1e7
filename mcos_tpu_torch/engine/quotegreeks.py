r"""Market-quote Greeks of the port (counterpart of
`mcos_tpu/engine/quotegreeks.py`, host float64 numpy over the port's copy
of the COS/Bates pricer; tests/test_torch_calibration.py holds it to the
JAX package's at rtol 1e-9).

Market-quote Greeks: bucketed sensitivities THROUGH the calibration.

What a desk actually hedges against is not "dP/d-kappa" but "dP/d-quote" — how the book moves when
one vanilla on the calibration chain reprices and the model is REFIT.
That map exists in closed form by the implicit function theorem on the
weighted-least-squares calibration optimum:

    theta*(q) = argmin_theta  1/2 sum_i w_i (C_i(theta) - q_i)^2
    d theta*/d q = (J^T W J)^{-1} J^T W          (Gauss-Newton IFT)
    d P/d q     = (dP/d theta)^T  (J^T W J)^{-1} J^T W

with J_ij = dC_i/d theta_j the chain Jacobian. Every derivative here
comes from the EXACT COS/Bates oracle (ops/cos_pricer.py) in host f64 —
no MC noise anywhere in the map (the same design as
CalibrationEngine.parameter_uncertainty, which reuses half of this
machinery for error bars).

Reading the output: `buckets[i]` is the position in quote-i's vanilla
that replicates the product's first-order exposure to ANY market move
the model can express — the calibration-consistent static hedge. Two
exact identities pin the construction in tests:

1. Replication: if the product IS chain quote k and the free-parameter
   set is exactly identified (square invertible J), the buckets are the
   k-th unit vector — repricing quote k moves the product one-for-one
   and nothing else.
2. Recalibration FD: bump one quote, refit, reprice. The bucket predicts
   that finite difference (checked for an off-chain vanilla).

Free-parameter choice = WHICH parameters the refit may move. The default
CORE4 = (theta, xi, rho, v0) is what one expiry identifies (measured
cond ~5e6; adding kappa sends it to ~8e11 — kappa/theta confound at a
single maturity, the same diagnosis parameter_uncertainty reports).
Multi-expiry chains (pass lists of strike vectors and maturities) carry
the term-structure information that identifies kappa — and give
per-(strike, expiry) SURFACE buckets. Underdetermined choices fall back
to the pseudo-inverse = the minimum-norm refit direction, with the
condition number reported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops.cos_pricer import cos_price

CORE4 = ("theta", "xi", "rho", "v0")
HESTON_CORE = ("kappa", "theta", "xi", "rho", "v0")
ALL_PARAMS = ("kappa", "theta", "xi", "rho", "v0",
              "lambda_j", "mu_j", "sigma_j")

# Bump guards where the CF parameterization degenerates (same table as
# CalibrationEngine.parameter_uncertainty).
_BUMP_LO = {"theta": 1e-6, "xi": 1e-3, "v0": 1e-6, "lambda_j": 0.0,
            "sigma_j": 1e-4, "kappa": 1e-4}
_BUMP_HI = {"rho": 0.999}

Chain = Tuple[np.ndarray, float]          # (strikes, maturity)


def _bs_vega_host(S, K, T, r, q, sigma):
    """BS vega in host f64 (`ops/bs.py:bs_vega` semantics): this module
    is a pure host path."""
    K = np.asarray(K, np.float64)
    d1 = (np.log(S / K) + (r - q + 0.5 * sigma * sigma) * T) \
        / (sigma * np.sqrt(T))
    pdf = np.exp(-0.5 * d1 * d1) / np.sqrt(2.0 * np.pi)
    return S * np.exp(-q * T) * np.sqrt(T) * pdf


def _normalize_chains(strikes, T) -> List[Chain]:
    """Accept (array, scalar) for one expiry or (list-of-arrays, list)
    for a surface; return [(strikes_i, T_i), ...]."""
    if np.isscalar(T) or np.asarray(T).ndim == 0:
        return [(np.asarray(strikes, np.float64), float(T))]
    Ts = [float(t) for t in T]
    if len(strikes) != len(Ts):
        raise ValueError("strikes and T lists must align per expiry")
    return [(np.asarray(k, np.float64), t) for k, t in zip(strikes, Ts)]


def _stacked_prices(params: SVJParams, spot: float, chains: List[Chain],
                    is_call: bool) -> np.ndarray:
    return np.concatenate([
        np.asarray(cos_price(params, spot, ks, t, is_call), np.float64)
        for ks, t in chains])


def _param_fd(params: SVJParams, free: Sequence[str], price_fn):
    """Central-FD gradient of `price_fn(params) -> (m,) array` over the
    free parameters, with the degenerate-point guards. Returns (m, p)."""
    x0 = np.array([float(getattr(params, n)) for n in free], np.float64)
    cols = []
    for j, name in enumerate(free):
        h = max(1e-4, 1e-3 * abs(x0[j]))
        up = min(x0[j] + h, _BUMP_HI.get(name, np.inf))
        dn = max(x0[j] - h, _BUMP_LO.get(name, -np.inf))
        if up - dn < 1e-12:
            cols.append(np.zeros_like(np.asarray(price_fn(params))))
            continue
        pu = price_fn(params.replace(**{name: up}))
        pd = price_fn(params.replace(**{name: dn}))
        cols.append((np.asarray(pu) - np.asarray(pd)) / (up - dn))
    return np.stack(cols, axis=-1)


def chain_jacobian(params: SVJParams, spot: float, strikes, T,
                   free: Sequence[str] = CORE4,
                   is_call: bool = True) -> np.ndarray:
    """J_ij = d cos_price(quote_i) / d theta_j, exact-oracle f64 FD.
    Quotes stack over expiries when (strikes, T) are lists."""
    chains = _normalize_chains(strikes, T)
    return _param_fd(params, free,
                     lambda p: _stacked_prices(p, spot, chains, is_call))


def quote_transfer_matrix(params: SVJParams, spot: float, strikes, T,
                          free: Sequence[str] = CORE4,
                          is_call: bool = True,
                          weights: Optional[np.ndarray] = None,
                          atm_vol: float = 0.15,
                          rcond: float = 1e-10) -> Dict:
    """d theta*/d q = (J^T W J)^+ J^T W, plus identifiability diagnostics.

    `weights`: None = vega weights normalized over the WHOLE quote stack
    (the CalibrationEngine's own weighting, kept globally consistent
    across expiries so the IFT differentiates the same optimum shape);
    pass an array to override. The IFT map is invariant to the overall
    weight scale — only relative weights matter.
    """
    chains = _normalize_chains(strikes, T)
    if weights is None:
        vega_blocks = [
            np.maximum(_bs_vega_host(
                spot, ks, t, float(params.r), float(params.q), atm_vol),
                1e-10)
            for ks, t in chains]
        w = np.concatenate(vega_blocks)
        w = w / w.sum()
    else:
        w = np.asarray(weights, np.float64)
    J = chain_jacobian(params, spot, strikes, T, free, is_call)
    if w.shape[0] != J.shape[0]:
        raise ValueError("weights length must match the total quote count")
    A = J.T @ (w[:, None] * J)
    M = np.linalg.pinv(A, rcond=rcond) @ J.T @ np.diag(w)   # (p, n)
    return {
        "transfer": M,
        "jacobian": J,
        "weights": w,
        "free": list(free),
        "condition_number": float(np.linalg.cond(A)),
        "identified": bool(np.linalg.cond(A) < 1e10),
    }


def product_price_and_gradient(params: SVJParams, spot: float,
                               product: Dict,
                               free: Sequence[str] = CORE4):
    """(price, dP/dtheta) for a COS/closed-form product — f64, no MC.

    Kinds:
      vanilla  — {"kind","strike","T","is_call"}: the exact COS price.
      digital  — cash-or-nothing call/put, e^{-rT} P(S_T >< K), priced as
                 a tight strike spread of COS vanillas (h = 1e-4 K).
      varswap  — {"kind","T"}: closed-form fair variance
                 (engine/exotics.py:variance_swap_fair_strike), in
                 variance units x `notional` (default 1).
    """
    kind = product.get("kind", "vanilla")
    T = float(product["T"])
    is_call = bool(product.get("is_call", True))

    if kind == "vanilla":
        K = float(product["strike"])

        def pf(p):
            return cos_price(p, spot, [K], T, is_call)[0]

    elif kind == "digital":
        K = float(product["strike"])
        h = 1e-4 * K

        def pf(p):
            lo, hi = cos_price(p, spot, [K - h, K + h], T, True)
            dig_call = (lo - hi) / (2.0 * h)      # -dC/dK
            if is_call:
                return dig_call
            disc = np.exp(-float(p.r) * T)
            return disc - dig_call                # cash parity

    elif kind == "varswap":
        from mcos_tpu_torch.engine.exotics import variance_swap_fair_strike

        notional = float(product.get("notional", 1.0))

        def pf(p):
            return notional * variance_swap_fair_strike(p, T)[
                "fair_variance"]

    else:
        raise ValueError(f"unknown product kind {kind!r} "
                         "(vanilla|digital|varswap)")

    price = float(np.asarray(pf(params)).reshape(()))
    grad = _param_fd(params, free,
                     lambda p: np.asarray(pf(p), np.float64).reshape(1))
    return price, grad.reshape(-1)


def quote_bucket_greeks(params: SVJParams, spot: float, strikes, T,
                        product: Dict,
                        free: Sequence[str] = CORE4,
                        is_call: bool = True,
                        weights: Optional[np.ndarray] = None) -> Dict:
    """The headline API: dP/dq_i per calibration quote + the hedge view.

    `buckets[i]` doubles as the hedge position in quote i's vanilla; the
    response carries the hedge list (with each quote's expiry) plus the
    transfer diagnostics. Pass lists of strike vectors / maturities for
    surface buckets.
    """
    chains = _normalize_chains(strikes, T)
    tm = quote_transfer_matrix(params, spot, strikes, T, free=free,
                               is_call=is_call, weights=weights)
    price, grad = product_price_and_gradient(params, spot, product, free)
    buckets = grad @ tm["transfer"]                     # (n_quotes,)
    chain_p = _stacked_prices(params, spot, chains, is_call)
    quote_meta = [(float(k), t) for ks, t in chains for k in ks]
    return {
        "product_price": price,
        "buckets": buckets.tolist(),
        "strikes": [k for k, _ in quote_meta],
        "maturities": [t for _, t in quote_meta],
        "chain_prices": [float(c) for c in chain_p],
        "hedge": [
            {"strike": k, "T": t, "position": float(b),
             "quote_price": float(c)}
            for (k, t), b, c in zip(quote_meta, buckets, chain_p)],
        "hedge_cost": float(buckets @ chain_p),
        "free_params": tm["free"],
        "dP_dtheta": grad.tolist(),
        "dtheta_dq": tm["transfer"].tolist(),
        "condition_number": tm["condition_number"],
        "identified": tm["identified"],
    }
