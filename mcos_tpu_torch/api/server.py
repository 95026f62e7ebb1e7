"""HTTP serving layer of the port (counterpart of `mcos_tpu/api/server.py`,
serving slice).

    GET  /api/health
    POST /api/price        — pre/post guards, price, 50 sample paths,
                             1024 terminal samples, elapsed_ms; every request
                             option but sharding: Sobol or PRNG driver, Euler
                             or QE, importance sampling, RQMC
    POST /api/greeks       — all Greeks off one autograd pass; cross,
                             second-order and minimum-variance blocks,
                             strike chains, discrete dividends
    POST /api/smile        — a strike smile by MC (one shared path set)
                             or COS, IV-inverted, optional COS density
    POST /api/convergence  — prefix-mean convergence series
    POST /api/exotic       — Asian, single and double barriers, one-touch and
                             no-touch digitals, lookback, digital, variance
                             swap; optional Greeks
    POST /api/hhw          — Heston-Hull-White hybrid: price, greeks, impact
    POST /api/svcj         — SVCJ: price, greeks, smile, compare
    POST /api/termsvj      — time-dependent SVJ: price, compare, smile,
                             forward_start, cliquet, greeks, varswap,
                             calibrate, american
    POST /api/rough        — rough Bergomi: price, greeks, smile, skew,
                             asian, barrier, lookback, calibrate
    POST /api/stress       — the spot/vol/gap stress report, or the spot ×
                             vol scenario matrix
    POST /api/regime       — calm / event / crisis classification
    POST /api/hedge        — the delta-hedging backtest of a short option in
                             the gbm, svj or rough world (bs_delta, mv_delta,
                             ww_band)
    POST /api/var          — portfolio VaR/CVaR under a Gaussian (with Euler
                             contributions) or Student-t copula
    POST /api/american     — Longstaff-Schwartz American/Bermudan price, with
                             the dual bounds, the AD Greeks, the COS oracle
                             and the Crank-Nicolson exercise boundary
    POST /api/pde          — the Heston ADI (PIDE with jumps) solve: plain,
                             barrier, American with its boundary surface;
                             or the Black-Scholes Crank-Nicolson grid
    POST /api/calibrate    — two-stage Monte Carlo SVJ calibration (the DE
                             members on K1), optionally de-Americanized
    POST /api/surface      — IV surface, arbitrage report, SABR slice and
                             SSVI fits
    POST /api/quotegreeks  — market-quote bucket Greeks through the
                             calibration (host float64)
    POST /api/localvol     — Dupire surface + local-vol chain
    POST /api/slv          — particle-method SLV: chain, barrier,
                             forward_start
    POST /api/book         — a whole book's prices and AD Greeks
    POST /api/pnl          — P&L explain between two market states (COS)
    POST /api/margin       — SPAN-style 16-scenario portfolio margin
    POST /api/replicate    — static replication onto a vanilla call chain
    POST /api/exposure     — EE/ENE/PFE profiles, CVA/DVA, CVA delta
    POST /api/volderivs    — variance and vol swaps, VIX futures/options
    POST /api/modelrisk    — one contract under every model family
    POST /api/basket       — basket, rainbow and spread options on
                             correlated SVJ assets, the implied correlation
                             of a quote, the Bermudan LSM and its duality
                             bracket
    POST /api/cliquet      — cliquet and forward-start options
    POST /api/quanto       — quanto vanillas with the pathwise √v tilt
    POST /api/autocall     — Express notes, single-asset or worst-of, and
                             the par coupon
    POST /api/roughheston  — rough Heston: price, greeks (lifted MC, torch
                             step loop), smile, compare, skew, calibrate
                             (the fractional-Riccati COS oracle on the host)
    GET  /api/metrics      — per-route request counts, errors and latency
                             (max, p50, p95, p99 from a fixed histogram),
                             the coalescer's, Sobol cache's and kernel
                             library's counters, per-span-name totals
    GET  /api/quote        — a market quote (live, or the static NIFTY
                             universe when the network is unreachable)
    GET  /api/symbols      — the tradeable universe, `?q=` filters it
    GET  /, /index.html, /advanced, /static/... — the dashboard in `web/`

Every other route answers 404, as the JAX server does for unknown paths.

Transport: the stdlib ThreadingHTTPServer (`create_fastapi_app` builds the
same routes as an ASGI app where fastapi is installed). Every device
program goes onto the device's default stream. Before it serves, `serve`
builds the CUDA kernels and the default-shape Sobol net, so the first
client request does not pay for either (the kernels of `/api/exotic`,
`/api/hhw`, `/api/svcj`, `/api/termsvj` and `/api/rough` are in the same
library).

    python -m mcos_tpu_torch.api.server --device cuda --port 8000
"""

from __future__ import annotations

import argparse
import bisect
import json
import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from pydantic import ValidationError

from mcos_tpu_torch.api import coalesce, schemas
from mcos_tpu_torch.api.quotes import fetch_quote, list_symbols
from mcos_tpu_torch.engine.american import AmericanEngine, american_cos_oracle
from mcos_tpu_torch.engine.autocallable import (
    AutocallableEngine,
    WorstOfAutocallableEngine,
)
from mcos_tpu_torch.engine.basket import BasketEngine, implied_correlation
from mcos_tpu_torch.engine.book import BookEngine
from mcos_tpu_torch.engine.calibration import CalibrationEngine
from mcos_tpu_torch.engine.cliquet import CliquetEngine
from mcos_tpu_torch.engine.exotics import (
    ExoticEngine,
    variance_swap_fair_strike,
)
from mcos_tpu_torch.engine.exposure import ExposureEngine
from mcos_tpu_torch.engine.greeks import GreeksEngine
from mcos_tpu_torch.engine.guards import PricingGuard
from mcos_tpu_torch.engine.hedge import StaticHedgeEngine
from mcos_tpu_torch.engine.hhw import HHWEngine
from mcos_tpu_torch.engine.localvol import LocalVolEngine, LocalVolSurface
from mcos_tpu_torch.engine.margin import MarginEngine
from mcos_tpu_torch.engine.modelrisk import model_risk_report
from mcos_tpu_torch.engine.pde import HestonPDEEngine, PDEEngine
from mcos_tpu_torch.engine.pnl import pnl_explain
from mcos_tpu_torch.engine.quanto import QuantoEngine
from mcos_tpu_torch.engine.quotegreeks import (ALL_PARAMS, CORE4,
                                               quote_bucket_greeks)
from mcos_tpu_torch.engine.pricer import (MonteCarloEngine, seeded_generator,
                                          to_host)
from mcos_tpu_torch.engine.regime import RegimeDetector
from mcos_tpu_torch.engine.risk import (
    HedgingBacktest,
    StressTestEngine,
    _hedge_paths,
    compute_risk_metrics,
    portfolio_risk_contributions,
    portfolio_var,
)
from mcos_tpu_torch.engine.rough import RoughBergomiEngine, calibrate_rbergomi
from mcos_tpu_torch.engine.roughheston import (RoughHestonEngine,
                                               calibrate_rough_heston)
from mcos_tpu_torch.engine.slv import SLVEngine
from mcos_tpu_torch.engine.ssvi import calibrate_ssvi
from mcos_tpu_torch.engine.surface import (
    ArbitrageFreeSpline,
    calibrate_sabr,
    deamericanize_quotes,
    extract_iv_surface,
    implied_vol,
)
from mcos_tpu_torch.engine.svcj import SVCJEngine
from mcos_tpu_torch.models.params import SVJParams, forward_price
from mcos_tpu_torch.engine.termsvj import TDSVJEngine, bootstrap_calibrate_td
from mcos_tpu_torch.engine.volderivs import VolDerivsEngine
from mcos_tpu_torch.ops.cos_pricer import cos_density, cos_price
from mcos_tpu_torch.ops.hhw import HHWParams, hhw_cholesky
from mcos_tpu_torch.ops.rough import RoughBergomiParams
from mcos_tpu_torch.ops.roughheston import RoughHestonParams
from mcos_tpu_torch.utils import fastjson, spans

logger = logging.getLogger("mcos_tpu_torch.api")

# Admission control: a JSON body bigger than this is rejected before parsing.
MAX_BODY_BYTES = 10 * 1024 * 1024

VERSION = "1.0.0"


#: Upper edges (ms) of the latency histogram's buckets: eight a doubling
#: from 0.1 ms to about 28 minutes, and one bucket above for the rest.
_BUCKET_EDGES_MS = tuple(0.1 * 2.0 ** (i / 8) for i in range(8 * 24 + 1))


class _Metrics:
    """Per-route serving counters: requests, errors, the slowest request
    and a latency histogram of fixed log buckets, fed by each POST's
    `http.request` span as it closes (`utils/spans.py`).

    A percentile reads the upper edge of the bucket that holds the
    nearest-rank request, at most `max_ms`: never below the true value,
    and less than 2^(1/8) (9 %) above it. Thread-safe through a plain lock
    (the stdlib transport serves from a thread pool); GET /api/metrics
    returns `snapshot()`.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, dict] = {}
        self.started = time.time()

    def observe(self, path: str, ms: float, ok: bool) -> None:
        with self._lock:
            st = self._stats.get(path)
            if st is None:
                st = self._stats[path] = {
                    "count": 0, "errors": 0, "max_ms": 0.0,
                    "buckets": [0] * (len(_BUCKET_EDGES_MS) + 1)}
            st["count"] += 1
            if not ok:
                st["errors"] += 1
            st["max_ms"] = max(st["max_ms"], ms)
            st["buckets"][bisect.bisect_left(_BUCKET_EDGES_MS, ms)] += 1

    @staticmethod
    def _percentile(st: dict, p: float) -> float:
        rank = max(math.ceil(p / 100.0 * st["count"]), 1)
        seen = 0
        for i, n in enumerate(st["buckets"]):
            seen += n
            if seen >= rank:
                break
        edge = (_BUCKET_EDGES_MS[i] if i < len(_BUCKET_EDGES_MS)
                else st["max_ms"])
        return min(edge, st["max_ms"])

    def snapshot(self) -> dict:
        with self._lock:
            endpoints = {
                path: {"count": st["count"], "errors": st["errors"],
                       "max_ms": round(st["max_ms"], 2),
                       **{f"p{p}_ms": round(self._percentile(st, p), 2)
                          for p in (50, 95, 99)}}
                for path, st in self._stats.items()}
        return {
            "uptime_s": round(time.time() - self.started, 1),
            "endpoints": endpoints,
            "coalescer": {
                "window_ms": coalesce.coalescer.window_s * 1000,
                "batches_run": coalesce.coalescer.batches_run,
                "requests_coalesced": coalesce.coalescer.requests_coalesced,
            },
            "counters": spans.RECORDER.counters(),
            "spans": {name: {"count": t["count"],
                             "wall_ms": round(t["wall_ms"], 2),
                             "offcpu_ms": round(t["offcpu_ms"], 2)}
                      for name, t in spans.RECORDER.totals().items()},
        }


METRICS = _Metrics()


class ApiError(Exception):
    def __init__(self, status: int, detail):
        super().__init__(str(detail))
        self.status = status
        self.detail = detail


# ─────────────────────────────────────────────────────────────────────────────
# Endpoint implementations (transport-agnostic: dict in, dict out)
# ─────────────────────────────────────────────────────────────────────────────
def handle_health(_body: dict) -> dict:
    return {"status": "healthy", "engine": "SVJ Monte Carlo (PyTorch/CUDA)",
            "version": VERSION}


def handle_price(body: dict, device="cuda") -> dict:
    """`/api/price` on `device`, the JAX handler's contract."""
    req = schemas.PriceRequest(**body)
    start = time.time()
    svj = req.params.to_params()

    guard = PricingGuard(svj)
    pre = guard.check_pre_price(req.spot, req.strike, req.T)
    if not pre["pass"]:
        raise ApiError(400, {"failures": pre["failures"],
                             "alerts": pre["alerts"]})

    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
    except ValueError as e:
        raise ApiError(400, str(e))
    try:
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    engine_kwargs = dict(
        num_paths=req.num_paths, use_sobol=req.use_sobol,
        use_antithetic=req.use_antithetic,
        use_control_variate=req.use_control_variate, cv_mode=req.cv_mode,
        scheme=req.scheme, dividends=divs, rate_curve=curve, device=device)
    if req.num_steps is not None:
        engine_kwargs["num_steps"] = req.num_steps
    engine = MonteCarloEngine(svj, **engine_kwargs)
    if divs is not None:
        try:
            engine._spot_eff(req.spot, req.T)  # escrow feasibility → 400
        except ValueError as e:
            raise ApiError(400, str(e))

    # Micro-batching: concurrent same-shape requests join one batch
    # (api/coalesce.py); members enter with their maturity-effective params
    # and dividend-effective spot, so batching stays exact.
    ck = coalesce.bucket_key(req, device) if coalesce.enabled() else None
    if ck is not None:
        sl = coalesce.coalescer.submit(
            ck, (engine._params_T(req.T),
                 engine._spot_eff(req.spot, req.T), req.strike, req.T))
        result = engine.format_price(sl["res"], req.T)
        sample_paths, terms = sl["paths"], sl["terms"]
    else:
        # Solo path: enqueue both viz programs and the price program(s),
        # then one device→host copy for all of them.
        viz = {"paths": engine.sample_paths_device(req.spot, req.T,
                                                   num_samples=50),
               "terms": engine.terminal_samples_device(req.spot, req.T)}
        if req.use_importance:
            # Exponential tilt toward the strike + likelihood-ratio weights.
            res, shift = engine.price_importance_device(
                req.spot, req.strike, req.T, req.is_call)
            host = to_host({**viz, **res})
            result = engine.format_importance(host, req.T, shift)
        elif req.rqmc_randomizations:
            # R independent Owen scrambles → spread-based standard error.
            host = to_host({**viz, **engine.price_rqmc_device(
                req.spot, req.strike, req.T, req.is_call,
                randomizations=req.rqmc_randomizations)})
            result = engine.format_rqmc(host)
        else:
            host = to_host({**viz, **engine.price_device(
                req.spot, req.strike, req.T, req.is_call)})
            result = engine.format_price(host, req.T)
        sample_paths, terms = host["paths"], host["terms"]

    result["sample_paths"] = fastjson.float_array_json(sample_paths,
                                                       decimals=2)
    result["terminal_samples"] = fastjson.float_array_json(terms, decimals=2)
    return _finish_price(result, guard, pre, req, start)


def handle_greeks(body: dict, device="cuda") -> dict:
    """`/api/greeks` on `device`, the JAX handler's contract: all Greeks off
    one autograd pass, optional cross, second-order and minimum-variance
    blocks, a strike chain with one host sync, discrete dividends by the
    effective-spot chain rule."""
    req = schemas.GreeksRequest(**body)
    start = time.time()
    engine = GreeksEngine(req.params.to_params(), num_paths=req.num_paths,
                          device=device)
    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
    except ValueError as e:
        raise ApiError(400, str(e))
    if req.strikes:
        if req.with_cross or req.with_second_order:
            raise ApiError(400, "with_cross/with_second_order are not "
                                "supported in chain mode (strikes list) — "
                                "request those blocks per contract with a "
                                "single strike")
        if divs is not None:
            raise ApiError(400, "dividends are supported in single-contract "
                                "mode only (omit the strikes list)")
        greeks = {"chain": engine.all_greeks_chain(
            req.spot, req.strikes, req.T, req.is_call)}
    else:
        if req.strike <= 0:
            raise ApiError(400, "need strike > 0 (or a strikes list)")
        if divs is not None:
            try:
                greeks = engine.all_greeks_dividends(
                    req.spot, req.strike, req.T, req.is_call, divs)
            except ValueError as e:
                raise ApiError(400, str(e))
        else:
            greeks = engine.all_greeks(req.spot, req.strike, req.T,
                                       req.is_call)
        if req.with_cross:
            if divs is not None:
                # vanna = ∂²P/∂S∂σ picks up ∂S_eff/∂S; volga is spot-free.
                from mcos_tpu_torch.ops.dividends import effective_spot

                eff, f = effective_spot(req.spot, divs,
                                        float(engine.params.r), req.T)
                cross = engine.cross_greeks(eff, req.strike, req.T,
                                            req.is_call)
                for key in ("vanna", "vanna_cross_check", "vanna_v0"):
                    cross[key] *= f
                greeks["cross"] = cross
            else:
                greeks["cross"] = engine.cross_greeks(req.spot, req.strike,
                                                      req.T, req.is_call)
        if req.with_second_order:
            if divs is not None:
                # charm/color/veta mix ∂/∂T with the T-dependent dividend
                # adjustment: the first-order chain rule does not close.
                raise ApiError(400, "with_second_order is not supported "
                                    "with discrete dividends")
            greeks["second_order"] = engine.second_order_greeks(
                req.spot, req.strike, req.T, req.is_call)
        if req.with_min_variance:
            if divs is not None:
                raise ApiError(400, "with_min_variance is not supported "
                                    "with discrete dividends")
            greeks["min_variance"] = engine.min_variance_delta(
                req.spot, req.strike, req.T, req.is_call)
    greeks["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return greeks


def handle_smile(body: dict, device="cuda") -> dict:
    """`/api/smile` on `device`: strikes over 0.7-1.3·S priced off one
    shared path set (`method="mc"`: the default Sobol engine, one K1 launch
    on a CUDA device) or by COS (`"cos"`, on the host), IVs inverted per
    strike, optionally the COS risk-neutral density."""
    req = schemas.SmileRequest(**body)
    svj = req.params.to_params()
    try:
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    if curve is not None:
        svj = svj.replace(r=curve.r_eff(req.T))
    strikes = np.linspace(req.spot * 0.7, req.spot * 1.3, req.num_strikes)
    if req.method == "cos":
        prices = np.asarray(cos_price(svj, req.spot, strikes, req.T, True))
        rows = [{"strike": float(k), "price": float(p)}
                for k, p in zip(strikes, prices)]
    elif req.method == "mc":
        engine = MonteCarloEngine(svj, num_paths=req.num_paths,
                                  device=device)
        rows = engine.price_batch(req.spot, strikes, req.T, is_call=True)
    else:
        raise ApiError(400, f"unknown smile method {req.method!r}")
    smile = []
    for row in rows:
        iv = implied_vol(row["price"], req.spot, row["strike"], req.T,
                         float(svj.r), float(svj.q), True)
        smile.append({
            "strike": row["strike"],
            "price": row["price"],
            "iv": iv if iv is not None else 0.0,
        })
    out = {"smile": smile, "method": req.method}
    if req.with_density:
        s_grid, pdf = cos_density(svj, req.spot, req.T)
        out["density"] = {
            "s": [round(float(x), 2) for x in s_grid],
            "pdf": [float(x) for x in pdf],
            "forward": float(req.spot * np.exp((svj.r - svj.q) * req.T)),
        }
    return out


def handle_convergence(body: dict, device="cuda") -> dict:
    """`/api/convergence` on `device`: the prefix-mean convergence series of
    one PRNG path set (num_paths capped at 500 000), the JAX handler's
    contract."""
    req = schemas.PriceRequest(**body)
    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    engine = MonteCarloEngine(
        req.params.to_params(), num_paths=min(req.num_paths, 500_000),
        use_sobol=False, use_antithetic=req.use_antithetic,
        dividends=divs, rate_curve=curve, device=device)
    try:
        return engine.convergence(req.spot, req.strike, req.T, req.is_call)
    except ValueError as e:  # escrowed spot <= 0
        raise ApiError(400, str(e))


def handle_exotic(body: dict, device="cuda") -> dict:
    """`/api/exotic` on `device`: Asian, barrier, touch digitals, lookback,
    digital and variance swap, the JAX handler's contract. Every priced kind
    runs kernel K6 once (`digital` kernel K3); `with_greeks` adds the
    autograd pass through the torch twin, or for discrete barriers five
    more K6 prices."""
    req = schemas.ExoticRequest(**body)
    start = time.time()
    _WINDOW_KINDS = ("barrier", "one_touch", "double_barrier",
                     "double_no_touch", "double_one_touch")
    if req.window is not None and req.kind not in _WINDOW_KINDS:
        raise ApiError(400, f"window is not supported for kind "
                            f"{req.kind!r} (barrier-family kinds only)")
    eng = ExoticEngine(req.params.to_params(), num_paths=req.num_paths,
                       device=device)
    if req.kind == "asian":
        if req.strike is None:
            raise ApiError(400, "asian requires strike")
        out = eng.price_asian(req.spot, req.strike, req.T, req.is_call,
                              averaging=req.averaging)
    elif req.kind == "barrier":
        if req.strike is None or req.barrier is None:
            raise ApiError(400, "barrier requires strike and barrier")
        if req.rebate_at_hit and req.knock != "out":
            raise ApiError(400, "rebate_at_hit only applies to knock-outs")
        monitoring = req.monitoring
        if req.window is not None:
            if not 0.0 <= req.window[0] < req.window[1] <= req.T:
                raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
            if req.rebate:
                raise ApiError(400, "rebates on window barriers are not "
                                    "offered")
            # window barriers require the bridge estimator; default to it
            # unless the body explicitly asked for something else
            if "monitoring" not in body:
                monitoring = "bridge"
            elif monitoring != "bridge":
                raise ApiError(400, "window barriers need "
                                    "monitoring='bridge'")
        try:
            out = eng.price_barrier(
                req.spot, req.strike, req.T, req.barrier, req.is_call,
                knock=req.knock, monitoring=monitoring, rebate=req.rebate,
                rebate_at_hit=req.rebate_at_hit,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind == "one_touch":
        if req.barrier is None:
            raise ApiError(400, "one_touch requires barrier")
        monitoring = req.monitoring
        if req.window is not None:
            if not 0.0 <= req.window[0] < req.window[1] <= req.T:
                raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
            if "monitoring" not in body:
                monitoring = "bridge"
        try:
            out = eng.price_one_touch(
                req.spot, req.T, req.barrier, monitoring=monitoring,
                pay_at_hit=req.pay_at_hit,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind == "double_barrier":
        if req.strike is None or req.barrier is None or req.barrier_lo is None:
            raise ApiError(400, "double_barrier requires strike, barrier "
                                "(upper) and barrier_lo (lower)")
        if not req.barrier_lo < req.barrier:
            raise ApiError(400, "double_barrier needs barrier_lo < barrier")
        # bridge is the natural default for corridors (exact continuous
        # monitoring); an explicit request body still wins
        monitoring = req.monitoring if "monitoring" in body else "bridge"
        if req.rebate_at_hit:
            raise ApiError(400, "rebate_at_hit is not offered on double "
                                "barriers (corridor rebates pay at expiry)")
        if req.window is not None \
                and not 0.0 <= req.window[0] < req.window[1] <= req.T:
            raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
        try:
            out = eng.price_double_barrier(
                req.spot, req.strike, req.T, req.barrier_lo, req.barrier,
                req.is_call, knock=req.knock, monitoring=monitoring,
                rebate=req.rebate,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind in ("double_no_touch", "double_one_touch"):
        if req.barrier is None or req.barrier_lo is None:
            raise ApiError(400, f"{req.kind} requires barrier (upper) and "
                                "barrier_lo (lower)")
        if not req.barrier_lo < req.barrier:
            raise ApiError(400, f"{req.kind} needs barrier_lo < barrier")
        monitoring = req.monitoring if "monitoring" in body else "bridge"
        if req.window is not None \
                and not 0.0 <= req.window[0] < req.window[1] <= req.T:
            raise ApiError(400, "window needs 0 <= t1 < t2 <= T")
        try:
            out = eng.price_double_no_touch(
                req.spot, req.T, req.barrier_lo, req.barrier,
                touch=(req.kind == "double_one_touch"),
                monitoring=monitoring,
                window=tuple(req.window) if req.window else None)
        except ValueError as e:
            raise ApiError(400, str(e))
    elif req.kind == "lookback":
        out = eng.price_lookback(req.spot, req.T, req.is_call,
                                 strike=req.strike)
    elif req.kind == "digital":
        if req.strike is None:
            raise ApiError(400, "digital requires strike")
        out = eng.price_digital(req.spot, req.strike, req.T, req.is_call)
    elif req.kind == "variance_swap":
        out = variance_swap_fair_strike(req.params.to_params(), req.T)
    else:
        raise ApiError(400, f"unknown kind {req.kind!r}")
    if req.with_greeks:
        if req.kind in ("double_barrier", "double_no_touch",
                        "double_one_touch"):
            # corridor Greeks come from the bridge AD pass
            out["greeks"] = eng.greeks(
                req.spot, req.strike if req.strike is not None else 0.0,
                req.T,
                kind=("double_barrier" if req.kind == "double_barrier"
                      else "double_no_touch"),
                is_call=req.is_call, barrier=req.barrier,
                barrier_lo=req.barrier_lo,
                knock=("in" if req.kind == "double_one_touch"
                       else req.knock),
                monitoring="bridge", rebate=req.rebate,
                window=tuple(req.window) if req.window else None)
        elif req.kind == "one_touch":
            out["greeks"] = eng.greeks(
                req.spot, 0.0, req.T, kind="one_touch",
                barrier=req.barrier, monitoring="bridge",
                window=tuple(req.window) if req.window else None)
        elif req.kind == "barrier" and req.window is not None:
            out["greeks"] = eng.greeks(
                req.spot, req.strike if req.strike is not None else 0.0,
                req.T, kind="barrier", is_call=req.is_call,
                barrier=req.barrier, knock=req.knock,
                monitoring="bridge", window=tuple(req.window))
        elif req.kind == "barrier" and req.rebate:
            # rebated-contract greeks need the smooth bridge weight (the
            # CRN-FD homogeneity identity breaks for cash rebates); the
            # at-expiry rebate is what's differentiated — for at-hit
            # contracts the closed-form discount ratio is held fixed.
            out["greeks"] = eng.greeks(
                req.spot, req.strike if req.strike is not None else 0.0,
                req.T, kind="barrier", is_call=req.is_call,
                barrier=req.barrier, knock=req.knock,
                monitoring="bridge", rebate=req.rebate)
        else:
            out["greeks"] = eng.greeks(
                req.spot,
                req.strike if req.strike is not None else 0.0, req.T,
                kind=req.kind, is_call=req.is_call, barrier=req.barrier,
                knock=req.knock, averaging=req.averaging,
                floating=req.kind == "lookback" and req.strike is None)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_hhw(body: dict, device="cuda") -> dict:
    """`/api/hhw` on `device`: Heston-Hull-White hybrid, the JAX handler's
    contract. Modes price (kernel K7 once), impact (K7 twice, on common
    random numbers) and greeks (autograd through the torch twin). A
    correlation matrix that is not positive definite answers 400: each of
    the three correlations is bounded on its own, which does not bound the
    matrix."""
    req = schemas.HHWRequest(**body)
    start = time.time()
    params = HHWParams(kappa=req.kappa, theta=req.theta, xi=req.xi,
                       v0=req.v0, a=req.a, b=req.b, sigma_r=req.sigma_r,
                       r0=req.r0, rho_sv=req.rho_sv, rho_sr=req.rho_sr,
                       rho_vr=req.rho_vr, q=req.q)
    try:
        hhw_cholesky(params)
    except ValueError as e:
        raise ApiError(400, str(e))
    eng = HHWEngine(params, num_paths=req.num_paths,
                    num_steps=req.num_steps, device=device)
    if req.mode == "price":
        out = eng.price(req.spot, req.strike, req.T, is_call=req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, req.strike, req.T, is_call=req.is_call)
    elif req.mode == "impact":
        out = eng.rate_vol_impact(req.spot, req.strike, req.T,
                                  is_call=req.is_call)
    else:
        raise ApiError(400, f"unknown mode {req.mode!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_svcj(body: dict, device="cuda") -> dict:
    """`/api/svcj` on `device`: correlated price/variance jumps, the JAX
    handler's contract. Modes price and compare (kernel K8 once), greeks
    (autograd through the torch twin), smile (exact COS-implied vols, host
    only)."""
    req = schemas.SVCJRequest(**body)
    start = time.time()
    p = req.params.to_params()
    kwargs = {"num_paths": req.num_paths}
    if req.num_steps is not None:
        kwargs["num_steps"] = req.num_steps
    eng = SVCJEngine(p, device=device, **kwargs)
    strike = req.strike if req.strike > 0 else req.spot
    strikes = req.strikes or [m * req.spot
                              for m in (0.9, 0.95, 1.0, 1.05, 1.1)]
    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, req.is_call)
    elif req.mode == "smile":
        out = eng.smile(req.spot, req.T, strikes)
    elif req.mode == "compare":
        out = eng.mc_vs_cos(req.spot, strikes, req.T, req.is_call)
    else:
        raise ApiError(400, f"unknown mode {req.mode!r} "
                            "(price|greeks|smile|compare)")
    warnings = p.validate()
    if warnings:
        out["model_warnings"] = warnings
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_termsvj(body: dict, device="cuda") -> dict:
    """`/api/termsvj` on `device`: one piecewise-constant (θ(t), ξ(t),
    λ(t)) SVJ process across all expiries, the JAX handler's contract.
    Modes price and compare (kernel K9 once, beside the exact
    chained-Riccati COS), smile and calibrate (host only), forward_start,
    cliquet, greeks, varswap and american (the torch twins; american is
    the Longstaff-Schwartz of engine/american.py on the td sheet)."""
    req = schemas.TermSVJRequest(**body)
    start = time.time()
    shared = req.params.to_params()

    if req.mode == "calibrate":
        if not req.maturities or req.market_prices is None:
            raise ApiError(400, "calibrate mode needs maturities and "
                                "market_prices (one chain per maturity)")
        if not req.strikes:
            raise ApiError(400, "calibrate mode needs strikes")
        try:
            fit = bootstrap_calibrate_td(
                req.spot, req.maturities, req.strikes,
                np.asarray(req.market_prices, np.float64), shared,
                is_call=req.is_call)
        except ValueError as e:
            raise ApiError(400, str(e))
        return {
            "segments": [
                {"t_end": float(t), "theta": float(th), "xi": float(x),
                 "lambda_j": float(lm)}
                for t, th, x, lm in zip(fit["seg_ends"], fit["thetas"],
                                        fit["xis"], fit["lams"])
            ],
            "errors": {str(k): v for k, v in fit["errors"].items()},
            "elapsed_ms": round((time.time() - start) * 1000, 1),
        }

    if not req.segments:
        raise ApiError(400, "need at least one segment")
    seg_ends = [s.t_end for s in req.segments]
    thetas = [s.theta for s in req.segments]
    xis = [s.xi for s in req.segments]
    lams = [s.lambda_j for s in req.segments]
    eng = TDSVJEngine(shared, seg_ends, thetas, xis, lams,
                      num_paths=req.num_paths, num_steps=req.num_steps,
                      device=device)
    strike = req.strike if req.strike > 0 else req.spot
    strikes = req.strikes or [m * req.spot
                              for m in (0.9, 0.95, 1.0, 1.05, 1.1)]

    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, req.is_call)
        out["cos_price"] = float(
            eng.cos_chain(req.spot, [strike], req.T, req.is_call)[0])
        out["segments"] = eng.segments_dict()
    elif req.mode == "compare":
        exact = eng.cos_chain(req.spot, strikes, req.T, req.is_call)
        rows = eng.price_batch(req.spot, strikes, req.T, req.is_call)
        out = {"rows": [
            {**row, "cos_price": float(exact[i]),
             "abs_error_sigma": (abs(row["price"] - float(exact[i]))
                                 / max(row["std_error"], 1e-12))}
            for i, row in enumerate(rows)
        ]}
    elif req.mode == "smile":
        prices = eng.cos_chain(req.spot, strikes, req.T, True)
        smile = []
        for k, p in zip(strikes, prices):
            iv = implied_vol(float(p), req.spot, float(k), req.T,
                             float(shared.r), float(shared.q), True)
            smile.append({"strike": float(k), "price": float(p),
                          "iv": iv if iv is not None else 0.0})
        out = {"smile": smile}
    elif req.mode == "forward_start":
        if not (req.t1 and 0.0 < req.t1 < req.T):
            raise ApiError(400, "forward_start mode needs 0 < t1 < T")
        k_perf = req.strike if req.strike > 0 else 1.0
        try:
            out = eng.price_forward_start(req.spot, req.t1, req.T,
                                          k=k_perf, is_call=req.is_call)
        except ValueError as e:
            raise ApiError(400, str(e))
        out["segments"] = eng.segments_dict()
    elif req.mode == "cliquet":
        out = eng.price_cliquet(
            req.T, n_periods=req.n_periods, local_floor=req.local_floor,
            local_cap=req.local_cap, global_floor=req.global_floor,
            global_cap=req.global_cap, notional=req.notional)
        out["segments"] = eng.segments_dict()
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, req.is_call)
    elif req.mode == "american":
        out = eng.price_american(req.spot, strike, req.T, req.is_call)
        out["segments"] = eng.segments_dict()
    elif req.mode == "varswap":
        out = eng.variance_swap(req.T)
    else:
        raise ApiError(400, f"unknown mode {req.mode!r} "
                            "(price|compare|smile|forward_start|cliquet|"
                            "greeks|american|varswap|calibrate)")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_rough(body: dict, device="cuda") -> dict:
    """`/api/rough` on `device`: rough Bergomi, the JAX handler's contract.
    At num_steps = 512 without Sobol the engine lifts: price, smile and
    skew launch kernel K10 once, asian, barrier and lookback kernel K11
    once; below 512 steps, or with use_sobol, the exact sampler (one
    matmul) runs. greeks ride the differentiable twins, calibrate the
    batched DE + Adam over the exact sampler."""
    req = schemas.RoughRequest(**body)
    if req.moneyness is not None and len(req.moneyness) > schemas.MAX_GRID_POINTS:
        raise ApiError(400, f"moneyness grid > {schemas.MAX_GRID_POINTS}")
    start = time.time()
    params = RoughBergomiParams(xi=req.xi, eta=req.eta, rho=req.rho,
                                r=req.r, q=req.q, hurst=req.hurst)
    eng = RoughBergomiEngine(params, num_paths=req.num_paths,
                             num_steps=req.num_steps,
                             use_sobol=req.use_sobol, device=device)
    strike = req.strike if req.strike > 0 else req.spot
    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, is_call=req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, is_call=req.is_call)
    elif req.mode == "smile":
        out = eng.smile(req.spot, req.T, moneyness=req.moneyness)
    elif req.mode == "skew":
        out = eng.atm_skew(req.spot, req.T)
    elif req.mode == "asian":
        out = eng.price_asian(req.spot, strike, req.T, is_call=req.is_call)
    elif req.mode == "barrier":
        if req.barrier <= 0:
            raise ApiError(400, "barrier mode needs barrier > 0")
        out = eng.price_barrier(req.spot, strike, req.T, req.barrier,
                                is_call=req.is_call, knock=req.knock)
    elif req.mode == "lookback":
        out = eng.price_lookback(
            req.spot, req.T, is_call=req.is_call,
            strike=req.strike if req.strike > 0 else None)
    elif req.mode == "calibrate":
        if not (req.maturities and req.cal_strikes and req.market_prices):
            raise ApiError(400, "calibrate mode needs maturities, "
                                "cal_strikes, market_prices")
        mkt = np.asarray(req.market_prices, np.float64)
        ks = np.asarray(req.cal_strikes, np.float64)
        if ks.shape != mkt.shape or ks.shape[0] != len(req.maturities):
            raise ApiError(400, "cal_strikes/market_prices must be (m, k) "
                                "matching maturities")
        if mkt.size > schemas.MAX_GRID_POINTS * 8:
            raise ApiError(400, "calibration grid too large")
        kw = {}
        if req.hurst_grid:
            kw["hurst_grid"] = tuple(float(h) for h in req.hurst_grid[:8])
        out = calibrate_rbergomi(
            req.spot, req.maturities, ks, mkt, r=req.r, q=req.q,
            num_paths=min(req.num_paths, 65_536), num_steps=req.num_steps,
            device=device, **kw)
        p = out.pop("params")
        out["params"] = {"hurst": p.hurst, "eta": float(p.eta),
                         "rho": float(p.rho), "xi": float(p.xi)}
    else:
        raise ApiError(400, f"unknown mode {req.mode!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_stress(body: dict, device="cuda") -> dict:
    """`/api/stress` on `device`, the JAX handler's contract: the report
    (spot ladder and gap scenario on one K3 launch, one more a shocked vol
    member) or `mode="matrix"` (one K3 launch a vol row), every price on the
    engine's seed."""
    req = schemas.StressRequest(**body)
    start = time.time()
    engine = StressTestEngine(req.params.to_params(), num_paths=req.num_paths,
                              device=device)
    if req.mode == "matrix":
        if req.spot_shocks is not None and any(
                s <= -0.95 or s >= 4.0 for s in req.spot_shocks):
            raise ApiError(400, "spot_shocks must lie in (-0.95, 4.0)")
        if req.vol_shocks is not None and any(
                abs(s) > 1.0 for s in req.vol_shocks):
            raise ApiError(400, "vol_shocks must lie in [-1.0, 1.0]"
                                " (decimal vol points)")
        report = engine.scenario_matrix(
            req.spot, req.strike, req.T, req.is_call,
            spot_shocks=req.spot_shocks, vol_shocks=req.vol_shocks)
    else:
        report = engine.full_stress_report(req.spot, req.strike, req.T,
                                           req.is_call)
    report["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return report


def handle_regime(body: dict, device="cuda") -> dict:
    """`/api/regime`: the three-input classifier, on the host."""
    req = schemas.RegimeRequest(**body)
    return RegimeDetector().classify(req.realized_vol, req.iv_percentile,
                                     req.skew_slope)


def handle_hedge(body: dict, device="cuda") -> dict:
    """`/api/hedge` on `device`, the JAX handler's contract: the premium on
    one K3 launch (gbm and svj worlds; the rough world on the exact
    sampler), the day loop as torch ops; a ValueError of the backtest
    answers 400."""
    req = schemas.HedgeRequest(**body)
    start = time.time()
    bt = HedgingBacktest(req.params.to_params(), device=device)
    try:
        result = bt.run_backtest(
            req.spot, req.strike, req.T, req.is_call,
            txn_cost_bps=req.txn_cost_bps, slippage_bps=req.slippage_bps,
            num_scenarios=req.num_scenarios, dynamics=req.dynamics,
            hedge=req.hedge, risk_aversion=req.risk_aversion)
    except ValueError as e:
        raise ApiError(400, str(e))
    result["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return result


def handle_var(body: dict, device="cuda") -> dict:
    """`/api/var` on `device`: portfolio VaR/CVaR and Euler per-asset
    contributions, the JAX handler's contract, with one settled difference:
    a `corr` that is not a symmetric positive definite matrix answers 400
    (the JAX handler answers 200 with every figure NaN)."""
    req = schemas.VarRequest(**body)
    n = len(req.spots)
    if len(req.sigmas) != n or len(req.weights) != n or len(req.corr) != n:
        raise ApiError(400, "spots/sigmas/weights/corr dimensions must agree")
    start = time.time()
    try:
        if req.with_contributions and req.copula == "gaussian":
            out = portfolio_risk_contributions(
                req.spots, req.sigmas, req.corr, req.weights, req.T, r=req.r,
                q=req.q, num_paths=req.num_paths, confidence=req.confidence,
                device=device)
        else:
            out = portfolio_var(
                req.spots, req.sigmas, req.corr, req.weights, req.T, r=req.r,
                q=req.q, num_paths=req.num_paths, confidence=req.confidence,
                copula=req.copula, nu=req.nu, device=device)
    except ValueError as e:  # corr: not a symmetric positive definite matrix
        raise ApiError(400, str(e))
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_american(body: dict, device="cuda") -> dict:
    """`/api/american` on `device`: Longstaff-Schwartz American pricing,
    the JAX handler's contract (every option, every 400)."""
    req = schemas.AmericanRequest(**body)
    start = time.time()
    try:
        divs = schemas.build_dividend_schedule(req.dividends,
                                               req.dividend_kind)
    except ValueError as e:
        raise ApiError(400, str(e))
    try:
        curve = schemas.build_rate_curve(req.rate_curve)
    except ValueError as e:
        raise ApiError(400, str(e))
    eng = AmericanEngine(req.params.to_params(), num_paths=req.num_paths,
                         dividends=divs, rate_curve=curve, device=device)
    out = eng.price(req.spot, req.strike, req.T, req.is_call,
                    exercise_every=req.exercise_every)
    if req.with_bounds:
        if divs is not None or curve is not None:
            raise ApiError(400, "with_bounds does not support discrete "
                                "dividends or rate curves yet — use the "
                                "LSM price/greeks")
        out["bounds"] = eng.price_bounds(
            req.spot, req.strike, req.T, req.is_call,
            n_outer=req.n_outer, n_inner=req.n_inner)
    if req.with_greeks:
        out["greeks"] = eng.greeks(req.spot, req.strike, req.T, req.is_call)
    if req.with_cos_oracle:
        if divs is not None or curve is not None:
            raise ApiError(400, "with_cos_oracle does not support discrete "
                                "dividends or rate curves — the COS "
                                "induction needs iid log-increments")
        out["cos_oracle"] = american_cos_oracle(
            req.params.to_params(), req.spot, req.strike, req.T,
            req.is_call)
    if req.with_boundary:
        p = req.params.to_params()
        pde = PDEEngine(sigma=float(p.v0) ** 0.5, r=float(p.r),
                        q=float(p.q), n_t=128, device=device)
        prop = None
        if divs is not None:
            if divs.kind != "proportional":
                raise ApiError(400, "with_boundary supports proportional "
                                    "dividends only (the CN grid's jump "
                                    "condition is multiplicative)")
            prop = list(zip(divs.times, divs.amounts))
        bd = pde.exercise_boundary(req.spot, req.strike, req.T,
                                   req.is_call, dividends=prop)
        bd["note"] = ("Crank-Nicolson boundary under the BS proxy "
                      "sigma=sqrt(v0); the full SVJ boundary is a "
                      "surface in (S, v)")
        out["exercise_boundary"] = bd
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_pde(body: dict, device="cuda") -> dict:
    """`/api/pde` on `device`: deterministic finite-difference pricing,
    the JAX handler's contract: the 2-D ADI Heston solve (Craig-Sneyd or
    Douglas; the PIDE when lambda_j > 0) or the 1-D Crank-Nicolson BS
    grid. A no-Monte-Carlo cross-check route."""
    req = schemas.PDERequest(**body)
    start = time.time()
    p = req.params.to_params()
    if req.model == "heston":
        eng = HestonPDEEngine(p, n_x=req.n_x, n_v=req.n_v, n_t=req.n_t,
                              scheme=req.scheme, device=device)
        if req.barrier is not None:
            try:
                out = eng.price_barrier(
                    req.spot, req.strike, req.T, req.barrier, req.is_call,
                    knock=req.knock, direction=req.direction,
                    barrier_lo=req.barrier_lo, rebate=req.rebate,
                    rebate_at_hit=req.rebate_at_hit,
                    american=req.american)
            except ValueError as e:
                raise ApiError(400, str(e))
            out["model"] = req.model
            out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
            return out
        try:
            out = eng.price(req.spot, req.strike, req.T, req.is_call,
                            american=req.american)
            if req.with_boundary and req.american:
                out["exercise_boundary"] = eng.exercise_boundary(
                    req.spot, req.strike, req.T, req.is_call)
        except ValueError as e:
            # e.g. sigma_j == 0 with lambda_j > 0: the Merton cell-mass
            # quadrature has no density to integrate.
            raise ApiError(400, str(e))
        if req.with_oracle and not req.american:
            # cos_price is the exact BATES CF — the oracle covers the
            # PIDE route (lambda_j > 0) as well as pure Heston.
            exact = float(cos_price(p, req.spot, [req.strike], req.T,
                                    req.is_call)[0])
            out["cos_oracle"] = {"price": exact,
                                 "abs_error": abs(out["price"] - exact)}
    else:
        sigma = req.sigma if req.sigma is not None else float(p.v0) ** 0.5
        eng = PDEEngine(sigma=sigma, r=float(p.r), q=float(p.q),
                        n_x=req.n_x, n_t=req.n_t, device=device)
        out = eng.price(req.spot, req.strike, req.T, req.is_call,
                        american=req.american)
        if req.with_boundary and req.american:
            out["exercise_boundary"] = eng.exercise_boundary(
                req.spot, req.strike, req.T, req.is_call)
    out["model"] = req.model
    out["american"] = req.american
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_calibrate(body: dict, device="cuda") -> dict:
    """`/api/calibrate` on `device`: the two-stage Monte Carlo SVJ fit
    (the DE members on K1, the Adam polish on the twin), optionally
    de-Americanizing the quotes first; the JAX handler's 400s."""
    req = schemas.CalibrateRequest(**body)
    start = time.time()
    eng = CalibrationEngine(device=device)
    strikes = np.asarray(req.strikes, np.float32)
    market = np.asarray(req.market_prices, np.float32)
    spreads = (np.asarray(req.bid_ask_spreads, np.float32)
               if req.bid_ask_spreads is not None else None)
    atm_vol = req.atm_vol
    deamericanized = None
    if req.exercise == "american":
        ivs, eur, keep = deamericanize_quotes(
            req.spot, strikes, req.T, market, req.r, req.q, req.is_call)
        if keep.sum() < 4:
            raise ApiError(400, f"only {int(keep.sum())} quotes "
                                "de-Americanize cleanly (need >= 4)")
        strikes, market = strikes[keep], eur.astype(np.float32)
        if spreads is not None:
            spreads = spreads[keep]
        atm_idx = int(np.argmin(np.abs(
            strikes - req.spot * np.exp((req.r - req.q) * req.T))))
        atm_vol = float(ivs[atm_idx])
        deamericanized = {
            "ivs": [float(x) for x in ivs],
            "strikes_kept": [float(k) for k in strikes],
            "n_dropped": int(len(req.strikes) - keep.sum()),
        }
    elif req.exercise != "european":
        raise ApiError(400, f"unknown exercise {req.exercise!r}")
    result = eng.calibrate(
        req.spot, strikes, req.T, market, is_call=req.is_call,
        r=req.r, q=req.q, bid_ask_spreads=spreads,
        atm_vol=atm_vol, num_paths=req.num_paths)
    if deamericanized is not None:
        result["deamericanized"] = deamericanized
    params = result.pop("params")
    result["params"] = params.as_dict()
    result["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return result


def handle_surface(body: dict, device="cuda") -> dict:
    """`/api/surface`: IV surface extraction and arbitrage screening on
    the host, the SABR slice fits and the SSVI fit on `device`."""
    req = schemas.SurfaceRequest(**body)
    start = time.time()
    strikes = np.asarray(req.strikes, np.float64)
    mats = np.asarray(req.maturities, np.float64)
    surface = extract_iv_surface(
        req.spot, req.r, req.q, strikes, mats,
        np.asarray(req.call_prices, np.float64),
        np.asarray(req.put_prices, np.float64),
        bid_ask_spreads=(np.asarray(req.bid_ask_spreads, np.float64)
                         if req.bid_ask_spreads is not None else None),
        exercise=req.exercise)

    spline = ArbitrageFreeSpline()
    report = spline.fit(strikes, mats, surface["iv_call"])

    out = {
        "iv_call": np.where(np.isfinite(surface["iv_call"]),
                            surface["iv_call"], None).tolist(),
        "iv_put": np.where(np.isfinite(surface["iv_put"]),
                           surface["iv_put"], None).tolist(),
        "valid_mask": surface["valid_mask"].tolist(),
        "arbitrage_report": report,
    }
    if req.fit_sabr:
        sabr = {}
        for i, T in enumerate(mats):
            ivs = surface["iv_call"][i]
            ok = np.isfinite(ivs)
            if ok.sum() < 4:
                continue
            F = float(forward_price(req.spot, req.r, req.q, float(T)))
            sabr[str(float(T))] = calibrate_sabr(
                F, strikes[ok], float(T), ivs[ok], beta_fixed=0.8, iters=80,
                device=device)
        out["sabr_fits"] = sabr
    if req.fit_ssvi:
        rows_ok = [i for i in range(len(mats))
                   if np.isfinite(surface["iv_call"][i]).sum() >= 4]
        if len(rows_ok) >= 2:
            sel = np.asarray(rows_ok)
            fwds = np.array([forward_price(req.spot, req.r, req.q,
                                           float(mats[i])) for i in sel])
            fit = calibrate_ssvi(
                mats[sel], fwds,
                np.tile(strikes, (len(sel), 1)),
                surface["iv_call"][sel], iters=100, device=device)
            fit.pop("surface")
            out["ssvi_fit"] = fit
        else:
            out["ssvi_fit"] = {"error": "need >=2 maturities with >=4 "
                                        "valid quotes each"}
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_quotegreeks(body: dict, device="cuda") -> dict:
    """`/api/quotegreeks`: dP/d(market quote) through the calibration, by
    the implicit function theorem on the weighted-least-squares optimum
    with the exact COS chain Jacobian. Host float64 on every device;
    `device` is taken for the routing's sake."""
    del device
    req = schemas.QuoteGreeksRequest(**body)
    start = time.time()
    p = req.params.to_params()
    product = req.product.model_dump()
    if product["kind"] in ("vanilla", "digital") and product["strike"] <= 0:
        product["strike"] = req.spot
    free = tuple(req.free) if req.free else CORE4
    bad = [n for n in free if n not in ALL_PARAMS]
    if bad:
        raise ApiError(400, f"unknown free parameter(s): {bad}")
    try:
        out = quote_bucket_greeks(
            p, req.spot, req.strikes, req.T, product, free=free,
            is_call=req.is_call,
            weights=np.asarray(req.weights, np.float64)
            if req.weights else None)
    except ValueError as e:
        raise ApiError(400, str(e))
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_localvol(body: dict, device="cuda") -> dict:
    """`/api/localvol` on `device`: the Dupire surface built on the host,
    the chain priced by the local-vol step loop."""
    req = schemas.LocalVolRequest(**body)
    start = time.time()
    try:
        surf = LocalVolSurface.from_iv_points(
            req.spot, req.strikes, req.maturities,
            np.asarray(req.iv, np.float64), r=req.r, q=req.q)
    except ValueError as e:
        raise ApiError(400, str(e))
    eng = LocalVolEngine(surf, num_paths=req.num_paths,
                         num_steps=req.num_steps, device=device)
    chain = eng.price_batch(req.spot, req.price_strikes, req.T, req.is_call)
    return {
        "chain": chain,
        "local_vol_grid": {
            "t": surf.t_grid.tolist(),
            "y": surf.y_grid.tolist(),
            "local_vol": np.sqrt(surf.local_var).round(6).tolist(),
        },
        "elapsed_ms": round((time.time() - start) * 1000, 1),
    }


def handle_slv(body: dict, device="cuda") -> dict:
    """`/api/slv` on `device`: particle-method SLV (chain, barrier,
    forward_start), the JAX handler's 400s."""
    req = schemas.SLVRequest(**body)
    iv = np.asarray(req.iv, np.float64)
    if iv.shape != (len(req.maturities), len(req.strikes)):
        raise ApiError(400, "iv must be (num_maturities, num_strikes)")
    if req.mode in ("barrier", "chain") and not req.price_strikes:
        raise ApiError(400, f"{req.mode} mode needs non-empty price_strikes")
    start = time.time()
    try:
        surf = LocalVolSurface.from_iv_points(
            req.spot, req.strikes, req.maturities, iv, r=req.r, q=req.q)
    except ValueError as e:
        raise ApiError(400, str(e))
    heston = SVJParams(kappa=req.kappa, theta=req.theta, xi=req.xi,
                       rho=req.rho, v0=req.v0, lambda_j=0.0,
                       r=req.r, q=req.q)
    eng = SLVEngine(surf, heston, num_paths=req.num_paths,
                    num_steps=req.num_steps, device=device)
    if req.mode == "barrier":
        if req.barrier <= 0:
            raise ApiError(400, "barrier mode needs barrier > 0")
        out = eng.price_barrier(req.spot, req.price_strikes[0], req.T,
                                req.barrier, is_call=req.is_call,
                                knock=req.knock)
    elif req.mode == "forward_start":
        if not 0.0 < req.t1 < req.T:
            raise ApiError(400, "need 0 < t1 < T")
        out = eng.price_forward_start(req.spot, req.t1, req.T, k=req.k,
                                      is_call=req.is_call)
    elif req.mode == "chain":
        res = eng.price(req.spot, req.price_strikes, req.T,
                        is_call=req.is_call)
        out = {
            "chain": [{"strike": float(k), "price": p, "std_error": s}
                      for k, p, s in zip(req.price_strikes, res["price"],
                                         res["std_error"])],
            "mixing_xi": res["mixing_xi"],
            "num_paths_used": res["num_paths_used"],
        }
    else:
        raise ApiError(400, f"unknown mode {req.mode!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_margin(body: dict, device="cuda") -> dict:
    """`/api/margin` on `device`: SPAN-style portfolio margin, the
    16-scenario price/vol scan off one common-random-number path set a
    maturity (three K3 launches a maturity group)."""
    req = schemas.MarginRequest(**body)
    if not (len(req.strikes) == len(req.Ts) == len(req.is_calls)
            == len(req.quantities)):
        raise ApiError(400,
                       "strikes/Ts/is_calls/quantities must be equal length")
    start = time.time()
    eng = MarginEngine(req.params.to_params(), num_paths=req.num_paths,
                       price_scan_range=req.price_scan_range,
                       vol_scan_range=req.vol_scan_range,
                       extreme_multiplier=req.extreme_multiplier,
                       extreme_coverage=req.extreme_coverage, device=device)
    out = eng.margin(req.spot, req.strikes, req.Ts, req.is_calls,
                     req.quantities)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_replicate(body: dict, device="cuda") -> dict:
    """`/api/replicate` on `device`: static replication of a (possibly
    path-dependent) payoff onto a vanilla chain; the paths are one K6
    launch, the L² projection host float64, the hedge valued by COS."""
    req = schemas.ReplicateRequest(**body)
    if req.kind in ("digital", "vanilla", "asian") and req.strike <= 0:
        raise ApiError(400, f"kind={req.kind} needs strike > 0")
    if req.kind == "barrier" and req.barrier <= 0:
        raise ApiError(400, "kind=barrier needs barrier > 0")
    if req.kind == "lookback" and not req.floating and req.strike <= 0:
        raise ApiError(400, "fixed-strike lookback needs strike > 0")
    start = time.time()
    eng = StaticHedgeEngine(req.params.to_params(), num_paths=req.num_paths,
                            device=device)
    try:
        out = eng.replicate(
            req.spot, req.T, kind=req.kind, strike=req.strike,
            is_call=req.is_call, barrier=req.barrier,
            averaging=req.averaging, knock=req.knock,
            direction=req.direction, floating=req.floating,
            hedge_strikes=req.hedge_strikes, n_hedge=req.n_hedge)
    except ValueError as e:
        raise ApiError(400, str(e))
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_volderivs(body: dict, device="cuda") -> dict:
    """`/api/volderivs` on `device`: variance/vol swaps (the
    realized-variance step loop) and VIX futures/options (host quadrature;
    `with_mc_check` one K4 launch)."""
    req = schemas.VolDerivsRequest(**body)
    start = time.time()
    eng = VolDerivsEngine(req.params.to_params(), num_paths=req.num_paths,
                          device=device)
    if req.kind == "variance_swap":
        out = eng.variance_swap(req.T)
    elif req.kind == "vol_swap":
        out = eng.vol_swap(req.T)
    elif req.kind == "vix_future":
        out = eng.vix_future(req.T, tau=req.tau, convention=req.convention)
        if req.with_mc_check:
            out["mc_check"] = eng.vix_future_mc(req.T, tau=req.tau,
                                                convention=req.convention)
    else:  # vix_option
        if req.strike is None:
            raise ApiError(400, "vix_option requires strike (in vol units)")
        out = eng.vix_option(req.T, req.strike, req.is_call,
                             tau=req.tau, convention=req.convention)
    out["kind"] = req.kind
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_book(body: dict, device="cuda") -> dict:
    """`/api/book` on `device`: whole-portfolio prices and Greeks, one step
    loop of the member twin under autograd (no kernel)."""
    req = schemas.BookRequest(**body)
    if not (len(req.spots) == len(req.strikes) == len(req.Ts)
            == len(req.is_calls)):
        raise ApiError(400, "spots/strikes/Ts/is_calls must be equal length")
    start = time.time()
    eng = BookEngine(req.params.to_params(), num_paths=req.num_paths,
                     device=device)
    out = eng.price_book(req.spots, req.strikes, req.Ts, req.is_calls,
                         req.quantities)
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in out.items()}
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_modelrisk(body: dict, device="cuda") -> dict:
    """`/api/modelrisk` on `device`: the model-risk band across the model
    zoo (the COS legs on the host, rough on the exact sampler, hhw one K7
    launch)."""
    req = schemas.ModelRiskRequest(**body)
    start = time.time()
    out = model_risk_report(
        req.spot, req.strike, req.T, is_call=req.is_call,
        atm_vol=req.atm_vol, r=req.r, q=req.q,
        svj=req.params.to_params() if req.params is not None else None,
        num_paths=req.num_paths, device=device)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_pnl(body: dict, device="cuda") -> dict:
    """`/api/pnl`: Greeks-based attribution of a price move between two
    market states, COS on the host (no device work)."""
    req = schemas.PnlRequest(**body)
    start = time.time()
    out = pnl_explain(req.params_old.to_params(),
                      req.params_new.to_params(),
                      req.spot_old, req.spot_new, req.T_old, req.T_new,
                      req.strike, is_call=req.is_call,
                      quantity=req.quantity)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_exposure(body: dict, device="cuda") -> dict:
    """`/api/exposure` on `device`: EE/ENE/PFE profile, CVA/DVA (with wrong-way
    risk) and the autograd CVA delta for a vanilla netting set, the JAX
    handler's contract: a `corr` that is not positive definite raises
    `np.linalg.LinAlgError` there and here, which the transport answers
    500."""
    req = schemas.ExposureRequest(**body)
    positions = [schemas.ExposurePosition(**p).model_dump()
                 for p in req.positions]
    if not positions or len(positions) > schemas.MAX_BOOK_POSITIONS:
        raise ApiError(400, f"need 1..{schemas.MAX_BOOK_POSITIONS} positions")
    n = len(req.spots)
    if len(req.sigmas) != n or len(req.corr) != n:
        raise ApiError(400, "spots/sigmas/corr dimensions must agree")
    start = time.time()
    eng = ExposureEngine(req.spots, req.sigmas,
                         np.asarray(req.corr, np.float64), positions,
                         r=req.r, q=req.q, num_paths=req.num_paths,
                         device=device)
    out = eng.profile(num_dates=req.num_dates, quantile=req.quantile,
                      collateral_threshold=req.collateral_threshold,
                      margin_period=req.margin_period)
    if req.hazard_rate > 0.0:
        out["credit"] = eng.cva(hazard_rate=req.hazard_rate, lgd=req.lgd,
                                num_dates=req.num_dates,
                                own_hazard=req.own_hazard)
        if req.wwr_gamma != 0.0:
            out["credit"]["wwr"] = eng.cva_wwr(
                hazard_rate=req.hazard_rate, lgd=req.lgd,
                gamma=req.wwr_gamma, num_dates=req.num_dates)
    if req.with_cva_delta:
        out["cva_delta"] = eng.cva_delta(
            hazard_rate=req.hazard_rate, lgd=req.lgd,
            num_dates=req.num_dates)["cva_delta"]
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_basket(body: dict, device="cuda") -> dict:
    """`/api/basket` on `device`: European basket, rainbow and spread
    options on correlated SVJ assets, the flat implied correlation of a
    basket quote, and the Bermudan LSM with its duality bracket (torch step
    loops, no kernel). The JAX handler's contract: a `corr` that does not
    factor (not PSD, or rows of the wrong length) raises ValueError outside
    the handler's checks, which the transport answers 500."""
    req = schemas.BasketRequest(**body)
    n = len(req.spots)
    if len(req.corr) != n:
        raise ApiError(400, "spots/corr dimensions must agree")
    if req.payoff == "basket" and len(req.weights) != n:
        raise ApiError(400, "basket payoff needs one weight per spot")
    if req.payoff == "spread" and n != 2:
        raise ApiError(400, "spread payoff needs exactly 2 assets")
    params = ([p.to_params() for p in req.params] if req.params
              else [schemas.SVJParamsRequest().to_params()] * n)
    if len(params) != n:
        raise ApiError(400, "params list must match spots length")
    start = time.time()
    if req.implied_corr_from_price is not None:
        if req.payoff != "basket":
            raise ApiError(400, "implied correlation needs payoff=basket")
        try:
            out = implied_correlation(
                params, req.spots, req.weights, req.strike, req.T,
                req.implied_corr_from_price, is_call=req.is_call,
                num_paths=min(req.num_paths, 200_000), device=device)
        except ValueError as e:
            raise ApiError(400, str(e))
        out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
        return out
    eng = BasketEngine(params, np.asarray(req.corr, np.float64),
                       num_paths=req.num_paths, device=device)
    if req.american:
        kind = {"basket": "basket", "best_of": "max",
                "worst_of": "min"}.get(req.payoff)
        if kind is None:
            raise ApiError(400, "american supports payoff basket/"
                                "worst_of/best_of (not spread)")
        weights = req.weights if kind == "basket" else None
        try:
            out = eng.price_american(
                req.spots, req.strike, req.T, kind=kind,
                is_call=req.is_call, weights=weights, n_ex=req.n_exercise,
                steps_per_period=req.steps_per_period)
            if req.with_bounds:
                out["bounds"] = eng.price_bounds_american(
                    req.spots, req.strike, req.T, kind=kind,
                    is_call=req.is_call, weights=weights,
                    n_ex=req.n_exercise,
                    steps_per_period=req.steps_per_period,
                    n_outer=req.n_outer, n_inner=req.n_inner)
        except ValueError as e:
            raise ApiError(400, str(e))
        out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
        return out
    if req.payoff == "basket":
        out = eng.price(req.spots, req.weights, req.strike, req.T,
                        req.is_call)
    elif req.payoff in ("worst_of", "best_of"):
        out = eng.price_rainbow(req.spots, req.strike, req.T,
                                kind=req.payoff, is_call=req.is_call)
    elif req.payoff == "spread":
        out = eng.price_spread(req.spots, req.strike, req.T, req.is_call)
    else:
        raise ApiError(400, f"unknown payoff {req.payoff!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_cliquet(body: dict, device="cuda") -> dict:
    """`/api/cliquet` on `device`: a cliquet or a forward start, the
    period loop of torch ops (no kernel)."""
    req = schemas.CliquetRequest(**body)
    start = time.time()
    eng = CliquetEngine(req.params.to_params(), num_paths=req.num_paths,
                        steps_per_period=req.steps_per_period, device=device)
    if req.kind == "cliquet":
        out = eng.price_cliquet(
            req.T, n_periods=req.n_periods, local_floor=req.local_floor,
            local_cap=req.local_cap, global_floor=req.global_floor,
            global_cap=req.global_cap, notional=req.notional)
    elif req.kind == "forward_start":
        if not 0.0 < req.t1 < req.T:
            raise ApiError(400, "need 0 < t1 < T")
        out = eng.price_forward_start(req.t1, req.T, k=req.k,
                                      is_call=req.is_call)
    else:
        raise ApiError(400, f"unknown kind {req.kind!r}")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_quanto(body: dict, device="cuda") -> dict:
    """`/api/quanto` on `device`: a quanto vanilla with the pathwise √v
    tilt and the exact companion control, a step loop of torch ops (no
    kernel)."""
    req = schemas.QuantoRequest(**body)
    start = time.time()
    eng = QuantoEngine(req.params.to_params(), req.r_domestic,
                       req.sigma_fx, req.rho_fx, num_paths=req.num_paths,
                       num_steps=req.num_steps, device=device)
    out = eng.price(req.spot, req.strike, req.T, is_call=req.is_call,
                    fx_fixed=req.fx_fixed)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_autocall(body: dict, device="cuda") -> dict:
    """`/api/autocall` on `device`: an Express note's price and
    early-redemption accounting, on one asset or the worst of up to 16
    correlated ones (torch step loops, no kernel). The JAX handler's
    contract: a worst-of book with mixed `r`, a `corr` that does not
    factor and a `solve_par` with no feasible coupon raise ValueError,
    which the transport answers 500."""
    req = schemas.AutocallRequest(**body)
    if not (req.protection_barrier <= req.coupon_barrier
            <= req.autocall_barrier):
        raise ApiError(400, "need protection <= coupon <= autocall barrier")
    start = time.time()
    if req.params_list is not None:
        if req.corr is None or len(req.corr) != len(req.params_list):
            raise ApiError(400, "worst-of needs corr matching params_list")
        if len(req.params_list) > 16:
            raise ApiError(400, "at most 16 basket assets")
        plist = [schemas.SVJParamsRequest(**p).to_params()
                 for p in req.params_list]
        eng = WorstOfAutocallableEngine(
            plist, np.asarray(req.corr, np.float64),
            num_paths=req.num_paths,
            steps_per_period=req.steps_per_period, device=device)
    else:
        eng = AutocallableEngine(req.params.to_params(),
                                 num_paths=req.num_paths,
                                 steps_per_period=req.steps_per_period,
                                 device=device)
    terms = dict(n_obs=req.n_obs, autocall_barrier=req.autocall_barrier,
                 coupon_barrier=req.coupon_barrier,
                 protection_barrier=req.protection_barrier,
                 notional=req.notional)
    if req.solve_par:
        out = eng.solve_par_coupon(req.T, target=req.par_target, **terms)
    else:
        out = eng.price(req.T, coupon=req.coupon,
                        final_coupon=req.final_coupon, **terms)
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_roughheston(body: dict, device="cuda") -> dict:
    """`/api/roughheston` on `device`: rough Heston, the JAX handler's
    contract. price, greeks and compare run the lifted Monte Carlo (a
    torch step loop over the factor block, one step's normals at a time:
    no kernel of the repo); smile, skew and calibrate run the
    fractional-Riccati COS oracle on the host."""
    req = schemas.RoughHestonRequest(**body)
    start = time.time()
    p = RoughHestonParams(lam=req.lam, theta=req.theta, nu=req.nu,
                          rho=req.rho, v0=req.v0, r=req.r, q=req.q,
                          hurst=req.hurst)
    kwargs = {"num_paths": req.num_paths, "n_factors": req.n_factors}
    if req.num_steps is not None:
        kwargs["num_steps"] = req.num_steps
    eng = RoughHestonEngine(p, device=device, **kwargs)
    strike = req.strike if req.strike > 0 else req.spot
    strikes = req.strikes or [m * req.spot
                              for m in (0.9, 0.95, 1.0, 1.05, 1.1)]
    if req.mode == "price":
        out = eng.price(req.spot, strike, req.T, req.is_call)
    elif req.mode == "greeks":
        out = eng.greeks(req.spot, strike, req.T, req.is_call)
    elif req.mode == "smile":
        out = eng.smile(req.spot, req.T, strikes)
    elif req.mode == "compare":
        out = eng.mc_vs_cos(req.spot, strikes, req.T, req.is_call)
    elif req.mode == "skew":
        mats = req.maturities or [0.02, 0.05, 0.1, 0.25, 0.5, 1.0]
        out = eng.atm_skew_term_structure(req.spot, mats)
    elif req.mode == "calibrate":
        if not req.strikes or req.market_prices is None:
            raise ApiError(400, "calibrate mode needs strikes and "
                                "market_prices")
        if len(req.strikes) != len(req.market_prices):
            raise ApiError(400, "strikes and market_prices length mismatch")
        try:
            fit = calibrate_rough_heston(
                req.spot, req.strikes, req.T, req.market_prices,
                r=req.r, q=req.q, is_call=req.is_call,
                hurst=None if req.fit_hurst else req.hurst)
        except RuntimeError as e:
            raise ApiError(400, str(e))
        out = {k: v for k, v in fit.items() if k != "params"}
    else:
        raise ApiError(400, f"unknown mode {req.mode!r} "
                            "(price|greeks|smile|compare|skew|calibrate)")
    out["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    return out


def handle_quote(query: dict) -> dict:
    """GET /api/quote?symbol=… — a live quote, else the static universe's
    (`api/quotes.py`); 400 without a symbol, 503 for an unknown one."""
    symbol = (query.get("symbol") or [""])[0]
    if not symbol:
        raise ApiError(400, "missing ?symbol=")
    quote = fetch_quote(symbol)
    if quote is None:
        raise ApiError(503, f"no quote available for {symbol}")
    return quote


def handle_symbols(query: dict) -> dict:
    """GET /api/symbols — the tradeable universe (50 NIFTY constituents +
    the index) for the UI's picker; `?q=` filters on symbol, name or
    sector (case-insensitive substring)."""
    rows = list_symbols()
    q = (query.get("q", [""])[0] or "").strip().lower()
    if q:
        rows = [row for row in rows
                if q in row["symbol"].lower() or q in row["name"].lower()
                or q in row["sector"].lower()]
    return {"symbols": rows}


_POST_ROUTES: Dict[str, Callable[..., dict]] = {"/api/price": handle_price,
                "/api/greeks": handle_greeks,
                "/api/smile": handle_smile,
                "/api/convergence": handle_convergence,
                "/api/exotic": handle_exotic,
                "/api/hhw": handle_hhw,
                "/api/svcj": handle_svcj,
                "/api/termsvj": handle_termsvj,
                "/api/rough": handle_rough,
                "/api/stress": handle_stress,
                "/api/regime": handle_regime,
                "/api/hedge": handle_hedge,
                "/api/var": handle_var,
                "/api/american": handle_american,
                "/api/pde": handle_pde,
                "/api/calibrate": handle_calibrate,
                "/api/surface": handle_surface,
                "/api/quotegreeks": handle_quotegreeks,
                "/api/localvol": handle_localvol,
                "/api/slv": handle_slv,
                "/api/book": handle_book,
                "/api/pnl": handle_pnl,
                "/api/margin": handle_margin,
                "/api/replicate": handle_replicate,
                "/api/exposure": handle_exposure,
                "/api/volderivs": handle_volderivs,
                "/api/modelrisk": handle_modelrisk,
                "/api/basket": handle_basket,
                "/api/cliquet": handle_cliquet,
                "/api/quanto": handle_quanto,
                "/api/autocall": handle_autocall,
                "/api/roughheston": handle_roughheston}


def _finish_price(result: dict, guard: PricingGuard, pre: dict, req,
                  start: float) -> dict:
    """Shared tail of /api/price: post-guards, timing, request echo."""
    post = guard.check_post_price(result, req.spot, req.strike, req.T,
                                  req.is_call)
    result["elapsed_ms"] = round((time.time() - start) * 1000, 1)
    result["pre_checks"] = pre
    result["post_checks"] = post
    result["params_used"] = req.params.model_dump()
    logger.info("Priced %s K=%.0f T=%.4f → %.4f (%.0fms)",
                "Call" if req.is_call else "Put", req.strike, req.T,
                result["price"], result["elapsed_ms"])
    return result


# ─────────────────────────────────────────────────────────────────────────────
# Static UI: the dashboard in the repo's `web/`, behind a traversal guard
# ─────────────────────────────────────────────────────────────────────────────
WEB_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "web"))
_MIME = {".html": "text/html", ".js": "application/javascript",
         ".css": "text/css", ".svg": "image/svg+xml", ".png": "image/png"}


def _static_file(name: str) -> Optional[Tuple[bytes, str]]:
    path = os.path.normpath(os.path.join(WEB_DIR, name))
    # The trailing separator keeps sibling directories (`web2/`) out.
    if not path.startswith(WEB_DIR + os.sep) or not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    return data, _MIME.get(os.path.splitext(path)[1],
                           "application/octet-stream")


# ─────────────────────────────────────────────────────────────────────────────
# stdlib transport
# ─────────────────────────────────────────────────────────────────────────────
class _Handler(BaseHTTPRequestHandler):
    server_version = f"mcos-tpu-torch/{VERSION}"
    # Socket read timeout against clients that never finish their body.
    timeout = 30

    def _security_headers(self, cache: str) -> None:
        self.send_header("X-Content-Type-Options", "nosniff")
        self.send_header("X-Frame-Options", "DENY")
        self.send_header("Referrer-Policy", "strict-origin-when-cross-origin")
        self.send_header("Cache-Control", cache)

    def _send_json(self, status: int, payload) -> None:
        with spans.span("http.send"):
            data = fastjson.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            # CORS-any, as the reference configures it.
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "*")
            self.send_header("Access-Control-Allow-Headers", "*")
            self._security_headers("no-store")
            self.end_headers()
            self.wfile.write(data)

    def do_OPTIONS(self):  # CORS preflight
        self._send_json(204, {})

    def _send_file(self, data: bytes, mime: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", mime)
        self.send_header("Content-Length", str(len(data)))
        # The HTML shell revalidates; its subresources cache for a year.
        cache = ("public, max-age=0, must-revalidate"
                 if mime == "text/html"
                 else "public, max-age=31536000, immutable")
        self._security_headers(cache)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug(fmt, *args)

    def do_GET(self):
        parsed = urlparse(self.path)
        try:
            if parsed.path == "/api/health":
                self._send_json(200, handle_health({}))
            elif parsed.path == "/api/metrics":
                self._send_json(200, METRICS.snapshot())
            elif parsed.path == "/api/quote":
                self._send_json(200, handle_quote(parse_qs(parsed.query)))
            elif parsed.path == "/api/symbols":
                self._send_json(200, handle_symbols(parse_qs(parsed.query)))
            elif parsed.path in ("/", "/index.html", "/advanced"):
                hit = _static_file("index.html")
                if hit:
                    self._send_file(*hit)
                else:
                    self._send_json(404, {"detail": "UI not bundled"})
            elif parsed.path.startswith("/static/"):
                hit = _static_file(parsed.path[len("/static/"):])
                if hit:
                    self._send_file(*hit)
                else:
                    self._send_json(404, {"detail": "not found"})
            else:
                self._send_json(404, {"detail": "not found"})
        except ApiError as e:
            self._send_json(e.status, {"detail": e.detail})
        except Exception as e:  # noqa: BLE001 — the server must not die
            logger.exception("GET %s failed", parsed.path)
            self._send_json(500, {"detail": str(e)})

    def do_POST(self):
        path = urlparse(self.path).path
        handler = _POST_ROUTES.get(path)
        if handler is None:
            self._send_json(404, {"detail": "not found"})
            return
        ok = False
        spans.RECORDER.open("http.request", spans.NEW_REQUEST)
        try:
            with spans.span("http.parse"):
                length = int(self.headers.get("Content-Length", 0))
                too_large = length > MAX_BODY_BYTES
                if not too_large:
                    body = json.loads(self.rfile.read(max(length, 0))
                                      or b"{}")
            if too_large:
                self._send_json(413, {"detail": "request body too large"})
                return
            with spans.span("handler"):
                out = handler(body, device=self.server.device)
            ok = True
            self._send_json(200, out)
        except ApiError as e:
            self._send_json(e.status, {"detail": e.detail})
        except (ValidationError, json.JSONDecodeError) as e:
            self._send_json(422, {"detail": str(e)})
        except Exception as e:  # noqa: BLE001 — the server must not die
            logger.exception("POST %s failed", path)
            self._send_json(500, {"detail": str(e)})
        finally:
            METRICS.observe(path, spans.RECORDER.close() / 1e6, ok)


def warm(device) -> None:
    """Build the CUDA kernels (on a CUDA device) and the default-shape Sobol
    net before serving. On a CUDA device, also run one tiny rough Bergomi
    `greeks` on the lift and one tiny `GreeksEngine.all_greeks`: the first
    `torch.utils.checkpoint` pass imports torch's compiler modules, and the
    first autograd pass on a device starts its engine threads, seconds that
    would otherwise land on the first such request. And one tiny
    hedge day loop and VaR request, so that the first risk-desk request
    does not load the device code of its torch ops (sort, top-k, the gamma
    sampler, the day loop's elementwise ops); and a tiny American price
    and PDE grid for the linear-algebra libraries they load."""
    device = torch.device(device)
    if device.type == "cuda":
        from mcos_tpu_torch.ops import cuda_kernels

        cuda_kernels.load_library()
        RoughBergomiEngine(RoughBergomiParams(), num_paths=256, num_steps=8,
                           sampler="lift", device=device).greeks(
            1.0, 1.0, 0.25)
        GreeksEngine(schemas.SVJParamsRequest().to_params(), num_paths=1024,
                     num_steps=64, device=device).all_greeks(1.0, 1.0, 0.25)
        # The risk desk's warm-ups launch no kernel (the hedge's day loop
        # without its premium): a caller that counts launches after
        # `serve` counts requests only.
        hedge = _hedge_paths(
            schemas.SVJParamsRequest().to_params(), 100.0, 100.0, 0.05, 1.0,
            seeded_generator(0, device), num_days=2, num_scenarios=64,
            is_call=True, txn_cost_bps=5.0, slippage_bps=2.0,
            dynamics="svj", hedge="ww_band", device=device)[0]
        compute_risk_metrics(hedge)
        book = {"spots": [100.0, 50.0], "sigmas": [0.2, 0.3],
                "weights": [0.5, 0.5], "corr": [[1.0, 0.3], [0.3, 1.0]],
                "T": 0.05, "num_paths": 1024}
        handle_var(book, device=device)
        handle_var(dict(book, copula="student_t"), device=device)
        # Slice H: the first batched inverse and small linear solves load the
        # device code of cuSOLVER and cuBLAS; a tiny American price (with
        # its autograd Greeks) and tiny grids, no kernel of the repo.
        am = AmericanEngine(schemas.SVJParamsRequest().to_params(),
                            num_paths=1024, device=device)
        am.price(1.0, 1.0, 0.1, False)
        am.greeks(1.0, 1.0, 0.1, False)
        HestonPDEEngine(schemas.SVJParamsRequest(lambda_j=0.0).to_params(),
                        n_x=51, n_v=21, n_t=16, device=device).price(
            1.0, 1.0, 0.1, american=True)
        PDEEngine(sigma=0.2, n_x=51, n_t=16, device=device).price(
            1.0, 1.0, 0.1, american=True, dividends=[(0.05, 0.01)])
    req = schemas.PriceRequest(spot=22500.0, strike=22500.0, T=0.25)
    eng = MonteCarloEngine(req.params.to_params(), num_paths=req.num_paths,
                           device=device)
    eng._sobol_draws(eng._steps(req.T))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(host: str = "0.0.0.0", port: int = 8000,
          device="cuda") -> ThreadingHTTPServer:
    """Warm the device, then bind; the caller runs `serve_forever()`."""
    warm(device)
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.device = torch.device(device)
    logger.info("mcos_tpu_torch API on %s:%d (device %s)", host,
                httpd.server_address[1], httpd.device)
    return httpd


def create_fastapi_app(device="cuda"):
    """The same routes as an ASGI app, where fastapi is installed: GET
    /api/health and every POST route on `device`, with the stdlib
    transport's 4xx contract."""
    from fastapi import FastAPI, HTTPException
    from fastapi.middleware.cors import CORSMiddleware

    app = FastAPI(title="NIFTY Monte Carlo Engine (PyTorch/CUDA)",
                  description="The SVJ pricing & risk engine on one GPU",
                  version=VERSION)
    app.add_middleware(CORSMiddleware, allow_origins=["*"],
                       allow_methods=["*"], allow_headers=["*"])

    @app.get("/api/health")
    async def health():
        return handle_health({})

    def _wrap(fn):
        async def endpoint(body: dict):
            try:
                return fn(body, device=device)
            except ApiError as e:
                raise HTTPException(e.status, detail=e.detail)
            except ValidationError as e:
                # The stdlib transport's 422 contract.
                raise HTTPException(422, detail=str(e))
        return endpoint

    for path, fn in _POST_ROUTES.items():
        app.post(path)(_wrap(fn))
    return app


def main():
    parser = argparse.ArgumentParser(description="mcos_tpu_torch pricing API")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", default="cuda",
                        help="torch device to price on (default: cuda)")
    args = parser.parse_args()
    # The kernels' build directory persists across restarts (the role of
    # the JAX package's persistent compilation cache); MCOS_JIT_CACHE
    # moves it, MCOS_DISABLE_JIT_CACHE=1 keeps the package's own.
    from mcos_tpu_torch.utils.checkpoint import enable_compilation_cache

    if "MCOS_JIT_CACHE" in os.environ:
        enable_compilation_cache(os.environ["MCOS_JIT_CACHE"])
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(name)s] %(levelname)s: %(message)s")
    serve(args.host, args.port, args.device).serve_forever()


if __name__ == "__main__":
    main()
