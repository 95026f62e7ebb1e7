"""Request schemas of the port's HTTP API: the part of
`mcos_tpu/api/schemas.py` that `PriceRequest`, `GreeksRequest`,
`SmileRequest`, `ExoticRequest`, `HHWRequest`, `SVCJRequest`,
`TermSVJRequest`, `RoughRequest`, `StressRequest`, `RegimeRequest`,
`HedgeRequest`, `VarRequest`, `AmericanRequest`, `PDERequest`,
`SurfaceRequest`, `CalibrateRequest`, `QuoteGreeksRequest` (with
`ProductSpec`), `LocalVolRequest`, `SLVRequest`, and the desk tools'
`ReplicateRequest`, `MarginRequest`, `VolDerivsRequest`, `BookRequest`,
`ExposurePosition`, `ExposureRequest`, `ModelRiskRequest` and `PnlRequest`,
the multi-asset and path products' `BasketRequest`, `QuantoRequest`,
`AutocallRequest` and `CliquetRequest`, and `RoughHestonRequest` need,
copied unchanged apart from the imports. tests/test_torch_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Optional, Union

from pydantic import BaseModel, Field, model_validator

from mcos_tpu_torch.config import DIVIDEND_YIELD, MAX_PATHS, RISK_FREE_RATE
from mcos_tpu_torch.models.params import SVCJParams, SVJParams

# Compute-parameter admission bounds: path counts flow straight into device
# allocations, so every request field that sizes a buffer is clamped here.
_PATHS = dict(ge=1_000, le=MAX_PATHS)
MAX_BOOK_POSITIONS = 4_096
MAX_GRID_POINTS = 256


class SVJParamsRequest(BaseModel):
    kappa: float = Field(3.0, description="Mean reversion speed")
    theta: float = Field(0.04, description="Long-run variance")
    xi: float = Field(0.5, description="Vol-of-vol")
    rho: float = Field(-0.7, description="Spot-vol correlation")
    v0: float = Field(0.04, description="Initial variance")
    lambda_j: float = Field(1.0, description="Jump intensity")
    mu_j: float = Field(-0.05, description="Mean jump size (log)")
    sigma_j: float = Field(0.10, ge=0.0,
                           description="Jump size volatility")
    r: float = Field(RISK_FREE_RATE, description="Risk-free rate")
    q: float = Field(DIVIDEND_YIELD, description="Dividend yield")

    def to_params(self) -> SVJParams:
        return SVJParams(**self.model_dump())


class SVCJParamsRequest(SVJParamsRequest):
    # The docstring is part of the JSON schema the copies test compares.
    """SVJ block + the two variance-jump fields (models/params.py:SVCJParams)."""
    mu_v: float = Field(0.05, ge=0.0, le=1.0,
                        description="Mean variance jump E[Z_v]")
    rho_j: float = Field(-0.5, ge=-10.0, le=10.0,
                         description="Jump correlation loading (Z_s on Z_v)")

    @model_validator(mode="after")
    def _compensator_exists(self):
        if self.rho_j * self.mu_v >= 1.0:
            raise ValueError(
                f"rho_j*mu_v={self.rho_j * self.mu_v:.3f} >= 1: "
                "the jump compensator E[e^Z_s] diverges")
        return self

    def to_params(self) -> SVCJParams:
        return SVCJParams(**self.model_dump())


class SVCJRequest(BaseModel):
    """POST /api/svcj: correlated price/variance jumps (engine/svcj.py)."""
    spot: float = Field(gt=0)
    T: float = Field(gt=0, le=10.0)
    # "price" | "greeks" | "smile" | "compare" (MC vs COS oracle rows)
    mode: str = "price"
    strike: float = 0.0                      # 0 → ATM
    strikes: Optional[list] = Field(None, max_length=MAX_GRID_POINTS)
    is_call: bool = True
    params: SVCJParamsRequest = SVCJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    num_steps: Optional[int] = Field(None, ge=4, le=8192)


class DividendItem(BaseModel):
    """One discrete dividend: ex-date `t` (year fraction) and `amount`
    (currency for kind="cash", fractional drop in (0,1) for
    kind="proportional")."""
    t: float = Field(gt=0.0, le=30.0)
    amount: float = Field(ge=0.0)


def build_dividend_schedule(items, kind: str):
    """Request dividends → ops.dividends.DividendSchedule (sorted; same-date
    cash amounts summed, proportional drops composed). None when empty."""
    if not items:
        return None
    from mcos_tpu_torch.ops.dividends import DividendSchedule

    merged: dict = {}
    for it in sorted(items, key=lambda d: d.t):
        if kind == "proportional":
            prev = merged.get(it.t, 0.0)
            merged[it.t] = 1.0 - (1.0 - prev) * (1.0 - it.amount)
        else:
            merged[it.t] = merged.get(it.t, 0.0) + it.amount
    times = sorted(merged)
    try:
        return DividendSchedule(times, [merged[t] for t in times], kind)
    except ValueError as e:
        raise ValueError(f"invalid dividends: {e}") from e


class RateKnot(BaseModel):
    """Piecewise-flat forward-rate knot: rate `r` applies up to time `t`."""
    t: float = Field(gt=0.0, le=50.0)
    r: float = Field(ge=-0.05, le=1.0)


def build_rate_curve(items):
    """Request knots → ops.curves.RateCurve (sorted). None when empty."""
    if not items:
        return None
    from mcos_tpu_torch.ops.curves import RateCurve

    knots = sorted(items, key=lambda k: k.t)
    try:
        return RateCurve([k.t for k in knots], [k.r for k in knots])
    except ValueError as e:
        raise ValueError(f"invalid rate_curve: {e}") from e


class PriceRequest(BaseModel):
    spot: float
    strike: float
    T: float
    is_call: bool = True
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(500_000, **_PATHS)
    use_sobol: bool = True
    use_antithetic: bool = True
    use_control_variate: bool = True
    cv_mode: str = "companion"
    rqmc_randomizations: Optional[int] = Field(None, ge=2, le=64)
    scheme: str = "euler"
    num_steps: Optional[int] = Field(None, ge=4, le=8192)
    use_importance: bool = False
    dividends: Optional[list[DividendItem]] = Field(None, max_length=64)
    dividend_kind: str = Field("cash", pattern="^(cash|proportional)$")
    rate_curve: Optional[list[RateKnot]] = Field(None, max_length=64)


class GreeksRequest(BaseModel):
    spot: float
    strike: float = 0.0          # single-contract mode (ignored with strikes)
    T: float
    is_call: bool = True
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    # Second-order cross Greeks (vanna/volga via CRN-FD of AD first
    # derivatives, engine/greeks.py:cross_greeks) — one extra device call.
    with_cross: bool = False
    # Remaining second/third-order Greeks (charm/speed/zomma/color/veta via
    # a 12-point (spot, v0, T) AD batch, engine/greeks.py:
    # second_order_greeks) — one extra device call. Single-contract,
    # no-dividends mode only.
    with_second_order: bool = False
    # Minimum-variance hedge ratio Delta + rho*xi*(dP/dv0)/S (Hull-White
    # 2017) off the same AD backward pass — zero extra device work.
    # Single-contract mode only.
    with_min_variance: bool = False
    # Chain mode: all Greeks for every strike with pipelined dispatch (one
    # host sync for the whole chain — engine/greeks.py:all_greeks_chain).
    strikes: list[float] = Field(default_factory=list,
                                 max_length=MAX_GRID_POINTS)
    # Discrete dividends: Greeks of the effective process, chain-ruled back
    # to raw spot (engine/greeks.py:all_greeks_dividends). Single-contract
    # mode only.
    dividends: Optional[list[DividendItem]] = Field(None, max_length=64)
    dividend_kind: str = Field("cash", pattern="^(cash|proportional)$")


class SmileRequest(BaseModel):
    spot: float
    T: float
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(50_000, **_PATHS)
    num_strikes: int = Field(21, ge=3, le=MAX_GRID_POINTS)
    # "mc" (reference behavior) or "cos" — exact semi-analytic smile in ms.
    method: str = "mc"
    # Attach the model-exact risk-neutral terminal density of S_T
    # (ops/cos_pricer.py:cos_density — Breeden–Litzenberger, no MC noise).
    with_density: bool = False
    # Rate curve: pricing AND the IV inversion both use the flat-equivalent
    # rate R(T)/T, so quoted IVs stay internally consistent.
    rate_curve: Optional[list[RateKnot]] = Field(None, max_length=64)


class ExoticRequest(BaseModel):
    """POST /api/exotic: Asian / barrier / lookback pricing."""
    spot: float
    T: float
    # asian|barrier|lookback|digital|variance_swap|one_touch|
    # double_barrier|double_no_touch|double_one_touch
    kind: str
    strike: Optional[float] = None       # None ⇒ floating-strike lookback
    is_call: bool = True
    averaging: str = "arithmetic"        # asian only
    barrier: Optional[float] = None      # barrier kinds (upper for double_*)
    barrier_lo: Optional[float] = None   # double_* kinds: lower barrier
    knock: str = "out"                   # barrier only
    # cash rebate on the dead branch (barrier / double_barrier kinds):
    # paid on knock for KO, at expiry if never knocked for KI.
    rebate: float = Field(default=0.0, ge=0.0)
    rebate_at_hit: bool = False          # KO single barriers only
    # window (partial) barrier: monitoring restricted to [t1, t2] ⊆ [0, T]
    # (kind="barrier", monitoring="bridge" only)
    window: Optional[list[float]] = Field(default=None, min_length=2,
                                          max_length=2)
    # barrier/one_touch: "discrete" (grid), "continuous" (BGK shift), or
    # "bridge" (Brownian-bridge survival weights: exact continuous
    # monitoring under GBM at any step count, smooth low-variance weight).
    monitoring: str = Field("discrete",
                            pattern="^(discrete|continuous|bridge)$")
    pay_at_hit: bool = False             # one_touch only
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    with_greeks: bool = False  # delta/vega (AD; CRN-FD for barriers)


class HHWRequest(BaseModel):
    """POST /api/hhw: Heston-Hull-White hybrid pricing (stochastic vol and
    stochastic rates; engine/hhw.py)."""
    spot: float = Field(gt=0)
    strike: float = Field(gt=0)
    T: float = Field(gt=0, le=30.0)
    is_call: bool = True
    mode: str = "price"              # "price" | "greeks" | "impact"
    # Heston block
    kappa: float = Field(2.0, gt=0, le=50)
    theta: float = Field(0.04, gt=0, le=4.0)
    xi: float = Field(0.4, gt=0, le=10.0)
    v0: float = Field(0.04, gt=0, le=4.0)
    rho_sv: float = Field(-0.7, ge=-0.999, le=0.999)
    # Hull-White block
    a: float = Field(0.1, gt=0, le=10.0)
    b: float = Field(0.05, ge=-0.1, le=1.0)
    sigma_r: float = Field(0.01, ge=0.0, le=0.5)
    r0: float = Field(0.05, ge=-0.1, le=1.0)
    rho_sr: float = Field(0.3, ge=-0.999, le=0.999)
    rho_vr: float = Field(0.0, ge=-0.999, le=0.999)
    q: float = DIVIDEND_YIELD
    num_paths: int = Field(200_000, **_PATHS)
    num_steps: int = Field(128, ge=8, le=1024)


class TermSVJSegment(BaseModel):
    """One piecewise-constant segment of the time-dependent SVJ model:
    (θ, ξ, λ) on calendar time up to `t_end` (years). Bounds mirror
    TERM_STRUCTURE_BOUNDS (config.py)."""
    t_end: float = Field(gt=0.0, le=30.0)
    theta: float = Field(0.04, ge=0.005, le=2.0)
    xi: float = Field(0.5, ge=0.05, le=5.0)
    lambda_j: float = Field(1.0, ge=0.0, le=20.0)


class TermSVJRequest(BaseModel):
    """POST /api/termsvj: one consistent time-dependent SVJ process
    (ops/tdsvj.py).

    Modes: price (td MC + exact td-COS), compare (MC-vs-oracle rows),
    smile (exact COS-implied vols), forward_start, cliquet, greeks,
    varswap, american, calibrate (sequential segment bootstrap against
    per-expiry chains)."""
    spot: float = Field(gt=0)
    T: float = Field(0.25, gt=0, le=10.0)
    mode: str = "price"
    strike: float = 0.0                      # 0 → ATM
    strikes: Optional[list[float]] = Field(None, max_length=MAX_GRID_POINTS)
    is_call: bool = True
    # Global (κ, ρ, v0, μ_J, σ_J, r, q); its θ/ξ/λ are ignored in favor of
    # the segments.
    params: SVJParamsRequest = SVJParamsRequest()
    segments: list[TermSVJSegment] = Field(default_factory=list,
                                           max_length=64)
    num_paths: int = Field(200_000, **_PATHS)
    num_steps: int = Field(512, ge=4, le=8192)
    # forward_start mode: reset date (years); `strike` is then the
    # performance strike k in max(±(S_T/S_t1 − k), 0), defaulting to 1.0.
    t1: Optional[float] = Field(None, gt=0.0, le=10.0)
    # cliquet mode terms.
    n_periods: int = Field(4, ge=1, le=64)
    local_floor: float = 0.0
    local_cap: float = 0.08
    global_floor: float = 0.0
    global_cap: float = 1e18
    notional: float = Field(1.0, gt=0, le=1e12)
    # calibrate mode inputs: one chain per maturity.
    maturities: Optional[list[float]] = Field(None,
                                              max_length=MAX_GRID_POINTS)
    market_prices: Optional[list[list[float]]] = None

    @model_validator(mode="after")
    def _segments_ascending(self):
        ends = [s.t_end for s in self.segments]
        if any(b <= a for a, b in zip(ends, ends[1:])):
            raise ValueError("segment t_end values must be strictly "
                             "ascending")
        return self


class RoughRequest(BaseModel):
    """POST /api/rough — rough Bergomi pricing/smile/Greeks
    (engine/rough.py; model family beyond the reference)."""
    spot: float = Field(gt=0)
    T: float = Field(gt=0, le=10.0)
    # "price" | "greeks" | "smile" | "skew" | "asian" | "barrier" | "lookback"
    mode: str = "price"
    strike: float = 0.0              # 0 → ATM (price/greeks/exotic modes)
    is_call: bool = True
    # barrier-mode terms
    barrier: float = 0.0
    knock: str = "out"               # "out" | "in"
    # model parameters
    hurst: float = Field(0.07, gt=0.0, le=0.5)
    xi: float = Field(0.04, gt=0.0, le=4.0)
    eta: float = Field(1.9, ge=0.0, le=10.0)
    rho: float = Field(-0.9, ge=-0.999, le=0.999)
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    # discretization
    num_paths: int = Field(131_072, **_PATHS)
    num_steps: int = Field(128, ge=8, le=512)
    # Owen-Sobol through the PCA factor + RQMC error bars (price mode)
    use_sobol: bool = False
    moneyness: Optional[list] = None  # smile mode grid (≤ MAX_GRID_POINTS)
    # calibrate mode: (m,) maturities, (m, k) strikes and call prices
    maturities: Optional[list] = None
    cal_strikes: Optional[list] = None
    market_prices: Optional[list] = None
    hurst_grid: Optional[list] = None


class StressRequest(BaseModel):
    spot: float
    strike: float
    T: float
    is_call: bool = True
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(100_000, **_PATHS)
    # mode="report": the reference's ladder report (spot/vol/jump).
    # mode="matrix": the full spot×vol scenario P&L cube in one CRN device
    # program (engine/risk.py:scenario_matrix); optional custom shock axes.
    mode: str = Field("report", pattern="^(report|matrix)$")
    spot_shocks: Optional[list[float]] = Field(None, max_length=25)
    vol_shocks: Optional[list[float]] = Field(None, max_length=25)


class RegimeRequest(BaseModel):
    realized_vol: float
    iv_percentile: float
    skew_slope: float


class HedgeRequest(BaseModel):
    spot: float
    strike: float
    T: float
    is_call: bool = True
    params: SVJParamsRequest = SVJParamsRequest()
    num_scenarios: int = Field(500, ge=10, le=100_000)
    txn_cost_bps: float = 5.0
    slippage_bps: float = 2.0
    # "gbm" (reference world) | "svj" (full jump-diffusion) | "rough"
    # (rough-Bergomi world from a pre-simulated exact-covariance sheet)
    dynamics: str = "gbm"
    # "bs_delta" (desk BS delta at sigma=sqrt(v0)) | "mv_delta"
    # (minimum-variance ratio Delta + rho*xi*P_v/S; gbm/svj worlds only)
    # | "ww_band" (Whalley-Wilmott no-transaction band around the BS
    # delta, trading to the nearest edge — asymptotically optimal under
    # proportional costs; gbm/svj worlds only)
    hedge: str = "bs_delta"
    # ww_band risk aversion (gamma in the band formula, units 1/currency:
    # absolute risk aversion, sensible values ~1/spot-scale); higher =
    # tighter band = closer tracking at more cost.
    risk_aversion: float = Field(1e-3, gt=0, le=1e4)


class VarRequest(BaseModel):
    """POST /api/var — correlated-GBM portfolio VaR/CVaR with per-asset
    Euler risk contributions (engine/risk.py:portfolio_risk_contributions;
    the reference reports portfolio scalars only, risk.py:117-155)."""
    spots: list[float] = Field(max_length=64)
    sigmas: list[float] = Field(max_length=64)
    weights: list[float] = Field(max_length=64)
    corr: list[list[float]]
    T: float
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    num_paths: int = Field(500_000, **_PATHS)
    confidence: float = Field(0.99, gt=0.5, lt=1.0)
    with_contributions: bool = True
    # dependence structure: "gaussian" (default; mesh-shardable) or
    # "student_t" (tail-dependent joint crashes, lognormal marginals kept)
    copula: str = "gaussian"
    nu: float = Field(5.0, ge=1.0, le=300.0)


class AmericanRequest(BaseModel):
    """POST /api/american — Longstaff-Schwartz American pricing (beyond the
    reference's European-only engine)."""
    spot: float
    strike: float
    T: float
    is_call: bool = True
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    # Bracket the price: out-of-sample LSM lower bound + Andersen-Broadie/
    # Haugh-Kogan dual upper bound with the duality gap (engine/american.py).
    with_bounds: bool = False
    # Policy-fixed pathwise AD Greeks (delta/gamma/vega/theta/rho) of the
    # out-of-sample LSM estimator (engine/american.py:AmericanEngine.greeks).
    with_greeks: bool = False
    # Early-exercise boundary S*(t) from the Crank-Nicolson grid under the
    # BS proxy sigma = sqrt(v0) (engine/pde.py:exercise_boundary) — the SVJ
    # boundary is a surface in (S, v); the proxy is the desk convention.
    with_boundary: bool = False
    # Exact COS American (Fourier-cosine backward induction + Richardson,
    # ops/cos_bermudan.py) under the Merton projection sigma=sqrt(v0) +
    # the SVJ jump leg — exact when xi=0 and theta=v0; prices American
    # options UNDER JUMPS semi-analytically, pinning the LSM estimate.
    with_cos_oracle: bool = False
    # Bermudan schedule: exercise allowed every m-th simulation date only
    # (1 = American; >= num_steps = European).
    exercise_every: int = Field(1, ge=1, le=8192)
    n_outer: int = Field(2048, ge=256, le=65536)
    n_inner: int = Field(128, ge=16, le=2048)
    # Discrete dividends — the case where American calls actually exercise
    # early. kind="cash" uses the exact compounded-cash path model,
    # kind="proportional" exact factors (engine/american.py).
    dividends: Optional[list[DividendItem]] = Field(None, max_length=64)
    dividend_kind: str = Field("cash", pattern="^(cash|proportional)$")
    # Rate curve: exact in the LSM via per-date drift offsets + per-step
    # discount factors (engine/american.py lsm_price docstring).
    rate_curve: Optional[list[RateKnot]] = Field(None, max_length=64)


class PDERequest(BaseModel):
    """POST /api/pde — deterministic finite-difference pricing
    (engine/pde.py): the 2-D ADI Heston solve (model="heston", the
    framework's third independent route to the flagship model; with
    params.lambda_j > 0 it solves the full Bates/SVJ PIDE — the jump
    integral as one MXU matmul per step) or the 1-D Crank-Nicolson BS
    grid (model="bs", with the American exercise boundary)."""
    spot: float = Field(gt=0)
    strike: float = Field(gt=0)
    T: float = Field(gt=0, le=30.0)
    is_call: bool = True
    american: bool = False
    model: str = "heston"                   # "heston" | "bs"
    params: SVJParamsRequest = SVJParamsRequest(lambda_j=0.0)
    sigma: Optional[float] = Field(None, gt=0, le=5.0,
                                   description="bs-model vol "
                                               "(default sqrt(v0))")
    scheme: str = "cs"                      # heston: "cs" | "douglas"
    n_x: int = Field(201, ge=51, le=801)
    n_v: int = Field(101, ge=21, le=401)
    n_t: int = Field(128, ge=16, le=1024)
    with_boundary: bool = False             # bs+american: S*(t) curve
    with_oracle: bool = False               # heston european: exact COS row
    # Barrier mode (heston model only): absorbing-edge continuous KO/KI.
    barrier: Optional[float] = Field(None, gt=0)
    barrier_lo: Optional[float] = Field(None, gt=0)
    knock: str = "out"                      # "out" | "in"
    direction: str = "up"                   # "up" | "down"
    rebate: float = Field(0.0, ge=0)
    rebate_at_hit: bool = False

    @model_validator(mode="after")
    def _modes(self):
        if self.model not in ("heston", "bs"):
            raise ValueError("model must be 'heston' or 'bs'")
        if self.scheme not in ("cs", "douglas"):
            raise ValueError("scheme must be 'cs' or 'douglas'")
        return self


class SurfaceRequest(BaseModel):
    """POST /api/surface — full-chain IV extraction + arbitrage report +
    per-maturity SABR fits (the reference keeps surface tooling library-only,
    engine/surface.py)."""
    spot: float
    strikes: list[float] = Field(max_length=MAX_GRID_POINTS)
    maturities: list[float] = Field(max_length=MAX_GRID_POINTS)
    call_prices: list[list[float]]   # (num_maturities, num_strikes)
    put_prices: list[list[float]]
    bid_ask_spreads: Optional[list[list[float]]] = None
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    fit_sabr: bool = True
    fit_ssvi: bool = False           # global SSVI surface fit + no-arb report
    # "european" (index options, vectorized Newton) or "american" (stock
    # options — de-Americanization through the CRR tree, engine/surface.py:
    # implied_vol_american).
    exercise: str = Field("european", pattern="^(european|american)$")


class CalibrateRequest(BaseModel):
    """POST /api/calibrate — advertised by the reference's docstring
    (engine/app.py:9) but never implemented there (SURVEY.md §1); this
    framework ships it."""
    spot: float
    strikes: list[float] = Field(max_length=MAX_GRID_POINTS)
    T: float
    market_prices: list[float] = Field(max_length=MAX_GRID_POINTS)
    is_call: bool = True
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    bid_ask_spreads: Optional[list[float]] = None
    atm_vol: float = 0.15
    num_paths: int = Field(100_000, **_PATHS)
    # "american": de-Americanize the quotes through the CRR tree before
    # fitting (the SVJ CF prices European exercise only; NSE single-stock
    # quotes are American). Quotes whose inversion fails are dropped.
    exercise: str = "european"


class ProductSpec(BaseModel):
    """Product priced against the calibration chain (quotegreeks)."""
    kind: str = "vanilla"            # "vanilla" | "digital" | "varswap"
    T: float = Field(gt=0, le=10.0)
    strike: float = 0.0              # vanilla/digital (0 → ATM = spot)
    is_call: bool = True
    notional: float = Field(1.0, gt=0, le=1e12)   # varswap


class QuoteGreeksRequest(BaseModel):
    """POST /api/quotegreeks — bucketed market-quote sensitivities via the
    implicit function theorem through the calibration
    (engine/quotegreeks.py; capability beyond the reference)."""
    spot: float = Field(gt=0)
    # One expiry: T float + strikes [..]. Surface: T [..] + strikes [[..]].
    T: Union[float, list]
    strikes: list = Field(min_length=1, max_length=MAX_GRID_POINTS)
    is_call: bool = True
    params: SVJParamsRequest = SVJParamsRequest()
    product: ProductSpec
    # Params the refit may move; default CORE4 = what one expiry
    # identifies. Names from the SVJ 8-tuple.
    free: Optional[list] = Field(None, max_length=8)
    weights: Optional[list] = Field(None, max_length=MAX_GRID_POINTS)


class LocalVolRequest(BaseModel):
    """POST /api/localvol — build a Dupire local-vol surface from an IV grid
    and price a strike chain under the surface-consistent diffusion (model
    family absent from the reference; engine/localvol.py)."""
    spot: float
    strikes: list[float] = Field(max_length=MAX_GRID_POINTS)
    maturities: list[float] = Field(max_length=MAX_GRID_POINTS)
    iv: list[list[float]]            # (num_maturities, num_strikes)
    price_strikes: list[float] = Field(max_length=MAX_GRID_POINTS)
    T: float
    is_call: bool = True
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    num_paths: int = Field(200_000, **_PATHS)
    num_steps: int = Field(100, ge=16, le=2048)


class SLVRequest(BaseModel):
    """POST /api/slv — stochastic local vol: Dupire surface from an IV
    grid + Heston mixing, priced by the in-scan particle method
    (engine/slv.py)."""
    spot: float = Field(gt=0)
    strikes: list[float] = Field(max_length=MAX_GRID_POINTS)
    maturities: list[float] = Field(max_length=MAX_GRID_POINTS)
    iv: list[list[float]]            # (num_maturities, num_strikes)
    price_strikes: list[float] = Field(max_length=MAX_GRID_POINTS)
    T: float = Field(gt=0)
    is_call: bool = True
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    # Heston mixing block (lambda ignored; SLV is diffusion + leverage)
    kappa: float = Field(2.0, gt=0, le=50)
    theta: float = Field(0.04, gt=0, le=4.0)
    xi: float = Field(0.6, ge=0.0, le=10.0)
    rho: float = Field(-0.7, ge=-0.999, le=0.999)
    v0: float = Field(0.04, gt=0, le=4.0)
    num_paths: int = Field(200_000, **_PATHS)
    num_steps: int = Field(128, ge=16, le=2048)
    # mode "chain" (default) | "barrier" | "forward_start"
    mode: str = "chain"
    barrier: float = 0.0
    knock: str = "out"
    t1: float = 0.0                  # forward-start reset date
    k: float = 1.0                   # forward-start performance strike


class ReplicateRequest(BaseModel):
    """POST /api/replicate — static replication of a target payoff onto a
    vanilla call chain (engine/hedge.py; beyond the reference). The residual
    distribution quantifies the statically-unhedgeable path risk."""
    spot: float = Field(gt=0.0)
    T: float = Field(gt=0.0, le=10.0)
    kind: str = Field("digital",
                      pattern="^(digital|vanilla|asian|barrier|lookback)$")
    strike: float = Field(0.0, ge=0.0)
    is_call: bool = True
    barrier: float = Field(0.0, ge=0.0)
    averaging: str = Field("arithmetic", pattern="^(arithmetic|geometric)$")
    knock: str = Field("out", pattern="^(in|out)$")
    direction: str = Field("up", pattern="^(up|down)$")
    floating: bool = False
    hedge_strikes: Optional[list[float]] = Field(None, min_length=1,
                                                 max_length=MAX_GRID_POINTS)
    n_hedge: int = Field(13, ge=1, le=MAX_GRID_POINTS)
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)


class MarginRequest(BaseModel):
    """POST /api/margin — SPAN-style 16-scenario portfolio initial margin
    (engine/margin.py; beyond the reference). Quantities signed (+long)."""
    spot: float = Field(gt=0.0)
    strikes: list[float] = Field(min_length=1, max_length=MAX_BOOK_POSITIONS)
    Ts: list[float] = Field(min_length=1, max_length=MAX_BOOK_POSITIONS)
    is_calls: list[bool] = Field(min_length=1,
                                 max_length=MAX_BOOK_POSITIONS)
    quantities: list[float] = Field(min_length=1,
                                    max_length=MAX_BOOK_POSITIONS)
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    price_scan_range: float = Field(0.06, gt=0.0, le=0.5)
    vol_scan_range: float = Field(0.04, ge=0.0, le=0.5)
    extreme_multiplier: float = Field(2.0, ge=1.0, le=5.0)
    extreme_coverage: float = Field(0.35, ge=0.0, le=1.0)


class VolDerivsRequest(BaseModel):
    """POST /api/volderivs — variance/vol swaps + VIX-style futures/options
    under the SVJ model (engine/volderivs.py; beyond the reference)."""
    kind: str = Field("variance_swap",
                      pattern="^(variance_swap|vol_swap|vix_future|"
                              "vix_option)$")
    T: float = Field(gt=0.0, le=30.0)
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    # vix_option only:
    strike: Optional[float] = Field(None, gt=0.0)   # in vol units (0.20=20%)
    is_call: bool = True
    # VIX definition window and jump convention.
    tau: float = Field(30.0 / 365.0, gt=0.0, le=1.0)
    convention: str = Field("log_contract",
                            pattern="^(log_contract|quadratic_variation)$")
    with_mc_check: bool = False


class BookRequest(BaseModel):
    """POST /api/book — vectorized portfolio pricing + Greeks (new)."""
    spots: list[float] = Field(max_length=MAX_BOOK_POSITIONS)
    strikes: list[float] = Field(max_length=MAX_BOOK_POSITIONS)
    Ts: list[float] = Field(max_length=MAX_BOOK_POSITIONS)
    is_calls: list[bool] = Field(max_length=MAX_BOOK_POSITIONS)
    quantities: Optional[list[float]] = Field(None,
                                              max_length=MAX_BOOK_POSITIONS)
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(100_000, **_PATHS)


class ExposurePosition(BaseModel):
    kind: str = "call"               # "call" | "put" | "forward"
    strike: float = Field(gt=0)
    T: float = Field(gt=0, le=30.0)
    qty: float = Field(1.0, ge=-1e9, le=1e9)
    asset: int = Field(0, ge=0)


class ExposureRequest(BaseModel):
    """POST /api/exposure — counterparty EE/PFE profiles + CVA/DVA
    (engine/exposure.py; XVA layer beyond the reference)."""
    spots: list
    sigmas: list
    corr: list
    positions: list                  # of ExposurePosition dicts
    r: float = RISK_FREE_RATE
    q: Optional[list] = None
    num_paths: int = Field(65_536, **_PATHS)
    num_dates: int = Field(32, ge=2, le=MAX_GRID_POINTS)
    quantile: float = Field(0.975, gt=0.5, lt=1.0)
    # credit inputs (CVA block; hazard 0 → profile only)
    hazard_rate: float = Field(0.02, ge=0.0, le=5.0)
    own_hazard: float = Field(0.0, ge=0.0, le=5.0)
    lgd: float = Field(0.6, ge=0.0, le=1.0)
    with_cva_delta: bool = False
    # CSA terms: variation margin above the threshold, held with a
    # margin-period-of-risk lag (None = uncollateralized)
    collateral_threshold: Optional[float] = Field(None, ge=0.0)
    margin_period: float = Field(10.0 / 252.0, gt=0.0, le=1.0)
    # Wrong-way risk: spot-linked intensity h0 * (S0/S_t)^gamma on asset 0
    # (0 = independent hazard, the default)
    wwr_gamma: float = Field(0.0, ge=-10.0, le=10.0)


class ModelRiskRequest(BaseModel):
    """POST /api/modelrisk — one contract priced under every model family
    (engine/modelrisk.py)."""
    spot: float = Field(gt=0)
    strike: float = Field(gt=0)
    T: float = Field(gt=0, le=30.0)
    is_call: bool = True
    atm_vol: float = Field(0.2, gt=0, le=3.0)
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    params: Optional[SVJParamsRequest] = None   # calibrated SVJ anchor
    num_paths: int = Field(65_536, **_PATHS)


class PnlRequest(BaseModel):
    """POST /api/pnl — daily P&L attribution between two market states
    (engine/pnl.py; COS-exact endpoints, deterministic report)."""
    strike: float = Field(gt=0)
    is_call: bool = True
    quantity: float = Field(1.0, ge=-1e9, le=1e9)
    spot_old: float = Field(gt=0)
    spot_new: float = Field(gt=0)
    T_old: float = Field(gt=0, le=30.0)
    T_new: float = Field(gt=0, le=30.0)
    params_old: SVJParamsRequest = SVJParamsRequest()
    params_new: SVJParamsRequest = SVJParamsRequest()


class BasketRequest(BaseModel):
    """POST /api/basket — European option on a weighted basket of correlated
    SVJ assets (multi-asset capability beyond the reference)."""
    spots: list[float] = Field(max_length=64)
    weights: list[float] = Field(default_factory=list, max_length=64)
    strike: float
    T: float
    is_call: bool = True
    corr: list[list[float]]          # (A, A) spot-shock correlation
    params: list[SVJParamsRequest] = Field(default_factory=list,
                                           max_length=64)
    num_paths: int = Field(200_000, **_PATHS)
    # "basket" (weighted sum; needs weights), "worst_of"/"best_of" rainbow
    # (exact Stulz companion CV for 2 assets), or "spread" (S1-S2-K; exact
    # Margrabe companion CV) — engine/basket.py.
    payoff: str = "basket"
    # Dispersion inverse problem: given a basket quote, return the flat
    # implied correlation instead of a price (basket payoff only).
    implied_corr_from_price: Optional[float] = Field(None, gt=0)
    # Bermudan exercise (engine/basket_american.py): n_exercise rights at
    # t_1..T on payoff "basket" | "worst_of" (min) | "best_of" (max).
    american: bool = False
    n_exercise: int = Field(9, ge=1, le=64)
    steps_per_period: int = Field(8, ge=1, le=64)
    # Honest price bracket: out-of-sample LSM lower + Andersen-Broadie
    # dual upper bound (american mode only).
    with_bounds: bool = False
    n_outer: int = Field(2048, ge=128, le=16384)
    n_inner: int = Field(64, ge=16, le=512)


class QuantoRequest(BaseModel):
    """POST /api/quanto — quanto vanilla under SVJ (engine/quanto.py).
    `params.r` is the FOREIGN rate; `r_domestic` discounts the payoff."""
    spot: float = Field(gt=0)
    strike: float = Field(gt=0)
    T: float = Field(gt=0, le=10.0)
    is_call: bool = True
    r_domestic: float = 0.05
    sigma_fx: float = Field(0.1, ge=0.0, le=2.0)
    rho_fx: float = Field(-0.3, ge=-0.999, le=0.999)
    fx_fixed: float = Field(1.0, gt=0)
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    num_steps: int = Field(64, ge=8, le=1024)


class AutocallRequest(BaseModel):
    """POST /api/autocall — Express/Phoenix note pricing under SVJ
    (engine/autocallable.py; structured product beyond the reference)."""
    T: float = Field(gt=0, le=10.0)
    n_obs: int = Field(4, ge=1, le=64)
    autocall_barrier: float = Field(1.0, gt=0, le=100.0)
    coupon_barrier: float = Field(0.8, ge=0.0, le=100.0)
    protection_barrier: float = Field(0.7, ge=0.0, le=100.0)
    coupon: float = Field(0.02, ge=0.0, le=1.0)
    final_coupon: Optional[float] = Field(None, ge=0.0, le=10.0)
    notional: float = Field(1.0, gt=0, le=1e12)
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    steps_per_period: int = Field(16, ge=2, le=256)
    # Worst-of basket variant: per-asset params + correlation (the
    # trigger/coupon/capital legs then read min_i S_i(t)/S_i(0)).
    params_list: Optional[list] = None       # of SVJParamsRequest dicts
    corr: Optional[list] = None              # (A, A)
    # Issuance: solve the coupon pricing the note at `par_target`
    # (exact by coupon-linearity on CRN paths; `coupon` is then ignored)
    solve_par: bool = False
    par_target: float = Field(1.0, gt=0.1, le=10.0)


class CliquetRequest(BaseModel):
    """POST /api/cliquet — cliquet (ratchet) / forward-start pricing under
    SVJ (forward-skew instruments; engine/cliquet.py)."""
    T: float
    kind: str = "cliquet"            # "cliquet" | "forward_start"
    params: SVJParamsRequest = SVJParamsRequest()
    num_paths: int = Field(200_000, **_PATHS)
    steps_per_period: int = Field(16, ge=2, le=256)
    # cliquet terms
    n_periods: int = Field(4, ge=1, le=64)
    local_floor: float = 0.0
    local_cap: float = 0.08
    global_floor: float = 0.0
    global_cap: float = 1e18
    notional: float = Field(1.0, gt=0, le=1e12)
    # forward-start terms
    t1: float = 0.25
    k: float = 1.0
    is_call: bool = True


class RoughHestonRequest(BaseModel):
    """POST /api/roughheston — rough Heston: CIR mean-reversion driven
    through the fractional kernel (engine/roughheston.py; exact
    fractional-Riccati COS oracle in ops/roughheston.py; model family
    beyond the reference)."""
    spot: float = Field(gt=0)
    T: float = Field(gt=0, le=10.0)
    # "price" | "greeks" | "smile" | "compare" | "skew" | "calibrate"
    mode: str = "price"
    strike: float = 0.0              # 0 → ATM
    strikes: Optional[list] = Field(None, max_length=MAX_GRID_POINTS)
    is_call: bool = True
    # model parameters (hurst < 0.5 = rough; 0.5 = classical Heston)
    hurst: float = Field(0.1, gt=0.0, le=0.5)
    lam: float = Field(1.5, gt=0.0, le=20.0)
    theta: float = Field(0.04, gt=0.0, le=4.0)
    nu: float = Field(0.35, gt=0.0, le=5.0)
    rho: float = Field(-0.7, ge=-0.999, le=0.999)
    v0: float = Field(0.04, gt=0.0, le=4.0)
    r: float = RISK_FREE_RATE
    q: float = DIVIDEND_YIELD
    # discretization (num_steps is per-year, oversampling the T/256
    # lifted-kernel resolution; None → engine default 8192)
    num_paths: int = Field(200_000, **_PATHS)
    num_steps: Optional[int] = Field(None, ge=8, le=65_536)
    n_factors: int = Field(24, ge=1, le=64)
    # skew mode: maturity grid for the T^(H-1/2) term structure
    maturities: Optional[list] = Field(None, max_length=MAX_GRID_POINTS)
    # calibrate mode: market prices for `strikes` at maturity T
    market_prices: Optional[list] = Field(None,
                                          max_length=MAX_GRID_POINTS)
    fit_hurst: bool = False          # calibrate: grid-search H too
