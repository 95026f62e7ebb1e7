"""mcos_tpu_torch — the PyTorch + CUDA port of mcos_tpu, for one NVIDIA H100.

The JAX package `mcos_tpu` is the reference; this package imports neither
JAX nor `mcos_tpu`. Its layout mirrors the reference's (`config`, `models`,
`ops`, `engine`, `api`, `utils`, `cli`), with the hand-written CUDA
sources in `csrc/`: one kernel for each of the JAX package's eleven Pallas
kernels (K1-K11), and `svj_viz.cu`, the step loops of `/api/price`'s two
visualisation programs in one launch each. Its HTTP server
(`api/server.py`) serves the reference's 32 POST routes, its 4 GET routes
and the dashboard in `web/`.
ROADMAP.md lists what is left (the sharded paths).

The names below are the ones `mcos_tpu/__init__.py` re-exports, each from
its port module. Importing the package builds no kernel and touches no
CUDA device: the kernels are built at their first launch.
"""

__version__ = "0.1.0"

from mcos_tpu_torch.config import (  # noqa: F401
    CALIBRATION_CONFIG,
    DEFAULT_NUM_PATHS,
    DEFAULT_NUM_STEPS,
    DIVIDEND_YIELD,
    PARAM_BOUNDS,
    REGIME_THRESHOLDS,
    RISK_FREE_RATE,
    check_feller,
)
from mcos_tpu_torch.models.params import (  # noqa: F401
    SVJParams,
    TermStructureSVJ,
    forward_price,
    gbm_params,
)
from mcos_tpu_torch.ops.cos_pricer import (  # noqa: F401
    bates_cf,
    cos_price,
    heston_price,
)
from mcos_tpu_torch.ops.tdsvj import (  # noqa: F401
    cos_price_td,
    segments_from_term_structure,
    simulate_terminal_td,
)
from mcos_tpu_torch.ops.bs import (  # noqa: F401
    bs_all_greeks,
    bs_delta,
    bs_gamma,
    bs_price,
    bs_rho,
    bs_theta,
    bs_vega,
)
from mcos_tpu_torch.engine.pricer import (  # noqa: F401
    MonteCarloEngine,
    mc_price_core,
    mc_price_from_draws,
)
from mcos_tpu_torch.engine.american import (  # noqa: F401
    AmericanEngine,
    american_greeks_ad,
    binomial_american_bs,
    dual_upper_bound,
    lsm_lower_bound,
    lsm_train,
)
from mcos_tpu_torch.engine.basket import (  # noqa: F401
    BasketEngine,
    implied_correlation,
)
from mcos_tpu_torch.engine.cliquet import (  # noqa: F401
    CliquetEngine,
    cliquet_bs,
    forward_start_bs,
)
from mcos_tpu_torch.engine.book import BookEngine  # noqa: F401
from mcos_tpu_torch.engine.rough import (  # noqa: F401
    RoughBergomiEngine,
    calibrate_rbergomi,
)
from mcos_tpu_torch.engine.exposure import ExposureEngine  # noqa: F401
from mcos_tpu_torch.engine.ssvi import SSVISurface, calibrate_ssvi  # noqa: F401
from mcos_tpu_torch.engine.hhw import HHWEngine  # noqa: F401
from mcos_tpu_torch.engine.pde import PDEEngine  # noqa: F401
from mcos_tpu_torch.engine.autocallable import (  # noqa: F401
    AutocallableEngine,
    WorstOfAutocallableEngine,
)
from mcos_tpu_torch.engine.quanto import QuantoEngine, quanto_bs  # noqa: F401
from mcos_tpu_torch.engine.pnl import pnl_explain  # noqa: F401
from mcos_tpu_torch.engine.modelrisk import model_risk_report  # noqa: F401
from mcos_tpu_torch.engine.slv import SLVEngine  # noqa: F401
from mcos_tpu_torch.engine.termsvj import (  # noqa: F401
    TDSVJEngine,
    bootstrap_calibrate_td,
)
from mcos_tpu_torch.engine.volderivs import VolDerivsEngine  # noqa: F401
from mcos_tpu_torch.engine.margin import MarginEngine  # noqa: F401
from mcos_tpu_torch.ops.dividends import DividendSchedule  # noqa: F401
from mcos_tpu_torch.ops.curves import RateCurve  # noqa: F401
from mcos_tpu_torch.ops.levy import (  # noqa: F401
    NIGParams,
    VGParams,
    calibrate_nig,
    calibrate_vg,
    levy_price_mc,
    nig_cos_price,
    nig_price_mc,
    nig_terminal,
    vg_cos_price,
    vg_price_mc,
    vg_terminal,
)
from mcos_tpu_torch.ops.hhw import (  # noqa: F401
    HHWParams,
    bsm_hullwhite,
    vasicek_bond,
)
from mcos_tpu_torch.ops.rough import RoughBergomiParams  # noqa: F401
from mcos_tpu_torch.engine.exotics import ExoticEngine  # noqa: F401
from mcos_tpu_torch.engine.greeks import GreeksEngine  # noqa: F401
from mcos_tpu_torch.engine.calibration import CalibrationEngine  # noqa: F401
from mcos_tpu_torch.engine.guards import (  # noqa: F401
    PricingGuard,
    validate_simulation_output,
)
from mcos_tpu_torch.engine.localvol import (  # noqa: F401
    LocalVolEngine,
    LocalVolSurface,
)
from mcos_tpu_torch.engine.mlmc import mlmc_price  # noqa: F401
from mcos_tpu_torch.engine.regime import MarketRegime, RegimeDetector  # noqa: F401
from mcos_tpu_torch.engine.risk import (  # noqa: F401
    HedgingBacktest,
    LiquidityStress,
    StressTestEngine,
    compute_risk_metrics,
    portfolio_var,
)
from mcos_tpu_torch.engine.surface import (  # noqa: F401
    ArbitrageFreeSpline,
    calibrate_sabr,
    extract_iv_surface,
    implied_vol,
    implied_vol_grid,
    sabr_vol,
)
