"""mcos_tpu_torch — the PyTorch + CUDA port of mcos_tpu, for one NVIDIA H100.

The JAX package `mcos_tpu` is the reference; this package imports neither
JAX nor `mcos_tpu`. Its layout mirrors the reference's (`config`, `models`,
`ops`, `engine`, `api`, `utils`), with the hand-written CUDA sources in
`csrc/`. Ported so far: the default `/api/price` path (Sobol draws, kernel
K1, companion control variate, guards, coalescer, HTTP server) and the GBM
benchmark kernel K2. ROADMAP.md lists what is left.
"""

from mcos_tpu_torch.engine.pricer import MonteCarloEngine, mc_price_from_draws
from mcos_tpu_torch.models.params import SVJParams, gbm_params
from mcos_tpu_torch.ops.bs import bs_price

__all__ = ["MonteCarloEngine", "SVJParams", "bs_price", "gbm_params",
           "mc_price_from_draws"]
