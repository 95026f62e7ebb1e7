"""mcos_tpu_torch — the PyTorch + CUDA port of mcos_tpu, for one NVIDIA H100.

The JAX package `mcos_tpu` is the reference; this package imports neither
JAX nor `mcos_tpu`. Its layout mirrors the reference's (`config`, `models`,
`ops`, `engine`, `api`, `utils`), with the hand-written CUDA sources in
`csrc/`: one kernel for each of the JAX package's eleven Pallas kernels
(K1-K11). Its HTTP server (`api/server.py`) serves `/api/health` and 31
of the reference's POST routes. ROADMAP.md lists what is left.
"""

from mcos_tpu_torch.engine.pricer import MonteCarloEngine, mc_price_from_draws
from mcos_tpu_torch.models.params import SVJParams, gbm_params
from mcos_tpu_torch.ops.bs import bs_price

__all__ = ["MonteCarloEngine", "SVJParams", "bs_price", "gbm_params",
           "mc_price_from_draws"]
