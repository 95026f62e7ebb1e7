#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mcos_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Device: needs `torch.cuda.is_available()`; prints the card's
   `nvidia-smi --query-gpu=name,power.limit` line.
2. Build: compiles the CUDA kernels from mcos_tpu_torch/csrc (sm_90a) and
   prints how long it took.
3. Kernels against their plain torch versions, at the main path's shapes:
   K1 `svj_terminal_from_draws` at 500 000 paths × 63 steps on the real
   Sobol net (explicit jump uniforms, then in-kernel Philox jumps; S, v
   and G bit for bit; S and G path by path against the Euler twin, the
   reference's step algebra, to rtol 1e-5), and
   K2 `gbm_terminal` at 2^20 pairs × 252 steps (word-for-word against the
   plain version, antithetic mirror, moments, Black-Scholes within 3σ);
   K3 `svj_terminal` and K4 `svj_terminal_qe` at 500 000 pairs × 63 steps
   on the same Philox words as their plain versions, S, v and G bit for
   bit (K4 also at 4 and 8 steps where its QE transition takes both
   branches), and
   K5 `svj_terminal_qe_from_draws` at 500 000 paths × 63 steps on the real
   Sobol QE net (explicit jump uniforms, then in-kernel jumps), and at 4
   and 8 steps where its QE transition takes both branches, v bit for bit;
   K6 `svj_path_stats` at 200 000 pairs × 63 steps in four variants (no
   bridge, single barrier above, corridor, each with the companion leg;
   corridor with a step window and no companion) and at 252 steps, every
   output bit for bit against its plain version on the same Philox words,
   -inf matching -inf on every path;
   K7 `hhw_terminal` at 200 000 pairs × 128 (and 127) steps, K8
   `svcj_terminal` at 200 000 pairs × 252 (and 63) steps at jump rates
   0, 1 (the default) and 8 a year, K9 `svj_terminal_td` at 200 000
   pairs × 512 (and 63) steps over three segments of different θ, ξ, λ
   and at 4096 steps with Σλᵢ·dt = 60 (a count table longer than 64
   entries), each bit for bit against its plain version on the same
   Philox words, with and without the companion leg where it has one; K7
   also against the exact discrete martingale E[D·S_T] = S0·e^{-qT} and
   the Vasicek bond. Each is timed with CUDA events beside its plain
   version and its bound. The viz kernel `svj_viz` (csrc/svj_viz.cu, the
   recorder and the histogram sampler of /api/price) is held against its
   plain version, the torch step loop, on the same draws at the quote's
   step counts (recorder 50 × 50, 62 and 51; sampler 1 024 × 10, 19, 62
   and 51): dt, √dt and λ·dt bit for bit, every jump indicator the
   loop's, every spot within rtol 2e-6; then timed at 50 × 62 and
   1 024 × 62 beside the loop and its latency bound.
4. Main path, with every launch count set to 0 first: the port's HTTP
   server on 127.0.0.1 (GET /api/health; the default POST /api/price solo
   and as 4 concurrent requests that the coalescer batches; a degenerate
   GBM request against Black-Scholes; the default SVJ request against the
   COS oracle; 5 warm requests for latency) and the benchmark entry point
   (`mcos_tpu_torch.bench`), then reads the launch counts: the first
   request raised `svj_viz`'s count and the `viz_kernel_launches` counter
   by exactly 2, and every priced request launched it twice.
5. The request options' path, with the counts set to 0 again: a new server
   on 127.0.0.1 answers use_sobol=false (SVJ against COS; GBM with the CV
   off against Black-Scholes; 4 concurrent requests in one batch, each
   equal to the solo price), scheme="qe" with the Sobol and the PRNG
   driver (against COS), use_importance on a deep-OTM call (against COS),
   rqmc_randomizations=4 under Euler and QE (against COS) and
   POST /api/convergence; then the counts show K3 served every PRNG Euler
   request, K4 every PRNG QE request and K5 every Sobol QE request and
   QE RQMC replicate.
6. The exotics path, with the counts set to 0 again: a new server on
   127.0.0.1 answers POST /api/exotic for every kind (Asian, barrier with
   bridge monitoring and with a window, one-touch, double barrier, double
   no-touch, lookback, digital, variance swap), at the default SVJ
   parameters and, against the closed forms, at degenerate GBM parameters
   (with the control variate on the price must equal the closed form; the
   raw estimate must lie within 3 se of it, the se taken from the same
   path set priced in process with the control variate off); a 252-step
   request, a request that must answer 400, Greeks by autograd (Asian,
   against a bump-and-reprice) and by re-pricing (discrete barrier), and 5
   warm Asian requests for latency. Then the counts show K6 launched once
   per priced request and K3 once per digital.
7. The model families' path, with the counts set to 0 again: a new server
   on 127.0.0.1 answers POST /api/hhw (price against `bsm_hullwhite` at
   T = 1 and T = 10 with the variance frozen; impact; greeks against a
   bump-and-reprice on K7; a correlation matrix that is not positive
   definite → 400), POST /api/svcj (price and compare against
   `svcj_cos_price`; smile; greeks) and POST /api/termsvj (price against
   its own cos_price, also at Σλᵢ·dt = 60; compare; smile; varswap;
   forward_start; cliquet; greeks; calibrate, on the host, recovering the
   segments behind two exact chains; american; no segments → 400), and
   5 warm price requests per route for latency. Then the counts show K7,
   K8 and K9 launched as often as the priced requests say, and K1-K6 not
   at all.
8. The rough Bergomi path, with the counts set to 0 again: a new server on
   127.0.0.1 answers POST /api/rough in every mode: price at 128 steps (the
   exact sampler) and at 512 (K10), the latter against the exact sampler at
   512 steps priced in process; at eta = rho = 0 both against
   Black-Scholes at sigma = sqrt(xi); smile and skew at 512 steps (K10);
   asian, barrier out and in (their sum against the vanilla) and lookback
   at 512 steps (K11), and at eta = 0 each against the port's ExoticEngine
   under GBM on the same grid; greeks at 128 and 512 steps against a
   bump-and-reprice on common random numbers (with the request's peak
   device memory); use_sobol against the PRNG price; a tiny calibrate that
   must recover (H, eta, rho, xi); six requests that must answer 400; 5 warm
   requests each of price at 128 and 512 steps and asian at 512. Then the
   counts show K10 launched once per priced lift request of price, smile
   and skew, K11 once per lift exotic, K1-K9 not at all.
   Before the paths, K10 `rbergomi_lift_integrals` and K11
   `rbergomi_lift_stats` are held against their plain versions at 131 072
   pairs × 512 and 511 steps (H = 0.07, 25 factors), at H = 0.5 (one
   factor) and at 24 factors, and timed beside them and their bounds, with
   the route instantiation's registers, blocks an SM and waves.
9. The Greeks and smile path (slice F), with the counts set to 0 again: a
   new server on 127.0.0.1 answers POST /api/greeks at the schema's width
   (200 000 paths, T = 0.25 → 63 steps): a degenerate GBM request whose
   delta, vega, gamma, theta and rho must lie within 5 standard errors of
   `bs_all_greeks` (the standard errors of the raw pathwise estimators at
   this width, from 8 seeds priced in process, whose mean must lie within
   5 standard errors of its own), the default SVJ request with its AD
   delta and vega against their CRN finite differences, the Greeks
   engine's device programs on the card against the CPU's on shared draws
   (8192 paths, every output of `_all_greeks_device` and the 12-point
   `_ad_delta_vega_batch`, rtol 1e-4 beside 1e-5 × the output's largest
   value), with_cross,
   with_second_order (also at T = 1, 252 steps, with the request's peak
   device memory), with_min_variance, a strike chain (its ATM row equal to
   the single contract's), cash and proportional dividends and two
   requests that must answer 400; POST /api/smile `mc` (one K1 launch a
   request, every strike against COS within 4 se + 1 %) and `cos` with the
   density (its mass 1); `price_term_structure` in process (one K3 launch
   a maturity, every price against COS within 4 se + 1 %); 5 warm requests
   each of /api/greeks and /api/smile in both methods. Then the counts
   show K1 and K3 launched exactly that often and no other kernel.
10. The risk desk path (slice G), with the counts set to 0 again: a new
   server on 127.0.0.1 answers POST /api/stress at the schema's width
   (100 000 pairs, T = 0.25 → 63 steps): the report, every spot row, both
   gap rows and both vol rows against COS within 4 se + 1 % (the se from
   the same K3 results priced in process), under degenerate GBM every row
   equal to Black-Scholes (control variate on) and its raw estimate within
   3 se; mode="matrix" at the default and at custom axes (its (0, 0) cell
   the report's base, its zero-vol row the report's spot rows); two 400s.
   POST /api/hedge at 500 scenarios in every world × hedge the reference
   allows (every figure finite); degenerate GBM at r = q = 0 with zero
   costs and 20 000 scenarios (mean P&L within 3 std/√n + 3 se of the
   premium); ww_band at zero cost equal to bs_delta; mv_delta below
   bs_delta's P&L std in the svj world with ρ < 0; the svj world's left
   tail fatter than the gbm world's; two 400s. POST /api/var at 500 000
   paths: Euler components against the normal oracle, their sums equal to
   VaR and CVaR, a one-asset VaR against the lognormal quantile, the
   t-copula (VaR at ν = 3 above the Gaussian, at ν = 300 within 2 % of it,
   its marginals GBM's within 3 se on a CUDA generator), 2 000 000 paths ×
   16 assets with its peak device memory, two 400s (a dimension mismatch, a
   correlation matrix that is not positive definite). POST /api/regime on
   the canned inputs against the detector in process; 5 warm requests each
   of the report, the gbm and svj hedges, both VaR copulas and the regime.
   Then the counts show K3 launched exactly once per report spot axis and
   vol member, matrix vol row, gbm/svj hedge and in-process price, and no
   other kernel.
11. The American exercise and PDE path (slice H), with the counts set to 0
   again: a new server on 127.0.0.1 answers POST /api/american at the
   schema's width (200 000 paths, T = 1 → 64 steps) on a degenerate put
   (xi = 0, lambda_j = 0: Black-Scholes at sigma = 0.25) against the CRR
   tree at 1000 steps (within 3 se + the LSM's 1 % low-bias allowance),
   with_bounds (lower ≤ CRR ≤ upper, each within 3 se), exercise_every ≥
   steps against Black-Scholes, with_greeks (delta and gamma against a
   CRN bump of the same policy-fixed estimator), with_cos_oracle (against
   the tree) and with_boundary (below the strike), a cash-dividend call
   (above its European on the same paths), a rate curve and a
   proportional dividend; POST /api/pde: the Heston ADI (Craig-Sneyd and
   Douglas) and the PIDE against COS (abs 0.015), the American surface,
   the Black-Scholes grid against Black-Scholes and its American put
   against the tree (at the schema's grid and the engine's), two barrier
   knock-outs under GBM against Reiner-Rubinstein; six requests that must
   answer 400; POST /api/termsvj mode="american" (its no-early-date
   Bermudan in process against cos_price_td); 5 warm requests each of the
   plain, with_bounds and with_greeks American and the heston and bs PDE,
   each once more in process under the profiler (device time, launches,
   busy share, peak memory); the schema's largest PIDE grid (801 × 401)
   with its peak memory; and the LSM, dual, ADI and CN programs on the
   card against the CPU on shared draws and grids. Then the counts show
   no kernel launched.
12. The calibration and surfaces path (slice I). First K1 at
   `/api/calibrate`'s shape: the DE objective of a 24-member population
   through one K1 launch against the same objective through the Euler
   twin on the same draws (100 000 paths × 50 steps), stage 1, stage 2 at
   λ = 0 and λ > 0, rtol 1e-4 (float32 rounding), one member's chain
   prices to 2e-5; the population launch against its plain version (bit
   for bit), against 24 one-member launches (each member word for word)
   and against the Euler twin path by path (S and G to rtol 1e-5), timed
   in turns with those 24 launches (at least 5x faster off a prebuilt
   consts table; also from the members' SVJParams, as the calibration
   calls it) beside its bound, and one member's launch timed. Then, with the counts set to 0 again, a new server
   on 127.0.0.1 answers a default POST /api/calibrate on an 11-strike chain
   (0.8-1.2 × F, T = 0.5) priced by COS at known SVJ parameters, whose fit
   must reprice the chain by COS within a bound derived from the estimator's
   standard errors and bias (`calibration_path`), and an exercise="american"
   request; POST /api/surface on a Black-Scholes chain of a known smile
   (IVs round-trip to 1e-5, SABR and SSVI fits, the arbitrage report);
   POST /api/quotegreeks equal to the CPU's to 1e-9; POST /api/localvol (a
   flat surface within 3 se of Black-Scholes; in process, an SSVI-derived
   surface reprices its IVs within 40 bp); POST /api/slv (flat at ξ > 0
   against Black-Scholes, ξ = 0 against /api/localvol, barrier and
   forward_start); 3 warm requests per route, each route but
   /api/calibrate once in process under the profiler; then the counts show K1 launched exactly 127 times
   a calibration (one launch a generation) and nothing else; and the SLV and
   local-vol loops on the card against the CPU on the same normals.
13. The desk tools (slice J), with the counts set to 0 again: a new server
   on 127.0.0.1 answers POST /api/pnl (explained + unexplained = total,
   equal to the CPU's), /api/margin at the schema's width (200 000 pairs,
   252 steps a year; a hedged book margins to 0, a short call's worst
   scenario is up and matches moving the spot within 5 %, a short put's is
   down, a long call's margin is at most its premium, a strangle is
   strictly subadditive), /api/replicate (a vanilla replicates itself
   against COS, a digital as a dense call spread, a GBM digital against
   Black-Scholes), /api/volderivs (the variance swap within 4 se of its
   closed form, the vol swap under GBM, the VIX MC check against the
   quadrature, VIX put-call parity), /api/book (GBM positions against
   `bs_all_greeks`, a flat book), /api/exposure (forward EE against Black,
   a call's CVA closed form, cva_delta against a CRN difference) and
   /api/modelrisk (an OTM put's premia in order), each route's 400s and the
   500 of a `corr` that is not positive definite, 3 warm requests a route,
   each route once in process under the profiler, a 4 096-position margin
   with its peak device memory, and margin, an Asian replicate, the VIX MC
   check and modelrisk's HHW leg on the card against the CPU (rtol 1e-5 at
   10 000 paths). Every request's launches are checked: K3 exactly 3 a
   margin maturity group, K6 1 a replicate, K4 1 a `with_mc_check`, K7 1 a
   modelrisk, no other kernel, none for book, pnl, exposure and the swaps.
14. The multi-asset and path products (slice K), with the counts set to 0
   again: a new server on 127.0.0.1 answers POST /api/cliquet (a
   GBM-degenerate cliquet and forward start against `cliquet_bs` and
   `forward_start_bs` within 3 se, with the control variate and raw in
   process), /api/quanto (GBM against `quanto_bs`, σ_fx = 0 against
   Black-Scholes), /api/basket (two-asset GBM rainbows against Stulz within
   5 se or 0.02, a K = 0 spread against Margrabe, a single-asset basket
   against Black-Scholes, an implied-correlation round trip; the
   Broadie-Glasserman 9-right max call at S0 = 90, 100, 110 inside the
   reference's bands and its duality bracket reaching [13.892, 13.934]
   with a gap under 0.8) and /api/autocall (an unreachable autocall
   against `no_call_note_bs`, a ρ = 1 worst-of against its single-asset
   note, the par coupon pricing at its target, single-asset and worst-of),
   the routes' 400s and kept 500s, 3 warm requests per default body, each
   default body once in process under the profiler, the wide bodies (64
   assets, a 16-asset worst-of, a 16 384 × 512 bracket) with their peak
   device memory, and every program on the card against the CPU on the
   same draws (rtol 1e-5; the dual 1e-4; the notes' barrier flips and the
   in-sample LSM's exercise flips at 200 000 paths, multi-asset and
   single-asset, counted). No kernel launches on this path.
15. Slices L and M (rough Heston, MLMC, the serving tail), with the
   counts set to 0 again: a new server on 127.0.0.1 answers POST
   /api/roughheston at the default body (200 000 pairs × 2 048 steps × 24
   factors): price against the fractional-Riccati COS price within 4 se +
   0.6 %, H = 1/2 against Heston COS within 4 se + 0.4 %, compare (its ATM
   row the price), greeks (the AD delta within 0.03 of a CRN
   bump-and-reprice in process), smile, skew (six negative skews; T =
   0.025 against 0.4 in the T^(H - 1/2) band), calibrate on COS prices of
   known parameters (the reference test's bands), two 400s and warm
   latencies (median of 5); then GET /api/metrics (counting this phase's
   requests), /api/symbols, /api/quote?symbol=NIFTY (the static universe:
   every urlopen to a host other than the loopback fails at once), / and
   a static file, and a traversal that answers 404. In process: price and
   greeks once under the profiler with their peak device memory (a price
   under 1 GiB: no (steps, 2, paths) sheet); the lifted loop on the card
   against the CPU on the same normals at 16 384 pairs × 512 steps × 24
   factors (G path by path to rtol 1e-5, 99 % of the S paths within rtol
   1e-4, the control-variate payoff means within 1e-5 of the spot; the
   largest S error and the share above 1e-4 printed); an MLMC coupled
   level on the card against the CPU on the same normals and Poisson
   counts; `mlmc_price` at eps = 1 against the Bates COS price. No kernel
   launches on this path.
16. Slice N1, the path-sharded mesh on cuda:0 (`mesh_path`, ~30 s):
   first K3, K4, K6, K7, K8 and K9 against their plain versions at the
   shapes a 4-shard mesh gives them (a quarter of each route's pairs, on a
   shard's seed), bit for bit; then, with the counts set to 0, each
   sharded driver on a one-shard mesh against its unsharded engine
   (`MonteCarloEngine(use_sobol=False)` Euler and QE at 500 000 paths × 63
   steps, the Asian and the digital through `sharded_exotic_price` at
   200 000, `/api/hhw`'s, `/api/svcj`'s and `/api/termsvj`'s engines at
   200 000): the kernel's terminal outputs bit for bit, price and standard
   error within rtol 1e-6; on a 4-shard mesh of cuda:0 at the same total
   paths, each shard's moment dict bit for bit the one-shard run on that
   shard's seed, the 4-shard result their pooled moments; the 4-shard
   wall time against the unsharded time at the same total paths;
   MCOS_AUTO_MESH=1 on one card giving the unsharded price bit for bit;
   the SLV's 4 shards stepping as one cloud (within 1 se of a one-shard
   run of 4·ppd particles); then the counts show each kernel launched as
   often as the drivers say.
17. Prints the kernels' JSON line (each kernel's launches on its own path
   and, under "launches_by_path", on every path; K1's row lists its two
   shapes under "shapes": one member at `/api/price`'s 500 000 × 63 and
   the 24-member population at `/api/calibrate`'s 100 000 × 50), the card
   line and, last, the result line {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line is
printed. Long output goes to chiprun_out/chip_smoke.json.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

SPOT = STRIKE = 22500.0
T_DEFAULT = 0.25          # 63 steps at the schema's 252 steps/year
STEPS_DEFAULT = 63
NUM_PATHS = 500_000       # PriceRequest default
GBM_PAIRS, GBM_STEPS = 1 << 20, 252
EXOTIC_PATHS = 200_000    # ExoticRequest default

# The card's peaks (NVIDIA's H100 SXM data sheet): device memory 3.35 TB/s;
# float32 67 TFLOP/s, i.e. 132 SMs x 128 lanes x 1.98 GHz instruction
# slots with an FMA counted as 2 flops. No unit retires more than those 33.5e12
# thread-instructions per second, so a kernel's operation count over that
# rate is a lower bound on its time, whatever the mix of float, integer and
# special-function instructions.
HBM_BYTES_PER_S = 3.35e12
INSTR_PER_S = 67e12 / 2

# Operations per path-step (K1, K5) or per antithetic pair-step (K2, K3,
# K4): the fewest instruction slots the step's work can take on sm_90, so
# that the time they give is a lower bound.
#   - One Philox4x32-10 call is 38: rounds 2-10 are two IMAD.WIDE.U32 (one
#     gives a product's high and low words) and two LOP3 (a three-input
#     xor) each; round 1 is half that, because its other multiply is of the
#     path word. The key schedule is the same for every call of a thread
#     and is left out. (cuobjdump -sass of the built kernels shows the
#     multiply pairs as IMAD.WIDE.U32 and the xors as LOP3.)
#   - bits_to_uniform 4 (shift, convert, add, multiply); Box-Muller 8 (log,
#     sqrt, sin, cos, four multiplies). Each special function, divide and
#     square root counts one, though its IEEE sequence is longer.
#   - A multiply-add is one FFMA; a negation folds into its consumer; a
#     product of launch constants, or a constant added every step, is known
#     before the loop and is left out.
#   - A choice that depends on the data counts its cheapest outcome: no jump
#     on a step; the QE transition's mass at zero (whose test needs only
#     psi and p, so Acklam's inverse, which feeds the quadratic branch, is
#     not counted either). The count then holds for any data.
#   - Loads count one each; stores, loop control and the once-per-path jump
#     count and exps are left out.
QE_COMMON = 6         # m 1, s2 1, psi 3 (square, max, divide), psi <= 1.5 1
QE_AT_ZERO = 6        # p 5 ((psi-1)/(psi+1) clipped), u <= p 1
# K1 per member path-step, in the algebra it computes (csrc/svj_draws.cu:
# the drift, the jumps and the companion leg leave the step loop, and
# sqrt(dt) folds into the terminal product): xi dW2 2 (xi rho sqrt(dt) z1
# + xi rho_perp sqrt(dt) z2, one multiply and one FFMA), the jump compare
# 1; two branches of 6 (sqrt, the sum of sqrt(v) z1 1, the sum of v 1, the
# v update 2 FFMA and its floor 1). Per path-step, shared by the launch's
# P members: the draw loads (3, or 4 with streamed jump uniforms), the sum
# of z1 1, and with in-kernel uniforms a quarter Philox call + 4.
K1_MEMBER = 2 + 1 + 2 * 6


def k1_ops(members: int = 1, streamed_u: bool = False) -> float:
    """Operations per member path-step of a P-member K1 launch."""
    shared = (4 if streamed_u else 3 + 38 / 4 + 4) + 1
    return K1_MEMBER + shared / members


OPS = {
    # one member, in-kernel jump uniforms (`/api/price`)
    "svj_terminal_from_draws": k1_ops(1),
    # a quarter Philox call, 4 uniforms / 4, two Box-Muller pairs / 4, one
    # FFMA per branch
    "gbm_terminal": (38 + 4 * 4 + 2 * 8) / 4 + 2,
    # half a Philox call, 2 uniforms, Box-Muller; dW1 1, dW2 2; two
    # branches of 7 (sqrt, log S 2, v 4); the companion sum 1
    "svj_terminal": 38 / 2 + 2 * 4 + 8 + 3 + 2 * 7 + 1,
    # one Philox call, 3 uniforms, Box-Muller, the QE transition, vol 4,
    # base 2, log S 2 and log G 1 per branch
    "svj_terminal_qe": 38 + 3 * 4 + 8 + QE_COMMON + QE_AT_ZERO + 4 + 2
    + 2 * 3,
    # 3 loads; jump uniform as in K1; the QE transition; vol 4, base 2, log
    # S 2 and log G 1 per branch
    "svj_terminal_qe_from_draws": 3 + (38 / 4 + 4 + 1) + QE_COMMON
    + QE_AT_ZERO + 4 + 2 + 2 * 3,
}
# K7 per pair-step: one Philox call, 3 uniforms, 1.5 Box-Muller pairs; the
# Cholesky mixes zv 2 and zr 3; dW1, dWv and the OU shock 3; two branches of
# 12 (max, sqrt, log S 3, v 4, the rate integral 1, the OU step 2).
OPS["hhw_terminal"] = 38 + 3 * 4 + 1.5 * 8 + 2 + 3 + 3 + 2 * 12
# K8 per pair-step, no jump in the step pair: two Philox calls per two
# steps, 3 uniforms (two for the diffusion's Box-Muller pair, the jump
# uniform), one Box-Muller pair, the jump compare 1, dW1 1, dW2 2; two
# branches of 8 (max, sqrt, log S 2, v 4); the companion sum 1. The
# jump-size normals and the exponential's uniforms are drawn only for a
# step pair in which a jump lands (csrc/svcj.cu), so with no jump they are
# not counted.
OPS["svcj_terminal"] = 38 + 3 * 4 + 1 * 8 + 1 + 3 + 2 * 8 + 1
# K9 per pair-step: K3's count, three table loads and kappa dt theta_i.
OPS["svj_terminal_td"] = OPS["svj_terminal"] + 3 + 1
# K6 per antithetic pair-step. Shared by the pair: one Philox call, 4
# uniforms, 1.5 Box-Muller pairs, dW1 1, dW2 2, the jump compare 1. Unlike
# K8's, the jump normal of a step is not made lazily: z_c and z_f share
# their Box-Muller pairs with z_d and z_e, which every step needs.
K6_SHARED = 38 + 4 * 4 + 1.5 * 8 + 3 + 1
# One SVJ branch: max, sqrt, log S 2, v 4, exp, two running sums, max, min.
K6_SVJ = 13
# The companion: sigma_cv dW1 once; per branch log G 1, exp, two sums, max,
# min.
K6_GBM_SHARED, K6_GBM = 1, 6
# One single-barrier increment: the new distance 1 (the old one is last
# step's), -2 d d' 2, divide, min, exp, min, log1p, two compares and a
# select 3, the sum 1; the SVJ leg's max(v, 1e-12) dt adds 3 (the
# companion's variance is a launch constant).
K6_SINGLE, K6_SVJ_VAR = 12, 3
# One corridor increment: b, delta, ssum, delta^2 4; four return images and
# five crossings of 6 each (argument 3, min, exp, accumulate); clip 2, log,
# four compares and a select 5, the sum 1.
K6_CORRIDOR = 4 + 9 * 6 + 2 + 1 + 5 + 1


def k6_ops(bridge: str, companion: bool, window_share: float = 1.0,
           branches: int = 2) -> float:
    """Operations per pair-step of K6 in one variant; `window_share` is the
    share of steps whose bridge increment this run computes, `branches`
    the paths a thread carries (2 antithetic, or 1)."""
    inc = {"none": 0, "up": K6_SINGLE, "down": K6_SINGLE,
           "corridor": K6_CORRIDOR}[bridge]
    ops = K6_SHARED + branches * K6_SVJ
    if inc:
        ops += branches * (inc + K6_SVJ_VAR) * window_share
    if companion:
        ops += K6_GBM_SHARED + branches * (K6_GBM + inc * window_share)
    return ops




def bound(name, units: int, in_bytes: int, out_bytes: int) -> dict:
    """The least time the card could take: the larger of the bytes read and
    written over the memory rate and the operations over the instruction
    rate. `name` is a key of OPS, or the operations per unit themselves."""
    ops = OPS[name] if isinstance(name, str) else float(name)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops * units / INSTR_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "ops_per_unit": ops, "units": units,
            "bytes": in_bytes + out_bytes}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


# ─────────────────────────────────────────────────────────────────────────────
# Kernels against their plain versions
# ─────────────────────────────────────────────────────────────────────────────
def check_k1(device, ck, sobol, params):
    steps = int(252 * T_DEFAULT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z1, z2, _, zjs = sobol.sobol_svj_draws(NUM_PATHS, steps, seed=42,
                                           jump_uniforms=False, device=device)
    torch.cuda.synchronize()
    sobol_ms = (time.perf_counter() - t0) * 1e3
    check(all(bool(torch.isfinite(x).all()) for x in (z1, z2, zjs)),
          "Sobol draws finite")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    uj = torch.rand(z1.shape, generator=gen, device=device)
    kw = dict(seed=42, antithetic=True, companion=True, steps_major=True)
    # Bit for bit: the kernel performs its plain version's IEEE operations
    # in the same order (csrc/svj_draws.cu), nothing contracted.
    errs = {}
    for mode, u in (("explicit u_jump", uj), ("in-kernel jumps", None)):
        ker = ck.svj_terminal_from_draws(params, SPOT, T_DEFAULT, z1, z2, u,
                                         zjs, **kw)
        torch.cuda.synchronize()
        ref = ck.svj_terminal_from_draws_plain(params, SPOT, T_DEFAULT, z1,
                                               z2, u, zjs, **kw)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(ker, ref)]
        log(f"K1 {mode}: S, v, G bit for bit against the plain version: "
            f"{same}")
        check(bool(torch.isfinite(ker[0]).all()), f"K1 {mode}: S finite")
        check(all(same), f"K1 {mode} vs plain")
        errs[mode] = float((ker[0] - ref[0]).abs().max())
    twin_err = k1_twin_errs(ck, [params], SPOT, T_DEFAULT, z1, z2, None, zjs,
                            kw["seed"])
    log(f"K1 at {NUM_PATHS} paths x {steps} steps (in-kernel jumps) vs the "
        f"Euler twin (the reference's step algebra), path by path: S rel "
        f"err {twin_err['s_rel_err']:.3e}, G {twin_err['g_rel_err']:.3e} "
        f"(rtol {K1_TWIN_RTOL:g})")
    check(max(twin_err.values()) < K1_TWIN_RTOL, "K1 vs the Euler twin")
    ms = cuda_ms(lambda: ck.svj_terminal_from_draws(
        params, SPOT, T_DEFAULT, z1, z2, None, zjs, **kw))
    plain_ms = cuda_ms(lambda: ck.svj_terminal_from_draws_plain(
        params, SPOT, T_DEFAULT, z1, z2, None, zjs, **kw), reps=3)
    b = bound("svj_terminal_from_draws", steps * NUM_PATHS,
              3 * steps * NUM_PATHS * 4, 3 * 2 * NUM_PATHS * 4)
    log(f"K1 at {NUM_PATHS} paths x {steps} steps: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}); Sobol net (cold, 3 x {steps} dims) "
        f"{sobol_ms:.2f} ms")
    return {"max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "sobol_ms": sobol_ms, "shape": [steps, NUM_PATHS],
            "twin_rel_err": twin_err, **b}


# K1 against the Euler twin (`pricer._euler_twin_pair`: the JAX package's
# step algebra, one step at a time), path by path. K1 sums the drift, the
# jumps and the companion leg apart and carries sum(sqrt(v) z1) and sum(v),
# so only the roundings differ: S and G to rtol 1e-5, as K1 was held before
# its algebra was rearranged.
K1_TWIN_RTOL = 1e-5


def k1_twin_errs(ck, members, spot, T, z1, z2, u_jump, zjs, seed) -> dict:
    """Max relative error of S and G, over every member, branch and path,
    of one K1 launch (antithetic, companion) against the Euler twin on the
    same draws; u_jump None: the kernel's in-kernel stream, which the twin
    takes from `philox_jump_uniforms`."""
    from mcos_tpu_torch.engine.pricer import _euler_twin_pair

    kw = dict(seed=seed, antithetic=True, companion=True, steps_major=True)
    ker = ck.svj_terminal_from_draws_population(members, spot, T, z1, z2,
                                                u_jump, zjs, **kw)
    if u_jump is None:
        u_jump = ck.philox_jump_uniforms(z1.shape[0], z1.shape[1], seed,
                                         z1.device)
    errs = {"s_rel_err": 0.0, "g_rel_err": 0.0}
    for p, params in enumerate(members):
        twin = _euler_twin_pair(params, spot, T, z1, z2, u_jump, zjs, True,
                                True, True)
        errs["s_rel_err"] = max(errs["s_rel_err"], rel_err(ker[0][p],
                                                           twin[0]))
        errs["g_rel_err"] = max(errs["g_rel_err"], rel_err(ker[2][p],
                                                           twin[2]))
    return errs


# The viz kernel (csrc/svj_viz.cu) is bound by latency: a path's steps
# form one serial chain, and each step's v depends on the last through
# about 13 operations (the floor, sqrtf's fast path 6 and its select,
# xi sqrt(v), times dW2, two adds, the floor). At 4 cycles an operation
# (the float32 pipe's latency; MUFU's is longer) and 1.98 GHz that is the
# least time of a launch whatever its width; its bytes, 16 a path-step
# read, take 0.3 us at 1 024 x 62.
VIZ_CHAIN_OPS, VIZ_OP_CYCLES, SM_CLOCK_HZ = 13, 4, 1.98e9
# (record, paths, steps, T): the quote cell's recorder (50 paths; 50 steps
# at 7-28 days, 62 at 91) and sampler (1 024 paths; 10, 19, 62 steps), and
# an odd count for each.
VIZ_SHAPES = [(True, 50, 50, 28 / 365), (True, 50, 62, 91 / 365),
              (True, 50, 51, 51 / 252), (False, 1024, 10, 7 / 365),
              (False, 1024, 19, 28 / 365), (False, 1024, 62, 91 / 365),
              (False, 1024, 51, 51 / 252)]
# Spots rtol 2e-6: the kernel takes the twin's operations in its order,
# uncontracted, on the constants the torch loop forms on the card; only
# the last bits of k = exp(mu_J + sigma_J^2 / 2) - 1 (numpy's exp on the
# host against torch's on the card) and of expf may differ.
VIZ_RTOL = 2e-6


def viz_bound(paths: int, steps: int, record: bool) -> dict:
    """The viz kernel's least time: its latency chain, or its bytes."""
    t_chain = steps * VIZ_CHAIN_OPS * VIZ_OP_CYCLES / SM_CLOCK_HZ * 1e3
    b = bound(0, 0, 16 * paths * steps,
              4 * paths * (steps + 1 if record else 1))
    return {**b, "bound_ms": max(t_chain, b["bytes_ms"]),
            "bound_by": "latency" if t_chain >= b["bytes_ms"] else "bytes",
            "latency_ms": t_chain}


def kernel_device_ms(fn, name: str, reps: int = 50) -> float:
    """Mean device time of the kernels named `name` over `reps` calls of
    fn(), from the profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [e.duration_ns() if hasattr(e, "duration_ns")
            else e.duration_us() * 1000
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and name in e.name()]
    check(len(durs) == reps, f"{name}: {len(durs)} device events of {reps}")
    return sum(durs) / len(durs) / 1e6


def check_viz(device, ck, params):
    """The viz kernel against the torch step loop (its plain version) on
    the same draws at VIZ_SHAPES, then timed at 50 x 62 (the recorder of a
    91-day quote) and 1 024 x 62 (its sampler) beside the loop."""
    pins = []
    for record, paths, steps, T in VIZ_SHAPES:
        gen = torch.Generator(device=device)
        gen.manual_seed(1000 + steps)
        z = torch.randn((steps, 3, paths), generator=gen, device=device)
        u = torch.rand((steps, paths), generator=gen, device=device)
        ker = ck.svj_viz(params, SPOT, T, z, u, record=record)
        torch.cuda.synchronize()
        ref = ck.svj_viz_plain(params, SPOT, T, z, u, record=record)
        c = ck._viz_consts(params, SPOT, T, steps)
        dt = torch.as_tensor(T, dtype=torch.float32, device=device) / steps
        loop = [dt, torch.sqrt(dt), params.lambda_j * dt]
        consts_exact = [np.float32(x.item()) for x in loop] \
            == list(c[[2, 3, 9]])
        jumps_same = bool(torch.equal(
            u < torch.as_tensor(c[9], device=device), u < loop[2]))
        err = rel_err(ker, ref)
        pin = {"record": record, "shape": [paths, steps],
               "consts_bit_for_bit": consts_exact,
               "jump_indicators_same": jumps_same, "rel_err": err,
               "bit_for_bit_share": float((ker == ref).float().mean())}
        pins.append(pin)
        log(f"svj_viz {'recorder' if record else 'sampler'} {paths} x "
            f"{steps}: dt, sqrt dt, lambda dt bit for bit {consts_exact}, "
            f"jump indicators the loop's {jumps_same}, spots rel err "
            f"{err:.3e} (rtol {VIZ_RTOL:g}), "
            f"{100 * pin['bit_for_bit_share']:.2f} % bit for bit")
        check(bool(torch.isfinite(ker).all()), "svj_viz finite")
        check(consts_exact and jumps_same and err <= VIZ_RTOL,
              f"svj_viz {pin}")
    shapes = []
    for record, paths, steps in ((True, 50, 62), (False, 1024, 62)):
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        z = torch.randn((steps, 3, paths), generator=gen, device=device)
        u = torch.rand((steps, paths), generator=gen, device=device)
        T = 91 / 365
        # Through the wrapper back to back, the host's work a launch paces
        # the events; the kernel's own time is the profiler's.
        ms = cuda_ms(lambda: ck.svj_viz(params, SPOT, T, z, u,
                                        record=record), reps=200)
        device_ms = kernel_device_ms(lambda: ck.svj_viz(
            params, SPOT, T, z, u, record=record), "svj_viz_kernel")
        plain_ms = cuda_ms(lambda: ck.svj_viz_plain(params, SPOT, T, z, u,
                                                    record=record), reps=5)
        b = viz_bound(paths, steps, record)
        shapes.append({"record": record, "shape": [paths, steps],
                       "ms": device_ms, "wrapper_ms": ms,
                       "plain_ms": plain_ms, **b})
        log(f"svj_viz {'recorder' if record else 'sampler'} {paths} x "
            f"{steps}: kernel {device_ms:.4f} ms on the card, {ms:.4f} ms a "
            f"call through the wrapper, plain loop {plain_ms:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"pins": pins, "shapes": shapes,
            "max_abs_err": max(p["rel_err"] for p in pins),
            **{k: shapes[1][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")}}


def check_k2(device, ck, bs_price):
    sigma, r, q, T = 0.2, 0.065, 0.012, 1.0
    kw = dict(num_paths=GBM_PAIRS, num_steps=GBM_STEPS, device=device)
    ker = ck.gbm_terminal(SPOT, sigma, r, q, T, 7, **kw)
    torch.cuda.synchronize()
    ref = ck.gbm_terminal_plain(SPOT, sigma, r, q, T, 7, **kw)
    torch.cuda.synchronize()
    err = rel_err(ker, ref)
    log(f"K2 vs plain (same Philox words): S rel err {err:.3e} (rtol 1e-5: "
        "float32; the kernel's hardware log2, rsqrt and sincos against the "
        "plain version's log, sqrt and sin/cos of a float64 angle)")
    check(err < 1e-5, "K2 vs plain")
    lr = torch.log(ker.double() / SPOT)
    drift = (r - q - 0.5 * sigma**2) * T
    mirror = float((lr[0] + lr[1] - 2 * drift).abs().max())
    mean, std = float(lr[0].mean()), float(lr[0].std())
    log(f"K2 mirror |lr0+lr1-2*drift| max {mirror:.2e}; log-return mean "
        f"{mean:.6f} (exact {drift:.6f}), std {std:.6f} "
        f"(exact {sigma * np.sqrt(T):.6f})")
    check(mirror < 2e-5, "K2 antithetic mirror")
    check(abs(mean - drift) < 5 * sigma * np.sqrt(T / GBM_PAIRS), "K2 mean")
    check(abs(std - sigma * np.sqrt(T)) < 5 * sigma * np.sqrt(T / (2 * GBM_PAIRS)),
          "K2 std")
    pay = torch.clamp(ker.double() - STRIKE, min=0).mean(dim=0)
    disc = np.exp(-r * T)
    mc, se = disc * float(pay.mean()), disc * float(pay.std()) / np.sqrt(GBM_PAIRS)
    bs = float(bs_price(SPOT, STRIKE, T, r, q, sigma, True))
    log(f"K2 call {mc:.4f} vs BS {bs:.4f} (3 se = {3 * se:.4f})")
    check(abs(mc - bs) < 3 * se, "K2 BS 3-sigma gate")
    ms = cuda_ms(lambda: ck.gbm_terminal(SPOT, sigma, r, q, T, 8, **kw))
    plain_ms = cuda_ms(lambda: ck.gbm_terminal_plain(SPOT, sigma, r, q, T, 8,
                                                     **kw), reps=2)
    rate = 2 * GBM_PAIRS * GBM_STEPS / (ms * 1e-3)
    b = bound("gbm_terminal", GBM_PAIRS * GBM_STEPS, 0, 2 * GBM_PAIRS * 4)
    log(f"K2 at {GBM_PAIRS} pairs x {GBM_STEPS} steps: kernel {ms:.4f} ms "
        f"({rate:.4e} path-steps/s), plain {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": float((ker - ref).abs().max()), "ms": ms,
            "plain_ms": plain_ms, **b}


def compare_terminal(name, ker, ref, v_bit_for_bit=False):
    """Kernel against plain on the same inputs. rtol 1e-5 on S and G: the
    kernel's multiply-adds are contracted to FMAs and the plain version's
    are not, a few ulps of the log carry per step; v can sit at 0, so it
    gets rtol 1e-4 beside atol 1e-6, and with `v_bit_for_bit` (K5, whose
    variance path repeats the plain version's IEEE operations) it must be
    the same float on every path. Returns (max |S err|, v exact share)."""
    s_err, g_err = rel_err(ker[0], ref[0]), rel_err(ker[2], ref[2])
    v_ok = torch.allclose(ker[1], ref[1], rtol=1e-4, atol=1e-6)
    v_exact = float((ker[1] == ref[1]).float().mean())
    log(f"{name}: S rel err {s_err:.3e}, G rel err {g_err:.3e}, v allclose "
        f"{v_ok}, v bit-equal share {v_exact:.6f}")
    check(bool(torch.isfinite(ker[0]).all()), f"{name}: S finite")
    check(s_err < 1e-5 and g_err < 1e-5 and v_ok, f"{name} vs plain")
    if v_bit_for_bit:
        check(v_exact == 1.0, f"{name}: v bit for bit")
    return float((ker[0] - ref[0]).abs().max()), v_exact


def check_prng(device, ck, params, name):
    """K3 or K4 at the path's width against its plain version on the same
    Philox words, bit for bit on S, v and G: both kernels write every
    operation on their carries as the plain versions do (csrc/philox.cuh:
    fmul, fadd), so rtol 0; the rtol 1e-5 figures of `compare_terminal`
    are logged beside. K4 also at kernel_lab.K5_PSI with 4 and 8 steps,
    where its QE transition takes both branches (tests/
    test_torch_acklam_converged.py shows both on its plain path)."""
    from mcos_tpu_torch.kernel_lab import K5_PSI

    kernel, plain = getattr(ck, name), getattr(ck, name + "_plain")
    t0 = time.perf_counter()
    cases = [(params, T_DEFAULT, STEPS_DEFAULT, "")]
    if name == "svj_terminal_qe":
        cases += [(params.replace(**K5_PSI), 1.0, steps, ", psi cross")
                  for steps in (4, 8)]
    errs, exact = [], {}
    for case_params, T, steps, label in cases:
        kw = dict(num_paths=NUM_PATHS, num_steps=steps, antithetic=True,
                  companion=True, device=device)
        ker = kernel(case_params, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        ref = plain(case_params, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        tag = f"{name} {steps} steps{label}"
        compare_terminal(tag, ker, ref)
        err, shares = compare_family(tag, ker, ref, ("S", "v", "G"),
                                     bit_for_bit=True)
        errs.append(err)
        exact = exact or shares
    kw = dict(num_paths=NUM_PATHS, num_steps=STEPS_DEFAULT, antithetic=True,
              companion=True, device=device)
    ms = cuda_ms(lambda: kernel(params, SPOT, T_DEFAULT, 43, **kw))
    plain_ms = cuda_ms(lambda: plain(params, SPOT, T_DEFAULT, 43, **kw),
                       reps=3)
    b = bound(name, NUM_PATHS * STEPS_DEFAULT, 0, 3 * 2 * NUM_PATHS * 4)
    log(f"{name} at {NUM_PATHS} pairs x {STEPS_DEFAULT} steps: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}); phase {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max(errs), "bit_equal_share": exact,
            "ms": ms, "plain_ms": plain_ms, **b}


def check_k5(device, ck, sobol, params):
    """K5 on the real Sobol QE net, explicit then in-kernel jump uniforms,
    at the route's 500 000 paths x 63 steps and where both QE branches run
    (4 and 8 steps); v bit for bit, S and G at rtol 1e-5."""
    # kernel_lab.K5_PSI: T = 1 from v0 = 0.005 with xi^2 / (2 kappa theta)
    # = 2.25, where the route's defaults give 1.04 (psi never passes 1.5);
    # tests/test_torch_acklam_converged.py shows both branches on its path.
    from mcos_tpu_torch.kernel_lab import K5_PSI

    t0 = time.perf_counter()
    kw = dict(seed=42, antithetic=True, companion=True, steps_major=True)
    errs, exact = [], []
    cases = ((params, T_DEFAULT, STEPS_DEFAULT, ""),
             (params.replace(**K5_PSI), 1.0, 4, ", psi cross"),
             (params.replace(**K5_PSI), 1.0, 8, ", psi cross"))
    for case_params, T, steps, label in cases:
        z_x, u_v, _, z_js = sobol.sobol_qe_draws(
            NUM_PATHS, steps, seed=42, jump_uniforms=False, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(2)
        uj = torch.rand(z_x.shape, generator=gen, device=device)
        if steps == STEPS_DEFAULT:
            route = z_x, u_v, z_js
        for mode, u in (("explicit u_jump", uj), ("in-kernel jumps", None)):
            ker = ck.svj_terminal_qe_from_draws(case_params, SPOT, T, z_x,
                                                u_v, u, z_js, **kw)
            torch.cuda.synchronize()
            ref = ck.svj_terminal_qe_from_draws_plain(
                case_params, SPOT, T, z_x, u_v, u, z_js, **kw)
            torch.cuda.synchronize()
            err, v_exact = compare_terminal(
                f"K5 {steps} steps{label}, {mode}", ker, ref,
                v_bit_for_bit=True)
            errs.append(err)
            exact.append(v_exact)
    z_x, u_v, z_js = route
    ms = cuda_ms(lambda: ck.svj_terminal_qe_from_draws(
        params, SPOT, T_DEFAULT, z_x, u_v, None, z_js, **kw))
    plain_ms = cuda_ms(lambda: ck.svj_terminal_qe_from_draws_plain(
        params, SPOT, T_DEFAULT, z_x, u_v, None, z_js, **kw), reps=3)
    units = STEPS_DEFAULT * NUM_PATHS
    b = bound("svj_terminal_qe_from_draws", units, 3 * units * 4,
              3 * 2 * NUM_PATHS * 4)
    log(f"K5 at {NUM_PATHS} paths x {STEPS_DEFAULT} steps: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}); phase {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max(errs), "v_bit_equal_share": min(exact),
            "ms": ms, "plain_ms": plain_ms, **b}


# K6's variants: (name, steps, T, wrapper keywords, bridge of k6_ops). The
# barriers sit 10-12 % from the spot, where a 63-step SVJ path set has
# every state: dead at an endpoint, alive with a weight near 1, alive with
# a weight near 0.
K6_VARIANTS = (
    ("no bridge + companion", 63, 0.25, dict(companion=True), "none"),
    ("barrier above + companion", 63, 0.25,
     dict(companion=True, bridge=True, bridge_up=True,
          bridge_log_b=float(np.log(1.10))), "up"),
    ("corridor + companion", 63, 0.25,
     dict(companion=True, bridge=True, corridor=True,
          bridge_log_b=float(np.log(1.12)),
          bridge_log_l=float(np.log(0.88))), "corridor"),
    ("corridor + window, no companion", 63, 0.25,
     dict(companion=False, bridge=True, corridor=True, window=(13, 50),
          bridge_log_b=float(np.log(1.12)),
          bridge_log_l=float(np.log(0.88))), "corridor"),
    ("corridor + companion, 252 steps", 252, 1.0,
     dict(companion=True, bridge=True, corridor=True,
          bridge_log_b=float(np.log(1.25)),
          bridge_log_l=float(np.log(0.78))), "corridor"),
)


def compare_stats(name, ker, ref):
    """Every output of K6 against its plain version on the same words, bit
    for bit (-inf, a dead path's log-survival, equal to -inf).

    The kernel rounds every operation on the carries and in the survival
    increments as the plain version does (csrc/svj_stats.cu, "Rounding"),
    and its library functions are the plain version's on the card, so every
    output is the same float; a path whose dead/alive state differs is
    counted apart. Returns (max abs error over all outputs, share of
    s_final bit-equal, paths dead)."""
    check(set(ker) == set(ref), f"{name}: same outputs {sorted(ker)}")
    worst, flips, dead, unequal = 0.0, 0, 0, []
    for key in ker:
        a, b = ker[key], ref[key]
        check(a.shape == b.shape, f"{name}: {key} shape")
        check(not bool(torch.isnan(a).any()), f"{name}: {key} has no NaN")
        if key.endswith("log_surv"):
            inf_a, inf_b = torch.isinf(a), torch.isinf(b)
            flips += int((inf_a != inf_b).sum())
            dead += int(inf_a.sum())
            check(bool((a[inf_a] < 0).all()), f"{name}: {key} dead is -inf")
            live = ~(inf_a | inf_b)
            err = float((a[live] - b[live]).abs().max())
        else:
            check(bool(torch.isfinite(a).all()), f"{name}: {key} finite")
            err = float((a - b).abs().max())
        if not bool((a == b).all()):
            unequal.append(key)
        worst = max(worst, err)
    exact = float((ker["s_final"] == ref["s_final"]).float().mean())
    log(f"K6 {name}: max abs err {worst:.3e} over {len(ker)} outputs "
        f"(limit 0), s_final bit-equal share {exact:.6f}, dead-or-alive "
        f"differs on {flips} paths (limit 0), {dead} dead path-legs")
    check(flips == 0, f"{name}: dead/alive state differs on {flips} paths")
    check(not unequal, f"{name}: not bit for bit on {unequal}")
    return worst, exact, dead


def check_k6(device, ck, params):
    """K6 in each variant at the exotic request's width, word for word
    against its plain version on the same Philox stream."""
    out = {}
    for name, steps, T, kw, bridge in K6_VARIANTS:
        t0 = time.perf_counter()
        kw = dict(kw, num_paths=EXOTIC_PATHS, num_steps=steps,
                  antithetic=True, device=device)
        ker = ck.svj_path_stats(params, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        ref = ck.svj_path_stats_plain(params, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        err, exact, dead = compare_stats(name, ker, ref)
        if kw.get("bridge"):
            check(0 < dead < 2 * EXOTIC_PATHS * (2 if kw["companion"] else 1),
                  f"{name}: some paths dead, some alive")
        ms = cuda_ms(lambda: ck.svj_path_stats(params, SPOT, T, 43, **kw))
        plain_ms = cuda_ms(lambda: ck.svj_path_stats_plain(
            params, SPOT, T, 43, **kw), reps=2)
        w0, w1 = kw.get("window") or (0, steps)
        b = bound(k6_ops(bridge, kw["companion"], (w1 - w0) / steps),
                  EXOTIC_PATHS * steps, 0, len(ker) * 2 * EXOTIC_PATHS * 4)
        log(f"K6 {name} at {EXOTIC_PATHS} pairs x {steps} steps: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f}"
            f" ms ({b['bound_by']}, {b['ops_per_unit']:.1f} per pair-step); "
            f"phase {time.perf_counter() - t0:.1f} s")
        out[name] = {"max_abs_err": err, "s_bit_equal_share": exact,
                     "dead_path_legs": dead, "steps": steps, "ms": ms,
                     "plain_ms": plain_ms, **b}
    return out



# ─────────────────────────────────────────────────────────────────────────────
# K7, K8, K9 against their plain versions
# ─────────────────────────────────────────────────────────────────────────────
FAMILY_PAIRS = 200_000    # HHWRequest, SVCJRequest and TermSVJRequest default
TD_SEGMENTS = [{"t_end": 0.08, "theta": 0.04, "xi": 0.5, "lambda_j": 1.0},
               {"t_end": 0.16, "theta": 0.06, "xi": 0.7, "lambda_j": 2.0},
               {"t_end": 0.25, "theta": 0.09, "xi": 0.9, "lambda_j": 4.0}]
# The /api/termsvj body with 60 expected jumps (sum of lambda_i dt = 60):
# beyond the reference count table's 64 entries, whose mean is 5.6 % short
# there. 4096 steps, so that one Bernoulli test per step (lambda dt = 1.5 %)
# stays close to the oracle's Poisson clock: at 512 steps the scheme's own
# bias is 2 %.
TD_HEAVY = {"T": 3.0, "num_steps": 4096, "segments": [
    {"t_end": 3.0, "theta": 0.04, "xi": 0.5, "lambda_j": 20.0}]}


def compare_family(name, ker, ref, labels, bit_for_bit=False):
    """A family kernel against its plain version on the same Philox words.
    K7-K9 round every operation on their carries as the plain versions do
    (csrc/philox.cuh: fmul, fadd, fsub), so what is left is the last exp:
    rtol 2e-6 on every output (an ulp or two of float32); with
    `bit_for_bit` (K3, K4, K7-K9: torch's exp on the card gives expf's
    bits) every output must be the same float. Returns (max abs error over
    the outputs, {label: bit-equal share, counted in float64})."""
    worst, exact = 0.0, {}
    for label, a, b in zip(labels, ker, ref):
        check((a is None) == (b is None), f"{name}: {label} present in both")
        if a is None:
            continue
        check(a.shape == b.shape, f"{name}: {label} shape")
        check(bool(torch.isfinite(a).all()), f"{name}: {label} finite")
        err = rel_err(a, b)
        check(err < 2e-6, f"{name}: {label} rel err {err:.3e} (rtol 2e-6)")
        worst = max(worst, float((a - b).abs().max()))
        exact[label] = float((a == b).double().mean())
        if bit_for_bit:
            check(bool((a == b).all()), f"{name}: {label} bit for bit")
    log(f"{name}: max abs err {worst:.3e}, bit-equal shares "
        f"{ {k: round(v, 6) for k, v in exact.items()} }")
    return worst, exact


def time_family(name, kernel, plain, args, kw, steps, n_out, in_bytes=0):
    ms = cuda_ms(lambda: kernel(*args, **kw))
    plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=2)
    b = bound(name, FAMILY_PAIRS * steps, in_bytes,
              n_out * 2 * FAMILY_PAIRS * 4)
    log(f"{name} at {FAMILY_PAIRS} pairs x {steps} steps: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, {b['ops_per_unit']:.1f} per pair-step)")
    return {"ms": ms, "plain_ms": plain_ms, "steps": steps, **b}


def check_k7(device, ck, hhw):
    """K7 at the route's width, word for word against its plain version,
    and its own output against the model's two exact identities."""
    t0 = time.perf_counter()
    p = hhw.HHWParams(kappa=2.0, theta=0.05, xi=0.4, v0=0.04, a=0.1, b=0.05,
                      sigma_r=0.012, r0=0.05, rho_sv=-0.6, rho_sr=0.3,
                      rho_vr=0.1, q=0.01)
    T, errs, exact = 2.0, [], {}
    for steps, antithetic in ((128, True), (127, True), (127, False)):
        kw = dict(num_paths=FAMILY_PAIRS, num_steps=steps,
                  antithetic=antithetic, device=device)
        ker = ck.hhw_terminal(p, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        ref = ck.hhw_terminal_plain(p, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        err, shares = compare_family(
            f"K7 {steps} steps, {2 if antithetic else 1} branch(es)", ker,
            ref, ("S", "D"), bit_for_bit=True)
        errs.append(err)
        exact = exact or shares
        if steps == 128:
            s, d = ker[0].double(), ker[1].double()
    # E[D S_T] = S0 e^{-qT} exactly at any step count (left-point rule);
    # E[D] carries the left-point O(dt) bias: 2e-4 relative at this T and
    # step count, the allowance the reference's own test gives it.
    ds = (s * d).mean(dim=0)
    m, se = float(ds.mean()), float(ds.std()) / np.sqrt(FAMILY_PAIRS)
    want = SPOT * np.exp(-p.q * T)
    log(f"K7 martingale E[D S_T] {m:.4f} vs S0 e^-qT {want:.4f} "
        f"(4 se = {4 * se:.4f})")
    check(abs(m - want) < 4 * se, "K7 discounted spot is a martingale")
    dm = d.mean(dim=0)
    bond, bse = float(dm.mean()), float(dm.std()) / np.sqrt(FAMILY_PAIRS)
    exact_bond = hhw.vasicek_bond(p, T)
    log(f"K7 zero-coupon E[D] {bond:.6f} vs Vasicek {exact_bond:.6f} "
        f"(4 se + 2e-4 = {4 * bse + 2e-4:.6f})")
    check(abs(bond - exact_bond) < 4 * bse + 2e-4, "K7 bond vs vasicek_bond")
    kw = dict(num_paths=FAMILY_PAIRS, num_steps=128, device=device)
    out = time_family("hhw_terminal", ck.hhw_terminal, ck.hhw_terminal_plain,
                      (p, SPOT, T, 43), kw, 128, 2)
    log(f"K7 phase {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max(errs), "bit_equal_share": exact,
            "martingale": {"mean": m, "exact": want, "se": se},
            "bond": {"mc": bond, "exact": exact_bond, "se": bse}, **out}


def check_k8(device, ck, SVCJParams):
    """K8 at the route's width, bit for bit against its plain version on
    the same Philox words: at the default jump rate (lambda = 1 a year),
    at lambda = 0 (the jump draws never made) and at lambda = 8 (most step
    pairs of a warp make them)."""
    t0 = time.perf_counter()
    p = SVCJParams()
    errs, exact = [], {}
    for steps, T, companion, lam in ((252, 1.0, True, 1.0),
                                     (252, 1.0, False, 1.0),
                                     (63, 0.25, True, 1.0),
                                     (252, 1.0, True, 0.0),
                                     (252, 1.0, True, 8.0)):
        q = dataclasses.replace(p, lambda_j=lam)
        kw = dict(num_paths=FAMILY_PAIRS, num_steps=steps, antithetic=True,
                  companion=companion, device=device)
        ker = ck.svcj_terminal(q, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        ref = ck.svcj_terminal_plain(q, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        err, shares = compare_family(
            f"K8 {steps} steps, companion {companion}, lambda {lam:g}", ker,
            ref, ("S", "v", "G"), bit_for_bit=True)
        errs.append(err)
        exact = exact or shares
    kw = dict(num_paths=FAMILY_PAIRS, num_steps=252, companion=True,
              device=device)
    out = time_family("svcj_terminal", ck.svcj_terminal,
                      ck.svcj_terminal_plain, (p, SPOT, 1.0, 43), kw, 252, 3)
    log(f"K8 phase {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max(errs), "bit_equal_share": exact, **out}


def check_k9(device, ck, tdsvj, params):
    """K9 at the route's width, word for word against its plain version at
    every shape the families' path gives it: three segments of different
    theta, xi and lambda at 512 and 63 steps, and the 60-expected-jumps
    body's 4096 steps over one segment (the only shape whose count table is
    longer than 64 entries and whose (4, steps) table is 64 KB)."""
    t0 = time.perf_counter()
    cases = [(TD_SEGMENTS, TD_SEGMENTS[-1]["t_end"], 512, True),
             (TD_SEGMENTS, TD_SEGMENTS[-1]["t_end"], 512, False),
             (TD_SEGMENTS, TD_SEGMENTS[-1]["t_end"], 63, True),
             (TD_HEAVY["segments"], TD_HEAVY["T"], TD_HEAVY["num_steps"],
              True)]
    errs, exact, heavy = [], {}, {}
    for segments, T, steps, companion in cases:
        seg = [np.asarray([s[k] for s in segments])
               for k in ("t_end", "theta", "xi", "lambda_j")]
        levels = tdsvj.step_param_arrays(*seg, T, steps)
        check(len({float(x) for x in levels[0]}) == len(segments),
              "one theta level per segment")
        kw = dict(num_paths=FAMILY_PAIRS, num_steps=steps, antithetic=True,
                  companion=companion, device=device)
        ker = ck.svj_terminal_td(params, *levels, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        ref = ck.svj_terminal_td_plain(params, *levels, SPOT, T, 42, **kw)
        torch.cuda.synchronize()
        err, shares = compare_family(
            f"K9 {steps} steps, companion {companion}", ker, ref,
            ("S", "v", "G"), bit_for_bit=True)
        errs.append(err)
        exact = exact or shares
        if segments is TD_HEAVY["segments"]:
            cdf_len = len(ck.poisson_binom_count_table(levels[2] * T / steps))
            log(f"K9 {steps} steps, sum lambda dt = "
                f"{float(levels[2].sum()) * T / steps:.1f}: count table of "
                f"{cdf_len} entries, step table {4 * steps * 4} bytes")
            check(cdf_len > 64, "the heavy shape's count table passes 64")
            heavy = {"steps": steps, "cdf_len": cdf_len, "max_abs_err": err,
                     "bit_equal_share": shares}
    T = TD_SEGMENTS[-1]["t_end"]
    seg = [np.asarray([s[k] for s in TD_SEGMENTS])
           for k in ("t_end", "theta", "xi", "lambda_j")]
    levels = tdsvj.step_param_arrays(*seg, T, 512)
    kw = dict(num_paths=FAMILY_PAIRS, num_steps=512, companion=True,
              device=device)
    out = time_family("svj_terminal_td", ck.svj_terminal_td,
                      ck.svj_terminal_td_plain,
                      (params, *levels, SPOT, T, 43), kw, 512, 3,
                      in_bytes=4 * 512 * 4 + 64 * 8)
    log(f"K9 phase {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max(errs), "bit_equal_share": exact,
            "heavy": heavy, **out}


# ─────────────────────────────────────────────────────────────────────────────
# K10, K11 against their plain versions
# ─────────────────────────────────────────────────────────────────────────────
ROUGH_PAIRS = 131_072     # RoughRequest default
ROUGH_T, ROUGH_H = 0.25, 0.07
# Per pair-step, m factors. K10: half a Philox call 19, 2 uniforms 8, one
# Box-Muller pair 8, the mix w 1 + m (one multiply, then one FFMA per
# factor), eta w 1, dW 1, two branches of 5 (add e_i, exp, sqrt, the I1
# FFMA, the I2 add), the factor update 2m (a multiply and an FFMA each):
# 48 + 3m. K11: one Philox call 38, 3 uniforms 12, 1.5 Box-Muller pairs 12,
# the mix 1 + m, eta w 1, dW 1, dz 3, two branches of 10 (add e_i, exp,
# sqrt, drift 1 FFMA, log S 2, exp, sum, max, min), the factor update 2m:
# 88 + 3m. The tables' loads are two a step, read by every thread of a warp
# at one address (counted: 2).
def rough_ops(name: str, m: int) -> float:
    base = {"rbergomi_lift_integrals": 48, "rbergomi_lift_stats": 88}[name]
    return base + 3 * m + 2


def check_rough_kernel(device, ck, rough, name, route_res):
    """K10 or K11 word for word against its plain version at the lift
    body's width (131 072 pairs x 512 steps, H = 0.07, m = 25), at 511
    steps (the odd tail), at H = 0.5 (m = 1) and with the H = 0.07 tables'
    first 24 factors (the exact m = 24 instantiation) at a small shape;
    timed at 512 steps beside the plain version and the bound, with the
    route instantiation's `route_res` (registers, stack bytes) and the
    blocks an SM and waves they give."""
    from mcos_tpu_torch.kernel_lab import occupancy

    t0 = time.perf_counter()
    kernel, plain = getattr(ck, name), getattr(ck, name + "_plain")
    labels = (("I1", "I2") if name == "rbergomi_lift_integrals"
              else ("S_T", "mean", "max", "min"))

    def call(fn, h, steps, pairs, seed, m=None):
        c, d, g, tail = rough.rbergomi_lift(h, ROUGH_T, steps)
        c, d, g = c[:m], d[:m], g[:m]
        kw = dict(num_paths=pairs, num_steps=steps, device=device)
        if name == "rbergomi_lift_integrals":
            out = fn(1.9, ROUGH_T, seed, c, d, g, tail, h, xi_flat=0.04,
                     **kw)
        else:
            out = tuple(fn((1.9, -0.9, R, Q, 0.04, SPOT), ROUGH_T, seed,
                           c, d, g, tail, h, **kw).values())
        return out, len(c)

    errs, exact, cases = [], {}, {}
    for h, steps, pairs, want_m in ((ROUGH_H, 512, ROUGH_PAIRS, 25),
                                    (ROUGH_H, 511, ROUGH_PAIRS, 25),
                                    (0.5, 64, 16_384, 1),
                                    (ROUGH_H, 64, 16_384, 24)):
        cut = 24 if want_m == 24 else None
        ker, m = call(kernel, h, steps, pairs, 42, cut)
        torch.cuda.synchronize()
        ref, _ = call(plain, h, steps, pairs, 42, cut)
        torch.cuda.synchronize()
        check(m == want_m, f"{name}: m = {m} at H = {h}")
        worst, shares = 0.0, {}
        for label, a, b in zip(labels, ker, ref):
            check(a.shape == b.shape == (2, pairs), f"{name}: {label} shape")
            check(bool(torch.isfinite(a).all()), f"{name}: {label} finite")
            err = float((a - b).abs().max())
            # The carries are uncontracted, in the plain version's order,
            # and the exps and square roots are the same library calls:
            # any difference is a fault.
            check(err == 0.0, f"{name} {steps} steps, H = {h}: {label} max "
                  f"abs err {err:.3e} (bit for bit)")
            worst = max(worst, err)
            shares[label] = float((a == b).float().mean())
        log(f"{name} H = {h} (m = {m}), {pairs} pairs x {steps} steps: max "
            f"abs err {worst:.3e}, bit-equal shares {shares}")
        errs.append(worst)
        cases[f"H={h},steps={steps},m={m}"] = {
            "m": m, "max_abs_err": worst, "bit_equal_share": shares}
        exact = exact or shares
    ms = cuda_ms(lambda: call(kernel, ROUGH_H, 512, ROUGH_PAIRS, 43))
    plain_ms = cuda_ms(lambda: call(plain, ROUGH_H, 512, ROUGH_PAIRS, 43),
                       reps=1)
    b = bound(rough_ops(name, 25), ROUGH_PAIRS * 512, 2 * 512 * 4,
              len(labels) * 2 * ROUGH_PAIRS * 4)
    regs, stack = route_res or (None, None)
    occ = (occupancy(regs, 256, -(-ROUGH_PAIRS // 256)) if regs
           else {"blocks_per_sm": None, "waves": float("nan")})
    log(f"{name} at {ROUGH_PAIRS} pairs x 512 steps: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, {b['ops_per_unit']:.0f} per pair-step); route "
        f"instantiation {regs} registers, stack {stack} B, "
        f"{occ['blocks_per_sm']} blocks of 256 an SM, {occ['waves']:.3f} "
        f"waves; phase {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": max(errs), "bit_equal_share": exact,
            "cases": cases, "ms": ms, "plain_ms": plain_ms, "steps": 512,
            "registers": regs, "stack_bytes": stack,
            "blocks_per_sm": occ["blocks_per_sm"], "waves": occ["waves"],
            **b}


def kernel_resources(lib_path: str, pattern: str = "svj_stats_kernel") -> dict:
    """{kernel: (registers, stack bytes)} of the instantiations whose name
    matches `pattern` (K6's by default), from
    `cuobjdump --dump-resource-usage`; empty when the tool is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    txt = subprocess.run([tool, "--dump-resource-usage", lib_path],
                         capture_output=True, text=True, timeout=120).stdout
    found = re.findall(r"Function (\S*(?:" + pattern + r")\S*):\s*REG:(\d+) "
                       r"STACK:(\d+)", txt)
    return {name: (int(reg), int(stack)) for name, reg, stack in found}


# ─────────────────────────────────────────────────────────────────────────────
# Main path
# ─────────────────────────────────────────────────────────────────────────────
def post(base: str, body: dict, path: str = "/api/price"):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, res = r.status, json.loads(r.read())
    return status, res, (time.perf_counter() - t0) * 1e3


def check_response(status, res, what, diagnostics=True):
    """A 200 with finite prices, passed post-checks and the viz samples.
    bs_ref and raw_mc_price come with the control variate only. Importance
    and RQMC responses carry no frac_nonfinite: pass diagnostics=False for
    them; every other response must report all its paths finite."""
    check(status == 200, f"{what}: status {status}")
    for k in ("price", "std_error"):
        check(np.isfinite(res[k]), f"{what}: {k} finite")
    for k in ("bs_ref", "raw_mc_price"):
        check(k not in res or np.isfinite(res[k]), f"{what}: {k} finite")
    check(res["std_error"] > 0, f"{what}: std_error > 0")
    if diagnostics:
        check(res["frac_nonfinite"] == 0.0, f"{what}: all paths finite")
    check(res["post_checks"]["pass"], f"{what}: post_checks {res['post_checks']}")
    paths = np.asarray(res["sample_paths"], dtype=float)
    check(paths.ndim == 2 and paths.shape[0] == 50, f"{what}: sample_paths")
    check(np.isfinite(paths).all() and len(res["terminal_samples"]) == 1024,
          f"{what}: viz samples")


def main_path(device, ck, bench, cos_price, bs_price, SVJParams, server):
    from mcos_tpu_torch.utils import spans

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    warm_s = time.perf_counter() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    priced = 0
    out = {"server_warm_s": warm_s}
    try:
        with urllib.request.urlopen(base + "/api/health", timeout=60) as r:
            check(r.status == 200 and json.loads(r.read())["status"]
                  == "healthy", "GET /api/health")
        body = {"spot": SPOT, "strike": STRIKE, "T": T_DEFAULT}
        viz0 = ck.launch_counts()["svj_viz"]
        counted0 = spans.RECORDER.counters().get("viz_kernel_launches", 0)
        status, solo, first_ms = post(base, body)
        check_response(status, solo, "default /api/price")
        priced += 1
        viz = (ck.launch_counts()["svj_viz"] - viz0,
               spans.RECORDER.counters()["viz_kernel_launches"] - counted0)
        log(f"one /api/price: svj_viz launched {viz[0]} times, "
            f"viz_kernel_launches counted {viz[1]}")
        check(viz == (2, 2), "one /api/price launches the viz kernel twice")
        log(f"default /api/price: {solo['price']:.4f} ± {solo['std_error']:.4f}"
            f" ({solo['num_steps']} steps, first request {first_ms:.1f} ms)")

        # A 100 ms window for this burst, so all 4 land in one batch
        # whatever the threads' start-up spread; the default is restored
        # before the latency runs.
        coalescer = server.coalesce.coalescer
        batches0, window = coalescer.batches_run, coalescer.window_s
        coalescer.window_s = 0.1
        results = [None] * 4

        def one(i):
            results[i] = post(base, body)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            coalescer.window_s = window
        check(not any(t.is_alive() for t in threads), "concurrent requests done")
        for i, (status, res, ms) in enumerate(results):
            check_response(status, res, f"concurrent request {i}")
            check(res["price"] == solo["price"], "coalesced price == solo")
        priced += 4
        n_batches = coalescer.batches_run - batches0
        log(f"4 concurrent /api/price: all 200, price == solo, in {n_batches} "
            f"coalesced batch(es); latencies "
            f"{[round(r[2], 1) for r in results]} ms")
        check(n_batches == 1, "the 4 concurrent requests form one batch")

        # Control variate off: with it on, the degenerate model's companion
        # leg is the priced path itself and the check would be vacuous.
        sigma = 0.2
        gbm_body = dict(body, use_control_variate=False,
                        params={"kappa": 0.0, "theta": sigma**2,
                                      "xi": 0.0, "rho": 0.0, "v0": sigma**2,
                                      "lambda_j": 0.0, "mu_j": 0.0,
                                      "sigma_j": 0.0})
        status, res, _ = post(base, gbm_body)
        check_response(status, res, "GBM /api/price")
        priced += 1
        bs = float(bs_price(SPOT, STRIKE, T_DEFAULT, 0.065, 0.012, sigma, True))
        log(f"GBM /api/price {res['price']:.4f} vs BS {bs:.4f} "
            f"(3 se = {3 * res['std_error']:.4f})")
        check(abs(res["price"] - bs) < 3 * res["std_error"], "GBM vs BS")

        cos = float(cos_price(SVJParams(), SPOT, [STRIKE], T_DEFAULT, True)[0])
        tol = 4 * solo["std_error"] + 0.01 * cos
        log(f"default SVJ /api/price {solo['price']:.4f} vs COS {cos:.4f} "
            f"(tol 4 se + 1% = {tol:.4f})")
        check(abs(solo["price"] - cos) < tol, "SVJ vs COS")

        lat = []
        for _ in range(5):
            status, res, ms = post(base, body)
            check_response(status, res, "warm /api/price")
            lat.append(ms)
        priced += 5
        out["warm_latency_ms"] = statistics.median(lat)
        out["warm_latencies_ms"] = lat
        out["server_elapsed_ms"] = res["elapsed_ms"]
        log(f"warm default /api/price latency: median {out['warm_latency_ms']:.2f}"
            f" ms over 5 ({[round(x, 2) for x in lat]}); server-side "
            f"elapsed_ms {res['elapsed_ms']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    gate = bench.bs_gate(device)
    check(gate["ok"], f"bench BS gate {gate}")
    rate = bench.throughput(device)
    out["bench_path_steps_per_s"] = rate
    log(f"bench (mcos_tpu_torch.bench): BS gate ok ({gate['mc']:.4f} vs "
        f"{gate['bs']:.4f}), {rate:.4e} path-steps/s")
    counts = ck.launch_counts()
    log(f"launch counts over the main path: {counts} ({priced} priced "
        "requests)")
    check(counts["svj_terminal_from_draws"] >= priced,
          "K1 launched for every priced request")
    check(counts["gbm_terminal"] > 0, "K2 launched by the benchmark")
    check(counts["svj_viz"] == 2 * priced,
          "the viz kernel launched twice for every priced request")
    out["launches"] = counts
    return out


def options_path(device, ck, cos_price, bs_price, SVJParams, server):
    """Every /api/price option but sharding, and /api/convergence, over HTTP
    on a fresh server, with the launch counts set to 0 just before."""
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    body = {"spot": SPOT, "strike": STRIKE, "T": T_DEFAULT}
    cos = float(cos_price(SVJParams(), SPOT, [STRIKE], T_DEFAULT, True)[0])
    expect = {"svj_terminal": 0, "svj_terminal_qe": 0,
              "svj_terminal_qe_from_draws": 0, "svj_terminal_from_draws": 0}
    out = {"cos": cos, "phases_s": {}}

    def phase(name, t0):
        out["phases_s"][name] = time.perf_counter() - t0
        log(f"  phase {name}: {out['phases_s'][name]:.2f} s")

    def vs_cos(res, what, ref=cos):
        tol = 4 * res["std_error"] + 0.01 * ref
        log(f"{what}: {res['price']:.4f} ± {res['std_error']:.4f} vs COS "
            f"{ref:.4f} (tol 4 se + 1% = {tol:.4f})")
        check(abs(res["price"] - ref) < tol, f"{what} vs COS")
        out[what] = {"price": res["price"], "std_error": res["std_error"],
                     "cos": ref}

    try:
        t0 = time.perf_counter()
        prng = dict(body, use_sobol=False)
        status, solo, ms = post(base, prng)
        check_response(status, solo, "use_sobol=false")
        expect["svj_terminal"] += 1
        vs_cos(solo, "use_sobol=false SVJ")
        out["use_sobol=false SVJ"]["first_ms"] = ms
        sigma = 0.2
        gbm = dict(prng, use_control_variate=False,
                   params={"kappa": 0.0, "theta": sigma**2, "xi": 0.0,
                           "rho": 0.0, "v0": sigma**2, "lambda_j": 0.0,
                           "mu_j": 0.0, "sigma_j": 0.0})
        status, res, _ = post(base, gbm)
        check_response(status, res, "use_sobol=false GBM")
        expect["svj_terminal"] += 1
        bs = float(bs_price(SPOT, STRIKE, T_DEFAULT, 0.065, 0.012, sigma,
                            True))
        log(f"use_sobol=false GBM (CV off) {res['price']:.4f} vs BS "
            f"{bs:.4f} (3 se = {3 * res['std_error']:.4f})")
        check(abs(res["price"] - bs) < 3 * res["std_error"],
              "use_sobol=false GBM vs BS")
        out["use_sobol=false GBM"] = {"price": res["price"], "bs": bs,
                                      "std_error": res["std_error"]}

        coalescer = server.coalesce.coalescer
        batches0, window = coalescer.batches_run, coalescer.window_s
        coalescer.window_s = 0.1
        results = [None] * 4

        def one(i):
            results[i] = post(base, prng)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            coalescer.window_s = window
        check(not any(t.is_alive() for t in threads),
              "concurrent PRNG requests done")
        for i, (status, res, _) in enumerate(results):
            check_response(status, res, f"concurrent PRNG request {i}")
            check(res["price"] == solo["price"], "coalesced PRNG == solo")
        expect["svj_terminal"] += 4
        n_batches = coalescer.batches_run - batches0
        log(f"4 concurrent use_sobol=false: all 200, price == solo, in "
            f"{n_batches} batch(es); latencies "
            f"{[round(r[2], 1) for r in results]} ms")
        check(n_batches == 1, "the 4 concurrent PRNG requests form one batch")
        phase("use_sobol=false", t0)

        t0 = time.perf_counter()
        for what, extra, kernel in (
                ("scheme=qe Sobol", {"scheme": "qe"},
                 "svj_terminal_qe_from_draws"),
                ("scheme=qe use_sobol=false",
                 {"scheme": "qe", "use_sobol": False}, "svj_terminal_qe")):
            status, res, ms = post(base, dict(body, **extra))
            check_response(status, res, what)
            expect[kernel] += 1
            vs_cos(res, what)
            out[what]["first_ms"] = ms
        phase("scheme=qe", t0)

        t0 = time.perf_counter()
        otm = 1.25 * SPOT
        cos_otm = float(cos_price(SVJParams(), SPOT, [otm], T_DEFAULT,
                                  True)[0])
        status, res, _ = post(base, dict(body, strike=otm,
                                         use_importance=True))
        check_response(status, res, "use_importance", diagnostics=False)
        check(res["ess"] > 0, "use_importance: ess > 0")
        vs_cos(res, "use_importance K=1.25 S", ref=cos_otm)
        out["use_importance K=1.25 S"].update(ess=res["ess"],
                                              tilt_shift=res["tilt_shift"])
        phase("use_importance", t0)

        t0 = time.perf_counter()
        for what, extra, kernel in (
                ("rqmc_randomizations=4", {}, "svj_terminal_from_draws"),
                ("rqmc_randomizations=4 QE", {"scheme": "qe"},
                 "svj_terminal_qe_from_draws")):
            status, res, _ = post(base, dict(body, rqmc_randomizations=4,
                                             **extra))
            check_response(status, res, what, diagnostics=False)
            check(res["randomizations"] == 4, f"{what}: 4 replicates")
            expect[kernel] += 4
            vs_cos(res, what)
        phase("rqmc", t0)

        t0 = time.perf_counter()
        status, res, _ = post(base, body, path="/api/convergence")
        check(status == 200, f"/api/convergence: status {status}")
        check(res["num_paths"][-1] == NUM_PATHS and all(
            np.isfinite(res["price"])), "/api/convergence series")
        vs_cos({"price": res["price"][-1], "std_error": res["std_error"][-1]},
               "/api/convergence last point")
        phase("convergence", t0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    counts = ck.launch_counts()
    log(f"launch counts over the options' path: {counts} (expected "
        f"{expect})")
    for name, n in expect.items():
        check(counts[name] == n, f"{name} launched once per request that "
              f"runs it ({counts[name]} vs {n})")
    check(counts["gbm_terminal"] == 0, "no K2 on the options' path")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"options' path: {out['wall_s']:.1f} s")
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Exotics path
# ─────────────────────────────────────────────────────────────────────────────
GBM_SIGMA = 0.2
GBM_FIELDS = {"kappa": 0.0, "theta": GBM_SIGMA**2, "xi": 0.0, "rho": 0.0,
              "v0": GBM_SIGMA**2, "lambda_j": 0.0, "mu_j": 0.0,
              "sigma_j": 0.0}
R, Q = 0.065, 0.012       # the schema's default rate and yield


def exotics_path(device, ck, ox, ExoticEngine, gbm_params, server):
    """Every kind of POST /api/exotic over HTTP on a fresh server, with the
    launch counts set to 0 just before; K6 must serve every priced request
    and K3 the digital."""
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    common = {"spot": SPOT, "T": T_DEFAULT, "num_paths": EXOTIC_PATHS}
    up, lo = 1.10 * SPOT, 0.90 * SPOT
    expect = {"svj_path_stats": 0, "svj_terminal": 0}
    out = {"requests": {}}
    # The same path sets with the control variate off, priced in process:
    # K6's stream depends on the seed only, so `price` there is the HTTP
    # response's raw_mc_price and `std_error` is that estimate's.
    raw = ExoticEngine(gbm_params(GBM_SIGMA, R, Q), num_paths=EXOTIC_PATHS,
                       use_control_variate=False, device=device)

    def ask(what, body, kernel="svj_path_stats", n=1):
        status, res, ms = post(base, dict(common, **body),
                               path="/api/exotic")
        check(status == 200, f"{what}: status {status}")
        for k in ("price", "std_error"):
            check(k not in res or np.isfinite(res[k]), f"{what}: {k} finite")
        check("elapsed_ms" in res, f"{what}: elapsed_ms")
        if kernel:
            expect[kernel] += n
        out["requests"][what] = dict(res, latency_ms=ms)
        return res

    def gbm_gate(what, body, ref, raw_res, exact_with_cv=True):
        """The degenerate-GBM request against the closed form `ref`."""
        res = ask(what, dict(body, params=GBM_FIELDS))
        expect["svj_path_stats"] += 1          # raw_res was one launch too
        check(abs(res["raw_mc_price"] - raw_res["price"])
              <= 1e-6 * abs(ref) + 1e-6, f"{what}: HTTP raw estimate "
              f"{res['raw_mc_price']} == in-process {raw_res['price']}")
        gap, se3 = abs(raw_res["price"] - ref), 3 * raw_res["std_error"]
        log(f"{what}: raw {raw_res['price']:.6f} vs closed form {ref:.6f} "
            f"(3 se = {se3:.6f}); with the control variate "
            f"{res['price']:.6f}")
        check(gap < se3, f"{what}: raw estimate within 3 se of closed form")
        if exact_with_cv:
            # The companion leg is the priced leg: the control removes all
            # the noise, up to float32 sums (1e-4 of the price).
            check(abs(res["price"] - ref) < 1e-4 * abs(ref) + 1e-4,
                  f"{what}: with the control variate equals closed form")
        return res

    try:
        # Asian, default SVJ parameters, then degenerate GBM (geometric).
        res = ask("asian arithmetic", {"kind": "asian", "strike": STRIKE})
        check("cv_beta" in res and res["num_steps"] == STEPS_DEFAULT,
              "asian: cv_beta and 63 steps")
        check(res["std_error"] > 0, "asian: std_error > 0")
        log(f"asian arithmetic (SVJ): {res['price']:.4f} ± "
            f"{res['std_error']:.4f}, cv_beta {res['cv_beta']:.4f}")
        geo = float(ox.geometric_asian_bs(SPOT, STRIKE, T_DEFAULT, R, Q,
                                          GBM_SIGMA, STEPS_DEFAULT, True))
        gbm_gate("asian geometric GBM",
                 {"kind": "asian", "strike": STRIKE, "averaging": "geometric"},
                 geo, raw.price_asian(SPOT, STRIKE, T_DEFAULT,
                                      averaging="geometric"))

        # Up-and-out barrier under bridge monitoring.
        bar = {"kind": "barrier", "strike": STRIKE, "barrier": up,
               "monitoring": "bridge"}
        gbm_gate("barrier up-and-out bridge GBM", bar,
                 ox.barrier_bs(SPOT, STRIKE, T_DEFAULT, R, Q, GBM_SIGMA, up),
                 raw.price_barrier(SPOT, STRIKE, T_DEFAULT, up,
                                   monitoring="bridge"))
        res = ask("barrier up-and-out bridge SVJ", bar)
        svj_off = ExoticEngine(
            server.schemas.SVJParamsRequest().to_params(),
            num_paths=EXOTIC_PATHS, use_control_variate=False,
            device=device).price_barrier(SPOT, STRIKE, T_DEFAULT, up,
                                         monitoring="bridge")
        expect["svj_path_stats"] += 1
        log(f"barrier up-and-out bridge (SVJ): {res['price']:.4f} ± "
            f"{res['std_error']:.4f} with the control variate, ± "
            f"{svj_off['std_error']:.4f} without")
        check(0 < res["std_error"] < svj_off["std_error"],
              "barrier SVJ: the control variate lowers the standard error")

        # One-touch (no control variate on any leg: a direct gate).
        res = ask("one_touch bridge GBM",
                  {"kind": "one_touch", "barrier": up, "monitoring": "bridge",
                   "params": GBM_FIELDS})
        ref = ox.one_touch_bs(SPOT, T_DEFAULT, R, Q, GBM_SIGMA, up)
        log(f"one_touch bridge GBM: {res['price']:.6f} vs closed form "
            f"{ref:.6f} (3 se = {3 * res['std_error']:.6f})")
        check(abs(res["closed_form_gbm"] - ref) < 1e-12,
              "one_touch: closed_form_gbm")
        check(abs(res["price"] - ref) < 3 * res["std_error"],
              "one_touch GBM within 3 se of one_touch_bs")

        # Corridor kinds (bridge monitoring by default).
        gbm_gate("double_barrier GBM",
                 {"kind": "double_barrier", "strike": STRIKE, "barrier": up,
                  "barrier_lo": lo},
                 ox.double_barrier_bs(SPOT, STRIKE, T_DEFAULT, R, Q,
                                      GBM_SIGMA, lo, up),
                 raw.price_double_barrier(SPOT, STRIKE, T_DEFAULT, lo, up))
        res = gbm_gate("double_no_touch GBM",
                       {"kind": "double_no_touch", "barrier": up,
                        "barrier_lo": lo},
                       ox.double_no_touch_bs(SPOT, T_DEFAULT, R, Q, GBM_SIGMA,
                                             lo, up),
                       raw.price_double_no_touch(SPOT, T_DEFAULT, lo, up))
        check(res["monitoring"] == "bridge", "corridor default is bridge")

        # Window barrier: monitored on [0.05, 0.2] snapped to the grid.
        win_raw = raw.price_barrier(SPOT, STRIKE, T_DEFAULT, up,
                                    monitoring="bridge", window=(0.05, 0.2))
        t1, t2 = win_raw["window_effective"]
        res = gbm_gate("barrier window GBM", dict(bar, window=[0.05, 0.2]),
                       ox.window_barrier_bs(SPOT, STRIKE, T_DEFAULT, R, Q,
                                            GBM_SIGMA, up, t1, t2),
                       win_raw)
        check(res["window_effective"] == [t1, t2], "window_effective")

        # Floating lookback: the grid minimum undershoots the continuous
        # one. First-order BGK: min over the grid ~ e^{+beta sigma sqrt(dt)}
        # x the continuous minimum, and call = S e^{-qT} - df E[min], so the
        # discrete price is cf - (e^shift - 1)(S e^{-qT} - cf). Allowance:
        # 3 se plus a tenth of that correction (it is first order only).
        look_raw = raw.price_lookback(SPOT, T_DEFAULT)
        res = ask("lookback floating GBM",
                  {"kind": "lookback", "params": GBM_FIELDS})
        expect["svj_path_stats"] += 1
        cf = float(ox.lookback_float_bs(SPOT, T_DEFAULT, R, Q, GBM_SIGMA))
        shift = ox.BGK_BETA * GBM_SIGMA * np.sqrt(T_DEFAULT / STEPS_DEFAULT)
        corr = (np.exp(shift) - 1.0) * (SPOT * np.exp(-Q * T_DEFAULT) - cf)
        tol = 3 * look_raw["std_error"] + 0.1 * corr
        log(f"lookback floating GBM: raw {look_raw['price']:.4f}, with the "
            f"control variate {res['price']:.4f}; continuous closed form "
            f"{cf:.4f}, BGK-corrected {cf - corr:.4f} (tol {tol:.4f})")
        check(abs(res["raw_mc_price"] - look_raw["price"]) < 1e-6 * cf,
              "lookback: HTTP raw estimate == in-process")
        check(abs(look_raw["price"] - (cf - corr)) < tol,
              "lookback within the BGK allowance of lookback_float_bs")
        check(abs(res["price"] - (cf - corr)) < tol,
              "lookback with the control variate within the same window")

        # Digital on K3, against e^{-rT} N(d2).
        from scipy.stats import norm
        res = ask("digital GBM", {"kind": "digital", "strike": STRIKE,
                                  "params": GBM_FIELDS}, kernel="svj_terminal")
        d2 = ((np.log(SPOT / STRIKE) + (R - Q - 0.5 * GBM_SIGMA**2)
               * T_DEFAULT) / (GBM_SIGMA * np.sqrt(T_DEFAULT)))
        ref = float(np.exp(-R * T_DEFAULT) * norm.cdf(d2))
        log(f"digital GBM: {res['price']:.6f} vs closed form {ref:.6f} "
            f"(3 se = {3 * res['std_error']:.6f}), delta {res['delta']:.3e}")
        check(abs(res["price"] - ref) < 3 * res["std_error"],
              "digital GBM within 3 se of e^-rT N(d2)")
        check(np.isfinite(res["delta"]) and res["delta"] > 0, "digital delta")

        res = ask("variance_swap", {"kind": "variance_swap"}, kernel=None)
        # theta + (v0 - theta)(..) + lambda (mu_J^2 + sigma_J^2) at defaults
        check(abs(res["fair_variance"] - (0.04 + 1.0 * (0.05**2 + 0.10**2)))
              < 1e-12, f"variance_swap fair_variance {res['fair_variance']}")

        res = ask("asian T=1.0", {"kind": "asian", "strike": STRIKE,
                                  "T": 1.0})
        check(res["num_steps"] == 252 and res["std_error"] > 0,
              "asian at T = 1.0 runs 252 steps")

        try:
            post(base, dict(common, kind="barrier", strike=STRIKE),
                 path="/api/exotic")
            check(False, "barrier without barrier must answer 400")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"barrier without barrier: status {e.code}")
            detail = json.loads(e.read())["detail"]
            check("barrier" in detail, f"400 detail {detail!r}")

        # Greeks. Asian: one autograd pass through the torch twin (no K6
        # beyond the price's), against a central difference of the K6 price
        # on the same seed, spot +- 1 %. The twin's stream is another than
        # K6's, so the two deltas differ by Monte Carlo noise: window 0.02.
        res = ask("asian with_greeks", {"kind": "asian", "strike": STRIKE,
                                        "with_greeks": True})
        g = res["greeks"]
        check(g["method"] == "pathwise_ad", "asian greeks by autograd")
        h = 0.01
        hi_p = ask("asian spot +1%", {"kind": "asian", "strike": STRIKE,
                                      "spot": SPOT * (1 + h)})["price"]
        lo_p = ask("asian spot -1%", {"kind": "asian", "strike": STRIKE,
                                      "spot": SPOT * (1 - h)})["price"]
        fd = (hi_p - lo_p) / (2 * h * SPOT)
        log(f"asian delta: autograd {g['delta']:.5f} vs bump-and-reprice "
            f"{fd:.5f} (window 0.02); vega {g['vega']:.3f}, rho "
            f"{g['rho']:.3f}")
        check(abs(g["delta"] - fd) < 0.02, "asian delta vs bump-and-reprice")
        check(abs(g["price"] - res["price"]) < 4 * res["std_error"]
              + 1e-3 * res["price"], "asian greeks price vs K6 price")
        # Discrete barrier: CRN central differences, so the request prices
        # six times on K6 (the price, then base, spot up, spot down, v0 up,
        # v0 down).
        res = ask("barrier discrete with_greeks",
                  {"kind": "barrier", "strike": STRIKE, "barrier": up,
                   "with_greeks": True}, n=6)
        g = res["greeks"]
        check(g["method"] == "crn_fd_homogeneity" and np.isfinite(g["delta"])
              and np.isfinite(g["vega"]), f"barrier greeks {g}")
        # Bridge barrier: autograd through the bridge weight.
        res = ask("barrier window with_greeks",
                  dict(bar, window=[0.05, 0.2], with_greeks=True))
        g = res["greeks"]
        check(g["method"] == "pathwise_ad_bridge"
              and all(np.isfinite(g[k]) for k in ("delta", "vega", "rho")),
              f"bridge barrier greeks {g}")

        lat = []
        for _ in range(5):
            status, res, ms = post(base, dict(common, kind="asian",
                                              strike=STRIKE),
                                   path="/api/exotic")
            check(status == 200 and np.isfinite(res["price"]),
                  "warm asian request")
            lat.append(ms)
        expect["svj_path_stats"] += 5
        out["warm_latency_ms"] = statistics.median(lat)
        out["warm_latencies_ms"] = lat
        out["server_elapsed_ms"] = res["elapsed_ms"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    counts = ck.launch_counts()
    log(f"launch counts over the exotics path: {counts} (expected {expect})")
    for name, n in expect.items():
        check(counts[name] == n, f"{name} launched once per request that "
              f"runs it ({counts[name]} vs {n})")
    for name in ("svj_terminal_from_draws", "gbm_terminal", "svj_terminal_qe",
                 "svj_terminal_qe_from_draws"):
        check(counts[name] == 0, f"no {name} on the exotics path")
    out["launches"] = counts
    out["k6_variants"] = dict(ck.svj_path_stats.variants)
    out["wall_s"] = time.perf_counter() - t_start
    return out


K6_MODES = ("none", "up", "down", "corridor")


def k6_mix(device, ck, params, variants):
    """K6's launches on the exotics path by variant (mode, companion,
    steps, window, branches), each variant timed at the route's 200 000
    pairs beside its bound (barriers 10-12 % from the spot; K6 has no
    data-dependent branch that a path takes, so the levels do not move
    the time): the path's loss, sum of launches x (ms - bound ms)."""
    rows, loss = [], 0.0
    for (mode, companion, steps, w0, w1, nb), n in sorted(variants.items()):
        name = K6_MODES[mode]
        kw = dict(num_paths=EXOTIC_PATHS, num_steps=steps,
                  antithetic=nb == 2, companion=companion, device=device)
        if mode:
            kw.update(bridge=True, bridge_up=mode == 1,
                      corridor=mode == 3,
                      bridge_log_b=float(np.log(1.12 if mode != 2 else 0.88)),
                      bridge_log_l=float(np.log(0.88)))
            if (w0, w1) != (0, steps):
                kw["window"] = (w0, w1)
        ms = cuda_ms(lambda: ck.svj_path_stats(params, SPOT, steps / 252, 43,
                                               **kw))
        rows_out = (5 if mode == 0 else 6) * (2 if companion else 1)
        b = bound(k6_ops(name, companion, (w1 - w0) / steps, nb),
                  EXOTIC_PATHS * steps, 0, rows_out * nb * EXOTIC_PATHS * 4)
        loss += n * (ms - b["bound_ms"])
        rows.append({"mode": name, "companion": companion, "steps": steps,
                     "window": [w0, w1], "branches": nb, "launches": n,
                     "ms": ms, "bound_ms": b["bound_ms"]})
        log(f"K6 on the exotics path: {n} x {name}"
            f"{' + companion' if companion else ''}, {steps} steps, window "
            f"[{w0}, {w1}), {nb} branch(es): {ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms")
    log(f"K6 loss over the exotics path's mix: {loss:.4f} ms "
        f"(launches x (ms - bound ms))")
    return {"variants": rows, "loss_ms": loss}


# ─────────────────────────────────────────────────────────────────────────────
# Model families' path
# ─────────────────────────────────────────────────────────────────────────────
def families_path(device, ck, hhw, svcj, tdsvj, server):
    """POST /api/hhw, /api/svcj and /api/termsvj over HTTP on a fresh
    server, with the launch counts set to 0 just before; K7, K8 and K9 must
    serve every priced request and K1-K6 none."""
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    expect = {"hhw_terminal": 0, "svcj_terminal": 0, "svj_terminal_td": 0}
    out = {"requests": {}}

    def ask(route, what, body, kernel=None, n=1):
        status, res, ms = post(base, body, path=f"/api/{route}")
        check(status == 200 and "elapsed_ms" in res,
              f"{what}: status {status}")
        if kernel:
            expect[kernel] += n
        out["requests"][what] = dict(res, latency_ms=ms)
        return res

    def refused(route, what, body, code, needle):
        try:
            post(base, body, path=f"/api/{route}")
            check(False, f"{what} must answer {code}")
        except urllib.error.HTTPError as e:
            check(e.code == code, f"{what}: status {e.code}")
            detail = json.loads(e.read())["detail"]
            check(needle in str(detail), f"{what}: detail {detail!r}")
            log(f"{what}: {code} {detail!r}")

    def warm_latency(route, body, kernel):
        lat = []
        for _ in range(5):
            status, res, ms = post(base, body, path=f"/api/{route}")
            check(status == 200 and np.isfinite(res["price"]),
                  f"warm /api/{route}")
            lat.append(ms)
        expect[kernel] += 5
        out[f"warm_{route}_ms"] = statistics.median(lat)
        out[f"warm_{route}_server_ms"] = res["elapsed_ms"]
        log(f"warm /api/{route} price latency: median "
            f"{statistics.median(lat):.2f} ms over 5 "
            f"({[round(x, 2) for x in lat]}); server-side elapsed_ms "
            f"{res['elapsed_ms']}")

    try:
        # ── /api/hhw ────────────────────────────────────────────────────
        # Variance frozen (xi = 1e-4, theta = v0): GBM + Vasicek rates, the
        # closed form of `bsm_hullwhite`. The spot and rate steps are exact
        # then; the left-point rate integral leaves an O(dt) bias, allowed
        # 0.1 % of the price beside 3 se.
        sig = 0.2
        frozen = {"spot": SPOT, "strike": STRIKE, "xi": 1e-4,
                  "theta": sig**2, "v0": sig**2, "rho_sv": 0.0}
        for T in (1.0, 10.0):
            res = ask("hhw", f"hhw price frozen variance T={T}",
                      dict(frozen, T=T), "hhw_terminal")
            req = server.schemas.HHWRequest(**dict(frozen, T=T))
            p = hhw.HHWParams(**{k: getattr(req, k) for k in (
                "kappa", "theta", "xi", "v0", "a", "b", "sigma_r", "r0",
                "rho_sv", "rho_sr", "rho_vr", "q")})
            ref = hhw.bsm_hullwhite(p, SPOT, STRIKE, T, sig, True)
            tol = 3 * res["std_error"] + 1e-3 * ref
            log(f"/api/hhw T={T}: {res['price']:.4f} ± "
                f"{res['std_error']:.4f} vs bsm_hullwhite {ref:.4f} (tol 3 se "
                f"+ 0.1% = {tol:.4f}); bond {res['zero_coupon_mc']:.6f} vs "
                f"{res['zero_coupon_exact']:.6f}")
            check(res["num_steps"] == 128 and res["num_paths_used"]
                  == FAMILY_PAIRS, "hhw at the schema's width")
            check(abs(res["price"] - ref) < tol, f"hhw T={T} vs bsm_hullwhite")
        # The premium of stochastic rates, on common random numbers, against
        # the closed form's own difference (the joint standard error is a
        # loose allowance: the two legs share their normals).
        res = ask("hhw", "hhw impact", dict(frozen, T=5.0, mode="impact"),
                  "hhw_terminal", n=2)
        req = server.schemas.HHWRequest(**dict(frozen, T=5.0))
        p = hhw.HHWParams(**{k: getattr(req, k) for k in (
            "kappa", "theta", "xi", "v0", "a", "b", "sigma_r", "r0",
            "rho_sv", "rho_sr", "rho_vr", "q")})
        ref = (hhw.bsm_hullwhite(p, SPOT, STRIKE, 5.0, sig, True)
               - hhw.bsm_hullwhite(dataclasses.replace(p, sigma_r=1e-8),
                                   SPOT, STRIKE, 5.0, sig, True))
        log(f"/api/hhw impact T=5: {res['price']:.4f}, deterministic rates "
            f"{res['price_deterministic_rates']:.4f}, premium "
            f"{res['stochastic_rates_premium']:.4f} vs closed form {ref:.4f} "
            f"(4 joint se = {4 * res['std_error']:.4f})")
        check(res["stochastic_rates_premium"] > 0
              and abs(res["stochastic_rates_premium"] - ref)
              < 4 * res["std_error"], "hhw impact vs closed-form premium")
        body = {"spot": SPOT, "strike": STRIKE, "T": 5.0}
        g = ask("hhw", "hhw greeks", dict(body, T=1.0, mode="greeks"))
        h = 0.01
        hi_p = ask("hhw", "hhw spot +1%", dict(body, T=1.0,
                                               spot=SPOT * (1 + h)),
                   "hhw_terminal")["price"]
        lo_p = ask("hhw", "hhw spot -1%", dict(body, T=1.0,
                                               spot=SPOT * (1 - h)),
                   "hhw_terminal")["price"]
        fd = (hi_p - lo_p) / (2 * h * SPOT)
        log(f"/api/hhw delta: autograd {g['delta']:.5f} vs bump-and-reprice "
            f"on K7 {fd:.5f} (window 0.02); vega/vol pt "
            f"{g['vega_per_vol_point']:.2f}, rate vega {g['rate_vega']:.2f}, "
            f"rho rate {g['rho_rate']:.2f}")
        check(abs(g["delta"] - fd) < 0.02, "hhw delta vs bump-and-reprice")
        check(all(np.isfinite(g[k]) for k in (
            "vega_per_vol_point", "rate_vega", "rho_rate")), "hhw greeks")
        refused("hhw", "hhw correlation not positive definite",
                dict(body, rho_sv=-0.999, rho_sr=0.999, rho_vr=0.999), 400,
                "positive definite")
        warm_latency("hhw", dict(body, T=1.0), "hhw_terminal")

        # ── /api/svcj ───────────────────────────────────────────────────
        sv = {"spot": SPOT, "T": 0.25}
        p = server.schemas.SVCJParamsRequest().to_params()
        res = ask("svcj", "svcj price", sv, "svcj_terminal")
        cos = float(svcj.svcj_cos_price(p, SPOT, [SPOT], 0.25, True)[0])
        tol = 4 * res["std_error"] + 0.01 * cos
        log(f"/api/svcj price: {res['price']:.4f} ± {res['std_error']:.4f} vs "
            f"svcj_cos_price {cos:.4f} (tol 4 se + 1% = {tol:.4f})")
        check(res["num_steps"] == STEPS_DEFAULT and res["frac_nonfinite"] == 0,
              "svcj at 63 steps, all paths finite")
        check(abs(res["price"] - cos) < tol, "svcj price vs COS")
        res = ask("svcj", "svcj compare T=1", dict(sv, T=1.0, mode="compare"),
                  "svcj_terminal")
        check(len(res["rows"]) == 5, "svcj compare: 5 rows")
        for row in res["rows"]:
            tol = 4 * row["std_error"] + 0.01 * row["cos_price"]
            check(abs(row["mc_price"] - row["cos_price"]) < tol,
                  f"svcj compare K={row['strike']:.0f}: {row['mc_price']:.3f}"
                  f" vs {row['cos_price']:.3f} (tol {tol:.3f})")
        log("/api/svcj compare T=1 (252 steps): err_sigmas "
            f"{[round(r['err_sigmas'], 2) for r in res['rows']]}")
        res = ask("svcj", "svcj smile", dict(sv, mode="smile"))
        check(all(v is not None and 0.05 < v < 1.0 for v in res["iv"]),
              f"svcj smile {res['iv']}")
        check(res["iv"][0] > res["iv"][-1], "svcj smile is skewed down")
        g = ask("svcj", "svcj greeks", dict(sv, mode="greeks"))
        check(0.3 < g["delta"] < 0.9 and g["vega"] > 0, f"svcj greeks {g}")
        warm_latency("svcj", sv, "svcj_terminal")

        # ── /api/termsvj ────────────────────────────────────────────────
        td = {"spot": SPOT, "T": 0.25, "segments": TD_SEGMENTS}
        res = ask("termsvj", "termsvj price", td, "svj_terminal_td")
        tol = 4 * res["std_error"] + 0.01 * res["cos_price"]
        log(f"/api/termsvj price: {res['price']:.4f} ± "
            f"{res['std_error']:.4f} vs its cos_price {res['cos_price']:.4f} "
            f"(tol 4 se + 1% = {tol:.4f})")
        check(abs(res["price"] - res["cos_price"]) < tol, "termsvj vs COS")
        check(res["segments"]["lams"] == [1.0, 2.0, 4.0], "termsvj segments")
        # TD_HEAVY: the shape `check_k9` also holds against the plain
        # version word for word.
        heavy = dict(TD_HEAVY, spot=SPOT)
        res = ask("termsvj", "termsvj price, 60 expected jumps", heavy,
                  "svj_terminal_td")
        tol = 4 * res["std_error"] + 0.01 * res["cos_price"]
        log(f"/api/termsvj lambda T = 60: {res['price']:.4f} ± "
            f"{res['std_error']:.4f} vs cos_price {res['cos_price']:.4f} "
            f"(tol {tol:.4f})")
        check(abs(res["price"] - res["cos_price"]) < tol,
              "termsvj at 60 expected jumps vs COS")
        res = ask("termsvj", "termsvj compare", dict(td, mode="compare"),
                  "svj_terminal_td")
        for row in res["rows"]:
            tol = 4 * row["std_error"] + 0.01 * row["cos_price"]
            check(abs(row["price"] - row["cos_price"]) < tol,
                  f"termsvj compare K={row['strike']:.0f}")
        log("/api/termsvj compare: abs_error_sigma "
            f"{[round(r['abs_error_sigma'], 2) for r in res['rows']]}")
        res = ask("termsvj", "termsvj smile", dict(td, mode="smile"))
        check(all(0.05 < r["iv"] < 1.5 for r in res["smile"]),
              "termsvj smile ivs")
        res = ask("termsvj", "termsvj varswap", dict(td, mode="varswap"))
        log(f"/api/termsvj varswap: closed {res['fair_variance']:.6f}, MC "
            f"{res['mc_fair_variance']:.6f} ± {res['mc_std_error']:.6f} "
            f"({res['mc_vs_closed_sigmas']:.2f} sigmas)")
        check(res["mc_vs_closed_sigmas"] < 4, "termsvj varswap MC vs closed")
        res = ask("termsvj", "termsvj forward_start",
                  dict(td, mode="forward_start", t1=0.1))
        check(0 < res["price"] < 0.2 and res["std_error"] > 0
              and abs(res["t1_effective"] - 0.1) < 1e-3,
              f"termsvj forward_start {res}")
        res = ask("termsvj", "termsvj cliquet", dict(td, mode="cliquet"))
        check(0 < res["price"] < 4 * 0.08 and res["num_steps"] == 512,
              f"termsvj cliquet {res}")
        g = ask("termsvj", "termsvj greeks", dict(td, mode="greeks"))
        check(0.3 < g["delta"] < 0.9 and g["vega"] > 0, f"termsvj greeks {g}")
        # mode="american" (slice H): the LSM on the td sheet, no kernel;
        # the American/PDE path pins its Bermudan limit against COS.
        res = ask("termsvj", "termsvj american", dict(td, mode="american"))
        check(np.isfinite(res["price"]) and res["std_error"] > 0
              and res["segments"]["lams"] == [1.0, 2.0, 4.0],
              f"termsvj american {res}")
        refused("termsvj", "termsvj without segments",
                {"spot": SPOT, "T": 0.25}, 400, "segment")
        # calibrate: the host-only bootstrap (scipy differential evolution
        # over `cos_price_td`, no kernel) must recover, from two exact
        # three-strike chains, the two segments that made them.
        truth = [{"t_end": 0.25, "theta": 0.05, "xi": 0.6, "lambda_j": 1.5},
                 {"t_end": 0.5, "theta": 0.08, "xi": 0.8, "lambda_j": 3.0}]
        seg = [np.asarray([x[k] for x in truth])
               for k in ("t_end", "theta", "xi", "lambda_j")]
        chain = [SPOT * m for m in (0.9, 1.0, 1.1)]
        shared = server.schemas.SVJParamsRequest().to_params()
        market = [[float(x) for x in tdsvj.cos_price_td(
            shared, SPOT, chain, T, *seg, True)] for T in (0.25, 0.5)]
        res = ask("termsvj", "termsvj calibrate",
                  {"spot": SPOT, "mode": "calibrate", "strikes": chain,
                   "maturities": [0.25, 0.5], "market_prices": market})
        log(f"/api/termsvj calibrate: {res['segments']} in "
            f"{res['elapsed_ms']:.0f} ms (host)")
        for fit, want in zip(res["segments"], truth):
            check(all(abs(fit[k] - want[k]) < 1e-2 * want[k] for k in want),
                  f"termsvj calibrate recovers {want}: {fit}")
        warm_latency("termsvj", td, "svj_terminal_td")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    counts = ck.launch_counts()
    log(f"launch counts over the families' path: {counts} (expected "
        f"{expect})")
    for name, n in counts.items():
        check(n == expect.get(name, 0), f"{name} launched {n} times, "
              f"expected {expect.get(name, 0)}")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"families' path: {out['wall_s']:.1f} s")
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Rough Bergomi path
# ─────────────────────────────────────────────────────────────────────────────
def bs64(spot, strike, T, r, q, sigma, is_call=True) -> float:
    """Black-Scholes in float64 (the eta = 0 limit of every rough price)."""
    sd = sigma * np.sqrt(T)
    d1 = (np.log(spot / strike) + (r - q + 0.5 * sigma**2) * T) / sd
    d2 = d1 - sd
    ncdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))  # noqa
    call = (spot * np.exp(-q * T) * ncdf(d1)
            - strike * np.exp(-r * T) * ncdf(d2))
    return float(call if is_call
                 else call - spot * np.exp(-q * T) + strike * np.exp(-r * T))


def rough_path(device, ck, rough, rough_engine, ExoticEngine, gbm_params,
               server):
    """POST /api/rough in every mode over HTTP on a fresh server, with the
    launch counts set to 0 just before: K10 must serve every priced lift
    request of price, smile and skew, K11 every lift exotic, K1-K9 none."""
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    common = {"spot": SPOT, "T": ROUGH_T}
    lift = dict(common, num_steps=512)
    expect = {"rbergomi_lift_integrals": 0, "rbergomi_lift_stats": 0}
    out = {"requests": {}}

    def ask(what, body, kernel=None, n=1):
        status, res, ms = post(base, body, path="/api/rough")
        check(status == 200 and "elapsed_ms" in res, f"{what}: status "
              f"{status}")
        for k in ("price", "std_error"):
            check(k not in res or np.isfinite(res[k]), f"{what}: {k} finite")
        if kernel:
            expect[kernel] += n
        out["requests"][what] = dict(res, latency_ms=ms)
        return res

    def refused(what, body, needle):
        try:
            post(base, body, path="/api/rough")
            check(False, f"{what} must answer 400")
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())["detail"]
            check(e.code == 400 and needle in str(detail),
                  f"{what}: {e.code} {detail!r}")
            log(f"/api/rough {what}: 400 {detail!r}")

    def warm_latency(what, body, kernel):
        lat = []
        for _ in range(5):
            res = ask(f"warm {what}", body, kernel)
            lat.append(out["requests"][f"warm {what}"]["latency_ms"])
        out[f"warm_{what}_ms"] = statistics.median(lat)
        out[f"warm_{what}_server_ms"] = res["elapsed_ms"]
        log(f"warm /api/rough {what}: median {statistics.median(lat):.2f} ms "
            f"over 5 ({[round(x, 2) for x in lat]}); server-side "
            f"elapsed_ms {res['elapsed_ms']}")

    try:
        # ── price: exact sampler at 128 steps, K10 at 512 ───────────────
        ex = ask("price 128 steps (exact)", common)
        li = ask("price 512 steps (K10)", lift, "rbergomi_lift_integrals")
        check(ex["estimator"] == "conditional-black"
              and li["estimator"] == "conditional-black+lift-cuda",
              f"estimators {ex['estimator']}, {li['estimator']}")
        check(ex["num_paths_used"] == ROUGH_PAIRS and li["num_steps"] == 512,
              "/api/rough at the schema's width")
        p = rough.RoughBergomiParams(xi=0.04, eta=1.9, rho=-0.9, r=R, q=Q,
                                     hurst=ROUGH_H)
        t0 = time.perf_counter()
        exact512 = rough_engine.RoughBergomiEngine(
            p, num_paths=ROUGH_PAIRS, num_steps=512, sampler="exact",
            device=device).price(
            SPOT, SPOT, ROUGH_T)
        exact512_s = time.perf_counter() - t0
        joint = float(np.hypot(li["std_error"], exact512["std_error"]))
        tol = max(5 * joint, 0.02 * exact512["price"])
        log(f"/api/rough price: exact 128 steps {ex['price']:.4f} ± "
            f"{ex['std_error']:.4f}; K10 512 steps {li['price']:.4f} ± "
            f"{li['std_error']:.4f} vs the exact sampler at 512 steps in "
            f"process {exact512['price']:.4f} ± {exact512['std_error']:.4f} "
            f"(tol {tol:.4f}; the exact 512-step price took "
            f"{exact512_s * 1e3:.1f} ms)")
        check(abs(li["price"] - exact512["price"]) < tol,
              "K10 lift price vs the exact sampler at 512 steps")
        out["exact_512"] = dict(exact512, wall_ms=exact512_s * 1e3)

        # ── the Black-Scholes limit: eta = 0, rho = 0 ───────────────────
        bs = bs64(SPOT, SPOT, ROUGH_T, R, Q, 0.2)
        for what, body, kernel in (
                ("exact", common, None),
                ("K10", lift, "rbergomi_lift_integrals")):
            res = ask(f"BS limit {what}", dict(body, eta=0.0, rho=0.0),
                      kernel)
            rel = abs(res["price"] / bs - 1.0)
            log(f"/api/rough eta = rho = 0 ({what}): {res['price']:.6f} vs "
                f"Black-Scholes {bs:.6f} (rel {rel:.2e}, limit 1e-4)")
            check(rel < 1e-4, f"BS limit on the {what} sampler")

        # ── smile and skew at 512 steps (K10 once each) ─────────────────
        sm = ask("smile 512", dict(lift, mode="smile"),
                 "rbergomi_lift_integrals")
        ivs = sm["implied_vols"]
        check(len(ivs) == 13 and all(v is not None and 0.05 < v < 1.0
                                     for v in ivs), f"smile ivs {ivs}")
        check(ivs[0] > ivs[6] > ivs[-1], "rough smile skewed down")
        sk = ask("skew 512", dict(lift, mode="skew"),
                 "rbergomi_lift_integrals")
        check(sk["skew"] < 0, f"ATM skew {sk}")
        log(f"/api/rough smile 512: ivs {[round(v, 4) for v in ivs]}; skew "
            f"{sk['skew']:.4f}, atm vol {sk['atm_vol']:.4f}")

        # ── exotics at 512 steps (K11 once each) ────────────────────────
        asian = ask("asian 512", dict(lift, mode="asian"),
                    "rbergomi_lift_stats")
        up = 1.1 * SPOT
        ko = ask("barrier out 512", dict(lift, mode="barrier", barrier=up),
                 "rbergomi_lift_stats")
        ki = ask("barrier in 512", dict(lift, mode="barrier", barrier=up,
                                        knock="in"), "rbergomi_lift_stats")
        lb = ask("lookback 512", dict(lift, mode="lookback"),
                 "rbergomi_lift_stats")
        gap = abs(ko["price"] + ki["price"] - li["price"])
        tol = 4 * (ko["std_error"] + ki["std_error"] + li["std_error"])
        log(f"/api/rough 512 steps: asian {asian['price']:.4f}, up-and-out "
            f"{ko['price']:.4f} + up-and-in {ki['price']:.4f} vs the vanilla "
            f"{li['price']:.4f} (gap {gap:.4f}, tol {tol:.4f}); hit fraction "
            f"{ko['hit_fraction']:.4f}; lookback {lb['price']:.4f}")
        check(gap < tol, "barrier in + out vs the vanilla")
        check(0 < asian["price"] < li["price"], "asian below the vanilla")
        # At eta = 0 the variance is flat: K11's statistics against the
        # port's ExoticEngine under GBM(sqrt(xi)) on the same 512-step grid
        # (its twin, control variate off, so no other kernel runs here).
        gbm = ExoticEngine(gbm_params(0.2, R, Q), num_paths=ROUGH_PAIRS,
                           num_steps=int(512 / ROUGH_T), seed=11,
                           use_control_variate=False, backend="torch",
                           device=device)
        flat = dict(lift, eta=0.0)
        for what, body, ref in (
                ("asian", dict(flat, mode="asian"),
                 gbm.price_asian(SPOT, SPOT, ROUGH_T)),
                ("barrier", dict(flat, mode="barrier", barrier=up),
                 gbm.price_barrier(SPOT, SPOT, ROUGH_T, up)),
                ("lookback", dict(flat, mode="lookback"),
                 gbm.price_lookback(SPOT, ROUGH_T))):
            res = ask(f"{what} eta = 0", body, "rbergomi_lift_stats")
            joint = float(np.hypot(res["std_error"], ref["std_error"]))
            log(f"/api/rough {what} at eta = 0: {res['price']:.4f} ± "
                f"{res['std_error']:.4f} vs ExoticEngine GBM "
                f"{ref['price']:.4f} ± {ref['std_error']:.4f} (4 joint se = "
                f"{4 * joint:.4f}; {ref['num_steps']} steps)")
            check(ref["num_steps"] == 512, "ExoticEngine on the same grid")
            check(abs(res["price"] - ref["price"]) < 4 * joint,
                  f"{what} at eta = 0 vs ExoticEngine")

        # ── greeks against a CRN bump-and-reprice ───────────────────────
        h = 0.01 * SPOT
        for steps in (128, 512):
            body = dict(common, num_steps=steps, mode="greeks")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            g = ask(f"greeks {steps}", body)
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            # The same twin on the same generator seed (the engine's
            # common random numbers); at 512 steps that is the lift twin,
            # not K10, whose stream is Philox.
            eng = rough_engine.RoughBergomiEngine(
                p, num_paths=ROUGH_PAIRS, num_steps=steps, backend="torch",
                device=device)
            pr = [eng.price(SPOT + k * h, SPOT, ROUGH_T)["price"]
                  for k in (-1, 0, 1)]
            delta = (pr[2] - pr[0]) / (2 * h)
            gamma = (pr[2] - 2 * pr[1] + pr[0]) / h**2
            log(f"/api/rough greeks {steps} steps: delta {g['delta']:.6f} "
                f"vs bump {delta:.6f}, gamma {g['gamma']:.4e} vs bump "
                f"{gamma:.4e}; price {g['price']:.4f} vs {pr[1]:.4f}; "
                f"{out['requests'][f'greeks {steps}']['latency_ms']:.1f} ms, "
                f"peak device memory {peak:.2f} GiB; vega_xi "
                f"{g['vega_xi']:.2f}, d_eta {g['d_eta']:.3f}, d_rho "
                f"{g['d_rho']:.3f}, rho_rate {g['rho_rate']:.2f}")
            check(abs(g["delta"] - delta) < 3e-3, f"delta at {steps} steps")
            check(abs(g["gamma"] / gamma - 1.0) < 0.03,
                  f"gamma at {steps} steps")
            check(all(np.isfinite(g[k]) for k in (
                "vega_xi", "d_eta", "d_rho", "rho_rate")), "greeks finite")
            out[f"greeks_{steps}"] = {"peak_gib": peak, "bump_delta": delta,
                                      "bump_gamma": gamma}

        # ── RQMC against the PRNG price ─────────────────────────────────
        qmc = ask("price sobol", dict(common, use_sobol=True))
        joint = float(np.hypot(qmc["std_error"], ex["std_error"]))
        log(f"/api/rough use_sobol: {qmc['price']:.4f} ± "
            f"{qmc['std_error']:.4f} ({qmc['estimator']}) vs PRNG "
            f"{ex['price']:.4f} ± {ex['std_error']:.4f}")
        check(qmc["estimator"] == "conditional-black+rqmc"
              and abs(qmc["price"] - ex["price"]) < 4 * joint,
              "RQMC vs PRNG within their bars")

        # ── a tiny calibration: 2 maturities x 3 strikes, 2 Hurst points ─
        mats = [0.1, 0.5]
        ks = [[SPOT * m for m in (0.95, 1.0, 1.05)] for _ in mats]
        truth = rough_engine.RoughBergomiEngine(p, num_steps=32, seed=99,
                                                device=device)
        market = [truth.price(SPOT, k, t)["price"] for t, k in zip(mats, ks)]
        res = ask("calibrate", dict(spot=SPOT, T=0.5, mode="calibrate",
                                    num_paths=16_384, num_steps=32,
                                    maturities=mats, cal_strikes=ks,
                                    market_prices=market,
                                    hurst_grid=[ROUGH_H, 0.3]))
        fit = res["params"]
        log(f"/api/rough calibrate: {fit}, rmse {res['rmse_price']:.4f} in "
            f"{res['elapsed_ms']:.0f} ms; per H "
            f"{ {k: round(v['objective'], 4) for k, v in res['hurst_grid'].items()} }")
        check(fit["hurst"] == ROUGH_H and abs(fit["eta"] - 1.9) < 0.5
              and abs(fit["rho"] + 0.9) < 0.15
              and abs(fit["xi"] - 0.04) < 0.006,
              f"calibrate recovers (H, eta, rho, xi): {fit}")

        # ── the 400s ────────────────────────────────────────────────────
        refused("moneyness grid > 256",
                dict(common, mode="smile", moneyness=[1.0] * 257), "> 256")
        refused("barrier <= 0", dict(common, mode="barrier"), "barrier > 0")
        refused("calibrate without a grid", dict(common, mode="calibrate"),
                "needs maturities")
        refused("calibrate shapes", dict(common, mode="calibrate",
                                         maturities=[0.1, 0.5],
                                         cal_strikes=[[SPOT]],
                                         market_prices=[[1.0], [2.0]]),
                "must be (m, k)")
        refused("calibration grid too large",
                dict(common, mode="calibrate", maturities=[0.5],
                     cal_strikes=[[SPOT] * 2049],
                     market_prices=[[1.0] * 2049]), "too large")
        refused("unknown mode", dict(common, mode="american"), "unknown mode")

        warm_latency("price 128", common, None)
        warm_latency("price 512", lift, "rbergomi_lift_integrals")
        warm_latency("asian 512", dict(lift, mode="asian"),
                     "rbergomi_lift_stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    counts = ck.launch_counts()
    log(f"launch counts over the rough path: {counts} (expected {expect})")
    for name, n in counts.items():
        check(n == expect.get(name, 0), f"{name} launched {n} times, "
              f"expected {expect.get(name, 0)}")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"rough path: {out['wall_s']:.1f} s")
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Slice F: /api/greeks and /api/smile
# ─────────────────────────────────────────────────────────────────────────────
GREEKS_PATHS = 200_000    # GreeksRequest default
SMILE_PATHS = 50_000      # SmileRequest default
TERM_MATS = (0.1, 0.25, 0.5)
GREEK_KEYS = (("delta", "pathwise", "delta"),
              ("vega", "vega_per_vol_point", "vega"),
              ("gamma", "gamma", "gamma"),
              ("theta", "theta_daily", "theta"),
              ("rho", "rho", "rho"))


def all_finite(obj) -> bool:
    if isinstance(obj, dict):
        return all(all_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(all_finite(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return bool(np.isfinite(obj))
    return True


def gbm_raw_greeks(device, greeks, gbm, steps, seeds=8):
    """The degenerate GBM model's raw pathwise Greeks (control variate
    off) at the request's width, one row per seed: delta, ∂P/∂σ, gamma (a
    CRN central difference of the AD delta), theta = −∂P/∂T and rho."""
    kw = dict(num_paths=GREEKS_PATHS, num_steps=steps, is_call=True,
              control_variate=False)
    rows, b = [], 0.01
    for seed in range(seeds):
        gen = torch.Generator(device=device)
        gen.manual_seed(9000 + seed)
        draws = (torch.randn((steps, 3, GREEKS_PATHS), generator=gen,
                             device=device),
                 torch.rand((steps, GREEKS_PATHS), generator=gen,
                            device=device))
        _, d_s, d_T, d_p = greeks.price_and_greeks(gbm, SPOT, STRIKE,
                                                   T_DEFAULT, draws, **kw)
        d_up, d_dn = (greeks.price_and_greeks(gbm, SPOT * f, STRIKE,
                                              T_DEFAULT, draws, **kw)[1]
                      for f in (1 + b, 1 - b))
        rows.append([float(d_s), float(d_p.v0) * 2 * GBM_SIGMA,
                     float(d_up - d_dn) / (2 * SPOT * b), -float(d_T),
                     float(d_p.r)])
    return np.asarray(rows)


def greeks_card_vs_cpu(device, greeks, SVJParams, paths=8192):
    """The Greeks engine's device programs on the card against the CPU's on
    the same draws (the default model, T = 0.25): every output of
    `_all_greeks_device` and the (∂P/∂S, ∂P/∂v₀) arrays of
    `_ad_delta_vega_batch` at the second-order block's 12 (spot, v₀, T)
    points, rtol 1e-4 beside an atol of 1e-5 × the output's largest
    |value|. Every key of the blocks is float64 host arithmetic on these
    outputs, the same code on both devices. Its central differences cancel
    digits: at this point veta's over T ± 1/252 keeps fewer of float32's
    than rtol 1e-4 asks (card and CPU differed by 7.9 times that
    tolerance there), so the keys themselves are held on the card where
    they keep them (`tests/test_torch_cuda.py`). Returns the worst
    |card − CPU| over its tolerance and the output it was found at."""
    gen = torch.Generator().manual_seed(4)
    draws = (torch.randn((STEPS_DEFAULT, 3, paths), generator=gen),
             torch.rand((STEPS_DEFAULT, paths), generator=gen))
    p = SVJParams()
    kw = dict(num_paths=paths, num_steps=STEPS_DEFAULT, is_call=True)
    v0, ht = p.v0, 1 / 252
    v_up, v_dn = v0 * 1.02**2, v0 * 0.98**2
    s_up, s_dn = SPOT * 1.01, SPOT * 0.99
    pts = [(s_up, v0, T_DEFAULT), (s_dn, v0, T_DEFAULT),
           (SPOT, v0, T_DEFAULT + ht), (SPOT, v0, T_DEFAULT - ht),
           (s_up, v_up, T_DEFAULT), (s_dn, v_up, T_DEFAULT),
           (s_up, v_dn, T_DEFAULT), (s_dn, v_dn, T_DEFAULT),
           (s_up, v0, T_DEFAULT + ht), (s_dn, v0, T_DEFAULT + ht),
           (s_up, v0, T_DEFAULT - ht), (s_dn, v0, T_DEFAULT - ht)]
    out = {}
    for dev in (device, torch.device("cpu")):
        d = tuple(x.to(dev) for x in draws)
        res = greeks._all_greeks_device(p, SPOT, STRIKE, T_DEFAULT, d,
                                        with_lr=True, **kw)
        res["batch_d_spot"], res["batch_d_v0"] = greeks._ad_delta_vega_batch(
            p, *([x[i] for x in pts] for i in (0, 1)), STRIKE,
            [x[2] for x in pts], d, **kw)
        out[dev.type] = {k: v.detach().cpu().double().numpy()
                         for k, v in res.items()}
    worst, where = 0.0, None
    for k, ref in out["cpu"].items():
        tol = 1e-4 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        share = float(np.max(np.abs(out["cuda"][k] - ref) / tol))
        if share >= worst:
            worst, where = share, k
    return worst, where


def greeks_path(device, ck, server, greeks, bs_all_greeks, cos_price,
                SVJParams, TermStructureSVJ, price_term_structure):
    """POST /api/greeks and /api/smile over HTTP on a fresh server, and
    `price_term_structure` in process, with the launch counts set to 0
    just before: K1 once per `mc` smile (and per in-process Sobol batch),
    K3 once per maturity, no other kernel (the Greeks ride the twins)."""
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    common = {"spot": SPOT, "strike": STRIKE, "T": T_DEFAULT}
    expect = {"svj_terminal_from_draws": 0, "svj_terminal": 0}
    out = {"requests": {}}
    steps = STEPS_DEFAULT

    def ask(what, body, path="/api/greeks", k1=0):
        n0 = ck.launch_counts()["svj_terminal_from_draws"]
        status, res, ms = post(base, body, path=path)
        check(status == 200, f"{what}: status {status}")
        check(all_finite(res), f"{what}: every number finite")
        n = ck.launch_counts()["svj_terminal_from_draws"] - n0
        check(n == k1, f"{what}: K1 launched {n} times, expected {k1}")
        expect["svj_terminal_from_draws"] += k1
        out["requests"][what] = {
            "latency_ms": ms, "elapsed_ms": res.get("elapsed_ms"),
            **({k: v for k, v in res.items() if k != "density"}
               if path == "/api/greeks" or "smile" in res else {})}
        return res, ms

    def refused(what, body, needle, path="/api/greeks"):
        try:
            post(base, body, path=path)
            check(False, f"{what} must answer 400")
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())["detail"]
            check(e.code == 400 and needle in str(detail),
                  f"{what}: {e.code} {detail!r}")
            log(f"{path} {what}: 400 {detail!r}")

    def warm(what, body, path, k1=0):
        lat = [ask(f"warm {what}", body, path, k1)[1] for _ in range(5)]
        out[f"warm_{what}_ms"] = statistics.median(lat)
        log(f"warm {path} {what}: median {statistics.median(lat):.2f} ms "
            f"over 5 ({[round(x, 2) for x in lat]})")

    try:
        # ── GBM-degenerate default request against Black-Scholes ─────────
        gbm = dict(common, params=GBM_FIELDS)
        res, ms = ask("GBM default", gbm)
        check(res["delta"].keys() >= {"pathwise", "finite_diff"}
              and res.keys() >= {"vega", "gamma", "theta", "rho", "jumps",
                                 "model"}, "all_greeks blocks")
        gbm_p = SVJParams(**GBM_FIELDS, r=R, q=Q)
        t0 = time.perf_counter()
        raw = gbm_raw_greeks(device, greeks, gbm_p, steps)
        ref = bs_all_greeks(SPOT, STRIKE, T_DEFAULT, R, Q, GBM_SIGMA, True)
        bs = np.array([float(ref[k]) for _, _, k in GREEK_KEYS])
        se = raw.std(0, ddof=1)
        got = np.array([res[b][k] for b, k, _ in GREEK_KEYS])
        mean_se = se / np.sqrt(raw.shape[0])
        out["gbm"] = {"bs": bs.tolist(), "response": got.tolist(),
                      "raw_mean": raw.mean(0).tolist(), "raw_se": se.tolist(),
                      "seeds_s": time.perf_counter() - t0}
        log(f"GBM /api/greeks (first request {ms:.0f} ms): "
            + ", ".join(f"{k} {g:.6g} vs BS {b:.6g} (5 se {5 * e:.3g})"
                        for (_, _, k), g, b, e in zip(GREEK_KEYS, got, bs,
                                                      se)))
        check(bool((np.abs(got - bs) < 5 * se).all()),
              "GBM /api/greeks within 5 se of bs_all_greeks")
        check(bool((np.abs(raw.mean(0) - bs) < 5 * mean_se).all()),
              f"raw GBM Greeks over {raw.shape[0]} seeds within 5 se of BS "
              f"({raw.mean(0)} vs {bs}, se {mean_se})")

        # ── the SVJ default: AD against the CRN cross-checks ─────────────
        svj, _ = ask("SVJ default", common)
        log(f"SVJ /api/greeks: delta {svj['delta']['pathwise']:.5f} (FD "
            f"{svj['delta']['finite_diff']:.5f}, {svj['delta']['diff_pct']:.2f}"
            f" %), dP/dv0 {svj['vega']['ad_vega_v0']:.2f} (FD "
            f"{svj['vega']['fd_vega_v0']:.2f}, {svj['vega']['diff_pct']:.2f} "
            f"%), lambda FD {svj['jumps']['lambda_j']:.2f}, LR "
            f"{svj['jumps']['lambda_j_lr']:.2f} ± "
            f"{svj['jumps']['lambda_j_lr_se']:.2f}")
        check(svj["delta"]["diff_pct"] < 3.0, "SVJ AD delta vs its FD")
        check(svj["vega"]["diff_pct"] < 10.0, "SVJ AD vega vs its FD")
        t0 = time.perf_counter()
        worst, where = greeks_card_vs_cpu(device, greeks, SVJParams)
        out["card_vs_cpu_worst_share_of_tol"] = worst
        log(f"Greeks programs card vs CPU on shared draws (8192 paths x "
            f"{STEPS_DEFAULT} steps, every output of _all_greeks_device and "
            f"the 12-point _ad_delta_vega_batch): worst |card - CPU| / tol "
            f"= {worst:.4f} at {where} ({time.perf_counter() - t0:.1f} s)")
        check(worst < 1.0, "the card's Greeks programs equal the CPU's")

        # ── every block and mode ─────────────────────────────────────────
        cross, _ = ask("with_cross", dict(common, with_cross=True))
        check(cross["cross"].keys() == {"vanna", "vanna_cross_check",
                                        "volga", "vanna_v0"}, "cross keys")
        for T, tag in ((T_DEFAULT, ""), (1.0, "_T1")):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            so, ms = ask(f"with_second_order T={T}", dict(
                common, T=T, with_second_order=True))
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            out[f"second_order{tag}_peak_gib"] = peak
            out[f"second_order{tag}_ms"] = ms
            log(f"/api/greeks with_second_order at T = {T} "
                f"({int(252 * T)} steps, {GREEKS_PATHS} paths): {ms:.0f} ms,"
                f" peak device memory {peak:.3f} GiB (all allocations of "
                f"the process, the server's caches included)")
            check(abs(so["second_order"]["gamma_check"]
                      - so["gamma"]["gamma"])
                  <= 1e-3 * abs(so["gamma"]["gamma"]),
                  "second-order gamma_check equals the gamma block")
        mv, _ = ask("with_min_variance", dict(common, with_min_variance=True))
        m = mv["min_variance"]
        check(abs(m["mv_delta"] - m["delta"] - m["adjustment"])
              <= 1e-9 * abs(m["delta"]), "mv_delta = delta + adjustment")
        chain, _ = ask("chain", dict(common, strike=0.0, strikes=[
            SPOT * 0.95, SPOT, SPOT * 1.05]))
        check(len(chain["chain"]) == 3, "chain rows")
        for blk, key in (("delta", "pathwise"), ("vega", "ad_vega_v0"),
                         ("gamma", "gamma")):
            a, b = chain["chain"][1][blk][key], svj[blk][key]
            check(abs(a - b) <= 1e-5 * abs(b),
                  f"chain ATM {blk} equals the single contract's")
        cash, _ = ask("cash dividends", dict(
            common, with_cross=True,
            dividends=[{"t": 0.1, "amount": 150.0}]))
        check(cash["dividends"]["model"] == "escrowed", "escrowed model")
        prop, _ = ask("proportional dividends", dict(
            common, dividend_kind="proportional",
            dividends=[{"t": 0.1, "amount": 0.01}]))
        check(prop["dividends"]["model"] == "proportional-exact",
              "proportional model")
        check(prop["delta"]["pathwise"] < svj["delta"]["pathwise"],
              "a dividend lowers the call's delta")
        refused("chain with_cross", dict(common, strikes=[SPOT],
                                         with_cross=True), "chain mode")
        refused("strike <= 0", dict(common, strike=0.0), "strike > 0")

        # ── /api/smile: mc on K1, cos with the density ───────────────────
        smile_body = {"spot": SPOT, "T": T_DEFAULT}
        mc, ms = ask("smile mc", smile_body, "/api/smile", k1=1)
        strikes = [row["strike"] for row in mc["smile"]]
        eng = server.MonteCarloEngine(SVJParams(), num_paths=SMILE_PATHS,
                                      device=device)
        rows = eng.price_batch(SPOT, strikes, T_DEFAULT)
        expect["svj_terminal_from_draws"] += 1
        exact = cos_price(SVJParams(), SPOT, strikes, T_DEFAULT, True)
        worst = 0.0
        for row, r, c in zip(mc["smile"], rows, exact):
            check(row["price"] == r["price"], "smile mc = price_batch")
            tol = 4 * r["std_error"] + 0.01 * c
            worst = max(worst, abs(row["price"] - c) / tol)
        out["smile_mc_vs_cos_worst_share_of_tol"] = worst
        log(f"/api/smile mc ({len(strikes)} strikes, {SMILE_PATHS} paths, "
            f"one K1 launch): worst |mc - COS| / (4 se + 1 %) = {worst:.3f}")
        check(worst < 1.0, "smile mc against COS")
        cos, _ = ask("smile cos", dict(smile_body, method="cos",
                                       with_density=True), "/api/smile")
        dens = cos["density"]
        s_grid, pdf = np.asarray(dens["s"]), np.asarray(dens["pdf"])
        mass = float(np.sum(np.diff(s_grid) * (pdf[1:] + pdf[:-1]) / 2))
        out["density_mass"] = mass
        log(f"/api/smile cos + density: {len(dens['s'])} points, mass "
            f"{mass:.5f}, forward {dens['forward']:.2f}")
        check(0.98 < mass < 1.001, "COS density integrates to 1")
        check(all(0.0 < row["iv"] < 5.0 for row in cos["smile"]),
              "COS smile: every strike has an implied vol")

        # ── price_term_structure: one K3 launch per maturity ─────────────
        ts = TermStructureSVJ(theta_curve={0.1: 0.04, 0.5: 0.06},
                              xi_curve={0.1: 0.6, 0.5: 0.4},
                              lambda_curve={0.1: 2.0, 0.5: 1.0})
        k3 = ck.launch_counts()["svj_terminal"]
        t0 = time.perf_counter()
        grid = price_term_structure(ts, SPOT, [SPOT * 0.9, SPOT, SPOT * 1.1],
                                    TERM_MATS, device=device)
        out["term_structure_ms"] = (time.perf_counter() - t0) * 1e3
        n3 = ck.launch_counts()["svj_terminal"] - k3
        check(n3 == len(TERM_MATS), f"K3 launched {n3} times for "
              f"{len(TERM_MATS)} maturities")
        expect["svj_terminal"] += len(TERM_MATS)
        worst = 0.0
        for sl in grid:
            p_t = ts.get_params_at_maturity(sl["maturity"])
            exact = cos_price(p_t, SPOT, [r["strike"] for r in sl["chain"]],
                              sl["maturity"], True)
            for r, c in zip(sl["chain"], exact):
                worst = max(worst, abs(r["price"] - c)
                            / (4 * r["std_error"] + 0.01 * c))
        out["term_structure_worst_share_of_tol"] = worst
        log(f"price_term_structure ({len(TERM_MATS)} maturities x 3 strikes,"
            f" {n3} K3 launches, {out['term_structure_ms']:.1f} ms): worst "
            f"|MC - COS| / (4 se + 1 %) = {worst:.3f}")
        check(worst < 1.0, "price_term_structure against COS")

        warm("greeks", common, "/api/greeks")
        warm("smile mc", smile_body, "/api/smile", k1=1)
        warm("smile cos", dict(smile_body, method="cos"), "/api/smile")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    counts = ck.launch_counts()
    log(f"launch counts over the greeks/smile path: {counts} (expected "
        f"{expect})")
    for name, n in counts.items():
        check(n == expect.get(name, 0), f"{name} launched {n} times, "
              f"expected {expect.get(name, 0)}")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"greeks/smile path: {out['wall_s']:.1f} s")
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Slice G: the risk desk (/api/stress, /api/regime, /api/hedge, /api/var)
# ─────────────────────────────────────────────────────────────────────────────
STRESS_PATHS = 100_000    # StressRequest default
HEDGE_SCEN = 500          # HedgeRequest default
VAR_PATHS = 500_000       # VarRequest default
# The normal oracle of tests/test_risk_regime_guards.py: at T = 0.05 the
# book's returns are nearly jointly normal, where componentᵢ/risk =
# wᵢ(Σw)ᵢ / wᵀΣw for VaR and CVaR alike.
ORACLE_BOOK = {"spots": [100.0, 100.0, 100.0], "sigmas": [0.2, 0.35, 0.15],
               "weights": [0.4, 0.35, 0.25],
               "corr": [[1.0, 0.5, 0.1], [0.5, 1.0, 0.3], [0.1, 0.3, 1.0]],
               "T": 0.05}
# tests/test_mv_delta.py's world (ρ = −0.8, no jumps) and
# tests/test_risk_regime_guards.py's jump world (λ = 3 a year).
MV_FIELDS = {"kappa": 2.0, "theta": 0.04, "xi": 0.6, "rho": -0.8,
             "v0": 0.04, "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.0}
JUMP_FIELDS = {"kappa": 3.0, "theta": 0.04, "xi": 0.4, "rho": -0.6,
               "v0": 0.04, "lambda_j": 3.0, "mu_j": -0.06, "sigma_j": 0.08}


def equicorr(n: int, rho: float) -> list:
    return [[1.0 if i == j else rho for j in range(n)] for i in range(n)]


def risk_path(device, ck, server, risk, regime, cos_price, bs_price,
              SVJParams):
    """POST /api/stress, /api/regime, /api/hedge and /api/var over HTTP on a
    fresh server, with the launch counts set to 0 just before: K3 once for
    a report's spot axis and once a shocked vol member, once a matrix vol
    row, once a gbm/svj hedge's premium (and once for each in-process price
    that reads a request's standard error and each in-process pin of K3
    against its plain version), no other kernel."""
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    common = {"spot": SPOT, "strike": STRIKE, "T": T_DEFAULT}
    k3 = {"requests": 0, "in_process": 0}
    out = {"requests": {}}

    def k3_now():
        return ck.launch_counts()["svj_terminal"]

    def ask(what, body, path, n3=0):
        before = k3_now()
        status, res, ms = post(base, body, path=path)
        check(status == 200, f"{what}: status {status}")
        # A hedge's Hill tail index is NaN by the reference's contract when
        # the P&L has 20 losses or fewer (risk.py:89); every other number
        # must be finite.
        rm = res.get("risk_metrics", {})
        check(all_finite(dict(res, risk_metrics={
            k: v for k, v in rm.items() if k != "tail_index"})),
            f"{what}: every number finite")
        n = k3_now() - before
        check(n == n3, f"{what}: K3 launched {n} times, expected {n3}")
        k3["requests"] += n3
        out["requests"][what] = {"latency_ms": ms,
                                 "elapsed_ms": res.get("elapsed_ms")}
        return res, ms

    def in_process(n3, fn, *a, **kw):
        before = k3_now()
        res = fn(*a, **kw)
        n = k3_now() - before
        check(n == n3, f"in-process {fn.__name__}: K3 launched {n} times, "
              f"expected {n3}")
        k3["in_process"] += n3
        return res

    def pin_k3(what, params, num_paths, steps, seed):
        """K3 at a launch's own shape and seed on this path against its
        plain version: S, v and G bit for bit, as check_prng holds it."""
        kw = dict(num_paths=num_paths, num_steps=steps, antithetic=True,
                  companion=True, device=device)
        ker = in_process(1, ck.svj_terminal, params, SPOT, T_DEFAULT, seed,
                         **kw)
        torch.cuda.synchronize()
        ref = ck.svj_terminal_plain(params, SPOT, T_DEFAULT, seed, **kw)
        torch.cuda.synchronize()
        err, _ = compare_family(f"K3 {what} ({num_paths} pairs x {steps} "
                                f"steps)", ker, ref, ("S", "v", "G"),
                                bit_for_bit=True)
        out.setdefault("k3_pins", {})[what] = err

    def refused(what, body, path, needle):
        try:
            post(base, body, path=path)
            check(False, f"{what} must answer 400")
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())["detail"]
            check(e.code == 400 and needle in str(detail),
                  f"{what}: {e.code} {detail!r}")
            log(f"{path} {what}: 400 {detail!r}")

    def warm(what, body, path, n3=0):
        lat = [ask(f"warm {what}", body, path, n3)[1] for _ in range(5)]
        out[f"warm_{what}_ms"] = statistics.median(lat)
        log(f"warm {path} {what}: median {statistics.median(lat):.2f} ms "
            f"over 5 ({[round(x, 2) for x in lat]})")

    try:
        # ── /api/stress report: SVJ against COS ──────────────────────────
        # The report's base member is its spot axis's unshocked price.
        n_report = 1 + len(risk.VOL_SHOCKS)
        stress = dict(common)
        rep, ms = ask("stress report", stress, "/api/stress", n_report)
        p = SVJParams()
        eng = risk.StressTestEngine(p, num_paths=STRESS_PATHS, device=device)
        steps = eng._steps(T_DEFAULT)
        members, v0s = eng._vol_members()
        pin_k3("stress base member", members[0], STRESS_PATHS, steps,
               eng.seed)
        pin_k3("stress vol member +5", members[-1], STRESS_PATHS, steps,
               eng.seed)
        gap = risk.JUMP_SCENARIO_SIZE
        shocks = np.concatenate([[0.0], risk.SPOT_SHOCKS, [-gap, gap]])
        rel, res = in_process(1, eng._shock_prices_device, SPOT, STRIKE,
                              T_DEFAULT, True, shocks)
        host = {k: res[k].cpu().double().numpy() for k in ("price",
                                                           "std_error")}
        price, se = host["price"] * rel, host["std_error"] * rel
        got = ([rep["jump_scenario"]["base_price"]]
               + [r["price"] for r in rep["spot_shocks"]]
               + [rep["jump_scenario"]["gap_down_price"],
                  rep["jump_scenario"]["gap_up_price"]])
        check(np.allclose(got, price, rtol=1e-6, atol=0),
              "the report's spot axis is the in-process K3 result")
        exact = np.array([cos_price(p, SPOT * r, [STRIKE], T_DEFAULT,
                                    True)[0] for r in rel])
        share = np.abs(price - exact) / (4 * se + 0.01 * exact)
        vol_share = []
        for m, row in zip(members[1:], rep["vol_shocks"]):
            r = in_process(1, eng._engine(m)._price_result, SPOT, [STRIKE],
                           T_DEFAULT, True)
            c = cos_price(m, SPOT, [STRIKE], T_DEFAULT, True)[0]
            check(abs(row["price"] - float(r["price"][0]))
                  <= 1e-6 * row["price"], "vol row is the in-process K3 "
                  "member")
            vol_share.append(abs(row["price"] - c)
                             / (4 * float(r["std_error"][0]) + 0.01 * c))
        out["stress_vs_cos_worst_share_of_tol"] = float(max(share.max(),
                                                           *vol_share))
        log(f"/api/stress report ({STRESS_PATHS} pairs x {STEPS_DEFAULT} "
            f"steps, {n_report} K3 launches, first request {ms:.1f} "
            f"ms): worst |MC - COS| / (4 se + 1 %) over 6 spot rows, 2 gap "
            f"rows and 2 vol rows = {out['stress_vs_cos_worst_share_of_tol']:.3f}")
        check(out["stress_vs_cos_worst_share_of_tol"] < 1.0,
              "stress report against COS")

        # ── degenerate GBM: every row against Black-Scholes ──────────────
        gbm_p = SVJParams(**GBM_FIELDS, r=R, q=Q)
        grep, _ = ask("stress report GBM", dict(stress, params=GBM_FIELDS),
                      "/api/stress", n_report)
        raw = in_process(1, server.MonteCarloEngine(
            gbm_p, num_paths=STRESS_PATHS, use_sobol=False,
            use_control_variate=False, device=device)._price_result,
            SPOT, (STRIKE / rel).astype(np.float32), T_DEFAULT, True)
        raw_p = raw["price"].cpu().double().numpy() * rel
        raw_se = raw["std_error"].cpu().double().numpy() * rel
        bs = np.array([float(bs_price(SPOT * r, STRIKE, T_DEFAULT, R, Q,
                                      GBM_SIGMA)) for r in rel])
        got = np.array([grep["jump_scenario"]["base_price"]]
                       + [r["price"] for r in grep["spot_shocks"]]
                       + [grep["jump_scenario"]["gap_down_price"],
                          grep["jump_scenario"]["gap_up_price"]])
        worst_raw = float(np.max(np.abs(raw_p - bs) / (3 * raw_se)))
        worst_cv = float(np.max(np.abs(got - bs)))
        vol_bs = []
        for row in grep["vol_shocks"]:
            sig = math.sqrt(row["v0"])
            m = gbm_p.replace(v0=row["v0"], theta=row["v0"])
            r = in_process(1, server.MonteCarloEngine(
                m, num_paths=STRESS_PATHS, use_sobol=False,
                use_control_variate=False, device=device)._price_result,
                SPOT, [STRIKE], T_DEFAULT, True)
            b = float(bs_price(SPOT, STRIKE, T_DEFAULT, R, Q, sig))
            vol_bs.append(abs(row["price"] - b))
            worst_raw = max(worst_raw, abs(float(r["price"][0]) - b)
                            / (3 * float(r["std_error"][0])))
        worst_cv = max(worst_cv, *vol_bs)
        out["stress_gbm"] = {"raw_worst_share_of_3se": worst_raw,
                             "cv_worst_abs": worst_cv}
        log(f"/api/stress report, degenerate GBM: the response (control "
            f"variate on, every row) within {worst_cv:.2e} of "
            f"Black-Scholes (limit 1e-5 x spot: float32 sums); the raw "
            f"estimates of the same paths within {worst_raw:.3f} of 3 se")
        check(worst_cv < 1e-5 * SPOT, "GBM stress rows equal Black-Scholes")
        check(worst_raw < 1.0, "GBM stress raw rows within 3 se of BS")

        # ── the scenario matrix at the default and at custom axes ────────
        for what, axes in (("default axes", {}),
                           ("custom axes", {"spot_shocks": [-0.3, -0.1, 0.15,
                                                            0.6],
                                            "vol_shocks": [-0.1, 0.05, 0.25,
                                                           0.8]})):
            rows = len(set(axes.get("vol_shocks", risk.VOL_SHOCKS)) | {0.0})
            mat, ms = ask(f"stress matrix {what}", dict(
                stress, mode="matrix", **axes), "/api/stress", rows)
            i0 = mat["vol_shocks_pts"].index(0.0)
            j0 = mat["spot_shocks_pct"].index(0.0)
            base_price = rep["jump_scenario"]["base_price"]
            check(abs(mat["prices"][i0][j0] - base_price)
                  <= 1e-6 * base_price,
                  f"matrix {what}: (0, 0) cell equals the report's base")
            if not axes:
                zero = dict(zip(mat["spot_shocks_pct"], mat["prices"][i0]))
                for r in rep["spot_shocks"]:
                    check(abs(zero[r["shock_pct"]] - r["price"])
                          <= 1e-6 * r["price"], "matrix zero-vol row equals "
                          "the report's spot rows")
            log(f"/api/stress matrix {what}: {len(mat['prices'])} x "
                f"{len(mat['prices'][0])} cells, {rows} K3 launches, "
                f"{ms:.1f} ms")
        refused("spot_shocks outside (-0.95, 4.0)", dict(
            stress, mode="matrix", spot_shocks=[0.1, 4.0]), "/api/stress",
            "spot_shocks")
        refused("vol_shocks beyond 1.0", dict(
            stress, mode="matrix", vol_shocks=[-1.5]), "/api/stress",
            "vol_shocks")

        # ── /api/hedge: every world x hedge the reference allows ─────────
        hedges = {}
        for dyn in ("gbm", "svj", "rough"):
            for hedge in (("bs_delta", "mv_delta", "ww_band")
                          if dyn != "rough" else ("bs_delta",)):
                res, ms = ask(f"hedge {dyn} {hedge}", dict(
                    common, dynamics=dyn, hedge=hedge), "/api/hedge",
                    0 if dyn == "rough" else 1)
                hedges[(dyn, hedge)] = res
                log(f"/api/hedge {dyn} {hedge} ({HEDGE_SCEN} scenarios, "
                    f"{STEPS_DEFAULT} days): mean P&L "
                    f"{res['mean_pnl']:.3f}, std {res['std_pnl']:.3f}, "
                    f"premium {res['premium']:.3f}, {ms:.1f} ms")
        refused("mv_delta in the rough world", dict(
            common, dynamics="rough", hedge="mv_delta"), "/api/hedge",
            "gbm/svj")
        refused("an unknown hedge", dict(common, hedge="gamma_neutral"),
                "/api/hedge", "unknown hedge")
        # Degenerate GBM at r = q = 0 (the backtest's cash earns no
        # interest, so at r > 0 its mean P&L carries (r - q)·T·Δ·S), zero
        # costs: S is a martingale and its log-Euler steps are exact, so
        # the mean P&L is the premium's error, centred on 0.
        gbm0 = dict(GBM_FIELDS, r=0.0, q=0.0)
        n_big = 20_000
        res, ms = ask("hedge GBM zero cost 20 000", dict(
            common, params=gbm0, num_scenarios=n_big, txn_cost_bps=0.0,
            slippage_bps=0.0), "/api/hedge", 1)
        prem_eng = server.MonteCarloEngine(
            SVJParams(**gbm0), num_paths=50_000, use_sobol=False,
            device=device)
        prem = in_process(1, prem_eng.price, SPOT, STRIKE, T_DEFAULT)
        # The premium's launch at the default SVJ parameters (the gbm/svj
        # hedges above): 50 000 pairs on the backtest's seed.
        hedge_eng = risk.HedgingBacktest(p, device=device)
        pin_k3("hedge premium", p, 50_000, prem_eng._steps(T_DEFAULT),
               hedge_eng.seed)
        tol = 3 * res["std_pnl"] / math.sqrt(n_big) + 3 * prem["std_error"]
        out["hedge_gbm_mean_pnl"] = {"mean": res["mean_pnl"], "tol": tol,
                                     "premium": res["premium"],
                                     "premium_se": prem["std_error"]}
        log(f"/api/hedge degenerate GBM, zero cost, {n_big} scenarios: mean "
            f"P&L {res['mean_pnl']:.4f} (limit {tol:.4f}: 3 std/sqrt(n) + "
            f"3 se of the premium), std {res['std_pnl']:.3f}, {ms:.1f} ms")
        check(abs(res["mean_pnl"]) <= tol, "GBM hedge mean P&L near 0")
        free = dict(common, txn_cost_bps=0.0, slippage_bps=0.0)
        for dyn in ("gbm", "svj"):
            a, _ = ask(f"hedge {dyn} bs_delta zero cost", dict(
                free, dynamics=dyn), "/api/hedge", 1)
            b, _ = ask(f"hedge {dyn} ww_band zero cost", dict(
                free, dynamics=dyn, hedge="ww_band"), "/api/hedge", 1)
            check(a["mean_pnl"] == b["mean_pnl"]
                  and a["std_pnl"] == b["std_pnl"],
                  f"{dyn}: ww_band at zero cost equals bs_delta")
        mv = {h: ask(f"hedge svj rho<0 {h}", dict(
            common, T=0.1, params=MV_FIELDS, dynamics="svj", hedge=h,
            num_scenarios=3000), "/api/hedge", 1)[0]
            for h in ("bs_delta", "mv_delta")}
        out["hedge_mv_std"] = {h: mv[h]["std_pnl"] for h in mv}
        log(f"/api/hedge svj world, rho = -0.8, 3000 scenarios: P&L std "
            f"bs_delta {mv['bs_delta']['std_pnl']:.3f}, mv_delta "
            f"{mv['mv_delta']['std_pnl']:.3f}")
        check(mv["mv_delta"]["std_pnl"] < 0.97 * mv["bs_delta"]["std_pnl"],
              "mv_delta cuts the P&L std in the svj world with rho < 0")
        tails = {d: ask(f"hedge jumps {d}", dict(
            common, T=0.1, params=JUMP_FIELDS, dynamics=d,
            num_scenarios=3000), "/api/hedge", 1)[0]
            for d in ("gbm", "svj")}
        out["hedge_tails"] = {d: {"std": tails[d]["std_pnl"],
                                  "p1": tails[d]["pnl_percentiles"]["1%"]}
                              for d in tails}
        log(f"/api/hedge jump world, 3000 scenarios: std gbm "
            f"{tails['gbm']['std_pnl']:.3f} / svj {tails['svj']['std_pnl']:.3f}"
            f", 1 % gbm {tails['gbm']['pnl_percentiles']['1%']:.3f} / svj "
            f"{tails['svj']['pnl_percentiles']['1%']:.3f}")
        check(tails["svj"]["std_pnl"] > tails["gbm"]["std_pnl"]
              and tails["svj"]["pnl_percentiles"]["1%"]
              < tails["gbm"]["pnl_percentiles"]["1%"],
              "the svj world's left tail is fatter than the gbm world's")

        # ── /api/var: Euler contributions, closed forms, the t-copula ────
        book = dict(ORACLE_BOOK)
        var, ms = ask("var gaussian", book, "/api/var")
        s, w = np.array(book["sigmas"]), np.array(book["weights"])
        cov = np.outer(s, s) * np.array(book["corr"]) * book["T"]
        pct = w * (cov @ w) / (w @ cov @ w) * 100
        d_cvar = np.abs(np.array(var["component_cvar_pct"]) - pct).max()
        d_var = np.abs(np.array(var["component_var_pct"]) - pct).max()
        out["var_oracle_pts"] = {"cvar": float(d_cvar), "var": float(d_var)}
        log(f"/api/var gaussian ({VAR_PATHS} paths, 3 assets, T = 0.05, "
            f"{ms:.1f} ms): VaR {var['var']:.5f}, CVaR {var['cvar']:.5f}; "
            f"components against the normal oracle within {d_cvar:.3f} "
            f"(CVaR) and {d_var:.3f} (VaR) percentage points")
        check(d_cvar <= 2.5 and d_var <= 4.0, "Euler components against "
              "the normal oracle")
        check(abs(sum(var["component_cvar"]) - var["cvar"])
              <= 1e-5 * var["cvar"], "sum of component CVaR = CVaR")
        check(abs(sum(var["component_var"]) - var["var"])
              <= 1e-5 * var["var"], "sum of component VaR = VaR")
        one, _ = ask("var one asset", {
            "spots": [100.0], "sigmas": [0.2], "weights": [1.0],
            "corr": [[1.0]], "T": 0.25, "with_contributions": False},
            "/api/var")
        z01 = statistics.NormalDist().inv_cdf(0.01)
        exact = -math.expm1((R - Q - 0.02) * 0.25 + 0.2 * 0.5 * z01)
        out["var_one_asset"] = {"mc": one["var"], "exact": exact}
        log(f"/api/var one asset, sigma 0.2, T = 0.25: VaR {one['var']:.5f} "
            f"against the lognormal quantile {exact:.5f}")
        check(abs(one["var"] - exact) <= 0.02 * exact,
              "one-asset VaR against the lognormal quantile")
        gauss, _ = ask("var gaussian, no contributions", dict(
            book, with_contributions=False), "/api/var")
        t3, ms3 = ask("var student_t nu=3", dict(book, copula="student_t",
                                                  nu=3.0), "/api/var")
        t300, _ = ask("var student_t nu=300", dict(
            book, copula="student_t", nu=300.0), "/api/var")
        log(f"/api/var t-copula: VaR nu=3 {t3['var']:.5f} ({ms3:.1f} ms), "
            f"nu=300 {t300['var']:.5f}, Gaussian {gauss['var']:.5f}")
        check(t3["var"] > gauss["var"], "t-copula nu=3 VaR above Gaussian")
        check(abs(t300["var"] - gauss["var"]) <= 0.02 * gauss["var"],
              "t-copula nu=300 VaR within 2 % of Gaussian")
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        s_t = risk.multi_asset_t_copula_terminal(
            book["spots"], book["sigmas"], book["corr"], R, Q, book["T"],
            gen, num_paths=VAR_PATHS, nu=4.0, device=device)
        lr = torch.log(s_t / torch.tensor(book["spots"], device=device))
        lr = lr.double().cpu().numpy()
        worst = 0.0
        for i, sig in enumerate(book["sigmas"]):
            sd = sig * math.sqrt(book["T"])
            mu = (R - Q - 0.5 * sig * sig) * book["T"]
            worst = max(worst,
                        abs(lr[:, i].mean() - mu) / (sd / math.sqrt(VAR_PATHS)),
                        abs(lr[:, i].std() - sd)
                        / (sd / math.sqrt(2 * VAR_PATHS)))
        out["t_copula_marginals_worst_se"] = worst
        log(f"t-copula marginals (nu = 4, {VAR_PATHS} paths, CUDA "
            f"generator): log-return mean and std within {worst:.2f} se of "
            f"GBM's")
        check(worst < 3.0, "t-copula marginals are GBM's")
        big = {"spots": [100.0 + 5 * i for i in range(16)],
               "sigmas": [0.15 + 0.01 * i for i in range(16)],
               "weights": [1.0 / 16] * 16, "corr": equicorr(16, 0.3),
               "T": 0.05, "num_paths": 2_000_000}
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device) / 2**30
        res, ms = ask("var 2M x 16", big, "/api/var")
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        out["var_2m_x16"] = {"ms": ms, "peak_gib": peak, "held_gib": held,
                             "var": res["var"]}
        log(f"/api/var 2 000 000 paths x 16 assets (Gaussian, contributions, "
            f"32 steps): {ms:.1f} ms, peak device memory {peak:.3f} GiB "
            f"(all allocations of the process; {held:.3f} GiB of it held "
            f"before the request, {peak - held:.3f} GiB the request's own)")
        refused("dimension mismatch", dict(book, weights=[0.5, 0.5]),
                "/api/var", "dimensions")
        refused("corr not positive definite", dict(
            book, corr=[[1.0, 1.5, 0.0], [1.5, 1.0, 0.0], [0.0, 0.0, 1.0]]),
            "/api/var", "positive definite")

        # ── /api/regime: the reference's labels, and the detector ────────
        # tests/test_risk_regime_guards.py pins calm, event and crisis on
        # these three inputs.
        for inputs, label in (((0.12, 25, 0.02), "calm"),
                              ((0.22, 60, 0.06), "event"),
                              ((0.35, 85, 0.12), "crisis")):
            body = dict(zip(("realized_vol", "iv_percentile",
                             "skew_slope"), inputs))
            res, _ = ask(f"regime {inputs}", body, "/api/regime")
            ref = regime.RegimeDetector().classify(*inputs)
            check(res["regime"] == label,
                  f"regime {inputs}: {res['regime']}, expected {label}")
            check(res["regime"] == ref["regime"]
                  and res["score"] == ref["score"],
                  f"regime {inputs}: {res['regime']} vs {ref['regime']}")
        log("/api/regime: the canned inputs give calm, event and crisis, as "
            "the reference pins them and as the detector in process does")

        warm("stress report", stress, "/api/stress", n_report)
        warm("hedge gbm", common, "/api/hedge", 1)
        warm("hedge svj", dict(common, dynamics="svj"), "/api/hedge", 1)
        warm("var gaussian", book, "/api/var")
        warm("var student_t", dict(book, copula="student_t"), "/api/var")
        warm("regime", {"realized_vol": 0.22, "iv_percentile": 60,
                        "skew_slope": 0.06}, "/api/regime")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    counts = ck.launch_counts()
    expect = k3["requests"] + k3["in_process"]
    log(f"launch counts over the risk desk path: {counts} (K3 expected "
        f"{k3['requests']} for the requests + {k3['in_process']} in process)")
    for name, n in counts.items():
        want = expect if name == "svj_terminal" else 0
        check(n == want, f"{name} launched {n} times, expected {want}")
    out["launches"] = counts
    out["k3_launches"] = k3
    out["wall_s"] = time.perf_counter() - t_start
    log(f"risk desk path: {out['wall_s']:.1f} s")
    return out


# ─────────────────────────────────────────────────────────────────────────────
# American exercise and the PDE solvers (slice H)
# ─────────────────────────────────────────────────────────────────────────────
AM_PATHS = 200_000        # AmericanRequest default
AM_SIGMA = 0.25
# Degenerate SVJ: no vol of vol, no jumps, v = v0 throughout, so the
# model is Black-Scholes at sigma = 0.25 and the CRR tree is its oracle.
AM_GBM = {"kappa": 0.0, "theta": AM_SIGMA**2, "xi": 0.0, "rho": 0.0,
          "v0": AM_SIGMA**2, "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.0,
          "r": 0.06, "q": 0.0}
AM_BODY = {"spot": 100.0, "strike": 100.0, "T": 1.0, "is_call": False,
           "params": AM_GBM}
PDE_BODY = {"spot": 100.0, "strike": 100.0, "T": 0.5}


def profiled_call(device, call) -> dict:
    """One warm in-process call under torch.profiler (its device time,
    kernel launches and busy share) and, in a second call, its peak device
    memory above what the process held before it."""
    from mcos_tpu_torch.profile_price import _profiled

    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    call()
    torch.cuda.synchronize(device)
    peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30
    return dict(_profiled(call, 1), peak_gib=peak)


def american_card_vs_cpu(device, american, pde, SVJParams, paths=20_000,
                         steps=32):
    """The LSM programs and the grids on the card against the CPU's, on
    the same draws and grids: a fixed policy's price, its Greeks and the
    dual (rtol 1e-4); the in-sample LSM within half a standard error, its
    exercise flips counted; the ADI (plain and PIDE) and the CN grids to
    1e-4 of their largest value."""
    from mcos_tpu_torch.engine.pricer import seeded_generator

    out = {}
    p = SVJParams()
    gen = seeded_generator(11, "cpu")
    z = torch.randn((steps, 3, paths), generator=gen)
    u = torch.rand((steps, paths), generator=gen)
    cpu, card = (z, u), (z.to(device), u.to(device))
    kw = dict(is_call=False)
    t0 = time.perf_counter()
    res = {}
    for name, draws in (("cpu", cpu), ("card", card)):
        lsm = american.lsm_price(p, 100.0, 100.0, 1.0, draws=draws, **kw)
        coefs = american.lsm_train(p, 100.0, 100.0, 1.0, draws=draws,
                                   **kw)["policy"]
        res[name] = {"lsm": {k: float(v) for k, v in lsm.items()},
                     "coefs": coefs.cpu()}
    torch.cuda.synchronize(device)
    coefs = res["cpu"]["coefs"]
    got = {}
    for name, draws, c in (("cpu", cpu, coefs), ("card", card,
                                                  coefs.to(device))):
        lb = american.lsm_lower_bound(p, 100.0, 100.0, 1.0, None, c,
                                      draws=draws, **kw)
        vals = american._lower_bound_values(p, 100.0, 100.0, 1.0, None, c,
                                            draws=draws, **kw)
        price, grads = american.american_greeks_ad(p, 100.0, 100.0, 1.0,
                                                   None, c, draws=draws, **kw)
        got[name] = {"lower_bound": float(lb["price"]),
                     "greeks": [float(price)] + [float(g) for g in grads],
                     "values": vals.cpu()}
    # A stopping decision that differs moves a path's value by a payoff;
    # the card's and the CPU's exp differ by rounding on every path.
    flips = int(((got["cpu"]["values"] - got["card"]["values"]).abs()
                 > 1e-3 * float(got["cpu"]["values"].abs().max())).sum())
    check(abs(got["card"]["lower_bound"] / got["cpu"]["lower_bound"] - 1)
          < 1e-4, f"LSM fixed-policy price card vs CPU {got}")
    check(np.allclose(got["card"]["greeks"], got["cpu"]["greeks"],
                      rtol=1e-4, atol=1e-6),
          f"American AD Greeks card vs CPU {got['card']['greeks']} vs "
          f"{got['cpu']['greeks']}")
    lsm_c, lsm_g = res["cpu"]["lsm"], res["card"]["lsm"]
    check(abs(lsm_g["price"] - lsm_c["price"]) < 0.5 * lsm_c["std_error"],
          f"in-sample LSM card vs CPU {lsm_g} vs {lsm_c}")
    log(f"LSM on the card vs the CPU ({paths} paths x {steps} steps, the "
        f"same draws): in-sample {lsm_g['price']:.5f} vs "
        f"{lsm_c['price']:.5f} (se {lsm_c['std_error']:.5f}); the CPU's "
        f"policy on both: {got['card']['lower_bound']:.6f} vs "
        f"{got['cpu']['lower_bound']:.6f}, {flips} of {paths} stopping "
        f"decisions differ; Greeks {np.round(got['card']['greeks'], 6)}")
    check(flips <= 0.001 * paths, f"fixed-policy flips card vs CPU: {flips}")
    out["lsm"] = {"card": lsm_g, "cpu": lsm_c, "fixed_policy_flips": flips,
                  "greeks_card": got["card"]["greeks"],
                  "greeks_cpu": got["cpu"]["greeks"]}

    # The dual on shared outer and inner draws.
    value = american.lsm_train(p, 100.0, 100.0, 1.0, draws=cpu,
                               **kw)["value"]
    half, n_outer = 32, 1024
    zi = torch.randn((steps, 3, half, n_outer), generator=gen)
    ui = torch.rand((steps, half, n_outer), generator=gen)
    zo = torch.randn((steps, 3, n_outer), generator=gen)
    uo = torch.rand((steps, n_outer), generator=gen)
    duals = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        d = ((zo.to(dev), uo.to(dev)), (zi.to(dev), ui.to(dev)))
        r = american.dual_upper_bound(p, 100.0, 100.0, 1.0, None,
                                      value.to(dev), n_outer=n_outer,
                                      n_inner=2 * half, num_steps=steps,
                                      draws=d, **kw)
        duals[name] = float(r["price"])
    check(abs(duals["card"] / duals["cpu"] - 1) < 1e-4,
          f"dual card vs CPU {duals}")
    out["dual"] = duals

    # The grids.
    grids = {}
    for lam in (0.0, 1.0):
        pp = SVJParams(lambda_j=lam)
        engs = {n: pde.HestonPDEEngine(pp, n_x=101, n_v=51, n_t=64,
                                       device=d)
                for n, d in (("cpu", "cpu"), ("card", device))}
        x, v, n_x, n_t = engs["cpu"]._grids(100.0, 100.0, 0.5)
        u_ = {n: e._solve(x, v, n_x, n_t, 100.0, 0.5, False, True,
                          jump=e._jump_tables(x))[0].cpu()
              for n, e in engs.items()}
        err = float((u_["card"] - u_["cpu"]).abs().max()
                    / u_["cpu"].abs().max())
        grids[f"adi lambda_j={lam}"] = err
    x = np.linspace(np.log(40.0), np.log(250.0), 201).astype(np.float32)
    sig2 = np.full((128, 201), AM_SIGMA**2, np.float32)
    div = np.zeros(128, np.float32)
    div[40] = np.log1p(-0.03)
    vv = {n: pde._cn_solve(sig2, 100.0, 1.0, 0.06, 0.0, x, div, n_x=201,
                           n_t=128, is_call=False, american=True,
                           device=d)[0].cpu()
          for n, d in (("cpu", "cpu"), ("card", device))}
    grids["cn american"] = float((vv["card"] - vv["cpu"]).abs().max()
                                 / vv["cpu"].abs().max())
    log(f"grids on the card vs the CPU (max |diff| / max |V|): {grids}")
    for name, err in grids.items():
        check(err < 1e-4, f"{name} card vs CPU: {err}")
    out["grids"] = grids
    out["wall_s"] = time.perf_counter() - t0
    return out


def american_path(device, ck, server, american, pde, termsvj, bs_price,
                  barrier_bs, SVJParams):
    """POST /api/american, /api/pde and /api/termsvj mode="american" over
    HTTP on a fresh server at the schema defaults, with the launch counts
    set to 0 just before: no kernel of the repo may launch (the slice is
    torch ops throughout)."""
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {"requests": {}}
    r, q, sig = AM_GBM["r"], AM_GBM["q"], AM_SIGMA

    def ask(what, body, path):
        status, res, ms = post(base, body, path=path)
        check(status == 200, f"{what}: status {status}")
        check(all_finite({k: v for k, v in res.items()
                          if k not in ("exercise_boundary", "cos_oracle")}),
              f"{what}: every number finite")
        out["requests"][what] = {"latency_ms": ms,
                                 "elapsed_ms": res.get("elapsed_ms")}
        return res

    def refused(what, body, path, needle):
        try:
            post(base, body, path=path)
            check(False, f"{what} must answer 400")
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())["detail"]
            check(e.code == 400 and needle in str(detail),
                  f"{what}: {e.code} {detail!r}")
            log(f"{path} {what}: 400 {detail!r}")

    def warm(what, body, path):
        lat = []
        for _ in range(5):
            lat.append(post(base, body, path=path)[2])
        out[f"warm_{what}_ms"] = statistics.median(lat)
        log(f"warm {path} {what}: median {statistics.median(lat):.2f} ms "
            f"over 5 ({[round(x, 2) for x in lat]})")

    def lap(what):
        log(f"  [{what}: {time.perf_counter() - t_start:.1f} s into the "
            f"path]")

    try:
        # ── /api/american: the degenerate put against the CRR tree ───────
        crr = american.binomial_american_bs(100.0, 100.0, 1.0, r, q, sig,
                                            steps=1000, is_call=False)
        res = ask("american put", AM_BODY, "/api/american")
        se = res["std_error"]
        log(f"/api/american degenerate put ({res['num_paths_used']} paths, "
            f"{res['num_steps']} steps): {res['price']:.4f} ± {se:.4f} vs "
            f"CRR(1000) {crr:.4f} (tol 3 se + 1 %: the LSM's low bias)")
        check(res["num_paths_used"] == AM_PATHS and res["num_steps"] == 64,
              f"american request size {res}")
        check(abs(res["price"] - crr) < 3 * se + 0.01 * crr
              and res["price"] < crr + 3 * se, "american put vs CRR")
        out["american_put"] = {"price": res["price"], "se": se, "crr": crr}

        res = ask("american with_bounds", dict(AM_BODY, with_bounds=True),
                  "/api/american")
        b = res["bounds"]
        log(f"/api/american with_bounds: [{b['lower_bound']:.4f} ± "
            f"{b['lower_se']:.4f}, {b['upper_bound']:.4f} ± "
            f"{b['upper_se']:.4f}], gap {b['duality_gap']:.4f}, CRR "
            f"{crr:.4f} ({b['n_outer']} x {b['n_inner']} dual)")
        check(b["lower_bound"] - 3 * b["lower_se"] <= crr
              <= b["upper_bound"] + 3 * b["upper_se"], "bounds bracket CRR")
        out["bounds"] = b

        res = ask("american European", dict(AM_BODY, exercise_every=999),
                  "/api/american")
        bs = float(bs_price(100.0, 100.0, 1.0, r, q, sig, False))
        log(f"/api/american exercise_every=999 → {res['exercise_every']}: "
            f"{res['price']:.4f} ± {res['std_error']:.4f} vs BS {bs:.4f}")
        check(res["exercise_every"] == 64
              and abs(res["price"] - bs) < 3 * res["std_error"],
              "European limit vs BS")

        res = ask("american with_greeks", dict(AM_BODY, with_greeks=True),
                  "/api/american")
        g = res["greeks"]
        # The CRN bump of the same estimator: the policy trained on the
        # engine's seed, evaluated at spot ± h on the evaluation draws.
        eng = american.AmericanEngine(SVJParams(**AM_GBM),
                                      num_paths=AM_PATHS, device=device)
        steps = 64
        coefs = american.lsm_train(eng.params, 100.0, 100.0, 1.0,
                                   draws=eng._draws(0, steps),
                                   is_call=False)["policy"]
        ev = eng._draws(1, steps)
        spots = (98.0, 100.0, 102.0, 95.0, 105.0)
        pv = dict(zip(spots, (float(american.lsm_lower_bound(
            eng.params, s, 100.0, 1.0, None, coefs, draws=ev,
            is_call=False)["price"]) for s in spots)))
        tree = {s: american.binomial_american_bs(s, 100.0, 1.0, r, q, sig,
                                                 steps=2000, is_call=False)
                for s in spots}

        def fd(prices, h):
            return ((prices[100.0 + h] - prices[100.0 - h]) / (2 * h),
                    (prices[100.0 + h] - 2 * prices[100.0]
                     + prices[100.0 - h]) / h**2)

        fd_delta, _ = fd(pv, 2.0)
        _, fd_gamma = fd(pv, 5.0)
        crr_delta, crr_gamma = fd(tree, 2.0)
        _, crr_gamma5 = fd(tree, 5.0)
        log(f"/api/american with_greeks: AD delta {g['delta']:.5f}, gamma "
            f"{g['gamma']:.5f}; CRN bump delta (h = 2) {fd_delta:.5f}, "
            f"gamma (h = 5) {fd_gamma:.5f}; CRR delta {crr_delta:.5f}, "
            f"gamma {crr_gamma:.5f} (h = 5: {crr_gamma5:.5f}); vega/vol pt "
            f"{g['vega_per_vol_point']:.4f}, theta {g['theta_annual']:.3f},"
            f" rho {g['rho']:.4f}")
        check(abs(g["price"] - pv[100.0]) < 1e-4 * pv[100.0],
              "greeks price is the policy-fixed price")
        check(abs(g["delta"] - fd_delta) < 0.01 + 0.05 * abs(fd_delta)
              and abs(g["delta"] - crr_delta) < 0.02,
              "American AD delta vs its CRN bump and the tree")
        check(abs(g["gamma"] - crr_gamma) < 0.15 * crr_gamma
              and abs(fd_gamma - crr_gamma5) < 0.3 * crr_gamma5,
              "American gamma vs the tree; the CRN bump's vs the tree's")
        out["greeks"] = dict(g, fd_delta=fd_delta, fd_gamma=fd_gamma,
                             crr_delta=crr_delta, crr_gamma=crr_gamma,
                             crr_gamma_h5=crr_gamma5)

        res = ask("american oracle and boundary",
                  dict(AM_BODY, with_cos_oracle=True, with_boundary=True),
                  "/api/american")
        cos = res["cos_oracle"]["price"]
        bd = np.asarray(res["exercise_boundary"]["s_star"], float)
        log(f"/api/american with_cos_oracle {cos:.4f} (CRR {crr:.4f}); "
            f"with_boundary: {np.isfinite(bd).sum()} of {bd.size} dates "
            f"finite, S* from {np.nanmin(bd):.2f} to {np.nanmax(bd):.2f}")
        check(np.isfinite(cos) and abs(cos / crr - 1) < 2e-3,
              "COS oracle vs CRR (exact at xi = 0)")
        check(np.isfinite(bd).sum() > 0.9 * bd.size
              and np.nanmax(bd) < 100.0, "put boundary below the strike")

        div_call = dict(AM_BODY, is_call=True,
                        dividends=[{"t": 0.5, "amount": 5.0}])
        amer = ask("american dividend call", div_call, "/api/american")
        euro = ask("american dividend call, European",
                   dict(div_call, exercise_every=999), "/api/american")
        log(f"/api/american call, cash dividend 5 at t = 0.5: American "
            f"{amer['price']:.4f} ± {amer['std_error']:.4f}, European "
            f"(same paths) {euro['price']:.4f}")
        check(amer["price"] > euro["price"] + 3 * amer["std_error"],
              "the dividend call exercises early")
        ask("american rate curve",
            dict(AM_BODY, rate_curve=[{"t": 0.5, "r": 0.04},
                                      {"t": 1.0, "r": 0.08}]),
            "/api/american")
        ask("american proportional dividend",
            dict(AM_BODY, dividends=[{"t": 0.3, "amount": 0.02}],
                 dividend_kind="proportional", with_boundary=True),
            "/api/american")

        lap("american")
        # ── /api/pde ─────────────────────────────────────────────────────
        res = ask("pde heston", dict(PDE_BODY, with_oracle=True), "/api/pde")
        log(f"/api/pde heston ({res['n_x']} x {res['n_v']} x {res['n_t']}, "
            f"{res['method']}): {res['price']:.5f} vs COS "
            f"{res['cos_oracle']['price']:.5f} (abs tol 0.015)")
        check(res["cos_oracle"]["abs_error"] < 0.015, "ADI vs COS")
        out["pde_heston_abs_error"] = res["cos_oracle"]["abs_error"]
        res = ask("pde heston douglas", dict(PDE_BODY, with_oracle=True,
                                             scheme="douglas"), "/api/pde")
        check(res["cos_oracle"]["abs_error"] < 0.015, "Douglas vs COS")
        jump = dict(PDE_BODY, with_oracle=True,
                    params={"lambda_j": 1.0, "sigma_j": 0.1})
        res = ask("pde pide", jump, "/api/pde")
        log(f"/api/pde PIDE lambda_j = 1 ({res['method']}): "
            f"{res['price']:.5f} vs COS {res['cos_oracle']['price']:.5f}")
        check(res["cos_oracle"]["abs_error"] < 0.015, "PIDE vs COS")
        res = ask("pde heston american", dict(PDE_BODY, is_call=False,
                                              american=True,
                                              with_boundary=True),
                  "/api/pde")
        surf = np.asarray(res["exercise_boundary"]["s_star"], float)
        check(surf.shape == (128, 101) and np.nanmax(surf) < 100.0,
              "ADI exercise surface below the strike")

        p0 = server.schemas.SVJParamsRequest(lambda_j=0.0).to_params()
        bs_errs = {}
        for grid in ({}, {"n_x": 401, "n_t": 256}):
            tol_e, tol_a = (5e-4, 2e-3) if not grid else (2e-4, 5e-4)
            for is_call in (True, False):
                res = ask(f"pde bs {grid or 'default'} {is_call}",
                          dict(PDE_BODY, model="bs", is_call=is_call,
                               **grid), "/api/pde")
                ref = float(bs_price(100.0, 100.0, 0.5, p0.r, p0.q, 0.2,
                                     is_call))
                bs_errs[f"european {grid or 'default'} {is_call}"] = \
                    res["price"] / ref - 1
                check(abs(res["price"] / ref - 1) < tol_e,
                      f"CN European vs BS {grid}")
            res = ask(f"pde bs american {grid or 'default'}",
                      dict(PDE_BODY, model="bs", is_call=False,
                           american=True, with_boundary=True, **grid),
                      "/api/pde")
            ref = american.binomial_american_bs(100.0, 100.0, 0.5, p0.r,
                                                p0.q, 0.2, steps=5000,
                                                is_call=False)
            bs_errs[f"american {grid or 'default'}"] = res["price"] / ref - 1
            check(abs(res["price"] / ref - 1) < tol_a,
                  f"CN American put vs CRR {grid}")
        log(f"/api/pde bs relative errors (European vs BS: tol 5e-4 at the "
            f"schema's 201 x 128, 2e-4 at the engine's 401 x 256; American "
            f"put vs CRR(5000): 2e-3, 5e-4): {bs_errs}")
        out["pde_bs_rel_errors"] = bs_errs

        gbm = dict(AM_GBM, r=p0.r, q=p0.q, v0=0.04, theta=0.04)
        for bar, d, is_call in ((120.0, "up", True),
                                (85.0, "down", False)):
            res = ask(f"pde barrier {d}", dict(PDE_BODY, params=gbm,
                                               barrier=bar, direction=d,
                                               is_call=is_call), "/api/pde")
            ref = barrier_bs(100.0, 100.0, 0.5, p0.r, p0.q, 0.2, bar,
                             is_call, "out", d)
            log(f"/api/pde {d}-and-out under GBM: {res['price']:.5f} vs "
                f"Reiner-Rubinstein {ref:.5f}")
            check(abs(res["price"] - ref) < 0.01, f"barrier {d} vs RR")

        lap("pde")
        # ── 400s ─────────────────────────────────────────────────────────
        cash = [{"t": 0.5, "amount": 1.0}]
        refused("with_bounds and dividends",
                dict(AM_BODY, with_bounds=True, dividends=cash),
                "/api/american", "with_bounds")
        refused("with_cos_oracle and a curve",
                dict(AM_BODY, with_cos_oracle=True,
                     rate_curve=[{"t": 1.0, "r": 0.05}]),
                "/api/american", "with_cos_oracle")
        refused("with_boundary and cash dividends",
                dict(AM_BODY, with_boundary=True, dividends=cash),
                "/api/american", "proportional")
        refused("sigma_j = 0 PIDE",
                dict(PDE_BODY, params={"lambda_j": 1.0, "sigma_j": 0.0}),
                "/api/pde", "sigma_j")
        refused("barrier on the wrong side", dict(PDE_BODY, barrier=95.0),
                "/api/pde", "up-and-out")
        refused("rebate on a knock-in",
                dict(PDE_BODY, barrier=120.0, knock="in", rebate=1.0),
                "/api/pde", "knock-out only")

        # ── /api/termsvj mode="american" ─────────────────────────────────
        td = {"spot": SPOT, "strike": SPOT, "T": 0.25, "is_call": False,
              "segments": TD_SEGMENTS, "mode": "american"}
        res = ask("termsvj american", td, "/api/termsvj")
        seg = [s for s in TD_SEGMENTS]
        eng = termsvj.TDSVJEngine(
            server.schemas.SVJParamsRequest().to_params(),
            [s["t_end"] for s in seg], [s["theta"] for s in seg],
            [s["xi"] for s in seg], [s["lambda_j"] for s in seg],
            num_paths=FAMILY_PAIRS, num_steps=512, device=device)
        euro = eng.price_american(SPOT, SPOT, 0.25, False,
                                  exercise_every=512)
        exact = float(eng.cos_chain(SPOT, [SPOT], 0.25, False)[0])
        log(f"/api/termsvj american put: {res['price']:.3f} ± "
            f"{res['std_error']:.3f}; exercise_every = 512 in process "
            f"{euro['price']:.3f} ± {euro['std_error']:.3f} vs "
            f"cos_price_td {exact:.3f} (tol 3 se + 1 %)")
        check(abs(euro["price"] - exact) < 3 * euro["std_error"]
              + 0.01 * exact, "td Bermudan with no early date vs COS")
        check(res["price"] > euro["price"] - 3 * res["std_error"],
              "td American put >= its European")
        out["termsvj_american"] = {"price": res["price"],
                                   "european": euro["price"],
                                   "cos_price_td": exact}

        lap("400s, termsvj")
        # ── warm latencies ───────────────────────────────────────────────
        warm("american", AM_BODY, "/api/american")
        warm("american with_bounds", dict(AM_BODY, with_bounds=True),
             "/api/american")
        warm("american with_greeks", dict(AM_BODY, with_greeks=True),
             "/api/american")
        warm("pde heston", PDE_BODY, "/api/pde")
        warm("pde bs", dict(PDE_BODY, model="bs"), "/api/pde")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    lap("warm latencies")
    # Each warm request once more in process under the profiler: device
    # time, launches, busy share, peak memory.
    prof = {}
    for what, fn, body in (
            ("american", server.handle_american, AM_BODY),
            ("american with_bounds", server.handle_american,
             dict(AM_BODY, with_bounds=True)),
            ("american with_greeks", server.handle_american,
             dict(AM_BODY, with_greeks=True)),
            ("pde heston", server.handle_pde, PDE_BODY),
            ("pde heston 401 x 201", server.handle_pde,
             dict(PDE_BODY, n_x=401, n_v=201)),
            ("pde bs", server.handle_pde, dict(PDE_BODY, model="bs"))):
        prof[what] = profiled_call(
            device, lambda: fn(dict(body), device=device))
        pr = prof[what]
        log(f"profiled {what}: wall {pr['profiled_wall_ms']:.1f} ms, device "
            f"{pr['device_ms_per_call']} ms, {pr['kernel_launches_per_call']}"
            f" launches, busy share {pr['busy_share']}, peak "
            f"{pr['peak_gib']:.3f} GiB")
    out["profiles"] = prof
    # Four times the nodes: a loop over nodes or lines would add tens of
    # thousands of launches; cuBLAS may pick another GEMM (a split-K
    # reduction) for the larger products, at most two launches a stage.
    small, large = (prof[k]["kernel_launches_per_call"]
                    for k in ("pde heston", "pde heston 401 x 201"))
    log(f"/api/pde heston launches at 201 x 101: {small}, at 401 x 201: "
        f"{large} ({(large - small) / 128:.2f} more a step of 4 implicit "
        f"stages)")
    check(isinstance(small, str) or large - small <= 2 * 4 * 128 + 64,
          "the ADI's launches do not grow with n_x and n_v")

    lap("profiles")
    # The schema's largest PIDE grid: its inverses' memory.
    big = pde.HestonPDEEngine(SVJParams(lambda_j=1.0, sigma_j=0.1), n_x=801,
                              n_v=401, n_t=32, device=device)
    x, v, n_x, n_t = big._grids(100.0, 100.0, 0.5)
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    u_big, _ = big._solve(x, v, n_x, n_t, 100.0, 0.5, True, False,
                          jump=big._jump_tables(x))
    torch.cuda.synchronize(device)
    big_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30
    factors = 2 * 401 * 801 * 801 * 4 / 2**30
    check(bool(torch.isfinite(u_big).all()), "801 x 401 PIDE grid finite")
    log(f"largest PIDE grid (801 x 401, {n_t} steps): {big_s:.2f} s, peak "
        f"device memory {peak:.3f} GiB above the process's, of which the "
        f"x-direction inverses are {factors:.3f} GiB")
    out["largest_pide"] = {"s": big_s, "peak_gib": peak,
                           "factor_gib": factors, "n_t": n_t}
    del u_big

    lap("largest grid")
    out["card_vs_cpu"] = american_card_vs_cpu(device, american, pde,
                                              SVJParams)
    lap("card against the CPU")
    counts = ck.launch_counts()
    log(f"launch counts over the American/PDE path: {counts} (expected "
        f"none)")
    for name, n in counts.items():
        check(n == 0, f"{name} launched {n} times on the American/PDE "
              f"path, expected 0")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"American/PDE path: {out['wall_s']:.1f} s")
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Slice I: calibration and surfaces
# ─────────────────────────────────────────────────────────────────────────────
# Each route's schema defaults, sent explicitly (a CPU rehearsal of the phase
# shrinks them).
SLICE_I_SIZES = {"calibrate_paths": 100_000,   # CalibrateRequest default
                 "calibrate_steps": 50, "calibrate_members": 24,
                 "localvol_paths": 200_000,    # LocalVolRequest default
                 "localvol_steps": 100,
                 "slv_paths": 200_000,         # SLVRequest default
                 "slv_steps": 128,
                 "roundtrip_paths": 300_000, "roundtrip_steps": 200,
                 "card_vs_cpu_paths": 100_000, "card_vs_cpu_steps": 64}
SLV_FLAT_SIGMA = 0.25


def k1_calibration_pin(device, ck, cal, cos_price, SVJParams):
    """K1 at `/api/calibrate`'s shape. The DE objective of a 24-member
    population (one K1 launch for all members) against the same objective
    through the Euler twin, on the same draws (100 000 paths × 50 steps),
    both stages, at λ = 0 and λ > 0. The population launch against its
    plain version and against 24 one-member launches (word for word), and
    path by path against the Euler twin (rtol `K1_TWIN_RTOL`), then timed
    in turns with those 24 launches beside its bound, off a prebuilt
    consts table and from SVJParams; one member's launch beside its plain
    version and its bound. Float32 rounding is the
    bound against the twin: the chain prices to rtol 2e-5 (K1's S to 1e-5
    a path, averaged over 200 000 paths) and the objectives to rtol 1e-4 (a
    squared residual amplifies the prices' relative error by
    2·price/residual). Run before the path's counts are set to 0: these
    launches compare, they are not the path's."""
    from mcos_tpu_torch.engine.pricer import seeded_generator
    from mcos_tpu_torch.profile_price import CHAIN_PARAMS, slice_i_body

    n, steps = SLICE_I_SIZES["calibrate_paths"], SLICE_I_SIZES[
        "calibrate_steps"]
    members = SLICE_I_SIZES["calibrate_members"]
    body = slice_i_body("calibrate")
    strikes = np.asarray(body["strikes"])
    r, q = CHAIN_PARAMS["r"], CHAIN_PARAMS["q"]
    draws = cal._calibration_draws(n, steps, seeded_generator(42, device))
    data = {"spot": body["spot"], "T": body["T"], "r": r, "q": q,
            "draws": draws,
            "strikes": torch.as_tensor(strikes, dtype=torch.float32,
                                       device=device),
            "market_prices": torch.as_tensor(
                np.asarray(body["market_prices"], np.float32),
                device=device),
            "weights": cal.compute_vega_weights(
                body["spot"], strikes, body["T"], r, q, 0.15,
                device=device),
            "heston_x": [CHAIN_PARAMS[k] for k in
                         ("kappa", "theta", "xi", "rho", "v0")]}
    rng = np.random.default_rng(16)
    out = {}
    pops = {}
    for name, fn, bounds, lam in (
            ("stage 1 (lambda 0)", cal.heston_objective, cal.HESTON_BOUNDS,
             None),
            ("stage 2, lambda 0", cal.svj_objective, cal.JUMP_BOUNDS, 0.0),
            ("stage 2, lambda > 0", cal.svj_objective, cal.JUMP_BOUNDS,
             None)):
        lo, hi = bounds[:, 0], bounds[:, 1]
        pop = (lo + (hi - lo) * rng.random((members, len(lo)))).astype(
            np.float32)
        if lam is not None:
            pop[:, 0] = lam
        pops[name] = pop
        x = torch.as_tensor(pop, device=device)
        n0 = ck.svj_terminal_from_draws.launches
        with torch.no_grad():
            ker = fn(x, data, backend="cuda")
            torch.cuda.synchronize()
            launched = ck.svj_terminal_from_draws.launches - n0
            twin = fn(x, data, backend="torch")
        err = float(((ker - twin).abs() / twin.abs()).max())
        log(f"K1 calibration objective, {name}, {members} members x {n} "
            f"paths x {steps} steps: {launched} K1 launch, max rel err vs "
            f"the twin {err:.3e} (rtol 1e-4)")
        check(launched == 1, f"K1 objective {name}: {launched} launches")
        check(bool(torch.isfinite(ker).all()), f"K1 objective {name} finite")
        check(err < 1e-4, f"K1 objective {name} vs the twin: {err}")
        out[name] = err
    # One member's chain prices, K1 against the twin.
    p = SVJParams(**CHAIN_PARAMS)
    prices = {b: cal._chain_prices(p, body["spot"], data["strikes"],
                                   body["T"], draws, is_call=True,
                                   backend=b) for b in ("cuda", "torch")}
    price_err = rel_err(prices["cuda"], prices["torch"])
    log(f"K1 chain prices at the true parameters vs the twin: max rel err "
        f"{price_err:.3e} (rtol 2e-5)")
    check(price_err < 2e-5, f"K1 chain prices vs the twin: {price_err}")

    # The population launch of a stage-2 generation (jumps on) against its
    # plain version and against one-member launches, then timed.
    z1, z2, u, zjs = draws
    kw = dict(antithetic=True, companion=True, steps_major=True)
    core = dict(zip(("kappa", "theta", "xi", "rho", "v0"), data["heston_x"]))
    gen = [SVJParams(**core, lambda_j=float(a), mu_j=float(b),
                     sigma_j=float(c), r=r, q=q)
           for a, b, c in pops["stage 2, lambda > 0"]]
    spot_t = (body["spot"], body["T"])
    ker = ck.svj_terminal_from_draws_population(gen, *spot_t, z1, z2, u,
                                                zjs, **kw)
    ref = ck.svj_terminal_from_draws_population_plain(gen, *spot_t, z1, z2,
                                                      u, zjs, **kw)
    torch.cuda.synchronize()
    s_err, g_err = rel_err(ker[0], ref[0]), rel_err(ker[2], ref[2])
    exact = {k: float((a == b).float().mean())
             for k, a, b in zip("svg", ker, ref)}
    singles = [ck.svj_terminal_from_draws(m, *spot_t, z1, z2, u, zjs, **kw)
               for m in gen]
    same = all(torch.equal(ker[i][j], one[i])
               for j, one in enumerate(singles) for i in range(3))
    log(f"K1 population ({members} x {n} x {steps}) vs plain: S rel err "
        f"{s_err:.3e}, G rel err {g_err:.3e}; bit-equal shares {exact}; "
        f"each member word for word its one-member launch {same}")
    check(all(x == 1.0 for x in exact.values()),
          "K1 population vs plain, bit for bit")
    check(same, "K1 population members vs one-member launches")
    del singles
    twin_err = k1_twin_errs(ck, gen, *spot_t, z1, z2, u, zjs, 0)
    log(f"K1 population ({members} x {n} x {steps}) vs the Euler twin (the "
        f"reference's step algebra), path by path: S rel err "
        f"{twin_err['s_rel_err']:.3e}, G {twin_err['g_rel_err']:.3e} (rtol "
        f"{K1_TWIN_RTOL:g})")
    check(max(twin_err.values()) < K1_TWIN_RTOL,
          "K1 population vs the Euler twin")

    # In turns, the population launch against the 24 one-member launches
    # it replaces: off the generation's consts table built once beforehand
    # (the launches: the wrapper's checks, its table copy, the kernel), and
    # from the members' SVJParams, as `_chain_sse` calls the wrapper (the
    # host builds the table every call) and as the calibration launched
    # K1 before, once a member.
    table = ck._svj_consts_table(gen, *spot_t, steps)
    calls = {
        "population": lambda: ck.svj_terminal_from_draws_population(
            table, *spot_t, z1, z2, u, zjs, **kw),
        "single_x24": lambda: [ck.svj_terminal_from_draws_population(
            table[m:m + 1], *spot_t, z1, z2, u, zjs, **kw)
            for m in range(members)],
        "population_from_params": lambda: (
            ck.svj_terminal_from_draws_population(gen, *spot_t, z1, z2, u,
                                                  zjs, **kw)),
        "single_x24_from_params": lambda: [ck.svj_terminal_from_draws(
            m, *spot_t, z1, z2, u, zjs, **kw) for m in gen]}
    turns = {name: [] for name in calls}
    for name in list(calls) + list(reversed(list(calls))):
        turns[name].append(cuda_ms(calls[name], reps=10))
    t_ms = {name: statistics.mean(v) for name, v in turns.items()}
    pop_ms, singles_ms = t_ms["population"], t_ms["single_x24"]
    pop_plain_ms = cuda_ms(
        lambda: ck.svj_terminal_from_draws_population_plain(
            gen, *spot_t, z1, z2, u, zjs, **kw), reps=2)
    pb = bound(k1_ops(members, streamed_u=True), members * steps * n,
               4 * steps * n * 4, 3 * members * 2 * n * 4)
    log(f"K1 population launch ({members} members x {n} paths x {steps} "
        f"steps, explicit jump uniforms, consts table built beforehand): "
        f"{pop_ms:.4f} ms ({turns['population']}), {members} one-member "
        f"launches {singles_ms:.4f} ms ({turns['single_x24']}): "
        f"{singles_ms / pop_ms:.2f}x; plain {pop_plain_ms:.2f} ms; bound "
        f"{pb['bound_ms']:.4f} ms ({pb['bound_by']}, "
        f"{pb['ops_per_unit']:.3f} operations a member path-step), "
        f"{pb['bound_ms'] / pop_ms:.1%} of it")
    log(f"K1 from the members' SVJParams, as the calibration calls it: "
        f"population {t_ms['population_from_params']:.4f} ms "
        f"({turns['population_from_params']}), {members} one-member "
        f"wrapper calls {t_ms['single_x24_from_params']:.4f} ms "
        f"({turns['single_x24_from_params']}): "
        f"{t_ms['single_x24_from_params'] / t_ms['population_from_params']:.2f}x")
    check(singles_ms / pop_ms >= 5.0,
          f"K1 population {pop_ms} ms vs 24 launches {singles_ms} ms")
    ms = cuda_ms(lambda: ck.svj_terminal_from_draws(
        p, *spot_t, z1, z2, u, zjs, **kw), reps=20)
    plain_ms = cuda_ms(lambda: ck.svj_terminal_from_draws_plain(
        p, *spot_t, z1, z2, u, zjs, **kw), reps=3)
    b = bound(k1_ops(1, streamed_u=True), steps * n, 4 * steps * n * 4,
              3 * 2 * n * 4)
    log(f"K1 one member at the calibration shape ({n} paths x {steps} "
        f"steps, explicit jump uniforms), wrapper calls from SVJParams in a "
        f"loop: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"objective_rel_err": out, "price_rel_err": price_err,
            "population": {
                "shape": [members, steps, n], "ms": pop_ms,
                "turns_ms": turns, "single_x24_ms": singles_ms,
                "from_params_ms": t_ms["population_from_params"],
                "single_x24_from_params_ms": t_ms["single_x24_from_params"],
                "twin_rel_err": twin_err,
                "speedup": singles_ms / pop_ms, "plain_ms": pop_plain_ms,
                "max_abs_err": float((ker[0] - ref[0]).abs().max()),
                "s_rel_err": s_err, "g_rel_err": g_err,
                "bit_equal_share": exact, "members_equal_singles": same,
                **pb},
            "ms": ms, "plain_ms": plain_ms, **b}


def slv_card_vs_cpu(device, localvol, slv, SVJParams, surf):
    """The SLV step loop on the card against the CPU on the same normals:
    the ATM call and put within 1 se (the card's bin sums are atomics in
    no fixed order, so the clouds part by rounding), and the local-vol
    loop's spots to rtol 2e-4 (the card's and the CPU's exp and sqrt
    differ by an ulp, which the local-vol feedback carries over the steps:
    3 of 200 000 paths part by 8e-5 at 64 steps)."""
    from mcos_tpu_torch.engine.pricer import seeded_generator

    n, steps = (SLICE_I_SIZES["card_vs_cpu_paths"],
                SLICE_I_SIZES["card_vs_cpu_steps"])
    rows, t_mid = surf.step_tables(0.5, steps)
    y0, dy = float(surf.y_grid[0]), float(surf.y_grid[1] - surf.y_grid[0])
    z = torch.randn((steps, 2, n), generator=seeded_generator(5, "cpu"))
    heston = SVJParams(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04,
                       lambda_j=0.0, r=surf.r, q=surf.q)
    out = {}
    for name, dev in (("cpu", "cpu"), ("card", device)):
        s = slv.slv_terminal(heston, rows, t_mid, y0, dy, 100.0, 0.5,
                             normals=z.to(dev)).cpu()
        lv = localvol.simulate_terminal_localvol(
            rows, t_mid, y0, dy, 100.0, surf.r, surf.q, 0.5,
            normals=z[:, 0].to(dev)).cpu()
        row = {"lv": lv}
        for leg, pay in (("call", torch.clamp(s - 100.0, min=0.0)),
                         ("put", torch.clamp(100.0 - s, min=0.0))):
            pay = pay.mean(dim=0)
            row[leg] = (float(pay.mean()),
                        float(pay.std(correction=0) / pay.numel() ** 0.5))
        out[name] = row
    lv_err = rel_err(out["card"].pop("lv"), out["cpu"].pop("lv"))
    for leg in ("call", "put"):
        (a, se), (b, _) = out["card"][leg], out["cpu"][leg]
        log(f"SLV {leg} on the card vs the CPU ({n} paths x {steps} steps, "
            f"the same normals): {a:.5f} vs {b:.5f}, se {se:.5f}")
        check(abs(a - b) < se, f"SLV {leg} card vs CPU within 1 se")
    log(f"local-vol spots on the card vs the CPU: max rel err {lv_err:.3e}")
    check(lv_err < 2e-4, "local-vol card vs CPU")
    return dict(out, lv_rel_err=lv_err)


def calibration_path(device, ck, server, cal, localvol, slv, ssvi,
                     cos_price, bs_price, SVJParams):
    """Slice I over HTTP on a fresh server, with the launch counts set to 0
    just before: `/api/calibrate` (its DE members on K1, one launch a
    generation), `/api/surface`, `/api/quotegreeks`, `/api/localvol`,
    `/api/slv`; then K1 launched exactly (generations + 1) a stage a
    calibrate, 127, and no other kernel."""
    from mcos_tpu_torch.engine.american import binomial_american_bs
    from mcos_tpu_torch.engine.pricer import (mc_price_from_draws,
                                              seeded_generator)
    from mcos_tpu_torch.profile_price import (CHAIN_PARAMS, SMILE_MATS,
                                              slice_i_body, smile_iv)

    sz = SLICE_I_SIZES
    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {"requests": {}}
    n_calibrates = 0

    def ask(what, body, path):
        nonlocal n_calibrates
        status, res, ms = post(base, body, path=path)
        n_calibrates += path == "/api/calibrate"
        check(status == 200, f"{what}: status {status}")
        # The error bars' condition number is inf where a parameter is
        # pinned (lambda_j = 0 leaves the jump columns zero), as in the JAX
        # package.
        check(all_finite({k: v for k, v in res.items()
                          if k != "uncertainty"}),
              f"{what}: every number finite")
        out["requests"][what] = {"latency_ms": ms,
                                 "elapsed_ms": res.get("elapsed_ms")}
        return res

    def warm(what, body, path):
        nonlocal n_calibrates
        lat = [post(base, body, path=path)[2] for _ in range(3)]
        n_calibrates += 3 * (path == "/api/calibrate")
        out[f"warm_{what}_ms"] = statistics.median(lat)
        log(f"warm {path} {what}: median {statistics.median(lat):.2f} ms "
            f"over 3 ({[round(x, 2) for x in lat]})")

    def lap(what):
        log(f"  [{what}: {time.perf_counter() - t_start:.1f} s into the "
            f"path]")

    cal_body = dict(slice_i_body("calibrate"),
                    num_paths=sz["calibrate_paths"])
    surf_body = dict(slice_i_body("surface"), fit_ssvi=True)
    qg_body = slice_i_body("quotegreeks")
    lv_body = dict(slice_i_body("localvol"), num_paths=sz["localvol_paths"],
                   num_steps=sz["localvol_steps"])
    slv_body = dict(slice_i_body("slv"), num_paths=sz["slv_paths"],
                    num_steps=sz["slv_steps"])
    try:
        # ── /api/calibrate ───────────────────────────────────────────────
        t0 = time.perf_counter()
        res = ask("calibrate", cal_body, "/api/calibrate")
        cal_s = time.perf_counter() - t0
        strikes = np.asarray(cal_body["strikes"])
        market = np.asarray(cal_body["market_prices"])
        fit = SVJParams(**res["params"])
        truth = SVJParams(**CHAIN_PARAMS)
        # The bound, by the triangle inequality in the stage-2 weighted
        # norm ||x||_w = sqrt(sum w x^2) (every strike is in stage 2's
        # 0.8-1.2 range): ||COS(fit) - mkt|| <= ||MC(fit) - mkt|| +
        # ||COS(fit) - MC(fit)||. The first is at most sqrt(stage-2 error)
        # (the fit's own weighted SSE plus its Tikhonov term); the second is
        # the estimator's error at the fit: 3 of its standard errors at
        # 100 000 paths plus its 50-step Euler bias, which is taken at the
        # true parameters on the same draws (MC(true) - COS(true)) and
        # doubled for the move from the true to the fitted parameters.
        w = cal.compute_vega_weights(cal_body["spot"], strikes,
                                     cal_body["T"], truth.r, truth.q,
                                     0.15).numpy().astype(np.float64)
        draws = cal._calibration_draws(sz["calibrate_paths"],
                                      sz["calibrate_steps"],
                                      seeded_generator(42, device))
        est = {}
        for name, p in (("fit", fit), ("true", truth)):
            # The Euler twin on the calibration's draws: the same
            # estimator, and no K1 launch outside the requests.
            r_ = mc_price_from_draws(
                p, cal_body["spot"], strikes, cal_body["T"], *draws,
                backend="torch", steps_major=True)
            est[name] = {k: r_[k].cpu().numpy().astype(np.float64)
                         for k in ("price", "std_error")}
        cos_fit = np.asarray(cos_price(fit, cal_body["spot"], strikes,
                                       cal_body["T"]), np.float64)
        cos_true = np.asarray(cos_price(truth, cal_body["spot"], strikes,
                                        cal_body["T"]), np.float64)

        def wnorm(x):
            return float(np.sqrt(np.sum(w * x * x)))

        got = wnorm(cos_fit - market)
        bound_ = (np.sqrt(res["stage2_result"]["error"])
                  + 3 * wnorm(est["fit"]["std_error"])
                  + 2 * wnorm(est["true"]["price"] - cos_true))
        log(f"/api/calibrate default ({sz['calibrate_paths']} paths x "
            f"{sz['calibrate_steps']} steps, {sz['calibrate_members']} "
            f"members): {cal_s:.2f} s; stage errors "
            f"{res['stage1_result']['error']:.3e} / "
            f"{res['stage2_result']['error']:.3e}; params {res['params']}; "
            f"COS reprices the chain within {got:.4f} (weighted RMS; max "
            f"|diff| {np.abs(cos_fit - market).max():.4f}) against the bound "
            f"{bound_:.4f} = sqrt(stage-2 error) + 3 se + 2 x the 50-step "
            f"bias at the truth ({wnorm(est['true']['price'] - cos_true):.4f})")
        check(got <= bound_, "calibrated parameters reprice the chain by COS")
        out["calibrate"] = {"s": cal_s, "params": res["params"],
                            "stage1_error": res["stage1_result"]["error"],
                            "stage2_error": res["stage2_result"]["error"],
                            "cos_wrms": got, "bound": bound_,
                            "uncertainty_present":
                                res["uncertainty"] is not None}

        am_strikes = strikes[::2]
        am_prices = [binomial_american_bs(cal_body["spot"], K, 0.5,
                                          truth.r, truth.q, 0.22,
                                          steps=256, is_call=False)
                     for K in am_strikes]
        res = ask("calibrate american", dict(
            cal_body, strikes=am_strikes.tolist(), market_prices=am_prices,
            is_call=False, exercise="american"), "/api/calibrate")
        log(f"/api/calibrate exercise=american: 200, "
            f"{len(res['deamericanized']['strikes_kept'])} quotes kept, "
            f"IVs {np.round(res['deamericanized']['ivs'], 4).tolist()}")
        check(np.allclose(res["deamericanized"]["ivs"], 0.22, atol=1e-4),
              "de-Americanized IVs recover the tree's vol")
        lap("calibrate")

        # ── /api/surface ─────────────────────────────────────────────────
        res = ask("surface", surf_body, "/api/surface")
        iv_err = float(np.abs(np.asarray(res["iv_call"], np.float64)
                              - smile_iv()).max())
        put_err = float(np.abs(np.asarray(res["iv_put"], np.float64)
                               - smile_iv()).max())
        sabr = {T: f["error"] for T, f in res["sabr_fits"].items()}
        ssvi_fit = res["ssvi_fit"]
        log(f"/api/surface: IV round trip max err call {iv_err:.2e}, put "
            f"{put_err:.2e} (tol 1e-5); SABR errors {sabr} (tol 1e-6); SSVI "
            f"rmse(w) {ssvi_fit['rmse_total_variance']:.2e} (tol 1e-3), "
            f"butterfly free {ssvi_fit['arbitrage']['butterfly_free']}; "
            f"arbitrage report {res['arbitrage_report']}")
        check(iv_err < 1e-5 and put_err < 1e-5, "surface IVs round-trip")
        check(len(sabr) == len(SMILE_MATS)
              and max(sabr.values()) < 1e-6, "SABR fits")
        check(ssvi_fit["rmse_total_variance"] < 1e-3, "SSVI fit")
        check(res["arbitrage_report"]["num_maturities_fitted"]
              == len(SMILE_MATS)
              and "is_arbitrage_free" in res["arbitrage_report"],
              "arbitrage report present")
        out["surface"] = {"iv_err": max(iv_err, put_err), "sabr": sabr,
                          "ssvi_rmse": ssvi_fit["rmse_total_variance"]}

        # ── /api/quotegreeks: host float64, card = CPU ──────────────────
        res = ask("quotegreeks", qg_body, "/api/quotegreeks")
        ref = server.handle_quotegreeks(dict(qg_body), device="cpu")
        diff = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(
            res["buckets"] + [res["product_price"]],
            ref["buckets"] + [ref["product_price"]]))
        log(f"/api/quotegreeks vs the same request on the CPU: max rel diff "
            f"{diff:.2e} (tol 1e-9); cond {res['condition_number']:.3e}")
        check(diff < 1e-9, "quotegreeks card vs CPU")
        lap("surface, quotegreeks")

        # ── /api/localvol ────────────────────────────────────────────────
        flat_iv = np.full_like(smile_iv(), SLV_FLAT_SIGMA).tolist()
        res = ask("localvol flat", dict(lv_body, iv=flat_iv),
                  "/api/localvol")
        r, q = lv_body["r"], lv_body["q"]
        for row in res["chain"]:
            bs = float(bs_price(100.0, row["strike"], lv_body["T"], r, q,
                                SLV_FLAT_SIGMA))
            check(abs(row["price"] - bs) < 3 * row["std_error"],
                  f"flat local vol vs BS at {row['strike']}: {row} vs {bs}")
        log(f"/api/localvol flat {SLV_FLAT_SIGMA}: "
            f"{[round(x['price'], 4) for x in res['chain']]} within 3 se of "
            f"BS")
        lv_res = ask("localvol", lv_body, "/api/localvol")
        # The SSVI-derived surface reprices its own input vols (the JAX
        # package's gate, tests/test_localvol.py: 40 bp over 0.85-1.15 at
        # 300 000 paths x 200 steps a year, T = 0.5).
        shape = dict(rho=-0.7, eta=1.2, gamma=0.4)
        mats = np.array([0.25, 0.5, 1.0])
        ssvi_surf = ssvi.SSVISurface(mats, 0.04 * mats, **shape)
        lv_surf = localvol.LocalVolSurface.from_ssvi(ssvi_surf, 100.0,
                                                     r=0.05, q=0.01)
        eng = localvol.LocalVolEngine(lv_surf,
                                      num_paths=sz["roundtrip_paths"],
                                      num_steps=sz["roundtrip_steps"],
                                      seed=7, device=device)
        ks = np.linspace(85.0, 115.0, 7)
        f = 100.0 * np.exp(0.04 * 0.5)
        target = ssvi_surf.vol(np.log(ks / f), 0.5)
        rt = eng.implied_surface_error(100.0, ks, 0.5, target)
        log(f"local vol from SSVI reprices its IVs over 0.85-1.15: max err "
            f"{rt:.4f} (tol 0.004)")
        check(rt < 0.004, "local-vol IV round trip")
        out["localvol"] = {"flat": res["chain"], "roundtrip_err": rt}

        # ── /api/slv ─────────────────────────────────────────────────────
        res = ask("slv flat", dict(slv_body, iv=flat_iv), "/api/slv")
        flat_rows = []
        for row in res["chain"]:
            bs = float(bs_price(100.0, row["strike"], slv_body["T"], r, q,
                                SLV_FLAT_SIGMA))
            z = (row["price"] - bs) / row["std_error"]
            flat_rows.append((row["strike"], round(z, 2)))
            if 95.0 <= row["strike"] <= 105.0:
                check(abs(z) < 3, f"flat SLV vs BS at {row['strike']}: {z}")
            check(abs(row["price"] - bs) < 4 * row["std_error"] + 0.01 * bs,
                  f"flat SLV vs BS at {row['strike']} (the reference's pin)")
        log(f"/api/slv flat {SLV_FLAT_SIGMA}, xi {slv_body.get('xi', 0.6)}: "
            f"(strike, se from BS) {flat_rows} (3 se at 95-105, 4 se + 1 % "
            f"elsewhere)")
        res = ask("slv xi 0", dict(slv_body, xi=0.0), "/api/slv")
        lv0 = ask("localvol at the slv's steps", dict(
            lv_body, num_paths=sz["slv_paths"],
            num_steps=int(sz["slv_steps"] / lv_body["T"])), "/api/localvol")
        for a, b in zip(res["chain"], lv0["chain"]):
            check(abs(a["price"] - b["price"]) < 3 * np.hypot(
                a["std_error"], b["std_error"]),
                f"SLV at xi = 0 vs local vol at {a['strike']}: {a} vs {b}")
        log(f"/api/slv xi = 0 vs /api/localvol: "
            f"{[(round(a['price'], 4), round(b['price'], 4)) for a, b in zip(res['chain'], lv0['chain'])]}"
            f" within 3 combined se")
        slv_res = ask("slv", slv_body, "/api/slv")
        bar = ask("slv barrier", dict(slv_body, mode="barrier",
                                      barrier=120.0), "/api/slv")
        fwd = ask("slv forward_start", dict(slv_body, mode="forward_start",
                                            t1=0.2), "/api/slv")
        log(f"/api/slv barrier {bar['price']:.4f} ± {bar['std_error']:.4f} "
            f"(hit {bar['hit_fraction']:.3f}), forward_start "
            f"{fwd['price']:.5f} ± {fwd['std_error']:.5f}")
        out["slv"] = {"flat_z": flat_rows, "chain": slv_res["chain"],
                      "barrier": bar["price"], "forward_start": fwd["price"]}
        lap("localvol, slv")

        # ── warm latencies ───────────────────────────────────────────────
        for what, body, path in (("calibrate", cal_body, "/api/calibrate"),
                                 ("surface", surf_body, "/api/surface"),
                                 ("quotegreeks", qg_body, "/api/quotegreeks"),
                                 ("localvol", lv_body, "/api/localvol"),
                                 ("slv", slv_body, "/api/slv")):
            warm(what, body, path)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    lap("warm latencies")

    # Each route but /api/calibrate once more in process under the
    # profiler. A default calibrate is ~700 000 launches, whose profile
    # takes the profiler minutes to summarize on the card's host: its
    # numbers come from `python -m mcos_tpu_torch.profile_price --route
    # calibrate --reps 1`.
    prof = {}
    for what, fn, body in (("surface", server.handle_surface, surf_body),
                           ("quotegreeks", server.handle_quotegreeks,
                            qg_body),
                           ("localvol", server.handle_localvol, lv_body),
                           ("slv", server.handle_slv, slv_body)):
        prof[what] = profiled_call(
            device, lambda fn=fn, body=body: fn(dict(body), device=device))
        pr = prof[what]
        log(f"profiled {what}: wall {pr['profiled_wall_ms']:.1f} ms, device "
            f"{pr['device_ms_per_call']} ms, {pr['kernel_launches_per_call']}"
            f" launches, busy share {pr['busy_share']}, peak "
            f"{pr['peak_gib']:.3f} GiB")
    out["profiles"] = prof
    lap("profiles")

    counts = ck.launch_counts()
    gens = (max(cal.CALIBRATION_CONFIG.stage1_max_iter // 4, 25) + 1
            + max(cal.CALIBRATION_CONFIG.stage2_max_iter // 4, 25) + 1)
    want = gens * n_calibrates
    log(f"launch counts over the calibration path: {counts} (expected K1 "
        f"{want} = {gens} generations x {n_calibrates} calibrations, one "
        f"launch for a generation's {sz['calibrate_members']} members, "
        f"nothing else)")
    for name, n in counts.items():
        check(n == (want if name == "svj_terminal_from_draws" else 0),
              f"{name} launched {n} times on the calibration path")
    out["launches"] = counts
    out["card_vs_cpu"] = slv_card_vs_cpu(device, localvol, slv, SVJParams,
                                         lv_surf)
    out["wall_s"] = time.perf_counter() - t_start
    log(f"calibration path: {out['wall_s']:.1f} s")
    return out


#: Card against CPU: the same engines and seeds at a reduced width; every
#: kernel equals its plain version bit for bit, so the two devices part by
#: float32 rounding of the exp/log/sqrt in the plain versions and of the
#: reductions over paths.
DESK_CARD_CPU_PATHS = 10_000
DESK_CARD_CPU_RTOL = 1e-5


def desk_card_vs_cpu(device, margin, hedge, volderivs, modelrisk_hhw,
                     SVJParams):
    """Margin's price table (3 K3 launches), an Asian replicate (1 K6), the
    VIX MC check (1 K4) and modelrisk's HHW leg (1 K7) on the card against
    the same engines on the CPU, same seeds, DESK_CARD_CPU_PATHS paths."""
    n = DESK_CARD_CPU_PATHS
    params = SVJParams()
    out = {}

    def both(what, fn):
        a, b = fn(device), fn("cpu")
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))
        log(f"card vs CPU, {what}: max rel diff {err:.3e} (rtol "
            f"{DESK_CARD_CPU_RTOL:g})")
        check(err < DESK_CARD_CPU_RTOL, f"card vs CPU: {what}")
        out[what] = err

    strikes = np.array([21000.0, 22500.0, 24000.0])
    both("margin price table (3 K3 launches)", lambda d: margin.MarginEngine(
        params, num_paths=n, device=d).price_table(
            SPOT, strikes, np.full(3, 0.25), np.array([False, True, True])))

    def rep(d):
        r = hedge.StaticHedgeEngine(params, num_paths=n, device=d).replicate(
            SPOT, 0.25, kind="asian", strike=SPOT)
        return [r["target_price_mc"], r["hedge_value"], r["r2"],
                r["resid_std"]]

    both("replicate asian (1 K6 launch)", rep)
    both("VIX MC check (1 K4 launch)", lambda d: volderivs.VolDerivsEngine(
        params, num_paths=n, device=d).vix_future_mc(0.5)["future_mc"])
    both("modelrisk HHW leg (1 K7 launch)", lambda d: [
        modelrisk_hhw(d, n)["price"]])
    return out


def desk_path(device, ck, server, cos_price, bs_price, bs_all_greeks,
              SVJParams, gbm_params):
    """Slice J over HTTP on a fresh server, with the launch counts set to 0
    just before: `/api/pnl` (host), `/api/margin` (three K3 launches a
    maturity group), `/api/replicate` (one K6), `/api/volderivs` (one K4 a
    `with_mc_check`; the swaps a step loop), `/api/book` and
    `/api/exposure` (step loops under autograd, no kernel) and
    `/api/modelrisk` (one K7); each request's launches checked against
    those counts, every other kernel at 0."""
    from scipy.stats import norm

    from mcos_tpu_torch.engine import hedge, margin, volderivs
    from mcos_tpu_torch.engine.hhw import HHWEngine
    from mcos_tpu_torch.engine.pricer import MonteCarloEngine
    from mcos_tpu_torch.ops.hhw import HHWParams
    from mcos_tpu_torch.profile_price import ROUTE_BODIES

    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    want = dict.fromkeys(ck.launch_counts(), 0)
    out = {"requests": {}}

    def counted(what, n, fn):
        """fn() must launch exactly n = {kernel: launches} and no other
        kernel."""
        before = ck.launch_counts()
        res = fn()
        after = ck.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        exp = {k: n.get(k, 0) for k in after}
        check(got == exp, f"{what}: launches {got}, expected {exp}")
        for k, v in n.items():
            want[k] += v
        return res

    def ask(what, path, body, n=None):
        status, res, ms = counted(what, n or {},
                                  lambda: post(base, body, path=path))
        check(status == 200, f"{what}: status {status}")
        check(all_finite(res), f"{what}: every number finite")
        out["requests"][what] = {"latency_ms": ms,
                                 "elapsed_ms": res.get("elapsed_ms")}
        return res

    def refused(what, path, body, code=400):
        try:
            post(base, body, path=path)
            check(False, f"{what} must answer {code}")
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())["detail"]
            check(e.code == code, f"{what}: {e.code} {detail!r}")
            log(f"{path} {what}: {code} {str(detail)[:80]!r}")

    def lap(what):
        log(f"  [{what}: {time.perf_counter() - t_start:.1f} s into the "
            f"path]")

    B = ROUTE_BODIES
    gbm = {"kappa": 0.0, "theta": 0.04, "xi": 0.0, "rho": 0.0, "v0": 0.04,
           "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.0, "r": 0.065,
           "q": 0.012}
    K6, K4, K7 = ({"svj_path_stats": 1}, {"svj_terminal_qe": 1},
                  {"hhw_terminal": 1})
    try:
        # ── /api/pnl: host COS, equal to the CPU's ───────────────────────
        res = ask("pnl", "/api/pnl", B["pnl"])
        check(abs(res["explained"] + res["unexplained"] - res["total_pnl"])
              < 1e-9, "pnl: explained + unexplained is the total")
        cpu = server.handle_pnl(dict(B["pnl"]), device="cpu")
        check(all(res[k] == cpu[k] for k in ("total_pnl", "explained",
                                              "unexplained")),
              "pnl equal to the CPU's")
        log(f"/api/pnl: total {res['total_pnl']:.4f} = explained "
            f"{res['explained']:.4f} + unexplained {res['unexplained']:.2e}")

        # ── /api/margin: 3 K3 launches a maturity group ──────────────────
        res = ask("margin", "/api/margin", B["margin"], {"svj_terminal": 6})
        log(f"/api/margin default (4 positions, 2 maturities, 200000 "
            f"pairs): margin {res['margin']:.2f}, worst "
            f"{res['worst_scenario']!r}")
        one = {"spot": SPOT, "Ts": [0.5], "params": gbm}
        m3 = {"svj_terminal": 3}
        hedged = ask("margin hedged", "/api/margin", {
            "spot": SPOT, "strikes": [SPOT, SPOT], "Ts": [0.5, 0.5],
            "is_calls": [True, True], "quantities": [5.0, -5.0]}, m3)
        check(hedged["margin"] == 0.0 and all(
            abs(x) < 1e-9 for x in hedged["risk_array"]),
            "a hedged book margins to zero")
        sc = ask("margin short call", "/api/margin", dict(
            one, strikes=[SPOT], is_calls=[True], quantities=[-1.0]), m3)
        sp = ask("margin short put", "/api/margin", dict(
            one, strikes=[SPOT], is_calls=[False], quantities=[-1.0]), m3)
        lc = ask("margin long call", "/api/margin", dict(
            one, strikes=[SPOT], is_calls=[True], quantities=[1.0]), m3)
        check(sc["margin"] > 0 and "price+" in sc["worst_scenario"],
              "short call: worst scenario up")
        check(sp["margin"] > 0 and "price-" in sp["worst_scenario"],
              "short put: worst scenario down")
        check(0.0 <= lc["margin"] <= lc["net_option_value"] + 1e-9,
              "long call margin bounded by its premium")
        a = ask("margin put leg", "/api/margin", dict(
            one, strikes=[0.95 * SPOT], is_calls=[False],
            quantities=[-2.0]), m3)
        b = ask("margin call leg", "/api/margin", dict(
            one, strikes=[1.05 * SPOT], is_calls=[True],
            quantities=[-3.0]), m3)
        both = ask("margin strangle", "/api/margin", dict(
            one, strikes=[0.95 * SPOT, 1.05 * SPOT], Ts=[0.5, 0.5],
            is_calls=[False, True], quantities=[-2.0, -3.0]), m3)
        check(both["margin"] < a["margin"] + b["margin"] - 1e-6,
              "margin strictly subadditive on a strangle")
        # The scan identity: the worst scenario of a short call under GBM
        # against moving the spot (two more K3 prices, independent paths).
        direct = counted("scan identity", {"svj_terminal": 2}, lambda: (
            MonteCarloEngine(margin._vol_shift(gbm_params(0.2, 0.065, 0.012),
                                               0.04),
                             num_paths=200_000, num_steps=252, seed=5,
                             use_sobol=False, device=device).price(
                SPOT * 1.06, SPOT, 0.5)["price"]
            - MonteCarloEngine(gbm_params(0.2, 0.065, 0.012),
                               num_paths=200_000, num_steps=252, seed=5,
                               use_sobol=False, device=device).price(
                SPOT, SPOT, 0.5)["price"]))
        check(abs(sc["margin"] - direct) < 0.05 * direct,
              f"scan identity: {sc['margin']} vs {direct}")
        log(f"/api/margin oracles: hedged 0, short call {sc['margin']:.2f} "
            f"({sc['worst_scenario']}) vs moving the spot {direct:.2f}, "
            f"short put {sp['margin']:.2f} ({sp['worst_scenario']}), "
            f"strangle {both['margin']:.2f} < {a['margin']:.2f} + "
            f"{b['margin']:.2f}")
        refused("unequal lengths", "/api/margin",
                dict(B["margin"], quantities=[1.0]))
        lap("margin")

        # ── /api/replicate: 1 K6 launch ──────────────────────────────────
        res = ask("replicate", "/api/replicate", B["replicate"], K6)
        log(f"/api/replicate default digital (200000 pairs): R2 "
            f"{res['r2']:.4f}, hedge {res['hedge_value']:.5f} vs MC "
            f"{res['target_price_mc']:.5f} ± {res['target_se']:.5f}")
        ks = (np.linspace(0.9, 1.1, 5) * SPOT).tolist()
        van = ask("replicate vanilla", "/api/replicate", dict(
            B["replicate"], kind="vanilla", hedge_strikes=ks), K6)
        cos_atm = float(cos_price(SVJParams(), SPOT, [SPOT], 0.25)[0])
        check(van["r2"] > 0.999999 and abs(van["hedge_value"] - cos_atm)
              < 2e-3 * cos_atm, "vanilla replicates itself")
        dig = ask("replicate digital dense", "/api/replicate", dict(
            B["replicate"], hedge_strikes=(np.linspace(0.94, 1.06, 13)
                                           * SPOT).tolist()), K6)
        w = np.asarray(dig["weights"]["calls"])
        check(dig["r2"] > 0.93 and abs(w.sum()) < 0.05 * np.abs(w).max()
              and abs(dig["hedge_value"] - dig["target_price_mc"])
              < 6 * dig["target_se"] + 0.01, "digital as a call spread")
        gd = ask("replicate GBM digital", "/api/replicate", dict(
            B["replicate"], params=gbm, hedge_strikes=(
                np.linspace(0.92, 1.08, 17) * SPOT).tolist()), K6)
        d2 = (0.065 - 0.012 - 0.02) * 0.25 / (0.2 * 0.5)
        bs_dig = float(np.exp(-0.065 * 0.25) * norm.cdf(d2))
        check(abs(gd["target_price_mc"] - bs_dig) < 4 * gd["target_se"]
              and abs(gd["hedge_value"] - bs_dig) < 0.02 * bs_dig + 5e-3,
              f"GBM digital: {gd['target_price_mc']}, {gd['hedge_value']} "
              f"vs {bs_dig}")
        log(f"/api/replicate oracles: vanilla R2 {van['r2']:.8f}, hedge "
            f"{van['hedge_value']:.3f} vs COS {cos_atm:.3f}; dense digital "
            f"R2 {dig['r2']:.4f}; GBM digital MC {gd['target_price_mc']:.5f}"
            f", hedge {gd['hedge_value']:.5f} vs BS {bs_dig:.5f}")
        for what, bad in (("digital strike 0", {"strike": 0.0}),
                          ("barrier 0", {"kind": "barrier"}),
                          ("fixed lookback strike 0",
                           {"kind": "lookback", "strike": 0.0})):
            refused(what, "/api/replicate", dict(B["replicate"], **bad))
        lap("replicate")

        # ── /api/volderivs: step loop; 1 K4 a with_mc_check ──────────────
        res = ask("variance swap", "/api/volderivs", B["volderivs"])
        check(res["mc_vs_closed_sigmas"] < 4.0, "variance swap pin")
        vol = ask("vol swap GBM", "/api/volderivs", dict(
            B["volderivs"], kind="vol_swap", T=0.5, params=dict(
                gbm, v0=0.0625, theta=0.0625)))
        check(abs(vol["fair_vol_strike"] - (0.25 - 0.25 * 2 / (8 * 126)))
              < 2e-3 and 0.0 < vol["convexity_discount"] < 5e-3,
              "vol swap under GBM")
        fut = ask("vix future + mc check", "/api/volderivs", {
            "kind": "vix_future", "T": 0.5, "with_mc_check": True}, K4)
        mc = fut["mc_check"]
        check(abs(mc["future_mc"] - fut["future"]) < 4 * mc["std_error"]
              + 2e-3, "VIX MC check against the quadrature")
        c = ask("vix call", "/api/volderivs", {"kind": "vix_option",
                                                "T": 0.5, "strike": 0.2})
        pt = ask("vix put", "/api/volderivs", {
            "kind": "vix_option", "T": 0.5, "strike": 0.2,
            "is_call": False})
        check(abs(c["price"] - pt["price"] - c["discount_factor"]
                  * (fut["future"] - 0.2)) < 1e-10, "VIX parity")
        log(f"/api/volderivs: variance swap {res['mc_fair_variance']:.5f} vs"
            f" {res['fair_variance']:.5f} ({res['mc_vs_closed_sigmas']:.2f}"
            f" se); GBM vol swap {vol['fair_vol_strike']:.5f}; VIX future "
            f"{fut['future']:.5f}, MC {mc['future_mc']:.5f} ± "
            f"{mc['std_error']:.5f}")
        refused("vix_option without strike", "/api/volderivs",
                {"kind": "vix_option", "T": 0.5})
        lap("volderivs")

        # ── /api/book: no kernel ─────────────────────────────────────────
        res = ask("book", "/api/book", B["book"])
        gb = {"spots": [SPOT, SPOT, SPOT, 18000.0],
              "strikes": [SPOT, 21000.0, 24000.0, 18500.0],
              "Ts": [0.1, 0.25, 0.5, 0.08],
              "is_calls": [True, True, False, False], "params": gbm}
        g = ask("book GBM", "/api/book", gb)
        for i in range(4):
            ref = bs_all_greeks(gb["spots"][i], gb["strikes"][i],
                                gb["Ts"][i], 0.065, 0.012, 0.2,
                                gb["is_calls"][i])
            ref = {k: float(v) for k, v in ref.items()}
            check(abs(g["price"][i] - ref["price"])
                  < max(4 * g["std_error"][i], 0.01 * ref["price"] + 0.5)
                  and abs(g["delta"][i] - ref["delta"]) < 0.02
                  and abs(g["theta"][i] - ref["theta"])
                  < 0.1 * abs(ref["theta"])
                  and abs(g["vega"][i] - ref["vega"])
                  < 0.05 * abs(ref["vega"])
                  and abs(g["rho"][i] - ref["rho"]) < 0.05 * abs(ref["rho"]),
                  f"book GBM position {i} against bs_all_greeks")
        flat = ask("book flat", "/api/book", dict(
            gb, spots=[SPOT] * 2, strikes=[SPOT] * 2, Ts=[0.25] * 2,
            is_calls=[True, True], quantities=[1.0, -1.0]))
        check(abs(flat["book_value"]) < 1e-4 * SPOT
              and abs(flat["book_delta"]) < 1e-6, "a flat book nets to 0")
        log(f"/api/book default (8 positions x 100000 paths x 64 steps): "
            f"value {res['book_value']:.2f}, delta {res['book_delta']:.4f}; "
            f"GBM positions within the bs_all_greeks bands")
        refused("unequal lengths", "/api/book", dict(B["book"], Ts=[0.1]))
        lap("book")

        # ── /api/exposure: no kernel ─────────────────────────────────────
        res = ask("exposure", "/api/exposure", dict(
            B["exposure"], with_cva_delta=True, wwr_gamma=1.0))
        one_a = {"spots": [100.0], "sigmas": [0.25], "corr": [[1.0]],
                 "r": 0.05, "q": [0.0], "num_paths": 200_000}
        fwd = ask("exposure forward", "/api/exposure", dict(
            one_a, positions=[{"kind": "forward", "strike": 100.0,
                               "T": 1.0}], num_dates=4, hazard_rate=0.0))
        t = np.asarray(fwd["dates"])
        s_ = 0.25 * np.sqrt(t)
        f_mean = 100.0 * np.exp(0.05)
        d1 = (np.log(f_mean / 100.0) + 0.5 * s_**2) / s_
        black = np.exp(-0.05 * (1.0 - t)) * (f_mean * norm.cdf(d1)
                                              - 100.0 * norm.cdf(d1 - s_))
        check(np.allclose(fwd["ee"], black, rtol=0.02),
              f"forward EE vs Black: {fwd['ee']} vs {black}")
        call_pos = [{"kind": "call", "strike": 100.0, "T": 1.0}]
        cva = ask("exposure call CVA", "/api/exposure", dict(
            one_a, positions=call_pos, num_dates=16, hazard_rate=0.03))
        c0 = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.0, 0.25))
        oracle = 0.6 * c0 * (1.0 - np.exp(-0.03))
        # The reference's pin takes a horizon of 0.999 T; at T the last
        # bucket holds the intrinsic value, the same expectation.
        check(abs(cva["credit"]["cva"] - oracle) < 0.01 * oracle,
              f"call CVA {cva['credit']['cva']} vs {oracle}")
        d = ask("exposure cva delta", "/api/exposure", dict(
            one_a, positions=call_pos, num_paths=100_000, num_dates=8,
            hazard_rate=0.03, with_cva_delta=True))
        up, dn = (ask(f"exposure cva {s}", "/api/exposure", dict(
            one_a, spots=[100.0 + h], positions=call_pos, num_paths=100_000,
            num_dates=8, hazard_rate=0.03)) for s, h in (("up", 0.5),
                                                          ("down", -0.5)))
        fd = (up["credit"]["cva"] - dn["credit"]["cva"]) / 1.0
        check(abs(d["cva_delta"][0] - fd) < 1e-4,
              f"cva_delta {d['cva_delta'][0]} vs CRN FD {fd}")
        log(f"/api/exposure default: EPE {res['epe']:.2f}, CVA "
            f"{res['credit']['cva']:.4f}, WWR {res['credit']['wwr']['cva']:.4f}"
            f", cva_delta {res['cva_delta']}; forward EE vs Black max rel "
            f"{np.max(np.abs(np.asarray(fwd['ee']) / black - 1)):.2e}; call "
            f"CVA {cva['credit']['cva']:.5f} vs {oracle:.5f}; cva_delta "
            f"{d['cva_delta'][0]:.6f} vs CRN FD {fd:.6f}")
        refused("no positions", "/api/exposure",
                dict(B["exposure"], positions=[]))
        refused("corr not positive definite", "/api/exposure", dict(
            B["exposure"], corr=[[1.0, 1.2], [1.2, 1.0]]), code=500)
        lap("exposure")

        # ── /api/modelrisk: 1 K7 launch ──────────────────────────────────
        res = ask("modelrisk", "/api/modelrisk", B["modelrisk"], K7)
        p = res["prices"]
        ivs = res["implied_vols"]
        check(p["heston"] > p["bs"] and p["svj"] > p["heston"]
              and p["rough"] > p["bs"] and res["model_risk_band_volpts"]
              > 0.01 and all(v is not None for v in ivs.values())
              and abs(res["model_risk_band_volpts"]
                      - (max(ivs.values()) - min(ivs.values()))) < 1e-12,
              f"modelrisk OTM put premia: {p}")
        log(f"/api/modelrisk default OTM put: prices "
            f"{ {k: round(v, 3) for k, v in p.items()} }, band "
            f"{res['model_risk_band_volpts']:.4f} vol points")
        lap("modelrisk")

        # ── warm latencies: median of 3 over HTTP ────────────────────────
        for route, n in (("pnl", None), ("margin", {"svj_terminal": 6}),
                         ("replicate", K6), ("volderivs", None),
                         ("book", None), ("exposure", None),
                         ("modelrisk", K7)):
            lat = []
            for _ in range(3):
                before = time.perf_counter()
                ask(f"warm {route}", f"/api/{route}", B[route], n)
                lat.append((time.perf_counter() - before) * 1e3)
            out[f"warm_{route}_ms"] = statistics.median(lat)
            log(f"warm /api/{route}: median {statistics.median(lat):.2f} ms"
                f" over 3 ({[round(x, 2) for x in lat]})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    lap("warm latencies")

    # Each route once in process under the profiler, its peak device
    # memory from the same (warm) call: the profiler's buffers are host
    # memory, and a loop route's ~30 000 events take it seconds to sum.
    from mcos_tpu_torch.profile_price import _profiled

    def profiled_once(call):
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        res = _profiled(call, 1)
        return dict(res, peak_gib=(torch.cuda.max_memory_allocated(device)
                                   - held) / 2**30)

    prof = {}
    for route, n in (("pnl", {}), ("margin", {"svj_terminal": 6}),
                     ("replicate", K6), ("volderivs", {}), ("book", {}),
                     ("exposure", {}), ("modelrisk", K7)):
        fn = getattr(server, f"handle_{route}")
        prof[route] = counted(f"profiled {route}", n, lambda fn=fn, route=route:
                              profiled_once(lambda: fn(dict(B[route]),
                                                       device=device)))
        pr = prof[route]
        log(f"profiled {route}: wall {pr['profiled_wall_ms']:.1f} ms, device "
            f"{pr['device_ms_per_call']} ms, {pr['kernel_launches_per_call']}"
            f" launches, busy share {pr['busy_share']}, peak "
            f"{pr['peak_gib']:.3f} GiB")
    out["profiles"] = prof
    # The margin of a 4 096-position book (MAX_BOOK_POSITIONS) at 200 000
    # pairs in one maturity: its strike table reduced in chunks.
    big = {"spot": SPOT,
           "strikes": (np.linspace(0.7, 1.3, 4096) * SPOT).tolist(),
           "Ts": [0.25] * 4096, "is_calls": [True, False] * 2048,
           "quantities": [1.0, -1.0] * 2048}
    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = counted("margin 4096 positions", {"svj_terminal": 3},
                  lambda: server.handle_margin(dict(big), device=device))
    big_ms = (time.perf_counter() - t0) * 1e3
    big_gib = (torch.cuda.max_memory_allocated(device) - held) / 2**30
    check(np.isfinite(res["margin"]), "4096-position margin finite")
    out["margin_4096"] = {"ms": big_ms, "peak_gib": big_gib}
    log(f"/api/margin at 4096 positions x 9 factors (36 864 strikes) x "
        f"200000 pairs: {big_ms:.1f} ms, peak device memory {big_gib:.3f} "
        f"GiB (payoff chunks of {margin._PAYOFF_CHUNK_BYTES >> 20} MiB)")
    lap("profiles, 4096-position margin")

    def hhw_leg(d, n):
        # modelrisk's HHW leg at the default anchor (atm_vol 0.2).
        return HHWEngine(HHWParams(kappa=3.0, theta=0.04, xi=0.5, v0=0.04,
                                   a=0.1, b=0.065, sigma_r=0.01, r0=0.065,
                                   rho_sv=-0.7, rho_sr=0.3, q=0.012),
                         num_paths=n, num_steps=96, seed=7,
                         device=d).price(SPOT, SPOT, 0.25, True)

    out["card_vs_cpu"] = counted(
        "card vs CPU", {"svj_terminal": 3, "svj_path_stats": 1,
                        "svj_terminal_qe": 1, "hhw_terminal": 1},
        lambda: desk_card_vs_cpu(device, margin, hedge, volderivs, hhw_leg,
                                 SVJParams))
    counts = ck.launch_counts()
    log(f"launch counts over the desk path: {counts} (expected {want}: K3 "
        f"3 a margin maturity group, K6 1 a replicate, K4 1 a VIX MC check,"
        f" K7 1 a modelrisk, nothing else)")
    check(counts == want, "desk path launch counts")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"desk path: {out['wall_s']:.1f} s")
    return out


#: Slice K: the schemas' path count (BasketRequest, CliquetRequest,
#: QuantoRequest, AutocallRequest default) and the card-against-CPU width.
MULTI_PATHS = 200_000
MULTI_CARD_CPU_PATHS = 20_000
#: The widest bodies the schemas allow: a basket of 64 assets, a worst-of
#: autocall of 16, a bracket of 16 384 outer × 512 inner paths.
WIDE_BASKET_ASSETS, WIDE_WORST_ASSETS, WIDE_BRACKET = 64, 16, (16384, 512)
#: The Broadie-Glasserman world: GBM at σ = 20 %, r = 5 %, q = 10 %, ρ = 0.
BG_GBM = {"kappa": 0.0, "theta": 0.04, "xi": 0.0, "rho": 0.0, "v0": 0.04,
          "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.0, "r": 0.05,
          "q": 0.10}
#: The reference tests' bands for the 9-right max call (Andersen-Broadie
#: 2004's duality midpoints 8.08 / 13.90 / 21.34).
BG_BANDS = ((90.0, 7.95, 8.20), (100.0, 13.75, 14.05), (110.0, 21.15, 21.50))


def shared_draws(seed, steps, shape, device):
    """(CPU draws, the same on the card): (steps, 3, *shape) normals and
    (steps, *shape) uniforms from a CPU generator."""
    from mcos_tpu_torch.engine.pricer import seeded_generator

    gen = seeded_generator(seed, "cpu")
    z = torch.randn((steps, 3, *shape), generator=gen)
    u = torch.rand((steps, *shape), generator=gen)
    return (z, u), (z.to(device), u.to(device))


def agree(what, a, b, rtol, atol=0.0) -> float:
    """Check |a − b| ≤ atol + rtol·|b| everywhere (a on the card, b on the
    CPU); returns the largest |a − b| / (atol + rtol·|b|)."""
    a = np.asarray(torch.as_tensor(a).cpu(), np.float64)
    b = np.asarray(torch.as_tensor(b).cpu(), np.float64)
    ratio = float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b) + 1e-300)))
    log(f"card vs CPU, {what}: max |card - CPU| {np.max(np.abs(a - b)):.3e}"
        f" ({ratio:.3f} of rtol {rtol:g} + atol {atol:g})")
    check(ratio <= 1.0, f"card vs CPU: {what}")
    return ratio


def multiasset_card_vs_cpu(device, cl, qu, bk, ba, ac, american,
                           SVJParams, gbm_params):
    """Every slice K program on the card against the CPU on the same draws
    (CPU generator, copied to the card): the period loop, the quanto
    terminal, the basket terminal and states, each engine's price, the
    note, the LSM's fixed-policy lower bound and the dual (rtol 1e-5, the
    dual 1e-4), and the in-sample LSM at 200 000 paths, multi-asset and
    single-asset, with its exercise flips counted."""
    n = MULTI_CARD_CPU_PATHS
    p = SVJParams()
    out = {}
    cpu, card = shared_draws(21, 64, (n,), device)
    out["period_returns"] = [agree(
        f"period log returns {w} (4 x 16 steps, {n} paths)", a, b,
        1e-5, 1e-6) for w, a, b in zip(("S", "G"), *(
            cl.simulate_period_log_returns(
                p, 1.0, None, num_paths=n, n_periods=4, steps_per_period=16,
                draws=d) for d in (card, cpu)))]
    out["quanto_terminal"] = [agree(
        f"quanto terminal {w} (64 steps)", a, b, 1e-5) for w, a, b in zip(
            ("S", "G"), *(qu._quanto_terminal(
                p, 100.0, 1.0, 0.03, 0.12, -0.4, None, num_paths=n,
                num_steps=64, draws=d) for d in (card, cpu)))]
    fields = [{}, {"v0": 0.06, "rho": -0.3, "lambda_j": 2.0},
              {"kappa": 1.5, "xi": 0.7, "q": 0.03}]
    params3 = [SVJParams(**f) for f in fields]
    corr3 = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.35], [0.2, 0.35, 1.0]])
    chol = np.linalg.cholesky(corr3).astype(np.float32)
    batch = bk._stack_params(params3)
    cpu3, card3 = shared_draws(22, 32, (3, n), device)
    out["basket_terminal"] = [agree(
        f"basket terminal {w} (3 assets, 32 steps)", a, b, 1e-5)
        for w, a, b in zip(("S", "G"), *(bk.simulate_basket_terminal(
            batch, [100.0, 50.0, 200.0], chol, 0.5, None, num_paths=n,
            num_steps=32, draws=d) for d in (card3, cpu3)))]
    out["basket_states"] = [agree(
        f"basket states {w} (3 assets, 4 x 8 steps)", a, b, 1e-5, atol)
        for w, a, b, atol in zip(("levels", "v"), *(
            bk.simulate_basket_states(
                batch, [100.0, 50.0, 200.0], chol, 0.5, None, num_paths=n,
                n_obs=4, steps_per_period=8, draws=d)
            for d in (card3, cpu3)), (0.0, 1e-6))]

    cpu_w, card_w = shared_draws(28, 64, (3, n), device)

    def engine_prices(d1, d3, dev):
        """The basket, cliquet and quanto engines' results on shared draws
        (their replay hooks): d1 one asset × 64 steps, d3 three assets ×
        32 steps."""
        res = {}
        eng = bk.BasketEngine(params3, corr3, num_paths=n, num_steps=64,
                              device=dev)
        eng._draws = lambda k, steps: d3
        res["basket"] = eng.price([100.0, 50.0, 200.0], [0.5, 0.3, 0.2],
                                  110.0, 0.5)
        eng = cl.CliquetEngine(p, num_paths=n, device=dev)
        eng._draws = lambda steps: d1
        res["cliquet"] = eng.price_cliquet(1.0)
        eng = qu.QuantoEngine(p, 0.03, 0.12, -0.4, num_paths=n, device=dev)
        eng._draws = lambda steps: d1
        res["quanto"] = eng.price(100.0, 100.0, 1.0)
        return res

    def note_values(d1, d3w):
        """Per-pair note values, single-asset and worst-of, default
        terms."""
        ratio = torch.exp(torch.cumsum(cl.simulate_period_log_returns(
            p, 1.0, None, num_paths=n, n_periods=4, steps_per_period=16,
            companion=False, draws=d1)[0], dim=0))
        levels = bk.simulate_basket_observations(
            batch, np.ones(3, np.float32), chol, 1.0, None, num_paths=n,
            n_obs=4, steps_per_period=16, draws=d3w)
        terms = (1.0, float(p.r), 4, 1.0, 0.8, 0.7, 0.02, 0.08, 1.0)
        return [ac._note_path_values(x, *terms)[0].cpu()
                for x in (ratio, torch.amin(levels, dim=2))]

    got = engine_prices(card, card3, device)
    ref = engine_prices(cpu, cpu3, "cpu")
    # A note's payoff jumps at its barriers: a path within rounding of one
    # takes another leg on the card (counted), every other path agrees.
    out["notes"] = {}
    for name, a, b in zip(("single-asset", "worst-of"),
                          note_values(card, card_w), note_values(cpu, cpu_w)):
        jump = (a - b).abs() > 1e-3
        check(int(jump.sum()) <= 0.001 * n,
              f"{name} note flips {int(jump.sum())}")
        out["notes"][name] = {"barrier_flips": int(jump.sum()),
                              "agree": agree(
                                  f"{name} note pair values "
                                  f"({int(jump.sum())} barrier flips aside)",
                                  a[~jump], b[~jump], 1e-5, 1e-7)}
    out["engines"] = {}
    for name in ref:
        keys = [k for k, v in ref[name].items()
                if isinstance(v, float) and k != "cv_beta"]
        out["engines"][name] = agree(
            f"{name} engine ({', '.join(keys)})",
            [got[name][k] for k in keys], [ref[name][k] for k in keys],
            1e-5, 1e-9)

    # The Broadie-Glasserman max call at the route's width, in sample on
    # the same draws: a path's cashflow that moves by more than rounding
    # is a flipped exercise decision.
    gbm2 = [gbm_params(0.2, r=0.05, q=0.10)] * 2
    b2 = bk._stack_params(gbm2)
    eye = np.eye(2, dtype=np.float32)
    cpu2, card2 = shared_draws(23, 9, (2, MULTI_PATHS), device)
    lsm = {}
    for name, d, dev in (("card", card2, device), ("cpu", cpu2, "cpu")):
        spots, strike, w = ba._prepare([100.0, 100.0], 100.0, None, dev)
        sheet = ba._sheet(b2, spots, eye, 3.0, None, num_paths=MULTI_PATHS,
                          n_ex=9, steps_per_period=1, draws=d, device=dev)
        pay = ba._ma_payoff_fn(strike, "max", True, w)
        basis = ba._ma_basis_fn(strike, "max", True, w)
        sdf = torch.exp(-torch.tensor(0.05, device=dev)
                        * torch.tensor(3.0, device=dev) / 9).expand(9)
        cf = american.lsm_backward_cashflows(
            pay(sheet[-1]), sheet, sheet, np.ones(8, bool), sdf, pay, basis)
        pairs = 0.5 * (cf[:MULTI_PATHS] + cf[MULTI_PATHS:])
        lsm[name] = {"cf": cf.cpu(), "price": float(pairs.mean()),
                     "se": float(pairs.std(correction=0))
                     / np.sqrt(MULTI_PATHS),
                     "coefs": ba.lsm_basket_train(
                         b2, [100.0, 100.0], eye, 100.0, 3.0, 0.05, None,
                         num_paths=MULTI_PATHS, n_ex=9, steps_per_period=1,
                         kind="max", is_call=True, draws=d, device=dev)}
    flips = int(((lsm["card"]["cf"] - lsm["cpu"]["cf"]).abs()
                 > 1e-3 * float(lsm["cpu"]["cf"].abs().max())).sum())
    log(f"multi-asset LSM (max call, 2 x {MULTI_PATHS} paths, 9 rights) in"
        f" sample: card {lsm['card']['price']:.5f} vs CPU "
        f"{lsm['cpu']['price']:.5f} (se {lsm['cpu']['se']:.5f}); {flips} of"
        f" {2 * MULTI_PATHS} paths' exercise dates differ")
    check(abs(lsm["card"]["price"] - lsm["cpu"]["price"])
          < 0.5 * lsm["cpu"]["se"], "multi-asset in-sample LSM card vs CPU")
    check(flips <= 0.03 * 2 * MULTI_PATHS, f"multi-asset LSM flips {flips}")
    out["basket_lsm"] = {"card": lsm["card"]["price"],
                         "cpu": lsm["cpu"]["price"], "se": lsm["cpu"]["se"],
                         "flips": flips, "paths": 2 * MULTI_PATHS}

    # The CPU's fitted policy and value function on both devices.
    coefs = lsm["cpu"]["coefs"]
    cpu_e, card_e = shared_draws(24, 9, (2, n), device)
    lb = [ba._lower_bound_pairs(
        b2, [100.0, 100.0], eye, 100.0, 3.0, 0.05, None,
        coefs["policy"].to(dev), num_paths=n, n_ex=9, steps_per_period=1,
        kind="max", is_call=True, draws=d, device=dev)
        for d, dev in ((card_e, device), (cpu_e, "cpu"))]
    lb_flips = int(((lb[0].cpu() - lb[1]).abs()
                    > 1e-3 * float(lb[1].abs().max())).sum())
    check(lb_flips <= 0.001 * n, f"fixed-policy flips card vs CPU {lb_flips}")
    out["lower_bound_flips"] = lb_flips
    keep = ((lb[0].cpu() - lb[1]).abs()
            <= 1e-3 * float(lb[1].abs().max()))
    out["lower_bound"] = agree(
        f"fixed-policy lower bound, pairs ({lb_flips} flips aside)",
        lb[0].cpu()[keep], lb[1][keep], 1e-5, 1e-7 * 100.0)
    n_outer, half = 2048, 32
    cpu_o, card_o = shared_draws(25, 9, (2, n_outer), device)
    gen = torch.Generator().manual_seed(26)
    zh = torch.randn((9, 1, 3, half, 2, 2 * n_outer), generator=gen)
    uh = torch.rand((9, 1, half, 2, 2 * n_outer), generator=gen)
    dual = [ba._dual_pairs(
        b2, [100.0, 100.0], eye, 100.0, 3.0, 0.05, None,
        coefs["value"].to(dev), n_outer=n_outer, n_inner=2 * half, n_ex=9,
        steps_per_period=1, kind="max", is_call=True, draws=d,
        inner_draws=(zh.to(dev), uh.to(dev)), device=dev)
        for d, dev in ((card_o, device), (cpu_o, "cpu"))]
    out["dual"] = agree(f"dual pairs ({n_outer} x {2 * half}, 9 dates)",
                        dual[0], dual[1], 1e-4, 1e-7 * 100.0)

    # The single-asset LSM at /api/american's width: a put, 200 000 paths
    # x 64 steps, in sample on the same draws.
    cpu_a, card_a = shared_draws(27, 64, (MULTI_PATHS,), device)
    am = {}
    for name, d in (("card", card_a), ("cpu", cpu_a)):
        strike, s_ex, s_cum = american._sheets(
            p, 100.0, 100.0, 1.0, None, num_paths=None, num_steps=None,
            div_grid=None, div_kind="cash", rate_offsets=None,
            td_table=None, draws=d, device=d[0].device)
        pay = american._payoff_fn(strike, False)
        cf = american.lsm_backward_cashflows(
            pay(s_ex[-1]), s_cum, s_ex, american._exercise_mask(64, 1),
            american._step_dfs(p, 1.0, 64, None, s_ex.device), pay,
            american._basis_fn(strike, False, 3))
        am[name] = {"cf": cf.cpu(), "price": float(cf.mean()),
                    "se": float(cf.std(correction=0)) / np.sqrt(MULTI_PATHS)}
    am_flips = int(((am["card"]["cf"] - am["cpu"]["cf"]).abs()
                    > 1e-3 * float(am["cpu"]["cf"].abs().max())).sum())
    log(f"single-asset LSM (put, {MULTI_PATHS} paths x 64 steps) in sample:"
        f" card {am['card']['price']:.5f} vs CPU {am['cpu']['price']:.5f} "
        f"(se {am['cpu']['se']:.5f}); {am_flips} of {MULTI_PATHS} paths' "
        f"exercise dates differ")
    check(abs(am["card"]["price"] - am["cpu"]["price"])
          < 0.5 * am["cpu"]["se"], "single-asset in-sample LSM card vs CPU")
    check(am_flips <= 0.03 * MULTI_PATHS, f"single-asset flips {am_flips}")
    out["american_lsm"] = {"card": am["card"]["price"],
                           "cpu": am["cpu"]["price"], "se": am["cpu"]["se"],
                           "flips": am_flips, "paths": MULTI_PATHS}
    return out


def multiasset_path(device, ck, server, bs_price, SVJParams, gbm_params):
    """Slice K over HTTP on a fresh server, with the launch counts set to 0
    just before: `/api/cliquet`, `/api/quanto`, `/api/basket` (European
    payoffs, the implied correlation, the Bermudan and its bracket) and
    `/api/autocall` at the schemas' widths against their oracles, the
    400s, warm latencies, the default bodies once under the profiler, the
    wide bodies' peak device memory, and the programs on the card against
    the CPU. No kernel of the repo is on this path: every count stays 0."""
    from mcos_tpu_torch.engine import autocallable as ac
    from mcos_tpu_torch.engine import basket as bk
    from mcos_tpu_torch.engine import basket_american as ba
    from mcos_tpu_torch.engine import cliquet as cl
    from mcos_tpu_torch.engine import american
    from mcos_tpu_torch.engine import quanto as qu
    from mcos_tpu_torch.ops import rainbow
    from mcos_tpu_torch.profile_price import ROUTE_BODIES

    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {"requests": {}}

    def ask(what, route, body):
        status, res, ms = post(base, body, path=f"/api/{route}")
        check(status == 200, f"{what}: status {status}")
        check(all_finite(res), f"{what}: every number finite")
        out["requests"][what] = {"latency_ms": ms,
                                 "elapsed_ms": res.get("elapsed_ms")}
        return res

    def refused(what, route, body, code=400):
        try:
            post(base, body, path=f"/api/{route}")
            check(False, f"{what} must answer {code}")
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())["detail"]
            check(e.code == code, f"{what}: {e.code} {detail!r}")
            log(f"/api/{route} {what}: {code} {str(detail)[:80]!r}")

    def lap(what):
        log(f"  [{what}: {time.perf_counter() - t_start:.1f} s into the "
            f"path]")

    def within(what, got, exact, tol):
        log(f"{what}: {got:.6f} vs {exact:.6f} (tol {tol:.2e})")
        check(abs(got - exact) <= tol, what)

    B = ROUTE_BODIES
    gbm = {"kappa": 0.0, "theta": 0.0625, "xi": 0.0, "rho": 0.0,
           "v0": 0.0625, "lambda_j": 0.0, "mu_j": 0.0, "sigma_j": 0.0,
           "r": 0.05, "q": 0.01}
    gbm_p = gbm_params(0.25, r=0.05, q=0.01)
    try:
        # ── /api/cliquet: GBM-degenerate against the closed forms ────────
        res = ask("cliquet", "cliquet", B["cliquet"])
        c = ask("cliquet GBM", "cliquet", dict(B["cliquet"], params=gbm,
                                               local_cap=0.06))
        exact = cl.cliquet_bs(1.0, 4, 0.05, 0.01, 0.25, 0.0, 0.06)
        within("GBM cliquet (CV) vs cliquet_bs", c["price"], exact,
               3 * c["std_error"] + 1e-6 * exact)
        raw = cl.CliquetEngine(gbm_p, num_paths=MULTI_PATHS, device=device,
                               use_control_variate=False).price_cliquet(
            1.0, local_cap=0.06)
        within("GBM cliquet (raw) vs cliquet_bs", raw["price"], exact,
               3 * raw["std_error"])
        f = ask("forward start GBM", "cliquet", dict(
            B["cliquet"], params=gbm, kind="forward_start", t1=0.25))
        exact = cl.forward_start_bs(f["t1_effective"], 1.0, 1.0, 0.05, 0.01,
                                    0.25)
        within("GBM forward start (CV) vs forward_start_bs", f["price"],
               exact, 3 * f["std_error"] + 1e-6 * exact)
        raw = cl.CliquetEngine(gbm_p, num_paths=MULTI_PATHS, device=device,
                               use_control_variate=False
                               ).price_forward_start(0.25, 1.0)
        within("GBM forward start (raw) vs forward_start_bs", raw["price"],
               exact, 3 * raw["std_error"])
        log(f"/api/cliquet default (4 x 16 steps, {MULTI_PATHS} paths): "
            f"{res['price']:.6f} ± {res['std_error']:.6f}")
        refused("t1 >= T", "cliquet", dict(B["cliquet"],
                                           kind="forward_start", t1=1.0))
        refused("unknown kind", "cliquet", dict(B["cliquet"], kind="x"))
        lap("cliquet")

        # ── /api/quanto: quanto_bs and the σ_fx = 0 limit ────────────────
        res = ask("quanto", "quanto", B["quanto"])
        qb = dict(B["quanto"], params=gbm, r_domestic=0.03)
        q = ask("quanto GBM", "quanto", qb)
        exact = qu.quanto_bs(100.0, 100.0, 1.0, 0.03, 0.05, 0.01, 0.25, 0.1,
                             -0.3)
        within("GBM quanto (CV) vs quanto_bs", q["price"], exact,
               3 * q["std_error"] + 1e-6 * exact)
        raw = qu.QuantoEngine(gbm_p, 0.03, 0.1, -0.3, num_paths=MULTI_PATHS,
                              use_control_variate=False,
                              device=device).price(100.0, 100.0, 1.0)
        within("GBM quanto (raw) vs quanto_bs", raw["price"], exact,
               3 * raw["std_error"])
        q0 = ask("quanto sigma_fx 0", "quanto", dict(qb, sigma_fx=0.0))
        plain = float(bs_price(100.0, 100.0, 1.0, 0.03, 0.03 - 0.05 + 0.01,
                               0.25))
        within("quanto at sigma_fx = 0 vs Black-Scholes", q0["price"], plain,
               3 * q0["std_error"] + 1e-5 * plain)
        log(f"/api/quanto default (64 steps): {res['price']:.5f} ± "
            f"{res['std_error']:.5f}, BS adjustment "
            f"{res['quanto_adjustment_bs']:.5f}")
        refused("rho_fx 1", "quanto", dict(B["quanto"], rho_fx=1.0), 422)
        lap("quanto")

        # ── /api/basket: Stulz, Margrabe, the vanilla, implied ρ ─────────
        res = ask("basket", "basket", B["basket"])
        g1, g2 = dict(gbm, v0=0.0625, theta=0.0625), dict(
            gbm, v0=0.1225, theta=0.1225, q=0.03)
        two = {"spots": [100.0, 95.0], "strike": 100.0, "T": 0.75,
               "corr": [[1.0, 0.4], [0.4, 1.0]], "params": [g1, g2]}
        for kind in ("worst_of", "best_of"):
            for is_call in (True, False):
                r_ = ask(f"rainbow {kind} {is_call}", "basket", dict(
                    two, payoff=kind, is_call=is_call))
                exact = rainbow.rainbow_price(
                    100.0, 95.0, 100.0, 0.75, 0.05, 0.01, 0.03, 0.25, 0.35,
                    0.4, kind=kind, is_call=is_call)
                within(f"GBM rainbow {kind} {'call' if is_call else 'put'}"
                       " vs Stulz", r_["price"], exact,
                       max(5 * r_["std_error"], 0.02))
        s = ask("spread K=0", "basket", dict(two, payoff="spread",
                                             strike=0.0))
        exact = rainbow.margrabe_exchange(100.0, 95.0, 0.75, 0.01, 0.03,
                                          0.25, 0.35, 0.4)
        within("GBM spread K=0 vs Margrabe", s["price"], exact,
               max(5 * s["std_error"], 0.02))
        one = ask("single-asset basket", "basket", {
            "spots": [100.0], "weights": [1.0], "strike": 100.0, "T": 0.25,
            "corr": [[1.0]], "params": [dict(gbm, v0=0.04, theta=0.04)]})
        exact = float(bs_price(100.0, 100.0, 0.25, 0.05, 0.01, 0.2))
        within("single-asset basket vs Black-Scholes", one["price"], exact,
               1e-3)
        trio = {"spots": [100.0, 50.0, 200.0], "weights": [1 / 3] * 3,
                "strike": 115.0, "T": 0.5, "corr": [
                    [1.0, 0.45, 0.45], [0.45, 1.0, 0.45], [0.45, 0.45, 1.0]],
                "params": [dict(gbm, v0=s_ * s_, theta=s_ * s_)
                           for s_ in (0.2, 0.25, 0.3)]}
        quote = ask("basket quote at rho 0.45", "basket", trio)
        t0 = time.perf_counter()
        ic = ask("implied correlation", "basket", dict(
            trio, implied_corr_from_price=quote["price"]))
        out["implied_corr_ms"] = (time.perf_counter() - t0) * 1e3
        within(f"implied correlation round trip ({ic['iterations']} "
               "bisections)", ic["implied_correlation"], 0.45, 0.02)
        log(f"/api/basket default (2 assets, {MULTI_PATHS} x 64 steps): "
            f"{res['price']:.5f} ± {res['std_error']:.5f} (beta "
            f"{res['cv_beta']:.4f}); implied correlation "
            f"{out['implied_corr_ms']:.0f} ms")
        lap("basket European")

        # ── /api/basket american: the Broadie-Glasserman table ───────────
        bg = {"strike": 100.0, "T": 3.0, "corr": [[1.0, 0.0], [0.0, 1.0]],
              "params": [BG_GBM, BG_GBM], "payoff": "best_of",
              "american": True, "n_exercise": 9, "steps_per_period": 1}
        for s0, lo, hi in BG_BANDS:
            r_ = ask(f"Bermudan max call S0={s0:g}", "basket",
                     dict(bg, spots=[s0, s0]))
            log(f"BG max call S0 = {s0:g}: {r_['price']:.4f} ± "
                f"{r_['std_error']:.4f} (band {lo}-{hi})")
            check(lo < r_["price"] < hi, f"BG max call at {s0}")
        r_ = ask("Bermudan bracket", "basket", dict(
            bg, spots=[100.0, 100.0], with_bounds=True))
        b = r_["bounds"]
        log(f"duality bracket at S0 = 100 (2048 x 64): [{b['lower_bound']:.4f}"
            f" ± {b['lower_se']:.4f}, {b['upper_bound']:.4f} ± "
            f"{b['upper_se']:.4f}], gap {b['duality_gap']:.4f}")
        check(b["lower_bound"] - 3 * b["lower_se"] < 13.934
              and b["upper_bound"] + 3 * b["upper_se"] > 13.892
              and b["duality_gap"] < 0.8
              and b["lower_bound"] - 3 * b["lower_se"] < 13.902
              < b["upper_bound"] + 3 * b["upper_se"],
              "duality bracket reaches [13.892, 13.934]")
        out["bg"] = {"bracket": b}
        for what, bad in (("corr rows", {"corr": [[1.0]]}),
                          ("weights", {"weights": [1.0]}),
                          ("spread of 3", {"payoff": "spread",
                                           "spots": [1.0, 2.0, 3.0],
                                           "corr": np.eye(3).tolist(),
                                           "params": []}),
                          ("params length", {"params": [{}]}),
                          ("implied corr on worst_of",
                           {"payoff": "worst_of",
                            "implied_corr_from_price": 3.0}),
                          ("american spread", {"payoff": "spread",
                                               "american": True})):
            refused(what, "basket", dict(B["basket"], **bad))
        refused("corr not PSD", "basket", dict(
            B["basket"], corr=[[1.0, 1.5], [1.5, 1.0]]), code=500)
        lap("basket Bermudan")

        # ── /api/autocall: no_call_note_bs, ρ = 1, the par coupon ────────
        res = ask("autocall", "autocall", B["autocall"])
        gbm20 = dict(gbm, v0=0.04, theta=0.04)
        a = ask("autocall unreachable", "autocall", dict(
            B["autocall"], params=gbm20, autocall_barrier=50.0))
        exact = ac.no_call_note_bs(1.0, 0.05, 0.01, 0.2, 0.8, 0.7, 0.08)
        within("unreachable autocall vs no_call_note_bs", a["price"], exact,
               4 * a["std_error"] + 5e-4)
        check(a["survival_prob"] == 1.0, "unreachable: every path survives")
        single = ask("autocall GBM", "autocall", dict(B["autocall"],
                                                      params=gbm20))
        w3 = ask("worst-of rho 1", "autocall", dict(
            B["autocall"], params_list=[gbm20] * 3,
            corr=np.ones((3, 3)).tolist()))
        within("worst-of at rho = 1 vs its single-asset note", w3["price"],
               single["price"], 3e-3)
        par = ask("par coupon", "autocall", dict(B["autocall"],
                                                 solve_par=True))
        within(f"price at the par coupon {par['par_coupon']:.5f}",
               par["price_at_par_coupon"], 1.0, 1e-5)
        wpar = ask("worst-of par coupon", "autocall", dict(
            B["autocall"], solve_par=True, params_list=[{}] * 3,
            corr=(np.full((3, 3), 0.6) + 0.4 * np.eye(3)).tolist()))
        within("worst-of price at its par coupon",
               wpar["price_at_par_coupon"], 1.0, 1e-5)
        check(wpar["par_coupon"] > par["par_coupon"],
              "worst-of pays a dispersion premium")
        log(f"/api/autocall default: {res['price']:.5f} ± "
            f"{res['std_error']:.5f}, call probabilities "
            f"{np.round(res['call_prob_by_date'], 4).tolist()}; par coupon "
            f"{par['par_coupon']:.5f} (worst of 3: {wpar['par_coupon']:.5f})")
        refused("barrier order", "autocall", dict(B["autocall"],
                                                 coupon_barrier=1.2))
        refused("worst-of without corr", "autocall", dict(
            B["autocall"], params_list=[{}, {}]))
        refused("17 assets", "autocall", dict(
            B["autocall"], params_list=[{}] * 17,
            corr=np.eye(17).tolist()))
        refused("mixed r", "autocall", dict(
            B["autocall"], params_list=[{}, {"r": 0.01}],
            corr=np.eye(2).tolist()), code=500)
        lap("autocall")

        # ── warm latencies: median of 3 over HTTP ────────────────────────
        bodies = {"basket": B["basket"], "cliquet": B["cliquet"],
                  "quanto": B["quanto"], "autocall": B["autocall"],
                  "bermudan": dict(B["basket"], american=True,
                                   payoff="best_of")}
        for name, body in bodies.items():
            route = "basket" if name == "bermudan" else name
            lat = []
            for _ in range(3):
                before = time.perf_counter()
                ask(f"warm {name}", route, body)
                lat.append((time.perf_counter() - before) * 1e3)
            out[f"warm_{name}_ms"] = statistics.median(lat)
            log(f"warm /api/{route} {name}: median "
                f"{statistics.median(lat):.2f} ms over 3 "
                f"({[round(x, 2) for x in lat]})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    lap("warm latencies")

    # The default bodies once in process under the profiler, each with its
    # peak device memory; then the widest bodies the schemas allow.
    bodies["bracket"] = dict(bodies["bermudan"], with_bounds=True)
    prof = {}
    for name, body in bodies.items():
        fn = getattr(server, "handle_basket" if name in ("bermudan",
                                                          "bracket")
                     else f"handle_{name}")
        prof[name] = profiled_call(
            device, lambda fn=fn, body=body: fn(dict(body), device=device))
        pr = prof[name]
        log(f"profiled {name}: wall {pr['profiled_wall_ms']:.1f} ms, device "
            f"{pr['device_ms_per_call']} ms, {pr['kernel_launches_per_call']}"
            f" launches, busy share {pr['busy_share']}, peak "
            f"{pr['peak_gib']:.3f} GiB")
    out["profiles"] = prof
    lap("profiles")

    def wide(name, fn):
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated(device) - held) / 2**30
        check(all_finite(res), f"{name}: finite")
        log(f"{name}: {ms:.1f} ms, peak device memory {peak:.3f} GiB")
        out.setdefault("wide", {})[name] = {"ms": ms, "peak_gib": peak}
        return res

    def eq(a, r):
        """An a × a flat correlation r."""
        return (np.full((a, a), r) + (1 - r) * np.eye(a)).tolist()

    a, w = WIDE_BASKET_ASSETS, WIDE_WORST_ASSETS
    wide(f"basket {a} assets x {MULTI_PATHS} paths x 64 steps",
         lambda: server.handle_basket({
             "spots": [100.0] * a, "weights": [1 / a] * a,
             "strike": 100.0, "T": 1.0, "corr": eq(a, 0.3)},
             device=device))
    wide(f"worst-of autocall {w} assets x {MULTI_PATHS} paths",
         lambda: server.handle_autocall(dict(
             B["autocall"], params_list=[{}] * w, corr=eq(w, 0.5)),
             device=device))
    n_outer, n_inner = WIDE_BRACKET
    res = wide(f"bracket 2 assets, {n_outer} outer x {n_inner} inner, "
               "9 x 8 steps", lambda: server.handle_basket(dict(
                   bodies["bracket"], n_outer=n_outer, n_inner=n_inner),
                   device=device))
    log(f"wide bracket: {res['bounds']}")
    lap("wide bodies")

    out["card_vs_cpu"] = multiasset_card_vs_cpu(
        device, cl, qu, bk, ba, ac, american, SVJParams, gbm_params)
    counts = ck.launch_counts()
    log(f"launch counts over the slice K path: {counts} (expected all 0: "
        f"no kernel on the path)")
    check(all(v == 0 for v in counts.values()), "slice K launches no kernel")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"slice K path: {out['wall_s']:.1f} s")
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Slices L and M: rough Heston, MLMC and the serving tail
# ─────────────────────────────────────────────────────────────────────────────
RH_BODY = {"spot": SPOT, "T": T_DEFAULT}       # RoughHestonRequest defaults
RH_PATHS = 200_000
RH_CARD_CPU = (16_384, 512, 24)                # pairs x steps x factors
MLMC_SVJ = {"kappa": 3.0, "theta": 0.05, "xi": 0.4, "rho": -0.6, "v0": 0.04,
            "lambda_j": 1.0, "mu_j": -0.05, "sigma_j": 0.1}


def offline_urlopen() -> None:
    """Every urlopen to a host other than the loopback fails at once: the
    card's machine has no network, and `/api/quote` must answer from the
    static universe without waiting out its timeout."""
    real = urllib.request.urlopen

    def guarded(req, *args, **kwargs):
        url = req.full_url if isinstance(req, urllib.request.Request) \
            else req
        if urllib.parse.urlparse(url).hostname not in ("127.0.0.1",
                                                        "localhost"):
            raise urllib.error.URLError("no network on this machine")
        return real(req, *args, **kwargs)

    urllib.request.urlopen = guarded


def roughheston_card_vs_cpu(device, rh_ops, rh_eng, mlmc, SVJParams):
    """The lifted loop and an MLMC coupled level on the card against the
    CPU on the same normals (and Poisson counts)."""
    from mcos_tpu_torch.engine.pricer import seeded_generator

    out = {}
    pairs, steps, nf = RH_CARD_CPU
    p = rh_ops.RoughHestonParams()
    c, x = rh_eng._nodes(p, T_DEFAULT, nf)
    z = torch.randn((steps, 2, pairs), generator=seeded_generator(0, "cpu"))
    kw = dict(num_paths=pairs, num_steps=steps, companion=True)
    cpu = rh_ops.lifted_terminal(p, SPOT, T_DEFAULT, None, c, x, draws=z,
                                 device="cpu", **kw)
    card = [t.cpu() for t in rh_ops.lifted_terminal(
        p, SPOT, T_DEFAULT, None, c, x, draws=z.to(device), device=device,
        **kw)]
    s_rel = ((card[0] - cpu[0]).abs() / cpu[0].abs()).flatten()
    g_rel = rel_err(card[2], cpu[2])
    strikes = torch.tensor([0.9, 0.95, 1.0, 1.05, 1.1]) * SPOT

    def cv(S, G):
        return (torch.clamp(S[..., None] - strikes, min=0.0)
                - torch.clamp(G[..., None] - strikes, min=0.0)
                ).double().mean(dim=(0, 1))
    cv_err = float((cv(card[0], card[2]) - cv(cpu[0], cpu[2])).abs().max()
                   / SPOT)
    q99 = float(s_rel.kthvalue(int(0.99 * s_rel.numel())).values)
    out["lifted"] = {
        "shape": f"{pairs} pairs x {steps} steps x {nf} factors",
        "s_max_rel_err": float(s_rel.max()), "s_q99_rel_err": q99,
        "s_share_above_1e-4": float((s_rel > 1e-4).float().mean()),
        "s_bit_equal_share": float((s_rel == 0).float().mean()),
        "g_max_rel_err": g_rel, "cv_means_max_err_over_spot": cv_err,
        "v_max_abs_err": float((card[1] - cpu[1]).abs().max())}
    log(f"lifted rough Heston card vs CPU ({out['lifted']['shape']}): S "
        f"max rel err {out['lifted']['s_max_rel_err']:.3e}, 99th pct "
        f"{q99:.3e}, {100 * out['lifted']['s_share_above_1e-4']:.3f} % of "
        f"paths above 1e-4, {100 * out['lifted']['s_bit_equal_share']:.1f} "
        f"% bit equal; G max rel err {g_rel:.3e}; CV payoff means "
        f"{cv_err:.3e} of the spot")
    # Float32 rounding of the factor contraction (cuBLAS against the CPU's
    # order) is amplified where v touches 0: paths part, the law does not.
    check(g_rel < 1e-5, "lifted G card vs CPU path by path (rtol 1e-5)")
    check(q99 < 1e-4, "lifted S card vs CPU: 99 % of paths within rtol 1e-4")
    check(cv_err < 1e-5, "lifted CV payoff means card vs CPU within 1e-5 "
          "of the spot")

    # An MLMC coupled level (16 coarse steps, 65 536 pairs) on shared
    # normals and Poisson counts.
    n, cs = 65_536, 16
    prm = SVJParams(**MLMC_SVJ)
    gen = seeded_generator(1, "cpu")
    lam_dt = torch.tensor(prm.lambda_j, dtype=torch.float32) * (
        torch.tensor(T_DEFAULT, dtype=torch.float32) / (2 * cs))
    draws = [torch.randn((cs, 2, n), generator=gen),
             torch.randn((cs, 2, n), generator=gen)]
    for _ in range(2):
        draws += [torch.poisson(torch.full((cs, n), float(lam_dt)),
                                generator=gen),
                  torch.randn((cs, n), generator=gen)]
    args = (prm, SPOT, SPOT, T_DEFAULT, None)
    m_cpu = [float(v) for v in mlmc._coupled_level(
        *args, num_paths=n, num_coarse_steps=cs, is_call=True, draws=draws,
        device="cpu")]
    m_card = [float(v) for v in mlmc._coupled_level(
        *args, num_paths=n, num_coarse_steps=cs, is_call=True,
        draws=[d.to(device) for d in draws], device=device)]
    scale = math.sqrt(m_cpu[1])
    out["coupled_level"] = {"card": m_card, "cpu": m_cpu,
                            "mean_err_over_rms": abs(m_card[0] - m_cpu[0])
                            / scale,
                            "m2_rel_err": abs(m_card[1] / m_cpu[1] - 1)}
    log(f"MLMC coupled level card vs CPU (65 536 pairs x 16 coarse steps): "
        f"mean {m_card[0]:.6f} vs {m_cpu[0]:.6f}, E[x^2] {m_card[1]:.6f} vs "
        f"{m_cpu[1]:.6f}")
    check(abs(m_card[0] - m_cpu[0]) <= 1e-5 * scale,
          "coupled level mean card vs CPU (1e-5 of its rms)")
    check(abs(m_card[1] - m_cpu[1]) <= 1e-5 * m_cpu[1],
          "coupled level E[x^2] card vs CPU (rtol 1e-5)")
    return out


def roughheston_path(device, ck, server, cos_price, SVJParams):
    """Slices L and M, with the launch counts set to 0 just before: on a
    fresh server `/api/roughheston` in every mode at the default body
    against the COS oracle and its own bumps, two 400s and warm
    latencies; price and greeks once under the profiler with their peak
    device memory; the lifted loop and a coupled MLMC level on the card
    against the CPU; `mlmc_price` at eps = 1 against the Bates COS price;
    then the serving tail over HTTP (`/api/metrics`, `/api/symbols`,
    `/api/quote`, the static UI). No kernel of the repo is on this path:
    every count stays 0."""
    from mcos_tpu_torch.engine import mlmc
    from mcos_tpu_torch.engine import roughheston as rh_eng
    from mcos_tpu_torch.ops import roughheston as rh_ops

    ck.reset_launch_counts()
    t_start = time.perf_counter()
    httpd = server.serve("127.0.0.1", 0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {"requests": {}}
    posts = [0]

    def ask(what, body):
        posts[0] += 1
        status, res, ms = post(base, body, path="/api/roughheston")
        check(status == 200, f"{what}: status {status}")
        check(all_finite({k: v for k, v in res.items() if k != "iv"}),
              f"{what}: every number finite")
        out["requests"][what] = {"latency_ms": ms,
                                 "elapsed_ms": res.get("elapsed_ms")}
        log(f"/api/roughheston {what}: {ms:.1f} ms over HTTP")
        return res

    def refused(what, body):
        posts[0] += 1
        try:
            post(base, body, path="/api/roughheston")
            check(False, f"{what} must answer 400")
        except urllib.error.HTTPError as e:
            detail = json.loads(e.read())["detail"]
            check(e.code == 400, f"{what}: {e.code} {detail!r}")
            log(f"/api/roughheston {what}: 400 {str(detail)[:70]!r}")

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    def within(what, got, exact, tol):
        log(f"{what}: {got:.6f} vs {exact:.6f} (tol {tol:.3e})")
        check(abs(got - exact) <= tol, what)

    def lap(what):
        out.setdefault("laps_s", {})[what] = time.perf_counter() - t_start
        log(f"  [{what}: {out['laps_s'][what]:.1f} s into the path]")

    p = rh_ops.RoughHestonParams()
    lap("server up")
    try:
        # ── price: the COS oracle, H = 1/2 against Heston ────────────────
        res = ask("price", RH_BODY)
        check(res["num_steps"] == 2048 and res["n_factors"] == 24
              and res["num_paths_used"] == RH_PATHS, "default widths")
        check(res["frac_nonfinite"] == 0.0, "price: every path finite")
        exact = float(rh_ops.rough_heston_cos_price(p, SPOT, [SPOT],
                                                    T_DEFAULT)[0])
        within("price vs the fractional-Riccati COS price", res["price"],
               exact, 4 * res["std_error"] + 0.006 * exact)
        out["price"] = {"mc": res["price"], "se": res["std_error"],
                        "cos": exact}
        half = ask("price H = 1/2", dict(RH_BODY, hurst=0.5))
        heston = float(cos_price(SVJParams(kappa=1.5, theta=0.04, xi=0.35,
                                           rho=-0.7, v0=0.04, lambda_j=0.0),
                                 SPOT, [SPOT], T_DEFAULT)[0])
        within("H = 1/2 price vs Heston COS", half["price"], heston,
               4 * half["std_error"] + 0.004 * heston)
        check(half["n_factors"] == 1, "H = 1/2 runs one factor")

        # ── compare: five strikes; its ATM row is the price ──────────────
        cmp_ = ask("compare", dict(RH_BODY, mode="compare"))
        rows = cmp_["rows"]
        check(len(rows) == 5 and rows[2]["strike"] == SPOT, "compare rows")
        check(abs(rows[2]["mc_price"] / res["price"] - 1) < 1e-6,
              "compare's ATM row is the price (same normals)")
        for r_ in rows:
            log(f"  compare K = {r_['strike']:.0f}: MC {r_['mc_price']:.4f}"
                f" ± {r_['std_error']:.4f}, COS {r_['cos_price']:.4f} "
                f"({(r_['mc_price'] / r_['cos_price'] - 1) * 100:+.3f} %)")
        out["compare"] = rows

        # ── greeks: AD delta against a CRN bump-and-reprice ──────────────
        g = ask("greeks", dict(RH_BODY, mode="greeks"))
        h = 0.01 * SPOT
        eng = rh_eng.RoughHestonEngine(p, device=device)
        up = eng.price(SPOT + h, SPOT, T_DEFAULT)["price"]
        dn = eng.price(SPOT - h, SPOT, T_DEFAULT)["price"]
        within("AD delta vs CRN bump-and-reprice", g["delta"],
               (up - dn) / (2 * h), 0.03)
        check(abs(g["price"] / res["price"] - 1) < 1e-5,
              "greeks' price is the price (same normals)")
        check(0.3 < g["delta"] < 0.8 and g["vega"] > 0.0
              and g["dP_drho"] != 0.0, "greeks sane")
        out["greeks"] = {k: g[k] for k in ("delta", "vega", "dP_dv0",
                                           "dP_dnu", "dP_drho")}
        lap("price, compare, greeks")

        # ── smile, skew, calibrate: the host oracle ──────────────────────
        sm = ask("smile", dict(RH_BODY, mode="smile"))
        check(all(v is not None for v in sm["iv"])
              and sm["iv"][0] > sm["iv"][2] > sm["iv"][4], "smile skewed")
        sk = ask("skew", dict(RH_BODY, mode="skew"))
        check(len(sk["rows"]) == 6 and all(r_["atm_skew"] < 0
                                           for r_ in sk["rows"]),
              "skew term structure: six negative skews")
        pl = ask("skew 0.025 / 0.4", dict(RH_BODY, mode="skew",
                                         maturities=[0.025, 0.4]))
        ratio = pl["rows"][0]["atm_skew"] / pl["rows"][1]["atm_skew"]
        expected = (0.025 / 0.4) ** (p.hurst - 0.5)
        log(f"skew ratio T = 0.025 / 0.4: {ratio:.3f} (power law "
            f"{expected:.3f})")
        check(0.55 * expected < ratio < 1.6 * expected,
              "short-dated skew follows T^(H - 1/2)")
        ks = [m * SPOT for m in (0.92, 0.96, 1.0, 1.04, 1.08)]
        market = rh_ops.rough_heston_cos_price(p, SPOT, ks, T_DEFAULT,
                                               n_terms=192, n_steps=128)
        fit = ask("calibrate", dict(RH_BODY, mode="calibrate", strikes=ks,
                                    market_prices=market.tolist(),
                                    hurst=0.1))
        log(f"calibrate: nu {fit['nu']:.4f}, rho {fit['rho']:.4f}, v0 "
            f"{fit['v0']:.5f}, rmse {fit['rmse_price']:.3e}")
        check(fit["rmse_price"] < 0.5 and abs(fit["nu"] - 0.35) < 0.05
              and abs(fit["rho"] + 0.7) < 0.08
              and abs(fit["v0"] - 0.04) < 0.004, "calibration round trip")
        out["calibrate"] = {k: fit[k] for k in ("nu", "rho", "v0",
                                                "rmse_price")}
        refused("unknown mode", dict(RH_BODY, mode="nope"))
        refused("calibrate without market_prices", dict(
            RH_BODY, mode="calibrate", strikes=ks))
        lap("host modes, 400s")

        # ── warm latencies: median of 5 over HTTP ────────────────────────
        for name, body in (("price", RH_BODY),
                           ("greeks", dict(RH_BODY, mode="greeks")),
                           ("smile", dict(RH_BODY, mode="smile"))):
            lat = []
            for _ in range(5):
                before = time.perf_counter()
                ask(f"warm {name}", body)
                lat.append((time.perf_counter() - before) * 1e3)
            out[f"warm_{name}_ms"] = statistics.median(lat)
            log(f"warm /api/roughheston {name}: median "
                f"{out[f'warm_{name}_ms']:.1f} ms over 5 "
                f"({[round(x, 1) for x in lat]})")
        lap("warm latencies")

        # ── the serving tail over HTTP ───────────────────────────────────
        status, _, body = get("/api/metrics")
        snap = json.loads(body)["endpoints"]["/api/roughheston"]
        log(f"/api/metrics /api/roughheston: {snap}")
        check(status == 200 and snap["count"] == posts[0]
              and snap["errors"] == 2, "metrics count this phase's requests")
        status, _, body = get("/api/symbols?q=bank")
        syms = [r_["symbol"] for r_ in json.loads(body)["symbols"]]
        check(status == 200 and "HDFCBANK" in syms, "/api/symbols?q=bank")
        status, _, body = get("/api/quote?symbol=NIFTY")
        quote = json.loads(body)
        log(f"/api/quote?symbol=NIFTY: {quote}")
        check(status == 200 and quote["source"] == "CACHED"
              and quote["price"] == 22500.0, "/api/quote falls back")
        for path, mime in (("/", "text/html"),
                           ("/static/app.js", "application/javascript")):
            status, got_mime, body = get(path)
            check(status == 200 and got_mime == mime and len(body) > 0,
                  f"GET {path}")
        try:
            get("/static/../chip_smoke.py")
            check(False, "traversal must answer 404")
        except urllib.error.HTTPError as e:
            check(e.code == 404, "traversal answers 404")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    out["http_s"] = time.perf_counter() - t_start
    lap("serving tail")

    # ── in process: price and greeks under the profiler ──────────────────
    prof = {}
    for name, body in (("price", RH_BODY),
                       ("greeks", dict(RH_BODY, mode="greeks"))):
        prof[name] = profiled_call(device, lambda body=body:
                                   server.handle_roughheston(
                                       dict(body), device=device))
        pr = prof[name]
        log(f"profiled {name}: wall {pr['profiled_wall_ms']:.1f} ms, device "
            f"{pr['device_ms_per_call']} ms, {pr['kernel_launches_per_call']}"
            f" launches, busy share {pr['busy_share']}, peak "
            f"{pr['peak_gib']:.3f} GiB")
    out["profiles"] = prof
    # One step's normals at a time: a (steps, 2, paths) sheet would be
    # 2048 x 2 x 200 000 float32, 3.05 GiB.
    check(prof["price"]["peak_gib"] < 1.0,
          "a default price holds no (steps, 2, paths) sheet")
    lap("profiles")

    out["card_vs_cpu"] = roughheston_card_vs_cpu(device, rh_ops, rh_eng,
                                                 mlmc, SVJParams)
    lap("card vs CPU")

    # ── MLMC at eps = 1 against the Bates COS price ──────────────────────
    svj = SVJParams(**MLMC_SVJ)
    exact = float(cos_price(svj, SPOT, [SPOT], T_DEFAULT)[0])
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    ml = mlmc.mlmc_price(svj, SPOT, SPOT, T_DEFAULT, eps=1.0, seed=3,
                         max_paths_per_level=1 << 20, device=device)
    ml_ms = (time.perf_counter() - t0) * 1e3
    within(f"mlmc_price eps = 1 ({ml['num_levels']} levels, paths "
           f"{[lv['n'] for lv in ml['levels']]}, {ml_ms:.0f} ms) vs Bates "
           "COS", ml["price"], exact,
           3 * (ml["std_error"] + ml["bias_estimate"]) + 1.0)
    check(ml["num_levels"] >= 3, "mlmc: at least three levels")
    out["mlmc_eps1"] = dict(ml, wall_ms=ml_ms, cos=exact)

    counts = ck.launch_counts()
    log(f"launch counts over the slice L + M path: {counts} (expected all "
        f"0: no kernel on the path)")
    check(all(v == 0 for v in counts.values()),
          "slices L and M launch no kernel")
    out["launches"] = counts
    out["wall_s"] = time.perf_counter() - t_start
    log(f"slice L + M path: {out['wall_s']:.1f} s")
    return out


T_START = time.perf_counter()


# ─────────────────────────────────────────────────────────────────────────────
# Slice N1: the path-sharded mesh on cuda:0
# ─────────────────────────────────────────────────────────────────────────────
MESH_SHARDS = 4
MESH_SEED = 42


class KernelCapture:
    """While installed, records what the kernel wrapper `ck.<name>` returns.
    The wrapper counts its launches (and K6 its variants) on the module's
    name, which is this spy until exit; the counts go back to the wrapper
    then."""

    def __init__(self, ck, name):
        self.ck, self.name, self.outs = ck, name, []

    def __enter__(self):
        real = self.real = getattr(self.ck, self.name)

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            self.outs.append(out)
            return out

        spy.__dict__.update(real.__dict__)
        self.spy = spy
        setattr(self.ck, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.ck, self.name, self.real)
        self.real.__dict__.update(self.spy.__dict__)


class PoolCapture:
    """While installed, records every (shard dicts, pooled dict) that
    `parallel.mesh.pool_shards` pools."""

    def __init__(self, pm):
        self.pm, self.calls = pm, []

    def __enter__(self):
        real = self.real = self.pm.pool_shards

        def spy(stats, mesh=None):
            stats = list(stats)
            out = real(stats, mesh)
            self.calls.append((stats, out))
            return out

        self.pm.pool_shards = spy
        return self

    def __exit__(self, *exc):
        self.pm.pool_shards = self.real


def bitwise_equal(a, b) -> bool:
    """Same floats (NaN matching NaN) in every tensor of two outputs."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bitwise_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bitwise_equal(x, y)
                                        for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def price_pair(res) -> tuple:
    """(price, std_error) of the first strike, as host floats."""
    return tuple(float(torch.as_tensor(res[k]).reshape(-1)[0])
                 for k in ("price", "std_error"))


def timed(fn) -> float:
    """Host wall ms of fn() ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def mesh_path(device, ck, card, SVJParams, SVCJParams, hhw, localvol):
    """Slice N1 on cuda:0: the kernels at a 4-shard mesh's shard shapes
    against their plain versions; each sharded driver on a one-shard mesh
    against its unsharded engine (the kernel's outputs bit for bit, price
    and standard error within rtol 1e-6); on a 4-shard mesh, each shard
    the one-shard run on its seed, bit for bit; MCOS_AUTO_MESH=1; the
    SLV's shards as one cloud; the kernels' launches; the 4-shard wall
    time against the unsharded one at the same total paths."""
    from mcos_tpu_torch.engine import pricer, termsvj
    from mcos_tpu_torch.engine.exotics import ExoticEngine
    from mcos_tpu_torch.engine.hhw import HHWEngine
    from mcos_tpu_torch.engine.svcj import SVCJEngine
    from mcos_tpu_torch.parallel import families as pf
    from mcos_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    params = SVJParams()
    svcj_p = SVCJParams()
    hp = hhw.HHWParams(kappa=2.0, theta=0.05, xi=0.4, v0=0.04, a=0.1,
                       b=0.05, sigma_r=0.012, r0=0.05, rho_sv=-0.6,
                       rho_sr=0.3, rho_vr=0.1, q=0.01)
    seg = tuple([s[k] for s in TD_SEGMENTS]
                for k in ("t_end", "theta", "xi", "lambda_j"))
    td_steps = 512
    td_levels = termsvj.TDSVJEngine(params, *seg, num_steps=td_steps,
                                    device=device)._step_arrays(T_DEFAULT)
    one = pm.make_mesh([device])
    four = pm.make_mesh([device] * MESH_SHARDS)

    # 1. Each kernel at a shard's shape, on a shard's seed, against its
    # plain version (not counted: launches that compare).
    s1 = pm.shard_seed(MESH_SEED, 1)
    pins = {}
    for name, args, kw, labels in (
            ("svj_terminal", (params, SPOT, T_DEFAULT, s1),
             dict(num_paths=NUM_PATHS // MESH_SHARDS,
                  num_steps=STEPS_DEFAULT, companion=True), ("S", "v", "G")),
            ("svj_terminal_qe", (params, SPOT, T_DEFAULT, s1),
             dict(num_paths=NUM_PATHS // MESH_SHARDS,
                  num_steps=STEPS_DEFAULT, companion=True), ("S", "v", "G")),
            ("hhw_terminal", (hp, SPOT, 1.0, s1),
             dict(num_paths=FAMILY_PAIRS // MESH_SHARDS, num_steps=128),
             ("S", "D")),
            ("svcj_terminal", (svcj_p, SPOT, T_DEFAULT, s1),
             dict(num_paths=FAMILY_PAIRS // MESH_SHARDS,
                  num_steps=STEPS_DEFAULT, companion=True), ("S", "v", "G")),
            ("svj_terminal_td", (params, *td_levels, SPOT, T_DEFAULT, s1),
             dict(num_paths=FAMILY_PAIRS // MESH_SHARDS, num_steps=td_steps,
                  companion=True), ("S", "v", "G"))):
        kw = dict(kw, antithetic=True, device=device)
        ker = getattr(ck, name)(*args, **kw)
        torch.cuda.synchronize()
        ref = getattr(ck, name + "_plain")(*args, **kw)
        err, _ = compare_family(f"{name} at a shard's shape "
                                f"({kw['num_paths']} pairs)", ker, ref,
                                labels, bit_for_bit=True)
        pins[name] = {"pairs": kw["num_paths"], "steps": kw["num_steps"],
                      "max_abs_err": err}
    kw = dict(num_paths=EXOTIC_PATHS // MESH_SHARDS, num_steps=STEPS_DEFAULT,
              antithetic=True, companion=True, device=device)
    err, _, _ = compare_stats(
        "at a shard's shape", ck.svj_path_stats(params, SPOT, T_DEFAULT, s1,
                                                **kw),
        ck.svj_path_stats_plain(params, SPOT, T_DEFAULT, s1, **kw))
    pins["svj_path_stats"] = {"pairs": kw["num_paths"],
                              "steps": STEPS_DEFAULT, "max_abs_err": err}

    # The drivers: run(mesh, seed, paths) on a mesh; with mesh=None the
    # unsharded engine (for the termsvj its core at β = 1, the estimator
    # the sharded driver pools).
    def mc(scheme):
        return lambda mesh, seed, n: pricer.MonteCarloEngine(
            params, num_paths=n, seed=seed, use_sobol=False, scheme=scheme,
            mesh=mesh, device=device).price(SPOT, STRIKE, T_DEFAULT)

    def exotic(kind):
        def run(mesh, seed, n):
            if mesh is not None:
                return pm.sharded_exotic_price(
                    params, SPOT, STRIKE, T_DEFAULT, seed, mesh=mesh,
                    kind=kind, num_paths=n, num_steps=STEPS_DEFAULT)
            eng = ExoticEngine(params, num_paths=n, seed=seed, device=device)
            return (eng.price_asian if kind == "asian"
                    else eng.price_digital)(SPOT, STRIKE, T_DEFAULT)
        return run

    def hhw_run(mesh, seed, n):
        if mesh is None:
            return HHWEngine(hp, num_paths=n, num_steps=128, seed=seed,
                             device=device).price(SPOT, STRIKE, 1.0)
        return pf.sharded_hhw_price(hp, SPOT, [STRIKE], 1.0, seed, mesh=mesh,
                                    num_paths=n, num_steps=128)

    def svcj_run(mesh, seed, n):
        return SVCJEngine(svcj_p, num_paths=n, seed=seed, mesh=mesh,
                          device=device).price(SPOT, STRIKE, T_DEFAULT)

    def td_run(mesh, seed, n):
        if mesh is not None:
            return termsvj.TDSVJEngine(
                params, *seg, num_paths=n, num_steps=td_steps, seed=seed,
                mesh=mesh, device=device).price(SPOT, STRIKE, T_DEFAULT)
        return termsvj.mc_price_td_cuda(
            params, *td_levels, SPOT, [STRIKE], T_DEFAULT, seed,
            num_paths=n, num_steps=td_steps, cv_beta="one", device=device)

    cases = (("price euler", "svj_terminal", NUM_PATHS, mc("euler")),
             ("price qe", "svj_terminal_qe", NUM_PATHS, mc("qe")),
             ("asian", "svj_path_stats", EXOTIC_PATHS, exotic("asian")),
             ("digital", "svj_terminal", EXOTIC_PATHS, exotic("digital")),
             ("hhw", "hhw_terminal", FAMILY_PAIRS, hhw_run),
             ("svcj", "svcj_terminal", FAMILY_PAIRS, svcj_run),
             ("termsvj", "svj_terminal_td", FAMILY_PAIRS, td_run))

    # 2. The unsharded engines, with their kernels' outputs.
    refs = {}
    for label, kname, n, run in cases:
        with KernelCapture(ck, kname) as cap:
            res = run(None, MESH_SEED, n)
        refs[label] = (price_pair(res), cap.outs[-1])

    # 3. The mesh path, counted.
    os.environ.pop("MCOS_AUTO_MESH", None)
    ck.reset_launch_counts()
    expect = {}
    out = {}
    for label, kname, n, run in cases:
        with KernelCapture(ck, kname) as cap:
            got = price_pair(run(one, MESH_SEED, n))
        (ref, ref_out) = refs[label]
        check(len(cap.outs) == 1 and bitwise_equal(cap.outs[0], ref_out),
              f"mesh {label}: one shard's {kname} outputs bit for bit")
        errs = [abs(g / r - 1.0) for g, r in zip(got, ref)]
        log(f"mesh {label}: one shard {got} vs unsharded {ref}: rel errs "
            f"price {errs[0]:.2e}, std_error {errs[1]:.2e} (rtol 1e-6); "
            f"{kname} outputs bit for bit")
        check(max(errs) <= 1e-6, f"mesh {label}: one shard = unsharded")
        with PoolCapture(pm) as whole:
            got4 = price_pair(run(four, MESH_SEED, n))
        with PoolCapture(pm) as parts:
            for i in range(MESH_SHARDS):
                run(one, pm.shard_seed(MESH_SEED, i), n // MESH_SHARDS)
        shard_dicts, pooled4 = whole.calls[-1]
        check(len(shard_dicts) == MESH_SHARDS, f"mesh {label}: 4 shards")
        singles = [c[0][0] for c in parts.calls]
        check(all(bitwise_equal(a, b) for a, b in zip(shard_dicts, singles)),
              f"mesh {label}: each shard = its one-shard run, bit for bit")
        check(bitwise_equal(pm.pool_shards(singles), pooled4),
              f"mesh {label}: 4 shards = their one-shard runs pooled")
        check(all(math.isfinite(x) for x in got4) and got4[1] > 0,
              f"mesh {label}: 4-shard result finite")
        expect[kname] = expect.get(kname, 0) + 1 + 2 * MESH_SHARDS
        out[label] = {"paths": n, "one_shard": got, "unsharded": ref,
                      "rel_err_price": errs[0], "rel_err_std_error": errs[1],
                      "four_shards": got4, "pooled_bit_equal": True}
        log(f"mesh {label}: 4 shards {got4}; each shard's moments bit for "
            f"bit its one-shard run, pooled in shard order")

    # MCOS_AUTO_MESH=1 on one card: no mesh, the unsharded price exactly.
    os.environ["MCOS_AUTO_MESH"] = "1"
    try:
        check(pricer.resolve_mesh(None) is None, "auto mesh on one card")
        auto = mc("euler")(None, MESH_SEED, NUM_PATHS)
    finally:
        os.environ.pop("MCOS_AUTO_MESH")
    plain_euler = mc("euler")(None, MESH_SEED, NUM_PATHS)
    check(auto == plain_euler, "MCOS_AUTO_MESH=1: the unsharded price")
    expect["svj_terminal"] += 2
    log(f"MCOS_AUTO_MESH=1 on {torch.cuda.device_count()} card(s): mesh "
        f"None, price {auto['price']} = unsharded, bit for bit")

    # The SLV: 4 shards fed the column blocks of one normal sheet step as
    # the one cloud of that sheet (their bin statistics pooled each step).
    strikes = SPOT * np.linspace(0.7, 1.3, 13)
    k = np.log(strikes / SPOT)
    surf = localvol.LocalVolSurface.from_iv_points(
        SPOT, strikes, [0.25, 0.5, 1.0],
        np.tile(0.2 - 0.15 * k + 0.2 * k * k, (3, 1)), r=0.05, q=0.01)
    heston = SVJParams(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04,
                       lambda_j=0.0, sigma_j=1e-4, r=0.05, q=0.01)
    slv_steps, ppd = 64, 50_000
    rows, t_mid = surf.step_tables(0.5, slv_steps)
    y0, dy = float(surf.y_grid[0]), float(surf.y_grid[1] - surf.y_grid[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    sheet = torch.randn((slv_steps, 2, MESH_SHARDS * ppd), generator=gen,
                        device=device)
    slv_k = [0.9 * SPOT, SPOT, 1.1 * SPOT]
    slv = {}
    for tag, mesh, draws in (
            ("one cloud", one, lambda i: sheet),
            ("4 shards", four,
             lambda i: sheet[:, :, i * ppd:(i + 1) * ppd])):
        t0 = time.perf_counter()
        res = pf.sharded_slv_price(heston, rows, t_mid, y0, dy, SPOT, slv_k,
                                   0.5, MESH_SEED, mesh=mesh,
                                   num_paths=MESH_SHARDS * ppd,
                                   num_steps=slv_steps, shard_draws=draws)
        torch.cuda.synchronize()
        slv[tag] = {"price": res["price"].tolist(),
                    "std_error": res["std_error"].tolist(),
                    "ms": (time.perf_counter() - t0) * 1e3}
    dev_se = [abs(a - b) / s for a, b, s in zip(
        slv["4 shards"]["price"], slv["one cloud"]["price"],
        slv["one cloud"]["std_error"])]
    log(f"SLV {MESH_SHARDS} x {ppd} particles x {slv_steps} steps: "
        f"{slv['4 shards']['price']} vs one cloud "
        f"{slv['one cloud']['price']}: {[round(d, 4) for d in dev_se]} se "
        f"(limit 1); {slv['4 shards']['ms']:.0f} ms vs "
        f"{slv['one cloud']['ms']:.0f} ms")
    check(max(dev_se) < 1.0, "SLV: 4 shards are one cloud")
    slv["deviation_se"] = dev_se

    torch.cuda.synchronize()
    launches = ck.launch_counts()
    log(f"mesh path launches: {launches}")
    for name, n in launches.items():
        check(n == expect.get(name, 0),
              f"mesh path: {name} launched {n} times, expected "
              f"{expect.get(name, 0)}")

    # 4. Wall time: 4 shards of cuda:0 against the unsharded engine at the
    # same total paths, warm, in turns (unsharded, 4, 4, unsharded).
    for label, kname, n, run in cases:
        run(None, MESH_SEED, n)
        run(four, MESH_SEED, n)
        t = [timed(lambda: run(m, MESH_SEED, n))
             for m in (None, four, four, None)]
        t_one, t_four = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        out[label].update(unsharded_ms=t_one, four_shard_ms=t_four)
        log(f"mesh {label} at {n} paths: 4 shards {t_four:.2f} ms vs "
            f"unsharded {t_one:.2f} ms (ratio {t_four / t_one:.2f}); on "
            f"{card}")
    wall = time.perf_counter() - t_phase
    log(f"mesh path {wall:.1f} s; on {card}")
    return {"launches": launches, "cases": out, "kernel_pins": pins,
            "slv": slv, "wall_s": wall, "card": card}


# ─────────────────────────────────────────────────────────────────────────────
# Slice N2: the sharded Sobol default, the programs with pooling of their
# own, calibrate(mesh=...), and two processes on cuda:0
# ─────────────────────────────────────────────────────────────────────────────
def k1_at(ck, members, z1, z2, u, zjs, seed, spot, T, reps=5) -> dict:
    """One K1 launch (a population of `members`, or one SVJParams) on the
    given draws against its plain version, bit for bit on S, v and G,
    timed beside its plain version and its bound. Not counted: call it
    outside a counted window."""
    kw = dict(seed=seed, antithetic=True, companion=True, steps_major=True)
    pop = isinstance(members, list)
    fn = (ck.svj_terminal_from_draws_population if pop
          else ck.svj_terminal_from_draws)
    plain = (ck.svj_terminal_from_draws_population_plain if pop
             else ck.svj_terminal_from_draws_plain)
    ker = fn(members, spot, T, z1, z2, u, zjs, **kw)
    ref = plain(members, spot, T, z1, z2, u, zjs, **kw)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(ker, ref)]
    err = float((ker[0] - ref[0]).abs().max())
    ms = cuda_ms(lambda: fn(members, spot, T, z1, z2, u, zjs, **kw), reps)
    plain_ms = cuda_ms(lambda: plain(members, spot, T, z1, z2, u, zjs, **kw),
                       reps=2)
    steps, n = z1.shape
    m = len(members) if pop else 1
    b = bound(k1_ops(m, streamed_u=u is not None), m * steps * n,
              (4 if u is not None else 3) * steps * n * 4,
              3 * m * 2 * n * 4)
    return {"shape": [m, steps, n], "bit_equal": same, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **b}


def mesh_n2_path(device, ck, card, sobol, cal, SVJParams):
    """Slice N2 on cuda:0. K1 at a 4-shard mesh's shard shape of the
    /api/price net (131 072 points of 2^19 × 63 steps) and at the
    calibrate shard's (12 members × 100 000 × 50) against its plain
    version, bit for bit. Counted: `sharded_sobol_price` at /api/price's
    defaults on one shard (at 2^19 paths and at 500 000) and on 4 shards,
    `calibrate(mesh=...)` at its defaults on 2 shards, and each of the
    seven other N2 programs once on one shard at its engine's default
    size. Then: one shard against the unsharded engines (K1's S, v, G bit
    for bit), each of the 4 Sobol shards its slice's launch alone, bit for
    bit, the 2-shard calibration the unsharded one exactly, the launches,
    MCOS_AUTO_MESH=1, and the 4-shard walls against the unsharded ones."""
    from mcos_tpu_torch.engine import american, exposure, greeks, mlmc
    from mcos_tpu_torch.engine import pde, pricer, risk
    from mcos_tpu_torch.engine.basket import BasketEngine
    from mcos_tpu_torch.engine.basket_american import price_bounds_basket
    from mcos_tpu_torch.parallel import mesh as pm
    from mcos_tpu_torch.profile_price import slice_i_body

    t_phase = time.perf_counter()
    params = SVJParams()
    one = pm.make_mesh([device])
    two = pm.make_mesh([device] * 2)
    four = pm.make_mesh([device] * MESH_SHARDS)
    n_net = 1 << int(np.ceil(np.log2(NUM_PATHS)))
    ppd = n_net // MESH_SHARDS
    steps = STEPS_DEFAULT
    out = {"net_points": n_net, "paths_per_shard": ppd}

    # 1. K1 at the shard shapes against its plain version (not counted).
    s1 = pm.shard_seed(MESH_SEED, 1)
    z1, z2, _, zjs = sobol.sobol_svj_draws_slice(ppd, n_net, ppd, steps,
                                                 seed=MESH_SEED,
                                                 device=device)
    shard_pin = k1_at(ck, params, z1, z2, None, zjs, s1, SPOT, T_DEFAULT)
    log(f"K1 at a Sobol shard's shape (shard 1: points [{ppd}, {2 * ppd}) "
        f"of 2^{n_net.bit_length() - 1} x {steps} steps, its seed): S, v, "
        f"G bit for bit {shard_pin['bit_equal']}; {shard_pin['ms']:.4f} ms,"
        f" plain {shard_pin['plain_ms']:.2f} ms, bound "
        f"{shard_pin['bound_ms']:.4f} ms ({shard_pin['bound_by']})")
    check(all(shard_pin["bit_equal"]), "K1 at the Sobol shard shape")
    whole = sobol.sobol_svj_draws(n_net, steps, seed=MESH_SEED,
                                  jump_uniforms=False, device=device)
    union = [sobol.sobol_svj_draws_slice(ppd, n_net, i * ppd, steps,
                                         seed=MESH_SEED, device=device)
             for i in range(MESH_SHARDS)]
    for j in (0, 1, 3):
        check(torch.equal(torch.cat([u[j] for u in union], dim=1),
                          whole[j]), "the 4 Sobol slices are the net")
    del whole, union
    log(f"the {MESH_SHARDS} Sobol slices put together: the {n_net}-point "
        f"net, bit for bit")
    body = slice_i_body("calibrate")
    cal_kw = dict(r=body["r"], q=body["q"])
    n_cal, steps_cal = (SLICE_I_SIZES["calibrate_paths"],
                        SLICE_I_SIZES["calibrate_steps"])
    members = SLICE_I_SIZES["calibrate_members"]
    draws = cal._calibration_draws(n_cal, steps_cal, pricer.seeded_generator(
        42, device))
    rng = np.random.default_rng(23)
    lo, hi = cal.HESTON_BOUNDS[:, 0], cal.HESTON_BOUNDS[:, 1]
    half = [SVJParams(**dict(zip(("kappa", "theta", "xi", "rho", "v0"),
                                 (lo + (hi - lo) * rng.random(5)).tolist())),
                      **cal_kw) for _ in range(members // 2)]
    cal_pin = k1_at(ck, half, *draws, 0, body["spot"], body["T"])
    log(f"K1 at a calibrate shard's shape ({members // 2} members x {n_cal} "
        f"x {steps_cal}, shared draws): bit for bit {cal_pin['bit_equal']};"
        f" {cal_pin['ms']:.4f} ms, plain {cal_pin['plain_ms']:.2f} ms, "
        f"bound {cal_pin['bound_ms']:.4f} ms ({cal_pin['bound_by']})")
    check(all(cal_pin["bit_equal"]), "K1 at the calibrate shard shape")

    # 2. The unsharded engines, K1's outputs captured (not counted).
    def sobol_engine(n, mesh=None):
        return pricer.MonteCarloEngine(params, num_paths=n, seed=MESH_SEED,
                                       mesh=mesh, device=device)

    refs = {}
    for n in (n_net, NUM_PATHS):
        with KernelCapture(ck, "svj_terminal_from_draws") as cap:
            refs[n] = (price_pair(sobol_engine(n).price(SPOT, STRIKE,
                                                        T_DEFAULT)),
                       cap.outs[-1])
    eng_cal = cal.CalibrationEngine(device=device)

    def calibrate(mesh=None, polish=True):
        return eng_cal.calibrate(body["spot"], body["strikes"], body["T"],
                                 body["market_prices"], mesh=mesh,
                                 polish=polish, **cal_kw)

    n0 = ck.svj_terminal_from_draws.launches
    cal_ref = calibrate()
    cal_launches = ck.svj_terminal_from_draws.launches - n0
    gre = greeks.GreeksEngine(params, device=device)
    g_steps = gre._steps(T_DEFAULT)
    amer = american.AmericanEngine(params, device=device)
    var_args = ([SPOT, 0.5 * SPOT], [0.2, 0.3], [[1.0, 0.4], [0.4, 1.0]],
                [0.6, 0.4], 0.1)
    xeng = exposure.ExposureEngine(
        [SPOT], [0.2], [[1.0]],
        [{"kind": "call", "strike": STRIKE, "T": 1.0, "qty": 1.0},
         {"kind": "put", "strike": 0.9 * STRIKE, "T": 0.5, "qty": -2.0}],
        device=device)
    beng = BasketEngine([SVJParams(), SVJParams(v0=0.06, theta=0.06)],
                        [[1.0, 0.5], [0.5, 1.0]], device=device)
    b_args = ([SPOT, SPOT], STRIKE, 1.0)
    peng = pde.HestonPDEEngine(params, device=device)
    chain = [(STRIKE * k, T_DEFAULT) for k in (0.9, 0.95, 1.0, 1.05, 1.1)]
    unsharded = {
        "greeks": lambda: gre._grads(SPOT, STRIKE, T_DEFAULT, True)[:2],
        "american": lambda: amer.price(SPOT, STRIKE, T_DEFAULT, False),
        "mlmc": lambda: mlmc.mlmc_price(params, SPOT, STRIKE, T_DEFAULT,
                                        eps=1.0, device=device),
        "var": lambda: risk.portfolio_var(*var_args, device=device),
        "exposure": lambda: xeng.profile(),
        "basket_bounds": lambda: price_bounds_basket(beng, *b_args),
        "pde_chain": lambda: [peng.price(SPOT, k, t) for k, t in chain]}
    sharded = {
        "greeks": lambda m: pm.sharded_all_greeks(
            params, SPOT, STRIKE, T_DEFAULT, gre.seed, mesh=m,
            num_paths=gre.num_paths, num_steps=g_steps),
        "american": lambda m: american.AmericanEngine(
            params, mesh=m, device=device).price(SPOT, STRIKE, T_DEFAULT,
                                                 False),
        "mlmc": lambda m: pm.sharded_mlmc_price(params, SPOT, STRIKE,
                                                T_DEFAULT, eps=1.0, mesh=m),
        "var": lambda m: risk.portfolio_var(*var_args, mesh=m,
                                            device=device),
        "exposure": lambda m: pm.sharded_exposure_profile(xeng, mesh=m),
        "basket_bounds": lambda m: pm.sharded_basket_bounds(beng, *b_args,
                                                            mesh=m),
        "pde_chain": lambda m: pm.sharded_pde_chain(
            peng, SPOT, chain, mesh=pm.make_mesh(list(m.devices),
                                                 axis_name="batch"))}
    ref7 = {}
    for name, fn in unsharded.items():
        t0 = time.perf_counter()
        ref7[name] = fn()
        torch.cuda.synchronize()
        log(f"unsharded {name}: {(time.perf_counter() - t0) * 1e3:.0f} ms")

    # 3. The N2 path, counted.
    os.environ.pop("MCOS_AUTO_MESH", None)
    ck.reset_launch_counts()
    t_count = time.perf_counter()
    with KernelCapture(ck, "svj_terminal_from_draws") as cap_one:
        one_net = price_pair(sobol_engine(n_net, one).price(SPOT, STRIKE,
                                                            T_DEFAULT))
        one_def = price_pair(sobol_engine(NUM_PATHS, one).price(
            SPOT, STRIKE, T_DEFAULT))
    with PoolCapture(pm) as whole4:
        four_res = price_pair(sobol_engine(NUM_PATHS, four).price(
            SPOT, STRIKE, T_DEFAULT))
    k1_sobol = ck.svj_terminal_from_draws.launches
    cal_two = calibrate(two)
    k1_by_route = {"sobol": k1_sobol, "calibrate":
                   ck.svj_terminal_from_draws.launches - k1_sobol}
    got7 = {}
    for name, fn in sharded.items():
        t0 = time.perf_counter()
        got7[name] = fn(one)
        torch.cuda.synchronize()
        log(f"one-shard {name}: {(time.perf_counter() - t0) * 1e3:.0f} ms")
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    count_s = time.perf_counter() - t_count
    expect = {"svj_terminal_from_draws": 2 + MESH_SHARDS + 2 * cal_launches}
    log(f"N2 path launches ({count_s:.1f} s): {launches}, K1 by route "
        f"{k1_by_route}; a calibration launches K1 {cal_launches} times "
        f"unsharded, once a generation")
    check(k1_by_route == {"sobol": 2 + MESH_SHARDS,
                          "calibrate": 2 * cal_launches},
          f"N2 path: K1 by route {k1_by_route}")
    for name, n in launches.items():
        check(n == expect.get(name, 0),
              f"N2 path: {name} launched {n} times, expected "
              f"{expect.get(name, 0)}")

    # 4. The comparisons.
    ref_net, ref_def = refs[n_net], refs[NUM_PATHS]
    check(bitwise_equal(cap_one.outs[0], ref_net[1]),
          "one-shard Sobol at 2^19: K1's S, v, G bit for bit")
    check(all(bool(torch.equal(a[..., :NUM_PATHS], b))
              for a, b in zip(cap_one.outs[1], ref_def[1])),
          "one-shard Sobol at 500 000: K1's first 500 000 paths bit for bit")
    errs = [abs(g / r - 1.0) for g, r in zip(one_net, ref_net[0])]
    log(f"sharded Sobol, one shard at {n_net} paths: {one_net} vs the "
        f"unsharded engine {ref_net[0]}: rel errs {errs[0]:.2e}, "
        f"{errs[1]:.2e} (rtol 1e-6); K1's S, v, G bit for bit; at "
        f"{NUM_PATHS} paths the shard prices the whole 2^19 net "
        f"{one_def} (the engine its first {NUM_PATHS} points, "
        f"{ref_def[0]}), K1's first {NUM_PATHS} paths bit for bit")
    check(max(errs) <= 1e-6, "one-shard sharded Sobol = the engine")
    shard_dicts, pooled4 = whole4.calls[-1]
    check(len(shard_dicts) == MESH_SHARDS, "4 Sobol shards pooled")
    for i in range(MESH_SHARDS):
        z1, z2, _, zjs = sobol.sobol_svj_draws_slice(
            ppd, n_net, i * ppd, steps, seed=MESH_SEED, device=device)
        s_f, v_f, g_f = ck.svj_terminal_from_draws(
            params, SPOT, T_DEFAULT, z1, z2, None, zjs,
            seed=pm.shard_seed(MESH_SEED, i), companion=True,
            steps_major=True)
        alone = pm.shard_moments(pm.beta_one_payoffs(
            params, SPOT, [STRIKE], T_DEFAULT, s_f, v_f, g_f, is_call=True,
            control_variate=True))
        check(bitwise_equal(shard_dicts[i], alone),
              f"Sobol shard {i}: its one-shard run, bit for bit")
    check(bitwise_equal(pm.pool_shards(shard_dicts), pooled4),
          "4 Sobol shards pooled in shard order")
    log(f"sharded Sobol, 4 shards of cuda:0 at {NUM_PATHS} (2^19 points): "
        f"{four_res}; each shard's moments bit for bit its slice's launch "
        f"alone")
    check(cal_two["params"] == cal_ref["params"]
          and all(cal_two[k] == cal_ref[k]
                  for k in ("stage1_result", "stage2_result")),
          "calibrate on 2 shards = unsharded, exactly")
    log(f"calibrate(mesh=2 shards of cuda:0) at {members} members x {n_cal}"
        f" x {steps_cal}: the unsharded fit exactly "
        f"({cal_two['stage1_result']}, {cal_two['stage2_result']})")
    progs = {}
    g = got7["greeks"]
    price, d_spot = ref7["greeks"]
    progs["greeks"] = [abs(g["price"] / price - 1),
                       abs(g["delta"] / d_spot - 1)]
    for name, keys in (("american", ("price", "std_error")),
                       ("mlmc", ("price", "std_error"))):
        progs[name] = [abs(got7[name][k] / ref7[name][k] - 1) for k in keys]
    check([lv["n"] for lv in got7["mlmc"]["levels"]]
          == [lv["n"] for lv in ref7["mlmc"]["levels"]], "MLMC levels")
    progs["var"] = [abs(got7["var"]["std"] / ref7["var"]["std"] - 1),
                    abs(got7["var"]["mean"] - ref7["var"]["mean"])
                    / ref7["var"]["std"]]
    progs["exposure"] = [max((abs(a / b - 1) for a, b in zip(
        got7["exposure"][k], ref7["exposure"][k]) if b), default=0.0)
        for k in ("ee", "ene", "gross_ee")]
    progs["basket_bounds"] = [abs(got7["basket_bounds"][k]
                                  / ref7["basket_bounds"][k] - 1)
                              for k in ("lower_bound", "upper_bound")]
    progs["pde_chain"] = [max(abs(a["price"] - b["price"]) for a, b in zip(
        got7["pde_chain"], ref7["pde_chain"]))]
    limits = {"greeks": 1e-5, "var": 1e-4, "pde_chain": 0.0}
    for name, errs in progs.items():
        lim = limits.get(name, 1e-6)
        log(f"{name}: one shard against the unsharded engine, errors "
            f"{[f'{e:.2e}' for e in errs]} (limit {lim:g})")
        check(max(errs) <= lim, f"{name}: one shard = unsharded")
    out["programs"] = {k: {"errors": v} for k, v in progs.items()}
    out["var"] = {"one_shard": got7["var"], "unsharded": ref7["var"]}

    # MCOS_AUTO_MESH=1 on one card: the default Sobol engine on one device.
    os.environ["MCOS_AUTO_MESH"] = "1"
    try:
        check(pricer.resolve_mesh(None) is None, "auto mesh on one card")
        auto = price_pair(sobol_engine(NUM_PATHS).price(SPOT, STRIKE,
                                                        T_DEFAULT))
    finally:
        os.environ.pop("MCOS_AUTO_MESH")
    check(auto == ref_def[0], "MCOS_AUTO_MESH=1: the unsharded Sobol price")
    log(f"MCOS_AUTO_MESH=1 on {torch.cuda.device_count()} card(s): the "
        f"default Sobol engine's price {auto}, unsharded, bit for bit")

    # 5. Walls, warm, in turns (unsharded, 4, 4, unsharded).
    walls = {}
    for label, run in (
            ("sobol 500000 x 63", lambda m: sobol_engine(NUM_PATHS, m).price(
                SPOT, STRIKE, T_DEFAULT)),
            ("calibrate DE (no polish)", lambda m: calibrate(m, False))):
        run(four)
        t = [timed(lambda m=m: run(m)) for m in (None, four, four, None)]
        walls[label] = {"unsharded_ms": (t[0] + t[3]) / 2,
                        "four_shard_ms": (t[1] + t[2]) / 2, "turns_ms": t}
        log(f"{label}: 4 shards of cuda:0 {walls[label]['four_shard_ms']:.1f}"
            f" ms vs unsharded {walls[label]['unsharded_ms']:.1f} ms "
            f"(turns {[round(x, 1) for x in t]}); on {card}")
    wall = time.perf_counter() - t_phase
    log(f"N2 path {wall:.1f} s; on {card}")
    out.update(launches=launches, k1_by_route=k1_by_route,
               shard_pin=shard_pin, calibrate_pin=cal_pin,
               calibrate_launches_unsharded=cal_launches,
               sobol={"one_shard_net": one_net, "unsharded_net": ref_net[0],
                      "one_shard_500k": one_def,
                      "unsharded_500k": ref_def[0], "four_shards": four_res},
               walls=walls, wall_s=wall, card=card)
    return out


def distributed_path(device, ck, card):
    """Two processes on cuda:0 with gloo (NCCL refuses two ranks on one
    GPU) run `parallel/distributed.py:_demo_price` at 500 000 × 63: both
    ranks' price and standard error bit for bit each other's and the
    in-process 2-shard mesh's. Counted: the in-process run's launches (the
    children count their own, reported in their lines)."""
    import socket

    from mcos_tpu_torch.parallel import distributed as pdist

    t_phase = time.perf_counter()
    local = [str(device)] * 2
    pdist._demo_price(NUM_PATHS, STEPS_DEFAULT, local)      # warm
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    one = pdist._demo_price(NUM_PATHS, STEPS_DEFAULT, local)
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    check(launches["svj_terminal"] == 2, "in-process 2 shards: 2 K3")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "mcos_tpu_torch.parallel.distributed",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--backend", "gloo", "--device", "cuda", "--num-paths",
           str(NUM_PATHS), "--num-steps", str(STEPS_DEFAULT), "--timeout",
           "60"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            check(p.returncode == 0, f"rank failed:\n{stderr[-3000:]}")
            outs.append(json.loads([ln for ln in stdout.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    spawn_s = time.perf_counter() - t0
    for o in outs:
        log(f"rank {o['process_id']}/{o['num_processes']} on "
            f"{o['devices']}: price {o['price']}, std_error "
            f"{o['std_error']}; its call {o['wall_s'] * 1e3:.1f} ms (first "
            f"in a fresh process), {o['collectives']} gather "
            f"{o['collective_s'] * 1e3:.2f} ms (gloo, through the host)")
    check(outs[0]["price"] == outs[1]["price"]
          and outs[0]["std_error"] == outs[1]["std_error"],
          "both ranks return the same bits")
    check(outs[0]["price"] == one["price"]
          and outs[0]["std_error"] == one["std_error"],
          "2 processes = 1 process x 2 shards, bit for bit")
    log(f"2 processes x 1 shard on cuda:0 (gloo) = 1 process x 2 shards, "
        f"bit for bit: {one['price']}; in-process warm call "
        f"{one['wall_s'] * 1e3:.1f} ms; the 2 processes from spawn to exit "
        f"{spawn_s:.1f} s; on {card}")
    wall = time.perf_counter() - t_phase
    log(f"distributed path {wall:.1f} s")
    return {"launches": launches, "ranks": outs, "in_process": one,
            "spawn_to_exit_s": spawn_s, "wall_s": wall, "card": card}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    from mcos_tpu_torch import bench
    from mcos_tpu_torch.api import server
    from mcos_tpu_torch.engine.exotics import ExoticEngine
    from mcos_tpu_torch.engine import greeks
    from mcos_tpu_torch.engine.pricer import price_term_structure
    from mcos_tpu_torch.models.params import (SVCJParams, SVJParams,
                                              TermStructureSVJ, gbm_params)
    from mcos_tpu_torch.ops import cuda_kernels as ck
    from mcos_tpu_torch.ops import exotics as ox
    from mcos_tpu_torch.ops.exotics import barrier_bs
    from mcos_tpu_torch.engine import american, pde, regime, risk, termsvj
    from mcos_tpu_torch.engine import calibration as cal
    from mcos_tpu_torch.engine import localvol, slv, ssvi
    from mcos_tpu_torch.engine import rough as rough_engine
    from mcos_tpu_torch.ops import hhw, rough, sobol, svcj, tdsvj
    from mcos_tpu_torch.ops.bs import bs_all_greeks, bs_price
    from mcos_tpu_torch.ops.cos_pricer import cos_price

    offline_urlopen()
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    ck.load_library()
    log(f"kernel build (nvcc sm_90a) + load: {ck.build_seconds():.2f} s")
    resources = kernel_resources(ck._LIBRARY.path)
    fattest = [v for k, v in resources.items() if "ILi2ELi3ELb1EE" in k]
    log(f"K6 registers per thread over its {len(resources)} instantiations: "
        f"{sorted({v[0] for v in resources.values()})}; corridor + companion"
        f" (registers, stack bytes): {fattest or 'cuobjdump not found'}")

    gbm_res = kernel_resources(ck._LIBRARY.path, "gbm_kernel")
    log(f"K2 (registers, stack bytes): {gbm_res}")
    fam = kernel_resources(ck._LIBRARY.path,
                           "hhw_kernel|svcj_kernel|svj_td_kernel")
    log(f"K7-K9 (registers, stack bytes) per instantiation: {fam}")
    qe_res = kernel_resources(ck._LIBRARY.path, "svj_qe_draws_kernel")
    log(f"K5 (registers, stack bytes) per instantiation: {qe_res}")
    rough_res = kernel_resources(ck._LIBRARY.path,
                                 "rbergomi_lift_kernel|rbergomi_stats_kernel")
    log(f"K10-K11 (registers, stack bytes) per instantiation: {rough_res}")

    params = SVJParams()
    k1 = check_k1(device, ck, sobol, params)
    k2 = check_k2(device, ck, bs_price)
    k3 = check_prng(device, ck, params, "svj_terminal")
    k4 = check_prng(device, ck, params, "svj_terminal_qe")
    k5 = check_k5(device, ck, sobol, params)
    k6 = check_k6(device, ck, params)
    k7 = check_k7(device, ck, hhw)
    k8 = check_k8(device, ck, SVCJParams)
    k9 = check_k9(device, ck, tdsvj, params)
    viz = check_viz(device, ck, params)
    # The route's instantiations: two branches, exactly 25 factors.
    route = {k: v for k, v in rough_res.items() if "ILi2ELi25ELb1E" in k}
    k10 = check_rough_kernel(device, ck, rough, "rbergomi_lift_integrals",
                             next((v for k, v in route.items()
                                   if "rbergomi_lift_kernel" in k), None))
    k11 = check_rough_kernel(device, ck, rough, "rbergomi_lift_stats",
                             next((v for k, v in route.items()
                                   if "rbergomi_stats_kernel" in k), None))
    mp = main_path(device, ck, bench, cos_price, bs_price, SVJParams, server)
    op = options_path(device, ck, cos_price, bs_price, SVJParams, server)
    xp = exotics_path(device, ck, ox, ExoticEngine, gbm_params, server)
    log(f"warm /api/exotic (asian) latency: median "
        f"{xp['warm_latency_ms']:.2f} ms over 5 "
        f"({[round(x, 2) for x in xp['warm_latencies_ms']]}); server-side "
        f"elapsed_ms {xp['server_elapsed_ms']}; exotics path "
        f"{xp['wall_s']:.1f} s")
    mix = k6_mix(device, ck, params, xp["k6_variants"])
    xp["k6_variants"] = mix
    fp = families_path(device, ck, hhw, svcj, tdsvj, server)
    rp = rough_path(device, ck, rough, rough_engine, ExoticEngine,
                    gbm_params, server)
    gp = greeks_path(device, ck, server, greeks, bs_all_greeks, cos_price,
                     SVJParams, TermStructureSVJ, price_term_structure)
    log(f"warm /api/greeks (200 000 paths, 63 steps, every all_greeks "
        f"block): median {gp['warm_greeks_ms']:.2f} ms; /api/smile mc "
        f"{gp['warm_smile mc_ms']:.2f} ms, cos {gp['warm_smile cos_ms']:.2f}"
        f" ms; with_second_order peak device memory "
        f"{gp['second_order_peak_gib']:.3f} GiB at T = 0.25, "
        f"{gp['second_order_T1_peak_gib']:.3f} GiB at T = 1; on {card}")
    gr = risk_path(device, ck, server, risk, regime, cos_price, bs_price,
                   SVJParams)
    log(f"warm risk desk over HTTP: /api/stress report "
        f"{gr['warm_stress report_ms']:.2f} ms, /api/hedge gbm "
        f"{gr['warm_hedge gbm_ms']:.2f}, svj {gr['warm_hedge svj_ms']:.2f}, "
        f"/api/var gaussian {gr['warm_var gaussian_ms']:.2f}, student_t "
        f"{gr['warm_var student_t_ms']:.2f}, /api/regime "
        f"{gr['warm_regime_ms']:.2f} ms; /api/var 2M x 16 "
        f"{gr['var_2m_x16']['ms']:.1f} ms, its own peak "
        f"{gr['var_2m_x16']['peak_gib'] - gr['var_2m_x16']['held_gib']:.3f}"
        f" GiB; on {card}")
    ap = american_path(device, ck, server, american, pde, termsvj, bs_price,
                       barrier_bs, SVJParams)
    log(f"warm slice H over HTTP: /api/american "
        f"{ap['warm_american_ms']:.2f} ms, with_bounds "
        f"{ap['warm_american with_bounds_ms']:.2f}, with_greeks "
        f"{ap['warm_american with_greeks_ms']:.2f}; /api/pde heston "
        f"{ap['warm_pde heston_ms']:.2f}, bs {ap['warm_pde bs_ms']:.2f} ms; "
        f"on {card}")
    k1_cal = k1_calibration_pin(device, ck, cal, cos_price, SVJParams)
    cp = calibration_path(device, ck, server, cal, localvol, slv, ssvi,
                          cos_price, bs_price, SVJParams)
    cp["k1_calibration_shape"] = k1_cal
    dp = desk_path(device, ck, server, cos_price, bs_price, bs_all_greeks,
                   SVJParams, gbm_params)
    kp = multiasset_path(device, ck, server, bs_price, SVJParams, gbm_params)
    lp = roughheston_path(device, ck, server, cos_price, SVJParams)
    sp = mesh_path(device, ck, card, SVJParams, SVCJParams, hhw, localvol)
    n2 = mesh_n2_path(device, ck, card, sobol, cal, SVJParams)
    dist = distributed_path(device, ck, card)
    log(f"warm slices L + M over HTTP (median of 5): /api/roughheston price "
        f"{lp['warm_price_ms']:.1f} ms, greeks {lp['warm_greeks_ms']:.1f}, "
        f"smile {lp['warm_smile_ms']:.1f} ms; on {card}")
    log(f"warm slice K over HTTP (median of 3): /api/basket "
        f"{kp['warm_basket_ms']:.2f} ms, Bermudan {kp['warm_bermudan_ms']:.2f}"
        f", /api/cliquet {kp['warm_cliquet_ms']:.2f}, /api/quanto "
        f"{kp['warm_quanto_ms']:.2f}, /api/autocall "
        f"{kp['warm_autocall_ms']:.2f} ms; on {card}")
    log(f"warm slice J over HTTP (median of 3): /api/pnl "
        f"{dp['warm_pnl_ms']:.2f} ms, /api/margin {dp['warm_margin_ms']:.2f},"
        f" /api/replicate {dp['warm_replicate_ms']:.2f}, /api/volderivs "
        f"{dp['warm_volderivs_ms']:.2f}, /api/book {dp['warm_book_ms']:.2f}, "
        f"/api/exposure {dp['warm_exposure_ms']:.2f}, /api/modelrisk "
        f"{dp['warm_modelrisk_ms']:.2f} ms; on {card}")
    log(f"warm slice I over HTTP: /api/calibrate "
        f"{cp['warm_calibrate_ms']:.1f} ms, /api/surface "
        f"{cp['warm_surface_ms']:.2f}, /api/quotegreeks "
        f"{cp['warm_quotegreeks_ms']:.2f}, /api/localvol "
        f"{cp['warm_localvol_ms']:.2f}, /api/slv {cp['warm_slv_ms']:.2f} ms; "
        f"on {card}")

    # (name, source, TPU kernel body, its check, the path that launched it)
    table = (
        ("svj_terminal_from_draws", "svj_draws.cu", 490, k1, mp),
        ("gbm_terminal", "gbm.cu", 1386, k2, mp),
        ("svj_terminal", "svj.cu", 299, k3, op),
        ("svj_terminal_qe", "svj_qe.cu", 769, k4, op),
        ("svj_terminal_qe_from_draws", "svj_qe_draws.cu", 966, k5, op),
        # K6's line carries the default Asian request's variant; its
        # max_abs_err is the worst over all variants, which are listed
        # under "variants".
        ("svj_path_stats", "svj_stats.cu", 1141,
         dict(k6["no bridge + companion"],
              max_abs_err=max(v["max_abs_err"] for v in k6.values())), xp),
        ("hhw_terminal", "hhw.cu", 1498, k7, fp),
        ("svcj_terminal", "svcj.cu", 1658, k8, fp),
        ("svj_terminal_td", "svj_td.cu", 1833, k9, fp),
        ("rbergomi_lift_integrals", "rbergomi_lift.cu", 2015, k10, rp),
        ("rbergomi_lift_stats", "rbergomi_stats.cu", 2162, k11, rp),
        ("svj_viz", "svj_viz.cu", None, viz, mp),
    )
    paths = {"main": mp, "options": op, "exotics": xp, "families": fp,
             "rough": rp, "greeks": gp, "risk": gr, "american": ap,
             "calibration": cp, "desk": dp, "multiasset": kp,
             "roughheston": lp, "mesh": sp, "mesh_n2": n2,
             "distributed": dist}
    # No single PyTorch call computes any of these simulations: library_ms
    # is null for every kernel.
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"mcos_tpu_torch/csrc/{src}",
         "replaces": (f"mcos_tpu/ops/pallas_kernels.py:{line}" if line
                      else "none: the lax.scan twins of "
                           "mcos_tpu/ops/simulate.py"),
         "launches": path["launches"][name],
         "launches_by_path": {p: paths[p]["launches"][name] for p in paths},
         "max_abs_err": res["max_abs_err"], "ms": res["ms"],
         "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
         "bound_by": res["bound_by"], "library_ms": None}
        for name, src, line, res, path in table]
    pop = k1_cal["population"]
    kernels[0]["shapes"] = [
        {"shape": "1 x 500000 x 63 (/api/price)", "launches": mp["launches"][
            "svj_terminal_from_draws"],
         **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")}},
        {"shape": "24 x 100000 x 50 (/api/calibrate)",
         "launches": cp["launches"]["svj_terminal_from_draws"],
         "single_x24_ms": pop["single_x24_ms"],
         "from_params_ms": pop["from_params_ms"],
         "single_x24_from_params_ms": pop["single_x24_from_params_ms"],
         **{k: pop[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by")}},
        {"shape": f"{MESH_SHARDS} shards x 1 x {n2['paths_per_shard']} x "
                  f"{STEPS_DEFAULT} (sharded /api/price: {MESH_SHARDS} "
                  f"shards, 2 one-shard runs)",
         "launches": n2["k1_by_route"]["sobol"],
         **{k: n2["shard_pin"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by")}},
        {"shape": f"2 shards x {n2['calibrate_pin']['shape'][0]} x "
                  f"{n2['calibrate_pin']['shape'][2]} x "
                  f"{n2['calibrate_pin']['shape'][1]} (calibrate(mesh=))",
         "launches": n2["k1_by_route"]["calibrate"],
         **{k: n2["calibrate_pin"][k] for k in ("max_abs_err", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by")}}]
    kernels[-1]["shapes"] = viz["shapes"]
    kernels[5]["variants"] = [
        {"name": name, **{k: v[k] for k in ("steps", "max_abs_err", "ms",
                                            "plain_ms", "bound_ms",
                                            "bound_by")}}
        for name, v in k6.items()]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": ck.build_seconds(), "k1": k1,
                   "k2": k2, "k3": k3, "k4": k4, "k5": k5, "k6": k6,
                   "k7": k7, "k8": k8, "k9": k9, "k10": k10, "k11": k11,
                   "svj_viz": viz,
                   "k2_resources": gbm_res,
                   "k5_resources": qe_res,
                   "k6_resources": resources, "k7_k9_resources": fam,
                   "k10_k11_resources": rough_res, "main_path": mp,
                   "options_path": op, "exotics_path": xp,
                   "families_path": fp, "rough_path": rp,
                   "greeks_path": gp, "risk_path": gr,
                   "american_path": ap, "calibration_path": cp,
                   "desk_path": dp, "multiasset_path": kp,
                   "roughheston_path": lp, "mesh_path": sp,
                   "mesh_n2_path": n2, "distributed_path": dist}, f,
                  indent=1)
    log(f"chip_smoke.py total {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # the nvidia-smi line as it came
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
