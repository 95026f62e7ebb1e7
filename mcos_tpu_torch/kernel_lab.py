"""Look inside the eleven hand-written kernels on one CUDA card: K1
(`csrc/svj_draws.cu`), K2 (`csrc/gbm.cu`), K3 (`csrc/svj.cu`), K4
(`csrc/svj_qe.cu`), K5 (`csrc/svj_qe_draws.cu`), K6 (`csrc/svj_stats.cu`),
K7 (`csrc/hhw.cu`),
K8 (`csrc/svcj.cu`), K9 (`csrc/svj_td.cu`), K10 (`csrc/rbergomi_lift.cu`)
and K11 (`csrc/rbergomi_stats.cu`): what the compiler made of them, how
accurate their special functions are, and how fast one version runs
against another.

    python -m mcos_tpu_torch.kernel_lab [--csrc LABEL=DIR ...]
        [--kernels k1,k2,k3,k4,k5,k6,k7,k8,k9,k10,k11] [--sass] [--dump DIR]
        [--probes] [--time] [--levers] [--wrappers LABEL=ROOT ...]
        [--out FILE]

Each `--csrc LABEL=DIR` names a directory holding a version of the chosen
kernels' sources and `philox.cuh` (default: `new=` the package's own
`csrc/`). Every version is compiled (all at once, one nvcc per source,
with the package's NVCC_FLAGS plus `-Xptxas -v`) into its own shared
library. `--kernels` picks the kernels (default all eleven). `--levers`
adds, for K3, K4, K5 and K7, one version per lever of the "new" design
with that lever taken out alone (`_LEVERS`), timed in turns with the rest.

- Always: per kernel, the registers, stack and spills that ptxas reports,
  and from the registers the blocks of 256 threads an SM holds and the
  waves the kernel's timed launch takes on 132 SMs (`occupancy`).
- `--sass`: from `cuobjdump -sass`, the instructions of each loop (a
  backward branch and the code it jumps over) by class: FFMA, FADD, FMUL;
  DFMA, DADD, DMUL and F2F by direction (F2F.F64.F32 to double,
  F2F.F32.F64 back); IMAD, IMAD.WIDE, IADD3, LOP3, SHF; I2F, F2I; MUFU by
  function; loads; branches and calls; and what each conditional forward
  branch inside it jumps over. For K10 and K11 the pair-steps a pass
  covers are its MUFU.EX2 count over the exps a step takes (one a branch
  in K10, two in K11), for K3, K4 and K6-K9 its Philox calls (from the
  products by the two Philox multipliers: `pair_steps_from_calls`; two
  steps a call in K3 and K9, one in K4), for K5 its draw loads (three a
  path-step, four with loaded jump uniforms: `k5_steps`), for K1 its
  square roots (two a member path-step: `k1_steps`), and the counts are
  also given per pair-step (per path-step for K5, per member path-step
  for K1). `--dump DIR` writes
  each kernel's listing there to read it.
- `--probes`: K2 and K9 over all 2^23 uniforms of the grid
  ((m + 1/2) 2^-23), the error of K2's Box-Muller radius and angle
  functions against float64 (`gbm.cu:box_muller_fast`), and whether
  `sincosf` (K3, K4 and K6-K11's Box-Muller) gives the bits of `sinf`,
  `cosf` and of torch's `sin`/`cos` (the plain versions') on the angle
  2 pi u; K5 over
  every float32 in (0, 1), whether Acklam's inverse with a float FMA a
  Horner step, and K5's own converged form, give the bits of the double
  step (`acklam_probe`).
- `--time`: the versions in turns (A B ... B A), CUDA events: K1 at
  `/api/price`'s one member x 500 000 paths x 63 steps (in-kernel jump
  uniforms), at `/api/calibrate`'s 24-member generation x 100 000 x 50
  (streamed uniforms; one launch, or one launch a member in a version
  without the population entry point, as the parent source) and one
  member there (`K1_CASES`); K2 at
  2^20 pairs x 252 steps and at the benchmark's 2^22 x 1024; K5 at the QE
  route's 500 000 paths x 63 steps on the Sobol QE net (in-kernel and
  loaded jump uniforms), its read floor and compute floor (`_K5_LAB_SRC`)
  and 405 504 and 608 256 paths; K3 and K4 at the PRNG route's 500 000
  pairs x 63 steps with the companion, and at 405 504 and 608 256 pairs;
  K6 at the exotic route's 200 000 pairs in chip_smoke.py's five
  variants, and the Asian and the corridor + companion over 135 168,
  160 000 and 264 000 pairs; K7 at 200 000 pairs x 128 steps and at
  160 000 and 264 000 pairs; K8 at 200 000 pairs x 252
  and x 63 steps with the companion; K9 at 200 000 pairs x 512 and x 4096
  steps with the companion, its table on the device ("kernel") and copied
  from the host before every launch, as a wrapper without a device cache
  does ("upload"); K10 and K11 at the route's 131 072 pairs x 512 and x
  511 steps with 25 lift factors (H = 0.07). Each version's outputs are
  first held against the plain torch versions (K1 at its cases and a
  ragged 25 x 100 001 x 63, with each member against its one-member
  launch, word for word, and the bit-equal share of S, v and G; K3, K4,
  K5's v, and K6-K11,
  bit for bit: K3 and K4 at the route's shape, at 200 003 pairs x 13 steps
  and with one branch and no companion at 10 007 x 64, K4 also at K5's psi
  cases (`K4_PSI_CHECKS`); K5 at the route's shape and where its QE
  transition takes both branches, both jump modes; K6 in the five
  variants, the barrier below with a window at 200 003 pairs x 13 steps
  and the corridor at v0 = 0;
  K7 at 128, 127 and 1 steps with one and two branches; K8 at 252 and 63
  steps, with and without the companion, at lambda = 0, 1 and 8; K10/K11
  also at 24 factors, at one and in the guarded fallback).

- `--wrappers LABEL=ROOT ...`: K1's Python wrappers, each ROOT a tree
  holding a version of the `mcos_tpu_torch` package (e.g. a `git archive`
  of another commit), in turns (A B ... B A, twice), one process a turn
  (`_WRAPPER_TIMER`): `svj_terminal_from_draws` from an SVJParams at one
  member x 500 000 x 63 and x 50 000 x 63 (in-kernel jump uniforms), and a
  24-member generation x 100 000 x 50 from SVJParams as the calibration
  calls it (`svj_terminal_from_draws_population`, or one call a member in
  a version without it); each the time a call in a loop of calls (host
  and card overlapped), the host's time until the call returns, and one
  call's latency to a synchronised result.

Prints a summary and writes everything to `--out` (default
mcos_tpu_torch/_build/lab/kernel_lab.json). Needs a CUDA card and nvcc;
the card's `nvidia-smi` name and power limit go beside every number.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from mcos_tpu_torch.ops import cuda_kernels as ck

_LAB_DIR = os.path.join(ck.BUILD_DIR, "lab")
# The kernels the lab knows, by short name: their source.
_KERNELS = {"k1": "svj_draws.cu", "k2": "gbm.cu", "k3": "svj.cu",
            "k4": "svj_qe.cu",
            "k5": "svj_qe_draws.cu", "k6": "svj_stats.cu", "k7": "hhw.cu",
            "k8": "svcj.cu", "k9": "svj_td.cu", "k10": "rbergomi_lift.cu",
            "k11": "rbergomi_stats.cu"}
# Each kernel's name as it stands in a mangled symbol. K3's and K4's carry
# the mangled length prefix and the template opener `I`, so that
# `svj_kernel` finds neither `svj_qe_kernel`, `svj_td_kernel`,
# `svj_qe_draws_kernel` nor `svj_stats_kernel`, and `svj_qe_kernel` not
# `svj_qe_draws_kernel`; K1's its length prefix, so that it does not find
# `svj_qe_draws_kernel` either.
_SASS_PATTERN = {"k1": "16svj_draws_kernel", "k2": "gbm_kernel",
                 "k3": "10svj_kernelI",
                 "k4": "13svj_qe_kernelI", "k5": "svj_qe_draws_kernel",
                 "k6": "svj_stats_kernel", "k7": "hhw_kernel",
                 "k8": "svcj_kernel", "k9": "svj_td_kernel",
                 "k10": "rbergomi_lift_kernel",
                 "k11": "rbergomi_stats_kernel"}

# The card (NVIDIA H100 SXM): 132 SMs of 65 536 registers, handed out to
# a warp in units of 256 (8 a thread), at most 64 warps and 32 blocks an SM.
SMS, REGS_PER_SM, REG_UNIT, MAX_WARPS, MAX_BLOCKS = 132, 65_536, 8, 64, 32
# Its shared memory: 228 KiB an SM, 1 KiB of it reserved for each block.
SMEM_PER_SM, SMEM_RESERVED = 228 * 1024, 1024

# Probe kernels over the uniform grid. The file includes the version's
# gbm.cu and svj_td.cu, so the probes call the very helpers the kernels do.
_PROBE_SRC = r'''
#include "gbm.cu"
#include "svj_td.cu"

namespace {
__device__ __forceinline__ float grid_u(int m) {
  return mcos::bits_to_uniform_bitcast(static_cast<uint32_t>(m) << 9);
}
__global__ void k2_bm_probe(float* out, int n) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  float za, zb;
  box_muller_fast(grid_u(m), 0.75f, za, zb);  // zb = r sin(3 pi / 2) = -r
  out[m] = -zb;
  box_muller_fast(0.36787944f, grid_u(m), za, zb);   // radius sqrt 2
  out[n + m] = za;
  out[2 * n + m] = zb;
}
__global__ void sincos_probe(float* out, int n) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  const float ang = __fmul_rn(mcos::kTwoPi, grid_u(m));
  float s, c;
  sincosf(ang, &s, &c);
  out[m] = ang;
  out[n + m] = s;
  out[2 * n + m] = c;
}
__global__ void sin_probe(float* out, int n) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  out[m] = sinf(__fmul_rn(mcos::kTwoPi, grid_u(m)));
}
__global__ void cos_probe(float* out, int n) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  out[m] = cosf(__fmul_rn(mcos::kTwoPi, grid_u(m)));
}
}  // namespace

extern "C" int mcos_probe(int which, float* out, int n) {
  const int blocks = (n + 255) / 256;
  switch (which) {
    case 0: k2_bm_probe<<<blocks, 256>>>(out, n); break;
    case 1: sincos_probe<<<blocks, 256>>>(out, n); break;
    case 2: sin_probe<<<blocks, 256>>>(out, n); break;
    case 3: cos_probe<<<blocks, 256>>>(out, n); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
'''
_GRID = 1 << 23

# The eager Andersen QE transition (pallas_kernels.py:_qe_variance_step):
# both branches computed, then one selected, in the operations and order of
# ops/simulate.py:qe_variance_step. No kernel runs it: the lab keeps it for
# the K5 lever that puts it back (`k5_eager_qe`) and for the compute floor
# of K5's two-region design. Guarded, as a lever's svj_qe_draws.cu and the
# K5 lab file that includes it both carry it.
_QE_EAGER_SRC = r'''
#ifndef MCOS_LAB_QE_EAGER
#define MCOS_LAB_QE_EAGER
namespace lab {
__device__ __forceinline__ float qe_eager(float v, float z_v, float u_v,
                                          const mcos::QeConsts& c) {
  const float m = __fadd_rn(c.theta, __fmul_rn(v - c.theta, c.e_kdt));
  const float s2 = __fadd_rn(__fmul_rn(v, c.var1), c.var2);
  const float psi = s2 / fmaxf(__fmul_rn(m, m), 1e-20f);
  const float two_over_psi = 2.0f / fmaxf(psi, 1e-12f);
  const float b2 = fmaxf(
      __fadd_rn(two_over_psi - 1.0f,
                __fmul_rn(sqrtf(fmaxf(two_over_psi, 1e-12f)),
                          sqrtf(fmaxf(two_over_psi - 1.0f, 0.0f)))),
      0.0f);
  const float a = m / (1.0f + b2);
  const float x = sqrtf(b2) + z_v;
  const float v_quad = __fmul_rn(a, __fmul_rn(x, x));
  const float p_mass = fminf(fmaxf((psi - 1.0f) / (psi + 1.0f), 0.0f), 0.999f);
  const float beta = (1.0f - p_mass) / fmaxf(m, 1e-20f);
  const float u_clip = fminf(fmaxf(u_v, 1e-7f), mcos::kUMax);
  const float v_exp =
      (u_v <= p_mass)
          ? 0.0f
          : logf((1.0f - p_mass) / fmaxf(1.0f - u_clip, 1e-12f)) /
                fmaxf(beta, 1e-20f);
  return psi <= 1.5f ? v_quad : v_exp;
}
}  // namespace lab
#endif
'''

# K5's lab library: its two floors and the exhaustive Acklam probe. The
# file includes the version's svj_qe_draws.cu (and through it philox.cuh).
#   - read floor: the kernel's three loads a step (z_x, u_v, z_js), summed
#     into one carry: what reading the net alone costs.
#   - compute floor: the kernel's step on draws made from the path and step
#     index, no loads (u_v puts one lane of a warp in each 1/32 of (0, 1),
#     as the Sobol net does; the jump uniforms from the Philox stream).
#     A version whose svj_qe_draws.cu has a `launch_qe_draws` template runs
#     its own kernel with `IndexDraws` in place of the loads; for one
#     without (the two-region design) the floor is that design's loop
#     body, copied.
#   - probe: Acklam's inverse over every float32 in (0, 1) (bit patterns 1
#     to 0x3f7fffff) against mcos::acklam_ndtri (the double Horner step,
#     the plain version's arithmetic): form 0 a float-only step fmaf(acc,
#     x, c); form 1 the version's K5 inverse, where it has one
#     (`acklam_converged`). The u whose outputs differ are counted, and the
#     first `cap` are kept with both outputs.
_K5_LAB_SRC = '\n#include "svj_qe_draws.cu"\n' + _QE_EAGER_SRC + r'''

namespace {

__device__ __forceinline__ void index_draws(uint32_t p, int t, float& z_x,
                                            float& u_v, float& z_j) {
  uint32_t h = (p ^ (static_cast<uint32_t>(t) * 0x9E3779B9u)) * 0x85EBCA6Bu;
  h ^= h >> 13;
  const float frac = mcos::bits_to_uniform_bitcast(h * 0xC2B2AE35u);
  u_v = fminf((static_cast<float>((p ^ static_cast<uint32_t>(t)) & 31u) +
               frac) * 0.03125f, 0.99999994f);
  z_x = frac - 0.5f;
  z_j = 0.5f - frac;
}

struct IndexDraws {
  __device__ __forceinline__ void operator()(size_t, uint32_t p, int t,
                                             float& z_x, float& u_v,
                                             float& z_j) const {
    index_draws(p, t, z_x, u_v, z_j);
  }
};

__global__ void __launch_bounds__(256)
    k5_read_floor(const float* __restrict__ zx, const float* __restrict__ uv,
                  const float* __restrict__ zjs, float* __restrict__ out,
                  long long n, int steps) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float acc = 0.0f;
  size_t off = static_cast<size_t>(p);
  for (int t = 0; t < steps; ++t, off += static_cast<size_t>(n)) {
    acc += __ldg(zx + off) + __ldg(uv + off) + __ldg(zjs + off);
  }
  out[p] = acc;
}

#ifndef K5_HAS_LAUNCH
// The compute floor of a design without launch_qe_draws: its loop body
// (the two-region svj_qe_draws.cu, in-kernel jumps, two branches), draws
// from the index.
__global__ void __launch_bounds__(256)
    k5_compute_floor(float* __restrict__ s_out, float* __restrict__ v_out,
                     float* __restrict__ g_out, long long n, int steps,
                     uint2 key, mcos::QeConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);
  float v = c.v0;
  float ls[2] = {0.0f, 0.0f}, lg[2] = {0.0f, 0.0f};
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  for (int t = 0; t < steps; ++t) {
    float z_x, u_v, z_j;
    index_draws(p_lo, t, z_x, u_v, z_j);
    if ((t & 3) == 0) {
      bits = mcos::philox4x32_10(
          make_uint4(p_lo, p_hi, static_cast<uint32_t>(t >> 2),
                     mcos::kJumpDomain),
          key);
    }
    const float u = mcos::bits_to_uniform(mcos::word_of(bits, t & 3));
    const float v_next =
        lab::qe_eager(v, mcos::acklam_ndtri(u_v), u_v, c);
    const float vol = sqrtf(fmaxf(c.k34 * (v + v_next), 0.0f));
    const float base = c.drift_dt + c.k0 + c.k1 * v + c.k2 * v_next;
    const bool jumped = u < c.lam_dt;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float sz_x = k == 0 ? z_x : -z_x;
      const float sz_j = k == 0 ? z_j : -z_j;
      const float jump = jumped ? c.mu_j + c.sig_j * sz_j : 0.0f;
      ls[k] = ls[k] + base + vol * sz_x + jump;
      lg[k] = lg[k] + c.g_drift_dt + c.sig_cv * sz_x * c.sqrt_dt;
    }
    v = v_next;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    s_out[k * n + p] = c.spot * expf(ls[k]);
    v_out[k * n + p] = v;
    g_out[k * n + p] = c.spot * expf(lg[k]);
  }
}
#endif

__device__ __forceinline__ float fmaf_step(float acc, float x, float c) {
  return fmaf(acc, x, c);
}

// mcos::acklam_ndtri with every Horner step a float FMA (one rounding).
__device__ __forceinline__ float acklam_fmaf(float u) {
  const float qc = u - 0.5f;
  if (fabsf(qc) <= 0.47575f) {
    const float r = qc * qc;
    float num = -3.969683028665376e+01f;
    num = fmaf_step(num, r, 2.209460984245205e+02f);
    num = fmaf_step(num, r, -2.759285104469687e+02f);
    num = fmaf_step(num, r, 1.383577518672690e+02f);
    num = fmaf_step(num, r, -3.066479806614716e+01f);
    num = fmaf_step(num, r, 2.506628277459239e+00f);
    float den = -5.447609879822406e+01f;
    den = fmaf_step(den, r, 1.615858368580409e+02f);
    den = fmaf_step(den, r, -1.556989798598866e+02f);
    den = fmaf_step(den, r, 6.680131188771972e+01f);
    den = fmaf_step(den, r, -1.328068155288572e+01f);
    return __fmul_rn(num, qc) / fmaf_step(den, r, 1.0f);
  }
  const float pm = fminf(u, 1.0f - u);
  const float qt = sqrtf(-2.0f * logf(pm));
  float num = -7.784894002430293e-03f;
  num = fmaf_step(num, qt, -3.223964580411365e-01f);
  num = fmaf_step(num, qt, -2.400758277161838e+00f);
  num = fmaf_step(num, qt, -2.549732539343734e+00f);
  num = fmaf_step(num, qt, 4.374664141464968e+00f);
  num = fmaf_step(num, qt, 2.938163982698783e+00f);
  float den = 7.784695709041462e-03f;
  den = fmaf_step(den, qt, 3.224671290700398e-01f);
  den = fmaf_step(den, qt, 2.445134137142996e+00f);
  den = fmaf_step(den, qt, 3.754408661907416e+00f);
  const float x_tail = num / fmaf_step(den, qt, 1.0f);
  return qc < 0.0f ? x_tail : -x_tail;
}

__global__ void acklam_probe(int which, unsigned* n_bad, unsigned* bad,
                             int cap) {
  const unsigned last = 0x3f7fffffu;   // the largest float32 below 1
  for (unsigned m = 1u + blockIdx.x * blockDim.x + threadIdx.x; m <= last;
       m += gridDim.x * blockDim.x) {
    const float u = __uint_as_float(m);
    const float ref = mcos::acklam_ndtri(u);
#ifdef K5_HAS_ACKLAM
    const float got = which == 0 ? acklam_fmaf(u) : acklam_converged(u);
#else
    const float got = acklam_fmaf(u);
#endif
    if (__float_as_uint(ref) != __float_as_uint(got)) {
      const unsigned i = atomicAdd(n_bad, 1u);
      if (i < static_cast<unsigned>(cap)) {
        bad[3 * i] = m;
        bad[3 * i + 1] = __float_as_uint(ref);
        bad[3 * i + 2] = __float_as_uint(got);
      }
    }
  }
}

}  // namespace

// which 0: the read floor (out = s_out); 1: the compute floor.
extern "C" int mcos_k5_floor(int which, const float* zx, const float* uv,
                             const float* zjs, float* s_out, float* v_out,
                             float* g_out, long long n, int steps,
                             unsigned long long seed,
                             const float* consts_host, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  if (which == 0) {
    k5_read_floor<<<blocks, 256, 0, st>>>(zx, uv, zjs, s_out, n, steps);
    return static_cast<int>(cudaGetLastError());
  }
  mcos::QeConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
#ifdef K5_HAS_LAUNCH
  return launch_qe_draws<2>(IndexDraws{}, nullptr, s_out, v_out, g_out, n,
                            steps, seed, c, st);
#else
  k5_compute_floor<<<blocks, 256, 0, st>>>(
      s_out, v_out, g_out, n, steps,
      make_uint2(static_cast<uint32_t>(seed),
                 static_cast<uint32_t>(seed >> 32)), c);
  return static_cast<int>(cudaGetLastError());
#endif
}

// Form `which` (0 float-only steps, 1 the version's K5 inverse) against
// mcos::acklam_ndtri over every float32 in (0, 1); synchronises.
extern "C" int mcos_acklam_probe(int which, unsigned* n_bad, unsigned* bad,
                                 int cap) {
  acklam_probe<<<132 * 16, 256>>>(which, n_bad, bad, cap);
  const cudaError_t err = cudaDeviceSynchronize();
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
'''


def _k5_lab_source(src_dir: str) -> str:
    """The K5 lab file for the version in `src_dir`: its own kernel drives
    the compute floor where it has `launch_qe_draws`, and its own inverse
    joins the probe where it has `acklam_converged`."""
    with open(os.path.join(src_dir, "svj_qe_draws.cu")) as f:
        text = f.read()
    flags = [f"#define {flag}\n" for flag, name in (
        ("K5_HAS_LAUNCH", "launch_qe_draws"),
        ("K5_HAS_ACKLAM", "acklam_converged")) if name in text]
    return "".join(flags) + _K5_LAB_SRC


# Contractible stand-ins for philox.cuh's fmul and fadd: nvcc fuses a
# product that feeds a sum into one FMA (the carries' contracted form).
_CONTRACTED = ("__device__ __forceinline__ float fadd(float a, float b) "
               "{ return a + b; }\n"
               "__device__ __forceinline__ float fmul(float a, float b) "
               "{ return a * b; }\n")


def _prng_levers(kernel: str, source: str, key_alias: str) -> tuple:
    """The levers K3 and K4 share, each taken out alone: their carries'
    uncontracted operations, sincosf, the bitcast uniform, round keys; and
    a minimum of 8 blocks of 256 an SM put in (32 registers a thread, the
    parent's occupancy)."""
    return (
        (f"{kernel}_contracted", source,
         "using mcos::fadd;\nusing mcos::fmul;\n", _CONTRACTED),
        (f"{kernel}_separate_sin_cos", source, "mcos::box_muller_sincos(",
         "mcos::box_muller("),
        (f"{kernel}_i2f_uniform", source,
         "return mcos::bits_to_uniform_bitcast(w);",
         "return mcos::bits_to_uniform(w);"),
        (f"{kernel}_no_round_keys", source,
         f"using {key_alias} = mcos::PhiloxKeys;",
         f"using {key_alias} = uint2;"),
        (f"{kernel}_min_8_blocks", source,
         "__launch_bounds__(kThreads)\n", "__launch_bounds__(kThreads, 8)\n"),
    )


# Each lever of the K3, K4, K5 and K7 designs taken out alone (`--levers`):
# (name, source, the design's text, what the variant puts in its place),
# or for a lever of several edits in one file, a tuple of each.
_LEVERS = {
    "k3": _prng_levers("k3", "svj.cu", "SvjKey"),
    "k4": _prng_levers("k4", "svj_qe.cu", "QeKey") + (
        ("k4_eager_qe", "svj_qe.cu",
         "  if (quadratic) return qe_quadratic(m, s2, m2, z_v);\n"
         "  return qe_exponential(m, s2, m2, u_v);\n",
         "  const float v_quad = qe_quadratic(m, s2, m2, z_v);\n"
         "  const float v_exp = qe_exponential(m, s2, m2, u_v);\n"
         "  return quadratic ? v_quad : v_exp;\n"),
        # the quadratic branch on psi, 2 / psi and two square roots, as
        # ops/simulate.py:qe_variance_step computes it
        ("k4_unfolded_quadratic", "svj_qe.cu",
         "  const float t =\n"
         "      fminf(fmaxf(__fmul_rn(2.0f, m2) / fmaxf(s2, 1e-30f), 1.0f), "
         "2e12f);\n"
         "  const float b2 = __fadd_rn(t - 1.0f, sqrtf(__fmul_rn(t, t - "
         "1.0f)));\n",
         "  const float psi = s2 / fmaxf(m2, 1e-20f);\n"
         "  const float t = 2.0f / fmaxf(psi, 1e-12f);\n"
         "  const float b2 = fmaxf(__fadd_rn(t - 1.0f, __fmul_rn(\n"
         "      sqrtf(fmaxf(t, 1e-12f)), sqrtf(fmaxf(t - 1.0f, 0.0f)))), "
         "0.0f);\n"),),
    "k5": (
        ("k5_double_horner", "svj_qe_draws.cu",
         "  return fmaf(acc, x, central ? a : t);",
         "  return static_cast<float>(fma(static_cast<double>(acc),\n"
         "      static_cast<double>(x), central ? static_cast<double>(a)\n"
         "      : static_cast<double>(t)));"),
        ("k5_two_regions_double", "svj_qe_draws.cu",
         "sqrtf(b2) + acklam_converged(u_v);",
         "sqrtf(b2) + mcos::acklam_ndtri(u_v);"),
        ("k5_eager_qe", "svj_qe_draws.cu",
         ('#include "philox.cuh"\n',
          "const float v_next = qe_step_lazy(v, u_v, c);"),
         ('#include "philox.cuh"\n' + _QE_EAGER_SRC,
          "const float v_next =\n"
          "        lab::qe_eager(v, acklam_converged(u_v), u_v, c);")),
        ("k5_i2f_uniform", "svj_qe_draws.cu",
         "u = mcos::bits_to_uniform_bitcast(", "u = mcos::bits_to_uniform("),
        ("k5_no_round_keys", "svj_qe_draws.cu",
         "using QeKey = mcos::PhiloxKeys;", "using QeKey = uint2;"),
        ("k5_min_7_blocks", "svj_qe_draws.cu",
         "__global__ void __launch_bounds__(256)\n    svj_qe_draws_kernel",
         "__global__ void __launch_bounds__(256, 7)\n    svj_qe_draws_kernel"),
    ),
    "k7": (
        ("k7_separate_sin_cos", "hhw.cu", "mcos::box_muller_sincos(",
         "mcos::box_muller("),
        ("k7_i2f_uniform", "hhw.cu", "(mcos::bits_to_uniform_bitcast(w1),\n"
         "                          mcos::bits_to_uniform_bitcast(w2)",
         "(mcos::bits_to_uniform(w1),\n"
         "                          mcos::bits_to_uniform(w2)"),
        ("k7_no_round_keys", "hhw.cu", "using HhwKey = mcos::PhiloxKeys;",
         "using HhwKey = uint2;"),
    ),
}


def lever_versions(src_dir: str, kernels) -> dict:
    """{lever name: directory}: a copy of `src_dir` per lever of `kernels`
    with that one edit made, under the lab's build directory."""
    out = {}
    for kernel in kernels:
        for name, source, design, other in _LEVERS.get(kernel, ()):
            edits = (((design, other),) if isinstance(design, str)
                     else tuple(zip(design, other)))
            with open(os.path.join(src_dir, source)) as f:
                text = f.read()
            for old, _ in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"lever {name}: {old!r} is not in "
                                       f"{source} exactly once")
            work = os.path.join(_LAB_DIR, "levers", name)
            os.makedirs(work, exist_ok=True)
            for f_name in os.listdir(src_dir):
                if f_name.endswith((".cu", ".cuh")):
                    with open(os.path.join(src_dir, f_name)) as f:
                        body = f.read()
                    if f_name == source:
                        for old, new in edits:
                            body = body.replace(old, new)
                    with open(os.path.join(work, f_name), "w") as f:
                        f.write(body)
            out[name] = work
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Build
# ─────────────────────────────────────────────────────────────────────────────
def _nvcc() -> str:
    return ck._Library._nvcc()


def build(versions: dict, kernels=tuple(_KERNELS)) -> dict:
    """{label: {"lib": path, "ptxas": {source: text}, "probe_lib": path,
    "k5_lib": path}}: each version's sources of `kernels` compiled with
    `-Xptxas -v` and linked into one library, plus its probe library when
    K2 and K9 are among them and its K5 lab library (`_K5_LAB_SRC`) when
    K5 is; all nvcc processes at once."""
    os.makedirs(_LAB_DIR, exist_ok=True)
    nvcc, jobs, out = _nvcc(), [], {}
    sources = [_KERNELS[k] for k in kernels]
    for label, src_dir in versions.items():
        digest = hashlib.sha256(" ".join(ck.NVCC_FLAGS).encode())
        for name in (*sources, "philox.cuh"):
            with open(os.path.join(src_dir, name), "rb") as f:
                digest.update(name.encode() + f.read())
        work = os.path.join(_LAB_DIR, f"{label}_{digest.hexdigest()[:12]}")
        os.makedirs(work, exist_ok=True)
        objs = []
        for name in sources:
            obj = os.path.join(work, name[:-3] + ".o")
            objs.append(obj)
            jobs.append((label, name, subprocess.Popen(
                [nvcc, *ck.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                 os.path.join(src_dir, name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        has_probes = False
        if "k2" in kernels and "k9" in kernels:
            with open(os.path.join(src_dir, "gbm.cu")) as f:
                has_probes = "box_muller_fast" in f.read()
        if has_probes:      # the probes call this design's helpers
            probe = os.path.join(work, "probes.cu")
            with open(probe, "w") as f:
                f.write(_PROBE_SRC)
            jobs.append((label, "probes", subprocess.Popen(
                [nvcc, *ck.NVCC_FLAGS, "-I", src_dir, "-shared", "-o",
                 os.path.join(work, "libprobe.so"), probe],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        if "k5" in kernels:  # K5's floors and Acklam probe
            lab_src = os.path.join(work, "k5_lab.cu")
            with open(lab_src, "w") as f:
                f.write(_k5_lab_source(src_dir))
            jobs.append((label, "k5_lab", subprocess.Popen(
                [nvcc, *ck.NVCC_FLAGS, "-I", src_dir, "-shared", "-o",
                 os.path.join(work, "libk5lab.so"), lab_src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        out[label] = {"dir": src_dir, "work": work, "objs": objs,
                      "ptxas": {}, "has_probes": has_probes,
                      "k5_lib": (os.path.join(work, "libk5lab.so")
                                 if "k5" in kernels else None)}
    for label, name, proc in jobs:
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}/{name}:\n{se}")
        if name not in ("probes", "k5_lab"):
            out[label]["ptxas"][name] = so + se
    for label, info in out.items():
        lib = os.path.join(info["work"], "libk.so")
        link = subprocess.run([nvcc, *ck.NVCC_FLAGS, "-shared", "-o", lib,
                               *info["objs"]], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed for {label}:\n{link.stderr}")
        info["lib"] = lib
        info["probe_lib"] = (os.path.join(info["work"], "libprobe.so")
                             if info.pop("has_probes") else None)
    return out


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp, i32, i64, u64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_ulonglong,
                              ctypes.c_float)
    signatures = {
        "mcos_svj_terminal_from_draws": [vp, vp, vp, vp, vp, vp, vp, i64,
                                         i32, i32, u64, vp, vp],
        "mcos_svj_terminal_from_draws_population": [vp, vp, vp, vp, vp, vp,
                                                    i64, i32, i32, i32, i32,
                                                    u64, vp],
        "mcos_gbm_terminal": [vp, i64, i32, i32, u64, f32, f32, f32, vp],
        "mcos_svj_terminal_td": [vp, vp, vp, vp, vp, i32, i64, i32, i32,
                                 u64, vp, vp],
        "mcos_rbergomi_lift_integrals": [vp, vp, vp, i64, i32, i32, u64, vp,
                                         vp, i32, vp],
        "mcos_rbergomi_lift_stats": [vp, vp, i64, i32, i32, u64, vp, vp, i32,
                                     vp],
        "mcos_svj_path_stats": [vp, i64, i32, i32, i32, i32, i32, i32, u64,
                                vp, vp],
        "mcos_svcj_terminal": [vp, vp, vp, i64, i32, i32, u64, vp, vp],
        "mcos_probe": [i32, vp, i32],
        "mcos_svj_terminal_qe_from_draws": [vp, vp, vp, vp, vp, vp, vp, i64,
                                            i32, i32, u64, vp, vp],
        "mcos_hhw_terminal": [vp, vp, i64, i32, i32, u64, vp, vp],
        "mcos_svj_terminal": [vp, vp, vp, vp, i32, i64, i32, i32, u64, vp,
                              vp],
        "mcos_svj_terminal_qe": [vp, vp, vp, vp, i32, i64, i32, i32, u64, vp,
                                 vp],
        "mcos_k5_floor": [i32, vp, vp, vp, vp, vp, vp, i64, i32, u64, vp,
                          vp],
        "mcos_acklam_probe": [i32, vp, vp, i32],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
    return lib


# ─────────────────────────────────────────────────────────────────────────────
# ptxas and SASS
# ─────────────────────────────────────────────────────────────────────────────
def ptxas_resources(text: str) -> dict:
    """{mangled kernel: {registers, stack, spill_stores, spill_loads}}."""
    out, fn, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn and props == fn:
            out.setdefault(fn, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def occupancy(registers: int, threads: int = 256, blocks=None,
              smem: int = 0) -> dict:
    """Blocks of `threads` an SM holds at `registers` a thread and `smem`
    bytes of shared memory a block (K1's stages; the other kernels use
    none) and, for a launch of `blocks`, the waves it takes on the card's
    132 SMs."""
    warps_per_block = -(-threads // 32)
    regs_per_warp = -(-registers // REG_UNIT) * REG_UNIT * 32
    warps = min(REGS_PER_SM // regs_per_warp, MAX_WARPS)
    per_sm = min(warps // warps_per_block, MAX_BLOCKS)
    if smem:
        per_sm = min(per_sm, SMEM_PER_SM // (smem + SMEM_RESERVED))
    out = {"blocks_per_sm": per_sm, "slots": per_sm * SMS}
    if blocks is not None:
        out.update(blocks=blocks, waves=blocks / (per_sm * SMS))
    return out


def _op_class(op: str) -> str:
    base = op.split(".")[0]
    base = {"I2FP": "I2F", "F2IP": "F2I"}.get(base, base)
    if op.startswith("IMAD.WIDE"):
        return "IMAD.WIDE"
    if op.startswith("IMAD.HI"):
        return "IMAD.HI"
    if base == "MUFU":
        return op
    # A conversion to or from a 64-bit float by its direction (destination
    # type first): both run on the SM's slow conversion pipe.
    for f2f in ("F2F.F64.F32", "F2F.F32.F64"):
        if op.startswith(f2f):
            return f2f
    if base in ("FFMA", "FADD", "FMUL", "DFMA", "DADD", "DMUL", "IMAD",
                "IADD3", "LOP3", "SHF",
                "I2F", "F2I", "F2F", "LDG", "LDC", "LDS", "STG", "BRA",
                "CALL", "BSSY", "BSYNC", "RET", "EXIT", "ISETP", "FSETP",
                "FSEL", "SEL", "FMNMX", "MOV", "LEA", "PRMT", "ULDC"):
        return base
    if base.startswith("U"):
        return "uniform"
    return "other"


def sass_functions(lib_path: str) -> dict:
    """{mangled function: [(address, opcode, text)]} from cuobjdump -sass."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    txt = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, cur, labels = {}, None, {}
    pending = []
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            ins = m.group(2).strip()
            for lab in pending:
                labels[(id(cur), lab)] = addr
            pending = []
            toks = ins.split()
            op = toks[1] if toks[0].startswith("@") else toks[0]
            cur.append((addr, op, ins))
    # resolve label targets to addresses
    for name, ins_list in funcs.items():
        fixed = []
        for addr, op, ins in ins_list:
            m = re.search(r"\(?(\.L_x_\d+)\)?", ins)
            if m and (id(ins_list), m.group(1)) in labels:
                ins = ins.replace(m.group(1), hex(
                    labels[(id(ins_list), m.group(1))]))
            fixed.append((addr, op, ins))
        funcs[name] = fixed
    return funcs


def _target(ins: str):
    found = re.findall(r"0x([0-9a-f]+)", ins)
    return int(found[-1], 16) if found else None


# K6's corridor makes its nine quotients an increment exactly by one shared
# reciprocal, and again by nine library divides (one FCHK range check
# each) only where those could over- or underflow.
_FALLBACK_DIVIDES = 9


def _cold(body) -> set:
    """Addresses inside a loop body that the kernels' arguments never
    reach: what a conditional forward branch jumps over when it guards an
    out-of-line slow path, namely a call (IEEE sqrt's special inputs: the
    few instructions around CALL), the trig functions' Payne-Hanek
    reduction (the branch on the predicate of `|x| >= 105615`), or K6's
    corridor fallback (a span of nine library divides, FCHK each, with no
    exp in it)."""
    end = body[-1][0]
    cold, huge = set(), None      # huge: the predicate |x| >= 105615 set
    for addr, op, ins in body:
        toks = ins.split()
        at = 2 if toks[0].startswith("@") else 1
        dest = toks[at].rstrip(",") if len(toks) > at else ""
        if op.startswith("FSETP") and "105615" in ins:
            huge = dest
        elif dest == huge:
            huge = None
        tgt = _target(ins) if op.startswith("BRA") else None
        if not ins.startswith("@") or tgt is None or not addr < tgt <= end:
            continue
        skipped = [x for x in body if addr < x[0] < tgt]
        ops = [o for _, o, _ in skipped]
        short_call = len(skipped) <= 5 and any(o.startswith("CALL")
                                               for o in ops)
        fallback = (sum(o.startswith("FCHK") for o in ops)
                    >= _FALLBACK_DIVIDES
                    and not any(o.startswith("MUFU.EX2") for o in ops))
        if short_call or fallback or (huge and toks[0] == f"@!{huge}"):
            cold.update(x[0] for x in skipped)
    return cold


# Philox4x32-10's multipliers 0xD2511F53 and 0xCD9E8D57 as cuobjdump
# prints them: signed 32-bit immediates.
_PHILOX_MULTIPLIERS = ("-0x2daee0ad", "-0x326172a9")


def philox_products(body) -> int:
    """The Philox products in a list of (address, opcode, text): each
    IMAD.WIDE.U32 or IMAD.HI.U32 by one of the two multipliers is one
    32 x 32 -> 64 bit product (a low word alone, IMAD, goes with an
    IMAD.HI and is not counted)."""
    return sum(1 for _, op, ins in body
               if op.startswith(("IMAD.WIDE.U32", "IMAD.HI.U32"))
               and any(m in ins for m in _PHILOX_MULTIPLIERS))


def philox_calls(products: int) -> int:
    """Philox4x32-10 calls from their per-thread products: rounds 2-10 make
    18 a call. Round 1 multiplies the path word, the same on every pass,
    and the call index, the same in every thread of a warp, so ptxas
    hoists those products or moves them to the uniform datapath (UIMAD);
    and a product whose multiplier sits in a register is not seen, so a
    call shows 16-18. The nearest whole number of 18s (right up to four
    calls a pass)."""
    return round(products / 18)


def loop_counts(ins_list) -> list:
    """Per backward branch: the loop's span, its instruction count by class
    (all of it, and without the slow paths it jumps over: "hot"), its
    Philox products (hot), the hot instructions each conditional forward
    branch inside it jumps over and those left where every such branch
    skips (the cheapest outcome of each data-dependent choice, e.g. K8's
    step pair with no jump), and the branches from inside it to code
    beyond its end."""
    loops = []
    for addr, op, ins in ins_list:
        target = _target(ins) if op.startswith("BRA") else None
        if target is None or target > addr:
            continue
        body = [x for x in ins_list if target <= x[0] <= addr]
        cold = _cold(body)
        hot_body = [x for x in body if x[0] not in cold]
        counts = collections.Counter(_op_class(op2) for _, op2, _ in body)
        hot = collections.Counter(_op_class(op2) for _, op2, _ in hot_body)
        exits = sum(1 for _, op2, ins2 in body
                    if op2.startswith(("BRA", "CALL"))
                    and (_target(ins2) or 0) > addr)
        skips, skipped = [], set()
        for a2, op2, ins2 in hot_body:
            tgt = _target(ins2) if op2.startswith("BRA") else None
            if ins2.startswith("@") and tgt is not None and a2 < tgt <= addr:
                span = {x[0] for x in hot_body if a2 < x[0] < tgt}
                skips.append({"at": a2, "skips": len(span)})
                skipped |= span
        # global loads every pass makes: neither predicated nor inside a
        # span that a conditional branch jumps over
        loads = sum(1 for a2, op2, ins2 in hot_body
                    if op2.startswith("LDG") and not ins2.startswith("@")
                    and a2 not in skipped)
        loops.append({"start": target, "end": addr, "instructions": len(body),
                      "hot_instructions": len(hot_body),
                      "hot_if_branches_skip": len(hot_body) - len(skipped),
                      "unconditional_loads": loads,
                      "philox_products": philox_products(hot_body),
                      "exits_to_slow_paths": exits,
                      "forward_branches": skips,
                      "by_class": dict(sorted(counts.items())),
                      "hot_by_class": dict(sorted(hot.items()))})
    return sorted(loops, key=lambda d: -d["instructions"])


def _short_name(name: str) -> str:
    """A mangled kernel name cut to its base name and integer and bool
    template arguments, e.g. `rbergomi_lift_kernelILi2ELi25ELb1EE`: one
    file per instantiation (a class argument after them, K5's draws, is
    left out)."""
    m = re.search(r"([a-z_]+_kernel)((?:I(?:L[ib]\d+E)+)?)", name)
    if not m:
        return re.sub(r"\W", "_", name)[-60:]
    return m.group(1) + m.group(2) + ("E" if m.group(2) else "")


def exps_per_pair_step(name: str):
    """The expf calls one pair-step of a K10 or K11 instantiation makes
    (one a branch in K10; two in K11: the variance and the spot), read
    from the branch count in its mangled name; None for other kernels."""
    m = re.search(r"rbergomi_(lift|stats)_kernelILi(\d)E", name)
    if not m:
        return None
    return int(m.group(2)) * (1 if m.group(1) == "lift" else 2)


def pair_steps_from_calls(name: str, calls: int):
    """The pair-steps a loop pass of K3, K4, K6-K9 covers, from the Philox
    calls in it (their exps depend on the variant, so `exps_per_pair_step`
    does not fit them): K4, K6 and K7 make one call a pair-step (K7 two a
    step pair); K3 and K9 one call a step pair (four words, two Box-Muller
    pairs); K8 two a step pair, plus a third only for a step pair in which
    a jump lands, so a pass of 2 or 3 calls covers 2 pair-steps. None for
    other kernels."""
    if any(_SASS_PATTERN[k] in name for k in ("k4", "k6", "k7")):
        return calls or None
    if any(_SASS_PATTERN[k] in name for k in ("k3", "k9")):
        return 2 * calls or None
    if "svcj_kernel" in name:
        return 2 * -(-calls // 3) or None
    return None


def k5_steps(loop: dict):
    """The path-steps a loop pass of K5 covers, from the draw loads every
    pass makes (`unconditional_loads`): three a step (z_x, u_v, z_js) in a
    loop that draws the jump uniforms itself (it holds Philox products),
    four where it loads them too. None for a loop with no such loads."""
    per_step = 3 if loop["philox_products"] else 4
    steps = loop["unconditional_loads"] / per_step
    return steps or None


def k1_steps(loop: dict):
    """The member path-steps a loop pass of K1 covers, from its IEEE square
    roots (MUFU.RSQ, one a branch: two a member path-step). None for a
    loop with none."""
    return loop["hot_by_class"].get("MUFU.RSQ", 0) / 2 or None


def sass_report(lib_path: str, pattern=r"gbm_kernel|svj_td_kernel",
                dump_prefix: str = "") -> dict:
    """Per kernel matching `pattern`: instruction counts by class, whole and
    per loop; each loop's pair-steps and hot count per pair-step, for
    K10/K11 from its MUFU.EX2 count over the exps a pair-step takes, for
    K3, K4, K6-K9 from its Philox calls (`pair_steps_from_calls`), for
    K5 (path-steps) from its draw loads (`k5_steps`), for K1 (member
    path-steps) from its square roots (`k1_steps`); with
    `dump_prefix`, each kernel's listing is also written to
    `<dump_prefix><kernel>.sass`."""
    out = {}
    for name, ins in sass_functions(lib_path).items():
        if not re.search(pattern, name):
            continue
        if dump_prefix:
            short = _short_name(name)
            with open(f"{dump_prefix}{short}.sass", "w") as f:
                f.writelines(f"{addr:#06x}  {text}\n" for addr, _, text in ins)
        total = collections.Counter(_op_class(op) for _, op, _ in ins)
        loops = [lp for lp in loop_counts(ins) if lp["instructions"] >= 20]
        exps = exps_per_pair_step(name)
        for lp in loops:
            ex2 = lp["hot_by_class"].get("MUFU.EX2", 0)
            if "svj_qe_draws_kernel" in name:
                steps = k5_steps(lp)
            elif _SASS_PATTERN["k1"] in name:
                steps = k1_steps(lp)
            else:
                steps = pair_steps_from_calls(
                    name, philox_calls(lp["philox_products"]))
            if exps and ex2:
                lp["pair_steps"] = ex2 / exps
            elif steps:
                lp["pair_steps"] = steps
            if "pair_steps" in lp:
                lp["hot_per_pair_step"] = (lp["hot_instructions"]
                                           / lp["pair_steps"])
                lp["hot_if_branches_skip_per_pair_step"] = (
                    lp["hot_if_branches_skip"] / lp["pair_steps"])
        out[name] = {"instructions": len(ins),
                     "by_class": dict(sorted(total.items())), "loops": loops}
    return out


# ─────────────────────────────────────────────────────────────────────────────
# Probes
# ─────────────────────────────────────────────────────────────────────────────
def run_probe(lib: ctypes.CDLL, which: int, rows: int, device) -> torch.Tensor:
    out = torch.empty((rows, _GRID), dtype=torch.float32, device=device)
    rc = lib.mcos_probe(which, out.data_ptr(), _GRID)
    if rc != 0:
        raise RuntimeError(f"probe {which} failed: CUDA error {rc}")
    torch.cuda.synchronize()
    return out


def probes(lib: ctypes.CDLL, device) -> dict:
    m = torch.arange(_GRID, dtype=torch.float64, device=device)
    u = (m + 0.5) * 2.0 ** -23
    rad_exact = torch.sqrt(-2.0 * torch.log(u))
    k2 = run_probe(lib, 0, 3, device).double()
    # Row 0: the radius at the angle whose sine is 1 (u2 = 3/4), so the
    # probe's error is the radius's plus at most that of sin near pi/2.
    rad_err = (k2[0] - rad_exact).abs()
    worst = int(rad_err.argmax())
    # Rows 1, 2: at u1 = float32(e^-1/2)... radius sqrt(-2 log u1).
    r0 = float(np.sqrt(-2.0 * np.log(np.float64(np.float32(0.36787944)))))
    ang = 2.0 * np.pi * u
    cos_err = (k2[1] - r0 * torch.cos(ang)).abs() / r0
    sin_err = (k2[2] - r0 * torch.sin(ang)).abs() / r0
    sc = run_probe(lib, 1, 3, device)
    sin_only = run_probe(lib, 2, 1, device)[0]
    cos_only = run_probe(lib, 3, 1, device)[0]
    return {
        "k2_radius_max_abs_err": float(rad_err.max()),
        "k2_radius_worst_u1": float(u[worst]),
        "k2_radius_finite_positive": bool(torch.isfinite(k2[0]).all()
                                          and (k2[0] > 0).all()),
        "k2_radius_max_abs_err_u1_below_1_minus_2^-7": float(
            rad_err[u < 1 - 2.0 ** -7].max()),
        "k2_radius_max_abs_err_u1_above_1_minus_2^-7": float(
            rad_err[u >= 1 - 2.0 ** -7].max()),
        "k2_cos_max_abs_err": float(cos_err.max()),
        "k2_sin_max_abs_err": float(sin_err.max()),
        "k9_sincosf_equals_sinf": bool((sc[1] == sin_only).all()),
        "k9_sincosf_equals_cosf": bool((sc[2] == cos_only).all()),
        "k9_sincosf_equals_torch_sin": bool((sc[1] == torch.sin(sc[0])).all()),
        "k9_sincosf_equals_torch_cos": bool((sc[2] == torch.cos(sc[0])).all()),
    }


def acklam_probe(lib: ctypes.CDLL, device, has_k5_form: bool,
                 cap: int = 4096) -> dict:
    """Acklam's inverse over every float32 in (0, 1) against
    mcos::acklam_ndtri (the plain version's double Horner step): the
    float-only step ("fmaf_step") and, where the version has one, its K5
    inverse ("k5"). Per form: the u whose outputs differ, the worst of the
    first `cap` of them, and the probe's time."""
    res = {}
    forms = ((0, "fmaf_step"), (1, "k5")) if has_k5_form else (
        (0, "fmaf_step"),)
    for which, form in forms:
        n_bad = torch.zeros(1, dtype=torch.int32, device=device)
        bad = torch.zeros(3 * cap, dtype=torch.int32, device=device)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        rc = lib.mcos_acklam_probe(which, n_bad.data_ptr(), bad.data_ptr(),
                                   cap)
        b.record()
        if rc != 0:
            raise RuntimeError(f"Acklam probe {form} failed: CUDA error {rc}")
        torch.cuda.synchronize()
        count = int(n_bad.cpu().numpy().view(np.uint32)[0])
        kept = bad[:3 * min(count, cap)].cpu().numpy().view(np.uint32)
        u, ref, got = (kept[i::3].view(np.float32) for i in range(3))
        entry = {"mismatches": count, "values": 0x3F7FFFFF,
                 "ms": a.elapsed_time(b)}
        if count:
            err = np.abs(ref.astype(np.float64) - got.astype(np.float64))
            worst = int(err.argmax())
            entry.update(worst_u=float(u[worst]), worst_ref=float(ref[worst]),
                         worst_got=float(got[worst]),
                         central_share=float(np.mean(
                             np.abs(u - np.float32(0.5))
                             <= np.float32(0.47575))))
        res[form] = entry
    return res


# ─────────────────────────────────────────────────────────────────────────────
# Timing
# ─────────────────────────────────────────────────────────────────────────────
K2_SHAPES = ((1 << 20, 252, 20), (1 << 22, 1024, 3))
K9_PAIRS = 200_000
K9_SHAPES = ((512, 20), (4096, 3))
TD_SEGMENTS = ((0.08, 0.04, 0.5, 1.0), (0.16, 0.06, 0.7, 2.0),
               (0.25, 0.09, 0.9, 4.0))


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _k2_call(lib, out, pairs, steps, seed):
    spot, drift, sig = ck._gbm_consts(22500.0, 0.2, 0.065, 0.012, 1.0, steps)
    rc = lib.mcos_gbm_terminal(out.data_ptr(), pairs, steps, 2, seed,
                               float(spot), float(drift), float(sig),
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: {rc}")


def _td_case(steps: int):
    from mcos_tpu_torch.models.params import SVJParams
    from mcos_tpu_torch.ops import tdsvj

    if steps == 4096:       # chip_smoke.py's TD_HEAVY body
        seg = [np.asarray([3.0]), np.asarray([0.04]), np.asarray([0.5]),
               np.asarray([20.0])]
        T = 3.0
    else:
        seg = [np.asarray(col) for col in zip(*TD_SEGMENTS)]
        T = 0.25
    levels = tdsvj.step_param_arrays(*seg, T, steps)
    return SVJParams(), levels, T


def _k9_call(lib, out, steps, case, device, upload: bool, seed=43,
             pairs=K9_PAIRS):
    params, levels, T = case
    consts, table, lam_dt = ck._td_consts(params, *levels, 22500.0, T, steps)
    cdf = ck._device_td_table(lam_dt.tobytes(), str(device))
    tab = (torch.as_tensor(table, device=device) if upload
           else ck._device_step_table(table.tobytes(), steps, str(device)))
    rc = lib.mcos_svj_terminal_td(
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        tab.data_ptr(), cdf.data_ptr(), int(cdf.numel()), pairs, steps, 2,
        seed, consts.ctypes.data, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K9 launch failed: {rc}")


ROUGH_PAIRS = 131_072     # RoughRequest default
ROUGH_SHAPES = ((512, 20), (511, 20))
ROUGH_T, ROUGH_H = 0.25, 0.07
# (pairs, steps, factors, H) of the bit-for-bit checks: the route's m = 25
# at both step parities, the exact m = 24 (the H = 0.07 tables' first 24
# rows) and m = 1 (H = 1/2), and the guarded fallback at m = 2, 7 and 32
# (the 25 rows and then the first 7 again: bit-equality needs no law).
ROUGH_CHECKS = ((ROUGH_PAIRS, 512, 25, ROUGH_H),
                (ROUGH_PAIRS, 511, 25, ROUGH_H), (10_007, 64, 24, ROUGH_H),
                (10_007, 63, 1, 0.5), (10_007, 64, 2, ROUGH_H),
                (10_007, 9, 7, ROUGH_H), (10_007, 64, 32, ROUGH_H))
# K6 at the exotic route's 200 000 pairs (ExoticRequest's default) in
# chip_smoke.py's five K6_VARIANTS: (name, pairs, steps, T, wrapper
# keywords). The checks add the barrier below at a ragged pair count and
# a short odd step count, and the corridor with v0 = 0, where the
# companion's step variance sits on the 1e-20 floor.
K6_PAIRS = 200_000
_LOG_UP, _LOG_HI, _LOG_LO = (float(np.log(x)) for x in (1.10, 1.12, 0.88))
K6_VARIANTS = (
    ("asian", K6_PAIRS, 63, 0.25, dict(companion=True)),
    ("up", K6_PAIRS, 63, 0.25, dict(companion=True, bridge=True,
                                    bridge_up=True, bridge_log_b=_LOG_UP)),
    ("corridor", K6_PAIRS, 63, 0.25,
     dict(companion=True, bridge=True, corridor=True, bridge_log_b=_LOG_HI,
          bridge_log_l=_LOG_LO)),
    ("corridor_window", K6_PAIRS, 63, 0.25,
     dict(companion=False, bridge=True, corridor=True, window=(13, 50),
          bridge_log_b=_LOG_HI, bridge_log_l=_LOG_LO)),
    ("corridor_252", K6_PAIRS, 252, 1.0,
     dict(companion=True, bridge=True, corridor=True,
          bridge_log_b=float(np.log(1.25)),
          bridge_log_l=float(np.log(0.78)))),
)
K6_CHECKS = K6_VARIANTS + (
    ("down_window", 200_003, 13, 0.25,
     dict(companion=True, bridge=True, bridge_up=False,
          bridge_log_b=float(np.log(0.95)), window=(2, 11))),
    ("corridor_v0_zero", 10_007, 63, 0.25,
     dict(companion=True, bridge=True, corridor=True, bridge_log_b=_LOG_HI,
          bridge_log_l=_LOG_LO, v0=0.0)),
)
# The sweep over pair counts (Asian and corridor + companion, 63 steps):
# 135 168 pairs are 528 blocks, one wave at 4 blocks an SM.
K6_SWEEP = (135_168, 160_000, 264_000)
# K8 at the families' 200 000 pairs: (steps, T, companion, lambda).
K8_PAIRS = 200_000
K8_CHECKS = tuple((steps, T, comp, lam) for steps, T in ((252, 1.0),
                                                         (63, 0.25))
                  for comp in (True, False) for lam in (0.0, 1.0, 8.0))
K8_TIMED = ((252, 1.0), (63, 0.25))
# K5 on the Sobol QE net (chip_smoke.py's check_k5): (name, paths, steps,
# T, SVJParams fields). "route" is the /api/price scheme="qe" default. The
# default parameters never take the exponential branch (psi <= xi^2 /
# (2 kappa theta) = 1.04 at any v and dt), so "psi_4" and "psi_8" raise xi
# and lower kappa (psi 8.3 at v = 0, 1.3 at v = 0.2): both branches run,
# and with v0 = 0.005 from the first step.
K5_PATHS = 500_000
K5_PSI = dict(kappa=2.0, xi=0.6, v0=0.005)
K5_CHECKS = (("route", K5_PATHS, 63, 0.25, {}),
             ("psi_4", K5_PATHS, 4, 1.0, K5_PSI),
             ("psi_8", K5_PATHS, 8, 1.0, K5_PSI))
# K7 at the families' 200 000 pairs and chip_smoke.py's parameters (T = 2):
# (steps, branches) of the checks; the timed shape and the pair sweep.
K7_PAIRS, K7_T = 200_000, 2.0
K7_CHECKS = tuple((steps, nb) for nb in (2, 1) for steps in (128, 127, 1))
K7_SWEEP = (160_000, 264_000)
# K5's path-count sweep at 63 steps: 1584 and 2376 blocks of 256 are two
# and three whole waves at 6 blocks an SM (the route's 500 000 take 1954,
# 2.47 waves).
K5_SWEEP = (405_504, 608_256)
# K3 and K4 at the PRNG route's 500 000 pairs x 63 steps (T = 0.25, the
# default SVJ parameters), with two branches and the companion: (name,
# pairs, steps, T, branches, companion, SVJParams fields) of the bit-for-bit
# checks. Beside the route: a ragged pair count at an odd step count (K3's
# last step on half a call), one branch without the companion at an even
# count, and for K4 the psi cases of K5 (K5_PSI at 4 and 8 steps), where
# its QE transition takes both branches and v reaches the mass at zero.
PRNG_PAIRS = 500_000
PRNG_CHECKS = (("route", PRNG_PAIRS, 63, 0.25, 2, True, {}),
               ("ragged_odd", 200_003, 13, 0.25, 2, True, {}),
               ("one_branch", 10_007, 64, 0.25, 1, False, {}))
K4_PSI_CHECKS = (("psi_4", PRNG_PAIRS, 4, 1.0, 2, True, K5_PSI),
                 ("psi_8", PRNG_PAIRS, 8, 1.0, 2, True, K5_PSI))
# K1: (name, members, paths, steps, T, streamed jump uniforms). One member
# at `/api/price`'s shape (in-kernel jump uniforms); a 24-member generation
# at `/api/calibrate`'s (streamed uniforms, one launch, or one launch a
# member in a version without the population entry point, as before it);
# one member at the calibration shape. The checks add a ragged path count
# at a step count that fills no stage, past one block's 24 members.
K1_CASES = (("price", 1, 500_000, 63, 0.25, False),
            ("calibration", 24, 100_000, 50, 0.5, True),
            ("calibration_one", 1, 100_000, 50, 0.5, True))
K1_CHECKS = K1_CASES + (("ragged", 25, 100_001, 63, 0.25, False),)
K1_SMEM = 3 * 4 * 1024 * 4     # svj_draws.cu: kStages x kArrays x words
# Timed launch of each kernel: (pairs, one thread each, blocks of 256).
TIMED_PAIRS = {"k1": K1_CASES[0][2], "k2": K2_SHAPES[0][0],
               "k3": PRNG_PAIRS, "k4": PRNG_PAIRS,
               "k5": K5_PATHS, "k6": K6_PAIRS,
               "k7": K7_PAIRS, "k8": K8_PAIRS, "k9": K9_PAIRS,
               "k10": ROUGH_PAIRS, "k11": ROUGH_PAIRS}


def _k1_case(members: int, paths: int, steps: int, T: float,
             streamed_u: bool, device):
    """(members' SVJParams, (z1, z2, u_jump or None, z_js), host consts
    table, the table on the device) of one K1 case: normals and uniforms
    from a seeded torch generator; the default SVJ parameters first, the
    others drawn in the calibration's bounds with numpy."""
    from mcos_tpu_torch.config import PARAM_BOUNDS
    from mcos_tpu_torch.models.params import SVJParams

    def make():
        gen = torch.Generator(device=device)
        gen.manual_seed(5)
        z = torch.randn((3, steps, paths), generator=gen, device=device)
        u = torch.rand((steps, paths), generator=gen, device=device)
        return z[0], z[1], (u if streamed_u else None), z[2]
    draws = _plain_once(("k1_draws", paths, steps, streamed_u), make)
    rng = np.random.default_rng(16)
    pop = [SVJParams()] + [
        SVJParams(**{k: float(lo + (hi - lo) * rng.random())
                     for k, (lo, hi) in PARAM_BOUNDS.items()})
        for _ in range(members - 1)]
    table = np.stack([ck._svj_consts(p, 22500.0, T, steps) for p in pop])
    return pop, draws, table, torch.from_numpy(table).to(device)


def _k1_call(lib, out, draws, table, table_dev, seed=43):
    """One K1 launch of the whole table into out (3, P, 2, paths); a
    version without the population entry point launches once a member."""
    z1, z2, u, zjs = draws
    steps, paths = z1.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (z1.data_ptr(), z2.data_ptr(), zjs.data_ptr(),
            None if u is None else u.data_ptr())
    if hasattr(lib, "mcos_svj_terminal_from_draws_population"):
        rc = lib.mcos_svj_terminal_from_draws_population(
            *ptrs, table_dev.data_ptr(), out.data_ptr(), paths, steps, 2,
            len(table), 1, seed, stream)
    else:
        for m in range(len(table)):
            rc = lib.mcos_svj_terminal_from_draws(
                *ptrs, out[0, m].data_ptr(), out[1, m].data_ptr(),
                out[2, m].data_ptr(), paths, steps, 2, seed,
                table[m].ctypes.data, stream)
            if rc:
                break
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: {rc}")


def _k5_case(paths: int, steps: int, T: float, fields: dict, device):
    """(params, (z_x, u_v, z_js), explicit jump uniforms, launch scalars)
    of one K5 case: the Sobol QE net at seed 42, steps-major."""
    from mcos_tpu_torch.models.params import SVJParams
    from mcos_tpu_torch.ops import sobol

    def make():
        z_x, u_v, _, z_js = sobol.sobol_qe_draws(
            paths, steps, seed=42, jump_uniforms=False, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(2)
        uj = torch.rand(z_x.shape, generator=gen, device=device)
        return (z_x, u_v, z_js), uj
    net, uj = _plain_once(("k5_net", paths, steps), make)
    params = SVJParams(**fields)
    return params, net, uj, ck._qe_consts(params, 22500.0, T, steps)


def _k5_call(lib, out, net, uj, consts, seed=43, fn="qe"):
    """One launch of K5 (`fn` "qe"), or of its read floor ("read") or
    compute floor ("compute") from the K5 lab library."""
    z_x, u_v, z_js = net
    steps, paths = z_x.shape
    stream = torch.cuda.current_stream().cuda_stream
    if fn == "qe":
        rc = lib.mcos_svj_terminal_qe_from_draws(
            z_x.data_ptr(), u_v.data_ptr(), z_js.data_ptr(),
            None if uj is None else uj.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), paths, steps, 2, seed,
            consts.ctypes.data, stream)
    else:
        rc = lib.mcos_k5_floor(
            0 if fn == "read" else 1, z_x.data_ptr(), u_v.data_ptr(),
            z_js.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), paths, steps, seed, consts.ctypes.data,
            stream)
    if rc != 0:
        raise RuntimeError(f"K5 ({fn}) launch failed: {rc}")


# K3's and K4's C entry points and plain versions.
_PRNG = {"k3": ("mcos_svj_terminal", "svj_terminal_plain"),
         "k4": ("mcos_svj_terminal_qe", "svj_terminal_qe_plain")}


def _prng_case(kernel: str, steps: int, T: float, fields: dict, device):
    """(params, launch scalars, device count table) of a K3 or K4 case."""
    from mcos_tpu_torch.models.params import SVJParams

    params = SVJParams(**fields)
    if kernel == "k3":
        consts = ck._svj_prng_consts(params, 22500.0, T, steps)
        lam_dt = consts[9]
    else:
        consts = ck._qe_consts(params, 22500.0, T, steps)
        lam_dt = consts[ck._QE_FIELDS.index("lam_dt")]
    return params, consts, ck._device_table(float(lam_dt), steps,
                                            str(device))


def _prng_call(lib, kernel: str, out, pairs, steps, nb, companion, consts,
               cdf, seed=43):
    rc = getattr(lib, _PRNG[kernel][0])(
        out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr() if companion else None, cdf.data_ptr(),
        int(cdf.numel()), pairs, steps, nb, seed, consts.ctypes.data,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.upper()} launch failed: {rc}")


def _k7_params():
    from mcos_tpu_torch.ops.hhw import HHWParams

    return HHWParams(kappa=2.0, theta=0.05, xi=0.4, v0=0.04, a=0.1, b=0.05,
                     sigma_r=0.012, r0=0.05, rho_sv=-0.6, rho_sr=0.3,
                     rho_vr=0.1, q=0.01)


def _k7_call(lib, out, pairs, steps, nb, consts, seed=43):
    rc = lib.mcos_hhw_terminal(out[0].data_ptr(), out[1].data_ptr(), pairs,
                               steps, nb, seed, consts.ctypes.data,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: {rc}")


def _rough_case(steps: int, m: int = 25, hurst: float = ROUGH_H):
    """(c, d, g, tail, hurst): the lift's tables at `hurst`, cut or
    repeated to m factors."""
    from mcos_tpu_torch.ops.rough import rbergomi_lift

    c, d, g, tail = rbergomi_lift(hurst, ROUGH_T, steps)
    rows = [np.resize(np.asarray(x, np.float32), m) for x in (c, d, g)]
    return (*rows, tail, hurst)


def _rough_args(kernel: str, steps: int, case, device):
    """The launch scalars, factor table and device step table of K10
    (`kernel` "k10") or K11 for `case`, made once outside the timing."""
    c, d, g, tail, hurst = case
    leg = None if kernel == "k10" else (-0.9, 0.05, 0.01)
    p, cdg, tab = ck._rough_tables(1.9, 0.04, hurst, ROUGH_T, steps, c, d, g,
                                   tail, spot_leg=leg)
    return p, cdg, ck._device_step_table(tab.tobytes(), steps, str(device))


def _rough_call(lib, kernel: str, out, pairs: int, steps: int, args,
                seed=43):
    p, cdg, tab = args
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "k10":
        rc = lib.mcos_rbergomi_lift_integrals(
            out[0].data_ptr(), out[1].data_ptr(), tab.data_ptr(), pairs,
            steps, 2, seed, p.ctypes.data, cdg.ctypes.data,
            int(cdg.shape[1]), stream)
    else:
        rc = lib.mcos_rbergomi_lift_stats(
            out.data_ptr(), tab.data_ptr(), pairs, steps, 2, seed,
            p.ctypes.data, cdg.ctypes.data, int(cdg.shape[1]), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.upper()} launch failed: {rc}")


def _rough_plain(kernel: str, pairs: int, steps: int, case, device,
                 seed=42):
    c, d, g, tail, hurst = case
    kw = dict(num_paths=pairs, num_steps=steps, device=device)
    if kernel == "k10":
        return torch.stack(ck.rbergomi_lift_integrals_plain(
            1.9, ROUGH_T, seed, c, d, g, tail, hurst, xi_flat=0.04, **kw))
    return torch.stack(list(ck.rbergomi_lift_stats_plain(
        (1.9, -0.9, 0.05, 0.01, 0.04, 1.0), ROUGH_T, seed, c, d, g, tail,
        hurst, **kw).values()))


def _k6_args(pairs: int, steps: int, T: float, kw: dict):
    """(launch arguments between `out` and the seed, launch scalars,
    output rows, plain-version call) of one K6 case; `kw` holds the
    wrapper's keywords and may set v0."""
    from mcos_tpu_torch.models.params import SVJParams

    kw = dict(kw)
    params = SVJParams(v0=kw.pop("v0")) if "v0" in kw else SVJParams()
    bridge, corridor = kw.get("bridge", False), kw.get("corridor", False)
    mode = ck._stats_mode(bridge, kw.get("bridge_up", True), corridor)
    w0, w1 = ck._stats_window(kw.get("window"), bridge, steps)
    consts = ck._stats_consts(params, 22500.0, T, steps,
                              kw.get("bridge_log_b", 0.0),
                              kw.get("bridge_log_l", 0.0))
    companion = kw.get("companion", True)
    rows = len(ck._stats_names(mode, companion))
    args = (pairs, steps, 2, mode, int(companion), w0, w1)

    def plain(seed):
        return torch.stack(list(ck.svj_path_stats_plain(
            params, 22500.0, T, seed, num_paths=pairs, num_steps=steps,
            device=torch.device("cuda", 0), **kw).values()))
    return args, consts, rows, plain


def _k6_call(lib, out, args, consts, seed=43):
    rc = lib.mcos_svj_path_stats(out.data_ptr(), *args, seed,
                                 consts.ctypes.data,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: {rc}")


def _k8_params(lam: float):
    from mcos_tpu_torch.models.params import SVCJParams

    return SVCJParams(lambda_j=lam)


def _k8_call(lib, out, pairs, steps, companion, consts, seed=43):
    rc = lib.mcos_svcj_terminal(
        out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr() if companion else None, pairs, steps, 2, seed,
        consts.ctypes.data, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K8 launch failed: {rc}")


# Plain versions' outputs by case, made once for all versions of a run.
_PLAIN = {}


def _plain_once(key, make):
    if key not in _PLAIN:
        _PLAIN[key] = make()
    return _PLAIN[key]


def check_outputs(lib, device, kernels=tuple(_KERNELS)) -> dict:
    """A version's kernels against the plain torch versions."""
    res = {}
    for name, members, paths, steps, T, streamed in (
            K1_CHECKS if "k1" in kernels else ()):
        pop, draws, table, table_dev = _k1_case(members, paths, steps, T,
                                                streamed, device)
        out = torch.empty((3, members, 2, paths), device=device)
        _k1_call(lib, out, draws, table, table_dev, seed=42)
        ref = _plain_once(("k1", name), lambda: torch.stack(
            ck.svj_terminal_from_draws_population_plain(
                table, 22500.0, T, *draws, seed=42, companion=True,
                steps_major=True)))
        key = f"k1_{name}_{members}x{paths}x{steps}"
        for i, label in enumerate("svg"):
            res[f"{key}_{label}_bit_equal_share"] = float(
                (out[i] == ref[i]).float().mean())
        res[f"{key}_s_g_max_rel_err"] = max(
            float(((out[i] - ref[i]).abs() / ref[i].abs()).max())
            for i in (0, 2))
        one = torch.empty((3, 1, 2, paths), device=device)
        same = True
        for m in range(members):
            _k1_call(lib, one, draws, table[m:m + 1], table_dev[m:m + 1],
                     seed=42)
            same = same and bool((one[:, 0] == out[:, m]).all())
        res[f"{key}_members_equal_one_member_launches"] = same
    for name, pairs, steps, T, kw in K6_CHECKS if "k6" in kernels else ():
        args, consts, rows, plain = _k6_args(pairs, steps, T, kw)
        out = torch.empty((rows, 2, pairs), device=device)
        _k6_call(lib, out, args, consts, seed=42)
        ref = _plain_once(("k6", name), lambda: plain(42))
        # bit for bit, -inf (a dead path's log-survival) equal to -inf
        res[f"k6_{name}_{pairs}x{steps}_bit_equal"] = bool(
            (out == ref).all())
    for steps, T, comp, lam in K8_CHECKS if "k8" in kernels else ():
        params = _k8_params(lam)
        out = torch.empty((3, 2, K8_PAIRS), device=device)
        _k8_call(lib, out, K8_PAIRS, steps, comp,
                 ck._svcj_consts(params, 22500.0, T, steps), seed=42)
        ref = _plain_once(("k8", steps, comp, lam), lambda: torch.stack(
            [x for x in ck.svcj_terminal_plain(
                params, 22500.0, T, 42, num_paths=K8_PAIRS, num_steps=steps,
                companion=comp, device=device) if x is not None]))
        res[f"k8_{K8_PAIRS}x{steps}_lam{lam:g}_"
            f"{'g' if comp else 'no_g'}_bit_equal"] = bool(
            (out[:len(ref)] == ref).all())
    for pairs, steps in ((1 << 21, 252), (50_001, 1), (50_001, 13)):
        if "k2" not in kernels:
            break
        out = torch.empty((2, pairs), device=device)
        _k2_call(lib, out, pairs, steps, 7)
        ref = ck.gbm_terminal_plain(22500.0, 0.2, 0.065, 0.012, 1.0, 7,
                                    num_paths=pairs, num_steps=steps,
                                    device=device)
        res[f"k2_{pairs}x{steps}_max_rel_err"] = float(
            ((out - ref).abs() / ref.abs()).max())
    for pairs, steps in ((200_003, 512), (10_007, 63)):
        if "k9" not in kernels:
            break
        case = _td_case(steps)
        out = torch.empty((3, 2, pairs), device=device)
        _k9_call(lib, out, steps, case, device, False, seed=42, pairs=pairs)
        ref = ck.svj_terminal_td_plain(case[0], *case[1], 22500.0, case[2],
                                       42, num_paths=pairs, num_steps=steps,
                                       companion=True, device=device)
        res[f"k9_{pairs}x{steps}_max_abs_err"] = max(
            float((a - b).abs().max()) for a, b in zip(out, ref))
        res[f"k9_{pairs}x{steps}_v_bit_equal"] = bool((out[1] == ref[1]).all())
    for name, paths, steps, T, fields in K5_CHECKS if "k5" in kernels else ():
        params, net, uj, consts = _k5_case(paths, steps, T, fields, device)
        for mode, u in (("explicit", uj), ("own_jumps", None)):
            out = torch.empty((3, 2, paths), device=device)
            _k5_call(lib, out, net, u, consts, seed=42)
            ref = _plain_once(("k5", name, mode), lambda: torch.stack(
                ck.svj_terminal_qe_from_draws_plain(
                    params, 22500.0, T, net[0], net[1], u, net[2], seed=42,
                    companion=True, steps_major=True)))
            key = f"k5_{name}_{paths}x{steps}_{mode}"
            res[f"{key}_v_bit_equal"] = bool((out[1] == ref[1]).all())
            res[f"{key}_v_bit_equal_share"] = float(
                (out[1] == ref[1]).float().mean())
            res[f"{key}_s_g_max_rel_err"] = max(
                float(((out[i] - ref[i]).abs() / ref[i].abs()).max())
                for i in (0, 2))
    for kernel in ("k3", "k4"):
        if kernel not in kernels:
            continue
        cases = PRNG_CHECKS + (K4_PSI_CHECKS if kernel == "k4" else ())
        for name, pairs, steps, T, nb, comp, fields in cases:
            params, consts, cdf = _prng_case(kernel, steps, T, fields, device)
            out = torch.empty((3, nb, pairs), device=device)
            _prng_call(lib, kernel, out, pairs, steps, nb, comp, consts, cdf,
                       seed=42)
            ref = _plain_once((kernel, name), lambda: [
                x for x in getattr(ck, _PRNG[kernel][1])(
                    params, 22500.0, T, 42, num_paths=pairs,
                    num_steps=steps, antithetic=nb == 2, companion=comp,
                    device=device) if x is not None])
            key = f"{kernel}_{name}_{pairs}x{steps}_{nb}b"
            res[f"{key}_bit_equal"] = all(
                bool((out[i] == r).all()) for i, r in enumerate(ref))
            for i, (label, r) in enumerate(zip("svg", ref)):
                res[f"{key}_{label}_bit_equal_share"] = float(
                    (out[i] == r).float().mean())
            res[f"{key}_s_max_rel_err"] = float(
                ((out[0] - ref[0]).abs() / ref[0].abs()).max())
    for steps, nb in K7_CHECKS if "k7" in kernels else ():
        params = _k7_params()
        out = torch.empty((2, nb, K7_PAIRS), device=device)
        _k7_call(lib, out, K7_PAIRS, steps, nb,
                 ck._hhw_consts(params, 22500.0, K7_T, steps), seed=42)
        ref = _plain_once(("k7", steps, nb), lambda: torch.stack(
            ck.hhw_terminal_plain(params, 22500.0, K7_T, 42,
                                  num_paths=K7_PAIRS, num_steps=steps,
                                  antithetic=nb == 2, device=device)))
        key = f"k7_{K7_PAIRS}x{steps}_{nb}b"
        res[f"{key}_bit_equal"] = bool((out == ref).all())
        for i, label in enumerate(("s", "d")):
            res[f"{key}_{label}_bit_equal_share"] = float(
                (out[i] == ref[i]).float().mean())
    for kernel in ("k10", "k11"):
        if kernel not in kernels:
            continue
        for pairs, steps, m, hurst in ROUGH_CHECKS:
            case = _rough_case(steps, m, hurst)
            out = torch.empty((2 if kernel == "k10" else 4, 2, pairs),
                              device=device)
            _rough_call(lib, kernel, out, pairs, steps,
                        _rough_args(kernel, steps, case, device), seed=42)
            ref = _rough_plain(kernel, pairs, steps, case, device)
            res[f"{kernel}_{pairs}x{steps}_m{m}_bit_equal"] = bool(
                (out == ref).all())
    torch.cuda.synchronize()
    return res


def time_versions(libs: dict, device, kernels=tuple(_KERNELS),
                  k5_libs=None) -> dict:
    """Each shape timed over the versions in turns: A B ... B A; with
    `k5_libs` ({label: K5 lab library}), K5's floors too."""
    k5_libs = k5_libs or {}
    order = list(libs) + list(reversed(list(libs)))
    res = {}
    for name, members, paths, steps, T, streamed in (
            K1_CASES if "k1" in kernels else ()):
        _, draws, table, table_dev = _k1_case(members, paths, steps, T,
                                              streamed, device)
        out = torch.empty((3, members, 2, paths), device=device)
        runs = collections.defaultdict(list)
        for label in order:
            runs[label].append(_events_ms(
                lambda: _k1_call(libs[label], out, draws, table, table_dev),
                20))
        res[f"k1_{name}_{members}x{paths}x{steps}"] = dict(runs)
    for pairs, steps, reps in K2_SHAPES if "k2" in kernels else ():
        out = torch.empty((2, pairs), device=device)
        runs = collections.defaultdict(list)
        for label in order:
            runs[label].append(_events_ms(
                lambda: _k2_call(libs[label], out, pairs, steps, 8), reps))
        res[f"k2_{pairs}x{steps}"] = dict(runs)
    out = torch.empty((3, 2, K9_PAIRS), device=device)
    for steps, reps in K9_SHAPES if "k9" in kernels else ():
        case = _td_case(steps)
        for upload in (False, True):
            runs = collections.defaultdict(list)
            for label in order:
                runs[label].append(_events_ms(
                    lambda: _k9_call(libs[label], out, steps, case, device,
                                     upload), reps))
            res[f"k9_{K9_PAIRS}x{steps}_{'upload' if upload else 'kernel'}"
                ] = dict(runs)
    if "k6" in kernels:
        cases = list(K6_VARIANTS) + [
            (name, pairs, steps, T, kw)
            for name, _, steps, T, kw in K6_VARIANTS[:3:2]
            for pairs in K6_SWEEP]
        for name, pairs, steps, T, kw in cases:
            args, consts, rows, _ = _k6_args(pairs, steps, T, kw)
            out = torch.empty((rows, 2, pairs), device=device)
            runs = collections.defaultdict(list)
            for label in order:
                runs[label].append(_events_ms(
                    lambda: _k6_call(libs[label], out, args, consts), 20))
            res[f"k6_{name}_{pairs}x{steps}"] = dict(runs)
    for steps, T in K8_TIMED if "k8" in kernels else ():
        out = torch.empty((3, 2, K8_PAIRS), device=device)
        consts = ck._svcj_consts(_k8_params(1.0), 22500.0, T, steps)
        runs = collections.defaultdict(list)
        for label in order:
            runs[label].append(_events_ms(
                lambda: _k8_call(libs[label], out, K8_PAIRS, steps, True,
                                 consts), 20))
        res[f"k8_{K8_PAIRS}x{steps}"] = dict(runs)
    if "k5" in kernels:
        params, net, uj, consts = _k5_case(*K5_CHECKS[0][1:], device)
        out = torch.empty((3, 2, K5_PATHS), device=device)
        fns = [("own_jumps", None, "qe"), ("explicit", uj, "qe")]
        if all(k5_libs.get(label) for label in libs):
            fns += [("read_floor", None, "read"),
                    ("compute_floor", None, "compute")]
        for mode, u, fn in fns:
            runs = collections.defaultdict(list)
            for label in order:
                lib = libs[label] if fn == "qe" else k5_libs[label]
                runs[label].append(_events_ms(
                    lambda: _k5_call(lib, out, net, u, consts, fn=fn), 20))
            res[f"k5_{K5_PATHS}x63_{mode}"] = dict(runs)
        for paths in K5_SWEEP:
            params, net, _, consts = _k5_case(paths, 63, 0.25, {}, device)
            out = torch.empty((3, 2, paths), device=device)
            runs = collections.defaultdict(list)
            for label in order:
                runs[label].append(_events_ms(
                    lambda: _k5_call(libs[label], out, net, None, consts),
                    20))
            res[f"k5_{paths}x63_own_jumps"] = dict(runs)
    for kernel in ("k3", "k4"):
        if kernel not in kernels:
            continue
        _, consts, cdf = _prng_case(kernel, 63, 0.25, {}, device)
        for pairs in (PRNG_PAIRS, *K5_SWEEP):
            out = torch.empty((3, 2, pairs), device=device)
            runs = collections.defaultdict(list)
            for label in order:
                runs[label].append(_events_ms(
                    lambda: _prng_call(libs[label], kernel, out, pairs, 63,
                                       2, True, consts, cdf), 20))
            res[f"{kernel}_{pairs}x63"] = dict(runs)
    for pairs in (K7_PAIRS, *K7_SWEEP) if "k7" in kernels else ():
        consts = ck._hhw_consts(_k7_params(), 22500.0, K7_T, 128)
        out = torch.empty((2, 2, pairs), device=device)
        runs = collections.defaultdict(list)
        for label in order:
            runs[label].append(_events_ms(
                lambda: _k7_call(libs[label], out, pairs, 128, 2, consts),
                20))
        res[f"k7_{pairs}x128"] = dict(runs)
    for kernel in ("k10", "k11"):
        if kernel not in kernels:
            continue
        out = torch.empty((2 if kernel == "k10" else 4, 2, ROUGH_PAIRS),
                          device=device)
        for steps, reps in ROUGH_SHAPES:
            args = _rough_args(kernel, steps, _rough_case(steps), device)
            runs = collections.defaultdict(list)
            for label in order:
                runs[label].append(_events_ms(
                    lambda: _rough_call(libs[label], kernel, out,
                                        ROUGH_PAIRS, steps, args), reps))
            res[f"{kernel}_{ROUGH_PAIRS}x{steps}"] = dict(runs)
    return res


# K1's wrappers: (name, members, paths, steps, T, streamed jump uniforms).
K1_WRAPPER_CASES = (("price", 1, 500_000, 63, 0.25, False),
                    ("price_50k", 1, 50_000, 63, 0.25, False),
                    ("calibration", 24, 100_000, 50, 0.5, True))
# Run by `time_wrappers` in a fresh process inside one version's tree; its
# last line of output is a JSON object {case: {loop_ms, host_ms,
# latency_ms}}.
_WRAPPER_TIMER = r"""
import json, statistics, sys, time
import numpy as np, torch
from mcos_tpu_torch.config import PARAM_BOUNDS
from mcos_tpu_torch.models.params import SVJParams
from mcos_tpu_torch.ops import cuda_kernels as ck

dev = torch.device("cuda", 0)
ck.load_library()
res = {}
for name, members, paths, steps, T, streamed in json.loads(sys.argv[1]):
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    z = torch.randn((3, steps, paths), generator=gen, device=dev)
    u = torch.rand((steps, paths), generator=gen, device=dev) \
        if streamed else None
    rng = np.random.default_rng(16)
    pop = [SVJParams()] + [
        SVJParams(**{k: float(lo + (hi - lo) * rng.random())
                     for k, (lo, hi) in PARAM_BOUNDS.items()})
        for _ in range(members - 1)]
    kw = dict(antithetic=True, companion=True, steps_major=True)
    args = (22500.0, T, z[0], z[1], u, z[2])
    if members == 1:
        call = lambda: ck.svj_terminal_from_draws(pop[0], *args, **kw)
    elif hasattr(ck, "svj_terminal_from_draws_population"):
        call = lambda: ck.svj_terminal_from_draws_population(pop, *args,
                                                             **kw)
    else:
        call = lambda: [ck.svj_terminal_from_draws(p, *args, **kw)
                        for p in pop]
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    reps, host, lat = 100, [], []
    t0 = time.perf_counter()
    for _ in range(reps):
        h = time.perf_counter()
        call()
        host.append(time.perf_counter() - h)
    torch.cuda.synchronize()
    loop = (time.perf_counter() - t0) / reps
    for _ in range(reps):
        h = time.perf_counter()
        call()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - h)
    res[name] = {"loop_ms": loop * 1e3,
                 "host_ms": statistics.median(host) * 1e3,
                 "latency_ms": statistics.median(lat) * 1e3}
print(json.dumps(res))
"""


def time_wrappers(roots: dict, rounds: int = 2) -> dict:
    """K1's wrappers of each version in turns (A B ... B A, `rounds`
    times: the host's clock spreads more than the card's), a process a
    turn, each importing `mcos_tpu_torch` from its ROOT (which builds its
    own library there on first use)."""
    order = (list(roots) + list(reversed(list(roots)))) * rounds
    runs = collections.defaultdict(lambda: collections.defaultdict(list))
    for label in order:
        root = os.path.abspath(roots[label])
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run(
            [sys.executable, "-c", _WRAPPER_TIMER,
             json.dumps(K1_WRAPPER_CASES)], cwd=root, env=env,
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"wrapper timer in {root} failed:\n"
                               f"{out.stderr[-4000:]}")
        for case, row in json.loads(out.stdout.strip().splitlines()[-1]
                                    ).items():
            for metric, ms in row.items():
                runs[f"k1_wrapper_{case}_{metric}"][label].append(ms)
    return {k: dict(v) for k, v in runs.items()}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", default=[],
                    help="LABEL=DIR holding the kernels' sources, philox.cuh")
    ap.add_argument("--kernels", default=",".join(_KERNELS),
                    help="comma-separated subset of " + ",".join(_KERNELS))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--levers", action="store_true",
                    help="also time each K3/K4/K5/K7 lever of the version "
                    "labelled 'new' taken out alone")
    ap.add_argument("--wrappers", action="append", default=[],
                    help="LABEL=ROOT holding a version of the package: "
                    "time K1's wrappers in turns")
    ap.add_argument("--dump", default="",
                    help="directory for each kernel's SASS listing")
    ap.add_argument("--out", default=os.path.join(_LAB_DIR,
                                                  "kernel_lab.json"))
    args = ap.parse_args()
    kernels = tuple(k for k in args.kernels.split(",") if k)
    unknown = set(kernels) - set(_KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_lab needs a CUDA device")
    versions = dict(v.split("=", 1) for v in args.csrc) or {
        "new": ck.CSRC_DIR}
    if args.levers:
        versions.update(lever_versions(versions["new"], kernels))
    device = torch.device("cuda", 0)
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "versions": versions,
              "kernels": kernels}
    print(f"card: {report['card']}", flush=True)
    built = build(versions, kernels)
    libs = {label: _load(info["lib"]) for label, info in built.items()}
    k5_libs = {label: _load(info["k5_lib"]) for label, info in built.items()
               if info["k5_lib"]}
    pattern = "|".join(_SASS_PATTERN[k] for k in kernels)
    for label, info in built.items():
        entry = report.setdefault(label, {})
        entry["ptxas"] = {}
        for text in info["ptxas"].values():
            entry["ptxas"].update(ptxas_resources(text))
        for fn, res in entry["ptxas"].items():
            kernel = next(k for k in kernels if _SASS_PATTERN[k] in fn)
            blocks = -(-TIMED_PAIRS[kernel] // 256)
            res["occupancy"] = occupancy(
                res["registers"], 256, blocks,
                smem=K1_SMEM if kernel == "k1" and "ILi" in fn else 0)
            occ = res["occupancy"]
            print(f"[{label}] {fn}: {res['registers']} registers, stack "
                  f"{res.get('stack')} B, spills {res.get('spill_stores')}/"
                  f"{res.get('spill_loads')} B; {occ['blocks_per_sm']} blocks"
                  f" of 256 an SM, {blocks} blocks = {occ['waves']:.3f} "
                  f"waves", flush=True)
        if args.sass:
            prefix = ""
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                prefix = os.path.join(args.dump, f"{label}_")
            entry["sass"] = sass_report(info["lib"], pattern, prefix)
            for fn, rep in entry["sass"].items():
                print(f"[{label}] {fn}: {rep['instructions']} instructions",
                      flush=True)
                for lp in rep["loops"]:
                    per = (f", {lp['pair_steps']:g} pair-steps a pass, "
                           f"{lp['hot_per_pair_step']:.1f} hot a pair-step "
                           f"({lp['hot_if_branches_skip_per_pair_step']:.1f}"
                           f" where every forward branch skips)"
                           if "pair_steps" in lp else "")
                    print(f"    loop {lp['start']:#x}-{lp['end']:#x}: "
                          f"{lp['instructions']} instructions "
                          f"({lp['hot_instructions']} hot){per}, "
                          f"{lp['exits_to_slow_paths']} exits; "
                          f"hot {lp['hot_by_class']}", flush=True)
        if args.probes and info["probe_lib"]:
            entry["probes"] = probes(_load(info["probe_lib"]), device)
            print(f"[{label}] probes: {json.dumps(entry['probes'])}",
                  flush=True)
        if args.probes and label in k5_libs:
            with open(os.path.join(info["dir"], "svj_qe_draws.cu")) as f:
                has_form = "acklam_converged" in f.read()
            entry["acklam_probe"] = acklam_probe(k5_libs[label], device,
                                                 has_form)
            print(f"[{label}] Acklam probe: "
                  f"{json.dumps(entry['acklam_probe'])}", flush=True)
        if args.time:
            entry["checks"] = check_outputs(libs[label], device, kernels)
            print(f"[{label}] checks: {json.dumps(entry['checks'])}",
                  flush=True)
    if args.time:
        report["times_ms"] = time_versions(libs, device, kernels, k5_libs)
        for shape, runs in report["times_ms"].items():
            print(f"{shape}: " + ", ".join(
                f"{label} {np.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
                for label, v in runs.items()), flush=True)
    if args.wrappers:
        report["wrapper_times_ms"] = time_wrappers(
            dict(v.split("=", 1) for v in args.wrappers))
        for shape, runs in report["wrapper_times_ms"].items():
            print(f"{shape}: " + ", ".join(
                f"{label} {np.mean(v):.4f} ({', '.join(f'{x:.4f}' for x in v)})"
                for label, v in runs.items()), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"card: {report['card']}", flush=True)

if __name__ == "__main__":
    main()
