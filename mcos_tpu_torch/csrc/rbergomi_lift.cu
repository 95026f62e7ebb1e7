// K10: rough Bergomi Markovian-lift integrals from an in-kernel generator
// (POST /api/rough at num_steps >= 512 without Sobol:
// RoughBergomiEngine.price, smile and skew).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_rbergomi_lift_kernel and its
// wrapper rbergomi_lift_integrals_pallas. Per path, the m-factor lift of the
// Volterra fBM, W~_t ~= sum_j c_j y_j + sqrt(tail_i) zeta, and the
// Romano-Touzi sufficient statistics of both antithetic branches:
//   w    = sqrt(tail_i) zeta + sum_j c_j y_j       (j in order)
//   v_+- = exp(+-eta w + e_i),  e_i = ln xi_i - eta^2/2 t_i^{2H}
//   I1  += sqrt(v) (+-dW),  I2 += v,  y_j <- d_j y_j + g_j dW
// and I2 is scaled by dt once at the end. The factor state is linear in the
// draws, so the minus branch's state is exactly -y in IEEE arithmetic: one
// state serves both branches, as in the TPU body, and only the exp, the
// sqrt and the two sums are done per branch.
//
// What bounds it on an H100: instruction issue. A (2, steps) table is read
// (every thread the same address: a broadcast from L1) and 16 B per pair
// are written. Bit-equality with the plain version fixes every operation
// on the carries (uncontracted, in its order: 5m + 1 a pair-step for the
// mix and the factor update, 126 at m = 25) and the accurate expf, logf,
// sqrtf and sincosf, so a pair-step takes 333 instructions at m = 25 by
// cuobjdump -sass without the never-taken slow paths (python -m
// mcos_tpu_torch.kernel_lab --sass; 172 at m = 1), against the 125
// operation slots chip_smoke.py counts (48 + 3m + 2, FMAs allowed), and
// issues at about 1.1 clocks an instruction. The design:
//   - one thread per antithetic pair; the m factors in registers. The
//     factor loops are unrolled to the exact m for the route's m = 25 (24
//     fitted nodes and the top-up node), for m = 24 (no top-up) and for
//     m = 1 (H = 1/2), with no guard, so each c_j and (d_j, g_j) is read
//     from the constant bank as it is used; every other m <= 32 runs the
//     loops to 32 under the guard j < m (at m = 25 the guarded loops take
//     422 instructions a pair-step: a compare and a constant load per
//     factor operation, and 1.76 times the time);
//   - Box-Muller through philox.cuh:box_muller_sincos (one range reduction
//     for the sine and the cosine), the conversion-free uniform and the
//     Philox round keys in the constant bank, none of which moves a bit;
//   - 54 registers: 4 blocks of 256 an SM, the route's 131 072 pairs (512
//     blocks) in one wave on 132 SMs.
//
// Tables: c and the pairs (d_j, g_j) (m <= 32 each) ride in the kernel's
// parameter struct (constant bank); the (2, steps) table [e_i,
// sqrt(tail_{i-1})] (left points, t_0 row first: sqrt(tail) shifted by
// one, t^{2H} = 0 at t = 0) is computed in float64 on the host and cast
// once (cuda_kernels.py:_rough_tables) and stays in global memory behind
// __ldg.
//
// Stream: counter (pair_lo, pair_hi, call, kRoughDomain), key = seed; call
// i gives Box-Muller(a0, a1) = (z_dW, z_zeta) for step 2i and
// Box-Muller(a2, a3) for step 2i + 1; an odd last step uses a0, a1 of its
// own call. The normals depend on (seed, pair, step) only.
// cuda_kernels.py:rbergomi_lift_integrals_plain draws the same words and
// performs the same IEEE operations in the same order (philox.cuh: fmul,
// fadd), so the two agree bit for bit on the card.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using mcos::box_muller_sincos;
using mcos::fadd;
using mcos::fmul;

constexpr int kMaxFactors = 32;
constexpr int kThreads = 256;

// Per-launch scalars and factor tables (cuda_kernels.py:_rough_tables).
struct LiftConsts {
  float eta, sqrt_dt, dt;
  int m;
  float c[kMaxFactors];
  float2 dg[kMaxFactors];  // (d_j, g_j): one 8-byte constant-bank read
};

__device__ __forceinline__ float unit(uint32_t bits) {
  return mcos::bits_to_uniform_bitcast(bits);
}

// One step of the lift for both branches (pallas_kernels.py:
// _rbergomi_lift_kernel body). M is the factor count when EXACT; else the
// loops run to M under the launch's guard j < m.
template <int NB, int M, bool EXACT>
__device__ __forceinline__ void lift_step(const LiftConsts& c,
                                          const float* __restrict__ tab,
                                          int steps, int idx, float z_dw,
                                          float z_zeta, float (&y)[M],
                                          float (&i1)[NB], float (&i2)[NB]) {
  const float e_i = __ldg(tab + idx);
  const float sqrt_tail = __ldg(tab + steps + idx);
  float w = fmul(sqrt_tail, z_zeta);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (EXACT || j < c.m) w = fadd(w, fmul(c.c[j], y[j]));
  }
  const float ew = fmul(c.eta, w);
  const float dw = fmul(z_dw, c.sqrt_dt);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float v = expf(fadd(k == 0 ? ew : -ew, e_i));
    i1[k] = fadd(i1[k], fmul(sqrtf(v), k == 0 ? dw : -dw));
    i2[k] = fadd(i2[k], v);
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (EXACT || j < c.m) {
      y[j] = fadd(fmul(c.dg[j].x, y[j]), fmul(c.dg[j].y, dw));
    }
  }
}

__device__ __forceinline__ uint4 lift_words(long long p, int call,
                                           const mcos::PhiloxKeys& keys) {
  return mcos::philox4x32_10(
      make_uint4(static_cast<uint32_t>(p),
                 static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32),
                 static_cast<uint32_t>(call), mcos::kRoughDomain),
      keys);
}

template <int NB, int M, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    rbergomi_lift_kernel(float* __restrict__ i1_out,
                         float* __restrict__ i2_out,
                         const float* __restrict__ tab, long long n,
                         int steps, mcos::PhiloxKeys keys, LiftConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float y[M];
#pragma unroll
  for (int j = 0; j < M; ++j) y[j] = 0.0f;
  float i1[NB], i2[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    i1[k] = 0.0f;
    i2[k] = 0.0f;
  }
  const int full_calls = steps >> 1;
  for (int call = 0; call < full_calls; ++call) {
    const uint4 b = lift_words(p, call, keys);
    float z_dw, z_zeta;
    box_muller_sincos(unit(b.x), unit(b.y), z_dw, z_zeta);
    lift_step<NB, M, EXACT>(c, tab, steps, 2 * call, z_dw, z_zeta, y, i1,
                            i2);
    box_muller_sincos(unit(b.z), unit(b.w), z_dw, z_zeta);
    lift_step<NB, M, EXACT>(c, tab, steps, 2 * call + 1, z_dw, z_zeta, y,
                            i1, i2);
  }
  if (steps & 1) {  // the odd last step takes the first pair of its call
    const uint4 b = lift_words(p, full_calls, keys);
    float z_dw, z_zeta;
    box_muller_sincos(unit(b.x), unit(b.y), z_dw, z_zeta);
    lift_step<NB, M, EXACT>(c, tab, steps, steps - 1, z_dw, z_zeta, y, i1,
                            i2);
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    i1_out[k * n + p] = i1[k];
    i2_out[k * n + p] = fmul(i2[k], c.dt);
  }
}

template <int NB, int M, bool EXACT>
void launch(float* i1, float* i2, const float* tab, long long n, int steps,
            const mcos::PhiloxKeys& keys, const LiftConsts& c,
            cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  rbergomi_lift_kernel<NB, M, EXACT>
      <<<blocks, kThreads, 0, st>>>(i1, i2, tab, n, steps, keys, c);
}

// The route's tables have m = 25 (24 fitted nodes and the top-up node;
// 24 without the top-up) and H = 1/2 has m = 1: those run with no guard.
// Every other m <= 32 takes the guarded loops.
template <int NB>
void dispatch(float* i1, float* i2, const float* tab, long long n, int steps,
              const mcos::PhiloxKeys& keys, const LiftConsts& c,
              cudaStream_t st) {
  switch (c.m) {
    case 1:
      launch<NB, 1, true>(i1, i2, tab, n, steps, keys, c, st);
      break;
    case 24:
      launch<NB, 24, true>(i1, i2, tab, n, steps, keys, c, st);
      break;
    case 25:
      launch<NB, 25, true>(i1, i2, tab, n, steps, keys, c, st);
      break;
    default:
      launch<NB, kMaxFactors, false>(i1, i2, tab, n, steps, keys, c, st);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown branch count or m outside 1..32). Does not synchronise.
// `p_host` = [eta, sqrt_dt, dt]; `cdg_host` = (3, m) rows c, d, g; `tab` a
// device array of (2, steps) float32 rows [e_i, sqrt_tail_left_i]. Outputs
// are (n_branch, n) row-major float32: I1 and I2 (already times dt).
extern "C" int mcos_rbergomi_lift_integrals(float* i1_out, float* i2_out,
                                            const float* tab, long long n,
                                            int steps, int n_branch,
                                            unsigned long long seed,
                                            const float* p_host,
                                            const float* cdg_host, int m,
                                            void* stream) {
  if (m < 1 || m > kMaxFactors) return static_cast<int>(cudaErrorInvalidValue);
  LiftConsts c;
  std::memset(&c, 0, sizeof(c));
  c.eta = p_host[0];
  c.sqrt_dt = p_host[1];
  c.dt = p_host[2];
  c.m = m;
  std::memcpy(c.c, cdg_host, m * sizeof(float));
  for (int j = 0; j < m; ++j) {
    c.dg[j] = make_float2(cdg_host[m + j], cdg_host[2 * m + j]);
  }
  const mcos::PhiloxKeys keys = mcos::philox_round_keys(seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    dispatch<2>(i1_out, i2_out, tab, n, steps, keys, c, st);
  } else if (n_branch == 1) {
    dispatch<1>(i1_out, i2_out, tab, n, steps, keys, c, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
