// K11: rough Bergomi Markovian-lift path statistics from an in-kernel
// generator (POST /api/rough at num_steps >= 512 without Sobol:
// RoughBergomiEngine.price_asian, price_barrier and price_lookback).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_rbergomi_lift_stats_kernel and
// its wrapper rbergomi_lift_stats_pallas. K10's factor recursion
// (csrc/rbergomi_lift.cu: one factor state for both branches, the mix w in
// order over j, v_+- = exp(+-eta w + e_i)) plus the spot leg the
// Romano-Touzi integrals never needed:
//   dz    = (rho z_dW + orth z_perp) sqrt(dt)          (odd in the draws)
//   ls   += (mu dt - v/2 dt) + sqrt(v) (+-dz)
//   sum  += exp(ls),  max ls,  min ls
// per branch, over the observation grid t_1..t_n. Outputs S_T/S0, mean S/S0
// (sum times float32(1/n)), max S/S0, min S/S0; the wrapper scales by the
// spot (max and min commute with the monotone spot exp(.)).
//
// What bounds it on an H100: instruction issue. The same (2, steps) table
// as K10 is read (a broadcast from L1), 32 B per pair are written; each
// pair-step needs one Philox4x32-10 call, three uniforms, one and a half
// Box-Muller pairs, the 5m + 1 uncontracted operations of the mix and the
// factor update, dz, and two branches of exp, sqrt, the log-spot update,
// exp, sum, max and min. Bit-equality fixes the carries' operations and
// the accurate special functions, so a pair-step takes 430 instructions at
// m = 25 by cuobjdump -sass without the never-taken slow paths (275 at
// m = 1), against the 165 operation slots chip_smoke.py counts
// (88 + 3m + 2). The design is K10's (rbergomi_lift.cu): one thread per
// antithetic pair, the factors in registers, loops unrolled to the exact
// m for m in {1, 24, 25} and guarded for every other m <= 32,
// box_muller_sincos, the conversion-free uniform, round keys in the
// constant bank. The route's instantiation holds 64 registers with no
// spill, 4 blocks of 256 an SM, so its 512 blocks run in one wave on 132
// SMs: one register more and only 3 blocks fit, 1.29 waves
// (tests/test_torch_cuda.py holds the count).
//
// Stream: K7's layout in its own domain. Counter (pair_lo, pair_hi, call,
// kRoughStatsDomain), key = seed. Steps 2i and 2i + 1 take calls 2i and
// 2i + 1: words a0..a3, b0, b1 give the Box-Muller pairs (z_a, z_b),
// (z_c, z_d), (z_e, z_f); step 2i runs on (z_dW, z_zeta, z_perp) =
// (z_a, z_b, z_c), step 2i + 1 on (z_d, z_e, z_f); b2, b3 are spare. An odd
// last step takes call steps - 1 alone: (z1, z2) from a0, a1 and z3 from
// a2, a3. The normals depend on (seed, pair, step) only.
// cuda_kernels.py:rbergomi_lift_stats_plain draws the same words and
// performs the same IEEE operations in the same order (philox.cuh: fmul,
// fadd, fsub), so the two agree bit for bit on the card.
#include <cmath>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using mcos::box_muller_sincos;
using mcos::fadd;
using mcos::fmul;
using mcos::fsub;

constexpr int kMaxFactors = 32;
constexpr int kThreads = 256;

// Per-launch scalars and factor tables (cuda_kernels.py:_rough_tables).
struct StatsConsts {
  float eta, sqrt_dt, dt, rho, orth, mu_dt, inv_n;
  int m;
  float c[kMaxFactors];
  float2 dg[kMaxFactors];  // (d_j, g_j): one 8-byte constant-bank read
};

template <int NB, int M>
struct Carry {
  float y[M];
  float ls[NB], sum[NB], mx[NB], mn[NB];
};

__device__ __forceinline__ float unit(uint32_t bits) {
  return mcos::bits_to_uniform_bitcast(bits);
}

// One step for both branches (pallas_kernels.py:_rbergomi_lift_stats_kernel
// one_step). M is the factor count when EXACT; else the loops run to M
// under the launch's guard j < m.
template <int NB, int M, bool EXACT>
__device__ __forceinline__ void stats_step(const StatsConsts& c,
                                           const float* __restrict__ tab,
                                           int steps, int idx, float z_dw,
                                           float z_zeta, float z_perp,
                                           Carry<NB, M>& s) {
  const float e_i = __ldg(tab + idx);
  const float sqrt_tail = __ldg(tab + steps + idx);
  float w = fmul(sqrt_tail, z_zeta);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (EXACT || j < c.m) w = fadd(w, fmul(c.c[j], s.y[j]));
  }
  const float ew = fmul(c.eta, w);
  const float dw = fmul(z_dw, c.sqrt_dt);
  const float dz =
      fmul(fadd(fmul(c.rho, z_dw), fmul(c.orth, z_perp)), c.sqrt_dt);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float v = expf(fadd(k == 0 ? ew : -ew, e_i));
    const float drift = fsub(c.mu_dt, fmul(fmul(0.5f, v), c.dt));
    s.ls[k] = fadd(fadd(s.ls[k], drift), fmul(sqrtf(v), k == 0 ? dz : -dz));
    s.sum[k] = fadd(s.sum[k], expf(s.ls[k]));
    s.mx[k] = fmaxf(s.mx[k], s.ls[k]);
    s.mn[k] = fminf(s.mn[k], s.ls[k]);
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (EXACT || j < c.m) {
      s.y[j] = fadd(fmul(c.dg[j].x, s.y[j]), fmul(c.dg[j].y, dw));
    }
  }
}

__device__ __forceinline__ uint4 stats_words(long long p, int call,
                                            const mcos::PhiloxKeys& keys) {
  return mcos::philox4x32_10(
      make_uint4(static_cast<uint32_t>(p),
                 static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32),
                 static_cast<uint32_t>(call), mcos::kRoughStatsDomain),
      keys);
}

template <int NB, int M, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    rbergomi_stats_kernel(float* __restrict__ out,
                          const float* __restrict__ tab, long long n,
                          int steps, mcos::PhiloxKeys keys, StatsConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  Carry<NB, M> s;
#pragma unroll
  for (int j = 0; j < M; ++j) s.y[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    s.ls[k] = 0.0f;
    s.sum[k] = 0.0f;
    s.mx[k] = -INFINITY;
    s.mn[k] = INFINITY;
  }
  for (int i = 0; i + 1 < steps; i += 2) {
    // Step i runs on (z_a, z_b, z_c), step i + 1 on (z_d, z_e, z_f); call
    // i + 1 is made after step i, so only z_d waits across it.
    const uint4 a = stats_words(p, i, keys);
    float z_a, z_b, z_c, z_d;
    box_muller_sincos(unit(a.x), unit(a.y), z_a, z_b);
    box_muller_sincos(unit(a.z), unit(a.w), z_c, z_d);
    stats_step<NB, M, EXACT>(c, tab, steps, i, z_a, z_b, z_c, s);
    const uint4 b = stats_words(p, i + 1, keys);
    float z_e, z_f;
    box_muller_sincos(unit(b.x), unit(b.y), z_e, z_f);
    stats_step<NB, M, EXACT>(c, tab, steps, i + 1, z_d, z_e, z_f, s);
  }
  if (steps & 1) {
    const uint4 a = stats_words(p, steps - 1, keys);
    float z1, z2, z3, unused;
    box_muller_sincos(unit(a.x), unit(a.y), z1, z2);
    box_muller_sincos(unit(a.z), unit(a.w), z3, unused);
    stats_step<NB, M, EXACT>(c, tab, steps, steps - 1, z1, z2, z3, s);
  }
  const long long plane = NB * n;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    out[k * n + p] = expf(s.ls[k]);
    out[plane + k * n + p] = fmul(s.sum[k], c.inv_n);
    out[2 * plane + k * n + p] = expf(s.mx[k]);
    out[3 * plane + k * n + p] = expf(s.mn[k]);
  }
}

template <int NB, int M, bool EXACT>
void launch(float* out, const float* tab, long long n, int steps,
            const mcos::PhiloxKeys& keys, const StatsConsts& c,
            cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  rbergomi_stats_kernel<NB, M, EXACT>
      <<<blocks, kThreads, 0, st>>>(out, tab, n, steps, keys, c);
}

// As K10 (rbergomi_lift.cu:dispatch): m in {1, 24, 25} with no guard,
// every other m <= 32 guarded.
template <int NB>
void dispatch(float* out, const float* tab, long long n, int steps,
              const mcos::PhiloxKeys& keys, const StatsConsts& c,
              cudaStream_t st) {
  switch (c.m) {
    case 1:
      launch<NB, 1, true>(out, tab, n, steps, keys, c, st);
      break;
    case 24:
      launch<NB, 24, true>(out, tab, n, steps, keys, c, st);
      break;
    case 25:
      launch<NB, 25, true>(out, tab, n, steps, keys, c, st);
      break;
    default:
      launch<NB, kMaxFactors, false>(out, tab, n, steps, keys, c, st);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown branch count or m outside 1..32). Does not synchronise.
// `p_host` = [eta, sqrt_dt, dt, rho, orth, mu_dt, inv_n]; `cdg_host` =
// (3, m) rows c, d, g; `tab` a device array of (2, steps) float32 rows
// [e_i, sqrt_tail_left_i]. `out` is (4, n_branch, n) row-major float32:
// S_T/S0, mean S/S0, max S/S0, min S/S0.
extern "C" int mcos_rbergomi_lift_stats(float* out, const float* tab,
                                        long long n, int steps, int n_branch,
                                        unsigned long long seed,
                                        const float* p_host,
                                        const float* cdg_host, int m,
                                        void* stream) {
  if (m < 1 || m > kMaxFactors) return static_cast<int>(cudaErrorInvalidValue);
  StatsConsts c;
  std::memset(&c, 0, sizeof(c));
  c.eta = p_host[0];
  c.sqrt_dt = p_host[1];
  c.dt = p_host[2];
  c.rho = p_host[3];
  c.orth = p_host[4];
  c.mu_dt = p_host[5];
  c.inv_n = p_host[6];
  c.m = m;
  std::memcpy(c.c, cdg_host, m * sizeof(float));
  for (int j = 0; j < m; ++j) {
    c.dg[j] = make_float2(cdg_host[m + j], cdg_host[2 * m + j]);
  }
  const mcos::PhiloxKeys keys = mcos::philox_round_keys(seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    dispatch<2>(out, tab, n, steps, keys, c, st);
  } else if (n_branch == 1) {
    dispatch<1>(out, tab, n, steps, keys, c, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
