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
// What bounds it on an H100: arithmetic. A (2, steps) table is read (every
// thread the same address: a broadcast from L1) and 16 B per pair are
// written; each pair-step needs half a Philox4x32-10 call, one Box-Muller
// pair, 3m + 1 multiply-adds for the mix and the factor update, and two
// branches of exp, sqrt and two sums: 48 + 3m operation slots, 123 at
// m = 25 (chip_smoke.py's count). One thread per antithetic pair keeps the
// m factors in registers: the loops over j are unrolled to the template's
// MMAX with a uniform guard j < m, so y never leaves the register file.
//
// Tables: c, d, g (m <= 32 each) ride in the kernel's parameter struct
// (constant bank); the (2, steps) table [e_i, sqrt(tail_{i-1})] (left
// points, t_0 row first: sqrt(tail) shifted by one, t^{2H} = 0 at t = 0) is
// computed in float64 on the host and cast once (cuda_kernels.py:
// _rough_tables) and stays in global memory behind __ldg.
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

using mcos::fadd;
using mcos::fmul;

constexpr int kMaxFactors = 32;

// Per-launch scalars and factor tables (cuda_kernels.py:_rough_tables).
struct LiftConsts {
  float eta, sqrt_dt, dt;
  int m;
  float c[kMaxFactors], d[kMaxFactors], g[kMaxFactors];
};

// One step of the lift for both branches (pallas_kernels.py:
// _rbergomi_lift_kernel body).
template <int NB, int MMAX>
__device__ __forceinline__ void lift_step(const LiftConsts& c,
                                          const float* __restrict__ tab,
                                          int steps, int idx, float z_dw,
                                          float z_zeta, float (&y)[MMAX],
                                          float (&i1)[NB], float (&i2)[NB]) {
  const float e_i = __ldg(tab + idx);
  const float sqrt_tail = __ldg(tab + steps + idx);
  float w = fmul(sqrt_tail, z_zeta);
#pragma unroll
  for (int j = 0; j < MMAX; ++j) {
    if (j < c.m) w = fadd(w, fmul(c.c[j], y[j]));
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
  for (int j = 0; j < MMAX; ++j) {
    if (j < c.m) y[j] = fadd(fmul(c.d[j], y[j]), fmul(c.g[j], dw));
  }
}

template <int NB, int MMAX>
__global__ void __launch_bounds__(256)
    rbergomi_lift_kernel(float* __restrict__ i1_out,
                         float* __restrict__ i2_out,
                         const float* __restrict__ tab, long long n,
                         int steps, uint2 key, LiftConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);

  float y[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) y[j] = 0.0f;
  float i1[NB], i2[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    i1[k] = 0.0f;
    i2[k] = 0.0f;
  }
  const int n_calls = (steps + 1) >> 1;
  for (int call = 0; call < n_calls; ++call) {
    const uint4 b = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(call),
                   mcos::kRoughDomain),
        key);
    float z_dw, z_zeta;
    mcos::box_muller(mcos::bits_to_uniform(b.x), mcos::bits_to_uniform(b.y),
                     z_dw, z_zeta);
    lift_step<NB, MMAX>(c, tab, steps, 2 * call, z_dw, z_zeta, y, i1, i2);
    if (2 * call + 1 < steps) {
      mcos::box_muller(mcos::bits_to_uniform(b.z),
                       mcos::bits_to_uniform(b.w), z_dw, z_zeta);
      lift_step<NB, MMAX>(c, tab, steps, 2 * call + 1, z_dw, z_zeta, y, i1,
                          i2);
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    i1_out[k * n + p] = i1[k];
    i2_out[k * n + p] = fmul(i2[k], c.dt);
  }
}

template <int NB, int MMAX>
void launch(float* i1, float* i2, const float* tab, long long n, int steps,
            uint2 key, const LiftConsts& c, cudaStream_t st) {
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  rbergomi_lift_kernel<NB, MMAX>
      <<<blocks, threads, 0, st>>>(i1, i2, tab, n, steps, key, c);
}

template <int NB>
void dispatch(float* i1, float* i2, const float* tab, long long n, int steps,
             uint2 key, const LiftConsts& c, cudaStream_t st) {
  // m = 25 is the engine's 24 fitted factors plus the top-up node; m = 1
  // is H = 1/2.
  if (c.m == 1) {
    launch<NB, 1>(i1, i2, tab, n, steps, key, c, st);
  } else if (c.m <= 25) {
    launch<NB, 25>(i1, i2, tab, n, steps, key, c, st);
  } else {
    launch<NB, kMaxFactors>(i1, i2, tab, n, steps, key, c, st);
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
  std::memcpy(c.d, cdg_host + m, m * sizeof(float));
  std::memcpy(c.g, cdg_host + 2 * m, m * sizeof(float));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    dispatch<2>(i1_out, i2_out, tab, n, steps, key, c, st);
  } else if (n_branch == 1) {
    dispatch<1>(i1_out, i2_out, tab, n, steps, key, c, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
