// K3: SVJ terminal state under full-truncation Euler from an in-kernel
// generator (the PRNG serving path, use_sobol=false, the batches of
// MonteCarloEngine.price_to_tolerance, and /api/exotic's digital).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_svj_kernel and its wrapper
// svj_terminal_pallas. The algebra is the TPU kernel's: the spot drift as
// drift_dt + (-dt/2) v, the variance drift as (1 - kappa dt) v +
// kappa theta dt, both branches of an antithetic pair in one thread with
// the normals negated on the second; the companion control leg is one
// accumulator sum sigma_cv dW1, odd in W1, so G = S0 exp(g_drift_dt steps
// +/- sum) serves both branches. Jumps use the compound identity: the
// total count is Binomial(steps, lambda dt), drawn once per path by
// inverting the host's float64 CDF table with one uniform, and one normal
// gives the summed Merton size N(n mu_J, n sigma_J^2), negated on the
// antithetic branch.
//
// Two departures from the TPU kernel, both towards the scan twin
// (mcos_tpu/ops/simulate.py:simulate_terminal), whose law is exact:
//   - the count table is exact: float64, as long as the upper tail needs
//     (mass < 2^-24, at least 64 entries); the TPU table stops at 64 and
//     normalises by its last entry, which conditions on count < 64 and
//     turns into NaN (zero jumps) once (1 - p)^n underflows;
//   - the variance carry starts from max(v0, 0); the TPU kernel starts from
//     v0 and takes sqrt(v) unclamped, so a negative v0 gives NaN paths.
//
// What bounds it on an H100: instruction issue. Nothing is read but the
// count table and 12 B per pair are written; each pair-step needs half a
// Philox4x32-10 call, a log, a square root, a sin/cos pair and two
// branches of Euler update, at least 53 operation slots (chip_smoke.py's
// count). One thread carries an antithetic pair, so both branches share
// every draw; one Philox call gives two Box-Muller pairs, which drive two
// steps; the carry stays in registers. The step is K9's
// (csrc/svj_td.cu:td_step) without its table: every operation on the
// carries is an uncontracted IEEE operation in the order of
// cuda_kernels.py:svj_terminal_plain (philox.cuh: fmul, fadd), so kernel
// and plain version agree bit for bit on S, v and G at any step count.
// The draws take the forms that give the same bits in fewer instructions
// (PERF.md §6; kernel_lab --levers takes each out alone): one sincosf per
// Box-Muller pair (mcos::box_muller_sincos), the uniforms by a bitcast
// (mcos::bits_to_uniform_bitcast) and the ten Philox round keys from the
// constant bank.
//
// Stream: counter (pair_lo, pair_hi, call, kSvjDomain), key = seed; call c
// drives steps 2c and 2c + 1 (an odd last step uses the first pair only);
// call ceil(steps / 2) gives the count uniform (word 0) and the size normal
// (words 1, 2). The stream depends on (pair, step, seed) only, not on the
// launch shape; cuda_kernels.py:svj_terminal_plain draws the same words.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using mcos::fadd;
using mcos::fmul;

constexpr int kThreads = 256;

// The Philox key the kernel takes: the ten round keys from the constant
// bank (uint2: the seed, and the key schedule in every thread).
using SvjKey = mcos::PhiloxKeys;

// Per-launch scalars, computed on the host in float32
// (cuda_kernels.py:_svj_prng_consts: _svj_consts plus the TPU kernel's
// three hoisted forms).
struct SvjPrngConsts {
  float spot, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
      sig_j, drift_dt, g_drift_dt, sig_cv, nhdt, omk, ktheta_dt;
};
static_assert(sizeof(SvjPrngConsts) == 18 * sizeof(float), "packed");

__device__ __forceinline__ uint4 svj_words(long long p, int call,
                                           const SvjKey& key) {
  return mcos::philox4x32_10(
      make_uint4(static_cast<uint32_t>(p),
                 static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32),
                 static_cast<uint32_t>(call), mcos::kSvjDomain),
      key);
}

// A word's uniform in (0, 1) (mcos::bits_to_uniform, bit for bit).
__device__ __forceinline__ float uniform(uint32_t w) {
  return mcos::bits_to_uniform_bitcast(w);
}

// Two normals from two words (mcos::box_muller on their uniforms, bit for
// bit).
__device__ __forceinline__ void normals(uint32_t w1, uint32_t w2, float& za,
                                        float& zb) {
  mcos::box_muller_sincos(uniform(w1), uniform(w2), za, zb);
}

// One pair's carry: log spot and variance per branch, the companion sum.
template <int NB>
struct Carry {
  float ls[NB], v[NB], cv_w;
};

// One Euler step for both branches (pallas_kernels.py:_svj_kernel
// one_step), in svj_terminal_plain's order of operations.
template <int NB>
__device__ __forceinline__ void euler_step(const SvjPrngConsts& c, float z1,
                                           float z2, Carry<NB>& st) {
  const float dw1 = fmul(z1, c.sqrt_dt);
  const float dw2 =
      fadd(fmul(c.rho, dw1), fmul(fmul(c.rho_perp, z2), c.sqrt_dt));
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dw2 = k == 0 ? dw2 : -dw2;
    const float sqrt_v = sqrtf(st.v[k]);
    st.ls[k] = fadd(fadd(st.ls[k], fadd(c.drift_dt, fmul(c.nhdt, st.v[k]))),
                    fmul(sqrt_v, s_dw1));
    st.v[k] = fmaxf(fadd(fadd(fmul(c.omk, st.v[k]), c.ktheta_dt),
                         fmul(c.xi, fmul(sqrt_v, s_dw2))),
                    0.0f);
  }
  st.cv_w = fadd(st.cv_w, fmul(c.sig_cv, dw1));
}

// One thread per antithetic pair.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    svj_kernel(float* __restrict__ s_out, float* __restrict__ v_out,
               float* __restrict__ g_out, const double* __restrict__ cdf,
               int cdf_len, long long n, int steps, SvjKey key,
               SvjPrngConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  Carry<NB> st;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    st.ls[k] = 0.0f;
    st.v[k] = fmaxf(c.v0, 0.0f);
  }
  st.cv_w = 0.0f;
  const int full_calls = steps >> 1;
  for (int call = 0; call < full_calls; ++call) {
    const uint4 b = svj_words(p, call, key);
    float za, zb;
    normals(b.x, b.y, za, zb);
    euler_step<NB>(c, za, zb, st);
    normals(b.z, b.w, za, zb);
    euler_step<NB>(c, za, zb, st);
  }
  if (steps & 1) {  // the odd last step takes the first pair of its call
    const uint4 b = svj_words(p, full_calls, key);
    float za, zb;
    normals(b.x, b.y, za, zb);
    euler_step<NB>(c, za, zb, st);
  }
  const uint4 e = svj_words(p, (steps + 1) >> 1, key);
  const float n_jump =
      static_cast<float>(mcos::count_from_table(cdf, cdf_len, uniform(e.x)));
  float z_total, unused;
  normals(e.y, e.z, z_total, unused);
  const float jump_mean = fmul(c.mu_j, n_jump);
  const float jump_body = fmul(fmul(c.sig_j, sqrtf(n_jump)), z_total);
  const float g_drift_total = fmul(c.g_drift_dt, static_cast<float>(steps));
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float sj = k == 0 ? jump_body : -jump_body;
    s_out[k * n + p] = fmul(c.spot, expf(fadd(fadd(st.ls[k], jump_mean), sj)));
    v_out[k * n + p] = st.v[k];
    if (g_out != nullptr) {
      g_out[k * n + p] =
          fmul(c.spot, expf(fadd(g_drift_total, k == 0 ? st.cv_w : -st.cv_w)));
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown branch count). Does not synchronise. cdf is a device
// array of cdf_len float64 jump-count CDF entries; g_out == nullptr skips
// the companion output. Outputs are (n_branch, n) row-major.
extern "C" int mcos_svj_terminal(float* s_out, float* v_out, float* g_out,
                                 const double* cdf, int cdf_len, long long n,
                                 int steps, int n_branch,
                                 unsigned long long seed,
                                 const float* consts_host, void* stream) {
  SvjPrngConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const SvjKey key = mcos::philox_key<SvjKey>(seed);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svj_kernel<2><<<blocks, kThreads, 0, st>>>(s_out, v_out, g_out, cdf,
                                               cdf_len, n, steps, key, c);
  } else if (n_branch == 1) {
    svj_kernel<1><<<blocks, kThreads, 0, st>>>(s_out, v_out, g_out, cdf,
                                               cdf_len, n, steps, key, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
