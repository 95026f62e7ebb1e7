// K3: SVJ terminal state under full-truncation Euler from an in-kernel
// generator (the PRNG serving path, use_sobol=false, and the batches of
// MonteCarloEngine.price_to_tolerance).
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
// What bounds it on an H100: arithmetic. Nothing is read but the count
// table and 12 B per pair are written; each pair-step needs a normal pair
// (half a Philox4x32-10 call, a log, a square root, a sin/cos pair) and
// two branches of Euler update, at least 53 instruction slots in all
// (chip_smoke.py's count). The design spreads that bill as
// thinly as it goes: one thread per antithetic pair, so both branches share
// every draw; one Philox call yields four uniforms, two Box-Muller pairs,
// which drive two steps (z1, z2 each); the carry stays in registers.
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

// Per-launch scalars, computed on the host in float32
// (cuda_kernels.py:_svj_prng_consts: _svj_consts plus the TPU kernel's
// three hoisted forms).
struct SvjPrngConsts {
  float spot, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
      sig_j, drift_dt, g_drift_dt, sig_cv, nhdt, omk, ktheta_dt;
};
static_assert(sizeof(SvjPrngConsts) == 18 * sizeof(float), "packed");

// One Euler step for both branches (pallas_kernels.py:_svj_kernel one_step).
template <int NB>
__device__ __forceinline__ void euler_step(const SvjPrngConsts& c, float z1,
                                           float z2, float (&ls)[NB],
                                           float (&v)[NB], float& cv_w) {
  const float dw1 = z1 * c.sqrt_dt;
  const float dw2 = c.rho * dw1 + c.rho_perp * z2 * c.sqrt_dt;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dw2 = k == 0 ? dw2 : -dw2;
    const float sqrt_v = sqrtf(v[k]);
    ls[k] = ls[k] + (c.drift_dt + c.nhdt * v[k]) + sqrt_v * s_dw1;
    v[k] = fmaxf(c.omk * v[k] + c.ktheta_dt + c.xi * (sqrt_v * s_dw2), 0.0f);
  }
  cv_w = cv_w + c.sig_cv * dw1;
}

template <int NB>
__global__ void __launch_bounds__(256)
    svj_kernel(float* __restrict__ s_out, float* __restrict__ v_out,
               float* __restrict__ g_out, const double* __restrict__ cdf,
               int cdf_len, long long n, int steps, uint2 key,
               SvjPrngConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);

  float ls[NB], v[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    ls[k] = 0.0f;
    v[k] = fmaxf(c.v0, 0.0f);
  }
  float cv_w = 0.0f;
  const int n_calls = (steps + 1) >> 1;
  for (int call = 0; call < n_calls; ++call) {
    const uint4 b = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(call), mcos::kSvjDomain),
        key);
    float za, zb;
    mcos::box_muller(mcos::bits_to_uniform(b.x), mcos::bits_to_uniform(b.y),
                     za, zb);
    euler_step<NB>(c, za, zb, ls, v, cv_w);
    if (2 * call + 1 < steps) {
      mcos::box_muller(mcos::bits_to_uniform(b.z),
                       mcos::bits_to_uniform(b.w), za, zb);
      euler_step<NB>(c, za, zb, ls, v, cv_w);
    }
  }
  const uint4 e = mcos::philox4x32_10(
      make_uint4(p_lo, p_hi, static_cast<uint32_t>(n_calls),
                 mcos::kSvjDomain),
      key);
  const float n_jump = static_cast<float>(
      mcos::count_from_table(cdf, cdf_len, mcos::bits_to_uniform(e.x)));
  float z_total, unused;
  mcos::box_muller(mcos::bits_to_uniform(e.y), mcos::bits_to_uniform(e.z),
                   z_total, unused);
  const float jump_mean = c.mu_j * n_jump;
  const float jump_body = c.sig_j * sqrtf(n_jump) * z_total;
  const float g_drift_total = c.g_drift_dt * static_cast<float>(steps);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float sj = k == 0 ? jump_body : -jump_body;
    s_out[k * n + p] = c.spot * expf(ls[k] + jump_mean + sj);
    v_out[k * n + p] = v[k];
    if (g_out != nullptr) {
      g_out[k * n + p] =
          c.spot * expf(g_drift_total + (k == 0 ? cv_w : -cv_w));
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError(). Does not synchronise.
// cdf is a device array of cdf_len float64 jump-count CDF entries;
// g_out == nullptr skips the companion output. Outputs are (n_branch, n)
// row-major.
extern "C" int mcos_svj_terminal(float* s_out, float* v_out, float* g_out,
                                 const double* cdf, int cdf_len, long long n,
                                 int steps, int n_branch,
                                 unsigned long long seed,
                                 const float* consts_host, void* stream) {
  SvjPrngConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svj_kernel<2><<<blocks, threads, 0, st>>>(s_out, v_out, g_out, cdf,
                                              cdf_len, n, steps, key, c);
  } else {
    svj_kernel<1><<<blocks, threads, 0, st>>>(s_out, v_out, g_out, cdf,
                                              cdf_len, n, steps, key, c);
  }
  return static_cast<int>(cudaGetLastError());
}
