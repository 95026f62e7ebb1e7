// K9: SVJ terminal state under piecewise-constant theta(t), xi(t),
// lambda(t) from an in-kernel generator (POST /api/termsvj:
// TDSVJEngine.price_batch).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_svj_td_kernel and its wrapper
// svj_terminal_td_pallas. K3's recursion (csrc/svj.cu: drift_dt + (-dt/2) v
// for the spot, (1 - kappa dt) v + kappa theta dt for the variance, both
// branches of an antithetic pair in one thread, one companion accumulator)
// with theta_i, xi_i and drift_dt_i read per step from a (4, steps) table
// with rows (theta_i, xi_i, lambda_i dt, drift_dt_i). The compound-jump
// identity survives time dependence: jump sizes are iid N(mu_J, sigma_J^2)
// whatever the arrival time, so only the count's law picks up lambda_i. It
// is Poisson-binomial over the per-step p_i = lambda_i dt, drawn once per
// path by inverting the host's float64 CDF table
// (cuda_kernels.py:poisson_binom_count_table), and one normal gives the
// summed sizes.
//
// Two departures from the TPU kernel, both towards the scan twin
// (mcos_tpu/ops/tdsvj.py:simulate_terminal_td), as in K3:
//   - the count table is exact: float64, as long as the upper tail needs
//     (mass < 2^-24, at least 64 entries); the TPU's 64-entry float32 table
//     divides by its last entry, which conditions on count < 64 (sum of
//     lambda_i dt reaches 200 over HTTP);
//   - the variance carry starts from max(v0, 0); the TPU kernel starts from
//     v0 and takes sqrt(v) unclamped, so a negative v0 gives NaN paths.
//
// What bounds it on an H100: arithmetic, as K3. The table is at most
// 4 x 8192 floats (128 KB, more than constant memory holds): it stays in
// global memory and is read with __ldg. Every thread of a warp reads the
// same three addresses in a step, so the loads broadcast and hit L1. Per
// pair-step: half a Philox4x32-10 call, a Box-Muller pair, three loads, two
// branches of Euler update, at least 57 operation slots (chip_smoke.py's
// count).
//
// Stream: counter (pair_lo, pair_hi, call, kTdDomain), key = seed; call c
// drives steps 2c and 2c + 1 (an odd last step uses the first pair only);
// call ceil(steps / 2) gives the count uniform (word 0) and the size normal
// (words 1, 2): K3's layout in its own domain. cuda_kernels.py:
// svj_terminal_td_plain draws the same words and performs the same IEEE
// operations in the same order (philox.cuh: fmul, fadd, fsub), so the two
// agree bit for bit on the card.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using mcos::fadd;
using mcos::fmul;

// Per-launch scalars, computed on the host in float64 and cast once
// (cuda_kernels.py:_td_consts).
struct TdConsts {
  float spot, v0, sqrt_dt, rho, rho_perp, mu_j, sig_j, g_drift_dt, sig_cv,
      nhdt, omk, kappa_dt;
};
static_assert(sizeof(TdConsts) == 12 * sizeof(float), "packed");

// One Euler step for both branches at the step's (theta_i, xi_i,
// drift_dt_i) (pallas_kernels.py:_svj_td_kernel one_step).
template <int NB>
__device__ __forceinline__ void td_step(const TdConsts& c,
                                        const float* __restrict__ table,
                                        int steps, int idx, float z1, float z2,
                                        float (&ls)[NB], float (&v)[NB],
                                        float& cv_w) {
  const float theta_i = __ldg(table + idx);
  const float xi_i = __ldg(table + steps + idx);
  const float drift_i = __ldg(table + 3 * steps + idx);
  const float ktheta_dt = fmul(c.kappa_dt, theta_i);
  const float dw1 = fmul(z1, c.sqrt_dt);
  const float dw2 =
      fadd(fmul(c.rho, dw1), fmul(fmul(c.rho_perp, z2), c.sqrt_dt));
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dw2 = k == 0 ? dw2 : -dw2;
    const float sqrt_v = sqrtf(v[k]);
    ls[k] = fadd(fadd(ls[k], fadd(drift_i, fmul(c.nhdt, v[k]))),
                 fmul(sqrt_v, s_dw1));
    v[k] = fmaxf(fadd(fadd(fmul(c.omk, v[k]), ktheta_dt),
                      fmul(xi_i, fmul(sqrt_v, s_dw2))),
                 0.0f);
  }
  cv_w = fadd(cv_w, fmul(c.sig_cv, dw1));
}

template <int NB>
__global__ void __launch_bounds__(256)
    svj_td_kernel(float* __restrict__ s_out, float* __restrict__ v_out,
                  float* __restrict__ g_out, const float* __restrict__ table,
                  const double* __restrict__ cdf, int cdf_len, long long n,
                  int steps, uint2 key, TdConsts c) {
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
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(call), mcos::kTdDomain),
        key);
    float za, zb;
    mcos::box_muller(mcos::bits_to_uniform(b.x), mcos::bits_to_uniform(b.y),
                     za, zb);
    td_step<NB>(c, table, steps, 2 * call, za, zb, ls, v, cv_w);
    if (2 * call + 1 < steps) {
      mcos::box_muller(mcos::bits_to_uniform(b.z),
                       mcos::bits_to_uniform(b.w), za, zb);
      td_step<NB>(c, table, steps, 2 * call + 1, za, zb, ls, v, cv_w);
    }
  }
  const uint4 e = mcos::philox4x32_10(
      make_uint4(p_lo, p_hi, static_cast<uint32_t>(n_calls), mcos::kTdDomain),
      key);
  const float n_jump = static_cast<float>(
      mcos::count_from_table(cdf, cdf_len, mcos::bits_to_uniform(e.x)));
  float z_total, unused;
  mcos::box_muller(mcos::bits_to_uniform(e.y), mcos::bits_to_uniform(e.z),
                   z_total, unused);
  const float jump_mean = fmul(c.mu_j, n_jump);
  const float jump_body = fmul(fmul(c.sig_j, sqrtf(n_jump)), z_total);
  const float g_drift_total = fmul(c.g_drift_dt, static_cast<float>(steps));
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float sj = k == 0 ? jump_body : -jump_body;
    s_out[k * n + p] =
        fmul(c.spot, expf(fadd(fadd(ls[k], jump_mean), sj)));
    v_out[k * n + p] = v[k];
    if (g_out != nullptr) {
      g_out[k * n + p] =
          fmul(c.spot, expf(fadd(g_drift_total, k == 0 ? cv_w : -cv_w)));
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown branch count). Does not synchronise. `table` is a device
// array of (4, steps) float32 rows (theta_i, xi_i, lambda_i dt,
// drift_dt_i); cdf a device array of cdf_len float64 jump-count CDF
// entries; g_out == nullptr skips the companion output. Outputs are
// (n_branch, n) row-major float32.
extern "C" int mcos_svj_terminal_td(float* s_out, float* v_out, float* g_out,
                                    const float* table, const double* cdf,
                                    int cdf_len, long long n, int steps,
                                    int n_branch, unsigned long long seed,
                                    const float* consts_host, void* stream) {
  TdConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svj_td_kernel<2><<<blocks, threads, 0, st>>>(
        s_out, v_out, g_out, table, cdf, cdf_len, n, steps, key, c);
  } else if (n_branch == 1) {
    svj_td_kernel<1><<<blocks, threads, 0, st>>>(
        s_out, v_out, g_out, table, cdf, cdf_len, n, steps, key, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
