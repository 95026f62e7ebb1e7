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
// What bounds it on an H100: instruction issue. Bit-equality with the plain
// version fixes every carry operation (uncontracted, in its order) and the
// accurate logf, sqrtf, sinf and cosf, so the step loop is mostly library
// sequences: 167 instructions a pair-step by cuobjdump -sass without the
// never-taken slow paths (python -m mcos_tpu_torch.kernel_lab --sass),
// against the 57 operation slots chip_smoke.py counts. Within that:
//   - sincosf shares one range reduction between the sine and the cosine
//     and gives their bits (held over every uniform of the grid by
//     tests/test_torch_cuda.py); the uniforms need no I2F
//     (philox.cuh:bits_to_uniform_bitcast); the Philox round keys come
//     from the constant bank;
//   - the table is at most 4 x 8192 floats (128 KB, more than constant
//     memory holds): it stays in global memory behind __ldg, every thread
//     of a warp reads the same three addresses in a step, so the loads
//     broadcast and hit L1; loading them a call ahead cost 7 registers and
//     time, so they are loaded where they are used;
//   - one thread per pair at most 40 registers: the route's 200 000 pairs
//     fit one wave (below). The wrapper keeps the table on the device
//     (cuda_kernels.py:_device_step_table), so a warm call copies nothing
//     before the launch.
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

using mcos::box_muller_sincos;
using mcos::fadd;
using mcos::fmul;

constexpr int kThreads = 256;

// Per-launch scalars, computed on the host in float64 and cast once
// (cuda_kernels.py:_td_consts).
struct TdConsts {
  float spot, v0, sqrt_dt, rho, rho_perp, mu_j, sig_j, g_drift_dt, sig_cv,
      nhdt, omk, kappa_dt;
};
static_assert(sizeof(TdConsts) == 12 * sizeof(float), "packed");

// One step's row of the (4, steps) table: theta_i, xi_i, drift_dt_i.
struct StepLevels {
  float theta, xi, drift;
};

__device__ __forceinline__ StepLevels load_levels(
    const float* __restrict__ table, int steps, int idx) {
  return {__ldg(table + idx), __ldg(table + steps + idx),
          __ldg(table + 3 * steps + idx)};
}

// One pair's carry: log spot and variance per branch, the companion sum.
template <int NB>
struct Carry {
  float ls[NB], v[NB], cv_w;
};

// One Euler step for both branches at the step's (theta_i, xi_i,
// drift_dt_i) (pallas_kernels.py:_svj_td_kernel one_step).
template <int NB>
__device__ __forceinline__ void td_step(const TdConsts& c, StepLevels lv,
                                        float z1, float z2, Carry<NB>& st) {
  const float ktheta_dt = fmul(c.kappa_dt, lv.theta);
  const float dw1 = fmul(z1, c.sqrt_dt);
  const float dw2 =
      fadd(fmul(c.rho, dw1), fmul(fmul(c.rho_perp, z2), c.sqrt_dt));
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dw2 = k == 0 ? dw2 : -dw2;
    const float sqrt_v = sqrtf(st.v[k]);
    st.ls[k] = fadd(fadd(st.ls[k], fadd(lv.drift, fmul(c.nhdt, st.v[k]))),
                    fmul(sqrt_v, s_dw1));
    st.v[k] = fmaxf(fadd(fadd(fmul(c.omk, st.v[k]), ktheta_dt),
                         fmul(lv.xi, fmul(sqrt_v, s_dw2))),
                    0.0f);
  }
  st.cv_w = fadd(st.cv_w, fmul(c.sig_cv, dw1));
}

__device__ __forceinline__ uint4 td_words(long long p, int call,
                                         const mcos::PhiloxKeys& keys) {
  return mcos::philox4x32_10(
      make_uint4(static_cast<uint32_t>(p),
                 static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32),
                 static_cast<uint32_t>(call), mcos::kTdDomain),
      keys);
}

// One thread per antithetic pair. At most 40 registers (6 blocks of 256
// an SM), so the route's 200 000 pairs (782 blocks) run in one wave on 132
// SMs (792 block slots) instead of a ragged second one.
template <int NB>
__global__ void __launch_bounds__(kThreads, 6)
    svj_td_kernel(float* __restrict__ s_out, float* __restrict__ v_out,
                  float* __restrict__ g_out, const float* __restrict__ table,
                  const double* __restrict__ cdf, int cdf_len, long long n,
                  int steps, mcos::PhiloxKeys keys, TdConsts c) {
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
    const uint4 b = td_words(p, call, keys);
    float za, zb;
    box_muller_sincos(mcos::bits_to_uniform_bitcast(b.x),
                      mcos::bits_to_uniform_bitcast(b.y), za, zb);
    td_step<NB>(c, load_levels(table, steps, 2 * call), za, zb, st);
    box_muller_sincos(mcos::bits_to_uniform_bitcast(b.z),
                      mcos::bits_to_uniform_bitcast(b.w), za, zb);
    td_step<NB>(c, load_levels(table, steps, 2 * call + 1), za, zb, st);
  }
  if (steps & 1) {  // the odd last step takes the first pair of its call
    const uint4 b = td_words(p, full_calls, keys);
    float za, zb;
    box_muller_sincos(mcos::bits_to_uniform_bitcast(b.x),
                      mcos::bits_to_uniform_bitcast(b.y), za, zb);
    td_step<NB>(c, load_levels(table, steps, steps - 1), za, zb, st);
  }
  const uint4 e = td_words(p, (steps + 1) >> 1, keys);
  const float n_jump = static_cast<float>(mcos::count_from_table(
      cdf, cdf_len, mcos::bits_to_uniform_bitcast(e.x)));
  float z_total, unused;
  box_muller_sincos(mcos::bits_to_uniform_bitcast(e.y),
                    mcos::bits_to_uniform_bitcast(e.z), z_total, unused);
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
  const mcos::PhiloxKeys keys = mcos::philox_round_keys(seed);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svj_td_kernel<2><<<blocks, kThreads, 0, st>>>(
        s_out, v_out, g_out, table, cdf, cdf_len, n, steps, keys, c);
  } else if (n_branch == 1) {
    svj_td_kernel<1><<<blocks, kThreads, 0, st>>>(
        s_out, v_out, g_out, table, cdf, cdf_len, n, steps, keys, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
