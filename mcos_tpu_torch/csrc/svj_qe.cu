// K4: SVJ terminal state under the Andersen QE scheme from an in-kernel
// generator (the PRNG serving path with scheme="qe").
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_svj_qe_kernel and its wrapper
// svj_terminal_qe_pallas. Per step, one Philox4x32-10 call gives three
// uniforms (the fourth word is unused): (u0, u1) -> Box-Muller ->
// (z_x, z_v), and u2 feeds the exponential branch. The variance transition
// is Andersen's QE in the TPU kernel's division-folded algebra
// (pallas_kernels.py:_svj_qe_kernel; qe_step below) with z_v in place of
// ndtri(u): under a PRNG the branch is fixed by v, so an independent normal
// for the quadratic branch samples the same transition law (the TPU
// kernel's argument). The log-spot update is the central K0..K4 scheme; the
// antithetic branch negates z_x and shares the variance path, so the
// transition runs once per pair and v is written to both output rows.
// Jumps use the compound identity, as the TPU kernel does: the total count
// over the path is Binomial(steps, lambda dt), drawn once per path by
// inverting the host's float64 CDF table with one uniform, and one normal
// gives the summed Merton size N(n mu_J, n sigma_J^2) (negated on the
// antithetic branch).
//
// What bounds it on an H100: instruction issue. Nothing is read but the
// count table, and 12 B per pair are written. Each pair-step needs a
// Philox call, a log, a square root and a sin/cos pair for the draws and
// the quadratic branch's divides and square roots (at least 82 operation
// slots, chip_smoke.py's count). One thread carries an antithetic pair,
// so the transition runs once per pair, and the carry stays in registers
// for the whole path. The design issues less for the same law (PERF.md
// §6; kernel_lab --levers takes each lever out alone):
//   - each QE branch only under its own test: the route's parameters never
//     take the exponential branch (psi <= xi^2 / (2 kappa theta) = 1.04),
//     whose mass, log and divides an eager transition computes every step;
//   - the quadratic branch on 2 / psi = 2 m^2 / s^2 with one square root
//     of t (t - 1): two divides and two square roots, where psi, 2 / psi,
//     sqrt(2 / psi) and sqrt(2 / psi - 1) take three and three;
//   - one sincosf per Box-Muller pair, the uniforms by a bitcast and the
//     ten Philox round keys from the constant bank.
// Every operation is an uncontracted IEEE operation in the order of
// cuda_kernels.py:svj_terminal_qe_plain (its transition _qe_step_folded,
// its log spot _qe_log_spot; philox.cuh: fmul, fadd), so kernel and plain
// version agree bit for bit on S, v and G. The folded transition is K4's
// own: K5 and the scan twins keep ops/simulate.py:qe_variance_step, which
// has the same law and other roundings.
//
// Stream: counter (pair_lo, pair_hi, step, kQeDomain), key = seed; the
// end-of-path call has step index = steps and gives the count uniform
// (word 0) and the size normal (words 1, 2). The stream depends on
// (pair, step, seed) only, not on the launch shape.
// cuda_kernels.py:svj_terminal_qe_plain draws the same words.
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
using QeKey = mcos::PhiloxKeys;

__device__ __forceinline__ uint4 qe_words(long long p, int step,
                                          const QeKey& key) {
  return mcos::philox4x32_10(
      make_uint4(static_cast<uint32_t>(p),
                 static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32),
                 static_cast<uint32_t>(step), mcos::kQeDomain),
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

// The quadratic branch a (sqrt(b^2) + z_v)^2 on t = 2 / psi = 2 m^2 / s^2,
// clipped to [1, 2e12] (2 / psi <= 2e12 where psi is floored at 1e-12):
// b^2 = t - 1 + sqrt(t (t - 1)), a = m / (1 + b^2).
__device__ __forceinline__ float qe_quadratic(float m, float s2, float m2,
                                              float z_v) {
  const float t =
      fminf(fmaxf(__fmul_rn(2.0f, m2) / fmaxf(s2, 1e-30f), 1.0f), 2e12f);
  const float b2 = __fadd_rn(t - 1.0f, sqrtf(__fmul_rn(t, t - 1.0f)));
  const float a = m / (1.0f + b2);
  const float x = sqrtf(b2) + z_v;
  return __fmul_rn(a, __fmul_rn(x, x));
}

// The exponential branch: mass p = (psi - 1) / (psi + 1) = (s^2 - m^2) /
// (s^2 + m^2) at 0 (clipped to [0, 0.999]), else the exponential tail
// m log((1 - p) / (1 - u_v)) / (1 - p), the uniform clipped below 1.
__device__ __forceinline__ float qe_exponential(float m, float s2, float m2,
                                                float u_v) {
  const float p_mass =
      fminf(fmaxf((s2 - m2) / fmaxf(s2 + m2, 1e-30f), 0.0f), 0.999f);
  if (u_v <= p_mass) return 0.0f;
  const float one_m_p = 1.0f - p_mass;
  const float u_clip = fminf(u_v, mcos::kUMax);
  return __fmul_rn(m, logf(one_m_p / (1.0f - u_clip))) / one_m_p;
}

// Andersen QE variance transition v -> v', each branch only under its own
// test: quadratic for psi = s^2 / m^2 <= 1.5, tested as s^2 <= 1.5 m^2.
__device__ __forceinline__ float qe_step(float v, float z_v, float u_v,
                                         const mcos::QeConsts& c) {
  const float m = __fadd_rn(c.theta, __fmul_rn(v - c.theta, c.e_kdt));
  const float s2 = __fadd_rn(__fmul_rn(v, c.var1), c.var2);
  const float m2 = __fmul_rn(m, m);
  const bool quadratic = s2 <= __fmul_rn(1.5f, m2);
  if (quadratic) return qe_quadratic(m, s2, m2, z_v);
  return qe_exponential(m, s2, m2, u_v);
}

// One thread per antithetic pair.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    svj_qe_kernel(float* __restrict__ s_out, float* __restrict__ v_out,
                  float* __restrict__ g_out, const double* __restrict__ cdf,
                  int cdf_len, long long n, int steps, QeKey key,
                  mcos::QeConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float drift_k0 = fadd(c.drift_dt, c.k0);
  float v = c.v0;
  float ls[NB], lg[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) ls[k] = lg[k] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const uint4 b = qe_words(p, t, key);
    float z_x, z_v;
    normals(b.x, b.y, z_x, z_v);
    const float v_next = qe_step(v, z_v, uniform(b.z), c);
    const float vol = sqrtf(fmaxf(fmul(c.k34, fadd(v, v_next)), 0.0f));
    const float base = fadd(fadd(drift_k0, fmul(c.k1, v)), fmul(c.k2, v_next));
    // vol (-z_x) and (sig_cv (-z_x)) sqrt_dt are the negated products
    // exactly: the antithetic branch shares them.
    const float dx = fmul(vol, z_x);
    const float dg = fmul(fmul(c.sig_cv, z_x), c.sqrt_dt);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      ls[k] = fadd(fadd(ls[k], base), k == 0 ? dx : -dx);
      lg[k] = fadd(fadd(lg[k], c.g_drift_dt), k == 0 ? dg : -dg);
    }
    v = v_next;
  }
  const uint4 e = qe_words(p, steps, key);
  const float n_jump =
      static_cast<float>(mcos::count_from_table(cdf, cdf_len, uniform(e.x)));
  float z_total, unused;
  normals(e.y, e.z, z_total, unused);
  const float jump_mean = fmul(c.mu_j, n_jump);
  const float jump_body = fmul(fmul(c.sig_j, sqrtf(n_jump)), z_total);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float sj = k == 0 ? jump_body : -jump_body;
    s_out[k * n + p] = fmul(c.spot, expf(fadd(fadd(ls[k], jump_mean), sj)));
    v_out[k * n + p] = v;
    if (g_out != nullptr) g_out[k * n + p] = fmul(c.spot, expf(lg[k]));
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown branch count). Does not synchronise. cdf is a device
// array of cdf_len float64 jump-count CDF entries; g_out == nullptr skips
// the companion output. Outputs are (n_branch, n) row-major.
extern "C" int mcos_svj_terminal_qe(float* s_out, float* v_out, float* g_out,
                                    const double* cdf, int cdf_len,
                                    long long n, int steps, int n_branch,
                                    unsigned long long seed,
                                    const float* consts_host, void* stream) {
  mcos::QeConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const QeKey key = mcos::philox_key<QeKey>(seed);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svj_qe_kernel<2><<<blocks, kThreads, 0, st>>>(s_out, v_out, g_out, cdf,
                                                  cdf_len, n, steps, key, c);
  } else if (n_branch == 1) {
    svj_qe_kernel<1><<<blocks, kThreads, 0, st>>>(s_out, v_out, g_out, cdf,
                                                  cdf_len, n, steps, key, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
