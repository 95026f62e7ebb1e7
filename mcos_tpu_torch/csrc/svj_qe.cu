// K4: SVJ terminal state under the Andersen QE scheme from an in-kernel
// generator (the PRNG serving path with scheme="qe").
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_svj_qe_kernel and its wrapper
// svj_terminal_qe_pallas. Per step, one Philox4x32-10 call gives three
// uniforms (the fourth word is unused): (u0, u1) -> Box-Muller ->
// (z_x, z_v), and u2 feeds the exponential branch. The variance transition
// is K5's (philox.cuh:qe_variance_step) with z_v in place of ndtri(u): under
// a PRNG the branch is fixed by v, so an independent normal for the
// quadratic branch samples the same transition law (the TPU kernel's
// argument). The log-spot update is the central K0..K4 scheme; the
// antithetic branch negates z_x and shares the variance path, so the
// transition runs once per pair and v is written to both output rows.
// Jumps use the compound identity, as the TPU kernel does: the total count
// over the path is Binomial(steps, lambda dt), drawn once per path by
// inverting the host's float64 CDF table with one uniform, and one normal
// gives the summed Merton size N(n mu_J, n sigma_J^2) (negated on the
// antithetic branch).
//
// What bounds it on an H100: arithmetic, and within it the transition's
// chain of four divides, three square roots and a log per pair-step, plus
// a Philox call, a log, a square root and a sin/cos pair for the draws.
// Nothing is read but the count table, and 12 B per pair are written. The
// design computes the transition once per antithetic pair (one thread per
// pair) and keeps the carry in registers for the whole path. The TPU
// kernel's division-folded algebra (two fewer divides) is left to a later
// speed change: this source keeps K5's arithmetic so the two QE kernels
// share one helper.
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

template <int NB>
__global__ void __launch_bounds__(256)
    svj_qe_kernel(float* __restrict__ s_out, float* __restrict__ v_out,
                  float* __restrict__ g_out, const double* __restrict__ cdf,
                  int cdf_len, long long n, int steps, uint2 key,
                  mcos::QeConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);

  float v = c.v0;
  float ls[NB], lg[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) ls[k] = lg[k] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const uint4 b = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(t), mcos::kQeDomain),
        key);
    float z_x, z_v;
    mcos::box_muller(mcos::bits_to_uniform(b.x), mcos::bits_to_uniform(b.y),
                     z_x, z_v);
    const float v_next =
        mcos::qe_variance_step(v, z_v, mcos::bits_to_uniform(b.z), c);
    const float vol = sqrtf(fmaxf(c.k34 * (v + v_next), 0.0f));
    const float base = c.drift_dt + c.k0 + c.k1 * v + c.k2 * v_next;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float sz_x = k == 0 ? z_x : -z_x;
      ls[k] = ls[k] + base + vol * sz_x;
      lg[k] = lg[k] + c.g_drift_dt + c.sig_cv * sz_x * c.sqrt_dt;
    }
    v = v_next;
  }
  const uint4 e = mcos::philox4x32_10(
      make_uint4(p_lo, p_hi, static_cast<uint32_t>(steps), mcos::kQeDomain),
      key);
  const float n_jump = static_cast<float>(
      mcos::count_from_table(cdf, cdf_len, mcos::bits_to_uniform(e.x)));
  float z_total, unused;
  mcos::box_muller(mcos::bits_to_uniform(e.y), mcos::bits_to_uniform(e.z),
                   z_total, unused);
  const float jump_mean = c.mu_j * n_jump;
  const float jump_body = c.sig_j * sqrtf(n_jump) * z_total;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float sj = k == 0 ? jump_body : -jump_body;
    s_out[k * n + p] = c.spot * expf(ls[k] + jump_mean + sj);
    v_out[k * n + p] = v;
    if (g_out != nullptr) g_out[k * n + p] = c.spot * expf(lg[k]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError(). Does not synchronise.
// cdf is a device array of cdf_len float64 jump-count CDF entries;
// g_out == nullptr skips the companion output. Outputs are (n_branch, n)
// row-major.
extern "C" int mcos_svj_terminal_qe(float* s_out, float* v_out, float* g_out,
                                    const double* cdf, int cdf_len,
                                    long long n, int steps, int n_branch,
                                    unsigned long long seed,
                                    const float* consts_host, void* stream) {
  mcos::QeConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svj_qe_kernel<2><<<blocks, threads, 0, st>>>(s_out, v_out, g_out, cdf,
                                                 cdf_len, n, steps, key, c);
  } else {
    svj_qe_kernel<1><<<blocks, threads, 0, st>>>(s_out, v_out, g_out, cdf,
                                                 cdf_len, n, steps, key, c);
  }
  return static_cast<int>(cudaGetLastError());
}
