// K5: SVJ terminal state under the Andersen QE scheme from streamed draws
// (the Sobol serving path with scheme="qe", and each QE RQMC replicate).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_svj_qe_draws_kernel and its
// wrapper svj_terminal_qe_from_draws_pallas. Per step: the QE variance
// transition from the uniform u_v (quadratic branch through Acklam's
// inverse normal of the same u_v, exponential branch on u_v itself), the
// central K0..K4 log-spot update with Merton jumps 1{u_jump < lambda dt},
// mu_J + sigma_J z_js, and the GBM companion leg on z_x. The antithetic
// branch negates z_x and z_js and shares u_v and u_jump.
//
// What bounds it on an H100: instruction issue, not the read. Each
// path-step reads three float32 words (z_x, u_v, z_js: 12 B; 16 B when
// u_jump is streamed), coalesced: the draws are steps-major (steps, paths)
// and one thread owns one path, so a warp reads 32 neighbouring words of a
// step row. Those loads alone take 0.13 ms at 500 000 paths x 63 steps,
// and the two-region design before this one took 0.60 ms: the same as its
// step with the draws made from the index and nothing read (kernel_lab's
// K5 floors, PERF.md §6). Its step issued about 466 instructions, among
// them Acklam's double Horner steps (36 conversions to and from double,
// which run on the SM's slow conversion pipe, and 19 DFMA), and both QE
// branches with nine divides. This design keeps the variance path's bits
// and issues less
// (0.60 -> 0.28 ms; each lever taken out alone costs, PERF.md §6):
//   - acklam_converged: Acklam's two regions as one Horner sequence, each
//     coefficient selected by region, so no warp runs both (on double
//     steps, two regions cost 18 % more than one); each step a float FMA,
//     which kernel_lab's probe finds equal to the plain version's double
//     step (one rounding in double, one to float) at every float32 in
//     (0, 1) (double steps: +49 %);
//   - qe_step_lazy: each QE branch only under its own test, with the same
//     operations in the same order as the plain ops/simulate.py:
//     qe_variance_step (both branches, kernel_lab's eager copy: +31 %;
//     K4 has a transition of its own, svj_qe.cu:qe_step);
//   - the jump uniform by a bitcast (mcos::bits_to_uniform_bitcast) and
//     the Philox round keys (1 % each, or less).
// The carry (v, log S and log G for both branches) lives in registers for
// the whole step loop, in place of the TPU grid's step chunks, VMEM
// scratch and step-padding mask. Because u_v is shared and v does not
// depend on z_x, the two branches' variance paths are the same path: the
// transition runs once per path and v is written to both output rows.
//
// In-kernel jump uniforms (u_jump == nullptr, the serving default): K1's
// stream, one Philox4x32-10 call per path and four steps, counter
// (path_lo, path_hi, step / 4, kJumpDomain), key = seed, word step % 4;
// cuda_kernels.py:philox_jump_uniforms is the same stream in torch.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

// The Philox key of the jump stream (one call serves four steps): the ten
// round keys from the constant bank. With uint2 (the seed, and the key
// schedule in every thread) K5 runs 1 % slower (kernel_lab --levers).
using QeKey = mcos::PhiloxKeys;

// One Horner step of the converged sequence: acc * x + c with the central
// region's coefficient a or the tail's t, rounded once in float. The plain
// version (ops/sobol.py:_fma) rounds acc * x + c in double and then to
// float; at every float32 u in (0, 1) both give Acklam's inverse the same
// bits (kernel_lab --probes, and tests/test_torch_cuda.py).
__device__ __forceinline__ float horner(float acc, float x, bool central,
                                        float a, float t) {
  return fmaf(acc, x, central ? a : t);
}

// Acklam's inverse normal CDF for u strictly inside (0, 1), bit for bit
// mcos::acklam_ndtri (pallas_kernels.py:_ndtri_kernel). Both regions run
// the same steps on x = r (central) or qt (tail): six numerator
// coefficients, and six denominator ones, the tail's led by a 0
// (horner(0, qt, d0) is d0 exactly). The numerator is scaled by qc in the
// central region and by -1 or 1 in the tail before the one divide: a
// product with 1 is exact and a negated quotient is the quotient of the
// negation. Every lane computes the tail's log and square root.
__device__ __forceinline__ float acklam_converged(float u) {
  const float qc = u - 0.5f;
  const bool central = fabsf(qc) <= 0.47575f;  // float32(0.5 - 0.02425)
  const float pm = fminf(u, 1.0f - u);
  const float qt = sqrtf(-2.0f * logf(pm));
  const float x = central ? __fmul_rn(qc, qc) : qt;
  float num = central ? -3.969683028665376e+01f : -7.784894002430293e-03f;
  num = horner(num, x, central, 2.209460984245205e+02f,
               -3.223964580411365e-01f);
  num = horner(num, x, central, -2.759285104469687e+02f,
               -2.400758277161838e+00f);
  num = horner(num, x, central, 1.383577518672690e+02f,
               -2.549732539343734e+00f);
  num = horner(num, x, central, -3.066479806614716e+01f,
               4.374664141464968e+00f);
  num = horner(num, x, central, 2.506628277459239e+00f,
               2.938163982698783e+00f);
  float den = central ? -5.447609879822406e+01f : 0.0f;
  den = horner(den, x, central, 1.615858368580409e+02f,
               7.784695709041462e-03f);
  den = horner(den, x, central, -1.556989798598866e+02f,
               3.224671290700398e-01f);
  den = horner(den, x, central, 6.680131188771972e+01f,
               2.445134137142996e+00f);
  den = horner(den, x, central, -1.328068155288572e+01f,
               3.754408661907416e+00f);
  den = horner(den, x, central, 1.0f, 1.0f);
  const float scale = central ? qc : (qc < 0.0f ? 1.0f : -1.0f);
  return __fmul_rn(num, scale) / den;
}

// Andersen QE v -> v' (ops/simulate.py:qe_variance_step with z_v =
// ndtri(u_v)) with each branch computed only under its own test: the
// quadratic branch (and Acklam's inverse that feeds it) for psi <= 1.5, the
// exponential branch (its mass p, beta, log and divides) otherwise. Each
// operation is the plain version's, in its order, so the taken branch
// gives the same bits.
__device__ __forceinline__ float qe_step_lazy(float v, float u_v,
                                              const mcos::QeConsts& c) {
  const float m = __fadd_rn(c.theta, __fmul_rn(v - c.theta, c.e_kdt));
  const float s2 = __fadd_rn(__fmul_rn(v, c.var1), c.var2);
  const float psi = s2 / fmaxf(__fmul_rn(m, m), 1e-20f);
  if (psi <= 1.5f) {
    const float two_over_psi = 2.0f / fmaxf(psi, 1e-12f);
    const float b2 = fmaxf(
        __fadd_rn(two_over_psi - 1.0f,
                  __fmul_rn(sqrtf(fmaxf(two_over_psi, 1e-12f)),
                            sqrtf(fmaxf(two_over_psi - 1.0f, 0.0f)))),
        0.0f);
    const float a = m / (1.0f + b2);
    const float x = sqrtf(b2) + acklam_converged(u_v);
    return __fmul_rn(a, __fmul_rn(x, x));
  }
  const float p_mass = fminf(fmaxf((psi - 1.0f) / (psi + 1.0f), 0.0f), 0.999f);
  if (u_v <= p_mass) return 0.0f;
  const float beta = (1.0f - p_mass) / fmaxf(m, 1e-20f);
  const float u_clip = fminf(fmaxf(u_v, 1e-7f), mcos::kUMax);
  return logf((1.0f - p_mass) / fmaxf(1.0f - u_clip, 1e-12f)) /
         fmaxf(beta, 1e-20f);
}

// The streamed draws of step row `off`: z_x, u_v and z_js.
struct LoadedDraws {
  const float* __restrict__ zx;
  const float* __restrict__ uv;
  const float* __restrict__ zjs;
  __device__ __forceinline__ void operator()(size_t off, uint32_t, int,
                                             float& z_x, float& u_v,
                                             float& z_j) const {
    z_x = __ldg(zx + off);
    u_v = __ldg(uv + off);
    z_j = __ldg(zjs + off);
  }
};

// kOwnJumps: the jump uniforms from the Philox stream (uj unused), else
// loaded from uj. `draws(off, path, step, z_x, u_v, z_j)` gives a step's
// draws (LoadedDraws on the route).
template <int NB, bool kOwnJumps, class Draws>
__global__ void __launch_bounds__(256)
    svj_qe_draws_kernel(Draws draws, const float* __restrict__ uj,
                        float* __restrict__ s_out, float* __restrict__ v_out,
                        float* __restrict__ g_out, long long n, int steps,
                        QeKey key, mcos::QeConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);

  float v = c.v0;
  float ls[NB], lg[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) ls[k] = lg[k] = 0.0f;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  size_t off = static_cast<size_t>(p);
  const size_t stride = static_cast<size_t>(n);
  for (int t = 0; t < steps; ++t, off += stride) {
    float z_x, u_v, z_j;
    draws(off, p_lo, t, z_x, u_v, z_j);
    float u;
    if constexpr (kOwnJumps) {
      if ((t & 3) == 0) {
        bits = mcos::philox4x32_10(
            make_uint4(p_lo, p_hi, static_cast<uint32_t>(t >> 2),
                       mcos::kJumpDomain),
            key);
      }
      u = mcos::bits_to_uniform_bitcast(mcos::word_of(bits, t & 3));
    } else {
      u = __ldg(uj + off);
    }
    const float v_next = qe_step_lazy(v, u_v, c);
    const float vol = sqrtf(fmaxf(c.k34 * (v + v_next), 0.0f));
    const float base = c.drift_dt + c.k0 + c.k1 * v + c.k2 * v_next;
    const bool jumped = u < c.lam_dt;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float sz_x = k == 0 ? z_x : -z_x;
      const float sz_j = k == 0 ? z_j : -z_j;
      const float jump = jumped ? c.mu_j + c.sig_j * sz_j : 0.0f;
      ls[k] = ls[k] + base + vol * sz_x + jump;
      lg[k] = lg[k] + c.g_drift_dt + c.sig_cv * sz_x * c.sqrt_dt;
    }
    v = v_next;
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    s_out[k * n + p] = c.spot * expf(ls[k]);
    v_out[k * n + p] = v;
    if (g_out != nullptr) g_out[k * n + p] = c.spot * expf(lg[k]);
  }
}

// Launches K5 with NB branches on `draws`; uj == nullptr draws the jump
// uniforms in-kernel. Returns cudaGetLastError().
template <int NB, class Draws>
int launch_qe_draws(Draws draws, const float* uj, float* s_out, float* v_out,
                    float* g_out, long long n, int steps,
                    unsigned long long seed, const mcos::QeConsts& c,
                    cudaStream_t st) {
  const QeKey key = mcos::philox_key<QeKey>(seed);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  if (uj == nullptr) {
    svj_qe_draws_kernel<NB, true, Draws><<<blocks, threads, 0, st>>>(
        draws, uj, s_out, v_out, g_out, n, steps, key, c);
  } else {
    svj_qe_draws_kernel<NB, false, Draws><<<blocks, threads, 0, st>>>(
        draws, uj, s_out, v_out, g_out, n, steps, key, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError(). Does not synchronise.
// Draws are (steps, n) row-major; uj == nullptr draws the jump uniforms
// in-kernel; g_out == nullptr skips the companion output. Outputs are
// (n_branch, n) row-major.
extern "C" int mcos_svj_terminal_qe_from_draws(
    const float* zx, const float* uv, const float* zjs, const float* uj,
    float* s_out, float* v_out, float* g_out, long long n, int steps,
    int n_branch, unsigned long long seed, const float* consts_host,
    void* stream) {
  mcos::QeConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const LoadedDraws draws{zx, uv, zjs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    return launch_qe_draws<2>(draws, uj, s_out, v_out, g_out, n, steps, seed,
                              c, st);
  }
  return launch_qe_draws<1>(draws, uj, s_out, v_out, g_out, n, steps, seed, c,
                            st);
}
