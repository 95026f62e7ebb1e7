// K8: SVCJ terminal state (correlated jumps in price and variance) from an
// in-kernel generator (POST /api/svcj: SVCJEngine.price and mc_vs_cos).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_svcj_kernel and its wrapper
// svcj_terminal_pallas. Full-truncation log-Euler as in K3, but the
// compound-jump identity does not apply: the variance jump Z_v feeds back
// into the diffusion through v, so jumps are applied per step. A step
// jumps when its uniform is below lambda dt; then the variance gains
// Z_v = -mu_v log(u_exp), an Exp(mu_v) draw shared by the antithetic pair,
// and the log spot gains mu_J + rho_J Z_v + sigma_J z_js, whose normal part
// flips with the branch. The companion control leg is one accumulator
// sum sigma_cv dW1, odd in W1, so G = S0 exp(g_drift_dt steps +/- sum)
// serves both branches. One thread carries both branches: normals, the dW2
// mix, the jump indicator and the jump magnitudes are computed once per
// pair.
//
// What bounds it on an H100: instruction issue. Nothing is read and 12 to
// 24 B per pair are written; each pair-step needs one Philox4x32-10 call,
// four uniforms, Box-Muller and two branches of Euler update, at least 79
// operation slots with no jump in the step pair (chip_smoke.py's count).
// Bit-equality with the plain version fixes every carry operation and the
// accurate library functions; within that the design takes:
//   - lazy jump draws: the jump-size normals' Box-Muller pair and the
//     exponential's uniforms come from a third Philox call that a thread
//     makes only for a step pair in which a jump lands (z_js is read only
//     on a jump step, so the bits do not move); at lambda dt = 0.4 % a
//     thread needs it on one step pair in 126, a warp of 32 on 22 %;
//   - Box-Muller through philox.cuh:box_muller_sincos and the uniforms
//     through bits_to_uniform_bitcast: neither moves a bit. The Philox
//     round keys from the constant bank (PhiloxKeys) gained nothing here
//     (ptxas then splits each product into IMAD.HI and IMAD), so the key
//     schedule runs in every thread;
//   - one thread per pair at most 40 registers: the route's 200 000 pairs
//     (782 blocks of 256) fit one wave on 132 SMs.
//
// Stream: counter (pair_lo, pair_hi, call, kSvcjDomain), key = seed. Steps
// 2i and 2i + 1 take calls 3i, 3i + 1 and 3i + 2: a0..a3 give the
// Box-Muller pairs (z1, z2) of step 2i and of step 2i + 1; b0, b1 the pair
// (z_js of step 2i, z_js of step 2i + 1); b2, b3 the two jump uniforms;
// c0, c1 the two exponential uniforms. An odd last step takes calls
// 3 (steps - 1) / 2 and the next: (z1, z2) from a0, a1, z_js from a2, a3,
// the jump uniform b0 and the exponential uniform b1. The stream depends on
// (pair, step, seed) only; cuda_kernels.py:svcj_terminal_plain draws the
// same words and performs the same IEEE operations in the same order
// (philox.cuh: fmul, fadd, fsub), so the two agree bit for bit on the card.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using mcos::box_muller_sincos;
using mcos::fadd;
using mcos::fmul;
using mcos::fsub;

// Per-launch scalars in the TPU kernel's order (_C_SPOT.._C_SIG_CV),
// computed on the host in float64 and cast once
// (cuda_kernels.py:_svcj_consts).
struct SvcjConsts {
  float spot, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
      sig_j, mu_v, rho_j, drift_dt, g_drift_dt, sig_cv;
};
static_assert(sizeof(SvcjConsts) == 17 * sizeof(float), "packed");

// One step for both branches. `u_exp` is read only when the step jumps.
template <int NB>
__device__ __forceinline__ void svcj_step(const SvcjConsts& c, float z1,
                                          float z2, float z_js, bool jumped,
                                          float u_exp, float (&ls)[NB],
                                          float (&v)[NB], float& cv_w) {
  const float dw1 = fmul(z1, c.sqrt_dt);
  const float dw2 =
      fadd(fmul(c.rho, dw1), fmul(fmul(c.rho_perp, z2), c.sqrt_dt));
  float jump_v = 0.0f, jump_base = 0.0f, jump_odd = 0.0f;
  if (jumped) {
    jump_v = fmul(c.mu_v, -logf(u_exp));  // Exp(mu_v), shared in the pair
    jump_base = fadd(c.mu_j, fmul(c.rho_j, jump_v));
    jump_odd = fmul(c.sig_j, z_js);  // flips with the branch
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dw2 = k == 0 ? dw2 : -dw2;
    const float s_odd = k == 0 ? jump_odd : -jump_odd;
    const float v_pos = fmaxf(v[k], 0.0f);
    const float sqrt_v = sqrtf(v_pos);
    float x = fadd(ls[k], fsub(c.drift_dt, fmul(fmul(0.5f, v_pos), c.dt)));
    x = fadd(x, fmul(sqrt_v, s_dw1));
    ls[k] = fadd(fadd(x, jump_base), s_odd);
    float w = fadd(v_pos, fmul(fmul(c.kappa, fsub(c.theta, v_pos)), c.dt));
    w = fadd(w, fmul(fmul(c.xi, sqrt_v), s_dw2));
    v[k] = fmaxf(fadd(w, jump_v), 0.0f);
  }
  cv_w = fadd(cv_w, fmul(c.sig_cv, dw1));
}

__device__ __forceinline__ float unit(uint32_t bits) {
  return mcos::bits_to_uniform_bitcast(bits);
}

template <int NB>
__global__ void __launch_bounds__(256)
    svcj_kernel(float* __restrict__ s_out, float* __restrict__ v_out,
                float* __restrict__ g_out, long long n, int steps, uint2 key,
                SvcjConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);
  auto words = [&](uint32_t call) {
    return mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, call, mcos::kSvcjDomain), key);
  };

  float ls[NB], v[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    ls[k] = 0.0f;
    v[k] = c.v0;
  }
  float cv_w = 0.0f;
  uint32_t call = 0;
  for (int i = 0; i + 1 < steps; i += 2, call += 3) {
    const uint4 a = words(call);
    const uint4 b = words(call + 1);
    float z1a, z2a, z1b, z2b;
    box_muller_sincos(unit(a.x), unit(a.y), z1a, z2a);
    box_muller_sincos(unit(a.z), unit(a.w), z1b, z2b);
    const bool jump_a = unit(b.z) < c.lam_dt;
    const bool jump_b = unit(b.w) < c.lam_dt;
    // read only on a jump step: made only for a step pair that jumps
    float zja = 0.0f, zjb = 0.0f, ue_a = 1.0f, ue_b = 1.0f;
    if (jump_a || jump_b) {
      const uint4 e = words(call + 2);
      ue_a = unit(e.x);
      ue_b = unit(e.y);
      box_muller_sincos(unit(b.x), unit(b.y), zja, zjb);
    }
    svcj_step<NB>(c, z1a, z2a, zja, jump_a, ue_a, ls, v, cv_w);
    svcj_step<NB>(c, z1b, z2b, zjb, jump_b, ue_b, ls, v, cv_w);
  }
  if (steps & 1) {
    const uint4 a = words(call);
    const uint4 b = words(call + 1);
    float z1, z2, z_js = 0.0f, unused;
    box_muller_sincos(unit(a.x), unit(a.y), z1, z2);
    const bool jumped = unit(b.x) < c.lam_dt;
    if (jumped) box_muller_sincos(unit(a.z), unit(a.w), z_js, unused);
    svcj_step<NB>(c, z1, z2, z_js, jumped, unit(b.y), ls, v, cv_w);
  }
  const float g_drift_total = fmul(c.g_drift_dt, static_cast<float>(steps));
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    s_out[k * n + p] = fmul(c.spot, expf(ls[k]));
    v_out[k * n + p] = v[k];
    if (g_out != nullptr) {
      g_out[k * n + p] =
          fmul(c.spot, expf(fadd(g_drift_total, k == 0 ? cv_w : -cv_w)));
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown branch count). Does not synchronise. g_out == nullptr
// skips the companion output. Outputs are (n_branch, n) row-major float32.
extern "C" int mcos_svcj_terminal(float* s_out, float* v_out, float* g_out,
                                  long long n, int steps, int n_branch,
                                  unsigned long long seed,
                                  const float* consts_host, void* stream) {
  SvcjConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svcj_kernel<2><<<blocks, threads, 0, st>>>(s_out, v_out, g_out, n, steps,
                                               key, c);
  } else if (n_branch == 1) {
    svcj_kernel<1><<<blocks, threads, 0, st>>>(s_out, v_out, g_out, n, steps,
                                               key, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
