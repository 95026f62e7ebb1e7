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
// What bounds it on an H100: device memory at the least, instruction issue
// in practice. Each path-step reads three float32 words (z_x, u_v, z_js:
// 12 B; 16 B when u_jump is streamed) and needs at least 42 instruction
// slots (chip_smoke.py's count: a quarter Philox call for the jump uniform,
// the QE transition, two log-spot updates), under the card's balance of 10
// per byte (33.5e12 instructions/s over 3.35 TB/s). What it issues is
// longer: Acklam's inverse in double Horner steps feeds the quadratic
// branch, and the transition's divides, square roots and log are IEEE
// sequences of several instructions each. The design reads every draw
// word once, coalesced: the draws are steps-major (steps, paths) and one
// thread owns one path, so a warp reads 32 neighbouring words of a step
// row. The carry
// (v, log S and log G for both branches) lives in registers for the whole
// step loop, in place of the TPU grid's step chunks, VMEM scratch and
// step-padding mask. Because u_v is shared and v does not depend on z_x,
// the two branches' variance paths are the same path: the transition runs
// once per path and v is written to both output rows.
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

template <int NB>
__global__ void __launch_bounds__(256)
    svj_qe_draws_kernel(const float* __restrict__ zx,
                        const float* __restrict__ uv,
                        const float* __restrict__ zjs,
                        const float* __restrict__ uj,
                        float* __restrict__ s_out, float* __restrict__ v_out,
                        float* __restrict__ g_out, long long n, int steps,
                        uint2 key, mcos::QeConsts c) {
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
    const float z_x = __ldg(zx + off);
    const float u_v = __ldg(uv + off);
    const float z_j = __ldg(zjs + off);
    float u;
    if (uj == nullptr) {
      if ((t & 3) == 0) {
        bits = mcos::philox4x32_10(
            make_uint4(p_lo, p_hi, static_cast<uint32_t>(t >> 2),
                       mcos::kJumpDomain),
            key);
      }
      u = mcos::bits_to_uniform(mcos::word_of(bits, t & 3));
    } else {
      u = __ldg(uj + off);
    }
    const float v_next =
        mcos::qe_variance_step(v, mcos::acklam_ndtri(u_v), u_v, c);
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
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    svj_qe_draws_kernel<2><<<blocks, threads, 0, st>>>(
        zx, uv, zjs, uj, s_out, v_out, g_out, n, steps, key, c);
  } else {
    svj_qe_draws_kernel<1><<<blocks, threads, 0, st>>>(
        zx, uv, zjs, uj, s_out, v_out, g_out, n, steps, key, c);
  }
  return static_cast<int>(cudaGetLastError());
}
