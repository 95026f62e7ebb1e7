// K7: Heston-Hull-White terminal spot and pathwise discount factor from an
// in-kernel generator (POST /api/hhw: HHWEngine.price and rate_vol_impact).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_hhw_kernel and its wrapper
// hhw_terminal_pallas. Three factors per path: the log spot under
// full-truncation Heston variance, the short rate under the exact
// Ornstein-Uhlenbeck transition r' = b + (r - b) e^{-a dt} + s_ou z_r, and
// the left-point money-market integral sum r dt, so that D S_T is an exact
// discrete martingale. Three normals a step, mixed by the rows of the 3x3
// Cholesky factor (computed on the host in float64). No jumps. One thread
// carries both branches of an antithetic pair: the normals, the mixes and
// the Brownian increments are computed once and negated for the second
// branch, as the TPU body does.
//
// What bounds it on an H100: arithmetic. Nothing is read and 16 B per pair
// are written; each pair-step needs one Philox4x32-10 call, 1.5 Box-Muller
// pairs and two branches of a 4-carry update, at least 94 operation
// slots (chip_smoke.py's count). One thread per pair keeps the eight carries
// in registers and spreads the draws over both branches. The draws take
// the forms that give the same bits in fewer instructions (PERF.md §6;
// each taken out alone costs, at 200 000 pairs x 128 steps): one sincosf
// for each Box-Muller pair (mcos::box_muller_sincos: one range reduction
// where sinf and cosf each made their own; 9 %), the uniforms by a
// bitcast (mcos::bits_to_uniform_bitcast: no integer-to-float conversion;
// 2 %), and the ten Philox round keys from the constant bank (0.5-1 %).
//
// Stream: counter (pair_lo, pair_hi, call, kHhwDomain), key = seed. Steps
// 2i and 2i + 1 take calls 2i and 2i + 1: words a0..a3 and b0, b1 give the
// Box-Muller pairs (z_a, z_b), (z_c, z_d), (z_e, z_f); step 2i runs on
// (z_a, z_b, z_c), step 2i + 1 on (z_d, z_e, z_f); b2 and b3 are spare. An
// odd last step takes call steps - 1 alone: (z1, z2) from a0, a1 and z3
// from a2, a3. The normals depend on (seed, pair, step) only, never on the
// parameters or the launch shape, which is what the common random numbers
// of rate_vol_impact rest on. cuda_kernels.py:hhw_terminal_plain draws the
// same words and performs the same IEEE operations in the same order
// (philox.cuh: fmul, fadd, fsub), so the two agree bit for bit on the card.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using mcos::fadd;
using mcos::fmul;
using mcos::fsub;

// The Philox key the loop takes: the ten round keys from the constant bank.
// With uint2 (the seed, and the key schedule in every thread) K7 runs
// 0.5-1 % slower (kernel_lab --levers).
using HhwKey = mcos::PhiloxKeys;

__device__ __forceinline__ uint4 hhw_words(uint32_t p_lo, uint32_t p_hi,
                                           int call, const HhwKey& key) {
  return mcos::philox4x32_10(
      make_uint4(p_lo, p_hi, static_cast<uint32_t>(call), mcos::kHhwDomain),
      key);
}

// Two normals from two words (mcos::box_muller on their uniforms, bit for
// bit).
__device__ __forceinline__ void normals(uint32_t w1, uint32_t w2, float& za,
                                        float& zb) {
  mcos::box_muller_sincos(mcos::bits_to_uniform_bitcast(w1),
                          mcos::bits_to_uniform_bitcast(w2), za, zb);
}

// Per-launch scalars in the TPU kernel's order (_H_SPOT.._H_L33), computed
// on the host in float64 and cast once (cuda_kernels.py:_hhw_consts).
struct HhwConsts {
  float spot, dt, sqrt_dt, kappa, theta, xi, v0, q, e_adt, s_ou, b, r0, l21,
      l22, l31, l32, l33;
};
static_assert(sizeof(HhwConsts) == 17 * sizeof(float), "packed");

template <int NB>
__device__ __forceinline__ void hhw_step(const HhwConsts& c, float z1,
                                         float z2, float z3, float (&ls)[NB],
                                         float (&v)[NB], float (&r)[NB],
                                         float (&int_r)[NB]) {
  const float zv = fadd(fmul(c.l21, z1), fmul(c.l22, z2));
  const float zr =
      fadd(fadd(fmul(c.l31, z1), fmul(c.l32, z2)), fmul(c.l33, z3));
  const float dw1 = fmul(z1, c.sqrt_dt);
  const float dwv = fmul(zv, c.sqrt_dt);
  const float ou = fmul(c.s_ou, zr);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dwv = k == 0 ? dwv : -dwv;
    const float s_ou = k == 0 ? ou : -ou;
    const float v_pos = fmaxf(v[k], 0.0f);
    const float sqrt_v = sqrtf(v_pos);
    const float drift =
        fmul(fsub(fsub(r[k], c.q), fmul(0.5f, v_pos)), c.dt);
    ls[k] = fadd(ls[k], fadd(drift, fmul(sqrt_v, s_dw1)));
    v[k] = fmaxf(
        fadd(fadd(v_pos, fmul(fmul(c.kappa, fsub(c.theta, v_pos)), c.dt)),
             fmul(fmul(c.xi, sqrt_v), s_dwv)),
        0.0f);
    int_r[k] = fadd(int_r[k], fmul(r[k], c.dt));  // left point
    r[k] = fadd(fadd(c.b, fmul(fsub(r[k], c.b), c.e_adt)), s_ou);
  }
}

template <int NB>
__global__ void __launch_bounds__(256)
    hhw_kernel(float* __restrict__ s_out, float* __restrict__ d_out,
               long long n, int steps, HhwKey key, HhwConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);

  float ls[NB], v[NB], r[NB], int_r[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    ls[k] = 0.0f;
    v[k] = c.v0;
    r[k] = c.r0;
    int_r[k] = 0.0f;
  }
  for (int i = 0; i + 1 < steps; i += 2) {
    const uint4 a = hhw_words(p_lo, p_hi, i, key);
    const uint4 b = hhw_words(p_lo, p_hi, i + 1, key);
    float z_a, z_b, z_c, z_d, z_e, z_f;
    normals(a.x, a.y, z_a, z_b);
    normals(a.z, a.w, z_c, z_d);
    normals(b.x, b.y, z_e, z_f);
    hhw_step<NB>(c, z_a, z_b, z_c, ls, v, r, int_r);
    hhw_step<NB>(c, z_d, z_e, z_f, ls, v, r, int_r);
  }
  if (steps & 1) {
    const uint4 a = hhw_words(p_lo, p_hi, steps - 1, key);
    float z1, z2, z3, unused;
    normals(a.x, a.y, z1, z2);
    normals(a.z, a.w, z3, unused);
    hhw_step<NB>(c, z1, z2, z3, ls, v, r, int_r);
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    s_out[k * n + p] = fmul(c.spot, expf(ls[k]));
    d_out[k * n + p] = expf(-int_r[k]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown branch count). Does not synchronise. Outputs are
// (n_branch, n) row-major float32: terminal spots and discount factors.
extern "C" int mcos_hhw_terminal(float* s_out, float* d_out, long long n,
                                 int steps, int n_branch,
                                 unsigned long long seed,
                                 const float* consts_host, void* stream) {
  HhwConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const HhwKey key = mcos::philox_key<HhwKey>(seed);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_branch == 2) {
    hhw_kernel<2><<<blocks, threads, 0, st>>>(s_out, d_out, n, steps, key, c);
  } else if (n_branch == 1) {
    hhw_kernel<1><<<blocks, threads, 0, st>>>(s_out, d_out, n, steps, key, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
