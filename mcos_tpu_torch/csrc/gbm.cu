// K2: GBM terminal spots from an in-kernel generator (the benchmark headline).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_gbm_kernel and its wrapper
// gbm_terminal_pallas: d log S = (r - q - sigma^2/2) dt + sigma dW on a
// log(S/S0) carry, both antithetic branches (+z, -z) in one thread, one exp
// at the end. The step loop stays honest (no collapse of the sum of normals)
// so the kernel keeps the shape a path-dependent payoff needs.
//
// What bounds it on an H100: instruction issue. Nothing is read from device
// memory and 4 B per path are written, while every step needs a normal. The
// library's accurate logf, sqrtf and sincospif are polynomial sequences with
// range reduction and subnormal fix-ups: they made the step loop 254
// instructions a quad (four steps) by cuobjdump -sass. Here each is one MUFU
// instruction in its flush-to-zero form, the uniforms need no I2F, and the
// Philox round keys come from the constant bank, so a quad is about 99:
// Philox 40 (15 IMAD.WIDE and 3 IMAD.HI on the half-rate multiply pipe, 20
// LOP3), four uniforms of 2, two Box-Muller pairs of about 13 with 4 MUFU
// each (an eighth of the FFMA rate: 64 of a quad's ~150 clocks per
// sub-partition), four steps of 4 (python -m mcos_tpu_torch.kernel_lab
// --sass). The design spreads that bill as thinly as it goes: one thread per
// antithetic pair, so both branches share each normal; one Philox call
// yields four uniforms, which give two Box-Muller pairs, which drive four
// steps; two quads per loop iteration, so two independent Philox chains are
// in flight in every thread (31 registers: full occupancy).
//
// Accuracy of the hardware functions (they must hold the pins against the
// accurate plain version, rtol 1e-5 on S even at one step of sigma 0.2):
//   - sine and cosine on the angle 2 pi (u2 - 1/2), centred into (-pi, pi]
//     where their absolute error is about 2^-21.4; cos(x + pi) = -cos x
//     and sin(x + pi) = -sin x give the normals with both signs flipped;
//   - the radius sqrt(t) as t * rsqrt(t), t = -2 log u1 > 0;
//   - the log2's absolute error (about 2^-22) is not small against log u1
//     when u1 is within 2^-7 of 1 (it gives a radius 2e-4 off, or worse,
//     a t of the wrong sign), so there t comes from the series
//     -2 log(1 - w) = w (2 + w) + 2 w^3 / 3 + ... in w = 1 - u1 (exact:
//     u1 >= 1/2, Sterbenz), cut after w^2: at most 2.1e-5 of t, 1.3e-6 on
//     the radius. The select costs about a tenth of the kernel's time.
//   Over all 2^23 uniforms the radius is within 1.3e-6 of float64 and the
//   sine and cosine within 3.5e-7 (kernel_lab --probes, checked by
//   tests/test_torch_cuda.py).
//
// Counter (path_lo, path_hi, step / 4, 1), key = seed; the last quad of a
// step count that is not a multiple of four uses only the normals it needs,
// as the TPU kernel's odd tail uses only the first normal of its last pair
// (pallas_kernels.py:1411-1430). cuda_kernels.py:gbm_terminal_plain is the
// same computation in torch on the same Philox words, with the accurate
// functions.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

// -2 ln 2 in float32: -2 log(x) = log2(x) * kMinus2Ln2.
constexpr float kMinus2Ln2 = -1.38629436111989061883f;
// Below this distance from 1, -2 log u1 comes from the series.
constexpr float kNearOne = 0.0078125f;  // 2^-7

// The hardware's approximations (one MUFU instruction each) in their
// flush-to-zero forms: every argument here is a normal float (u1 >= 2^-24,
// t >= 2^-23, |angle| <= pi), so flushing changes nothing, and the
// compiler emits no subnormal fix-up around the MUFU as it does for
// __log2f, rsqrtf and __sincosf.
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void sincos_approx(float x, float& s, float& c) {
  asm("sin.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(x));
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(c) : "f"(x));
}

__device__ __forceinline__ void box_muller_fast(float u1, float u2,
                                                float& za, float& zb) {
  const float w = 1.0f - u1;
  const float t_series = w * (2.0f + w);
  const float t = w < kNearOne ? t_series : lg2_approx(u1) * kMinus2Ln2;
  const float rad = t * rsqrt_approx(t);
  float s, c;
  sincos_approx(mcos::kTwoPi * (u2 - 0.5f), s, c);
  za = -rad * c;
  zb = -rad * s;
}

// Four normals from quad `qd` of pair (p_lo, p_hi).
__device__ __forceinline__ void quad_normals(uint32_t p_lo, uint32_t p_hi,
                                             int qd,
                                             const mcos::PhiloxKeys& keys,
                                             float (&z)[4]) {
  const uint4 b = mcos::philox4x32_10(
      make_uint4(p_lo, p_hi, static_cast<uint32_t>(qd), mcos::kGbmDomain),
      keys);
  box_muller_fast(mcos::bits_to_uniform_bitcast(b.x),
                  mcos::bits_to_uniform_bitcast(b.y), z[0], z[1]);
  box_muller_fast(mcos::bits_to_uniform_bitcast(b.z),
                  mcos::bits_to_uniform_bitcast(b.w), z[2], z[3]);
}

__device__ __forceinline__ void gbm_step(float z, float drift_dt,
                                         float sig_sqrt_dt, float& ls0,
                                         float& ls1) {
  const float st = sig_sqrt_dt * z;
  ls0 = ls0 + drift_dt + st;
  ls1 = ls1 + drift_dt - st;
}

__global__ void __launch_bounds__(256)
    gbm_kernel(float* __restrict__ out, long long n, int steps, int n_branch,
               mcos::PhiloxKeys keys, float spot, float drift_dt,
               float sig_sqrt_dt) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);
  float ls0 = 0.0f, ls1 = 0.0f;
  const int full_quads = steps >> 2;
  int qd = 0;
  // Two full quads an iteration: both Philox calls are issued before
  // either quad's normals are consumed.
  for (; qd + 2 <= full_quads; qd += 2) {
    float za[4], zb[4];
    quad_normals(p_lo, p_hi, qd, keys, za);
    quad_normals(p_lo, p_hi, qd + 1, keys, zb);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gbm_step(za[k], drift_dt, sig_sqrt_dt, ls0, ls1);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gbm_step(zb[k], drift_dt, sig_sqrt_dt, ls0, ls1);
    }
  }
  // At most one full quad and one partial quad are left.
  const int n_quads = (steps + 3) >> 2;
  for (; qd < n_quads; ++qd) {
    float z[4];
    quad_normals(p_lo, p_hi, qd, keys, z);
    const int left = steps - 4 * qd;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < left) gbm_step(z[k], drift_dt, sig_sqrt_dt, ls0, ls1);
    }
  }
  out[p] = spot * expf(ls0);
  if (n_branch == 2) out[n + p] = spot * expf(ls1);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError(). Does not synchronise.
// out is (n_branch, n) row-major.
extern "C" int mcos_gbm_terminal(float* out, long long n, int steps,
                                 int n_branch, unsigned long long seed,
                                 float spot, float drift_dt,
                                 float sig_sqrt_dt, void* stream) {
  const mcos::PhiloxKeys keys = mcos::philox_round_keys(seed);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  gbm_kernel<<<static_cast<unsigned>(blocks), threads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      out, n, steps, n_branch, keys, spot, drift_dt, sig_sqrt_dt);
  return static_cast<int>(cudaGetLastError());
}
