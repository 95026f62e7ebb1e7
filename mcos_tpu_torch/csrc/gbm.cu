// K2: GBM terminal spots from an in-kernel generator (the benchmark headline).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_gbm_kernel and its wrapper
// gbm_terminal_pallas: d log S = (r - q - sigma^2/2) dt + sigma dW on a
// log(S/S0) carry, both antithetic branches (+z, -z) in one thread, one exp
// at the end. The step loop stays honest (no collapse of the sum of normals)
// so the kernel keeps the shape a path-dependent payoff needs.
//
// What bounds it on an H100: arithmetic. Nothing is read from device memory
// and 4 B per path are written, while every step needs a normal: per four
// steps one Philox4x32-10 call (ten rounds of two 32-bit multiply-highs) and
// two Box-Muller pairs (two logf, two sqrtf, two sincospif). The design
// spreads that bill as thinly as it goes: one thread per antithetic pair, so
// both branches share each normal; one Philox call yields four uniforms, which
// give two Box-Muller pairs, which drive four steps. sincospif replaces the
// TPU kernel's polynomial _sincos_2pi, which existed only because Mosaic's
// trig was slow there.
//
// Counter (path_lo, path_hi, step / 4, 1), key = seed; the last quad of a
// step count that is not a multiple of four uses only the normals it needs,
// as the TPU kernel's odd tail uses only the first normal of its last pair
// (pallas_kernels.py:1411-1430). cuda_kernels.py:gbm_terminal_plain is the
// same computation in torch on the same Philox words.
#include <cstdint>

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__device__ __forceinline__ void box_muller(float u1, float u2, float& za,
                                           float& zb) {
  const float rad = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincospif(2.0f * u2, &s, &c);
  za = rad * c;
  zb = rad * s;
}

__global__ void __launch_bounds__(256)
    gbm_kernel(float* __restrict__ out, long long n, int steps, int n_branch,
               uint2 key, float spot, float drift_dt, float sig_sqrt_dt) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);
  float ls0 = 0.0f, ls1 = 0.0f;
  const int n_quads = (steps + 3) >> 2;
  for (int qd = 0; qd < n_quads; ++qd) {
    const uint4 b = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(qd), mcos::kGbmDomain),
        key);
    float z[4];
    box_muller(mcos::bits_to_uniform(b.x), mcos::bits_to_uniform(b.y), z[0],
               z[1]);
    box_muller(mcos::bits_to_uniform(b.z), mcos::bits_to_uniform(b.w), z[2],
               z[3]);
    const int left = steps - 4 * qd;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < left) {
        const float st = sig_sqrt_dt * z[k];
        ls0 = ls0 + drift_dt + st;
        ls1 = ls1 + drift_dt - st;
      }
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
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  gbm_kernel<<<static_cast<unsigned>(blocks), threads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      out, n, steps, n_branch, key, spot, drift_dt, sig_sqrt_dt);
  return static_cast<int>(cudaGetLastError());
}
