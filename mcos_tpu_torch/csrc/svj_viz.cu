// The two visualisation programs of /api/price in one launch each: the
// viz-path recorder (a few tens of whole paths, every step's spot) and the
// histogram sampler (about a thousand terminal spots, one branch).
//
// Replaces no Pallas kernel. The JAX package runs both as `lax.scan`
// programs (mcos_tpu/ops/simulate.py: simulate_paths_recorded and
// simulate_terminal, which one jit compiles into a handful of device
// programs). The port ran them as Python step loops over
// ops/simulate.py:_svj_step_core, about 40 torch launches a step and some
// 3 000 a quote, each costing the host far more than the card's work; this
// kernel is the whole loop, and a program is now two draws (torch.randn,
// torch.rand on the engine's seeded generator, unchanged) and this launch.
//
// One thread a path. It carries (log S, v) in registers over all the
// steps and reads its step's draws from the (steps, 3, n) normals and the
// (steps, n) jump uniforms, neighbouring threads on neighbouring
// addresses. The step is the twin's full-truncation log-Euler SVJ step
// (ops/simulate.py:_svj_step_core) in its order of operations, every
// multiply, add and subtract an uncontracted IEEE operation (philox.cuh:
// fmul, fadd, fsub), as in K1 and K3: the constants are what the torch
// loop forms on the card (cuda_kernels.py:_viz_consts), so only the last
// bits of k = exp(mu_J + sigma_J^2 / 2) - 1, taken by numpy on the host,
// and of expf can differ from the loop's.
//
// What bounds it on an H100: latency. A path is a serial chain of its
// steps (10-62 on the quote's paths), each a dependent chain of about
// twenty operations through sqrtf; the bytes, 16 B a path-step (about
// 1 MB, 0.3 us at the card's bandwidth, for 1 024 x 62) and the few
// blocks (1 for 50 paths, 8 for 1 024) leave the card nearly empty. The
// design does not fight that: the loop is unrolled so the loads of
// several steps issue together, off the chain, and the rest of the time
// is the launch itself.
//
// Record mode writes out (n, steps + 1) row-major, column 0 = spot and
// column t + 1 = spot exp(log S after step t); terminal mode writes out
// (n,), spot exp(log S) after the last step.
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using mcos::fadd;
using mcos::fmul;
using mcos::fsub;

// The 13 per-launch float32 scalars, in the order of
// cuda_kernels.py:_viz_consts. drift is the compensated drift
// r - q - lambda k (not yet times dt), as the twin forms it.
struct VizConsts {
  float spot, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
      sig_j, drift;
};
constexpr int kNumConsts = 13;
static_assert(sizeof(VizConsts) == kNumConsts * sizeof(float), "packed");

constexpr int kThreads = 128;

// ops/simulate.py:_svj_step_core, operation for operation.
__device__ __forceinline__ void viz_step(const VizConsts& c, float z1,
                                         float z2, float u_jump, float z_js,
                                         float& log_s, float& v) {
  const float v_pos = fmaxf(v, 0.0f);
  const float sqrt_v = v_pos > 0.0f ? sqrtf(fmaxf(v_pos, 1e-20f)) : 0.0f;
  const float dw1 = fmul(z1, c.sqrt_dt);
  const float dw2 =
      fadd(fmul(c.rho, dw1), fmul(fmul(c.rho_perp, z2), c.sqrt_dt));
  const float jump =
      u_jump < c.lam_dt ? fadd(fmul(c.sig_j, z_js), c.mu_j) : 0.0f;
  log_s = fadd(fadd(fadd(log_s, fmul(fsub(c.drift, fmul(0.5f, v_pos)), c.dt)),
                    fmul(sqrt_v, dw1)),
               jump);
  v = fmaxf(fadd(fadd(v_pos, fmul(fmul(c.kappa, fsub(c.theta, v_pos)), c.dt)),
                 fmul(fmul(c.xi, sqrt_v), dw2)),
            0.0f);
}

__global__ void __launch_bounds__(kThreads)
    svj_viz_kernel(const float* __restrict__ z, const float* __restrict__ u,
                   const VizConsts c, float* __restrict__ out, long long n,
                   int steps, int record) {
  const long long p = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (p >= n) return;
  float log_s = 0.0f;
  float v = c.v0;
  float* row = out + p * (steps + 1LL);
  if (record) row[0] = c.spot;
#pragma unroll 8
  for (int t = 0; t < steps; ++t) {
    const float* zt = z + 3LL * n * t;
    viz_step(c, zt[p], zt[n + p], u[n * t + p], zt[2 * n + p], log_s, v);
    if (record) row[t + 1] = fmul(c.spot, expf(log_s));
  }
  if (!record) out[p] = fmul(c.spot, expf(log_s));
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError(). Does not synchronise.
// z: device (steps, 3, n) normals (z1, z2, z_js); u: device (steps, n)
// jump uniforms; consts: HOST pointer to the 13 VizConsts floats, passed
// to the kernel by value (no copy to the device); out: device (n, steps + 1)
// with record, else (n,).
extern "C" int mcos_svj_viz(const float* z, const float* u,
                            const float* consts, float* out, long long n,
                            int steps, int record, void* stream) {
  if (n < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* f = consts;
  const VizConsts c{f[0], f[1], f[2], f[3], f[4],  f[5], f[6],
                    f[7], f[8], f[9], f[10], f[11], f[12]};
  svj_viz_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(z, u, c, out, n, steps,
                                                        record);
  return static_cast<int>(cudaGetLastError());
}
