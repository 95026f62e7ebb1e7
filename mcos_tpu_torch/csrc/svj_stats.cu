// K6: SVJ paths under full-truncation Euler with running path functionals,
// from an in-kernel generator (the exotics hot path: Asians, single and
// double barriers, touch digitals, lookbacks behind POST /api/exotic).
//
// Replaces mcos_tpu/ops/pallas_kernels.py:_svj_stats_kernel and its wrapper
// svj_path_stats_pallas. Per path and antithetic branch it returns the
// terminal spot, the arithmetic mean and the mean log of S over the grid
// t_1..t_n, the running maximum and minimum, and (bridge modes) the
// Brownian-bridge log-survival weight against one barrier (up or down) or
// a corridor (the image series of ops/exotics.py:corridor_surv_increment,
// two images each side: nine exponentials per leg and step), optionally
// restricted to the steps [w0, w1); with the companion on, the same six for
// the sigma = sqrt(v0) GBM leg on the same dW1. Jumps are one Bernoulli
// per step (u < lambda dt), as in the TPU kernel: the path functionals see
// when a jump lands, so there is no once-per-path count here, unlike K3.
//
// Not carried over from the TPU kernel: the (rows, 128) layout, the two
// grid halves for the antithetic branches (one thread runs both branches
// of a pair here and shares every draw) and the twelve always-written
// outputs (only the rows the variant has are written: 5 or 6, doubled with
// the companion).
//
// What bounds it on an H100: arithmetic. Nothing is read and at most 96 B
// per pair are written; a pair-step costs a Philox4x32-10 call, three
// uniforms' worth of Box-Muller, two Euler branches with an exp each, the
// companion's two exps, and in the bridge modes 2 to 4 survival increments
// of 1 exp + 1 log1p (single barrier) or 9 exp + 1 log (corridor). The
// design keeps the whole carry (up to 26 floats) in registers and spends
// one thread per antithetic pair so both branches share the draws.
//
// Rounding. `dead = an endpoint on the wrong side of the barrier` is a
// discontinuous select on the log-spot carry: a path that ends a step
// within an ulp of the barrier would be -inf here and finite in the plain
// version if the two rounded differently. So every operation on the
// carries and in the survival increments is an explicit __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc never contracts into an
// FMA, in the order cuda_kernels.py:svj_path_stats_plain performs them; on
// the card the two then agree bit for bit on log S, v and log G, and no
// path may differ in its dead/alive state (chip_smoke.py counts them and
// fails on one). The price is the FMAs a contracted build would use; the
// kernel is bound by its special functions, not by those. The build has no
// fast-math, and the -inf arithmetic relies on that: -inf + x = -inf,
// expf(-inf) = 0, fmaxf(-inf, x) = x.
//
// Stream: counter (pair_lo, pair_hi, call, kStatsDomain), key = seed. Steps
// 2i and 2i + 1 take calls 2i and 2i + 1, eight words: three Box-Muller
// pairs (z_a, z_b), (z_c, z_d), (z_e, z_f) from words 0-5 and the two jump
// uniforms from words 6, 7; step 2i uses (z_a, z_b, z_c, u6) as (z1, z2,
// z_jump), step 2i + 1 (z_d, z_e, z_f, u7): the TPU kernel's layout. An odd
// last step takes calls steps - 1 and steps: (z1, z2) from words 0, 1,
// z_jump from words 2, 3, the uniform from word 4. The stream depends on
// (pair, step, seed) only; svj_path_stats_plain draws the same words.
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "philox.cuh"

namespace {

// Per-launch scalars, computed on the host in float32
// (cuda_kernels.py:_stats_consts: _svj_consts, the barrier logs
// log(B / S0) and log(L / S0), and 1 / steps).
struct StatsConsts {
  float spot, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
      sig_j, drift_dt, g_drift_dt, sig_cv, log_b, log_l, inv_n;
};
static_assert(sizeof(StatsConsts) == 18 * sizeof(float), "packed");

constexpr int kNoBridge = 0;
constexpr int kBridgeUp = 1;
constexpr int kBridgeDown = 2;
constexpr int kCorridor = 3;

// log P(no within-step crossing | endpoints live), -inf on a breached
// endpoint; s_var = max(var_step dt, 1e-20). Single barrier:
// log1p(-min(exp(min(-2 d_old d_new / s_var, 0)), 1 - 1e-7))
// (pallas_kernels.py:_svj_stats_kernel surv_inc). Corridor: the image
// series, n = -2..2, every exponent clamped at 0, P_surv clipped to
// [1e-7, 1] (mcos_tpu/ops/exotics.py:corridor_surv_increment).
template <int MODE>
__device__ __forceinline__ float surv_inc(float x_old, float x_new,
                                          float var_step,
                                          const StatsConsts& c) {
  const float s_var = fmaxf(__fmul_rn(var_step, c.dt), 1e-20f);
  if (MODE == kCorridor) {
    const float a = __fsub_rn(x_old, c.log_l);
    const float b = __fsub_rn(x_new, c.log_l);
    const float d = __fsub_rn(c.log_b, c.log_l);
    const bool dead = a <= 0.0f || a >= d || b <= 0.0f || b >= d;
    const float delta = __fsub_rn(b, a);
    const float ssum = __fadd_rn(a, b);
    const float delta_sq = __fmul_rn(delta, delta);
    const float two_s = __fmul_rn(2.0f, s_var);
    float psurv = 1.0f;
#pragma unroll
    for (int n = -2; n <= 2; ++n) {
      const float nf = static_cast<float>(n);
      if (n != 0) {
        const float ret = __fdiv_rn(
            __fmul_rn(__fmul_rn(-2.0f * nf, d),
                      __fsub_rn(__fmul_rn(nf, d), delta)),
            s_var);
        psurv = __fadd_rn(psurv, expf(fminf(ret, 0.0f)));
      }
      const float t = __fsub_rn(ssum, __fmul_rn(2.0f * nf, d));
      const float cross =
          __fdiv_rn(-__fsub_rn(__fmul_rn(t, t), delta_sq), two_s);
      psurv = __fsub_rn(psurv, expf(fminf(cross, 0.0f)));
    }
    return dead ? -CUDART_INF_F : logf(fminf(fmaxf(psurv, 1e-7f), 1.0f));
  }
  const float d_old = MODE == kBridgeUp ? __fsub_rn(c.log_b, x_old)
                                        : __fsub_rn(x_old, c.log_b);
  const float d_new = MODE == kBridgeUp ? __fsub_rn(c.log_b, x_new)
                                        : __fsub_rn(x_new, c.log_b);
  const bool dead = d_old <= 0.0f || d_new <= 0.0f;
  const float e =
      __fdiv_rn(__fmul_rn(__fmul_rn(-2.0f, d_old), d_new), s_var);
  const float p_cross = expf(fminf(e, 0.0f));
  return dead ? -CUDART_INF_F : log1pf(-fminf(p_cross, mcos::kUMax));
}

// The carry of one antithetic pair: log(S/S0), v and the running
// functionals of the SVJ leg, and the companion leg's.
template <int NB>
struct Carry {
  float ls[NB], v[NB], sum_s[NB], sum_l[NB], max_l[NB], min_l[NB], surv[NB];
  float lg[NB], g_sum_s[NB], g_sum_l[NB], g_max_l[NB], g_min_l[NB],
      g_surv[NB];
};

// One step for both branches (pallas_kernels.py:_svj_stats_kernel one_step);
// the second branch negates the three normals and shares the jump uniform.
template <int NB, int MODE, bool COMP>
__device__ __forceinline__ void one_step(const StatsConsts& c, float z1,
                                         float z2, float z_js, float u_jump,
                                         bool in_win, float g_var,
                                         Carry<NB>& st) {
  const float dw1 = __fmul_rn(z1, c.sqrt_dt);
  const float dw2 =
      __fadd_rn(__fmul_rn(c.rho, dw1),
                __fmul_rn(__fmul_rn(c.rho_perp, z2), c.sqrt_dt));
  const bool jumped = u_jump < c.lam_dt;
  const float jump_body = __fmul_rn(c.sig_j, z_js);
  const float cv_dw = __fmul_rn(c.sig_cv, dw1);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dw2 = k == 0 ? dw2 : -dw2;
    const float v_pos = fmaxf(st.v[k], 0.0f);
    const float sqrt_v = sqrtf(v_pos);
    const float jump =
        jumped ? __fadd_rn(c.mu_j, k == 0 ? jump_body : -jump_body) : 0.0f;
    const float x_prev = st.ls[k];
    float x = __fadd_rn(
        x_prev,
        __fsub_rn(c.drift_dt, __fmul_rn(__fmul_rn(0.5f, v_pos), c.dt)));
    x = __fadd_rn(x, __fmul_rn(sqrt_v, s_dw1));
    x = __fadd_rn(x, jump);
    float v_next = __fadd_rn(
        v_pos,
        __fmul_rn(__fmul_rn(c.kappa, __fsub_rn(c.theta, v_pos)), c.dt));
    v_next = __fadd_rn(v_next, __fmul_rn(__fmul_rn(c.xi, sqrt_v), s_dw2));
    st.ls[k] = x;
    st.v[k] = fmaxf(v_next, 0.0f);
    st.sum_s[k] = __fadd_rn(st.sum_s[k], expf(x));
    st.sum_l[k] = __fadd_rn(st.sum_l[k], x);
    st.max_l[k] = fmaxf(st.max_l[k], x);
    st.min_l[k] = fminf(st.min_l[k], x);
    if (MODE != kNoBridge && in_win) {
      st.surv[k] = __fadd_rn(
          st.surv[k], surv_inc<MODE>(x_prev, x, fmaxf(v_pos, 1e-12f), c));
    }
    if (COMP) {
      const float g_prev = st.lg[k];
      const float g = __fadd_rn(__fadd_rn(g_prev, c.g_drift_dt),
                                k == 0 ? cv_dw : -cv_dw);
      st.lg[k] = g;
      st.g_sum_s[k] = __fadd_rn(st.g_sum_s[k], expf(g));
      st.g_sum_l[k] = __fadd_rn(st.g_sum_l[k], g);
      st.g_max_l[k] = fmaxf(st.g_max_l[k], g);
      st.g_min_l[k] = fminf(st.g_min_l[k], g);
      if (MODE != kNoBridge && in_win) {
        st.g_surv[k] =
            __fadd_rn(st.g_surv[k], surv_inc<MODE>(g_prev, g, g_var, c));
      }
    }
  }
}

// out is (rows, NB, n) row-major; rows in order: s_final, avg, log_avg,
// max_s, min_s, [log_surv], then with the companion g_final, g_avg,
// g_log_avg, g_max, g_min, [g_log_surv].
template <int NB, int MODE, bool COMP>
__global__ void __launch_bounds__(256)
    svj_stats_kernel(float* __restrict__ out, long long n, int steps, int w0,
                     int w1, uint2 key, StatsConsts c) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t p_lo = static_cast<uint32_t>(p);
  const uint32_t p_hi = static_cast<uint32_t>(static_cast<uint64_t>(p) >> 32);

  Carry<NB> st;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    st.ls[k] = st.sum_s[k] = st.sum_l[k] = st.surv[k] = 0.0f;
    st.lg[k] = st.g_sum_s[k] = st.g_sum_l[k] = st.g_surv[k] = 0.0f;
    st.v[k] = c.v0;
    st.max_l[k] = st.g_max_l[k] = -CUDART_INF_F;
    st.min_l[k] = st.g_min_l[k] = CUDART_INF_F;
  }
  const float g_var = __fmul_rn(c.sig_cv, c.sig_cv);

  const int n_even = steps & ~1;
  for (int i = 0; i < n_even; i += 2) {
    const uint4 a = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(i), mcos::kStatsDomain),
        key);
    const uint4 b = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(i + 1),
                   mcos::kStatsDomain),
        key);
    float z_a, z_b, z_c, z_d, z_e, z_f;
    mcos::box_muller(mcos::bits_to_uniform(a.x), mcos::bits_to_uniform(a.y),
                     z_a, z_b);
    mcos::box_muller(mcos::bits_to_uniform(a.z), mcos::bits_to_uniform(a.w),
                     z_c, z_d);
    mcos::box_muller(mcos::bits_to_uniform(b.x), mcos::bits_to_uniform(b.y),
                     z_e, z_f);
    one_step<NB, MODE, COMP>(c, z_a, z_b, z_c, mcos::bits_to_uniform(b.z),
                             i >= w0 && i < w1, g_var, st);
    one_step<NB, MODE, COMP>(c, z_d, z_e, z_f, mcos::bits_to_uniform(b.w),
                             i + 1 >= w0 && i + 1 < w1, g_var, st);
  }
  if (steps & 1) {
    const int i = steps - 1;
    const uint4 a = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(i), mcos::kStatsDomain),
        key);
    const uint4 b = mcos::philox4x32_10(
        make_uint4(p_lo, p_hi, static_cast<uint32_t>(i + 1),
                   mcos::kStatsDomain),
        key);
    float z1, z2, z_js, unused;
    mcos::box_muller(mcos::bits_to_uniform(a.x), mcos::bits_to_uniform(a.y),
                     z1, z2);
    mcos::box_muller(mcos::bits_to_uniform(a.z), mcos::bits_to_uniform(a.w),
                     z_js, unused);
    one_step<NB, MODE, COMP>(c, z1, z2, z_js, mcos::bits_to_uniform(b.x),
                             i >= w0 && i < w1, g_var, st);
  }

  constexpr int kLegRows = MODE == kNoBridge ? 5 : 6;
  const float log_spot = logf(c.spot);
  const long long row = static_cast<long long>(NB) * n;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float* o = out + k * n + p;
    o[0 * row] = __fmul_rn(c.spot, expf(st.ls[k]));
    o[1 * row] = __fmul_rn(c.spot, __fmul_rn(st.sum_s[k], c.inv_n));
    o[2 * row] = __fadd_rn(log_spot, __fmul_rn(st.sum_l[k], c.inv_n));
    o[3 * row] = __fmul_rn(c.spot, expf(st.max_l[k]));
    o[4 * row] = __fmul_rn(c.spot, expf(st.min_l[k]));
    if (MODE != kNoBridge) o[5 * row] = st.surv[k];
    if (COMP) {
      float* g = o + kLegRows * row;
      g[0 * row] = __fmul_rn(c.spot, expf(st.lg[k]));
      g[1 * row] = __fmul_rn(c.spot, __fmul_rn(st.g_sum_s[k], c.inv_n));
      g[2 * row] = __fadd_rn(log_spot, __fmul_rn(st.g_sum_l[k], c.inv_n));
      g[3 * row] = __fmul_rn(c.spot, expf(st.g_max_l[k]));
      g[4 * row] = __fmul_rn(c.spot, expf(st.g_min_l[k]));
      if (MODE != kNoBridge) g[5 * row] = st.g_surv[k];
    }
  }
}

template <int NB, int MODE>
void launch_comp(bool companion, unsigned blocks, int threads,
                 cudaStream_t st, float* out, long long n, int steps, int w0,
                 int w1, uint2 key, const StatsConsts& c) {
  if (companion) {
    svj_stats_kernel<NB, MODE, true>
        <<<blocks, threads, 0, st>>>(out, n, steps, w0, w1, key, c);
  } else {
    svj_stats_kernel<NB, MODE, false>
        <<<blocks, threads, 0, st>>>(out, n, steps, w0, w1, key, c);
  }
}

template <int NB>
bool launch_mode(int mode, bool companion, unsigned blocks, int threads,
                 cudaStream_t st, float* out, long long n, int steps, int w0,
                 int w1, uint2 key, const StatsConsts& c) {
  switch (mode) {
    case kNoBridge:
      launch_comp<NB, kNoBridge>(companion, blocks, threads, st, out, n,
                                 steps, w0, w1, key, c);
      return true;
    case kBridgeUp:
      launch_comp<NB, kBridgeUp>(companion, blocks, threads, st, out, n,
                                 steps, w0, w1, key, c);
      return true;
    case kBridgeDown:
      launch_comp<NB, kBridgeDown>(companion, blocks, threads, st, out, n,
                                   steps, w0, w1, key, c);
      return true;
    case kCorridor:
      launch_comp<NB, kCorridor>(companion, blocks, threads, st, out, n,
                                 steps, w0, w1, key, c);
      return true;
    default:
      return false;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for an unknown mode or branch count). Does not synchronise. `out` is
// (rows, n_branch, n) row-major float32 with rows = (mode == 0 ? 5 : 6) *
// (companion ? 2 : 1); mode: 0 no bridge, 1 barrier above, 2 barrier below,
// 3 corridor; the bridge is monitored on the steps [w0, w1).
extern "C" int mcos_svj_path_stats(float* out, long long n, int steps,
                                   int n_branch, int mode, int companion,
                                   int w0, int w1, unsigned long long seed,
                                   const float* consts_host, void* stream) {
  StatsConsts c;
  std::memcpy(&c, consts_host, sizeof(c));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool known = false;
  if (n_branch == 2) {
    known = launch_mode<2>(mode, companion != 0, blocks, threads, st, out, n,
                           steps, w0, w1, key, c);
  } else if (n_branch == 1) {
    known = launch_mode<1>(mode, companion != 0, blocks, threads, st, out, n,
                           steps, w0, w1, key, c);
  }
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
