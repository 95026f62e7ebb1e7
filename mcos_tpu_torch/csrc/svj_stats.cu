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
// What bounds it on an H100: instruction issue. Nothing is read and at
// most 96 B per pair are written; a pair-step costs a Philox4x32-10 call,
// three uniforms' worth of Box-Muller, two Euler branches with an exp
// each, the companion's two exps, and in the bridge modes 2 to 4 survival
// increments of 1 exp + 1 log1p (single barrier) or 9 exp + 1 log
// (corridor). Bit-equality with the plain version fixes every carry
// operation (below) and the accurate library functions, so the step loop
// is mostly library sequences (python -m mcos_tpu_torch.kernel_lab
// --kernels k6 --sass counts them). The design keeps the whole carry (up
// to 26 floats) in registers, spends one thread per antithetic pair so
// both branches share the draws, and takes only levers that leave every
// bit where it was:
//   - Box-Muller through philox.cuh:box_muller_sincos (one range
//     reduction for the sine and the cosine, their bits), the uniforms
//     through bits_to_uniform_bitcast (no I2F), and in the corridor's loop
//     the Philox round keys from the constant bank (StatsKey);
//   - the corridor's launch constants (its width d = log_b - log_l and the
//     image products 2n d and n d) and the companion's step variance, its
//     double and their reciprocals come from the host in StatsConsts,
//     computed there by the same IEEE float32 operations
//     (cuda_kernels.py:_stats_consts), so the loop holds none of them in a
//     register;
//   - the corridor's nine divides an increment share one reciprocal per
//     denominator: a / s is q = a r, e = fma(-s, q, a), q + e r with r the
//     correctly rounded 1 / s (Markstein), which is the correctly rounded
//     quotient when nothing over- or underflows; an increment whose
//     endpoints or variance could leave that range (|a|, |b|, |d| >= 1024,
//     s >= 1e30, or a NaN) makes all nine again with the library's
//     __fdiv_rn, in one block after the fast ones (a branch around each
//     divide instead fences the exps apart and cost a third). Each
//     quotient is read only through expf(min(q, 0)), where a quotient
//     below 2^-25 in size gives 1 either way;
//   - no __launch_bounds__ minimum: ptxas gives the route's instantiations
//     57 (Asian), 61 (barrier) and 76 (corridor + companion) registers, 4,
//     4 and 3 blocks of 256 an SM; forcing 5 or 4 spills and is slower,
//     and the time per pair is the same where the launch fits one wave.
//
// Rounding. `dead = an endpoint on the wrong side of the barrier` is a
// discontinuous select on the log-spot carry: a path that ends a step
// within an ulp of the barrier would be -inf here and finite in the plain
// version if the two rounded differently. So every operation on the
// carries and in the survival increments is an explicit __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn (or the exact division above), which
// nvcc never contracts into an FMA, in the order
// cuda_kernels.py:svj_path_stats_plain performs them; on the card the two
// then agree bit for bit on every output (chip_smoke.py and
// tests/test_torch_cuda.py hold them so). The build has no fast-math, and
// the -inf arithmetic relies on that: -inf + x = -inf, expf(-inf) = 0,
// fmaxf(-inf, x) = x.
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
#include <type_traits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "philox.cuh"

namespace {

using mcos::box_muller_sincos;
using mcos::fadd;
using mcos::fmul;
using mcos::fsub;

constexpr int kThreads = 256;

// Per-launch scalars, computed on the host in float32
// (cuda_kernels.py:_stats_consts): _svj_consts, the barrier logs
// log(B / S0) and log(L / S0) and 1 / steps; then the corridor's width
// d = log_b - log_l, two_nd[j] = 2 (j - 2) d and nd[j] = (j - 2) d for the
// images n = j - 2 = -2..2; the companion's step variance
// g_s = max(sig_cv^2 dt, 1e-20), g_two_s = 2 g_s and their correctly
// rounded reciprocals.
struct StatsConsts {
  float spot, v0, dt, sqrt_dt, kappa, theta, xi, rho, rho_perp, lam_dt, mu_j,
      sig_j, drift_dt, g_drift_dt, sig_cv, log_b, log_l, inv_n;
  float width, two_nd[5], nd[5], g_s, g_two_s, g_rcp, g_rcp_two;
};
static_assert(sizeof(StatsConsts) == 33 * sizeof(float), "packed");

constexpr int kNoBridge = 0;
constexpr int kBridgeUp = 1;
constexpr int kBridgeDown = 2;
constexpr int kCorridor = 3;

// A step's variance s = max(var_step dt, 1e-20), 2 s, and (corridor) their
// correctly rounded reciprocals.
struct StepVar {
  float s, two_s, rcp, rcp_two;
};

// a / s, correctly rounded, from r = 1 / s correctly rounded (Markstein):
// right wherever nothing over- or underflows (surv_inc's `exact`).
__device__ __forceinline__ float quot(float a, float s, float r) {
  const float q = fmul(a, r);
  return __fmaf_rn(__fmaf_rn(-s, q, a), r, q);
}

// Endpoint distances and variances below which quot is exact: the
// numerators stay below 2^26 and the quotients below 2^93.
constexpr float kQuotArg = 1024.0f;
constexpr float kQuotVar = 1e30f;

// The corridor's image series, n = -2..2 (mcos_tpu/ops/exotics.py:
// corridor_surv_increment), a = x_old - log_l, b = x_new - log_l: the
// exponent of the return image n != 0, -2 n d (n d - (b - a)) / s, and of
// the crossing image n, -((a + b - 2 n d)^2 - (b - a)^2) / (2 s).
__device__ __forceinline__ float ret_num(int j, float delta,
                                         const StatsConsts& c) {
  // -2 n d = 2 (-n) d: two_nd at the mirrored image
  return fmul(c.two_nd[4 - j], fsub(c.nd[j], delta));
}
__device__ __forceinline__ float cross_num(int j, float delta_sq, float ssum,
                                           const StatsConsts& c) {
  const float t = fsub(ssum, c.two_nd[j]);
  return -fsub(fmul(t, t), delta_sq);
}

// P_surv before the clip: sum over the images of exp(min(return, 0)) -
// exp(min(crossing, 0)), the n = 0 return term being 1. The nine quotients
// come from quot; where that is not known to be exact, all nine are made
// again by the library's __fdiv_rn, in one block that no path takes in
// practice (a branch around each divide instead fences the exps apart).
__device__ __forceinline__ float corridor_psurv(float delta, float ssum,
                                                const StepVar& w, bool exact,
                                                const StatsConsts& c) {
  const float delta_sq = fmul(delta, delta);
  float ret[5], cross[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    if (j != 2) ret[j] = quot(ret_num(j, delta, c), w.s, w.rcp);
    cross[j] = quot(cross_num(j, delta_sq, ssum, c), w.two_s, w.rcp_two);
  }
  if (!exact) {
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (j != 2) ret[j] = __fdiv_rn(ret_num(j, delta, c), w.s);
      cross[j] = __fdiv_rn(cross_num(j, delta_sq, ssum, c), w.two_s);
    }
  }
  float psurv = 1.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    if (j != 2) psurv = fadd(psurv, expf(fminf(ret[j], 0.0f)));
    psurv = fsub(psurv, expf(fminf(cross[j], 0.0f)));
  }
  return psurv;
}

// log P(no within-step crossing | endpoints live), -inf on a breached
// endpoint. Single barrier: log1p(-min(exp(min(-2 d_old d_new / s, 0)),
// 1 - 1e-7)) (pallas_kernels.py:_svj_stats_kernel surv_inc). Corridor:
// log of corridor_psurv clipped to [1e-7, 1].
template <int MODE>
__device__ __forceinline__ float surv_inc(float x_old, float x_new,
                                          const StepVar& w,
                                          const StatsConsts& c) {
  if (MODE == kCorridor) {
    const float a = fsub(x_old, c.log_l);
    const float b = fsub(x_new, c.log_l);
    const bool dead = a <= 0.0f || a >= c.width || b <= 0.0f || b >= c.width;
    const float delta = fsub(b, a);
    const float ssum = fadd(a, b);
    const bool exact = fabsf(a) < kQuotArg && fabsf(b) < kQuotArg &&
                       fabsf(c.width) < kQuotArg && w.s < kQuotVar;
    const float psurv = corridor_psurv(delta, ssum, w, exact, c);
    return dead ? -CUDART_INF_F : logf(fminf(fmaxf(psurv, 1e-7f), 1.0f));
  }
  const float d_old =
      MODE == kBridgeUp ? fsub(c.log_b, x_old) : fsub(x_old, c.log_b);
  const float d_new =
      MODE == kBridgeUp ? fsub(c.log_b, x_new) : fsub(x_new, c.log_b);
  const bool dead = d_old <= 0.0f || d_new <= 0.0f;
  const float e = __fdiv_rn(fmul(fmul(-2.0f, d_old), d_new), w.s);
  const float p_cross = expf(fminf(e, 0.0f));
  return dead ? -CUDART_INF_F : log1pf(-fminf(p_cross, mcos::kUMax));
}

// The SVJ leg's step variance from max(v, 1e-12).
template <int MODE>
__device__ __forceinline__ StepVar svj_step_var(float var_step,
                                                const StatsConsts& c) {
  StepVar w;
  w.s = fmaxf(fmul(var_step, c.dt), 1e-20f);
  w.two_s = MODE == kCorridor ? fmul(2.0f, w.s) : 0.0f;
  w.rcp = MODE == kCorridor ? __frcp_rn(w.s) : 0.0f;
  w.rcp_two = fmul(0.5f, w.rcp);  // 1 / (2 s), exactly
  return w;
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
                                         bool in_win, Carry<NB>& st) {
  const float dw1 = fmul(z1, c.sqrt_dt);
  const float dw2 =
      fadd(fmul(c.rho, dw1), fmul(fmul(c.rho_perp, z2), c.sqrt_dt));
  const bool jumped = u_jump < c.lam_dt;
  const float jump_body = fmul(c.sig_j, z_js);
  const float cv_dw = fmul(c.sig_cv, dw1);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float s_dw1 = k == 0 ? dw1 : -dw1;
    const float s_dw2 = k == 0 ? dw2 : -dw2;
    const float v_pos = fmaxf(st.v[k], 0.0f);
    const float sqrt_v = sqrtf(v_pos);
    const float jump =
        jumped ? fadd(c.mu_j, k == 0 ? jump_body : -jump_body) : 0.0f;
    const float x_prev = st.ls[k];
    float x = fadd(x_prev, fsub(c.drift_dt, fmul(fmul(0.5f, v_pos), c.dt)));
    x = fadd(x, fmul(sqrt_v, s_dw1));
    x = fadd(x, jump);
    float v_next =
        fadd(v_pos, fmul(fmul(c.kappa, fsub(c.theta, v_pos)), c.dt));
    v_next = fadd(v_next, fmul(fmul(c.xi, sqrt_v), s_dw2));
    st.ls[k] = x;
    st.v[k] = fmaxf(v_next, 0.0f);
    st.sum_s[k] = fadd(st.sum_s[k], expf(x));
    st.sum_l[k] = fadd(st.sum_l[k], x);
    st.max_l[k] = fmaxf(st.max_l[k], x);
    st.min_l[k] = fminf(st.min_l[k], x);
    if (MODE != kNoBridge && in_win) {
      st.surv[k] = fadd(st.surv[k],
                        surv_inc<MODE>(x_prev, x,
                                       svj_step_var<MODE>(
                                           fmaxf(v_pos, 1e-12f), c),
                                       c));
    }
    if (COMP) {
      const float g_prev = st.lg[k];
      const float g =
          fadd(fadd(g_prev, c.g_drift_dt), k == 0 ? cv_dw : -cv_dw);
      st.lg[k] = g;
      st.g_sum_s[k] = fadd(st.g_sum_s[k], expf(g));
      st.g_sum_l[k] = fadd(st.g_sum_l[k], g);
      st.g_max_l[k] = fmaxf(st.g_max_l[k], g);
      st.g_min_l[k] = fminf(st.g_min_l[k], g);
      if (MODE != kNoBridge && in_win) {
        const StepVar w = {c.g_s, c.g_two_s, c.g_rcp, c.g_rcp_two};
        st.g_surv[k] = fadd(st.g_surv[k], surv_inc<MODE>(g_prev, g, w, c));
      }
    }
  }
}

__device__ __forceinline__ float unit(uint32_t bits) {
  return mcos::bits_to_uniform_bitcast(bits);
}

// The Philox key as each mode's loop takes it: the ten round keys from the
// constant bank (PhiloxKeys) in the corridor's long loop; elsewhere the seed
// and the key schedule in every thread, because with round keys from the
// constant bank ptxas splits each Philox product into IMAD.HI and IMAD, and
// the short loops lose more to that than they save.
template <int MODE>
constexpr bool kRoundKeys = MODE == kCorridor;

template <int MODE>
using StatsKey =
    typename std::conditional<kRoundKeys<MODE>, mcos::PhiloxKeys, uint2>::type;

template <int MODE>
StatsKey<MODE> stats_key(unsigned long long seed) {
  if constexpr (kRoundKeys<MODE>) {
    return mcos::philox_round_keys(seed);
  } else {
    return make_uint2(static_cast<uint32_t>(seed),
                      static_cast<uint32_t>(seed >> 32));
  }
}

template <typename Key>
__device__ __forceinline__ uint4 stats_words(uint32_t p_lo, uint32_t p_hi,
                                             int call, const Key& key) {
  return mcos::philox4x32_10(
      make_uint4(p_lo, p_hi, static_cast<uint32_t>(call), mcos::kStatsDomain),
      key);
}

// out is (rows, NB, n) row-major; rows in order: s_final, avg, log_avg,
// max_s, min_s, [log_surv], then with the companion g_final, g_avg,
// g_log_avg, g_max, g_min, [g_log_surv].
template <int NB, int MODE, bool COMP>
__global__ void __launch_bounds__(kThreads)
    svj_stats_kernel(float* __restrict__ out, long long n, int steps, int w0,
                     int w1, StatsKey<MODE> key, StatsConsts c) {
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

  const int n_even = steps & ~1;
  for (int i = 0; i < n_even; i += 2) {
    const uint4 a = stats_words(p_lo, p_hi, i, key);
    const uint4 b = stats_words(p_lo, p_hi, i + 1, key);
    float z_a, z_b, z_c, z_d, z_e, z_f;
    box_muller_sincos(unit(a.x), unit(a.y), z_a, z_b);
    box_muller_sincos(unit(a.z), unit(a.w), z_c, z_d);
    box_muller_sincos(unit(b.x), unit(b.y), z_e, z_f);
    one_step<NB, MODE, COMP>(c, z_a, z_b, z_c, unit(b.z), i >= w0 && i < w1,
                             st);
    one_step<NB, MODE, COMP>(c, z_d, z_e, z_f, unit(b.w),
                             i + 1 >= w0 && i + 1 < w1, st);
  }
  if (steps & 1) {
    const int i = steps - 1;
    const uint4 a = stats_words(p_lo, p_hi, i, key);
    const uint4 b = stats_words(p_lo, p_hi, i + 1, key);
    float z1, z2, z_js, unused;
    box_muller_sincos(unit(a.x), unit(a.y), z1, z2);
    box_muller_sincos(unit(a.z), unit(a.w), z_js, unused);
    one_step<NB, MODE, COMP>(c, z1, z2, z_js, unit(b.x), i >= w0 && i < w1,
                             st);
  }

  constexpr int kLegRows = MODE == kNoBridge ? 5 : 6;
  const float log_spot = logf(c.spot);
  const long long row = static_cast<long long>(NB) * n;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float* o = out + k * n + p;
    o[0 * row] = fmul(c.spot, expf(st.ls[k]));
    o[1 * row] = fmul(c.spot, fmul(st.sum_s[k], c.inv_n));
    o[2 * row] = fadd(log_spot, fmul(st.sum_l[k], c.inv_n));
    o[3 * row] = fmul(c.spot, expf(st.max_l[k]));
    o[4 * row] = fmul(c.spot, expf(st.min_l[k]));
    if (MODE != kNoBridge) o[5 * row] = st.surv[k];
    if (COMP) {
      float* g = o + kLegRows * row;
      g[0 * row] = fmul(c.spot, expf(st.lg[k]));
      g[1 * row] = fmul(c.spot, fmul(st.g_sum_s[k], c.inv_n));
      g[2 * row] = fadd(log_spot, fmul(st.g_sum_l[k], c.inv_n));
      g[3 * row] = fmul(c.spot, expf(st.g_max_l[k]));
      g[4 * row] = fmul(c.spot, expf(st.g_min_l[k]));
      if (MODE != kNoBridge) g[5 * row] = st.g_surv[k];
    }
  }
}

template <int NB, int MODE>
void launch_comp(bool companion, unsigned blocks, cudaStream_t st,
                 float* out, long long n, int steps, int w0, int w1,
                 const StatsKey<MODE>& key, const StatsConsts& c) {
  if (companion) {
    svj_stats_kernel<NB, MODE, true>
        <<<blocks, kThreads, 0, st>>>(out, n, steps, w0, w1, key, c);
  } else {
    svj_stats_kernel<NB, MODE, false>
        <<<blocks, kThreads, 0, st>>>(out, n, steps, w0, w1, key, c);
  }
}

template <int NB>
bool launch_mode(int mode, bool companion, unsigned blocks, cudaStream_t st,
                 float* out, long long n, int steps, int w0, int w1,
                 unsigned long long seed, const StatsConsts& c) {
  switch (mode) {
    case kNoBridge:
      launch_comp<NB, kNoBridge>(companion, blocks, st, out, n, steps, w0,
                                 w1, stats_key<kNoBridge>(seed), c);
      return true;
    case kBridgeUp:
      launch_comp<NB, kBridgeUp>(companion, blocks, st, out, n, steps, w0,
                                 w1, stats_key<kBridgeUp>(seed), c);
      return true;
    case kBridgeDown:
      launch_comp<NB, kBridgeDown>(companion, blocks, st, out, n, steps, w0,
                                   w1, stats_key<kBridgeDown>(seed), c);
      return true;
    case kCorridor:
      launch_comp<NB, kCorridor>(companion, blocks, st, out, n, steps, w0,
                                 w1, stats_key<kCorridor>(seed), c);
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
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool known = false;
  if (n_branch == 2) {
    known = launch_mode<2>(mode, companion != 0, blocks, st, out, n, steps,
                           w0, w1, seed, c);
  } else if (n_branch == 1) {
    known = launch_mode<1>(mode, companion != 0, blocks, st, out, n, steps,
                           w0, w1, seed, c);
  }
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
