// Device helpers shared by the port's kernels: the Philox4x32-10
// counter-based generator, the bits-to-uniform map, Box-Muller, the
// inverse-CDF jump count over a host table, Acklam's inverse normal CDF and
// the QE kernels' launch scalars.
//
// The Philox constants are those of PyTorch's ATen/core/PhiloxRNGEngine.h
// (kPhilox10A/B, kPhiloxSA/SB); that header is not included, so the sources
// build with nvcc alone. mcos_tpu_torch/ops/cuda_kernels.py holds the same
// helpers on torch tensors (philox4x32_10, bits_to_uniform, box_muller,
// count_from_table), with ops/sobol.py:ndtri_acklam; the CPU tests and the
// on-card checks compare the two.
//
// Rounding against the plain versions. A QE transition's branch selects
// (psi <= 1.5, u <= p) are not continuous in v, so a one-ulp difference in
// v could send a path down the other branch. Each QE kernel keeps its own
// transition beside its plain version's (K4: svj_qe.cu:qe_step and
// cuda_kernels.py:_qe_step_folded; K5: svj_qe_draws.cu:qe_step_lazy and
// ops/simulate.py:qe_variance_step), and those and the helpers on the
// variance path repeat the plain version's IEEE operations one for one:
//   - the transitions and box_muller multiply and add with
//     __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA (nor into
//     the inlined sinf/cosf/logf);
//   - acklam_ndtri rounds each Horner step once, in double, where the float
//     product is exact; that is the plain version's float64 (a*x + c).
//     K5 (svj_qe_draws.cu:acklam_converged) takes one float FMA a step
//     instead, which gives the same inverse at every float32 in (0, 1)
//     (kernel_lab's probe holds it against acklam_ndtri over all of them).
// K3, K4 and K6-K11 write every operation on their carries the same way
// (K6: dead-or-alive selects on the log-spot carry; K7-K11: hundreds of
// dependent steps; K3, K4: to be held bit for bit). In K1's and K5's
// Euler updates nvcc contracts freely, and those kernels differ from the
// plain versions by FMA rounding (K2 takes the hardware's approximate
// log2, rsqrt and sincos, gbm.cu: its only consumer is a continuous sum).
#pragma once

#include <cstdint>
#include <type_traits>

namespace mcos {

constexpr uint32_t kPhilox10A = 0x9E3779B9u;
constexpr uint32_t kPhilox10B = 0xBB67AE85u;
constexpr uint32_t kPhiloxSA = 0xD2511F53u;
constexpr uint32_t kPhiloxSB = 0xCD9E8D57u;

// Philox counter domains (word 3 of the counter), one per stream, so that
// two kernels given the same seed draw independent words.
constexpr uint32_t kJumpDomain = 0u;   // K1/K5 per-step jump uniforms
constexpr uint32_t kGbmDomain = 1u;    // K2
constexpr uint32_t kSvjDomain = 2u;    // K3
constexpr uint32_t kQeDomain = 3u;     // K4
constexpr uint32_t kStatsDomain = 4u;  // K6
constexpr uint32_t kHhwDomain = 5u;    // K7
constexpr uint32_t kSvcjDomain = 6u;   // K8
constexpr uint32_t kTdDomain = 7u;     // K9
constexpr uint32_t kRoughDomain = 8u;  // K10
constexpr uint32_t kRoughStatsDomain = 9u;  // K11

// IEEE float32 multiply, add and subtract that nvcc never contracts into an
// FMA. K3, K4 and K6-K11 write every operation on their carries with
// these, in their plain versions' order, so on the card kernel and plain
// version agree bit for bit at any step count.
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
  const uint32_t hi0 = __umulhi(kPhiloxSA, c.x);
  const uint32_t lo0 = kPhiloxSA * c.x;
  const uint32_t hi1 = __umulhi(kPhiloxSB, c.z);
  const uint32_t lo1 = kPhiloxSB * c.z;
  return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

// Ten rounds; the key is bumped after each of the first nine.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    ctr = philox_round(ctr, key);
    key.x += kPhilox10A;
    key.y += kPhilox10B;
  }
  return philox_round(ctr, key);
}

// The ten round keys of a seed (key + i (kPhilox10A, kPhilox10B) mod 2^32),
// made once on the host and passed to a kernel by value, so they sit in the
// constant bank and each round's xor reads its key from there instead of
// re-running the key schedule in every thread. K2-K5, K7, K9-K11 and
// K6's corridor use them.
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

inline PhiloxKeys philox_round_keys(unsigned long long seed) {
  PhiloxKeys keys;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  for (int i = 0; i < 10; ++i) {
    keys.k0[i] = k0;
    keys.k1[i] = k1;
    k0 += kPhilox10A;
    k1 += kPhilox10B;
  }
  return keys;
}

// The key a kernel takes, made on the host from the seed: the round keys
// (Key = PhiloxKeys) or the seed's two words (Key = uint2), for a kernel
// that chooses by a type alias (K3, K4, K5, K7).
template <typename Key>
Key philox_key(unsigned long long seed) {
  if constexpr (std::is_same<Key, PhiloxKeys>::value) {
    return philox_round_keys(seed);
  } else {
    return make_uint2(static_cast<uint32_t>(seed),
                      static_cast<uint32_t>(seed >> 32));
  }
}

// philox4x32_10 with the round keys precomputed: the same words.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr,
                                               const PhiloxKeys& keys) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    ctr = philox_round(ctr, make_uint2(keys.k0[i], keys.k1[i]));
  }
  return ctr;
}

// Top 23 bits plus half an ulp: u = ((bits >> 9) + 0.5) * 2^-23, strictly
// inside (0, 1) and exact in float32 (mcos_tpu/ops/pallas_kernels.py:
// _bits_to_uniform).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return (static_cast<float>(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;
}

// The same value as bits_to_uniform, bit for bit, with no integer-to-float
// conversion (I2F runs on a slower pipe than FADD): the top 23 bits become
// the mantissa of a float in [1, 2), and subtracting float32(1 - 2^-24)
// leaves (m + 1/2) 2^-23. The subtraction is exact (Sterbenz: the operands
// are within a factor 2), so no rounding differs. K1-K11 use it (the
// kernel_lab levers that take it out put bits_to_uniform back).
__device__ __forceinline__ float bits_to_uniform_bitcast(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3f800000u) -
         __uint_as_float(0x3f7fffffu);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int lane) {
  return lane == 0 ? w.x : lane == 1 ? w.y : lane == 2 ? w.z : w.w;
}

// 2*pi rounded to float32 (6.2831855f).
constexpr float kTwoPi = 6.28318530717958647692f;

// Two independent standard normals from two uniforms in (0, 1):
// za = r cos(2 pi u2), zb = r sin(2 pi u2), r = sqrt(-2 log u1).
__device__ __forceinline__ void box_muller(float u1, float u2, float& za,
                                           float& zb) {
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float ang = __fmul_rn(kTwoPi, u2);
  za = __fmul_rn(rad, cosf(ang));
  zb = __fmul_rn(rad, sinf(ang));
}

// box_muller with one shared range reduction for the sine and the cosine:
// sincosf gives the bits of sinf and cosf (held over every uniform of the
// grid by tests/test_torch_cuda.py), so the normals are box_muller's bit
// for bit. K3, K4 and K6-K11 use it (box_muller is what kernel_lab's
// levers put back in its place).
__device__ __forceinline__ void box_muller_sincos(float u1, float u2,
                                                  float& za, float& zb) {
  const float rad = sqrtf(fmul(-2.0f, logf(u1)));
  float s, c;
  sincosf(fmul(kTwoPi, u2), &s, &c);
  za = fmul(rad, c);
  zb = fmul(rad, s);
}

// Jump count by inverse CDF: the number of entries of the nondecreasing
// table cdf[0..k) that lie below u, i.e. sum_k 1{u > cdf_k}
// (pallas_kernels.py:_count_from_u). The scan stops at the first entry
// >= u, so it costs the count plus one compare.
__device__ __forceinline__ int count_from_table(const double* __restrict__ cdf,
                                                int k, float u) {
  const double ud = static_cast<double>(u);
  int n = 0;
  while (n < k && __ldg(cdf + n) < ud) ++n;
  return n;
}

// One Horner step a*x + c rounded once: the float product is exact in
// double, so the double FMA rounds only the sum, as the plain version's
// float64 a*x + c does; then once more to float.
__device__ __forceinline__ float horner_step(float acc, float x, float c) {
  return static_cast<float>(fma(static_cast<double>(acc),
                                static_cast<double>(x),
                                static_cast<double>(c)));
}

// Acklam's rational approximation of the inverse normal CDF for u strictly
// inside (0, 1) (pallas_kernels.py:_ndtri_kernel; the constants of _ACK_*).
__device__ __forceinline__ float acklam_ndtri(float u) {
  const float qc = u - 0.5f;
  if (fabsf(qc) <= 0.47575f) {  // float32(0.5 - 0.02425): central region
    const float r = qc * qc;
    float num = -3.969683028665376e+01f;
    num = horner_step(num, r, 2.209460984245205e+02f);
    num = horner_step(num, r, -2.759285104469687e+02f);
    num = horner_step(num, r, 1.383577518672690e+02f);
    num = horner_step(num, r, -3.066479806614716e+01f);
    num = horner_step(num, r, 2.506628277459239e+00f);
    float den = -5.447609879822406e+01f;
    den = horner_step(den, r, 1.615858368580409e+02f);
    den = horner_step(den, r, -1.556989798598866e+02f);
    den = horner_step(den, r, 6.680131188771972e+01f);
    den = horner_step(den, r, -1.328068155288572e+01f);
    return (num * qc) / horner_step(den, r, 1.0f);
  }
  const float pm = fminf(u, 1.0f - u);
  const float qt = sqrtf(-2.0f * logf(pm));
  float num = -7.784894002430293e-03f;
  num = horner_step(num, qt, -3.223964580411365e-01f);
  num = horner_step(num, qt, -2.400758277161838e+00f);
  num = horner_step(num, qt, -2.549732539343734e+00f);
  num = horner_step(num, qt, 4.374664141464968e+00f);
  num = horner_step(num, qt, 2.938163982698783e+00f);
  float den = 7.784695709041462e-03f;
  den = horner_step(den, qt, 3.224671290700398e-01f);
  den = horner_step(den, qt, 2.445134137142996e+00f);
  den = horner_step(den, qt, 3.754408661907416e+00f);
  const float x_tail = num / horner_step(den, qt, 1.0f);
  return qc < 0.0f ? x_tail : -x_tail;
}

// Per-launch QE scalars, computed on the host in float32 in the order and
// arithmetic of mcos_tpu/ops/pallas_kernels.py:_pack_qe_params
// (cuda_kernels.py:_qe_consts).
struct QeConsts {
  float spot, v0, theta, e_kdt, var1, var2, k0, k1, k2, k34, drift_dt, lam_dt,
      mu_j, sig_j, g_drift_dt, sig_cv, sqrt_dt;
};
static_assert(sizeof(QeConsts) == 17 * sizeof(float), "packed");

// float32(1 - 1e-7): the upper clip of the exponential branch's uniform.
constexpr float kUMax = 0.99999988079071044921875f;

}  // namespace mcos
