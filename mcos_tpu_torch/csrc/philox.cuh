// Philox4x32-10 counter-based generator and the bits-to-uniform map shared
// by the port's kernels.
//
// The constants are those of PyTorch's ATen/core/PhiloxRNGEngine.h
// (kPhilox10A/B, kPhiloxSA/SB); that header is not included, so the sources
// build with nvcc alone. mcos_tpu_torch/ops/cuda_kernels.py:philox4x32_10 is
// the same generator on int64 tensors: the CPU tests and the on-card checks
// compare the two word for word.
#pragma once

#include <cstdint>

namespace mcos {

constexpr uint32_t kPhilox10A = 0x9E3779B9u;
constexpr uint32_t kPhilox10B = 0xBB67AE85u;
constexpr uint32_t kPhiloxSA = 0xD2511F53u;
constexpr uint32_t kPhiloxSB = 0xCD9E8D57u;

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

// Top 23 bits plus half an ulp: u = ((bits >> 9) + 0.5) * 2^-23, strictly
// inside (0, 1) and exact in float32 (mcos_tpu/ops/pallas_kernels.py:
// _bits_to_uniform).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return (static_cast<float>(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int lane) {
  return lane == 0 ? w.x : lane == 1 ? w.y : lane == 2 ? w.z : w.w;
}

}  // namespace mcos
