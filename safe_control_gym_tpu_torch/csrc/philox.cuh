// Counter-based random numbers for the rollout kernels (K4 in
// cartpole_kernels.cu, K5 in quad_kernels.cu).
//
// A Philox4x32-10 (Salmon et al., SC'11) keyed on (seed, 0) with the counter
// (env, step, j, 0) gives each env four uint32 words per control step and
// counter word j; a uniform is the high 24 bits of a word times 2^-24. Each
// kernel documents its own j layout. The plain PyTorch versions
// (ops/rollout_kernels.py) run the same generator on int64 tensors and the
// same float operations, so kernel and plain version draw identical numbers.

#pragma once

#include <cstdint>

namespace scg {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTwoPow24Inv = 5.9604644775390625e-08f;  // 2^-24

// Philox4x32-10, in place on the counter.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Four U[0, 1) floats from the high 24 bits of each Philox word of the
// counter (env, step, j, 0) under the key (seed, 0).
__device__ __forceinline__ void uniform4(uint32_t seed, uint32_t env,
                                         uint32_t step, uint32_t j,
                                         float* u) {
  uint32_t c[4] = {env, step, j, 0u};
  philox4x32_10(c, seed, 0u);
  for (int k = 0; k < 4; ++k) u[k] = (float)(c[k] >> 8) * kTwoPow24Inv;
}

// Box-Muller radius of the uniform u1.
__device__ __forceinline__ float box_muller_radius(float u1) {
  return sqrtf(-2.0f * logf(fmaxf(u1, 1e-12f)));
}

// Box-Muller, cos half only: two uniforms -> one standard normal.
__device__ __forceinline__ float standard_normal(float u1, float u2) {
  return box_muller_radius(u1) * cosf(kTwoPi * u2);
}

// Box-Muller, both halves: two uniforms -> two independent standard normals.
__device__ __forceinline__ void standard_normal_pair(float u1, float u2,
                                                     float& n_cos,
                                                     float& n_sin) {
  const float r = box_muller_radius(u1);
  const float a = kTwoPi * u2;
  n_cos = r * cosf(a);
  n_sin = r * sinf(a);
}

}  // namespace scg
