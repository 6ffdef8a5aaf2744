// The actor MLP of the rollout kernels' policy mode (K4 in
// cartpole_kernels.cu, K5 in quad_kernels.cu). Replaces _mlp_fwd and
// _policy_mean of safe_control_gym_tpu/ops/rollout_kernels.py, which ran the
// actor as three MXU dots on the TPU's (rows, B) lane layout.
//
// What it computes, per env and control step, from the state s at the start
// of the step:
//   obs = clip((s - nmean) * ninv, -clip_obs, clip_obs)
//   h1  = act(W1^T obs + b1)        act = tanh or relu
//   h2  = act(W2^T h1 + b2)
//   mu  = W3^T h2 + b3              (only the first nu of nu_out rows)
// The weights are one float32 buffer [nmean (nx), ninv (nx), W1 (nx, H1),
// b1 (H1), W2 (H1, H2), b2 (H2), W3 (H2, nu_out), b3 (nu_out)], in-major, so
// W[k][j] is at k * n_out + j.
//
// Design. One thread per env, as in the rest of the rollout, and one warp a
// block (ops/rollout_kernels.py _policy_launch; at B = 4096 that is one warp
// per SM). h1 lives in shared memory as [unit][thread] (H1 x 32 floats,
// dynamic; 32 KB at H1 = 256, and H1 is at most 384 so that it stays within
// the 48 KB a launch gets without opting in), so that a warp's 32 accesses to
// one unit fall in 32 banks; h2 is never stored: each h2 unit is folded into
// mu as soon as it is computed. The weights are read from global memory
// through the read-only path; every thread of a warp reads the same address,
// one broadcast per load, and the whole actor (284 KB at 12 -> 256 -> 256 ->
// 8) stays in L2. Eight output units are accumulated at a time (eight
// independent add chains, one shared-memory load of an input for eight
// products), so H1 and H2 are multiples of 8. At H = 256 the MLP is about
// 139k flop per env-step against about 2k of physics, so its bound is the
// float32 operations. Measured on an H100, the kernel reaches about 1% of
// that bound: with one warp per SM, the weight loads of successive inputs do
// not overlap, and each group of eight products waits on a memory round trip.
//
// Numerics. Full float32, no tensor cores. Each unit is accumulated from 0.0
// in ascending input order, one multiply and one add at a time (the file is
// built with --fmad=false), then the bias is added and the activation taken:
// the order of the plain version in ops/rollout_kernels.py
// (policy_mean_plain), so both give the same floats.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace scg {

// Mode bits of the policy mode in the kernels' flags (ops/rollout_kernels.py _FLAGS).
enum {
  F_POLICY = 256, F_POLICY_STOCHASTIC = 512, F_POLICY_SQUASH = 1024,
  F_POLICY_RELU = 2048
};

struct PolicyMLP {
  const float* p;  // the packed buffer
  int h1, h2, nu_out;
  float clip_obs;
  bool relu;
};

__device__ __forceinline__ float policy_act(float x, bool relu) {
  return relu ? fmaxf(x, 0.0f) : tanhf(x);
}

// Hidden units computed at a time; H1 and H2 are multiples of it.
constexpr int kTile = 8;

// Layer 1, units [j, j + kTile): h1 = act(W1^T obs + b1) into shared memory.
template <int NX>
__device__ __forceinline__ void policy_layer1(const PolicyMLP& m, const float (&obs)[NX],
                                              const float* __restrict__ w1,
                                              const float* __restrict__ b1, float* hid,
                                              int stride, int j) {
  float acc[kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u) acc[u] = 0.0f;
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const float* row = w1 + (size_t)k * m.h1 + j;
#pragma unroll
    for (int u = 0; u < kTile; ++u) acc[u] = acc[u] + obs[k] * __ldg(row + u);
  }
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
    hid[(size_t)(j + u) * stride] = policy_act(acc[u] + __ldg(b1 + j + u), m.relu);
  }
}

// Layers 2 and 3, h2 units [j, j + kTile): each h2 unit is computed from h1
// in shared memory and folded into mu at once (ascending j, as the plain
// version's last layer sums).
template <int NU>
__device__ __forceinline__ void policy_layer23(const PolicyMLP& m,
                                               const float* __restrict__ w2,
                                               const float* __restrict__ b2,
                                               const float* __restrict__ w3,
                                               const float* hid, int stride, int j,
                                               float (&mu)[NU]) {
  float acc[kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u) acc[u] = 0.0f;
  // H1 is a multiple of kTile (8), so this unroll leaves no remainder loop.
  // The compiler's own choice, 4, ran the 2D quad's policy mode at about
  // half the speed on an H100, and the others no faster (PERF.md).
#pragma unroll 8
  for (int k = 0; k < m.h1; ++k) {
    const float hk = hid[(size_t)k * stride];
    const float* row = w2 + (size_t)k * m.h2 + j;
#pragma unroll
    for (int u = 0; u < kTile; ++u) acc[u] = acc[u] + hk * __ldg(row + u);
  }
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
    const float h = policy_act(acc[u] + __ldg(b2 + j + u), m.relu);
    const float* w3row = w3 + (size_t)(j + u) * m.nu_out;
#pragma unroll
    for (int d = 0; d < NU; ++d) mu[d] = mu[d] + h * __ldg(w3row + d);
  }
}

// The actor's first NU outputs on the state s. ``hid`` is this thread's
// column of the block's [H1][blockDim] shared buffer, ``stride`` = blockDim.
template <int NX, int NU>
__device__ __forceinline__ void policy_mean(const PolicyMLP& m, const float (&s)[NX],
                                         float* hid, int stride, float (&mu)[NU]) {
  const float* nmean = m.p;
  const float* ninv = m.p + NX;
  const float* w1 = m.p + 2 * NX;
  const float* b1 = w1 + (size_t)NX * m.h1;
  const float* w2 = b1 + m.h1;
  const float* b2 = w2 + (size_t)m.h1 * m.h2;
  const float* w3 = b2 + m.h2;
  const float* b3 = w3 + (size_t)m.h2 * m.nu_out;

  float obs[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    obs[k] = fminf(fmaxf((s[k] - __ldg(nmean + k)) * __ldg(ninv + k), -m.clip_obs),
                   m.clip_obs);
  }
  for (int j = 0; j < m.h1; j += kTile) policy_layer1(m, obs, w1, b1, hid, stride, j);

#pragma unroll
  for (int d = 0; d < NU; ++d) mu[d] = 0.0f;
  for (int j = 0; j < m.h2; j += kTile) policy_layer23(m, w2, b2, w3, hid, stride, j, mu);
#pragma unroll
  for (int d = 0; d < NU; ++d) mu[d] = mu[d] + __ldg(b3 + d);
}

// Dynamic shared memory of a launch: h1 floats per thread in policy mode.
inline size_t policy_smem(int flags, int h1, int threads) {
  return (flags & F_POLICY) ? (size_t)h1 * threads * sizeof(float) : 0;
}

}  // namespace scg
