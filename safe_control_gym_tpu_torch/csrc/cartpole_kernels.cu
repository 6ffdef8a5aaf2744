// Cartpole kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// K1 cartpole_advance: one control step (n_substeps semi-implicit-Euler
//    updates) for B cartpoles. Replaces the Pallas kernel
//    safe_control_gym_tpu/ops/pallas_kernels.py::cartpole_advance_pallas.
// K4 cartpole_rollout: the whole T-step open-loop rollout (action pipeline,
//    K1's substeps, reward, done, violations, auto-reset) in one launch.
//    Replaces safe_control_gym_tpu/ops/rollout_kernels.py::
//    cartpole_rollout_pallas, open loop and, in policy mode, closed loop with
//    the actor MLP of policy_mlp.cuh choosing each action.
//
// Design. Both are per-env elementwise work along a long serial chain, so
// each thread owns one env and keeps its state in registers: K1 for
// n_substeps, K4 for all T steps (the loop over T replaces the TPU grid
// over steps; nothing is carried between blocks). K1 moves 44 bytes per
// env and is bound by its launch at the batch sizes of the env step; K4
// reads its inputs once and writes its outputs once, and at B=4096 it is
// bound by the latency of the dependent chain (T x n_substeps substeps of
// sin, cos and a reciprocal), not by FLOP/s or bytes. In policy mode the
// actor's float32 products come first in each step (policy_mlp.cuh).
//
// Numerics. Every expression follows the plain PyTorch version
// (ops/physics_kernels.py, ops/rollout_kernels.py) operation for
// operation, and the file is built with --fmad=false and without fast-math
// intrinsics (ops/_build.py), so each float op rounds as PyTorch's own
// elementwise op does.
//
// Launch shape. The wrappers pick the block size so that the grid covers
// every SM (32 threads a block at B=4096 on 132 SMs): with one thread per
// env, a larger block would leave most SMs idle.
//
// Randomness (K4). The Philox4x32-10 of philox.cuh keyed on (seed, 0),
// counter (env, step, j, 0) for j = 0, 1: eight uint32 per env and step, the
// kernel's eight random rows. Row 0 is the action draw, rows 1-2 the
// Box-Muller pair of the action noise, rows 4-7 the fresh auto-reset
// state. In policy mode, where no action is drawn, rows 0 and 3 are the
// Box-Muller pair (cos half) of the exploration noise. The plain version runs
// the same Philox on int64 tensors.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "policy_mlp.cuh"

namespace {

using scg::F_POLICY;
using scg::F_POLICY_RELU;
using scg::F_POLICY_SQUASH;
using scg::F_POLICY_STOCHASTIC;
using scg::kTwoPi;
using scg::standard_normal;
using scg::uniform4;

constexpr float kFourThirds = 1.33333333333333333f;
constexpr float kPi = 3.141592653589793f;
constexpr float kInv2Pi = 0.15915494309189535f;  // float(1 / (2 pi))

// cfg vector layout (ops/rollout_kernels.py _C).
enum {
  POLE_MASS = 0, CART_MASS = 1, POLE_LEN = 2, GRAVITY = 3,
  ACT_LO = 4, ACT_HI = 5, ACT_SCALE = 6, PHYS_LO = 7, PHYS_HI = 8,
  GOAL = 9, TOL_SQ = 13, X_THRESH = 14, TH_THRESH = 15, MAX_STEPS = 16,
  W_ACT = 17, NOISE_STD = 18, INIT_LO = 19, INIT_HI = 23, W_STATE = 27,
  CON_HI = 31, P_STD = 35, U_GOAL = 39, CFG_LEN = 40
};

// Rollout mode flags (ops/rollout_kernels.py _FLAGS).
enum {
  F_DRAW_ACTIONS = 1, F_CONSTRAINED = 2, F_ACTION_NOISE = 4,
  F_RANDOMIZED_RESET = 8, F_REW_EXPONENTIAL = 16, F_DONE_ON_OOB = 32,
  F_TRACKING = 64, F_QUADRATIC_COST = 128
};

// n_substeps semi-implicit-Euler updates of the manipulator-form cartpole
// with a pole-COM tab force (fx, fz); invariants hoisted, one reciprocal
// per substep.
__device__ __forceinline__ void cartpole_substeps(
    float& x, float& xd, float& th, float& thd, float force, float fx,
    float fz, float m, float M, float L, float g, int n_substeps, float dt) {
  const float Mm = m + M;
  const float ml = m * L;
  const float a11 = Mm;
  const float a22 = kFourThirds * m * L * L;
  const float f1 = force + fx;
  const float mgL = m * g * L;
  const float fxL = fx * L;
  const float fzL = fz * L;
  const float a11a22 = a11 * a22;
  for (int i = 0; i < n_substeps; ++i) {
    const float sin_t = sinf(th);
    const float cos_t = cosf(th);
    const float a12 = ml * cos_t;
    const float b1 = f1 + ml * thd * thd * sin_t;
    const float b2 = mgL * sin_t + fxL * cos_t - fzL * sin_t;
    const float inv_det = 1.0f / (a11a22 - a12 * a12);
    const float x_dd = (a22 * b1 - a12 * b2) * inv_det;
    const float th_dd = (a11 * b2 - a12 * b1) * inv_det;
    xd = xd + dt * x_dd;
    thd = thd + dt * th_dd;
    x = x + dt * xd;
    th = th + dt * thd;
  }
}

__global__ void cartpole_advance_kernel(
    const float* __restrict__ states, const float* __restrict__ forces,
    const float* __restrict__ tab, const float* __restrict__ params,
    float* __restrict__ out, int B, int n_substeps, float dt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float x = states[4 * b + 0], xd = states[4 * b + 1];
  float th = states[4 * b + 2], thd = states[4 * b + 3];
  cartpole_substeps(x, xd, th, thd, forces[b], tab[2 * b + 0],
                    tab[2 * b + 1], params[0], params[1], params[2],
                    params[3], n_substeps, dt);
  out[4 * b + 0] = x;
  out[4 * b + 1] = xd;
  out[4 * b + 2] = th;
  out[4 * b + 3] = thd;
}

// ((th + pi) mod 2 pi) - pi with floor semantics, as th - 2pi floor(...).
__device__ __forceinline__ float wrap_angle(float th) {
  return th - kTwoPi * floorf((th + kPi) * kInv2Pi);
}

// POLICY: the policy mode, compiled apart so that the open-loop modes keep
// their own register allocation.
template <bool POLICY>
__global__ void cartpole_rollout_kernel(
    const float* __restrict__ state0, const float* __restrict__ cfg_g,
    const float* __restrict__ actions, const float* __restrict__ x_goal,
    const float* __restrict__ policy_p, float* __restrict__ state_out,
    float* __restrict__ step_out, float* __restrict__ reward_out,
    float* __restrict__ done_out, float* __restrict__ viol_out, int B, int T,
    int n_substeps, float dt, uint32_t seed, int n_goal, int h1, int h2,
    int nu_out, float clip_obs, int flags) {
  extern __shared__ float hidden[];  // policy mode: [h1][blockDim.x]
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c[CFG_LEN];
#pragma unroll
  for (int k = 0; k < CFG_LEN; ++k) c[k] = cfg_g[k];

  const bool draw_actions = flags & F_DRAW_ACTIONS;
  const bool constrained = flags & F_CONSTRAINED;
  const bool action_noise = flags & F_ACTION_NOISE;
  const bool randomized_reset = flags & F_RANDOMIZED_RESET;
  const bool rew_exponential = flags & F_REW_EXPONENTIAL;
  const bool done_on_oob = flags & F_DONE_ON_OOB;
  const bool tracking = flags & F_TRACKING;
  const bool quadratic = flags & F_QUADRATIC_COST;
  const bool policy_stochastic = flags & F_POLICY_STOCHASTIC;
  const bool policy_squash = flags & F_POLICY_SQUASH;
  const scg::PolicyMLP mlp{policy_p, h1, h2, nu_out, clip_obs,
                           (flags & F_POLICY_RELU) != 0};
  float* hid = hidden + threadIdx.x;

  float x = state0[4 * b + 0], xd = state0[4 * b + 1];
  float th = state0[4 * b + 2], thd = state0[4 * b + 3];
  int step = 0;
  float reward_sum = 0.0f;
  int done_count = 0, viol_count = 0;

  for (int t = 0; t < T; ++t) {
    float rnd[8];
    if (draw_actions || action_noise || (POLICY && policy_stochastic)) {
      uniform4(seed, b, t, 0u, rnd);
    }
    if (randomized_reset) uniform4(seed, b, t, 1u, rnd + 4);

    // Action pipeline: raw -> physical -> noisy -> clipped.
    float raw;
    if constexpr (POLICY) {
      // The actor on the state at the start of the step, exploration noise
      // from rows 0 and 3, then the squash.
      const float s[4] = {x, xd, th, thd};
      float mu[1];
      scg::policy_mean<4, 1>(mlp, s, hid, blockDim.x, mu);
      raw = mu[0];
      if (policy_stochastic) raw = raw + c[P_STD] * standard_normal(rnd[0], rnd[3]);
      if (policy_squash) raw = tanhf(raw);
    } else {
      raw = draw_actions ? c[ACT_LO] + rnd[0] * (c[ACT_HI] - c[ACT_LO])
                         : actions[(size_t)t * B + b];
    }
    const float phys = raw * c[ACT_SCALE];
    float noisy = phys;
    if (action_noise) noisy = phys + c[NOISE_STD] * standard_normal(rnd[1], rnd[2]);
    const float force = fminf(fmaxf(noisy, c[PHYS_LO]), c[PHYS_HI]);

    cartpole_substeps(x, xd, th, thd, force, 0.0f, 0.0f, c[POLE_MASS],
                      c[CART_MASS], c[POLE_LEN], c[GRAVITY], n_substeps, dt);

    // Goal: constant, or this env's own waypoint X_GOAL[step + 1]
    // (X_GOAL[step] under the quadratic cost).
    float g0 = c[GOAL + 0], g1 = c[GOAL + 1], g2 = c[GOAL + 2], g3 = c[GOAL + 3];
    if (tracking) {
      const int idx = min(step + (quadratic ? 0 : 1), n_goal - 1);
      g0 = x_goal[4 * idx + 0];
      g1 = x_goal[4 * idx + 1];
      g2 = x_goal[4 * idx + 2];
      g3 = x_goal[4 * idx + 3];
    }
    const float e0 = x - g0, e1 = xd - g1, e3 = thd - g3;
    float rew;
    if (quadratic) {
      // Unwrapped angle, clipped action against U_GOAL, never exponential.
      const float e2q = th - g2;
      const float du = force - c[U_GOAL];
      rew = -(c[W_STATE + 0] * e0 * e0 + c[W_STATE + 1] * e1 * e1
              + c[W_STATE + 2] * e2q * e2q + c[W_STATE + 3] * e3 * e3
              + c[W_ACT] * du * du);
    } else {
      // Wrapped angle and the noisy action.
      const float ew = wrap_angle(th) - g2;
      const float dist = c[W_STATE + 0] * e0 * e0 + c[W_STATE + 1] * e1 * e1
          + c[W_STATE + 2] * ew * ew + c[W_STATE + 3] * e3 * e3
          + c[W_ACT] * noisy * noisy;
      rew = rew_exponential ? expf(-dist) : -dist;
    }

    // Done: goal (stabilization only, unwrapped), out of bounds, time limit.
    bool done = false;
    if (!tracking) {
      const float e2 = th - c[GOAL + 2];
      done = e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3 < c[TOL_SQ];
    }
    if (done_on_oob) {
      done = done || fabsf(x) > c[X_THRESH] || fabsf(th) > c[TH_THRESH];
    }
    const int new_step = step + 1;
    done = done || (float)new_step >= c[MAX_STEPS];

    // Default state box and input box, on the noisy pre-clip action.
    if (constrained) {
      const bool viol = fabsf(x) > c[CON_HI + 0] || fabsf(xd) > c[CON_HI + 1]
          || fabsf(th) > c[CON_HI + 2] || fabsf(thd) > c[CON_HI + 3]
          || noisy > c[PHYS_HI] || noisy < c[PHYS_LO];
      viol_count += viol;
    }

    // Auto-reset: fresh states are drawn every step, selected where done.
    if (done) {
      if (randomized_reset) {
        x = c[INIT_LO + 0] + rnd[4] * (c[INIT_HI + 0] - c[INIT_LO + 0]);
        xd = c[INIT_LO + 1] + rnd[5] * (c[INIT_HI + 1] - c[INIT_LO + 1]);
        th = c[INIT_LO + 2] + rnd[6] * (c[INIT_HI + 2] - c[INIT_LO + 2]);
        thd = c[INIT_LO + 3] + rnd[7] * (c[INIT_HI + 3] - c[INIT_LO + 3]);
      } else {
        x = c[INIT_LO + 0];
        xd = c[INIT_LO + 1];
        th = c[INIT_LO + 2];
        thd = c[INIT_LO + 3];
      }
    }
    step = done ? 0 : new_step;
    reward_sum += rew;
    done_count += done;
  }
  state_out[4 * b + 0] = x;
  state_out[4 * b + 1] = xd;
  state_out[4 * b + 2] = th;
  state_out[4 * b + 3] = thd;
  step_out[b] = (float)step;
  reward_out[b] = reward_sum;
  done_out[b] = (float)done_count;
  viol_out[b] = (float)viol_count;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. Every entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).
// ---------------------------------------------------------------------------

extern "C" {

const char* scg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int scg_cartpole_advance(const void* states, const void* forces,
                         const void* tab, const void* params, void* out,
                         int B, int n_substeps, float dt, int threads,
                         void* stream) {
  if (B > 0) {
    cartpole_advance_kernel<<<(B + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
        (const float*)states, (const float*)forces, (const float*)tab,
        (const float*)params, (float*)out, B, n_substeps, dt);
  }
  return (int)cudaGetLastError();
}

// policy: the packed actor (ops/rollout_kernels.py pack_policy_params) with
// widths h1, h2, nu_out, read when flags has F_POLICY.
int scg_cartpole_rollout(const void* state0, const void* cfg,
                         const void* actions, const void* x_goal,
                         const void* policy, void* state_out, void* step_out,
                         void* reward_out, void* done_out, void* viol_out, int B,
                         int T, int n_substeps, float dt, unsigned int seed,
                         int n_goal, int h1, int h2, int nu_out, float clip_obs,
                         int flags, int threads, void* stream) {
  if (B > 0) {
    auto kernel = (flags & F_POLICY) ? cartpole_rollout_kernel<true>
                                     : cartpole_rollout_kernel<false>;
    const size_t smem = scg::policy_smem(flags, h1, threads);
    kernel<<<(B + threads - 1) / threads, threads, smem, (cudaStream_t)stream>>>(
        (const float*)state0, (const float*)cfg, (const float*)actions,
        (const float*)x_goal, (const float*)policy, (float*)state_out,
        (float*)step_out, (float*)reward_out, (float*)done_out, (float*)viol_out,
        B, T, n_substeps, dt, seed, n_goal, h1, h2, nu_out, clip_obs, flags);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
