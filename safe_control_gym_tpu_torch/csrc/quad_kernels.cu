// Quadrotor kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// K2 quad2d_advance: one control step (n_substeps semi-implicit-Euler
//    updates) for B planar quadrotors. Replaces the Pallas kernel
//    safe_control_gym_tpu/ops/pallas_kernels.py::quad2d_advance_pallas.
// K3 quad3d_advance: the same for B 12-state rigid bodies. Replaces
//    pallas_kernels.py::quad3d_advance_pallas.
// K5 quad_rollout<QT>: the whole T-step open-loop 2D (QT=2) or 3D (QT=3)
//    rollout (action pipeline, motor model, K2's or K3's substeps, reward
//    on state and action error, done, violations, auto-reset) in one
//    launch. Replaces safe_control_gym_tpu/ops/rollout_kernels.py::
//    _quad_rollout_pallas, open loop and, in policy mode, closed loop with
//    the actor MLP of policy_mlp.cuh choosing each action.
//
// Design. All three are per-env elementwise work along a serial chain, so
// each thread owns one env and keeps its state in registers: K2 and K3 for
// n_substeps, K5 for all T steps (the loop over T replaces the TPU grid over
// steps; nothing is carried between blocks). K5 is templated on the quad
// type, so nx and nu are compile-time and the state arrays unroll into
// registers; its cfg vector sits in shared memory, read at one address by
// every thread. K2 moves 64 bytes per env and K3 128; both are bound by
// their launch at the env step's batch sizes. K5 reads its inputs once and
// writes its outputs once; at B=4096 it is bound by the latency of the
// dependent chain (T x n_substeps substeps of one sin/cos pair in 2D, three
// pairs and three divides in 3D), not by FLOP/s or bytes. In policy mode the
// actor's float32 products come first in each step (policy_mlp.cuh).
//
// Numerics. Every expression follows the plain PyTorch version
// (ops/physics_kernels.py, ops/rollout_kernels.py) operation for
// operation, and the file is built with --fmad=false and without fast-math
// intrinsics (ops/_build.py), so each float op rounds as PyTorch's own
// elementwise op does.
//
// Randomness (K5). The Philox4x32-10 of philox.cuh keyed on (seed, 0) with
// the counter (env, step, j, 0); each j gives four uint32 words:
//   j = 0     the nu action draws (draw_actions);
//   j = 1     the nu noise uniforms, in pairs (u1, u2), each pair giving a
//             cos and a sin Box-Muller normal (action_noise);
//   j = 2     the policy mode's exploration noise, paired as for j = 1
//             (policy_stochastic);
//   j = 3..5  the nx words of a fresh auto-reset state (randomized_reset),
//             drawn only for an env that is done at that step.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "policy_mlp.cuh"

namespace {

using scg::F_POLICY;
using scg::F_POLICY_RELU;
using scg::F_POLICY_SQUASH;
using scg::F_POLICY_STOCHASTIC;
using scg::standard_normal_pair;
using scg::uniform4;

constexpr float kSqrt2 = 1.41421356237309515f;  // float32(sqrt(2))

// cfg vector layout (ops/rollout_kernels.py _Q), sized for the 3D case; the
// 2D kernel reads the first nx / nu entries of each group.
enum {
  MASS = 0, IXX = 1, IYY = 2, IZZ = 3, ARM_L = 4, GRAVITY = 5, KF = 6,
  KM = 7, PWM_SCALE = 8, PWM_CONST = 9, PWM_MIN = 10, PWM_MAX = 11,
  ACT_LO = 12, ACT_HI = 13, DEN_A = 14, DEN_B = 15, PHYS_LO = 16,
  PHYS_HI = 17, GOAL = 18, TOL_SQ = 30, MAX_STEPS = 31, U_GOAL = 32,
  W_ACT = 36, NOISE_STD = 40, W_STATE = 41, INIT_LO = 53, INIT_HI = 65,
  CON_LO = 77, CON_HI = 89, P_STD = 101, QUAD_CFG_LEN = 105
};

// Rollout mode flags (ops/rollout_kernels.py _FLAGS).
enum {
  F_DRAW_ACTIONS = 1, F_CONSTRAINED = 2, F_ACTION_NOISE = 4,
  F_RANDOMIZED_RESET = 8, F_REW_EXPONENTIAL = 16, F_DONE_ON_OOB = 32,
  F_TRACKING = 64, F_QUADRATIC_COST = 128
};

// n_substeps semi-implicit-Euler updates of the planar quadrotor with the
// rotor-pair thrusts and the world force held; the angular acceleration is
// constant over the step, so every divide is hoisted.
__device__ __forceinline__ void quad2d_substeps(
    float& x, float& xd, float& z, float& zd, float& th, float& thd, float T1,
    float T2, float fx, float fz, float m, float Iyy, float L, float g,
    int n_substeps, float dt) {
  const float th_dd = L * (T2 - T1) / Iyy / kSqrt2;
  const float inv_m = 1.0f / m;
  const float tom = (T1 + T2) * inv_m;
  const float fxm = fx * inv_m;
  const float fzm_g = fz * inv_m - g;
  for (int i = 0; i < n_substeps; ++i) {
    const float sin_t = sinf(th);
    const float cos_t = cosf(th);
    const float x_dd = sin_t * tom + fxm;
    const float z_dd = cos_t * tom + fzm_g;
    xd = xd + dt * x_dd;
    zd = zd + dt * z_dd;
    thd = thd + dt * th_dd;
    x = x + dt * xd;
    z = z + dt * zd;
    th = th + dt * thd;
  }
}

// n_substeps semi-implicit-Euler updates of the 12-state rigid body
// [x, xd, y, yd, z, zd, phi, theta, psi, p, q, r]: thrust along the third
// column of Rz(psi) Ry(theta) Rx(phi), diagonal-inertia Euler equations,
// Euler angles advanced with W(old angles) times the new body rates.
__device__ __forceinline__ void quad3d_substeps(
    float (&s)[12], float f0, float f1, float f2, float f3, float zt,
    float fx, float fy, float fz, float m, float Ixx, float Iyy, float Izz,
    float L, float g, int n_substeps, float dt) {
  float x = s[0], xd = s[1], y = s[2], yd = s[3], z = s[4], zd = s[5];
  float phi = s[6], th = s[7], psi = s[8], p = s[9], q = s[10], r = s[11];
  const float total = f0 + f1 + f2 + f3;
  const float l_sq2 = L / kSqrt2;
  const float Mx = l_sq2 * (f0 + f1 - f2 - f3);
  const float My = l_sq2 * (-f0 + f1 + f2 - f3);
  const float inv_m = 1.0f / m;
  const float tom = total * inv_m;
  const float fxm = fx * inv_m;
  const float fym = fy * inv_m;
  const float fzm_g = fz * inv_m - g;
  const float c_p = (Izz - Iyy) / Ixx;
  const float c_q = (Ixx - Izz) / Iyy;
  const float c_r = (Iyy - Ixx) / Izz;
  const float Mx_I = Mx / Ixx;
  const float My_I = My / Iyy;
  const float zt_I = zt / Izz;
  for (int i = 0; i < n_substeps; ++i) {
    const float sphi = sinf(phi), cphi = cosf(phi);
    const float sth = sinf(th), cth = cosf(th);
    const float spsi = sinf(psi), cpsi = cosf(psi);
    const float x_dd = (cphi * sth * cpsi + sphi * spsi) * tom + fxm;
    const float y_dd = (cphi * sth * spsi - sphi * cpsi) * tom + fym;
    const float z_dd = cphi * cth * tom + fzm_g;
    const float p_d = Mx_I - q * r * c_p;
    const float q_d = My_I - p * r * c_q;
    const float r_d = zt_I - p * q * c_r;
    xd = xd + dt * x_dd;
    yd = yd + dt * y_dd;
    zd = zd + dt * z_dd;
    p = p + dt * p_d;
    q = q + dt * q_d;
    r = r + dt * r_d;
    x = x + dt * xd;
    y = y + dt * yd;
    z = z + dt * zd;
    const float tth = sth / cth;
    const float phi_d = p + sphi * tth * q + cphi * tth * r;
    const float th_d = cphi * q - sphi * r;
    const float psi_d = sphi / cth * q + cphi / cth * r;
    phi = phi + dt * phi_d;
    th = th + dt * th_d;
    psi = psi + dt * psi_d;
  }
  s[0] = x; s[1] = xd; s[2] = y; s[3] = yd; s[4] = z; s[5] = zd;
  s[6] = phi; s[7] = th; s[8] = psi; s[9] = p; s[10] = q; s[11] = r;
}

__global__ void quad2d_advance_kernel(
    const float* __restrict__ states, const float* __restrict__ t1,
    const float* __restrict__ t2, const float* __restrict__ dyn,
    const float* __restrict__ params, float* __restrict__ out, int B,
    int n_substeps, float dt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* s = states + 6 * b;
  float x = s[0], xd = s[1], z = s[2], zd = s[3], th = s[4], thd = s[5];
  quad2d_substeps(x, xd, z, zd, th, thd, t1[b], t2[b], dyn[2 * b + 0],
                  dyn[2 * b + 1], params[0], params[1], params[2], params[3],
                  n_substeps, dt);
  float* o = out + 6 * b;
  o[0] = x; o[1] = xd; o[2] = z; o[3] = zd; o[4] = th; o[5] = thd;
}

__global__ void quad3d_advance_kernel(
    const float* __restrict__ states, const float* __restrict__ forces,
    const float* __restrict__ z_torque, const float* __restrict__ dyn,
    const float* __restrict__ params, float* __restrict__ out, int B,
    int n_substeps, float dt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) s[k] = states[12 * b + k];
  const float* f = forces + 4 * b;
  quad3d_substeps(s, f[0], f[1], f[2], f[3], z_torque[b], dyn[3 * b + 0],
                  dyn[3 * b + 1], dyn[3 * b + 2], params[0], params[1],
                  params[2], params[3], params[4], params[5], n_substeps, dt);
#pragma unroll
  for (int k = 0; k < 12; ++k) out[12 * b + k] = s[k];
}

// Position and angle dims checked for out of bounds (quadrotor.py _oob).
template <int QT>
__device__ constexpr bool oob_dim(int k) {
  return QT == 2 ? (k == 0 || k == 2 || k == 4)
                 : (k == 0 || k == 2 || k == 4 || k == 6 || k == 7 || k == 8);
}

// POLICY: the policy mode, compiled apart so that the open-loop modes keep
// their own register allocation.
template <int QT, bool POLICY>
__global__ void quad_rollout_kernel(
    const float* __restrict__ state0, const float* __restrict__ cfg_g,
    const float* __restrict__ actions, const float* __restrict__ x_goal,
    const float* __restrict__ policy_p, float* __restrict__ state_out,
    float* __restrict__ step_out, float* __restrict__ reward_out,
    float* __restrict__ done_out, float* __restrict__ viol_out, int B, int T,
    int n_substeps, float dt, uint32_t seed, int n_goal, int h1, int h2,
    int nu_out, float clip_obs, int flags) {
  constexpr int NX = QT == 2 ? 6 : 12;
  constexpr int NU = QT == 2 ? 2 : 4;
  constexpr float N_MOTOR = QT == 2 ? 2.0f : 1.0f;  // motors per command

  __shared__ float c[QUAD_CFG_LEN];
  extern __shared__ float hidden[];  // policy mode: [h1][blockDim.x]
  for (int k = threadIdx.x; k < QUAD_CFG_LEN; k += blockDim.x) c[k] = cfg_g[k];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

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

  float s[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) s[k] = state0[NX * b + k];
  int step = 0;
  float reward_sum = 0.0f;
  int done_count = 0, viol_count = 0;

  // Motor model constants: cmd -> pwm -> rpm (dynamics.py cmd2pwm/pwm2rpm).
  const float inv_nkf = 1.0f / (N_MOTOR * c[KF]);
  const float inv_scale = 1.0f / c[PWM_SCALE];

  for (int t = 0; t < T; ++t) {
    // Action pipeline: raw -> physical -> noisy -> clipped.
    float rnd_a[4], rnd_n[4];
    if (draw_actions) uniform4(seed, b, t, 0u, rnd_a);
    if (action_noise) uniform4(seed, b, t, 1u, rnd_n);
    float noisy[NU], clipped[NU];
    if constexpr (POLICY) {
      // The actor on the state at the start of the step, exploration noise
      // from counter word j = 2 in Box-Muller pairs, then the squash.
      float raw[NU];
      scg::policy_mean<NX, NU>(mlp, s, hid, blockDim.x, raw);
      if (policy_stochastic) {
        float rnd_p[4];
        uniform4(seed, b, t, 2u, rnd_p);
#pragma unroll
        for (int d = 0; d < NU; d += 2) {
          float n_cos, n_sin;
          standard_normal_pair(rnd_p[d], rnd_p[d + 1], n_cos, n_sin);
          raw[d] = raw[d] + c[P_STD + d] * n_cos;
          raw[d + 1] = raw[d + 1] + c[P_STD + d + 1] * n_sin;
        }
      }
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        const float a = policy_squash ? tanhf(raw[d]) : raw[d];
        noisy[d] = c[DEN_A] * a + c[DEN_B];
      }
    } else {
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        const float raw = draw_actions
            ? c[ACT_LO] + rnd_a[d] * (c[ACT_HI] - c[ACT_LO])
            : actions[((size_t)t * B + b) * NU + d];
        noisy[d] = c[DEN_A] * raw + c[DEN_B];
      }
    }
    if (action_noise) {
#pragma unroll
      for (int d = 0; d < NU; d += 2) {
        float n_cos, n_sin;
        standard_normal_pair(rnd_n[d], rnd_n[d + 1], n_cos, n_sin);
        noisy[d] = noisy[d] + c[NOISE_STD] * n_cos;
        noisy[d + 1] = noisy[d + 1] + c[NOISE_STD] * n_sin;
      }
    }
    float rpm[NU];
#pragma unroll
    for (int d = 0; d < NU; ++d) {
      clipped[d] = fminf(fmaxf(noisy[d], c[PHYS_LO]), c[PHYS_HI]);
      float pwm = (sqrtf(fmaxf(clipped[d], 0.0f) * inv_nkf) - c[PWM_CONST]) * inv_scale;
      pwm = fminf(fmaxf(pwm, c[PWM_MIN]), c[PWM_MAX]);
      rpm[d] = c[PWM_SCALE] * pwm + c[PWM_CONST];
    }

    // Motor forces and the physics of one control step.
    if constexpr (QT == 2) {
      // Pairing [m0, m1, m1, m0]: T1 = f0 + f3 = 2 f(m0), T2 = 2 f(m1).
      const float T1 = 2.0f * c[KF] * rpm[0] * rpm[0];
      const float T2 = 2.0f * c[KF] * rpm[1] * rpm[1];
      quad2d_substeps(s[0], s[1], s[2], s[3], s[4], s[5], T1, T2, 0.0f, 0.0f,
                      c[MASS], c[IYY], c[ARM_L], c[GRAVITY], n_substeps, dt);
    } else {
      float f[4], tq[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        f[d] = c[KF] * rpm[d] * rpm[d];
        tq[d] = c[KM] * rpm[d] * rpm[d];
      }
      const float zt = -tq[0] + tq[1] - tq[2] + tq[3];
      quad3d_substeps(s, f[0], f[1], f[2], f[3], zt, 0.0f, 0.0f, 0.0f,
                      c[MASS], c[IXX], c[IYY], c[IZZ], c[ARM_L], c[GRAVITY],
                      n_substeps, dt);
    }

    // Goal: constant, or this env's own waypoint X_GOAL[step + 1] (both
    // costs). Reward: state error and action error against U_GOAL, on the
    // noisy action (RL reward) or the clipped one (quadratic cost, never
    // exponential).
    const float* goal = c + GOAL;
    if (tracking) goal = x_goal + (size_t)min(step + 1, n_goal - 1) * NX;
    float dist = 0.0f, goal_sq = 0.0f;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const float e = s[k] - goal[k];
      dist = dist + c[W_STATE + k] * e * e;
      goal_sq = goal_sq + e * e;
    }
#pragma unroll
    for (int d = 0; d < NU; ++d) {
      const float ae = (quadratic ? clipped[d] : noisy[d]) - c[U_GOAL + d];
      dist = dist + c[W_ACT + d] * ae * ae;
    }
    const float rew = (!quadratic && rew_exponential) ? expf(-dist) : -dist;

    // Done: goal (stabilization only), position/angle out of bounds on both
    // sides, time limit.
    bool done = !tracking && goal_sq < c[TOL_SQ];
    if (done_on_oob) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        if (oob_dim<QT>(k)) {
          done = done || s[k] < c[CON_LO + k] || s[k] > c[CON_HI + k];
        }
      }
    }
    const int new_step = step + 1;
    done = done || (float)new_step >= c[MAX_STEPS];

    // Default state box and input box, on the noisy pre-clip commands.
    if (constrained) {
      bool viol = false;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        viol = viol || s[k] < c[CON_LO + k] || s[k] > c[CON_HI + k];
      }
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        viol = viol || noisy[d] > c[PHYS_HI] || noisy[d] < c[PHYS_LO];
      }
      viol_count += viol;
    }

    // Auto-reset.
    if (done) {
      if (randomized_reset) {
        float rnd_r[12];
#pragma unroll
        for (int j = 0; j < (NX + 3) / 4; ++j) uniform4(seed, b, t, 3u + j, rnd_r + 4 * j);
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          s[k] = c[INIT_LO + k] + rnd_r[k] * (c[INIT_HI + k] - c[INIT_LO + k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < NX; ++k) s[k] = c[INIT_LO + k];
      }
    }
    step = done ? 0 : new_step;
    reward_sum += rew;
    done_count += done;
  }
#pragma unroll
  for (int k = 0; k < NX; ++k) state_out[NX * b + k] = s[k];
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

int scg_quad2d_advance(const void* states, const void* t1, const void* t2,
                       const void* dyn, const void* params, void* out, int B,
                       int n_substeps, float dt, int threads, void* stream) {
  if (B > 0) {
    quad2d_advance_kernel<<<(B + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
        (const float*)states, (const float*)t1, (const float*)t2,
        (const float*)dyn, (const float*)params, (float*)out, B, n_substeps,
        dt);
  }
  return (int)cudaGetLastError();
}

int scg_quad3d_advance(const void* states, const void* forces,
                       const void* z_torque, const void* dyn,
                       const void* params, void* out, int B, int n_substeps,
                       float dt, int threads, void* stream) {
  if (B > 0) {
    quad3d_advance_kernel<<<(B + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
        (const float*)states, (const float*)forces, (const float*)z_torque,
        (const float*)dyn, (const float*)params, (float*)out, B, n_substeps,
        dt);
  }
  return (int)cudaGetLastError();
}

// policy: the packed actor (ops/rollout_kernels.py pack_policy_params) with
// widths h1, h2, nu_out, read when flags has F_POLICY.
int scg_quad_rollout(int quad_type, const void* state0, const void* cfg,
                     const void* actions, const void* x_goal, const void* policy,
                     void* state_out, void* step_out, void* reward_out,
                     void* done_out, void* viol_out, int B, int T, int n_substeps,
                     float dt, unsigned int seed, int n_goal, int h1, int h2,
                     int nu_out, float clip_obs, int flags, int threads,
                     void* stream) {
  if (quad_type != 2 && quad_type != 3) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const bool policy_mode = flags & F_POLICY;
    auto kernel = quad_type == 2
        ? (policy_mode ? quad_rollout_kernel<2, true> : quad_rollout_kernel<2, false>)
        : (policy_mode ? quad_rollout_kernel<3, true> : quad_rollout_kernel<3, false>);
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
