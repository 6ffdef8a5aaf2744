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
// each env's state stays in registers: K2 and K3 for n_substeps, K5 for all
// T steps (the loop over T replaces the TPU grid over steps; nothing is
// carried between blocks). K5 is templated on the quad type, so nx and nu
// are compile-time and the state arrays unroll into registers; its cfg
// vector sits in shared memory, read at one address by every thread. K2
// moves 64 bytes per env and K3 128; both are bound by their launch at the
// env step's batch sizes. K5 reads its inputs once and writes its outputs
// once; at B=4096 it is bound by how fast one warp runs one env's T x
// n_substeps substeps, not by FLOP/s or bytes.
//
// K5's open loop, quad_rollout_kernel<QT, N>. What bounded it: every
// library sinf, cosf and divide ends in a branch to its slow path, and a warp
// stalls at each branch while ptxas schedules each call on its own, so one
// warp an SM ran a 3D substep (232 instructions, nine such branches) in
// about 960 cycles, and on exact hover the divides' zero numerators took
// their slow path (kernel_first_check --chain). What the design does:
// - exact_math.cuh's branch-free copies of the library's fast paths, and the
//   step recomputed with the library's own functions where an operand was
//   special: a chunk of substeps (rollout_modes.cuh) is one basic block, so
//   the chunk's independent sin/cos pairs and quotients overlap;
// - N = kSpecialisedSubsteps compiled in (the benchmark's and the committed
//   models' 1000 Hz under 50 Hz); N = 0, any other count, loops over it;
// - 2D: in each chunk the angles first, then their sin/cos pairs, then the x
//   and z sums, so the pairs overlap.
// What bounds it now: one warp's issue and latency along a step, since one
// thread owns one env. A team of four lanes an env (each lane one sin/cos
// pair or quotient, __shfl_sync to the others) was measured slower than one
// lane at every batch from 4096 to 65536, in 2D and in 3D: the shuffles
// lengthen the chain one warp already runs at its own pace, and the step's
// rest runs on every lane. Up to about four warps an SM (B = 16384 on 132
// SMs) a substep takes the same time as at B=4096.
// In policy mode the actor's float32 products dominate each step, and a
// separate kernel, quad_policy_rollout_kernel<QT>, runs them with a block of
// 256 threads for every 32 envs (policy_mlp.cuh) and the library's substeps
// (quad_step<QT>, which shares the reward, done and reset with the open
// loop).
//
// Launch shape. K2, K3 and K5's open loop, one thread an env: block_size
// (ops/_launch.py), 32 threads a block at B=4096 so that every SM holds a
// block. Policy mode: 256 threads for every 32 envs.
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

#include "exact_math.cuh"
#include "philox.cuh"
#include "policy_mlp.cuh"
#include "rollout_modes.cuh"

namespace {

using scg::div_exact;
using scg::F_POLICY;
using scg::F_POLICY_RELU;
using scg::Modes;
using scg::modes;
using scg::rcp_exact;
using scg::sincos_exact;
using scg::standard_normal_pair;
using scg::uniform4;

constexpr float kSqrt2 = 1.41421356237309515f;  // float32(sqrt(2))

// The substep count the open loop compiles in (ops/rollout_kernels.py
// SPECIALISED_SUBSTEPS).
constexpr int kSpecialisedSubsteps = 20;

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

// The open loop's substeps: quad2d_substeps and quad3d_substeps with no
// world force, every float op as there, but with exact_math.cuh's
// branch-free sin/cos and quotients. They return false where an operand was
// special; the caller then recomputes the step with the functions above.
// N > 0 is the substep count compiled in (run in unrolled chunks,
// rollout_modes.cuh); N == 0 loops over the runtime count n.
//
// 2D, N > 0, in each chunk of substeps (rollout_modes.cuh): the angle's
// chain first (thd, th: two adds a substep, since th_dd is constant over the
// step), then the chunk's sin/cos pairs, which no longer wait for each other,
// then the x and z accumulations. Each variable sees the same ops in the same
// order as in quad2d_substeps.
template <int N>
__device__ __forceinline__ bool quad2d_substeps_exact(float (&s)[6], float T1, float T2,
                                                      float m, float Iyy, float L, float g,
                                                      int n, float dt) {
  float th_dd, inv_m;
  bool ok = div_exact(L * (T2 - T1), Iyy, th_dd);
  ok &= div_exact(th_dd, kSqrt2, th_dd);
  ok &= rcp_exact(m, inv_m);
  const float tom = (T1 + T2) * inv_m;
  const float fxm = 0.0f * inv_m;
  const float fzm_g = 0.0f * inv_m - g;
  float x = s[0], xd = s[1], z = s[2], zd = s[3], th = s[4], thd = s[5];
  if constexpr (N > 0) {
    constexpr int C = scg::kSubstepChunk < N ? scg::kSubstepChunk : N;
    static_assert(N % C == 0, "the substep count must be a multiple of the chunk");
#pragma unroll 1
    for (int c0 = 0; c0 < N; c0 += C) {
      float sn[C], cs[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        sn[i] = th;
        thd = thd + dt * th_dd;
        th = th + dt * thd;
      }
#pragma unroll
      for (int i = 0; i < C; ++i) ok &= sincos_exact(sn[i], sn[i], cs[i]);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float x_dd = sn[i] * tom + fxm;
        const float z_dd = cs[i] * tom + fzm_g;
        xd = xd + dt * x_dd;
        zd = zd + dt * z_dd;
        x = x + dt * xd;
        z = z + dt * zd;
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      float sin_t, cos_t;
      ok &= sincos_exact(th, sin_t, cos_t);
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
  s[0] = x; s[1] = xd; s[2] = z; s[3] = zd; s[4] = th; s[5] = thd;
  return ok;
}

// The 3D terms that depend on the cfg alone, hoisted out of the rollout
// (quad3d_substeps computes the same ones on every call).
struct Quad3DConsts {
  float l_sq2, inv_m, c_p, c_q, c_r, Ixx, Iyy, Izz, g;
};

__device__ __forceinline__ Quad3DConsts quad3d_consts(float m, float Ixx, float Iyy,
                                                      float Izz, float L, float g) {
  return Quad3DConsts{L / kSqrt2, 1.0f / m, (Izz - Iyy) / Ixx, (Ixx - Izz) / Iyy,
                      (Iyy - Ixx) / Izz, Ixx, Iyy, Izz, g};
}

// 3D: the three sin/cos pairs and the three quotients of a substep are
// independent of each other, and a chunk of substeps is one basic block.
template <int N>
__device__ __forceinline__ bool quad3d_substeps_exact(float (&s)[12], float f0, float f1,
                                                      float f2, float f3, float zt,
                                                      const Quad3DConsts& k, int n, float dt) {
  float x = s[0], xd = s[1], y = s[2], yd = s[3], z = s[4], zd = s[5];
  float phi = s[6], th = s[7], psi = s[8], p = s[9], q = s[10], r = s[11];
  const float total = f0 + f1 + f2 + f3;
  const float Mx = k.l_sq2 * (f0 + f1 - f2 - f3);
  const float My = k.l_sq2 * (-f0 + f1 + f2 - f3);
  const float tom = total * k.inv_m;
  const float fxm = 0.0f * k.inv_m;
  const float fym = 0.0f * k.inv_m;
  const float fzm_g = 0.0f * k.inv_m - k.g;
  float Mx_I, My_I, zt_I;
  bool ok = div_exact(Mx, k.Ixx, Mx_I);
  ok &= div_exact(My, k.Iyy, My_I);
  ok &= div_exact(zt, k.Izz, zt_I);
  auto substep = [&]() {
    float sphi, cphi, sth, cth, spsi, cpsi;
    ok &= sincos_exact(phi, sphi, cphi);
    ok &= sincos_exact(th, sth, cth);
    ok &= sincos_exact(psi, spsi, cpsi);
    const float x_dd = (cphi * sth * cpsi + sphi * spsi) * tom + fxm;
    const float y_dd = (cphi * sth * spsi - sphi * cpsi) * tom + fym;
    const float z_dd = cphi * cth * tom + fzm_g;
    const float p_d = Mx_I - q * r * k.c_p;
    const float q_d = My_I - p * r * k.c_q;
    const float r_d = zt_I - p * q * k.c_r;
    xd = xd + dt * x_dd;
    yd = yd + dt * y_dd;
    zd = zd + dt * z_dd;
    p = p + dt * p_d;
    q = q + dt * q_d;
    r = r + dt * r_d;
    x = x + dt * xd;
    y = y + dt * yd;
    z = z + dt * zd;
    float tth, sphi_c, cphi_c;
    ok &= div_exact(sth, cth, tth);
    ok &= div_exact(sphi, cth, sphi_c);
    ok &= div_exact(cphi, cth, cphi_c);
    const float phi_d = p + sphi * tth * q + cphi * tth * r;
    const float th_d = cphi * q - sphi * r;
    const float psi_d = sphi_c * q + cphi_c * r;
    phi = phi + dt * phi_d;
    th = th + dt * th_d;
    psi = psi + dt * psi_d;
  };
  if constexpr (N > 0) {
    scg::chunked_substeps<N>(substep);
  } else {
    for (int i = 0; i < n; ++i) substep();
  }
  s[0] = x; s[1] = xd; s[2] = y; s[3] = yd; s[4] = z; s[5] = zd;
  s[6] = phi; s[7] = th; s[8] = psi; s[9] = p; s[10] = q; s[11] = r;
  return ok;
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

// State and action sizes of quad type QT, and motors per command.
template <int QT>
struct QuadDims {
  static constexpr int NX = QT == 2 ? 6 : 12;
  static constexpr int NU = QT == 2 ? 2 : 4;
  static constexpr float N_MOTOR = QT == 2 ? 2.0f : 1.0f;
};

// One env of the rollout: its state and what it accumulates.
template <int QT>
struct QuadEnv {
  float s[QuadDims<QT>::NX];
  int step;
  float reward_sum;
  int done_count, viol_count;
};

template <int QT>
__device__ __forceinline__ void load_env(QuadEnv<QT>& e, const float* __restrict__ state0,
                                         int b) {
  constexpr int NX = QuadDims<QT>::NX;
#pragma unroll
  for (int k = 0; k < NX; ++k) e.s[k] = state0[NX * b + k];
  e.step = 0;
  e.reward_sum = 0.0f;
  e.done_count = 0;
  e.viol_count = 0;
}

template <int QT>
__device__ __forceinline__ void store_env(const QuadEnv<QT>& e, int b,
                                          float* __restrict__ state_out,
                                          float* __restrict__ step_out,
                                          float* __restrict__ reward_out,
                                          float* __restrict__ done_out,
                                          float* __restrict__ viol_out) {
  constexpr int NX = QuadDims<QT>::NX;
#pragma unroll
  for (int k = 0; k < NX; ++k) state_out[NX * b + k] = e.s[k];
  step_out[b] = (float)e.step;
  reward_out[b] = e.reward_sum;
  done_out[b] = (float)e.done_count;
  viol_out[b] = (float)e.viol_count;
}

// Action noise from counter word j = 1 on the denormalized commands.
template <int NU>
__device__ __forceinline__ void quad_action_noise(const float* c, float (&noisy)[NU],
                                                  uint32_t seed, int b, int t) {
  float rnd_n[4];
  uniform4(seed, b, t, 1u, rnd_n);
#pragma unroll
  for (int d = 0; d < NU; d += 2) {
    float n_cos, n_sin;
    standard_normal_pair(rnd_n[d], rnd_n[d + 1], n_cos, n_sin);
    noisy[d] = noisy[d] + c[NOISE_STD] * n_cos;
    noisy[d + 1] = noisy[d + 1] + c[NOISE_STD] * n_sin;
  }
}

// The motor model of one clipped command: cmd -> pwm -> rpm
// (dynamics.py cmd2pwm / pwm2rpm).
__device__ __forceinline__ float quad_rpm(const float* c, float clipped, float inv_nkf,
                                          float inv_scale) {
  float pwm = (sqrtf(fmaxf(clipped, 0.0f) * inv_nkf) - c[PWM_CONST]) * inv_scale;
  pwm = fminf(fmaxf(pwm, c[PWM_MIN]), c[PWM_MAX]);
  return c[PWM_SCALE] * pwm + c[PWM_CONST];
}

// After the substeps: the reward (into rew), done before the reset (the
// return value) and the violation count. Goal: constant, or this env's own
// waypoint X_GOAL[step + 1] (both costs). Reward: state error and action
// error against U_GOAL, on the noisy action (RL reward) or the clipped one
// (quadratic cost, never exponential).
template <int QT>
__device__ __forceinline__ bool quad_outcome(const Modes& m, const float* c,
                                             const float (&noisy)[QuadDims<QT>::NU],
                                             const float (&clipped)[QuadDims<QT>::NU],
                                             const float* __restrict__ x_goal, int n_goal,
                                             QuadEnv<QT>& e, float& rew) {
  constexpr int NX = QuadDims<QT>::NX;
  constexpr int NU = QuadDims<QT>::NU;
  const float (&s)[NX] = e.s;
  const float* goal = c + GOAL;
  if (m.tracking) goal = x_goal + (size_t)min(e.step + 1, n_goal - 1) * NX;
  float dist = 0.0f, goal_sq = 0.0f;
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const float err = s[k] - goal[k];
    dist = dist + c[W_STATE + k] * err * err;
    goal_sq = goal_sq + err * err;
  }
#pragma unroll
  for (int d = 0; d < NU; ++d) {
    const float ae = (m.quadratic ? clipped[d] : noisy[d]) - c[U_GOAL + d];
    dist = dist + c[W_ACT + d] * ae * ae;
  }
  rew = (!m.quadratic && m.rew_exponential) ? expf(-dist) : -dist;

  // Done: goal (stabilization only), position/angle out of bounds on both
  // sides, time limit.
  bool done = !m.tracking && goal_sq < c[TOL_SQ];
  if (m.done_on_oob) {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      if (oob_dim<QT>(k)) {
        done = done || s[k] < c[CON_LO + k] || s[k] > c[CON_HI + k];
      }
    }
  }
  done = done || (float)(e.step + 1) >= c[MAX_STEPS];

  // Default state box and input box, on the noisy pre-clip commands.
  if (m.constrained) {
    bool viol = false;
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      viol = viol || s[k] < c[CON_LO + k] || s[k] > c[CON_HI + k];
    }
#pragma unroll
    for (int d = 0; d < NU; ++d) {
      viol = viol || noisy[d] > c[PHYS_HI] || noisy[d] < c[PHYS_LO];
    }
    e.viol_count += viol;
  }
  return done;
}

// The auto-reset of a done env to INIT_LO + rnd_r (INIT_HI - INIT_LO), or to
// INIT_LO, and the counters.
template <int QT>
__device__ __forceinline__ void quad_finish(const Modes& m, const float* c, bool done,
                                            const float* rnd_r, float rew, QuadEnv<QT>& e) {
  constexpr int NX = QuadDims<QT>::NX;
  if (done) {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      e.s[k] = m.randomized_reset
          ? c[INIT_LO + k] + rnd_r[k] * (c[INIT_HI + k] - c[INIT_LO + k])
          : c[INIT_LO + k];
    }
  }
  e.step = done ? 0 : e.step + 1;
  e.reward_sum += rew;
  e.done_count += done;
}

// The rest of one control step after the denormalized action `noisy`, for
// env b (policy mode): action noise, clip, motor model, the substeps, reward,
// done, violations and the auto-reset. c is the cfg vector in shared memory.
template <int QT>
__device__ __forceinline__ void quad_step(const Modes& m, const float* c,
                                          float (&noisy)[QuadDims<QT>::NU], uint32_t seed,
                                          int b, int t, const float* __restrict__ x_goal,
                                          int n_goal, int n_substeps, float dt,
                                          float inv_nkf, float inv_scale, QuadEnv<QT>& e) {
  constexpr int NX = QuadDims<QT>::NX;
  constexpr int NU = QuadDims<QT>::NU;
  float (&s)[NX] = e.s;
  if (m.action_noise) quad_action_noise(c, noisy, seed, b, t);
  float clipped[NU], rpm[NU];
#pragma unroll
  for (int d = 0; d < NU; ++d) {
    clipped[d] = fminf(fmaxf(noisy[d], c[PHYS_LO]), c[PHYS_HI]);
    rpm[d] = quad_rpm(c, clipped[d], inv_nkf, inv_scale);
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

  float rew;
  const bool done = quad_outcome<QT>(m, c, noisy, clipped, x_goal, n_goal, e, rew);
  float rnd_r[12];
  if (done && m.randomized_reset) {
#pragma unroll
    for (int j = 0; j < (NX + 3) / 4; ++j) uniform4(seed, b, t, 3u + j, rnd_r + 4 * j);
  }
  quad_finish<QT>(m, c, done, rnd_r, rew, e);
}

// One control step of the open loop for env b, as quad_step but with the
// substeps of quad2d_substeps_exact / quad3d_substeps_exact, or the library's
// substeps where those report a special operand.
template <int QT, int N>
__device__ __forceinline__ void quad_open_step(const Modes& m, const float* c,
                                               float (&noisy)[QuadDims<QT>::NU],
                                               uint32_t seed, int b, int t,
                                               const float* __restrict__ x_goal, int n_goal,
                                               int n_substeps, float dt, float inv_nkf,
                                               float inv_scale, const Quad3DConsts& k3,
                                               QuadEnv<QT>& e) {
  constexpr int NX = QuadDims<QT>::NX;
  constexpr int NU = QuadDims<QT>::NU;
  float (&s)[NX] = e.s;
  if (m.action_noise) quad_action_noise(c, noisy, seed, b, t);
  float clipped[NU], rpm[NU];
#pragma unroll
  for (int d = 0; d < NU; ++d) {
    clipped[d] = fminf(fmaxf(noisy[d], c[PHYS_LO]), c[PHYS_HI]);
    rpm[d] = quad_rpm(c, clipped[d], inv_nkf, inv_scale);
  }

  float start[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) start[k] = s[k];
  if constexpr (QT == 2) {
    const float T1 = 2.0f * c[KF] * rpm[0] * rpm[0];
    const float T2 = 2.0f * c[KF] * rpm[1] * rpm[1];
    if (!quad2d_substeps_exact<N>(s, T1, T2, c[MASS], c[IYY], c[ARM_L], c[GRAVITY],
                                  n_substeps, dt)) {
#pragma unroll
      for (int k = 0; k < NX; ++k) s[k] = start[k];
      quad2d_substeps(s[0], s[1], s[2], s[3], s[4], s[5], T1, T2, 0.0f, 0.0f, c[MASS],
                      c[IYY], c[ARM_L], c[GRAVITY], n_substeps, dt);
    }
  } else {
    float f[4], tq[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      f[d] = c[KF] * rpm[d] * rpm[d];
      tq[d] = c[KM] * rpm[d] * rpm[d];
    }
    const float zt = -tq[0] + tq[1] - tq[2] + tq[3];
    if (!quad3d_substeps_exact<N>(s, f[0], f[1], f[2], f[3], zt, k3, n_substeps, dt)) {
#pragma unroll
      for (int k = 0; k < NX; ++k) s[k] = start[k];
      quad3d_substeps(s, f[0], f[1], f[2], f[3], zt, 0.0f, 0.0f, 0.0f, c[MASS], c[IXX],
                      c[IYY], c[IZZ], c[ARM_L], c[GRAVITY], n_substeps, dt);
    }
  }

  float rew;
  const bool done = quad_outcome<QT>(m, c, noisy, clipped, x_goal, n_goal, e, rew);
  float rnd_r[12];
  if (done && m.randomized_reset) {
#pragma unroll
    for (int j = 0; j < (NX + 3) / 4; ++j) uniform4(seed, b, t, 3u + j, rnd_r + 4 * j);
  }
  quad_finish<QT>(m, c, done, rnd_r, rew, e);
}

// The open loop: one thread an env, actions drawn or replayed; N substeps
// compiled in, or n_substeps if N == 0.
template <int QT, int N>
__global__ void quad_rollout_kernel(
    const float* __restrict__ state0, const float* __restrict__ cfg_g,
    const float* __restrict__ actions, const float* __restrict__ x_goal,
    float* __restrict__ state_out, float* __restrict__ step_out,
    float* __restrict__ reward_out, float* __restrict__ done_out,
    float* __restrict__ viol_out, int B, int T, int n_substeps, float dt,
    uint32_t seed, int n_goal, int flags) {
  constexpr int NU = QuadDims<QT>::NU;
  __shared__ float c[QUAD_CFG_LEN];
  for (int k = threadIdx.x; k < QUAD_CFG_LEN; k += blockDim.x) c[k] = cfg_g[k];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Modes m = modes(flags);
  QuadEnv<QT> e;
  load_env(e, state0, b);

  // Motor model constants: cmd -> pwm -> rpm (dynamics.py cmd2pwm/pwm2rpm).
  const float inv_nkf = 1.0f / (QuadDims<QT>::N_MOTOR * c[KF]);
  const float inv_scale = 1.0f / c[PWM_SCALE];
  const Quad3DConsts k3 = quad3d_consts(c[MASS], c[IXX], c[IYY], c[IZZ], c[ARM_L], c[GRAVITY]);

  for (int t = 0; t < T; ++t) {
    // Action pipeline: raw -> physical, then noisy -> clipped in the step.
    float rnd_a[4];
    if (m.draw_actions) uniform4(seed, b, t, 0u, rnd_a);
    float noisy[NU];
#pragma unroll
    for (int d = 0; d < NU; ++d) {
      const float raw = m.draw_actions
          ? c[ACT_LO] + rnd_a[d] * (c[ACT_HI] - c[ACT_LO])
          : actions[((size_t)t * B + b) * NU + d];
      noisy[d] = c[DEN_A] * raw + c[DEN_B];
    }
    quad_open_step<QT, N>(m, c, noisy, seed, b, t, x_goal, n_goal, n_substeps, dt, inv_nkf,
                          inv_scale, k3, e);
  }
  store_env(e, b, state_out, step_out, reward_out, done_out, viol_out);
}

// The closed loop (policy_mlp.cuh): a block of kPolicyThreads threads for
// kPolicyEnvs envs. The threads of warp 0 own one env each and run
// quad_step; the whole block runs the actor. A thread past the last env of a
// partly filled tile keeps a zero state and skips the step, but stays in the
// loop for the block's barriers.
// CHUNKED: H2 runs in chunks of w2_cols units (policy_mlp.cuh).
template <int QT, bool CHUNKED>
__global__ void __launch_bounds__(scg::kPolicyThreads) quad_policy_rollout_kernel(
    const float* __restrict__ state0, const float* __restrict__ cfg_g,
    const float* __restrict__ x_goal, const float* __restrict__ policy_p,
    float* __restrict__ state_out, float* __restrict__ step_out,
    float* __restrict__ reward_out, float* __restrict__ done_out,
    float* __restrict__ viol_out, int B, int T, int n_substeps, float dt,
    uint32_t seed, int n_goal, int h1, int h2, int nu_out, int w2_rows, int w2_cols,
    float clip_obs, int flags) {
  constexpr int NX = QuadDims<QT>::NX;
  constexpr int NU = QuadDims<QT>::NU;
  __shared__ float c[QUAD_CFG_LEN];
  for (int k = threadIdx.x; k < QUAD_CFG_LEN; k += blockDim.x) c[k] = cfg_g[k];
  const scg::PolicyMLP mlp{policy_p, h1, h2, nu_out, clip_obs, (flags & F_POLICY_RELU) != 0};
  const scg::PolicySmem sm = scg::policy_smem(NX, NU, h1, h2, w2_rows, w2_cols);
  const bool w2_resident = scg::policy_w2_resident(h1, h2, w2_rows, w2_cols);
  scg::W2Ring<CHUNKED> ring;
  scg::policy_stage<NX, NU>(mlp, sm, w2_rows, w2_cols, ring);
  __syncthreads();

  const int lane = threadIdx.x;
  const int b = blockIdx.x * scg::kPolicyEnvs + lane;
  const bool env_thread = lane < scg::kPolicyEnvs;
  const bool live = env_thread && b < B;
  const Modes m = modes(flags);
  QuadEnv<QT> e;
  if (live) {
    load_env(e, state0, b);
  } else {
#pragma unroll
    for (int k = 0; k < NX; ++k) e.s[k] = 0.0f;
  }
  const float inv_nkf = 1.0f / (QuadDims<QT>::N_MOTOR * c[KF]);
  const float inv_scale = 1.0f / c[PWM_SCALE];

  for (int t = 0; t < T; ++t) {
    if (env_thread) scg::policy_write_obs<NX>(mlp, sm, e.s, lane);
    scg::policy_actor<NX, NU>(mlp, sm, w2_resident, w2_cols, ring);
    if (live) {
      // The actor's mean, exploration noise from counter word j = 2 in
      // Box-Muller pairs, the squash, denormalize.
      float raw[NU];
#pragma unroll
      for (int d = 0; d < NU; ++d) raw[d] = sm.mu[d * scg::kPolicyEnvs + lane];
      if (m.policy_stochastic) {
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
      float noisy[NU];
#pragma unroll
      for (int d = 0; d < NU; ++d) {
        const float a = m.policy_squash ? tanhf(raw[d]) : raw[d];
        noisy[d] = c[DEN_A] * a + c[DEN_B];
      }
      quad_step<QT>(m, c, noisy, seed, b, t, x_goal, n_goal, n_substeps, dt, inv_nkf,
                    inv_scale, e);
    }
  }
  ring.drain();
  if (live) store_env(e, b, state_out, step_out, reward_out, done_out, viol_out);
}

// exact_math.cuh against the CUDA math library, for kernel_first_check
// --chain: sincos_exact and rcp_exact on every 32-bit pattern x where they
// report the fast range, and div_exact on one pair drawn from each pattern
// (exponents from 2^-66 to 2^65, the fast range and a margin on each side;
// one numerator in 16 a signed zero). counts: compared and differing, for
// sincos, rcp and div in turn.
__device__ __forceinline__ uint32_t mix32(uint32_t v) {   // murmur3's finalizer
  v ^= v >> 16;
  v *= 0x85ebca6bu;
  v ^= v >> 13;
  v *= 0xc2b2ae35u;
  v ^= v >> 16;
  return v;
}

__device__ __forceinline__ float random_float(uint32_t h) {
  return __uint_as_float((h & 0x807fffffu) | ((61u + ((h >> 23) & 0xffu) % 132u) << 23));
}

__global__ void exact_math_check_kernel(unsigned long long* counts) {
  unsigned long long n[6] = {0, 0, 0, 0, 0, 0};
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < (1ull << 32);
       i += stride) {
    const float x = __uint_as_float((uint32_t)i);
    float s, c, r, q;
    if (sincos_exact(x, s, c)) {
      n[0] += 1;
      n[1] += __float_as_uint(s) != __float_as_uint(sinf(x))
              || __float_as_uint(c) != __float_as_uint(cosf(x));
    }
    if (rcp_exact(x, r)) {
      n[2] += 1;
      n[3] += __float_as_uint(r) != __float_as_uint(1.0f / x);
    }
    const uint32_t h1 = mix32((uint32_t)i), h2 = mix32((uint32_t)i ^ 0x9e3779b9u);
    const float num = (h2 >> 28) == 0 ? __uint_as_float(h1 & 0x80000000u) : random_float(h1);
    const float den = random_float(h2);
    if (div_exact(num, den, q)) {
      n[4] += 1;
      n[5] += __float_as_uint(q) != __float_as_uint(num / den);
    }
  }
  for (int k = 0; k < 6; ++k) atomicAdd(counts + k, n[k]);
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
// widths h1, h2, nu_out, read when flags has F_POLICY. A policy launch takes
// the geometry of ops/rollout_kernels.py _policy_launch (envs and threads a
// block, W2's rows and columns a tile, dynamic shared memory bytes) and
// refuses any other; an open-loop launch takes `threads` a block of one
// thread an env and ignores the rest.
int scg_quad_rollout(int quad_type, const void* state0, const void* cfg,
                     const void* actions, const void* x_goal, const void* policy,
                     void* state_out, void* step_out, void* reward_out,
                     void* done_out, void* viol_out, int B, int T, int n_substeps,
                     float dt, unsigned int seed, int n_goal, int h1, int h2,
                     int nu_out, float clip_obs, int flags, int threads, int envs,
                     int w2_rows, int w2_cols, int smem, void* stream) {
  if (quad_type != 2 && quad_type != 3) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  if (!(flags & F_POLICY)) {
    const bool spec = n_substeps == kSpecialisedSubsteps;
    constexpr int S = kSpecialisedSubsteps;
    auto kernel = quad_type == 2 ? (spec ? quad_rollout_kernel<2, S> : quad_rollout_kernel<2, 0>)
                                 : (spec ? quad_rollout_kernel<3, S> : quad_rollout_kernel<3, 0>);
    kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)state0, (const float*)cfg, (const float*)actions,
        (const float*)x_goal, (float*)state_out, (float*)step_out, (float*)reward_out,
        (float*)done_out, (float*)viol_out, B, T, n_substeps, dt, seed, n_goal, flags);
    return (int)cudaGetLastError();
  }
  const int nx = quad_type == 2 ? 6 : 12, nu = quad_type == 2 ? 2 : 4;
  if (!scg::policy_geometry_ok(policy, nx, nu, h1, h2, w2_rows, w2_cols, envs, threads,
                                smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool chunked = w2_cols < h2;
  auto kernel = quad_type == 2 ? (chunked ? quad_policy_rollout_kernel<2, true>
                                          : quad_policy_rollout_kernel<2, false>)
                               : (chunked ? quad_policy_rollout_kernel<3, true>
                                          : quad_policy_rollout_kernel<3, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + envs - 1) / envs, threads, smem, (cudaStream_t)stream>>>(
      (const float*)state0, (const float*)cfg, (const float*)x_goal, (const float*)policy,
      (float*)state_out, (float*)step_out, (float*)reward_out, (float*)done_out,
      (float*)viol_out, B, T, n_substeps, dt, seed, n_goal, h1, h2, nu_out, w2_rows,
      w2_cols, clip_obs, flags);
  return (int)cudaGetLastError();
}

// counts: six zeroed uint64 (exact_math_check_kernel).
int scg_exact_math_check(void* counts, void* stream) {
  exact_math_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
