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
// bound by the dependent chain of one env (T x n_substeps substeps of
// sin/cos, a reciprocal and a dozen multiplies and adds, each needing the
// last), not by FLOP/s or bytes.
//
// K4's open loop, cartpole_rollout_kernel<N>. The chain is coupled (the
// angular acceleration needs sin and cos of the angle, and the reciprocal of
// a term in cos^2), so the work is to keep everything else off it. With the
// library's sinf, cosf and reciprocal each ending in a branch to its slow
// path, the warp stalled at every one and a substep took about 390 cycles
// against a chain of about 140 (kernel_first_check --chain). The design:
// exact_math.cuh's branch-free copies (one range reduction for sin and cos,
// the step recomputed with the library's functions where an operand was
// special); N = 20 substeps compiled in, run in unrolled chunks
// (rollout_modes.cuh), N = 0 for other counts; the next step's draw of rows
// 0-3 in the same basic block as the substeps, so its Philox rounds fill
// the issue slots the chain leaves idle; the reset rows drawn only for an
// env that is done. In policy mode the actor's float32 products dominate
// each step, and a separate kernel, cartpole_policy_rollout_kernel, runs
// them with the whole block (policy_mlp.cuh) and the library's substeps; both
// kernels share the action, reward, done and reset code (cartpole_step).
//
// Numerics. Every expression follows the plain PyTorch version
// (ops/physics_kernels.py, ops/rollout_kernels.py) operation for
// operation, and the file is built with --fmad=false and without fast-math
// intrinsics (ops/_build.py), so each float op rounds as PyTorch's own
// elementwise op does; exact_math.cuh's copies give the library's results
// bit for bit.
//
// Launch shape. For K1 and K4's open loop the wrappers pick the block size so
// that the grid covers every SM (32 threads a block at B=4096 on 132 SMs):
// with one thread per env, a larger block would leave most SMs idle. The
// policy mode launches 256 threads for every 32 envs.
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

#include "exact_math.cuh"
#include "philox.cuh"
#include "policy_mlp.cuh"
#include "rollout_modes.cuh"

namespace {

using scg::F_POLICY;
using scg::F_POLICY_RELU;
using scg::kTwoPi;
using scg::Modes;
using scg::modes;
using scg::rcp_exact;
using scg::sincos_exact;
using scg::standard_normal;
using scg::uniform4;

// The substep count the open loop compiles in (ops/rollout_kernels.py
// SPECIALISED_SUBSTEPS); other counts loop over the runtime count.
constexpr int kSpecialisedSubsteps = 20;

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

// cartpole_substeps without the tab force, every float op as there, but
// with exact_math.cuh's branch-free sin/cos and reciprocal: N > 0 substeps
// compiled in (in unrolled chunks, rollout_modes.cuh), or n if N == 0. Returns false where an
// operand was special; the caller then recomputes the step with
// cartpole_substeps.
template <int N>
__device__ __forceinline__ bool cartpole_substeps_exact(float& x, float& xd, float& th,
                                                        float& thd, float force, float m,
                                                        float M, float L, float g, int n,
                                                        float dt) {
  const float Mm = m + M;
  const float ml = m * L;
  const float a11 = Mm;
  const float a22 = kFourThirds * m * L * L;
  const float f1 = force + 0.0f;
  const float mgL = m * g * L;
  const float fxL = 0.0f * L;
  const float fzL = 0.0f * L;
  const float a11a22 = a11 * a22;
  bool ok = true;
  auto substep = [&]() {
    float sin_t, cos_t, inv_det;
    ok &= sincos_exact(th, sin_t, cos_t);
    const float a12 = ml * cos_t;
    const float b1 = f1 + ml * thd * thd * sin_t;
    const float b2 = mgL * sin_t + fxL * cos_t - fzL * sin_t;
    ok &= rcp_exact(a11a22 - a12 * a12, inv_det);
    const float x_dd = (a22 * b1 - a12 * b2) * inv_det;
    const float th_dd = (a11 * b2 - a12 * b1) * inv_det;
    xd = xd + dt * x_dd;
    thd = thd + dt * th_dd;
    x = x + dt * xd;
    th = th + dt * thd;
  };
  if constexpr (N > 0) {
    scg::chunked_substeps<N>(substep);
  } else {
    for (int i = 0; i < n; ++i) substep();
  }
  return ok;
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

// One env of the rollout: its state and what it accumulates.
struct CartEnv {
  float x, xd, th, thd;
  int step;
  float reward_sum;
  int done_count, viol_count;
};

__device__ __forceinline__ CartEnv load_env(const float* __restrict__ state0, int b) {
  return CartEnv{state0[4 * b + 0], state0[4 * b + 1], state0[4 * b + 2],
                 state0[4 * b + 3], 0, 0.0f, 0, 0};
}

__device__ __forceinline__ void store_env(const CartEnv& e, int b, float* __restrict__ state_out,
                                          float* __restrict__ step_out,
                                          float* __restrict__ reward_out,
                                          float* __restrict__ done_out,
                                          float* __restrict__ viol_out) {
  state_out[4 * b + 0] = e.x;
  state_out[4 * b + 1] = e.xd;
  state_out[4 * b + 2] = e.th;
  state_out[4 * b + 3] = e.thd;
  step_out[b] = (float)e.step;
  reward_out[b] = e.reward_sum;
  done_out[b] = (float)e.done_count;
  viol_out[b] = (float)e.viol_count;
}

// The action pipeline of one step: physical -> noisy (white noise from rows
// 1-2) -> clipped force.
__device__ __forceinline__ void cartpole_action(const Modes& m, const float (&c)[CFG_LEN],
                                                float raw, const float* rnd, float& noisy,
                                                float& force) {
  const float phys = raw * c[ACT_SCALE];
  noisy = phys;
  if (m.action_noise) noisy = phys + c[NOISE_STD] * standard_normal(rnd[1], rnd[2]);
  force = fminf(fmaxf(noisy, c[PHYS_LO]), c[PHYS_HI]);
}

// After the substeps: the reward (into rew), done before the reset (the
// return value) and the violation count.
__device__ __forceinline__ bool cartpole_outcome(const Modes& m, const float (&c)[CFG_LEN],
                                                 float noisy, float force,
                                                 const float* __restrict__ x_goal,
                                                 int n_goal, CartEnv& e, float& rew) {
  // Goal: constant, or this env's own waypoint X_GOAL[step + 1]
  // (X_GOAL[step] under the quadratic cost).
  float g0 = c[GOAL + 0], g1 = c[GOAL + 1], g2 = c[GOAL + 2], g3 = c[GOAL + 3];
  if (m.tracking) {
    const int idx = min(e.step + (m.quadratic ? 0 : 1), n_goal - 1);
    g0 = x_goal[4 * idx + 0];
    g1 = x_goal[4 * idx + 1];
    g2 = x_goal[4 * idx + 2];
    g3 = x_goal[4 * idx + 3];
  }
  const float e0 = e.x - g0, e1 = e.xd - g1, e3 = e.thd - g3;
  if (m.quadratic) {
    // Unwrapped angle, clipped action against U_GOAL, never exponential.
    const float e2q = e.th - g2;
    const float du = force - c[U_GOAL];
    rew = -(c[W_STATE + 0] * e0 * e0 + c[W_STATE + 1] * e1 * e1
            + c[W_STATE + 2] * e2q * e2q + c[W_STATE + 3] * e3 * e3
            + c[W_ACT] * du * du);
  } else {
    // Wrapped angle and the noisy action.
    const float ew = wrap_angle(e.th) - g2;
    const float dist = c[W_STATE + 0] * e0 * e0 + c[W_STATE + 1] * e1 * e1
        + c[W_STATE + 2] * ew * ew + c[W_STATE + 3] * e3 * e3
        + c[W_ACT] * noisy * noisy;
    rew = m.rew_exponential ? expf(-dist) : -dist;
  }

  // Done: goal (stabilization only, unwrapped), out of bounds, time limit.
  bool done = false;
  if (!m.tracking) {
    const float e2 = e.th - c[GOAL + 2];
    done = e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3 < c[TOL_SQ];
  }
  if (m.done_on_oob) {
    done = done || fabsf(e.x) > c[X_THRESH] || fabsf(e.th) > c[TH_THRESH];
  }
  done = done || (float)(e.step + 1) >= c[MAX_STEPS];

  // Default state box and input box, on the noisy pre-clip action.
  if (m.constrained) {
    const bool viol = fabsf(e.x) > c[CON_HI + 0] || fabsf(e.xd) > c[CON_HI + 1]
        || fabsf(e.th) > c[CON_HI + 2] || fabsf(e.thd) > c[CON_HI + 3]
        || noisy > c[PHYS_HI] || noisy < c[PHYS_LO];
    e.viol_count += viol;
  }
  return done;
}

// The auto-reset of a done env (fresh state from rows 4-7, or INIT_LO) and
// the counters.
__device__ __forceinline__ void cartpole_finish(const Modes& m, const float (&c)[CFG_LEN],
                                                bool done, const float* rnd, float rew,
                                                CartEnv& e) {
  if (done) {
    if (m.randomized_reset) {
      e.x = c[INIT_LO + 0] + rnd[4] * (c[INIT_HI + 0] - c[INIT_LO + 0]);
      e.xd = c[INIT_LO + 1] + rnd[5] * (c[INIT_HI + 1] - c[INIT_LO + 1]);
      e.th = c[INIT_LO + 2] + rnd[6] * (c[INIT_HI + 2] - c[INIT_LO + 2]);
      e.thd = c[INIT_LO + 3] + rnd[7] * (c[INIT_HI + 3] - c[INIT_LO + 3]);
    } else {
      e.x = c[INIT_LO + 0];
      e.xd = c[INIT_LO + 1];
      e.th = c[INIT_LO + 2];
      e.thd = c[INIT_LO + 3];
    }
  }
  e.step = done ? 0 : e.step + 1;
  e.reward_sum += rew;
  e.done_count += done;
}

// The rest of one control step after the raw action, for one env (policy
// mode): physical -> noisy -> clipped action, the substeps, reward, done,
// violations and the auto-reset. rnd holds the step's eight random rows.
__device__ __forceinline__ void cartpole_step(const Modes& m, const float (&c)[CFG_LEN],
                                              float raw, const float (&rnd)[8],
                                              const float* __restrict__ x_goal,
                                              int n_goal, int n_substeps, float dt,
                                              CartEnv& e) {
  float noisy, force, rew;
  cartpole_action(m, c, raw, rnd, noisy, force);
  cartpole_substeps(e.x, e.xd, e.th, e.thd, force, 0.0f, 0.0f, c[POLE_MASS],
                    c[CART_MASS], c[POLE_LEN], c[GRAVITY], n_substeps, dt);
  const bool done = cartpole_outcome(m, c, noisy, force, x_goal, n_goal, e, rew);
  cartpole_finish(m, c, done, rnd, rew, e);
}

// The open loop: one thread per env, actions drawn or replayed; N substeps
// compiled in, or n_substeps if N == 0. A step's substeps run
// cartpole_substeps_exact (the library's cartpole_substeps where it reports a
// special operand) in one basic block, together with the next step's draw of
// rows 0-3, whose Philox rounds fill the issue slots the substeps' chain
// leaves idle. The reset rows 4-7 are drawn only for an env that is done
// (the plain version draws them every step and selects: the same words).
template <int N>
__global__ void cartpole_rollout_kernel(
    const float* __restrict__ state0, const float* __restrict__ cfg_g,
    const float* __restrict__ actions, const float* __restrict__ x_goal,
    float* __restrict__ state_out, float* __restrict__ step_out,
    float* __restrict__ reward_out, float* __restrict__ done_out,
    float* __restrict__ viol_out, int B, int T, int n_substeps, float dt,
    uint32_t seed, int n_goal, int flags) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c[CFG_LEN];
#pragma unroll
  for (int k = 0; k < CFG_LEN; ++k) c[k] = cfg_g[k];
  const Modes m = modes(flags);
  CartEnv e = load_env(state0, b);

  float rnd[8];
  uniform4(seed, b, 0, 0u, rnd);
  for (int t = 0; t < T; ++t) {
    const float raw = m.draw_actions ? c[ACT_LO] + rnd[0] * (c[ACT_HI] - c[ACT_LO])
                                     : actions[(size_t)t * B + b];
    float noisy, force, rew;
    cartpole_action(m, c, raw, rnd, noisy, force);
    float next[4];
    uniform4(seed, b, t + 1, 0u, next);
    const CartEnv start = e;
    if (!cartpole_substeps_exact<N>(e.x, e.xd, e.th, e.thd, force, c[POLE_MASS],
                                    c[CART_MASS], c[POLE_LEN], c[GRAVITY], n_substeps, dt)) {
      e = start;
      cartpole_substeps(e.x, e.xd, e.th, e.thd, force, 0.0f, 0.0f, c[POLE_MASS],
                        c[CART_MASS], c[POLE_LEN], c[GRAVITY], n_substeps, dt);
    }
    const bool done = cartpole_outcome(m, c, noisy, force, x_goal, n_goal, e, rew);
    if (done && m.randomized_reset) uniform4(seed, b, t, 1u, rnd + 4);
    cartpole_finish(m, c, done, rnd, rew, e);
#pragma unroll
    for (int k = 0; k < 4; ++k) rnd[k] = next[k];
  }
  store_env(e, b, state_out, step_out, reward_out, done_out, viol_out);
}

// The closed loop (policy_mlp.cuh): a block of kPolicyThreads threads for
// kPolicyEnvs envs. The threads of warp 0 own one env each and run
// cartpole_step; the whole block runs the actor. A thread past the last env
// of a partly filled tile keeps a zero state and skips the step, but stays in
// the loop for the block's barriers.
// CHUNKED: H2 runs in chunks of w2_cols units (policy_mlp.cuh).
template <bool CHUNKED>
__global__ void __launch_bounds__(scg::kPolicyThreads) cartpole_policy_rollout_kernel(
    const float* __restrict__ state0, const float* __restrict__ cfg_g,
    const float* __restrict__ x_goal, const float* __restrict__ policy_p,
    float* __restrict__ state_out, float* __restrict__ step_out,
    float* __restrict__ reward_out, float* __restrict__ done_out,
    float* __restrict__ viol_out, int B, int T, int n_substeps, float dt,
    uint32_t seed, int n_goal, int h1, int h2, int nu_out, int w2_rows, int w2_cols,
    float clip_obs, int flags) {
  const scg::PolicyMLP mlp{policy_p, h1, h2, nu_out, clip_obs, (flags & F_POLICY_RELU) != 0};
  const scg::PolicySmem sm = scg::policy_smem(4, 1, h1, h2, w2_rows, w2_cols);
  const bool w2_resident = scg::policy_w2_resident(h1, h2, w2_rows, w2_cols);
  scg::W2Ring<CHUNKED> ring;
  scg::policy_stage<4, 1>(mlp, sm, w2_rows, w2_cols, ring);
  __syncthreads();

  const int lane = threadIdx.x;
  const int b = blockIdx.x * scg::kPolicyEnvs + lane;
  const bool env_thread = lane < scg::kPolicyEnvs;
  const bool live = env_thread && b < B;
  float c[CFG_LEN];
#pragma unroll
  for (int k = 0; k < CFG_LEN; ++k) c[k] = cfg_g[k];
  const Modes m = modes(flags);
  CartEnv e = live ? load_env(state0, b) : CartEnv{0.0f, 0.0f, 0.0f, 0.0f, 0, 0.0f, 0, 0};

  for (int t = 0; t < T; ++t) {
    if (env_thread) {
      const float s[4] = {e.x, e.xd, e.th, e.thd};
      scg::policy_write_obs<4>(mlp, sm, s, lane);
    }
    scg::policy_actor<4, 1>(mlp, sm, w2_resident, w2_cols, ring);
    if (live) {
      // The actor's mean, exploration noise from rows 0 and 3, the squash.
      float rnd[8];
      if (m.action_noise || m.policy_stochastic) uniform4(seed, b, t, 0u, rnd);
      if (m.randomized_reset) uniform4(seed, b, t, 1u, rnd + 4);
      float raw = sm.mu[lane];
      if (m.policy_stochastic) raw = raw + c[P_STD] * standard_normal(rnd[0], rnd[3]);
      if (m.policy_squash) raw = tanhf(raw);
      cartpole_step(m, c, raw, rnd, x_goal, n_goal, n_substeps, dt, e);
    }
  }
  ring.drain();
  if (live) store_env(e, b, state_out, step_out, reward_out, done_out, viol_out);
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
// widths h1, h2, nu_out, read when flags has F_POLICY. A policy launch takes
// the geometry of ops/rollout_kernels.py _policy_launch (envs and threads a
// block, W2's rows and columns a tile, dynamic shared memory bytes) and
// refuses any other; an open-loop launch takes `threads` a block and ignores
// the rest.
int scg_cartpole_rollout(const void* state0, const void* cfg,
                         const void* actions, const void* x_goal,
                         const void* policy, void* state_out, void* step_out,
                         void* reward_out, void* done_out, void* viol_out, int B,
                         int T, int n_substeps, float dt, unsigned int seed,
                         int n_goal, int h1, int h2, int nu_out, float clip_obs,
                         int flags, int threads, int envs, int w2_rows, int w2_cols,
                         int smem, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (!(flags & F_POLICY)) {
    auto kernel = n_substeps == kSpecialisedSubsteps
        ? cartpole_rollout_kernel<kSpecialisedSubsteps> : cartpole_rollout_kernel<0>;
    kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)state0, (const float*)cfg, (const float*)actions,
        (const float*)x_goal, (float*)state_out, (float*)step_out, (float*)reward_out,
        (float*)done_out, (float*)viol_out, B, T, n_substeps, dt, seed, n_goal, flags);
    return (int)cudaGetLastError();
  }
  if (!scg::policy_geometry_ok(policy, 4, 1, h1, h2, w2_rows, w2_cols, envs, threads,
                                smem)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = w2_cols < h2 ? cartpole_policy_rollout_kernel<true>
                             : cartpole_policy_rollout_kernel<false>;
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

}  // extern "C"
