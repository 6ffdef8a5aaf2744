// The mode bits of the rollout kernels, K4 (cartpole_kernels.cu) and K5
// (quad_kernels.cu), and their decoded form, read once per launch.

#pragma once

namespace scg {

// Mode bits of the kernels' flags argument (ops/rollout_kernels.py _FLAGS).
enum {
  F_DRAW_ACTIONS = 1, F_CONSTRAINED = 2, F_ACTION_NOISE = 4,
  F_RANDOMIZED_RESET = 8, F_REW_EXPONENTIAL = 16, F_DONE_ON_OOB = 32,
  F_TRACKING = 64, F_QUADRATIC_COST = 128, F_POLICY = 256,
  F_POLICY_STOCHASTIC = 512, F_POLICY_SQUASH = 1024, F_POLICY_RELU = 2048
};

struct Modes {
  bool draw_actions, constrained, action_noise, randomized_reset, rew_exponential,
      done_on_oob, tracking, quadratic, policy_stochastic, policy_squash;
};

__device__ __forceinline__ Modes modes(int flags) {
  return Modes{(flags & F_DRAW_ACTIONS) != 0, (flags & F_CONSTRAINED) != 0,
               (flags & F_ACTION_NOISE) != 0, (flags & F_RANDOMIZED_RESET) != 0,
               (flags & F_REW_EXPONENTIAL) != 0, (flags & F_DONE_ON_OOB) != 0,
               (flags & F_TRACKING) != 0, (flags & F_QUADRATIC_COST) != 0,
               (flags & F_POLICY_STOCHASTIC) != 0, (flags & F_POLICY_SQUASH) != 0};
}

}  // namespace scg
