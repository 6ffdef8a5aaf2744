"""Floating-point operations of one PPO training iteration, counted from the
algorithm (``README.md`` says from which source lines): a multiply and an add
per weight and row for each product; the backward pass the products of every
weight's gradient and of every layer's input gradient but the first layer's
(the observations need none); the physics substeps as ``counts/rollout.py``
counts them."""

from __future__ import annotations

from gpubench.counts.rollout import OPS_INVARIANT, OPS_SUBSTEP

# The 3D quad's env step outside the substeps, per env: denormalize and clip
# (3 x 4), the motor model (9 x 4), forces and yaw torque (19), the reward
# (12 x 4 + 4 x 4 + 2), bounds and time limit (6 x 4 + 4), the reset's draw
# and select (3 x 4 + 2 x 12).
OPS_ENV_REST = 12 + 36 + 19 + 66 + 28 + 36


def mlp_matmul_params(sizes):
    """Weights of an MLP with layer sizes ``sizes`` (in, hidden..., out)."""
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def iteration_flops(system, n_envs, n_steps, n_substeps, obs_dim, act_dim, hidden,
                    epochs, minibatch, n_minibatches, env=True):
    """One iteration: T steps of N envs (an actor forward, two critic
    forwards, the env step), the bootstrap value, then ``epochs`` epochs of
    ``n_minibatches`` minibatches of ``minibatch`` rows (actor and critic
    forward and backward). ``env`` False leaves out the env step: what is
    left are the products alone."""
    p_actor = mlp_matmul_params([obs_dim, hidden, hidden, act_dim])
    p_critic = mlp_matmul_params([obs_dim, hidden, hidden, 1])
    env_ops = n_substeps * OPS_SUBSTEP[system] + OPS_INVARIANT[system] + OPS_ENV_REST
    per_step = 2 * p_actor + 2 * (2 * p_critic) + (env_ops if env else 0)
    rollout = n_envs * n_steps * per_step + n_envs * 2 * p_critic
    backward = 2 * (2 * p_actor - obs_dim * hidden) + 2 * (2 * p_critic - obs_dim * hidden)
    update = epochs * n_minibatches * minibatch * (2 * p_actor + 2 * p_critic + backward)
    return rollout + update
