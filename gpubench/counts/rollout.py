"""Operations and bytes of the whole-rollout kernels (K4, K5), open loop and
in policy mode, counted from the algorithm (``README.md`` beside this file
says from which source lines). Per env and control step unless a name says
otherwise; a sine or cosine, a divide, a square root and an exponential
count one operation each, as a multiply or an add does."""

from __future__ import annotations

# Per env and physics substep. Cartpole: sin, cos, the reciprocal and 28
# multiplies, adds and subtracts; 3D quad: three sin/cos pairs, three
# divides and 60 others.
OPS_SUBSTEP = {'cartpole': 31, 'quadrotor_3D': 69}
# Per env and launch: the substeps' hoisted invariants.
OPS_INVARIANT = {'cartpole': 10, 'quadrotor_3D': 25}
# Philox4x32-10 (10 rounds of two 32-bit multiplies with their high halves,
# four xors and two key adds) per four words, and the four uniform
# conversions.
OPS_PHILOX = 10 * 10
OPS_UNIFORM4 = 3 * 4
# K4's other work per env and control step.
OPS_STEP_REST = {'uniform': OPS_UNIFORM4, 'box_muller': 8, 'action': 6, 'reward': 20,
                 'done': 12, 'violation': 12, 'reset': 12}
NX = {'cartpole': 4, 'quadrotor_3D': 12}
NU = {'cartpole': 1, 'quadrotor_3D': 4}
N_OOB = {'quadrotor_3D': 6}
CFG_FLOATS = {'cartpole': 40, 'quadrotor_3D': 105}


def open_loop_ops(system, batch, n_steps, n_substeps, *, draw_actions=True,
                  constrained=False, randomized_reset=False, done_total=0.0):
    """Operations of one ``batch``-env, ``n_steps``-step launch;
    ``done_total`` is the launch's summed done count (K5 draws a fresh state
    only where an env is done)."""
    if system == 'cartpole':
        ops = n_substeps * OPS_SUBSTEP[system] + OPS_STEP_REST['action'] \
            + OPS_STEP_REST['reward'] + OPS_STEP_REST['done'] + OPS_STEP_REST['reset']
        if draw_actions or constrained:
            ops += OPS_PHILOX + OPS_STEP_REST['uniform']
        if randomized_reset:
            ops += OPS_PHILOX + OPS_STEP_REST['uniform']
        if constrained:
            ops += OPS_STEP_REST['box_muller'] + OPS_STEP_REST['violation']
        return batch * n_steps * ops
    nx, nu = NX[system], NU[system]
    ops = n_substeps * OPS_SUBSTEP[system] + OPS_INVARIANT[system]
    ops += nu * (4 + 9)                  # denormalize, clip; motor model
    ops += 19                            # rotor forces and yaw torque
    ops += nx * 6 + nu * 4 + 2           # reward
    ops += N_OOB[system] * 4 + 4         # done
    ops += 3                             # accumulators
    if draw_actions:
        ops += OPS_PHILOX + OPS_UNIFORM4 + 2 * nu
    if constrained:
        ops += OPS_PHILOX + OPS_UNIFORM4 + nu // 2 * 13 + (nx + nu) * 4
    n = batch * n_steps * ops
    reset_words = (nx + 3) // 4 * (OPS_PHILOX + OPS_UNIFORM4) if randomized_reset else 0
    return n + done_total * (reset_words + 2 * nx)


def open_loop_bytes(system, batch):
    """Bytes of one launch: the start states read, the final states and the
    four per-env results written, and the parameter vector."""
    nx = NX[system]
    return batch * (nx * 4 + nx * 4 + 4 * 4) + CFG_FLOATS[system] * 4


def mlp_ops(nx, h1, h2, nu):
    """One actor forward as the kernel runs it: a multiply and an add per
    weight (of the output layer's units only the first ``nu``), the biases
    and activations, and the normalization of the input."""
    return 2 * (nx * h1 + h1 * h2 + h2 * nu) + 2 * (h1 + h2) + nu + 4 * nx


def policy_ops(system, batch, n_steps, n_substeps, h1, h2, *, constrained=False,
               randomized_reset=False, done_total=0.0):
    """Operations of one deterministic policy-mode launch: the open loop's,
    without the action draw, and the actor on every env and step."""
    base = open_loop_ops(system, batch, n_steps, n_substeps, draw_actions=False,
                         constrained=constrained, randomized_reset=randomized_reset,
                         done_total=done_total)
    return base + batch * n_steps * mlp_ops(NX[system], h1, h2, NU[system])


def policy_bytes(system, batch, h1, h2):
    """Bytes of one policy-mode launch: the open loop's and the actor the
    kernel reads (normalization, W1, b1, W2, b2, the first nu columns of W3
    and b3)."""
    nx, nu = NX[system], NU[system]
    weights = 2 * nx + nx * h1 + h1 + h1 * h2 + h2 + h2 * nu + nu
    return open_loop_bytes(system, batch) + 4 * weights
