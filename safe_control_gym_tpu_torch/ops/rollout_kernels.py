"""K4: the whole open-loop cartpole rollout in one launch, as a CUDA kernel and in
plain PyTorch.

Port of the cartpole part of ``safe_control_gym_tpu/ops/rollout_kernels.py``:
``cartpole_rollout_pallas`` and its body ``_cartpole_rollout_kernel``, the cfg
layout ``_C``, and the cfg function with its coverage gates. The CUDA kernel is
``cartpole_rollout_kernel`` in ``csrc/cartpole_kernels.cu``.

Each of the T steps runs, per env: the action (a uniform draw or the replayed
row), denormalize, white-noise action disturbance, clip, K1's substeps, the
reward (``rl_reward`` or quadratic cost), done on goal / out of bounds / time
limit, the default-box violation count, and the auto-reset; the state, the
step counter and three accumulators are written once at the end.

Design on the card. The TPU kernel ran ``grid=(T,)`` over lane-major (8, B)
blocks. Here one thread owns one env and loops over T, so the state, the step
counter and the accumulators stay in registers for the whole rollout. Replayed
actions are read as ``actions[t * B + b]`` (coalesced across a warp); a tracking
env reads its own waypoint ``x_goal[idx]`` directly, which replaces the TPU's
one-hot matrix gather and its 4096-step cap. At B=4096 one thread per env is
about one warp per SM, so the kernel is bound by the latency of its serial
chain (T x n_substeps dependent substeps of sin, cos and a reciprocal), not by
FLOP/s or bytes.

Randomness. A Philox4x32-10 written out in the kernel, keyed on ``(seed, 0)``
with the counter ``(env, step, j, 0)`` for j = 0, 1: eight uint32 per env and
step, the TPU kernel's eight random rows (0: action, 1-2: Box-Muller pair of the
action noise, 4-7: the fresh auto-reset state; 3 is the policy mode's). A
uniform is ``(bits >> 8) * 2^-24``; Box-Muller uses the cos half only. The plain
version runs the same Philox on int64 tensors, so kernel and plain version draw
identical numbers and can be compared value by value.

The closed-loop policy mode (``policy_params``) comes with the closed-loop
slice; until then the wrapper raises on it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops._launch import block_size, check_tensor
from safe_control_gym_tpu_torch.ops.physics_kernels import cartpole_substeps

__all__ = ['cartpole_rollout', 'cartpole_rollout_plain', 'cartpole_rollout_cfg',
           'rollout_task_kwargs', 'philox4x32_10', 'philox_uniform4',
           'standard_normal', 'wrap_angle', 'CARTPOLE_CFG_LEN']

_TWO_PI = 6.283185307179586
_INV_2PI = 1.0 / _TWO_PI
_U24 = 2.0 ** -24
_MASK32 = 0xFFFFFFFF

# cfg vector layout (f32), as in the JAX package. Grouped: dynamics, action
# pipeline, task, episode, init randomization, reward weights, constraint box.
_C = dict(
    POLE_MASS=0, CART_MASS=1, POLE_LEN=2, GRAVITY=3,
    ACT_LO=4, ACT_HI=5, ACT_SCALE=6, PHYS_LO=7, PHYS_HI=8,
    GOAL=9,            # 9..12: goal state
    TOL_SQ=13, X_THRESH=14, TH_THRESH=15, MAX_STEPS=16,
    W_ACT=17, NOISE_STD=18,
    INIT_LO=19,        # 19..22: fresh-state low (nominal + rand low)
    INIT_HI=23,        # 23..26: fresh-state high
    W_STATE=27,        # 27..30: reward state weights
    CON_HI=31,         # 31..34: symmetric state-box constraint bound
    P_STD=35,          # 35..38: policy exploration std per action dim
    U_GOAL=39,         # quadratic-cost action reference
)
CARTPOLE_CFG_LEN = 40

# Mode bits of the kernel's ``flags`` argument (csrc/cartpole_kernels.cu).
_FLAGS = dict(draw_actions=1, constrained=2, action_noise=4,
              randomized_reset=8, rew_exponential=16, done_on_oob=32,
              tracking=64, quadratic_cost=128)


# ---------------------------------------------------------------------------
# Philox4x32-10 and the helpers built on it (plain versions)
# ---------------------------------------------------------------------------

def _mulhilo32(a: int, b):
    """(hi, lo) 32-bit halves of the constant ``a`` times the uint32 values
    ``b`` (int64 tensor), without overflowing int64: b is split in 16-bit
    halves so every partial product stays below 2^49."""
    p1 = a * (b >> 16)
    p0 = a * (b & 0xFFFF)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    counter words; returns the four uint32 output words (int64 tensors)."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo32(0xD2511F53, c0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniform4(seed: int, env_idx, step: int, j: int):
    """Four float32 U[0, 1) per env from counter (env, step, j, 0) under key
    (seed, 0): the high 24 bits of each Philox word times 2^-24."""
    full = lambda v: torch.full_like(env_idx, v)
    words = philox4x32_10(env_idx, full(step & _MASK32), full(j), full(0),
                          int(seed) & _MASK32, 0)
    return [(w >> 8).to(torch.float32) * _U24 for w in words]


def standard_normal(u1, u2):
    """Box-Muller, cos half only: two uniforms -> one standard normal."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos(_TWO_PI * u2)


def wrap_angle(th):
    """((th + pi) mod 2 pi) - pi with floor semantics, as th - 2 pi floor(...)."""
    return th - _TWO_PI * torch.floor((th + math.pi) * _INV_2PI)


# ---------------------------------------------------------------------------
# The rollout
# ---------------------------------------------------------------------------

def _modes(draw_actions, constrained, action_noise, randomized_reset,
           rew_exponential, done_on_oob, tracking, quadratic_cost):
    return dict(draw_actions=bool(draw_actions), constrained=bool(constrained),
                action_noise=bool(constrained if action_noise is None
                                  else action_noise),
                randomized_reset=bool(randomized_reset),
                rew_exponential=bool(rew_exponential),
                done_on_oob=bool(done_on_oob), tracking=bool(tracking),
                quadratic_cost=bool(quadratic_cost))


def cartpole_rollout_plain(state0, cfg, seed, n_steps: int, n_substeps: int,
                           dt: float, actions=None, draw_actions: bool = True,
                           constrained: bool = False, action_noise=None,
                           randomized_reset: bool = True,
                           rew_exponential: bool = True,
                           done_on_oob: bool = True, x_goal=None,
                           quadratic_cost: bool = False):
    """The plain version of K4: the same T-step loop, one PyTorch op at a
    time, on whatever device the inputs are. Arguments and result as
    :func:`cartpole_rollout`."""
    m = _modes(draw_actions, constrained, action_noise, randomized_reset,
               rew_exponential, done_on_oob, x_goal is not None, quadratic_cost)
    dev = state0.device
    B = state0.shape[0]
    # Scalars of the cfg as Python floats holding float32 values; a difference
    # of two is taken in float32 first, as the kernel does.
    c = np.asarray(cfg.detach().cpu(), np.float32)
    C = lambda k, off=0: float(c[_C[k] + off])
    span = lambda hi, lo, off=0: float(c[_C[hi] + off] - c[_C[lo] + off])
    params = cfg[:4].to(torch.float32)
    zero = torch.zeros((B,), dtype=torch.float32, device=dev)
    env_idx = torch.arange(B, dtype=torch.int64, device=dev)
    n_goal = 1 if x_goal is None else int(x_goal.shape[0])

    x, xd, th, thd = (state0[:, k].to(torch.float32) for k in range(4))
    step = torch.zeros((B,), dtype=torch.int64, device=dev)
    reward_sum = zero.clone()
    done_count = zero.clone()
    viol_count = zero.clone()
    for t in range(n_steps):
        rnd = [None] * 8
        if m['draw_actions'] or m['action_noise']:
            rnd[0:4] = philox_uniform4(seed, env_idx, t, 0)
        if m['randomized_reset']:
            rnd[4:8] = philox_uniform4(seed, env_idx, t, 1)

        # Action pipeline: raw -> physical -> noisy -> clipped.
        if m['draw_actions']:
            raw = C('ACT_LO') + rnd[0] * span('ACT_HI', 'ACT_LO')
        else:
            raw = actions[t].to(torch.float32)
        phys = raw * C('ACT_SCALE')
        noisy = phys
        if m['action_noise']:
            noisy = phys + C('NOISE_STD') * standard_normal(rnd[1], rnd[2])
        force = torch.clamp(noisy, C('PHYS_LO'), C('PHYS_HI'))

        x, xd, th, thd = cartpole_substeps(x, xd, th, thd, force, zero, zero,
                                           params[0], params[1], params[2],
                                           params[3], n_substeps, dt)

        # Goal: constant, or this env's own waypoint X_GOAL[step + 1]
        # (X_GOAL[step] under the quadratic cost).
        if m['tracking']:
            inc = 0 if m['quadratic_cost'] else 1
            g = x_goal[torch.clamp(step + inc, max=n_goal - 1)]
            g0, g1, g2, g3 = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        else:
            g0, g1, g2, g3 = (C('GOAL', k) for k in range(4))
        e0 = x - g0
        e1 = xd - g1
        e3 = thd - g3
        if m['quadratic_cost']:
            # Unwrapped angle, clipped action against U_GOAL, never exponential.
            e2q = th - g2
            du = force - C('U_GOAL')
            rew = -(C('W_STATE', 0) * e0 * e0 + C('W_STATE', 1) * e1 * e1
                    + C('W_STATE', 2) * e2q * e2q + C('W_STATE', 3) * e3 * e3
                    + C('W_ACT') * du * du)
        else:
            # Wrapped angle and the noisy action.
            ew = wrap_angle(th) - g2
            dist = (C('W_STATE', 0) * e0 * e0 + C('W_STATE', 1) * e1 * e1
                    + C('W_STATE', 2) * ew * ew + C('W_STATE', 3) * e3 * e3
                    + C('W_ACT') * noisy * noisy)
            rew = torch.exp(-dist) if m['rew_exponential'] else -dist

        # Done: goal (stabilization only, unwrapped), out of bounds, time limit.
        if m['tracking']:
            done = torch.zeros((B,), dtype=torch.bool, device=dev)
        else:
            e2 = th - C('GOAL', 2)
            done = e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3 < C('TOL_SQ')
        if m['done_on_oob']:
            done = done | (torch.abs(x) > C('X_THRESH')) \
                | (torch.abs(th) > C('TH_THRESH'))
        new_step = step + 1
        done = done | (new_step.to(torch.float32) >= C('MAX_STEPS'))

        # Default state box and input box, on the noisy pre-clip action.
        if m['constrained']:
            viol = ((torch.abs(x) > C('CON_HI', 0)) | (torch.abs(xd) > C('CON_HI', 1))
                    | (torch.abs(th) > C('CON_HI', 2)) | (torch.abs(thd) > C('CON_HI', 3))
                    | (noisy > C('PHYS_HI')) | (noisy < C('PHYS_LO')))
            viol_count = viol_count + viol.to(torch.float32)

        # Auto-reset: fresh states are drawn every step, selected where done.
        if m['randomized_reset']:
            fresh = [C('INIT_LO', k) + rnd[4 + k] * span('INIT_HI', 'INIT_LO', k)
                     for k in range(4)]
        else:
            fresh = [zero + C('INIT_LO', k) for k in range(4)]
        x = torch.where(done, fresh[0], x)
        xd = torch.where(done, fresh[1], xd)
        th = torch.where(done, fresh[2], th)
        thd = torch.where(done, fresh[3], thd)
        step = torch.where(done, torch.zeros_like(new_step), new_step)
        reward_sum = reward_sum + rew
        done_count = done_count + done.to(torch.float32)
    return {'state': torch.stack([x, xd, th, thd], dim=1),
            'ctrl_step': step.to(torch.float32), 'reward_sum': reward_sum,
            'done_count': done_count, 'violation_count': viol_count}


def cartpole_rollout(state0, cfg, seed, n_steps: int, n_substeps: int,
                     dt: float, actions=None, draw_actions: bool = True,
                     constrained: bool = False, action_noise=None,
                     randomized_reset: bool = True, rew_exponential: bool = True,
                     done_on_oob: bool = True, policy_params=None, x_goal=None,
                     quadratic_cost: bool = False):
    """Run ``n_steps`` full cartpole control steps in one kernel launch (K4).

    Args:
        state0: (B, 4) float32 initial states.
        cfg: (CARTPOLE_CFG_LEN,) float32 config vector (see ``_C``).
        seed: integer Philox key.
        actions: (n_steps, B) float32 raw actions, required when
            ``draw_actions`` is False (replay mode). With ``draw_actions`` the
            actions are drawn iid uniform in [ACT_LO, ACT_HI].
        constrained: count default state-box / input-box violations per env.
        action_noise: draw the NOISE_STD white-noise action disturbance;
            defaults to ``constrained``.
        randomized_reset: draw fresh states uniform in [INIT_LO, INIT_HI];
            otherwise reset to INIT_LO.
        policy_params: the closed-loop mode, not in this slice (raises).
        x_goal: (n_goal, 4) float32 tracking reference; None = stabilization.
        quadratic_cost: the quadratic cost instead of the RL reward.

    Returns:
        dict of ``state`` (B, 4), ``ctrl_step``, ``reward_sum``,
        ``done_count``, ``violation_count`` (B,), all float32. On the CPU the
        plain version computes them; on a CUDA device the kernel does.
    """
    if policy_params is not None:
        raise NotImplementedError(
            'cartpole_rollout: the closed-loop policy mode comes with the '
            'closed-loop slice of the port')
    if not draw_actions and actions is None:
        raise ValueError('cartpole_rollout: replay mode (draw_actions=False) '
                         'needs actions')
    dev = state0.device
    if dev.type == 'cpu':
        return cartpole_rollout_plain(
            state0, cfg, seed, n_steps, n_substeps, dt, actions=actions,
            draw_actions=draw_actions, constrained=constrained,
            action_noise=action_noise, randomized_reset=randomized_reset,
            rew_exponential=rew_exponential, done_on_oob=done_on_oob,
            x_goal=x_goal, quadratic_cost=quadratic_cost)
    if dev.type != 'cuda':
        raise ValueError(f'cartpole_rollout: unsupported device {dev}')
    m = _modes(draw_actions, constrained, action_noise, randomized_reset,
               rew_exponential, done_on_oob, x_goal is not None, quadratic_cost)
    B = state0.shape[0]
    check_tensor(state0, 'state0', (B, 4), dev)
    check_tensor(cfg, 'cfg', (CARTPOLE_CFG_LEN,), dev)
    if not m['draw_actions']:
        check_tensor(actions, 'actions', (n_steps, B), dev)
    n_goal = 1
    if m['tracking']:
        n_goal = int(x_goal.shape[0])
        check_tensor(x_goal, 'x_goal', (n_goal, 4), dev)
    flags = sum(bit for name, bit in _FLAGS.items() if m[name])
    state = torch.empty_like(state0)
    ctrl_step, reward_sum, done_count, violation_count = (
        torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(4))
    lib = _lib()
    err = lib.scg_cartpole_rollout(
        state0.data_ptr(), cfg.data_ptr(),
        actions.data_ptr() if not m['draw_actions'] else None,
        x_goal.data_ptr() if m['tracking'] else None,
        state.data_ptr(), ctrl_step.data_ptr(), reward_sum.data_ptr(),
        done_count.data_ptr(), violation_count.data_ptr(), B, int(n_steps),
        int(n_substeps), float(dt), int(seed) & _MASK32, n_goal, flags,
        block_size(B, dev), torch.cuda.current_stream(dev).cuda_stream)
    cartpole_rollout.launches += 1
    _build.check(lib, err, 'cartpole_rollout')
    return {'state': state, 'ctrl_step': ctrl_step, 'reward_sum': reward_sum,
            'done_count': done_count, 'violation_count': violation_count}


cartpole_rollout.launches = 0


def _lib():
    lib = _build.load_library('cartpole_kernels')
    if lib.scg_cartpole_rollout.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.scg_cartpole_rollout.argtypes = [
            p, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_float, ctypes.c_uint,
            i, i, i, p]
        lib.scg_cartpole_rollout.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# cfg vector and coverage gates
# ---------------------------------------------------------------------------

def rollout_task_kwargs(env):
    """Extra rollout kwargs for the env's task/cost mode: ``x_goal`` for
    TRAJ_TRACKING, ``quadratic_cost`` for Cost.QUADRATIC; empty for
    stabilization with the RL reward."""
    from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
    kw = {}
    if env.COST == Cost.QUADRATIC:
        kw['quadratic_cost'] = True
    if env.TASK == Task.TRAJ_TRACKING:
        kw['x_goal'] = torch.as_tensor(np.atleast_2d(env.X_GOAL), dtype=torch.float32,
                                       device=env.device).contiguous()
    return kw


def _check_default_constraints(env):
    """Raise ValueError unless the env's constraints are exactly what the
    ``constrained`` kernel hard-codes: the unmodified default state box and
    input box, counted only (no done on violation, no reward penalty)."""
    from safe_control_gym_tpu_torch.envs.constraints import DefaultConstraint
    cl = env.constraints
    if cl is None or not cl.constraints:
        return
    if env.DONE_ON_VIOLATION or env.use_constraint_penalty:
        raise ValueError('fused rollout counts violations only; '
                         'done_on_violation / constraint_penalty unsupported')
    by_var = {c.constrained_variable.value: c for c in cl.constraints}
    if len(cl.constraints) != 2 or set(by_var) != {'state', 'input'}:
        raise ValueError('fused rollout supports exactly the default '
                         'state-box + input-box constraints')
    expected = {'state': (env.state_space.low, env.state_space.high),
                'input': env.physical_action_bounds}
    for var, con in by_var.items():
        lo, hi = expected[var]
        if (type(con) is not DefaultConstraint or con.strict
                or not np.allclose(con.lower_bounds, lo)
                or not np.allclose(con.upper_bounds, hi)):
            raise ValueError('fused rollout supports only the unmodified '
                             f'default {var} box constraint')


def _check_task_cost(env):
    """Raise ValueError outside stabilization/tracking with the RL reward or a
    quadratic cost of diagonal Q/R."""
    from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
    if env.TASK not in (Task.STABILIZATION, Task.TRAJ_TRACKING):
        raise ValueError('fused rollout supports stabilization/tracking')
    if env.COST not in (Cost.RL_REWARD, Cost.QUADRATIC):
        raise ValueError('fused rollout supports rl_reward/quadratic cost')
    if env.COST == Cost.QUADRATIC:
        Q, R = np.asarray(env.Q), np.asarray(env.R)
        if not (np.allclose(Q, np.diag(np.diag(Q)))
                and np.allclose(R, np.diag(np.diag(R)))):
            raise ValueError('fused rollout: diagonal Q/R only')


def cartpole_rollout_cfg(env):
    """The (CARTPOLE_CFG_LEN,) float32 cfg vector of a CartPole env, on the
    env's device. Raises ValueError for configurations the kernel does not
    reproduce. NOISE_STD is left 0: the caller sets it from the action
    disturbance it wants drawn."""
    from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
    _check_task_cost(env)
    if env.RANDOMIZED_INERTIAL_PROP or env.adversary_disturbance:
        raise ValueError('fused rollout needs fixed params, no adversary')
    _check_default_constraints(env)
    if env.obs_wrap_angle:
        raise ValueError('fused rollout assumes raw-angle state obs')
    cfg = np.zeros(CARTPOLE_CFG_LEN, np.float32)
    cfg[_C['POLE_MASS']] = env.POLE_MASS
    cfg[_C['CART_MASS']] = env.CART_MASS
    cfg[_C['POLE_LEN']] = env.EFFECTIVE_POLE_LENGTH
    cfg[_C['GRAVITY']] = env.GRAVITY_ACC
    cfg[_C['ACT_LO']] = env.action_space.low[0]
    cfg[_C['ACT_HI']] = env.action_space.high[0]
    cfg[_C['ACT_SCALE']] = (env.action_scale
                            if env.NORMALIZED_RL_ACTION_SPACE else 1.0)
    cfg[_C['PHYS_LO']] = env.physical_action_bounds[0][0]
    cfg[_C['PHYS_HI']] = env.physical_action_bounds[1][0]
    if env.TASK == Task.STABILIZATION:
        cfg[_C['GOAL']:_C['GOAL'] + 4] = np.atleast_2d(env.X_GOAL)[0]
        tol = float(env.TASK_INFO.get('stabilization_goal_tolerance', 0.0))
        cfg[_C['TOL_SQ']] = tol * tol
    # Tracking: GOAL/TOL_SQ unused; the reference comes in as ``x_goal``.
    cfg[_C['X_THRESH']] = env.x_threshold
    cfg[_C['TH_THRESH']] = env.theta_threshold_radians
    cfg[_C['MAX_STEPS']] = env.CTRL_STEPS
    if env.COST == Cost.QUADRATIC:
        # W_STATE/W_ACT carry 0.5*diag(Q)/(R).
        cfg[_C['W_STATE']:_C['W_STATE'] + 4] = 0.5 * np.diag(env.Q)
        cfg[_C['W_ACT']] = 0.5 * env.R[0, 0]
        cfg[_C['U_GOAL']] = np.atleast_1d(env.U_GOAL)[0]
    else:
        w_a = np.atleast_1d(env.rew_act_weight)
        cfg[_C['W_ACT']] = w_a[0]
        w_s = np.atleast_1d(env.rew_state_weight)
        cfg[_C['W_STATE']:_C['W_STATE'] + 4] = (
            w_s if w_s.size == 4 else np.full(4, w_s[0]))
    nominal = np.array([env.INIT_X, env.INIT_X_DOT, env.INIT_THETA,
                        env.INIT_THETA_DOT], np.float32)
    lo, hi = nominal.copy(), nominal.copy()
    if env.RANDOMIZED_INIT:
        spec = env.INIT_STATE_RAND_INFO
        for k, name in enumerate(('init_x', 'init_x_dot', 'init_theta',
                                  'init_theta_dot')):
            info = spec[name]
            if info.get('distrib') != 'uniform':
                raise ValueError('fused rollout: uniform init rand only')
            lo[k] += info['low']
            hi[k] += info['high']
    cfg[_C['INIT_LO']:_C['INIT_LO'] + 4] = lo
    cfg[_C['INIT_HI']:_C['INIT_HI'] + 4] = hi
    cfg[_C['CON_HI']:_C['CON_HI'] + 4] = env.state_space.high
    return torch.as_tensor(cfg, device=env.device)
