"""The open-loop rollout benchmark protocol, on the card.

Port of ``safe_control_gym_tpu/experiments/benchmark_suite.py`` for the
cartpole and the 2D and 3D quadrotors: ``_env_kwargs``, ``kernel_covers``,
``measure_rollout_kernel`` (the whole-rollout kernels, K4 and K5) and
``measure_batched`` (the per-step path: ``FuncEnv.step_autoreset`` in a Python
loop, whose physics runs in K1, K2 or K3), and ``measure_closed_loop_kernel``
(the closed loop: K4 or K5 in policy mode with a random actor and Gaussian
exploration, the RL collect and eval workload). The protocol is the reference's
headline one: open-loop random actions, 50 Hz control over 20 physics
substeps at 1000 Hz, with and without the default constraints and a
white-noise action disturbance. ``'quadrotor_3D'`` names the 3D quadrotor,
made as ``'quadrotor'`` with ``quad_type=3``.

Every measurement runs on a CUDA device and times with CUDA events and
``torch.cuda.synchronize()``; it raises where there is none. Each result names
the card it ran on.
"""

from __future__ import annotations

import time

import torch

from safe_control_gym_tpu_torch.utils.device import require_cuda
from safe_control_gym_tpu_torch.utils.registration import make

__all__ = ['CONSTRAINTS', 'DISTURBANCES', '_env_kwargs', 'kernel_covers',
           'measure_rollout_kernel', 'measure_closed_loop_kernel',
           'measure_batched', 'per_step_rollout', 'sanity_check', 'hover_case',
           'hover_actions', 'physics_args', 'physics_cases']

CONSTRAINTS = [{'constraint_form': 'default_constraint',
                'constrained_variable': 'state'},
               {'constraint_form': 'default_constraint',
                'constrained_variable': 'input'}]

DISTURBANCES = {'action': [{'disturbance_func': 'white_noise', 'std': 0.1}]}

_SYSTEMS = ('cartpole', 'quadrotor', 'quadrotor_3D')


def _env_kwargs(system, constrained, tracking=False):
    """The benchmark's env config for ``system`` ('cartpole', 'quadrotor' or
    'quadrotor_3D'); ``tracking`` is the reference's circle tracking task."""
    if system not in _SYSTEMS:
        raise ValueError(f'unknown benchmark system {system!r}')
    kw = dict(seed=0, ctrl_freq=50, pyb_freq=1000, episode_len_sec=5)
    if system != 'cartpole':
        three_d = system == 'quadrotor_3D'
        kw.update(quad_type=3 if three_d else 2, randomized_init=False,
                  init_state={'init_z': 1.0},
                  task_info={'stabilization_goal': [0, 0, 1] if three_d else [0, 1],
                             'stabilization_goal_tolerance': 0.0})
    if tracking:
        kw.update(task='traj_tracking', task_info={
            'trajectory_type': 'circle', 'num_cycles': 1,
            'trajectory_plane': 'zx',
            'trajectory_position_offset': [0, 0] if system == 'cartpole' else [0.5, 0],
            'trajectory_scale': 0.2 if system == 'cartpole' else -0.5})
    if constrained:
        kw.update(constraints=CONSTRAINTS, disturbances=DISTURBANCES)
    return kw


def _make(system, constrained, tracking=False, device='cuda'):
    return make(system.replace('_3D', ''), device=device,
                **_env_kwargs(system, constrained, tracking))


def _kernel(system):
    """(cfg function, rollout wrapper, cfg layout) of ``system``'s
    whole-rollout kernel."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    return {'cartpole': (rk.cartpole_rollout_cfg, rk.cartpole_rollout, rk._C),
            'quadrotor': (rk.quad_rollout_cfg, rk.quad2d_rollout, rk._Q),
            'quadrotor_3D': (rk.quad_rollout_cfg, rk.quad3d_rollout, rk._Q)}[system]


def kernel_covers(system, constrained, tracking=False, device='cuda'):
    """True when the whole-rollout kernel covers this benchmark config (its
    cfg function raises ValueError outside coverage)."""
    env = _make(system, constrained, tracking, device)
    try:
        _kernel(system)[0](env)
        return True
    except ValueError:
        return False
    finally:
        env.close()


def _kernel_cfg(system, env, constrained):
    """The kernel cfg with NOISE_STD set from the env's action disturbance."""
    cfg_fn, _, layout = _kernel(system)
    cfg = cfg_fn(env)
    if constrained:
        cfg[layout['NOISE_STD']] = float(
            env.disturbances['action'].disturbances[0].std[0])
    return cfg


def hover_case(system, device='cuda', tilt=0.0):
    """(state, raw action, cfg, kwargs) of a hover replay of ``system``'s
    whole-rollout kernel: the nominal state (the cartpole upright at rest),
    the raw action that commands the hover thrust on every motor (0 on the
    cartpole), no noise, no goal, and a time-limit reset back to the same
    state. ``tilt`` sets the quads' angles, which then stay put: equal motors
    give no torque. Without a tilt the angles stay exactly 0. Replay it with
    ``hover_actions``."""
    env = _make(system, False, device=device)
    layout = _kernel(system)[2]
    cfg = _kernel_cfg(system, env, False)
    if system == 'cartpole':
        hover = torch.zeros(4, device=device)
        raw = torch.zeros(1, device=device)
    else:
        hover = torch.as_tensor(env._nominal_init_state(), dtype=torch.float32,
                                device=device)
        hover[[4] if system == 'quadrotor' else [6, 7, 8]] = tilt
        u_goal = cfg[layout['U_GOAL']:layout['U_GOAL'] + env.action_dim]
        raw = (u_goal - cfg[layout['DEN_B']]) / cfg[layout['DEN_A']]
    nx = hover.numel()
    cfg[layout['TOL_SQ']] = 0.0
    cfg[layout['INIT_LO']:layout['INIT_LO'] + nx] = hover
    cfg[layout['INIT_HI']:layout['INIT_HI'] + nx] = hover
    kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP, draw_actions=False,
              constrained=False, action_noise=False, randomized_reset=False)
    env.close()
    return hover, raw, cfg, kw


def hover_actions(system, raw, T, B):
    """The (T, B[, nu]) replay of the hover command ``raw``."""
    actions = raw.expand(T, B, raw.numel()).contiguous()
    return actions[..., 0].contiguous() if system == 'cartpole' else actions


# The per-step kernels' parameter vectors (envs/dynamics.py QuadParams and
# the cartpole's defaults): [pole_mass, cart_mass, pole_length, gravity];
# [mass, Iyy, arm_length, gravity]; [mass, Ixx, Iyy, Izz, arm_length, gravity].
PHYSICS_PARAMS = {'cartpole': [0.1, 1.0, 0.5, 9.8], 'quadrotor': [0.027, 1.4e-5, 0.0397, 9.8],
                  'quadrotor_3D': [0.027, 1.4e-5, 1.4e-5, 2.17e-5, 0.0397, 9.8]}
# The angle each per-step case puts past sinf's fast range.
PHYSICS_ANGLE_DIM = {'cartpole': 2, 'quadrotor': 4, 'quadrotor_3D': 7}


def physics_args(system, device='cuda', batch=4096, seed=0, hover=False):
    """The tensor inputs of ``system``'s per-step physics kernel (K1, K2 or
    K3) for ``batch`` envs, drawn from ``seed``: tilted and moving states,
    forces about the hover thrust and nonzero tab or world forces. With
    ``hover`` the angles and rates are 0, every motor gives the hover thrust
    (the cartpole's force is 0) and no tab or world force acts, so the angles
    stay exactly 0 over the step."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=g, device=device)
    params = torch.tensor(PHYSICS_PARAMS[system], device=device)
    if system == 'cartpole':
        states, force, tab = u((batch, 4), -0.3, 0.3), u((batch,), -10.0, 10.0), \
            u((batch, 2), -0.5, 0.5)
        if hover:
            states[:, 2:] = 0.0
            force.zero_()
            tab.zero_()
        return states, force, tab, params
    if system == 'quadrotor':
        states = torch.stack([u((batch,), -1, 1), u((batch,), -0.5, 0.5), u((batch,), 0.5, 1.5),
                              u((batch,), -0.5, 0.5), u((batch,), -1, 1), u((batch,), -3, 3)], 1)
        t1, t2, dyn = u((batch,), 0.05, 0.2), u((batch,), 0.05, 0.2), u((batch, 2), -0.01, 0.01)
        if hover:
            states[:, 4:] = 0.0
            t1.fill_(0.027 * 9.8 / 2)
            t2.fill_(0.027 * 9.8 / 2)
            dyn.zero_()
        return states.contiguous(), t1, t2, dyn, params
    states = u((batch, 12), -0.5, 0.5)
    states[:, 4] += 1.0
    states[:, 6:9] = u((batch, 3), -0.8, 0.8)
    thrust = 0.027 * 9.8 / 4
    forces, zt, dyn = u((batch, 4), 0.5 * thrust, 1.5 * thrust), u((batch,), -1e-6, 1e-6), \
        u((batch, 3), -0.01, 0.01)
    if hover:
        states[:, 6:] = 0.0
        forces.fill_(thrust)
        zt.zero_()
        dyn.zero_()
    return states.contiguous(), forces, zt, dyn, params


def physics_cases(system, device='cuda', batch=4096, n_substeps=20, dt=1e-3):
    """[(name, args)] of the checked per-step cases of ``system``, ``args``
    the kernel's arguments with n_substeps and dt: random inputs at ``batch``
    (the 20 substeps compiled in), a hover (angles exactly 0: zero
    numerators in 3D's quotients), angles past sinf's fast range on every
    97th env (the step's library recompute), a ragged last warp (``batch`` +
    13), four warps an SM (blocks of 128 threads) and 7 substeps over the
    same control step (the runtime-count instantiation)."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    step = (n_substeps, dt)
    random = physics_args(system, device, batch)
    special = [a.clone() for a in random]
    special[0][::97, PHYSICS_ANGLE_DIM[system]] = 2.0e5
    return [('random', (*random, *step)),
            ('hover', (*physics_args(system, device, batch, seed=1, hover=True), *step)),
            ('angle_past_sinf_fast_range', (*special, *step)),
            ('ragged_batch', (*physics_args(system, device, batch + 13, seed=2), *step)),
            ('four_warps_an_sm', (*physics_args(system, device, 32 * 4 * n_sm, seed=3), *step)),
            ('substeps_7', (*random, 7, n_substeps * dt / 7))]


def sanity_check(out, t_steps, label):
    """Raise unless the episode statistics of a rollout are plausible: some
    episode ended and the mean reward sum lies in (0, T]."""
    dc = float(out['done_count'].mean())
    rs = float(out['reward_sum'].mean())
    if not (dc > 0 and 0 < rs <= t_steps):
        raise RuntimeError(f'rollout sanity check failed: {label} '
                           f'done_count={dc} reward_sum={rs} over {t_steps} steps')
    return dc, rs


def measure_rollout_kernel(system, constrained, batch=4096, n_steps=32768,
                           n_reps=3, tracking=False, device='cuda'):
    """The whole-rollout kernel (K4 or K5): the full open-loop workload in one
    launch.

    Returns ``(speedup, steps_per_sec, extras)``: the simulated over the wall
    time and the end-to-end rate of the best of ``n_reps`` runs (host clock
    around a launch that ends in ``torch.cuda.synchronize()``), and
    ``extras`` with the kernel's device time from CUDA events, the device rate
    from the slope between T/8 and T steps, the warm-up run's episode
    statistics and the card's name."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    dev = require_cuda(device)
    env = _make(system, constrained, tracking, dev)
    try:
        roll = _kernel(system)[1]
        cfg = _kernel_cfg(system, env, constrained)
        states, _ = env.func.reset_batch(
            torch.Generator(device=dev).manual_seed(0), batch)
        state0 = states.state.contiguous()
        kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                  draw_actions=True, constrained=constrained,
                  randomized_reset=bool(env.RANDOMIZED_INIT),
                  **rk.rollout_task_kwargs(env))

        def timed(t_steps):
            # The warm-up run checks the statistics before any timing.
            out = roll(state0, cfg, 1, n_steps=t_steps, **kw)
            torch.cuda.synchronize(dev)
            warm = sanity_check(out, t_steps, f'{system} constrained={constrained} '
                                f'tracking={tracking}') \
                + (float(out['violation_count'].mean()),)
            best_wall = best_dev = float('inf')
            for i in range(n_reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                roll(state0, cfg, 2 + i, n_steps=t_steps, **kw)
                e1.record()
                torch.cuda.synchronize(dev)
                best_wall = min(best_wall, time.perf_counter() - t0)
                best_dev = min(best_dev, e0.elapsed_time(e1) / 1e3)
            return best_wall, best_dev, warm

        _, d_short, _ = timed(n_steps // 8)
        t_long, d_long, (dc, rs, vc) = timed(n_steps)
        slope = (d_long - d_short) / (n_steps - n_steps // 8)
        sim_time = batch * n_steps * env.CTRL_TIMESTEP
        extras = dict(device=torch.cuda.get_device_name(dev),
                      kernel_ms=d_long * 1e3,
                      device_steps_per_sec=batch * n_steps / d_long,
                      device_slope_steps_per_sec=batch / slope,
                      mean_done_count=dc, mean_reward_sum=rs,
                      mean_violation_count=vc)
        return sim_time / t_long, batch * n_steps / t_long, extras
    finally:
        env.close()


def measure_closed_loop_kernel(system, batch=4096, n_steps=8192, n_reps=3, hidden=64,
                               activation='tanh', nu_out=None, device='cuda'):
    """The closed-loop rollout kernel: the actor MLP (obs -> hidden -> hidden
    -> nu_out, a PPO actor drawn from seed 0) runs inside K4 or K5 on every
    step, with stochastic Gaussian exploration (std exp(logstd)) from the
    kernel's Philox; one launch for the whole T-step rollout. ``nu_out``
    (default nu) may be 2 nu for a SAC-shaped output layer, of which the
    kernel reads the first nu.

    Returns ``(steps_per_sec, extras)`` like ``measure_rollout_kernel``, with
    the device time of the T-step launch and the device rate from the slope
    between T/8 and T steps."""
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import init_actor_critic
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    dev = require_cuda(device)
    env = _make(system, False, device=dev)
    try:
        nx, nu = env.state_dim, env.action_dim
        params = init_actor_critic(torch.Generator(device=dev).manual_seed(0), nx,
                                   nu if nu_out is None else nu_out, [hidden] * 2)
        cfg_fn, roll, layout = _kernel(system)
        cfg = cfg_fn(env)
        rk.check_policy_obs(env)
        cfg[layout['P_STD']:layout['P_STD'] + nu] = torch.exp(params['logstd'][:nu])
        pp = rk.pack_policy_params(params['actor'], nx, device=dev)
        states, _ = env.func.reset_batch(torch.Generator(device=dev).manual_seed(1), batch)
        state0 = states.state.contiguous()
        kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                  draw_actions=False, randomized_reset=False, policy_params=pp,
                  policy_stochastic=True, policy_activation=activation)

        def timed(t_steps):
            out = roll(state0, cfg, 1, n_steps=t_steps, **kw)
            torch.cuda.synchronize(dev)
            warm = sanity_check(out, t_steps, f'closed loop {system} hidden={hidden}')
            best_wall = best_dev = float('inf')
            for i in range(n_reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                roll(state0, cfg, 2 + i, n_steps=t_steps, **kw)
                e1.record()
                torch.cuda.synchronize(dev)
                best_wall = min(best_wall, time.perf_counter() - t0)
                best_dev = min(best_dev, e0.elapsed_time(e1) / 1e3)
            return best_wall, best_dev, warm

        _, d_short, _ = timed(n_steps // 8)
        t_long, d_long, (dc, rs) = timed(n_steps)
        slope = (d_long - d_short) / (n_steps - n_steps // 8)
        extras = dict(device=torch.cuda.get_device_name(dev), kernel_ms=d_long * 1e3,
                      device_steps_per_sec=batch * n_steps / d_long,
                      device_slope_steps_per_sec=batch / slope,
                      mean_done_count=dc, mean_reward_sum=rs, hidden=hidden,
                      activation=activation, nu_out=pp.nu_out)
        return batch * n_steps / t_long, extras
    finally:
        env.close()


def per_step_rollout(env, states, actions, gen):
    """The per-step path over T steps: ``step_autoreset`` on each (B, act)
    row of ``actions`` (T, B, act). Returns the final states and the per-env
    ``reward_sum``, ``done_count`` and ``violation_count`` (B,) float32."""
    B = actions.shape[1]
    z = lambda: torch.zeros((B,), dtype=torch.float32, device=actions.device)
    rew, dones, viol = z(), z(), z()
    for t in range(actions.shape[0]):
        states, out, _obs = env.func.step_autoreset(states, actions[t], gen)
        rew += out.reward
        dones += out.done
        viol += out.constraint_violation
    return states, {'reward_sum': rew, 'done_count': dones,
                    'violation_count': viol}


def measure_batched(system, constrained, batch=4096, n_steps=4096, n_reps=3,
                    device='cuda'):
    """The per-step path: a Python loop of batched ``step_autoreset`` calls on
    actions drawn up front, the physics of each step in K1, K2 or K3.

    Returns ``(speedup, steps_per_sec, extras)`` for the best of ``n_reps``
    runs, timed on the host clock around work that ends in
    ``torch.cuda.synchronize()``."""
    dev = require_cuda(device)
    env = _make(system, constrained, device=dev)
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        lo = torch.as_tensor(env.action_space.low, device=dev)
        hi = torch.as_tensor(env.action_space.high, device=dev)

        def run(seed):
            states, _ = env.func.reset_batch(gen.manual_seed(seed), batch)
            actions = lo + torch.rand((n_steps, batch, env.action_dim),
                                      generator=gen, device=dev) * (hi - lo)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, stats = per_step_rollout(env, states, actions, gen)
            torch.cuda.synchronize(dev)
            return time.perf_counter() - t0, stats

        _, stats = run(1)  # warm-up
        best = min(run(2 + i)[0] for i in range(n_reps))
        total_steps = batch * n_steps
        extras = dict(device=torch.cuda.get_device_name(dev),
                      mean_done_count=float(stats['done_count'].mean()),
                      mean_reward_sum=float(stats['reward_sum'].mean()))
        return total_steps * env.CTRL_TIMESTEP / best, total_steps / best, extras
    finally:
        env.close()
