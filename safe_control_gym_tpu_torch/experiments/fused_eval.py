"""Closed-loop policy evaluation: a trained PPO, SAC or DDPG actor over a large
env batch, with the actor inside the rollout kernel where the config allows.

Port of ``safe_control_gym_tpu/experiments/fused_eval.py``. Two paths:

* ``policy-in-kernel``: the whole T-step rollout in one launch of K4
  (cartpole) or K5 (2D and 3D quadrotors) in policy mode; the actor MLP runs
  inside the kernel (``csrc/policy_mlp.cuh``) and exploration noise comes
  from its Philox. On the CPU the wrappers run their plain versions.
* ``per-step-scan``: a Python loop of ``FuncEnv.step_autoreset`` with the
  controller's own action function (PyTorch ops outside any kernel, as the
  JAX package left the actor forward to XLA). It serves every config the
  kernel's gates refuse.

With ``use_kernel=None`` the kernel path is taken when the env lives on a
CUDA device and the gates raise no ``ValueError``; errors from the kernel
run itself propagate. Both paths return fleet statistics with the JAX
package's keys, ``path`` included.

    ctrl = make('sac', partial(make, 'quadrotor', device='cuda', **task_config),
                **algo_config)
    ctrl.load('examples/rl/models/sac/sac_model_quadrotor_3D_stab.pt')
    res = ctrl.evaluate_fused(batch=4096, n_steps=500, seed=0)
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ['evaluate_policy_fused', 'kernel_inputs', 'policy_eval_spec']


def policy_eval_spec(ctrl, env, stochastic=False):
    """The kernel-facing description of ``ctrl``'s policy: ``actor`` (the
    ``mlp_init`` parameter list), ``activation``, ``squash`` (the SAC/DDPG
    tanh), ``std`` ((nu,) exploration std, stochastic PPO only),
    ``obs_mean``/``obs_var`` (frozen normalizer stats or None), ``clip_obs``,
    and ``action_fn(obs, gen) -> action``, the controller's own action
    semantics (the per-step path, and what the kernel path is held to).

    Raises ValueError for policies neither path reproduces: stochastic SAC or
    DDPG, and squashed policies on a physical (not normalized) action space."""
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import actor_dist
    name = type(ctrl).__name__
    params = ctrl.agent.params
    activation = ctrl.agent.activation
    if name == 'PPO':
        norm = bool(ctrl.norm_obs) and ctrl.obs_norm_state is not None
        obs_norm = ctrl.obs_norm_state if norm else None
        clip_obs = float(ctrl.clip_obs) if norm else 1e30

        def action_fn(obs, gen):
            if norm:
                obs = torch.clamp((obs - obs_norm.mean) / torch.sqrt(obs_norm.var + 1e-8),
                                  -clip_obs, clip_obs)
            dist = actor_dist(params, obs, activation)
            return dist.sample(gen) if stochastic else dist.mode()

        return dict(actor=params['actor'], activation=activation, squash=False,
                    std=torch.exp(params['logstd']),
                    obs_mean=obs_norm.mean if norm else None,
                    obs_var=obs_norm.var if norm else None, clip_obs=clip_obs,
                    action_fn=action_fn)

    if name in ('SAC', 'DDPG'):
        if stochastic:
            raise ValueError(
                'fused eval: stochastic mode is PPO-only (SAC exploration std is '
                'state-dependent, DDPG uses OU training noise); '
                f'{name} evaluates deterministically')
        if not env.NORMALIZED_RL_ACTION_SPACE:
            raise ValueError(
                'fused eval: SAC/DDPG tanh policies need the normalized action '
                'space (the kernel squash maps to [-1, 1]; the controller unscale '
                'to a physical box is not in-kernel)')
        lo = torch.as_tensor(env.action_space.low, dtype=torch.float32, device=env.device)
        hi = torch.as_tensor(env.action_space.high, dtype=torch.float32, device=env.device)
        if name == 'SAC':
            from safe_control_gym_tpu_torch.controllers.sac.sac_utils import \
                sac_actor_forward

            def action_fn(obs, gen):
                return sac_actor_forward(params['actor'], obs, gen, lo, hi, activation,
                                         deterministic=True, with_logprob=False)[0]
        else:
            from safe_control_gym_tpu_torch.controllers.ddpg.ddpg_utils import \
                ddpg_actor_forward

            def action_fn(obs, gen):
                return ddpg_actor_forward(params['actor'], obs, lo, hi, activation)

        return dict(actor=params['actor'], activation=activation, squash=True, std=None,
                    obs_mean=None, obs_var=None, clip_obs=1e30, action_fn=action_fn)

    raise ValueError(f'fused eval supports PPO/SAC/DDPG, got {name}')


def _kernel_tables(env):
    """(cfg function, rollout wrapper, cfg layout) of the env's rollout kernel."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    if env.NAME == 'cartpole':
        return rk.cartpole_rollout_cfg, rk.cartpole_rollout, rk._C
    if env.NAME == 'quadrotor':
        qt = int(env.QUAD_TYPE)
        if qt == 2:
            return rk.quad_rollout_cfg, rk.quad2d_rollout, rk._Q
        if qt == 3:
            return rk.quad_rollout_cfg, rk.quad3d_rollout, rk._Q
    raise ValueError(f'fused eval kernel: no kernel for env {env.NAME}')


def _kernel_gates(spec, env, stochastic):
    """Every coverage gate, and nothing that can fail for another reason: a
    ValueError from here means the config lies outside the kernel's coverage.
    Returns (cfg, action_noise)."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    cfg_fn, _, cidx = _kernel_tables(env)
    cfg = cfg_fn(env)                       # coverage gate (raises)
    rk.check_policy_obs(env)                # obs == state gate (raises)
    if stochastic:
        std = spec['std']
        cfg[cidx['P_STD']:cidx['P_STD'] + std.shape[0]] = std.to(cfg.device)
    # One disturbance channel runs in the kernel: iid white action noise with
    # one std for every dim. Any other goes to the per-step path.
    action_noise = False
    for chan, dlist in (env.disturbances or {}).items():
        specs = dlist.disturbances
        if chan == 'action' and len(specs) == 1 and type(specs[0]).__name__ == 'WhiteNoise':
            std = np.atleast_1d(np.asarray(specs[0].std, np.float32))
            if not np.all(std == std[0]):
                raise ValueError('fused eval kernel: per-dim action-noise std outside '
                                 'kernel coverage')
            cfg[cidx['NOISE_STD']] = float(std[0])
            action_noise = True
        else:
            raise ValueError(f'fused eval kernel: {chan} disturbance outside kernel '
                             'coverage')
    return cfg, action_noise


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def kernel_inputs(spec, env, batch, seed, stochastic, gates=None):
    """``(state0, cfg, kwargs)`` of the policy-in-kernel path's launch: the
    ``batch`` first states drawn from ``seed``, the env's cfg vector, and the
    keyword arguments of its rollout wrapper in policy mode."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    cfg, action_noise = gates if gates is not None else _kernel_gates(spec, env, stochastic)
    dev = env.device
    pp = rk.pack_policy_params(spec['actor'], env.state_dim, obs_mean=spec['obs_mean'],
                               obs_var=spec['obs_var'], device=dev)
    constrained = env.constraints is not None and bool(env.constraints.constraints)
    states, _ = env.func.reset_batch(torch.Generator(device=dev).manual_seed(seed), batch)
    kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP, draw_actions=False,
              constrained=constrained, action_noise=action_noise,
              randomized_reset=bool(env.RANDOMIZED_INIT), policy_params=pp,
              policy_stochastic=stochastic, policy_squash=spec['squash'],
              policy_activation=spec['activation'], clip_obs=spec['clip_obs'],
              **rk.rollout_task_kwargs(env))
    return states.state.contiguous(), cfg, kw


def _kernel_eval(spec, env, batch, n_steps, seed, stochastic, n_reps, gates=None):
    """The policy-in-kernel path: one K4 or K5 launch for the whole rollout."""
    _, roll_fn, _ = _kernel_tables(env)
    state0, cfg, kw = kernel_inputs(spec, env, batch, seed, stochastic, gates)
    dev = env.device
    constrained = kw['constrained']
    out = roll_fn(state0, cfg, seed, n_steps=n_steps, **kw)   # warm-up and values
    per_env = {k: out[k].cpu().numpy() for k in ('reward_sum', 'done_count')}
    if constrained:
        per_env['violation_count'] = out['violation_count'].cpu().numpy()
    best = float('inf')
    for r in range(n_reps):
        _sync(dev)
        t0 = time.perf_counter()
        roll_fn(state0, cfg, seed + 1 + r, n_steps=n_steps, **kw)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    totals = (float(per_env['reward_sum'].sum()), float(per_env['done_count'].sum()),
              float(per_env['violation_count'].sum()) if constrained else 0.0, None)
    return totals, per_env, best


def _per_step_eval(spec, env, batch, n_steps, seed, n_reps):
    """The per-step path: ``FuncEnv.step_autoreset`` in a Python loop, the
    action from the controller's own action function."""
    func = env.func
    dev = env.device
    action_fn = spec['action_fn']
    counts = env.constraints is not None and bool(env.constraints.constraints)

    def run(s):
        gen = torch.Generator(device=dev).manual_seed(s)
        states, obs = func.reset_batch(gen, batch)
        z = lambda: torch.zeros((batch,), dtype=torch.float32, device=dev)
        rew, dn, vi, mse = z(), z(), z(), z()
        with torch.no_grad():
            for _ in range(n_steps):
                act = action_fn(obs, gen)
                states, out, obs = func.step_autoreset(states, act, gen)
                rew = rew + out.reward
                dn = dn + out.done.to(torch.float32)
                if counts:
                    vi = vi + out.constraint_violation.to(torch.float32)
                mse = mse + out.mse
        return rew, dn, vi, mse

    rew, dn, vi, mse = (a.cpu().numpy() for a in run(seed))   # warm-up and values
    per_env = dict(reward_sum=rew, done_count=dn)
    if counts:
        per_env['violation_count'] = vi
    best = float('inf')
    for r in range(n_reps):
        _sync(dev)
        t0 = time.perf_counter()
        run(seed + 1 + r)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    totals = (float(rew.sum()), float(dn.sum()), float(vi.sum()), float(mse.sum()))
    return totals, per_env, best


def evaluate_policy_fused(ctrl, env=None, batch=1024, n_steps=4096, seed=0,
                          stochastic=False, use_kernel=None, n_reps=1,
                          return_per_env=False, mesh=None, axis_name='env'):
    """Evaluate ``ctrl``'s policy closed loop over ``batch`` envs for
    ``n_steps`` control steps; return fleet episode statistics.

    Args:
        ctrl: a PPO, SAC or DDPG controller of the port.
        env: the env to evaluate on (default ``ctrl.env``); its device is the
            device of the run. Episodes auto-reset; the trailing partial
            episode of each env adds reward but no episode.
        stochastic: PPO only, sample the Gaussian policy instead of its mean.
        use_kernel: None picks the kernel on a CUDA env whose config passes
            the kernel's gates, else the per-step path; True forces the
            kernel (its plain version for a CPU env), False the per-step path.
        n_reps: timed repetitions after the warm-up run (best of).
        return_per_env: add ``per_env``, the (batch,) numpy ``reward_sum``,
            ``done_count`` (and ``violation_count``) of the warm-up run.
        mesh, axis_name: sharding over devices, not in the port yet.

    Returns a dict: ``path``, ``total_steps``, ``episodes``, ``ep_return_mean``,
    ``ep_length_mean``, ``steps_per_sec``, ``total_violations`` (constrained
    envs), ``rmse`` (per-step path only) and ``per_env`` if asked.
    """
    if mesh is not None:
        raise NotImplementedError('fused eval: sharding the env batch over devices '
                                  'comes with the multi-GPU slice (ROADMAP Queue 1 '
                                  'item 14)')
    env = env if env is not None else ctrl.env
    spec = policy_eval_spec(ctrl, env, stochastic=stochastic)
    path = None
    if use_kernel is None:
        if env.device.type == 'cuda':
            try:
                gates = _kernel_gates(spec, env, stochastic)
            except ValueError:
                gates = None                # outside coverage: the per-step path
            if gates is not None:           # errors of the kernel run propagate
                totals, per_env, best = _kernel_eval(spec, env, batch, n_steps, seed,
                                                     stochastic, n_reps, gates=gates)
                path = 'policy-in-kernel'
    elif use_kernel:
        totals, per_env, best = _kernel_eval(spec, env, batch, n_steps, seed,
                                             stochastic, n_reps)
        path = 'policy-in-kernel'
    if path is None:
        totals, per_env, best = _per_step_eval(spec, env, batch, n_steps, seed, n_reps)
        path = 'per-step-scan'
    rew, episodes, violations, mse = totals
    total_steps = batch * n_steps
    out = dict(path=path, total_steps=total_steps, episodes=int(episodes),
               ep_return_mean=rew / max(episodes, 1.0),
               ep_length_mean=total_steps / max(episodes, 1.0),
               steps_per_sec=total_steps / best)
    if env.constraints is not None and bool(env.constraints.constraints):
        out['total_violations'] = int(violations)
    if mse is not None:
        out['rmse'] = float(np.sqrt(mse / total_steps))
    if return_per_env:
        out['per_env'] = per_env
    return out
