"""The port's 2D and 3D quadrotor envs against the JAX package's: the default
config, spaces, references, cost matrices and motor bounds, the stateful
episode, and the batched ``step_autoreset`` in replay over T steps against
JAX's under ``lax.scan``, both packages started from one state. States and
reward sums are held to rtol/atol 1e-4 and the done, violation and step counts
exactly: the JAX package's own bar for its kernel against its scan
(tests/test_rollout_kernel.py). The JAX env on the CPU integrates by its
matmul scan and the port by the kernels' closed form; they differ by about
2e-5 a step."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments.benchmark_suite import per_step_rollout
from safe_control_gym_tpu_torch.utils.convert import (env_state_from_numpy,
                                                      quad_params_from_numpy)
from safe_control_gym_tpu_torch.utils.registration import get_config
from safe_control_gym_tpu_torch.utils.registration import make as tmake

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BENCH_CONSTRAINTS = [
    {'constraint_form': 'default_constraint', 'constrained_variable': 'state'},
    {'constraint_form': 'default_constraint', 'constrained_variable': 'input'},
]
TRACK_2D = {'trajectory_type': 'circle', 'num_cycles': 1, 'trajectory_plane': 'zx',
            'trajectory_position_offset': [0.5, 0], 'trajectory_scale': -0.5}
TRACK_3D = {'trajectory_type': 'figure8', 'num_cycles': 1, 'trajectory_plane': 'xy',
            'trajectory_position_offset': [0, 0], 'trajectory_scale': 0.75,
            'proj_point': [0, 0, 0.5], 'proj_normal': [0, 1, 1]}


def _base(quad_type):
    goal = [0, 1] if quad_type == 2 else [0, 0, 1]
    return dict(quad_type=quad_type, seed=0, ctrl_freq=50, pyb_freq=1000,
                episode_len_sec=0.4, randomized_init=False, init_state={'init_z': 1.0},
                task_info={'stabilization_goal': goal, 'stabilization_goal_tolerance': 0.0})


def _track(quad_type, **over):
    return dict(episode_len_sec=1.0, init_state={'init_z': 0.5}, task='traj_tracking',
                task_info=TRACK_2D if quad_type == 2 else TRACK_3D, **over)


def _envs(quad_type, **over):
    kw = dict(_base(quad_type), **over)
    return jmake('quadrotor', **kw), tmake('quadrotor', device='cpu', **kw)


def _state_dict(est):
    """A JAX EnvState as the dict of numpy arrays the converter takes."""
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def test_default_config_is_the_yaml():
    with open(os.path.join(ROOT, 'safe_control_gym_tpu', 'envs', 'quadrotor.yaml')) as f:
        assert get_config('quadrotor') == yaml.safe_load(f)
    with open(os.path.join(ROOT, 'safe_control_gym_tpu_torch', 'envs', 'quadrotor.json')) as f:
        assert json.load(f) == get_config('quadrotor')
    env = tmake('quadrotor', device='cpu', **get_config('quadrotor'))
    assert (env.QUAD_TYPE, env.PYB_STEPS_PER_CTRL, env.CTRL_FREQ) == (2, 4, 60)


@pytest.mark.parametrize('quad_type', [2, 3])
@pytest.mark.parametrize('over', [
    {}, 'track', dict(normalized_rl_action_space=True, cost='quadratic'),
    dict(constraints=BENCH_CONSTRAINTS, rew_state_weight=2.0, rew_act_weight=[0.5]),
    dict(obs_goal_horizon=2, inertial_prop={'M': 0.03, 'Iyy': 1.5e-5}),
], ids=['stabilization', 'tracking', 'normalized-quadratic', 'constrained', 'horizon-inertia'])
def test_config_and_spaces_match_jax(quad_type, over):
    if over == 'track':
        over = _track(quad_type, obs_goal_horizon=3)
    je, te = _envs(quad_type, **over)
    for name in ('action_space', 'observation_space', 'state_space'):
        a, b = getattr(te, name), getattr(je, name)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    # The 3D plane projection runs in float32 in both packages, with the
    # dot products summed in their own orders.
    np.testing.assert_allclose(te.X_GOAL, je.X_GOAL, rtol=0, atol=1e-6)
    for name in ('U_GOAL', 'Q', 'R', 'physical_action_bounds', 'J',
                 'info_mse_metric_state_weight'):
        np.testing.assert_array_equal(np.asarray(getattr(te, name)),
                                      np.asarray(getattr(je, name)), err_msg=name)
    for name in ('CTRL_STEPS', 'PYB_STEPS_PER_CTRL', 'CTRL_TIMESTEP', 'PYB_TIMESTEP',
                 'MASS', 'hover_thrust', 'MAX_THRUST', 'GND_EFF_H_CLIP', 'num_constraints',
                 'state_dim', 'action_dim', 'obs_dim', 'INIT_STATE_RAND_INFO',
                 'INERTIAL_PROP_RAND_INFO', 'DISTURBANCE_MODES'):
        assert getattr(te, name) == getattr(je, name), name
    assert te.func.obs_dim == je.func.obs_dim


def _replay(je, te, B, T, actions, key):
    """``step_autoreset`` over the (T, B, nu) actions: JAX's under
    ``lax.scan``, the port's in its Python loop, from one state."""
    func = je.func

    def body(carry, a):
        st, rew, dones, viol = carry
        st, out, _obs = func.step_autoreset(st, a, jax.random.PRNGKey(0))
        return (st, rew + out.reward, dones + out.done.astype(jnp.float32),
                viol + out.constraint_violation.astype(jnp.float32)), None

    jst, _ = func.reset_batch(jax.random.PRNGKey(key), B)
    tst = env_state_from_numpy(_state_dict(jst), 'cpu')
    z = jnp.zeros((B,), jnp.float32)
    (jst, rew, dones, viol), _ = jax.jit(
        lambda s, a: jax.lax.scan(body, (s, z, z, z), a))(jst, jnp.asarray(actions))
    tst, stats = per_step_rollout(te, tst, torch.as_tensor(actions),
                                  torch.Generator().manual_seed(0))
    return (dict(state=np.asarray(jst.state), ctrl_step=np.asarray(jst.ctrl_step),
                 reward_sum=np.asarray(rew), done_count=np.asarray(dones),
                 violation_count=np.asarray(viol)),
            dict(state=tst.state.numpy(), ctrl_step=tst.ctrl_step.numpy(),
                 **{k: v.numpy() for k, v in stats.items()}))


@pytest.mark.parametrize('quad_type', [2, 3])
@pytest.mark.parametrize('mode', ['stabilization', 'constrained', 'tracking-quadratic'])
def test_step_autoreset_replay_matches_jax(quad_type, mode):
    over = {'stabilization': {}, 'constrained': dict(constraints=BENCH_CONSTRAINTS),
            'tracking-quadratic': _track(quad_type, cost='quadratic')}[mode]
    je, te = _envs(quad_type, **over)
    B, T = 64, 48
    lo, hi = je.physical_action_bounds[0][0], je.physical_action_bounds[1][0]
    if mode == 'constrained':
        # 20% beyond the input box on both sides: input and state hits.
        lo, hi = 1.2 * lo - 0.2 * hi, 1.2 * hi
    rng = np.random.default_rng(quad_type)
    actions = rng.uniform(lo, hi, (T, B, te.action_dim)).astype(np.float32)
    ref, got = _replay(je, te, B, T, actions, key=quad_type)
    np.testing.assert_allclose(got['state'], ref['state'], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got['reward_sum'], ref['reward_sum'], rtol=1e-4, atol=1e-4)
    for key in ('done_count', 'ctrl_step', 'violation_count'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert ref['done_count'].sum() > 0
    if mode == 'constrained':
        assert ref['violation_count'].sum() > 0
    if mode == 'tracking-quadratic':
        assert ref['ctrl_step'].max() > ref['ctrl_step'].min()  # desynchronized resets


def test_shim_episode_matches_jax():
    kw = dict(get_config('quadrotor'), seed=3, ctrl_freq=50, pyb_freq=1000,
              init_state={'init_z': 1.0, 'init_theta': 0.1})
    je = jmake('quadrotor', **kw)
    te = tmake('quadrotor', device='cpu', **kw)
    jobs, _ = je.reset()
    tobs, tinfo = te.reset()
    np.testing.assert_allclose(tobs, jobs, atol=1e-6)
    assert tinfo['current_step'] == 0
    done, steps = False, 0
    while not done:
        a = te.U_GOAL * (1 + 0.2 * np.array([np.sin(0.3 * steps), np.cos(0.2 * steps)]))
        jobs, jrew, jdone, jinfo = je.step(a.astype(np.float32))
        tobs, trew, done, tinfo = te.step(a.astype(np.float32))
        steps += 1
        np.testing.assert_allclose(tobs, jobs, atol=1e-4)
        assert abs(trew - jrew) <= 1e-4 + 1e-4 * abs(jrew)
        assert done == jdone
        assert tinfo['current_step'] == jinfo['current_step']
        assert tinfo.get('out_of_bounds') == jinfo.get('out_of_bounds')
        assert abs(tinfo['mse'] - jinfo['mse']) <= 1e-4 + 1e-4 * abs(jinfo['mse'])
    assert steps > 1


def test_converter_carries_the_quad_state():
    je, te = _envs(3)
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(0), 8)
    d = _state_dict(jst)
    est = env_state_from_numpy(d, 'cpu')
    np.testing.assert_array_equal(est.state.numpy(), d['state'])
    assert type(est.dyn_params).__name__ == 'QuadParams'
    for f in dataclasses.fields(est.dyn_params):
        want = np.asarray(d['dyn_params'][f.name], np.float32).ravel()[0]
        assert float(getattr(est.dyn_params, f.name)) == float(want), f.name
    with pytest.raises(NotImplementedError):
        quad_params_from_numpy(dict(d['dyn_params'], mass=np.array([0.02, 0.03])), 'cpu')


@pytest.mark.parametrize('over', [dict(quad_type=1), dict(physics='pyb_drag'),
                                  dict(physics='dyn'), dict(randomized_inertial_prop=True)])
def test_out_of_slice_configs_raise(over):
    with pytest.raises(NotImplementedError):
        tmake('quadrotor', device='cpu', **dict(_base(2), **over))
