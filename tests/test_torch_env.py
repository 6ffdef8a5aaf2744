"""The port's cartpole env against the JAX package's: config and spaces,
constraints, disturbances, and the batched step with auto-reset over T steps,
both packages started from one state (states atol 1e-4; done, violation and
step counts exact)."""

import dataclasses
from functools import partial
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_tpu.envs import constraints as jcon
from safe_control_gym_tpu.envs import disturbances as jdist
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.envs import constraints as tcon
from safe_control_gym_tpu_torch.envs import disturbances as tdist
from safe_control_gym_tpu_torch.utils.convert import (cartpole_params_from_numpy,
                                                      env_state_from_numpy)
from safe_control_gym_tpu_torch.utils.registration import get_config
from safe_control_gym_tpu_torch.utils.registration import make as tmake


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(seed=0, ctrl_freq=50, pyb_freq=1000, episode_len_sec=0.4,
            randomized_init=False, init_state={'init_x': 0.1},
            task_info={'stabilization_goal': [0],
                       'stabilization_goal_tolerance': 0.0})
TRACK = dict(episode_len_sec=1.0, init_state={'init_x': 0.0}, task='traj_tracking',
             task_info={'trajectory_type': 'circle', 'num_cycles': 1,
                        'trajectory_plane': 'zx', 'trajectory_position_offset': [0, 0],
                        'trajectory_scale': 0.2})
BENCH_CONSTRAINTS = [
    {'constraint_form': 'default_constraint', 'constrained_variable': 'state'},
    {'constraint_form': 'default_constraint', 'constrained_variable': 'input'},
]


def _envs(**over):
    kw = dict(BASE, **over)
    return jmake('cartpole', **kw), tmake('cartpole', device='cpu', **kw)


def _state_dict(est):
    """A JAX EnvState as the dict of numpy arrays the converter takes."""
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def test_default_config_is_the_yaml():
    with open(os.path.join(ROOT, 'safe_control_gym_tpu', 'envs', 'cartpole.yaml')) as f:
        assert get_config('cartpole') == yaml.safe_load(f)
    with open(os.path.join(ROOT, 'safe_control_gym_tpu_torch', 'envs', 'cartpole.json')) as f:
        assert json.load(f) == get_config('cartpole')


@pytest.mark.parametrize('over', [
    {}, dict(normalized_rl_action_space=True, cost='quadratic'), TRACK,
    dict(TRACK, obs_goal_horizon=3), dict(obs_goal_horizon=1),
    dict(constraints=BENCH_CONSTRAINTS, rew_state_weight=[1, 2, 3, 4]),
], ids=['default', 'normalized-quadratic', 'tracking', 'tracking-horizon',
        'stab-horizon', 'constrained'])
def test_config_and_spaces_match_jax(over):
    je, te = _envs(**over)
    for name in ('action_space', 'observation_space', 'state_space'):
        a, b = getattr(te, name), getattr(je, name)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    for name in ('X_GOAL', 'U_GOAL', 'Q', 'R', 'physical_action_bounds'):
        np.testing.assert_array_equal(np.asarray(getattr(te, name)),
                                      np.asarray(getattr(je, name)), err_msg=name)
    for name in ('CTRL_STEPS', 'PYB_STEPS_PER_CTRL', 'CTRL_TIMESTEP', 'PYB_TIMESTEP',
                 'x_threshold', 'theta_threshold_radians', 'action_scale',
                 'num_constraints', 'state_dim', 'action_dim', 'obs_dim'):
        assert getattr(te, name) == getattr(je, name), name
    assert te.func.obs_dim == je.func.obs_dim


def test_constraint_values_match_jax():
    specs = [
        {'constraint_form': 'default_constraint', 'constrained_variable': 'state'},
        {'constraint_form': 'default_constraint', 'constrained_variable': 'input'},
        {'constraint_form': 'abs_bound', 'constrained_variable': 'state',
         'bound': [0.2, 1.0], 'active_dims': [0, 2], 'strict': True},
        {'constraint_form': 'linear_constraint', 'constrained_variable': 'input_and_state',
         'A': [[1, 0, 0, 0, 0.5], [0, 1, -1, 0, 0]], 'b': [0.3, 0.1]},
        {'constraint_form': 'quadratic_constraint', 'constrained_variable': 'state',
         'P': [[2.0, 0.5], [0.5, 1.0]], 'b': 0.4, 'active_dims': [1, 3]},
        {'constraint_form': 'bounded_constraint', 'constrained_variable': 'input',
         'lower_bounds': [-2.0], 'upper_bounds': [3.0]},
    ]
    je, te = _envs()
    jl = jcon.create_constraint_list(specs, je.AVAILABLE_CONSTRAINTS, je)
    tl = tcon.create_constraint_list(specs, te.AVAILABLE_CONSTRAINTS, te)
    assert tl.num_constraints == jl.num_constraints
    rng = np.random.default_rng(0)
    x = rng.uniform(-6, 6, (96, 4)).astype(np.float32)
    u = rng.uniform(-12, 12, (96, 1)).astype(np.float32)
    jv = jax.vmap(jl.values_from)(x, u)
    tv = tl.values_from(torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tl.violated_mask(tv).numpy(),
                                  np.asarray(jax.vmap(jl.violated_mask)(jv)))


@pytest.mark.parametrize('spec', [
    {'disturbance_func': 'impulse', 'magnitude': 2.5, 'step_offset': 3,
     'duration': 4, 'decay_rate': 0.7},
    {'disturbance_func': 'step', 'magnitude': -1.5, 'mask': [1, 0, 1, 0]},
    {'disturbance_func': 'uniform', 'low': [-1, -2, 0, 0], 'high': [1, 2, 0.5, 3]},
    {'disturbance_func': 'white_noise', 'std': [0.1, 0.2, 0.3, 0.4]},
    {'disturbance_func': 'periodic', 'scale': 0.8, 'frequency': 1.3},
], ids=lambda s: s['disturbance_func'])
def test_disturbance_apply_drawn_matches_jax(spec):
    n, dim = 64, 4
    jl = jdist.create_disturbance_list([spec], {'dim': dim}, 100)
    tl = tdist.create_disturbance_list([spec], {'dim': dim}, 100)
    assert (tl.state_size, tl.noise_size) == (jl.state_size, jl.noise_size)
    rng = np.random.default_rng(1)
    target = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    dstate = rng.integers(0, 10, (n, tl.state_size)).astype(np.float32)
    drawn = rng.uniform(-1, 1, (n, tl.noise_size)).astype(np.float32)
    step = rng.integers(0, 12, n).astype(np.int32)
    t = step.astype(np.float32) * 0.02
    ref = jax.vmap(jl.apply_drawn)(target, dstate, step, t, drawn)
    got = tl.apply_drawn(torch.as_tensor(target), torch.as_tensor(dstate),
                         torch.as_tensor(step), torch.as_tensor(t), torch.as_tensor(drawn))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # Draws have the configured shape and moments.
    gen = torch.Generator().manual_seed(0)
    assert tl.draw(gen, 4096).shape == (4096, tl.noise_size)
    if spec['disturbance_func'] == 'white_noise':
        std = tl.draw(gen, 4096).std(dim=0).numpy()
        np.testing.assert_allclose(std, spec['std'], rtol=0.1)


def _compare_rollout(je, te, B, T, actions, drawn_noise=False, key0=1):
    """Step both packages T steps from one state; compare every step."""
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(key0), B)
    tst = env_state_from_numpy(_state_dict(jst), 'cpu')
    sar = jax.jit(je.func.step_autoreset)
    gen = torch.Generator().manual_seed(0)
    dist_act = je.disturbances.get('action')
    totals = np.zeros(3)
    for t in range(T):
        key = jax.random.PRNGKey(100 + t)
        drawn = None
        if drawn_noise:
            # The noise JAX's step_autoreset draws from this key.
            k_noise, _ = jax.random.split(key)
            k_a, _, _ = jax.random.split(k_noise, 3)
            drawn = {'action': torch.tensor(np.asarray(dist_act.draw(k_a, (B,))))}
        jst, jout, jobs = sar(jst, jnp.asarray(actions[t]), key)
        tst, tout, tobs = te.func.step_autoreset(tst, torch.as_tensor(actions[t]), gen,
                                                 drawn=drawn)
        np.testing.assert_allclose(tst.state.numpy(), np.asarray(jst.state), atol=1e-4)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4)
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
        np.testing.assert_array_equal(tst.ctrl_step.numpy(), np.asarray(jst.ctrl_step))
        np.testing.assert_array_equal(tout.constraint_violation.numpy(),
                                      np.asarray(jout.constraint_violation))
        np.testing.assert_allclose(tout.reward.numpy(), np.asarray(jout.reward),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tout.noisy_action.numpy(),
                                   np.asarray(jout.noisy_action), atol=1e-6)
        np.testing.assert_allclose(tout.mse.numpy(), np.asarray(jout.mse),
                                   rtol=1e-4, atol=1e-4)
        totals += [float(tout.done.sum()), float(tout.constraint_violation.sum()),
                   float(tout.out_of_bounds.sum())]
    return totals, tst


@pytest.mark.parametrize('task', ['stabilization', 'traj_tracking'])
@pytest.mark.parametrize('cost', ['rl_reward', 'quadratic'])
def test_step_autoreset_matches_jax(task, cost):
    over = dict(TRACK) if task == 'traj_tracking' else dict(episode_len_sec=2.0)
    je, te = _envs(cost=cost, **over)
    B, T = 64, 70
    actions = np.random.default_rng(8).uniform(-5, 5, (T, B, 1)).astype(np.float32)
    (dones, _, oob), tst = _compare_rollout(je, te, B, T, actions)
    # Out-of-bounds resets desynchronize the batch.
    assert dones > 0 and oob > 0
    assert int(tst.ctrl_step.max()) > int(tst.ctrl_step.min())


def test_constrained_white_noise_step_with_the_drawn_noise():
    je, te = _envs(episode_len_sec=2.0, constraints=BENCH_CONSTRAINTS,
                   disturbances={'action': [{'disturbance_func': 'white_noise',
                                             'std': 0.5}]})
    B, T = 64, 40
    # Beyond the +-10 N physical bound: input violations on the noisy action.
    actions = np.random.default_rng(6).uniform(-12, 12, (T, B, 1)).astype(np.float32)
    (dones, viols, _), _ = _compare_rollout(je, te, B, T, actions, drawn_noise=True)
    assert dones > 0 and viols > 0


def test_shim_episode_matches_jax():
    kw = dict(get_config('cartpole'), seed=3, randomized_init=False,
              init_state={'init_theta': 0.2})
    je = jmake('cartpole', **kw)
    te = tmake('cartpole', device='cpu', **kw)
    jobs, _ = je.reset()
    tobs, tinfo = te.reset()
    np.testing.assert_allclose(tobs, jobs, atol=1e-6)
    assert tinfo['current_step'] == 0
    done = False
    steps = 0
    while not done:
        a = np.array([np.sin(0.3 * steps)], np.float32)
        jobs, jrew, jdone, jinfo = je.step(a)
        tobs, trew, done, tinfo = te.step(a)
        steps += 1
        np.testing.assert_allclose(tobs, jobs, atol=1e-4)
        assert abs(trew - jrew) <= 1e-4 + 1e-4 * abs(jrew)
        assert done == jdone
        assert tinfo['current_step'] == jinfo['current_step']
        assert tinfo.get('out_of_bounds') == jinfo.get('out_of_bounds')
    assert steps > 1


def test_converter_carries_the_jax_state():
    je = jmake('cartpole', **BASE)
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(0), 8)
    d = _state_dict(jst)
    d['state'] = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    d['ctrl_step'] = np.arange(8, dtype=np.int32)
    est = env_state_from_numpy(d, 'cpu')
    np.testing.assert_array_equal(est.state.numpy(), d['state'])
    np.testing.assert_array_equal(est.ctrl_step.numpy(), d['ctrl_step'])
    assert est.ctrl_step.dtype == torch.int32
    assert float(est.dyn_params.pole_length) == pytest.approx(0.5)
    # Per-env parameters (randomized envs) carry across as (B,) tensors.
    per_env = cartpole_params_from_numpy(dict(d['dyn_params'], pole_mass=np.array([0.1, 0.2])),
                                         'cpu')
    assert per_env.pole_mass.tolist() == pytest.approx([0.1, 0.2])
    assert per_env.pole_length.ndim == 0
    # The adversary buffers carry across.
    adv = np.random.default_rng(1).normal(size=(8, 4)).astype(np.float32)
    est = env_state_from_numpy(dict(d, adv_action=adv, adv_valid=np.ones(8, bool)), 'cpu')
    np.testing.assert_array_equal(est.adv_action.numpy(), adv)
    assert est.adv_valid.dtype == torch.bool and bool(est.adv_valid.all())


@pytest.mark.parametrize('over', [dict(randomized_inertial_prop=True), dict(gui=True)])
def test_out_of_slice_configs_raise(over):
    """The configs the earlier slices refused (randomized inertial
    properties, the viewer) now build and step as JAX's do, and a malformed
    ``inertial_prop`` still raises in both packages."""
    je = jmake('cartpole', **dict(BASE, **over))
    te = tmake('cartpole', device='cpu', **dict(BASE, **over))
    _, jinfo = je.reset()
    _, info = te.reset()
    assert set(info['physical_parameters']) == set(jinfo['physical_parameters'])
    obs, _, _, _ = te.step(np.zeros(1, np.float32))
    assert np.isfinite(obs).all()
    assert (te._viewer is not None) == bool(over.get('gui'))
    te.close()
    je.close()
    for make in (jmake, partial(tmake, device='cpu')):
        with pytest.raises(ValueError):
            make('cartpole', **dict(BASE, inertial_prop=[0.5, 0.1], **over))
