"""Closed-loop policy evaluation (``experiments/fused_eval.py``) and the
inference controllers against the JAX package, on the CPU: ``select_action``
of PPO, SAC and DDPG loaded from the same checkpoints (atol 1e-5); the
per-step path's per-env reward sums (rtol/atol 1e-4) and done counts (exact)
against the JAX package's scan path on a deterministic PPO with fixed resets;
the plain K4 under ``use_kernel=True`` against the per-step path; and the
gates that send a config to the per-step path, against JAX's."""

import functools
import os

import numpy as np
import pytest
import torch

from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments import fused_eval as tfe
from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
from safe_control_gym_tpu_torch.parallel.sharding import make_env_mesh
from safe_control_gym_tpu_torch.utils.registration import make as tmake
from tests.torch_sharding_ranks import one_rank


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED_START = dict(randomized_init=False, init_state={'init_x': 0.1, 'init_theta': 0.05})


def _model(algo, system, task='stab'):
    return os.path.join(ROOT, 'examples', 'rl', 'models', algo,
                        f'{algo}_model_{system}_{task}.pt')


def _task_config(system, task='stab'):
    import yaml
    with open(os.path.join(ROOT, 'examples', 'rl', 'config_overrides', system,
                           f'{system}_{task}.yaml')) as f:
        return yaml.safe_load(f)['task_config']


def _pair(algo, system, tmp_path, task='stab', over=None, load=True):
    """The JAX and the port controller of one committed model (or of a fresh
    JAX one, carried across through a checkpoint), on the CPU."""
    env_id, _, algo_config = eval_config(algo, system) if algo != 'ddpg' else (
        'cartpole', None, {})
    task_config = dict(_task_config(system, task), **(over or {}))
    jctrl = jmake(algo, functools.partial(jmake, env_id, **task_config),
                  **{**jget(algo), **algo_config, 'output_dir': str(tmp_path)})
    tctrl = tmake(algo, functools.partial(tmake, env_id, device='cpu', **task_config),
                  **algo_config)
    path = _model(algo, system, task) if load else str(tmp_path / 'model.pt')
    if load:
        jctrl.load(path)
    else:
        jctrl.save(path)
    tctrl.load(path)
    return jctrl, tctrl


@pytest.mark.parametrize('algo,system', [('ppo', 'cartpole'), ('sac', 'quadrotor_3D'),
                                         ('ppo', 'quadrotor_2D'), ('ddpg', 'cartpole')])
def test_select_action_matches_jax(tmp_path, algo, system):
    jctrl, tctrl = _pair(algo, system, tmp_path, load=algo != 'ddpg')
    try:
        obs = np.random.default_rng(0).normal(0, 0.3, (16, tctrl.env.obs_dim)).astype(np.float32)
        np.testing.assert_allclose(tctrl.select_action(obs), jctrl.select_action(obs),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tctrl.select_action(obs[0]), jctrl.select_action(obs[0]),
                                   rtol=0, atol=1e-5)
    finally:
        jctrl.close()
        tctrl.close()


def test_per_step_path_matches_jax_scan_and_plain_kernel(tmp_path):
    jctrl, tctrl = _pair('ppo', 'cartpole', tmp_path, over=FIXED_START)
    try:
        kw = dict(batch=32, n_steps=300, seed=0, return_per_env=True, n_reps=0)
        want = jctrl.evaluate_fused(**kw)
        got = tctrl.evaluate_fused(**kw)
        kern = tctrl.evaluate_fused(use_kernel=True, **kw)
    finally:
        jctrl.close()
        tctrl.close()
    assert want['path'] == got['path'] == 'per-step-scan'
    assert kern['path'] == 'policy-in-kernel'
    assert got['episodes'] == want['episodes'] > 0
    for other in (want, kern):
        np.testing.assert_allclose(got['per_env']['reward_sum'], other['per_env']['reward_sum'],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got['per_env']['done_count'],
                                      other['per_env']['done_count'])
    np.testing.assert_allclose(got['rmse'], want['rmse'], rtol=1e-4)
    assert set(want) == set(got)


@pytest.mark.parametrize('system,task', [('cartpole', 'stab'), ('cartpole', 'track'),
                                         ('quadrotor_2D', 'stab'), ('quadrotor_2D', 'track'),
                                         ('quadrotor_3D', 'stab'), ('quadrotor_3D', 'track')])
def test_gates_route_the_committed_configs_as_jax_does(system, task):
    """cartpole_stab and quadrotor_3D_stab pass the kernel's gates; every
    *_track model (obs_goal_horizon) and quadrotor_2D_stab (a state box that
    is not the default) go to the per-step path. JAX agrees except on
    quadrotor_3D_stab, where its cfg builder raises KeyError."""
    import safe_control_gym_tpu.experiments.fused_eval as jfe
    env_id = 'cartpole' if system == 'cartpole' else 'quadrotor'
    task_config = _task_config(system, task)
    tctrl = tmake('sac', functools.partial(tmake, env_id, device='cpu', **task_config))
    tctrl.load(_model('sac', system, task))
    spec = tfe.policy_eval_spec(tctrl, tctrl.env)
    try:
        tfe._kernel_gates(spec, tctrl.env, False)
        port_kernel = True
    except ValueError:
        port_kernel = False
    assert port_kernel == (task == 'stab' and system != 'quadrotor_2D')
    jenv = jmake(env_id, **task_config)
    if (system, task) == ('quadrotor_3D', 'stab'):
        with pytest.raises(KeyError):
            jfe._kernel_gates({}, jenv, False)
    else:
        try:
            jfe._kernel_gates({}, jenv, False)
            jax_kernel = True
        except ValueError:
            jax_kernel = False
        assert jax_kernel == port_kernel
    # Off the card, None takes the per-step path.
    res = tctrl.evaluate_fused(batch=4, n_steps=3, n_reps=0)
    assert res['path'] == 'per-step-scan'
    tctrl.close()


def test_gates_refuse_what_neither_path_reproduces(tmp_path):
    tctrl = tmake('sac', functools.partial(tmake, 'cartpole', device='cpu',
                                           **_task_config('cartpole')))
    with pytest.raises(ValueError, match='stochastic mode is PPO-only'):
        tctrl.evaluate_fused(batch=4, n_steps=3, stochastic=True)
    with one_rank(), pytest.raises(ValueError, match='runs the per-step path'):
        tctrl.evaluate_fused(batch=4, n_steps=3, mesh=make_env_mesh(), use_kernel=True)
    tctrl.close()
    physical = dict(_task_config('cartpole'), normalized_rl_action_space=False)
    ddpg = tmake('ddpg', functools.partial(tmake, 'cartpole', device='cpu', **physical))
    with pytest.raises(ValueError, match='normalized action space'):
        ddpg.evaluate_fused(batch=4, n_steps=3)
    ddpg.close()
    ppo = tmake('ppo', functools.partial(tmake, 'cartpole', device='cpu', **physical))
    res = ppo.evaluate_fused(batch=4, n_steps=3, stochastic=True, n_reps=0)
    assert res['path'] == 'per-step-scan' and res['total_steps'] == 12
    ppo.close()
