"""The port's vectorized envs and episode statistics against the JAX package's, on the CPU.

* ``TorchVecEnv`` against ``JaxVecEnv`` on the cartpole and the 2D and 3D
  quadrotors, with deterministic resets and fixed actions, over a T that
  crosses auto-resets: observations, rewards, dones, terminal observations
  and every info key, to 1e-4 (float32 physics in both; JAX's vmapped scan
  and the port's plain K1-K3 round alike but not bit for bit).
* ``TorchVecEnv`` against ``FuncEnv.step_autoreset`` on the same generator,
  exactly, with randomized resets; one physics call a step for the batch.
* ``DummyVecEnv`` against ``SubprocVecEnv`` (two workers), exactly.
* ``VecRecordEpisodeStatistics`` against the JAX package's on the same
  steps, and ``RecordEpisodeStatistics`` over one env's episode.
"""

from functools import partial

import numpy as np
import pytest
import torch

from safe_control_gym_tpu.envs.env_wrappers.record_episode_statistics import \
    VecRecordEpisodeStatistics as JaxVecStats
from safe_control_gym_tpu.envs.env_wrappers.vectorized_env.jax_vec_env import JaxVecEnv
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.envs.env_wrappers.record_episode_statistics import (
    RecordEpisodeStatistics, VecRecordEpisodeStatistics)
from safe_control_gym_tpu_torch.envs.env_wrappers.vectorized_env import (DummyVecEnv,
                                                                         SubprocVecEnv,
                                                                         TorchVecEnv,
                                                                         make_vec_envs)
from safe_control_gym_tpu_torch.ops import physics_kernels
from safe_control_gym_tpu_torch.utils.registration import make as tmake

# Deterministic resets; short episodes, so that T crosses the time limit and,
# on the cartpole, out-of-bounds ends.
SYSTEMS = {
    'cartpole': ('cartpole', dict(randomized_init=False, normalized_rl_action_space=True,
                                  episode_len_sec=1, init_state={'init_theta': 0.15},
                                  done_on_out_of_bound=True,
                                  constraints=[{'constraint_form': 'default_constraint',
                                                'constrained_variable': 'state'}])),
    'quadrotor_2D': ('quadrotor', dict(quad_type=2, randomized_init=False,
                                       normalized_rl_action_space=True, episode_len_sec=1,
                                       init_state={'init_z': 1.0})),
    'quadrotor_3D': ('quadrotor', dict(quad_type=3, randomized_init=False,
                                       normalized_rl_action_space=True, episode_len_sec=1,
                                       init_state={'init_z': 1.0},
                                       task_info={'stabilization_goal': [0, 0, 1]})),
}
ADVANCE = {'cartpole': 'cartpole_advance_plain', 'quadrotor_2D': 'quad2d_advance_plain',
           'quadrotor_3D': 'quad3d_advance_plain'}
B = 8


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _actions(env, T, seed=0):
    return np.random.default_rng(seed).uniform(
        -1, 1, (T, B, env.action_space.shape[0])).astype(np.float32)


def _assert_info(got, want, msg):
    assert set(got) == set(want), msg
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_info(g, w, f'{msg} {k}')
        elif isinstance(w, (bool, int, np.integer)) and not isinstance(w, float):
            assert g == w and type(g) is type(w), (msg, k, g, w)
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4, err_msg=f'{msg} {k}')


def _assert_equal_info(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_equal_info(got[k], w)
        else:
            np.testing.assert_array_equal(got[k], w)


@pytest.mark.parametrize('system', sorted(SYSTEMS))
def test_torch_vec_env_matches_jax_vec_env(system):
    env_id, task = SYSTEMS[system]
    jvenv = JaxVecStats(JaxVecEnv(partial(jmake, env_id, **task), B, seed=0))
    tvenv = VecRecordEpisodeStatistics(
        make_vec_envs(partial(tmake, env_id, device='cpu', **task), batch_size=B, seed=0))
    T = tvenv.venv.func.max_steps + 15
    acts = _actions(tvenv, T)
    np.testing.assert_allclose(tvenv.reset(), jvenv.reset(), rtol=0, atol=1e-6)
    ends = 0
    for t in range(T):
        obs, rew, done, infos = tvenv.step(acts[t])
        jobs, jrew, jdone, jinfos = jvenv.step(acts[t])
        np.testing.assert_array_equal(done, np.asarray(jdone))
        np.testing.assert_allclose(rew, jrew, rtol=0, atol=1e-4, err_msg=f'reward {t}')
        np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-4, err_msg=f'obs {t}')
        for i in range(B):
            _assert_info(infos[i], jinfos[i], f'step {t} env {i}')
        ends += int(done.sum())
    assert ends >= B          # every env crossed at least one auto-reset
    assert list(tvenv.length_queue) == [int(x) for x in jvenv.length_queue]
    np.testing.assert_allclose(list(tvenv.return_queue), list(jvenv.return_queue), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize('system', sorted(SYSTEMS))
def test_one_physics_call_a_step_equal_to_step_autoreset(system, monkeypatch):
    env_id, task = SYSTEMS[system]
    task = dict(task, randomized_init=True)
    calls = []
    name = ADVANCE[system]
    plain = getattr(physics_kernels, name)

    def counting(states, *args, **kwargs):
        calls.append(states.shape[0])
        return plain(states, *args, **kwargs)

    monkeypatch.setattr(physics_kernels, name, counting)
    venv = make_vec_envs(partial(tmake, env_id, device='cpu', **task), batch_size=B, seed=3)
    assert isinstance(venv, TorchVecEnv)
    func = tmake(env_id, device='cpu', **task).func
    gen = torch.Generator().manual_seed(3)
    T = func.max_steps + 15
    acts = _actions(venv, T, seed=1)
    est, ref_obs = func.reset_batch(gen, B)
    np.testing.assert_array_equal(venv.reset(), ref_obs.numpy())
    for t in range(T):
        obs, rew, done, infos = venv.step(acts[t])
        est, out, ref_obs = func.step_autoreset(est, torch.tensor(acts[t]), gen)
        np.testing.assert_array_equal(obs, ref_obs.numpy())
        np.testing.assert_array_equal(rew, out.reward.numpy())
        np.testing.assert_array_equal(done, out.done.numpy())
        for i in np.flatnonzero(done):
            np.testing.assert_array_equal(infos[i]['terminal_observation'], out.obs[i].numpy())
    assert calls == [B] * (2 * T)   # the vec env's steps, then the reference's


def test_dummy_and_subproc_vec_envs_agree():
    env_id, task = SYSTEMS['cartpole']
    task = dict(task, randomized_init=True)
    env_func = partial(tmake, env_id, device='cpu', **task)
    dummy = make_vec_envs(env_func, batch_size=4, seed=5, backend='numpy')
    sub = make_vec_envs(env_func, batch_size=4, seed=5, backend='numpy', n_processes=2)
    assert isinstance(dummy, DummyVecEnv) and isinstance(sub, SubprocVecEnv)
    try:
        np.testing.assert_array_equal(sub.reset(), dummy.reset())
        acts = np.random.default_rng(2).uniform(-1, 1, (60, 4, 1)).astype(np.float32)
        ends = 0
        for t in range(60):
            a, b = sub.step(acts[t]), dummy.step(acts[t])
            for x, y in zip(a[:3], b[:3]):
                np.testing.assert_array_equal(x, y)
            for i in range(4):
                _assert_equal_info(a[3][i], b[3][i])
            ends += int(b[2].sum())
        assert ends > 0
        assert sub.get_attr('CTRL_STEPS') == dummy.get_attr('CTRL_STEPS') == [50] * 4
        states = sub.get_env_random_state()
        sub.set_env_random_state(states)
        assert len(states) == 4 and sub.env_method('seed', [7]) == [[7]] * 4
    finally:
        sub.close()
        dummy.close()
    assert not any(p.is_alive() for p in sub.ps)


def test_single_env_episode_statistics():
    env_id, task = SYSTEMS['cartpole']
    env = RecordEpisodeStatistics(tmake(env_id, device='cpu', seed=0, **task), deque_size=4)
    env.add_tracker('constraint_violation', 0)
    env.add_tracker('mse', 0.0, mode='queue')
    obs, _ = env.reset()
    total, steps, done = 0.0, 0, False
    while not done:
        obs, rew, done, info = env.step(np.array([0.2]))
        total += rew
        steps += 1
    ep = info['episode']
    assert ep['l'] == steps and ep['r'] == pytest.approx(total)
    assert ep['mse'] == info['mse'] and list(env.length_queue) == [steps]
    assert env.CTRL_STEPS == 50    # attributes pass through to the env
