"""The port's PPO training against the JAX package's on cartpole, on the CPU:
the batched rollout against ``PPO._rollout_jit`` from one state with the
action noise JAX's key chain drew (batch and normalizer states atol 1e-4,
done and violation counts exact); a JAX-written checkpoint loaded into the
port, and one update from it against JAX's on the same batch and
permutations (params atol 1e-4); and the port's own learn -> save -> load,
exact resume (atol 1e-5), ``fused_iterations`` and the interval
bookkeeping. The run to 300k env steps, which checks that the port solves
cartpole where JAX does, is marked slow."""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy
from safe_control_gym_tpu_torch.utils.registration import make as tmake


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


# Cartpole from rest with the pole at 0.15 rad: in 1 s episodes some envs'
# poles pass the 12 degree bound (oob dones) and the others time out
# (truncations), so T = 100 sees both and the auto-resets after each.
TASK = dict(seed=0, normalized_rl_action_space=True, randomized_init=False,
            episode_len_sec=1, init_state={'init_theta': 0.15},
            task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.0})
ALGO = dict(rollout_batch_size=8, rollout_steps=25, mini_batch_size=64, opt_epochs=2,
            use_gae=True, norm_obs=True, norm_reward=True)


def _jax_ppo(tmp, seed=0, task=TASK, **over):
    cfg = {**jget('ppo'), **ALGO, **over}
    return jmake('ppo', functools.partial(jmake, 'cartpole', **task), output_dir=str(tmp),
                 seed=seed, **cfg)


def _port_ppo(tmp, seed=0, task=TASK, **over):
    return tmake('ppo', functools.partial(tmake, 'cartpole', device='cpu', **task),
                 output_dir=str(tmp), seed=seed, **{**ALGO, **over})


def _state_dict(est):
    """A JAX EnvState as the dict of numpy arrays the converter takes."""
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def _agent_numpy(agent):
    return jax.tree.map(np.asarray, {'params': agent.params,
                                     'actor_opt_state': agent.actor_opt_state,
                                     'critic_opt_state': agent.critic_opt_state})


def _close(got, want, atol, msg=''):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=msg)


def _assert_normalizers(tctrl, obs_norm, ret_state, atol):
    for k in ('mean', 'var', 'count'):
        _close(getattr(tctrl.obs_norm_state, k), getattr(obs_norm, k), atol, k)
        _close(getattr(tctrl.ret_norm_state.rms, k), getattr(ret_state.rms, k), atol, k)
    _close(tctrl.ret_norm_state.ret, ret_state.ret, atol, 'ret')


def test_rollout_matches_rollout_jit(tmp_path):
    T, N = 100, 16
    jctrl = _jax_ppo(tmp_path / 'j', rollout_steps=T, rollout_batch_size=N)
    tctrl = _port_ppo(tmp_path / 't', rollout_steps=T, rollout_batch_size=N)
    jctrl.reset()
    tctrl.agent.load_state_dict(_agent_numpy(jctrl.agent))
    tctrl._env_states = env_state_from_numpy(_state_dict(jctrl._env_states), 'cpu')
    tctrl._obs = torch.tensor(np.asarray(jctrl._obs))
    key = jax.random.PRNGKey(11)
    noise, k = [], key
    for _ in range(T):
        k, k_act, _ = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.normal(k_act, (N, 1))))
    (est, obs, obs_norm, ret_state, _, jbatch, jstats) = jctrl._rollout_jit(
        jctrl.agent.params, jctrl._env_states, jctrl._obs, jctrl.obs_norm_state,
        jctrl.ret_norm_state, key)
    ends = {'oob': 0, 'truncated': 0}
    step_autoreset = tctrl.func_env.step_autoreset

    def counting(est, act, gen):
        est, out, obs = step_autoreset(est, act, gen)
        ends['oob'] += int(out.out_of_bounds.sum())
        ends['truncated'] += int(out.truncated.sum())
        return est, out, obs

    tctrl.func_env.step_autoreset = counting
    batch, stats = tctrl.rollout(noise=torch.tensor(np.stack(noise)))
    assert ends['oob'] > 0 and ends['truncated'] > 0, ends
    assert ends['oob'] + ends['truncated'] == float(stats['dones'])
    for name in ('obs', 'act', 'logp', 'v', 'ret', 'adv'):
        _close(batch[name], jbatch[name], 1e-4, name)
    assert float(stats['dones']) == float(jstats['dones'])
    assert float(stats['constraint_violations']) == float(jstats['constraint_violations'])
    for name in ('mean_reward', 'mean_mse'):
        _close(stats[name], jstats[name], 1e-4, name)
    _close(tctrl._env_states.state, est.state, 1e-4, 'state')
    np.testing.assert_array_equal(tctrl._env_states.ctrl_step.numpy(), np.asarray(est.ctrl_step))
    _close(tctrl._obs, obs, 1e-4, 'obs')
    _assert_normalizers(tctrl, obs_norm, ret_state, 1e-4)
    jctrl.close()
    tctrl.close()


def test_jax_checkpoint_loads_and_updates_as_jax(tmp_path):
    jctrl = _jax_ppo(tmp_path / 'j', max_env_steps=200, rollout_batch_size=4)
    jctrl.reset()
    jctrl.learn()
    path = str(tmp_path / 'jax.pt')
    jctrl.save(path)
    tctrl = _port_ppo(tmp_path / 't', seed=5, rollout_batch_size=4)
    tctrl.load(path)
    assert tctrl.total_steps == jctrl.total_steps == 200
    for got, want in zip(tree_leaves(tctrl.agent.params), jax.tree.leaves(jctrl.agent.params)):
        _close(got, want, 0)
    for opt in ('actor_opt_state', 'critic_opt_state'):
        adam = getattr(jctrl.agent, opt)[1][0]
        state = getattr(tctrl.agent, opt)
        assert int(state['count']) == int(adam.count) > 0
        for name in ('mu', 'nu'):
            for got, want in zip(state[name], jax.tree.leaves(getattr(adam, name))):
                _close(got, want, 0)
    _assert_normalizers(tctrl, jctrl.obs_norm_state, jctrl.ret_norm_state, 0)
    _close(tctrl._env_states.state, jctrl._env_states.state, 0)
    _close(tctrl._obs, jctrl._obs, 0)
    # The generator is re-seeded from the controller's seed (5).
    assert torch.equal(tctrl.gen.get_state(), torch.Generator().manual_seed(5).get_state())

    rng = np.random.default_rng(8)
    m = 100
    batch = {'obs': rng.normal(0, 1, (m, 4)), 'act': rng.normal(0, 0.6, (m, 1)),
             'logp': rng.normal(-1.0, 0.2, (m, 1)), 'adv': rng.normal(0, 1, (m, 1)),
             'ret': rng.normal(0, 1, (m, 1)), 'v': rng.normal(0, 1, (m, 1))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    params, a_state, _, _ = jctrl.agent._update_jit(
        jctrl.agent.params, jctrl.agent.actor_opt_state, jctrl.agent.critic_opt_state,
        {k: jax.numpy.asarray(v) for k, v in batch.items()}, key)
    _, _, used = tctrl.agent.minibatch_plan(m)
    perms = [np.asarray(jax.random.permutation(k, m)[:used])
             for k in jax.random.split(key, 2)]
    tctrl.agent.update({k: torch.tensor(v) for k, v in batch.items()}, perms=perms)
    for got, want in zip(tree_leaves(tctrl.agent.params), jax.tree.leaves(params)):
        _close(got, want, 1e-4)
    assert int(tctrl.agent.actor_opt_state['count']) == int(a_state[1][0].count)
    jctrl.close()
    tctrl.close()


def test_learn_save_load_in_a_fresh_controller(tmp_path):
    ctrl = _port_ppo(tmp_path / 'a', max_env_steps=400, checkpoint_path='last.pt')
    ctrl.reset()
    ctrl.learn()
    assert ctrl.total_steps == 400
    assert ctrl.checkpoint_path == os.path.join(str(tmp_path / 'a'), 'last.pt')
    assert os.path.exists(ctrl.checkpoint_path)
    fresh = _port_ppo(tmp_path / 'b', seed=7)
    fresh.load(ctrl.checkpoint_path)
    assert fresh.total_steps == 400
    obs = np.float32([0.05, -0.1, 0.02, 0.3])
    np.testing.assert_allclose(fresh.select_action(obs), ctrl.select_action(obs), rtol=0,
                               atol=1e-6)
    assert torch.equal(fresh.gen.get_state(), ctrl.gen.get_state())
    ctrl.close()
    fresh.close()


def test_resume_matches_uninterrupted(tmp_path):
    """As tests/test_resume.py holds the JAX package: 4 iterations straight,
    against 2, a checkpoint, and 2 more in a controller of another seed."""
    a = _port_ppo(tmp_path / 'a', max_env_steps=800)
    a.reset()
    a.learn()
    b = _port_ppo(tmp_path / 'b', max_env_steps=400)
    b.reset()
    b.learn()
    ckpt = str(tmp_path / 'ckpt.pt')
    b.save(ckpt)
    c = _port_ppo(tmp_path / 'c', seed=99, max_env_steps=800)
    c.load(ckpt)
    c.learn()
    assert a.total_steps == c.total_steps == 800
    for got, want in zip(tree_leaves(c.agent.params), tree_leaves(a.agent.params)):
        _close(got, want.numpy(), 1e-5)
    obs = np.full(4, 0.07, np.float32)
    np.testing.assert_allclose(c.select_action(obs), a.select_action(obs), rtol=0, atol=1e-5)
    for x in (a, b, c):
        x.close()


def test_fused_iterations_match_one_at_a_time(tmp_path):
    one = _port_ppo(tmp_path / 'one', max_env_steps=800)
    one.reset()
    one.learn()
    two = _port_ppo(tmp_path / 'two', max_env_steps=800, fused_iterations=2)
    two.reset()
    two.learn()
    assert one.total_steps == two.total_steps == 800
    for got, want in zip(tree_leaves(two.agent.params), tree_leaves(one.agent.params)):
        _close(got, want.numpy(), 0)
    assert set(two.last_results) >= {'policy_loss', 'value_loss', 'entropy_loss',
                                     'approx_kl', 'mean_reward', 'dones', 'step'}
    one.close()
    two.close()


def test_intervals_log_save_and_evaluate(tmp_path):
    ctrl = _port_ppo(tmp_path, max_env_steps=600, log_interval=200, save_interval=400,
                     num_checkpoints=1, eval_interval=400, eval_batch_size=3,
                     eval_save_best=True)
    ctrl.reset()
    ctrl.learn()
    assert sorted(os.listdir(tmp_path / 'checkpoints')) == ['model_400.pt', 'model_600.pt']
    assert os.path.exists(tmp_path / 'model_best.pt')
    assert os.path.exists(tmp_path / 'model_latest.pt')
    with open(tmp_path / 'logs' / 'ppo_policy_loss.log') as f:
        assert [int(line.split()[0]) for line in f] == [200, 400, 600]
    res = ctrl.run(n_episodes=3)
    assert res['ep_returns'].shape == (3,) and np.all(res['ep_lengths'] >= 1)
    assert np.all(res['ep_lengths'] <= ctrl.eval_env.func.max_steps + 1)
    ctrl.close()


@pytest.mark.slow
def test_cartpole_solves_as_jax_does(tmp_path):
    """The committed cartpole config (64 envs x 150 steps, 300k env steps)
    from seed 0 through both packages on the CPU; each one's 10-episode
    deterministic eval return is printed, and the port's must clear the
    solved mark of 200 that JAX's clears."""
    env_id, task, algo = eval_config('ppo', 'cartpole')
    jctrl = jmake('ppo', functools.partial(jmake, env_id, **task), training=True,
                  output_dir=str(tmp_path / 'j'), seed=0, **{**jget('ppo'), **algo})
    jctrl.reset()
    jctrl.learn()
    jret = float(jctrl.run(n_episodes=10)['ep_returns'].mean())
    tctrl = tmake('ppo', functools.partial(tmake, env_id, device='cpu', **task),
                  training=True, output_dir=str(tmp_path / 't'), seed=0, **algo)
    tctrl.reset()
    tctrl.learn()
    tret = float(tctrl.run(n_episodes=10)['ep_returns'].mean())
    print(json.dumps({'jax_eval_return': jret, 'port_eval_return': tret,
                      'total_steps': tctrl.total_steps}))
    assert tctrl.total_steps == jctrl.total_steps >= int(algo['max_env_steps'])
    assert jret >= 200 and tret >= 200
    jctrl.close()
    tctrl.close()
