"""The port's SAC and DDPG training against the JAX package's, on the CPU.

The schedules and exploration processes on JAX's draws (1e-6); one to three
``SACAgent`` updates (with and without entropy tuning) and ``DDPGAgent``
updates against JAX's ``make_update_step()`` on the same batches and normals
(parameters, targets, ``log_alpha``, Adam states and losses 1e-5); the
collects against JAX's ``_collect_jit`` on the same uniforms or normals and
deterministic resets (ring rows 1e-4, masks exact, time-truncated and
terminated episodes both in the window); JAX-written checkpoints loaded by
the port (actions 1e-6, the ring and env states as written); the port's own
learn -> save -> load, exact resume (1e-5) and the iteration bookkeeping,
``fused_iterations`` included."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.math import random_processes as jrp
from safe_control_gym_tpu.math import schedules as jsched
from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.math import random_processes as trp
from safe_control_gym_tpu_torch.math import schedules as tsched
from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy
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


# Cartpole from rest with the pole at 0.1 rad in 1 s episodes: under random
# actions some envs pass the 12 degree bound (terminations, mask 0) and the
# rest reach the time limit (truncations, mask 1) within 120 steps.
TASK = dict(seed=0, normalized_rl_action_space=True, randomized_init=False,
            episode_len_sec=1, init_state={'init_theta': 0.1}, done_on_out_of_bound=True,
            task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.0})
ALGO = dict(hidden_dim=32, rollout_batch_size=4, train_interval=240, train_batch_size=32,
            max_buffer_size=4000, warm_up_steps=240)


def _state_dict(est):
    """A JAX EnvState as the dict of numpy arrays the converter takes."""
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def _close(got, want, atol, msg=''):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=msg)


def _jax_ctrl(algo, tmp, **over):
    cfg = {**jget(algo), **ALGO, **over}
    return jmake(algo, functools.partial(jmake, 'cartpole', **TASK), output_dir=str(tmp),
                 seed=0, **cfg)


def _port_ctrl(algo, tmp, seed=0, **over):
    return tmake(algo, functools.partial(tmake, 'cartpole', device='cpu', **TASK),
                 output_dir=str(tmp), seed=seed, **{**ALGO, **over})


def _assert_agent(tagent, jagent, atol):
    """Every array of the two agents' state dicts (params, targets, log_alpha,
    and the Adam count, mu and nu of each optimizer)."""
    jsd = jax.tree.map(np.asarray, jagent.state_dict())
    tsd = tagent.state_dict()
    for name in ('params', 'target', 'log_alpha'):
        if name in jsd:
            for got, want in zip(tree_leaves(tsd[name]), jax.tree.leaves(jsd[name])):
                _close(got, want, atol, name)
    for name in [k for k in jsd if k.endswith('opt_state')]:
        adam = jsd[name][0]
        assert int(tsd[name]['count']) == int(adam.count), name
        for part in ('mu', 'nu'):
            for got, want in zip(tsd[name][part], jax.tree.leaves(getattr(adam, part))):
                _close(got, want, atol, f'{name}.{part}')


def test_schedules_and_noise_processes_match_jax():
    for args in ((0.2,), (0.3, 0.05, 1000), (0.05, 0.3, 700)):
        j, t = jsched.LinearSchedule(*args), tsched.LinearSchedule(*args)
        for steps in (1, 100, 250, 900):
            assert t(steps) == pytest.approx(j(steps), abs=1e-12)
    assert tsched.ConstantSchedule(0.4)(10) == jsched.ConstantSchedule(0.4)(10)
    key = jax.random.PRNGKey(4)
    state_j, state_t = jrp.ou_init((8, 2)), trp.ou_init((8, 2))
    for k in jax.random.split(key, 20):
        w = np.asarray(jax.random.normal(k, (8, 2)))
        noise_j, state_j = jrp.ou_sample(state_j, k, 0.3, theta=0.2, dt=0.05)
        noise_t, state_t = trp.ou_sample(state_t, None, 0.3, theta=0.2, dt=0.05, normals=w)
        _close(noise_t, noise_j, 1e-6, 'ou')
    _close(trp.gaussian_sample(None, (8, 2), 0.7, normals=w),
           jrp.gaussian_sample(k, (8, 2), 0.7), 1e-6, 'gaussian')
    # The classes step a std schedule as the reference's do.
    jou = jrp.OrnsteinUhlenbeckProcess(3, jsched.LinearSchedule(0.2, 0.1, 10))
    tou = trp.OrnsteinUhlenbeckProcess(3, tsched.LinearSchedule(0.2, 0.1, 10))
    for _ in range(4):
        jou._key, k = jax.random.split(jou._key)
        want = np.asarray(jrp.ou_sample(jou.x_prev, k, jou.std(), jou.theta, jou.dt)[0])
        jou.x_prev = jnp.asarray(want)
        _close(tou.sample(normals=np.asarray(jax.random.normal(k, (3,)))), want, 1e-6, 'class')
    # DDPG's noise spec builds the same process and schedule in both packages.
    from safe_control_gym_tpu.controllers.ddpg.ddpg_utils import \
        make_action_noise_process as jmake_noise
    from safe_control_gym_tpu_torch.controllers.ddpg.ddpg_utils import make_action_noise_process
    from safe_control_gym_tpu_torch.envs.spaces import Box
    spec = {'func': 'OrnsteinUhlenbeckProcess', 'theta': 0.3,
            'std': {'func': 'LinearSchedule', 'args': [0.2, 0.1, 50]}}
    space = Box(low=-np.ones(2), high=np.ones(2))
    jproc, tproc = jmake_noise(dict(spec), space), make_action_noise_process(dict(spec), space)
    assert type(tproc).__name__ == type(jproc).__name__ and tproc.theta == jproc.theta == 0.3
    assert [tproc.std(10) for _ in range(3)] == pytest.approx([jproc.std(10) for _ in range(3)])


def _batches(rng, n, b=48, obs_dim=4, act_dim=1):
    out = []
    for _ in range(n):
        batch = {'obs': rng.normal(0, 1, (b, obs_dim)), 'act': rng.uniform(-1, 1, (b, act_dim)),
                 'rew': rng.normal(0, 1, (b, 1)), 'next_obs': rng.normal(0, 1, (b, obs_dim)),
                 'mask': (rng.random((b, 1)) > 0.2).astype(np.float64)}
        out.append({k: v.astype(np.float32) for k, v in batch.items()})
    return out


@pytest.mark.parametrize('tuning', [False, True], ids=['fixed_alpha', 'entropy_tuning'])
def test_sac_update_matches_jax(tmp_path, tuning):
    jctrl = _jax_ctrl('sac', tmp_path / 'j', use_entropy_tuning=tuning)
    tctrl = _port_ctrl('sac', tmp_path / 't', use_entropy_tuning=tuning)
    tctrl.agent.load_state_dict(jax.tree.map(np.asarray, jctrl.agent.state_dict()))
    update = jax.jit(jctrl.agent.make_update_step())
    ts = jctrl.agent.train_state()
    for i, batch in enumerate(_batches(np.random.default_rng(3), 3)):
        key = jax.random.PRNGKey(10 + i)
        k1, k2 = jax.random.split(key)
        noise = [np.asarray(jax.random.normal(k, (48, 1))) for k in (k1, k2)]
        ts, jlosses = update(ts, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tlosses = tctrl.agent.update({k: torch.tensor(v) for k, v in batch.items()},
                                     noise=[torch.tensor(n) for n in noise])
        _close(tlosses, jlosses, 1e-5, f'losses {i}')
    jctrl.agent.set_train_state(ts)
    _assert_agent(tctrl.agent, jctrl.agent, 1e-5)
    if tuning:
        assert abs(float(tctrl.agent.log_alpha) - np.log(0.2)) > 1e-4
    jctrl.close()
    tctrl.close()


def test_ddpg_update_matches_jax(tmp_path):
    jctrl = _jax_ctrl('ddpg', tmp_path / 'j')
    tctrl = _port_ctrl('ddpg', tmp_path / 't')
    tctrl.agent.load_state_dict(jax.tree.map(np.asarray, jctrl.agent.state_dict()))
    update = jax.jit(jctrl.agent.make_update_step())
    ts = jctrl.agent.train_state()
    for i, batch in enumerate(_batches(np.random.default_rng(5), 3)):
        ts, jlosses = update(ts, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(i))
        tlosses = tctrl.agent.update({k: torch.tensor(v) for k, v in batch.items()})
        _close(tlosses, jlosses, 1e-5, f'losses {i}')
    jctrl.agent.set_train_state(ts)
    _assert_agent(tctrl.agent, jctrl.agent, 1e-5)
    jctrl.close()
    tctrl.close()


def _collect_draws(algo, key, steps, n=4):
    """The uniforms and normals JAX's collect scan draws from ``key``."""
    uniforms, normals = [], []
    for _ in range(steps):
        if algo == 'sac':
            key, k_act, _ = jax.random.split(key, 3)
            k_ou = k_act
        else:
            key, k_act, k_ou, _ = jax.random.split(key, 4)
        uniforms.append(np.asarray(jax.random.uniform(k_act, (n, 1))))
        normals.append(np.asarray(jax.random.normal(k_ou, (n, 1))))
    return uniforms, normals


def _ring(buffer, rows):
    return {k: np.asarray(v)[:rows] for k, v in buffer.data.items()}


@pytest.mark.parametrize('algo', ['sac', 'ddpg'])
def test_collect_and_checkpoint_match_jax(tmp_path, algo):
    """Two collects, random then policy phase, against ``_collect_jit`` on the
    draws JAX made; then a JAX checkpoint (one update applied, the ring, env
    states) loaded into a fresh port controller."""
    jctrl = _jax_ctrl(algo, tmp_path / 'j')
    tctrl = _port_ctrl(algo, tmp_path / 't')
    jctrl.reset()
    tctrl.agent.load_state_dict(jax.tree.map(np.asarray, jctrl.agent.state_dict()))
    tctrl._env_states = env_state_from_numpy(_state_dict(jctrl._env_states), 'cpu')
    tctrl._obs = torch.tensor(np.asarray(jctrl._obs))
    steps = tctrl.steps_per_iter
    assert steps == 60
    ends = {'terminated': 0, 'truncated': 0}
    step_autoreset = tctrl.func_env.step_autoreset

    def counting(est, act, gen):
        est, out, obs = step_autoreset(est, act, gen)
        ends['terminated'] += int((out.done & ~out.truncated).sum())
        ends['truncated'] += int(out.truncated.sum())
        return est, out, obs

    tctrl.func_env.step_autoreset = counting
    std = 0.2
    for phase, random_phase in enumerate((True, False)):
        key = jax.random.PRNGKey(20 + phase)
        uniforms, normals = _collect_draws(algo, key, steps)
        if algo == 'sac':
            (jctrl._env_states, jctrl._obs, jctrl.buffer, jrew) = jctrl._collect_jit(
                jctrl.agent.params['actor'], jctrl._env_states, jctrl._obs, jctrl.buffer, key,
                jnp.asarray(random_phase))
            draws = uniforms if random_phase else normals
        else:
            (jctrl._env_states, jctrl._obs, jctrl.buffer, jctrl._ou_state,
             jrew) = jctrl._collect_jit(jctrl.agent.params['actor'], jctrl._env_states,
                                        jctrl._obs, jctrl.buffer, jctrl._ou_state, key,
                                        jnp.asarray(random_phase), jnp.float32(std))
            tctrl.noise_std = std
            draws = [(torch.tensor(u), torch.tensor(w)) for u, w in zip(uniforms, normals)]
        if algo == 'sac':
            draws = [torch.tensor(d) for d in draws]
        trew = tctrl.collect(random_phase, draws=draws)
        _close(trew, jrew, 1e-5, 'mean reward')
    assert ends['terminated'] > 0 and ends['truncated'] > 0, ends
    rows = 2 * steps * 4
    jring, tring = _ring(jctrl.buffer, rows), _ring(tctrl.buffer, rows)
    for k in ('obs', 'act', 'rew', 'next_obs'):
        _close(tring[k], jring[k], 1e-4, k)
    np.testing.assert_array_equal(tring['mask'], jring['mask'])
    assert int(tctrl.buffer.count) == int(jctrl.buffer.count) == rows
    _close(tctrl._env_states.state, jctrl._env_states.state, 1e-4, 'state')
    if algo == 'ddpg':
        _close(tctrl._ou_state, jctrl._ou_state, 1e-5, 'ou state')

    # A JAX checkpoint, one update into its training, into a fresh controller.
    batch = {k: jnp.asarray(v[:32]) for k, v in jring.items()}
    ts, _ = jax.jit(jctrl.agent.make_update_step())(jctrl.agent.train_state(), batch,
                                                    jax.random.PRNGKey(0))
    jctrl.agent.set_train_state(ts)
    jctrl.total_steps = rows
    path = str(tmp_path / 'jax.pt')
    jctrl.save(path, save_buffer=True)
    fresh = _port_ctrl(algo, tmp_path / 'f', seed=9)
    fresh.load(path)
    assert fresh.total_steps == rows
    _assert_agent(fresh.agent, jctrl.agent, 0)
    obs = np.random.default_rng(1).normal(0, 0.3, (16, 4)).astype(np.float32)
    _close(fresh.select_action(obs), jctrl.select_action(jnp.asarray(obs)), 1e-6, 'actions')
    for k, v in _ring(fresh.buffer, rows).items():
        _close(v, jring[k], 0, k)
    assert int(fresh.buffer.ptr) == int(jctrl.buffer.ptr)
    _close(fresh._env_states.state, jctrl._env_states.state, 0, 'state')
    _close(fresh._obs, jctrl._obs, 0, 'obs')
    # The JAX PRNG key re-seeds the generator from the controller's seed.
    assert torch.equal(fresh.gen.get_state(), torch.Generator().manual_seed(9).get_state())
    jctrl.close()
    tctrl.close()
    fresh.close()


@pytest.mark.parametrize('algo', ['sac', 'ddpg'])
def test_resume_matches_uninterrupted(tmp_path, algo):
    """As tests/test_resume.py holds the JAX package: 1200 env steps straight,
    against 600, a checkpoint with the ring, and 600 more in a controller of
    another seed."""
    over = dict(train_interval=100, warm_up_steps=300, checkpoint_path='')
    a = _port_ctrl(algo, tmp_path / 'a', max_env_steps=1200, **over)
    a.reset()
    a.learn()
    b = _port_ctrl(algo, tmp_path / 'b', max_env_steps=600, **over)
    b.reset()
    b.learn()
    ckpt = str(tmp_path / 'ckpt.pt')
    b.save(ckpt, save_buffer=True)
    c = _port_ctrl(algo, tmp_path / 'c', seed=88, max_env_steps=1200, **over)
    c.load(ckpt)
    c.learn()
    assert a.total_steps == c.total_steps == 1200
    for got, want in zip(tree_leaves(c.agent.params), tree_leaves(a.agent.params)):
        _close(got, want, 1e-5)
    obs = np.full(4, 0.06, np.float32)
    _close(c.select_action(obs), a.select_action(obs), 1e-5)
    for x in (a, b, c):
        x.close()


def test_learn_run_save_load_and_bookkeeping(tmp_path):
    """``steps_per_iter`` and the warm-up, ``fused_iterations`` K (K
    iterations a read, ``total_steps`` by K), the intervals, the final
    checkpoint with the ring, ``run`` and a load into a fresh controller."""
    over = dict(train_interval=100, warm_up_steps=200, max_env_steps=900, fused_iterations=3,
                log_interval=192, save_interval=384, checkpoint_path='last.pt')
    ctrl = _port_ctrl('sac', tmp_path, **over)
    assert ctrl.steps_per_iter == 25
    ctrl.reset()
    ctrl.learn()
    # Two warm-up iterations of 100 env steps, then three passes of K = 3
    # iterations, the last one past max_env_steps.
    assert ctrl.total_steps == 1100
    assert set(ctrl.last_results) >= {'mean_reward', 'policy_loss', 'critic_loss', 'step'}
    assert np.isfinite(ctrl.last_results['critic_loss'])
    assert int(ctrl.buffer.count) == 1100
    assert os.path.exists(ctrl.checkpoint_path)
    assert os.listdir(tmp_path / 'checkpoints')
    res = ctrl.run(n_episodes=3)
    assert res['ep_returns'].shape == (3,) and np.all(res['ep_lengths'] >= 1)
    fresh = _port_ctrl('sac', tmp_path / 'f', seed=4)
    fresh.load(ctrl.checkpoint_path)
    assert fresh.total_steps == 1100 and int(fresh.buffer.count) == 1100
    obs = np.float32([0.05, -0.1, 0.02, 0.3])
    _close(fresh.select_action(obs), ctrl.select_action(obs), 1e-6)
    assert torch.equal(fresh.gen.get_state(), ctrl.gen.get_state())
    # Sharded over a world of one rank, a restored run collects and updates
    # as another unsharded one does: the same envs, draws and samples.
    twin = _port_ctrl('sac', tmp_path / 't', seed=4)
    twin.load(ctrl.checkpoint_path)
    with one_rank():
        fresh.shard_over(make_env_mesh())
        _close(fresh.collect(False), twin.collect(False), 1e-6)
        _close(fresh.train_phase(), twin.train_phase(), 1e-6)
    twin.close()
    ctrl.close()
    fresh.close()
