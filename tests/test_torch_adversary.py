"""The env's adversary channel, RARL and RAP of the port against the JAX package, on the CPU.

The channel in both modes ('action', 'dynamics') on the cartpole and the 2D
and 3D quads: the port's batched step against JAX's on the same states and
``adv_action`` (states and rewards 1e-4), the shim's
``set_adversary_control``, the converter with the adversary fields set and
the auto-reset clearing them. RARL's rollout batches and RAP's per-env member
gather against JAX's ``_rollout_jit`` and ``_pop_rollout_jit`` on the normals
JAX drew and deterministic resets (1e-4); ``split_obs_by_adversary`` exact;
RARL's resume equal to the uninterrupted run (1e-5, as tests/test_resume.py);
RAP's learn -> save -> load."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.controllers.rarl.rarl_utils import \
    split_obs_by_adversary as jsplit
from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.controllers.rarl.rarl_utils import split_obs_by_adversary
from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy, env_state_to_numpy
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


SYSTEMS = {'cartpole': ('cartpole', {}),
           'quadrotor_2D': ('quadrotor', dict(quad_type=2)),
           'quadrotor_3D': ('quadrotor', dict(quad_type=3,
                                              task_info={'stabilization_goal': [0, 0, 1]}))}
# tests/test_rarl_behavior.py's cartpole with deterministic resets and 1 s
# episodes, so that a rollout of 32 steps crosses time limits and resets.
RARL_TASK = dict(seed=3, cost='rl_reward', normalized_rl_action_space=True, randomized_init=False,
                 init_state={'init_theta': 0.05}, episode_len_sec=1, ctrl_freq=15, pyb_freq=750,
                 adversary_disturbance='dynamics', adversary_disturbance_scale=2.0)
RARL_ALGO = dict(rollout_batch_size=4, rollout_steps=32, agent_iterations=1,
                 adversary_iterations=1, opt_epochs=2, mini_batch_size=32, use_gae=True)


def _state_dict(est):
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def _close(got, want, atol, msg=''):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize('mode', ['action', 'dynamics'])
@pytest.mark.parametrize('system', sorted(SYSTEMS))
def test_adversary_step_matches_jax(system, mode):
    env_id, kw = SYSTEMS[system]
    cfg = dict(seed=0, normalized_rl_action_space=True, adversary_disturbance=mode,
               adversary_disturbance_scale=0.5, **kw)
    je, te = jmake(env_id, **cfg), tmake(env_id, device='cpu', **cfg)
    assert te.adv_action_dim == je.adv_action_dim
    np.testing.assert_array_equal(te.adversary_action_space.low, je.adversary_action_space.low)
    n = 8
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(0), n)
    rng = np.random.default_rng(1)
    adv = rng.uniform(-0.5, 0.5, (n, je.adv_action_dim)).astype(np.float32)
    valid = np.arange(n) % 2 == 0
    jst = jst.replace(adv_action=jnp.asarray(adv), adv_valid=jnp.asarray(valid))
    tst = env_state_from_numpy(_state_dict(jst), 'cpu')
    np.testing.assert_array_equal(tst.adv_valid.numpy(), valid)
    act = rng.uniform(-1, 1, (n, je.action_dim)).astype(np.float32)
    jnext, jout = jax.vmap(je.func.step)(jst, jnp.asarray(act))
    tnext, tout = te.func.step(tst, torch.tensor(act))
    for name in ('state', 'obs', 'reward', 'noisy_action', 'clipped_action'):
        _close(getattr(tout, name), getattr(jout, name), 1e-4, name)
    assert not tnext.adv_valid.any() and not np.asarray(jnext.adv_valid).any()
    # The adversary moved the envs it acted on, and only those.
    _, plain = te.func.step(tst.replace(adv_valid=torch.zeros(n, dtype=torch.bool)),
                            torch.tensor(act))
    moved = (tout.state - plain.state).abs().amax(dim=1) > 0
    np.testing.assert_array_equal(moved.numpy(), valid)


def test_shim_and_autoreset_carry_the_channel():
    cfg = dict(seed=0, normalized_rl_action_space=True, randomized_init=False,
               init_state={'init_theta': 0.05}, adversary_disturbance='dynamics',
               adversary_disturbance_scale=2.0, adversary_disturbance_offset=0.1)
    je, te = jmake('cartpole', **cfg), tmake('cartpole', device='cpu', **cfg)
    je.reset()
    te.reset()
    for t, adv in enumerate([[0.3, -0.4], None, [2.0, 0.5], None]):
        if adv is not None:
            je.set_adversary_control(np.asarray(adv, np.float32))
            te.set_adversary_control(np.asarray(adv, np.float32))
        jobs, jrew, _, _ = je.step(np.float32([0.2]))
        tobs, trew, _, _ = te.step(np.float32([0.2]))
        _close(tobs, jobs, 1e-5, f'obs {t}')
        assert trew == pytest.approx(jrew, abs=1e-5)
    plain = tmake('cartpole', device='cpu', **dict(cfg, adversary_disturbance=None))
    plain.reset()
    assert plain.adversary_action_space is None and plain.adv_action_dim == 4
    plain.set_adversary_control(np.float32([1.0, 1.0]))   # no channel: a no-op
    assert plain.adv_action is None
    # step_autoreset gives done envs a fresh, empty adversary buffer.
    gen = torch.Generator().manual_seed(0)
    est, _ = te.func.reset_batch(gen, 4)
    est = est.replace(ctrl_step=torch.tensor([0, te.CTRL_STEPS - 1, 0, 0], dtype=torch.int32),
                      adv_action=torch.ones((4, 2)),
                      adv_valid=torch.ones(4, dtype=torch.bool))
    est, out, _ = te.func.step_autoreset(est, torch.zeros((4, 1)), gen)
    np.testing.assert_array_equal(out.truncated.numpy(), [False, True, False, False])
    np.testing.assert_array_equal(est.adv_action[:, 0].numpy(), [1, 0, 1, 1])
    assert not est.adv_valid.any()
    back = env_state_from_numpy(env_state_to_numpy(est), 'cpu')
    _close(back.adv_action, est.adv_action, 0)


def _rarl_pair(algo, tmp, **over):
    cfg = {**jget(algo), **RARL_ALGO, **over}
    jctrl = jmake(algo, functools.partial(jmake, 'cartpole', **RARL_TASK), training=True,
                  output_dir=str(tmp / 'j'), seed=1, **cfg)
    tctrl = tmake(algo, functools.partial(tmake, 'cartpole', device='cpu', **RARL_TASK),
                  training=True, output_dir=str(tmp / 't'), seed=1, **{**RARL_ALGO, **over})
    jctrl.reset()
    tctrl._env_states = env_state_from_numpy(_state_dict(jctrl._env_states), 'cpu')
    tctrl._obs = torch.tensor(np.asarray(jctrl._obs))
    tctrl.agent.load_state_dict(jax.tree.map(np.asarray, {
        'params': jctrl.agent.params, 'actor_opt_state': jctrl.agent.actor_opt_state,
        'critic_opt_state': jctrl.agent.critic_opt_state}))
    members = jctrl.adversaries if algo == 'rap' else [jctrl.adversary]
    tmembers = tctrl.adversaries if algo == 'rap' else [tctrl.adversary]
    for j, t in zip(members, tmembers):
        t.load_state_dict(jax.tree.map(np.asarray, {
            'params': j.params, 'actor_opt_state': j.actor_opt_state,
            'critic_opt_state': j.critic_opt_state}))
    return jctrl, tctrl


def _assert_batch(tb, jb, msg):
    for k in ('obs', 'act', 'logp', 'adv', 'ret', 'v'):
        _close(tb[k], np.asarray(jb[k]).reshape(tb[k].shape), 1e-4, f'{msg} {k}')


def test_rarl_rollout_matches_jax(tmp_path):
    jctrl, tctrl = _rarl_pair('rarl', tmp_path)
    T, N = 32, 4
    key = jax.random.PRNGKey(7)
    p_noise, a_noise, k = [], [], key
    for _ in range(T):
        k, k_p, k_a, _ = jax.random.split(k, 4)
        p_noise.append(np.asarray(jax.random.normal(k_p, (N, 1))))
        a_noise.append(np.asarray(jax.random.normal(k_a, (N, 2))))
    est, obs, _, jp, ja, jrew = jctrl._rollout_jit(
        jctrl.agent.params, jctrl.adversary.params, jctrl._env_states, jctrl._obs, key,
        jnp.asarray(True))
    dones = []
    step_autoreset = tctrl.func_env.step_autoreset

    def recording(est, act, gen):
        # The adversary's force rides on every env state, valid this step.
        assert est.adv_valid.all() and est.adv_action.abs().max() > 0
        est, out, obs = step_autoreset(est, act, gen)
        dones.append(int(out.done.sum()))
        return est, out, obs

    tctrl.func_env.step_autoreset = recording
    tp, ta, trew = tctrl.rollout(True, torch.tensor(np.stack(p_noise)),
                                 torch.tensor(np.stack(a_noise)))
    assert sum(dones) >= N, dones
    _assert_batch(tp, jp, 'protagonist')
    _assert_batch(ta, ja, 'adversary')
    _close(trew, jrew, 1e-5, 'mean reward')
    _close(tctrl._env_states.state, est.state, 1e-4, 'state')
    _close(tctrl._obs, obs, 1e-4, 'obs')
    jctrl.close()
    tctrl.close()


def test_rap_rollout_gathers_each_envs_member_as_jax(tmp_path):
    jctrl, tctrl = _rarl_pair('rap', tmp_path, num_adversaries=2)
    T, N = 32, 4
    assign = np.array([1, 0, 0, 1], np.int32)
    key = jax.random.PRNGKey(9)
    p_noise, a_noise, k = [], [], key
    for _ in range(T):
        k, k_p, k_a, _ = jax.random.split(k, 4)
        p_noise.append(np.asarray(jax.random.normal(k_p, (N, 1))))
        a_noise.append(np.stack([np.asarray(jax.random.normal(ka, (2,)))
                                 for ka in jax.random.split(k_a, N)]))
    est, obs, _, jp, ja, jrew = jctrl._pop_rollout_jit(
        jctrl.agent.params, jctrl._stacked_adv_params(), jnp.asarray(assign),
        jctrl._env_states, jctrl._obs, key)
    tp, ta, trew = tctrl.rollout(True, torch.tensor(np.stack(p_noise)),
                                 torch.tensor(np.stack(a_noise)), assign=assign)
    _assert_batch(tp, jp, 'protagonist')
    _assert_batch(ta, ja, 'population')
    _close(trew, jrew, 1e-5, 'mean reward')
    _close(tctrl._env_states.state, est.state, 1e-4, 'state')
    # Balanced assignments, and the update's per-member columns.
    a = tctrl.sample_assignment()
    assert sorted(a.tolist()) == [0, 0, 1, 1]
    obs_np = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    groups = np.array([2, 0, 1, 2, 0, 1])
    for got, want in zip(split_obs_by_adversary(torch.tensor(obs_np), groups, 3),
                         jsplit(obs_np, groups, 3)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(split_obs_by_adversary(obs_np, groups, 3), jsplit(obs_np, groups, 3)):
        np.testing.assert_array_equal(got, want)
    jctrl.close()
    tctrl.close()


def _port_rarl(algo, tmp, seed=1, **over):
    task = dict(RARL_TASK, randomized_init=True, episode_len_sec=3,
                adversary_disturbance_scale=1.0)
    return tmake(algo, functools.partial(tmake, 'cartpole', device='cpu', **task), training=True,
                 output_dir=str(tmp), seed=seed,
                 **{**RARL_ALGO, 'rollout_steps': 16, 'use_gae': False, 'checkpoint_path': '',
                    **over})


def test_rarl_resume_matches_uninterrupted(tmp_path):
    """As tests/test_resume.py holds the JAX package: 512 env steps straight,
    against 256, a checkpoint, and 256 more in a controller of another seed."""
    a = _port_rarl('rarl', tmp_path / 'a', max_env_steps=512)
    a.reset()
    a.learn()
    b = _port_rarl('rarl', tmp_path / 'b', max_env_steps=256)
    b.reset()
    b.learn()
    ckpt = str(tmp_path / 'ckpt.pt')
    b.save(ckpt)
    c = _port_rarl('rarl', tmp_path / 'c', seed=77, max_env_steps=512)
    c.load(ckpt)
    c.learn()
    assert a.total_steps == c.total_steps == 512
    obs = np.full(4, 0.07, np.float32)
    _close(c.select_action(obs), a.select_action(obs), 1e-5)
    _close(c.adversary.act(torch.tensor(obs)), a.adversary.act(torch.tensor(obs)), 1e-5)
    for x in (a, b, c):
        x.close()


def test_rap_learn_save_load_and_fused_cycles(tmp_path):
    ctrl = _port_rarl('rap', tmp_path, max_env_steps=384, num_adversaries=2,
                      checkpoint_path='rap.pt', fused_iterations=2)
    assert len(ctrl.adversaries) == 2
    ctrl.reset()
    ctrl.learn()
    # Cycles of 2 x 64 env steps, K = 2 a read: 256, then the tail's single cycle.
    assert ctrl.total_steps == 384
    assert np.isfinite(ctrl.last_results['mean_reward'])
    assert ctrl.run(n_episodes=1)['ep_returns'].shape == (1,)
    fresh = _port_rarl('rap', tmp_path / 'f', seed=5, num_adversaries=2)
    fresh.load(ctrl.checkpoint_path)
    obs = torch.full((4,), 0.07)
    _close(fresh.select_action(obs), ctrl.select_action(obs), 1e-6)
    for got, want in zip(fresh.adversaries, ctrl.adversaries):
        for g, w in zip(tree_leaves(got.params), tree_leaves(want.params)):
            _close(g, w, 0)
    # Sharded over a world of one rank, a restored run rolls out as another
    # unsharded one does (the same generator, envs and members).
    twin = _port_rarl('rap', tmp_path / 't', seed=5, num_adversaries=2)
    twin.load(ctrl.checkpoint_path)
    with one_rank():
        fresh.shard_over(make_env_mesh())
        got, want = fresh.rollout(), twin.rollout()
    twin.close()
    for g, w in zip(got[:2], want[:2]):
        for k in w:
            _close(g[k], w[k], 1e-6)
    _close(got[2], want[2], 1e-6)
    with pytest.raises(ValueError, match='adversary_disturbance'):
        tmake('rarl', functools.partial(tmake, 'cartpole', device='cpu'))
    ctrl.close()
    fresh.close()
