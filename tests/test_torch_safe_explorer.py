"""The port's SafeExplorerPPO against the JAX package's, on the CPU.

``SafetyLayer``'s losses, Adam steps and closed-form projection against
JAX's on the same parameters and batches (1e-5), with a tie between two
constraints' multipliers that the first index must take; the pretraining
collect against ``_pretrain_collect_jit`` on JAX's uniforms and deterministic
resets (1e-4), the constraint values after an auto-reset being the fresh
state's; the committed cartpole and 2D quad artifacts' actions on 64
observations against JAX's (1e-5) and the cartpole one's ``BaseExperiment``
evaluation at the bar of tests/test_safe_explorer_behavior.py (met with NaN
actions, as in JAX: the file's PPO parameters are NaN); the resume equal to
the uninterrupted run (1e-5, as tests/test_resume.py); a short learn with
pretraining."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.controllers.safe_explorer.safe_explorer_utils import \
    SafetyLayer as JSafetyLayer
from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.controllers.safe_explorer.safe_explorer_utils import SafetyLayer
from safe_control_gym_tpu_torch.envs.spaces import Box
from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, 'examples', 'rl', 'models', 'safe_explorer_ppo',
                     'safe_explorer_ppo_model_cartpole_stab.pt')
BOX = [{'constraint_form': 'abs_bound', 'constrained_variable': 'state',
        'bound': [1.5, 2.0, 0.3, 2.0]}]
# tests/test_resume.py's SafeExplorerPPO cartpole.
TASK = dict(seed=7, cost='rl_reward', normalized_rl_action_space=True, randomized_init=True,
            episode_len_sec=3, ctrl_freq=15, pyb_freq=750, constraints=BOX,
            done_on_violation=False, done_on_out_of_bound=False)


def _close(got, want, atol, msg=''):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=msg)


def _state_dict(est):
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def test_safety_layer_matches_jax():
    obs_space = Box(low=-np.ones(4), high=np.ones(4))
    act_space = Box(low=-np.ones(2), high=np.ones(2))
    slack = [0.05, 0.05, 0.1]
    jl = JSafetyLayer(obs_space, act_space, hidden_dim=10, num_constraints=3, lr=0.01,
                      slack=slack, seed=2)
    tl = SafetyLayer(obs_space, act_space, hidden_dim=10, num_constraints=3, lr=0.01,
                     slack=slack, device='cpu')
    tl.load_state_dict(jax.tree.map(np.asarray, jl.state_dict()))
    rng = np.random.default_rng(0)
    for i in range(4):
        batch = {'obs': rng.normal(0, 1, (64, 4)), 'act': rng.uniform(-1, 1, (64, 2)),
                 'c': rng.normal(0, 0.5, (64, 3)), 'c_next': rng.normal(0, 0.5, (64, 3))}
        batch = {k: v.astype(np.float32) for k, v in batch.items()}
        want = jl.update({k: jnp.asarray(v) for k, v in batch.items()})
        got = tl.update({k: torch.tensor(v) for k, v in batch.items()})
        _close(got, [want[f'constraint_{j}_loss'] for j in range(3)], 1e-5, f'losses {i}')
    _close(tl.compute_loss({k: torch.tensor(v) for k, v in batch.items()}),
           jl.compute_loss({k: jnp.asarray(v) for k, v in batch.items()}), 1e-5, 'loss')
    for got, want in zip(tree_leaves(tl.params), jax.tree.leaves(jl.params)):
        _close(got, want, 1e-5, 'params')
    adam = jl.opt_state[0]
    assert int(tl.opt_state['count']) == int(adam.count) == 4
    for got, want in zip(tl.opt_state['mu'], jax.tree.leaves(adam.mu)):
        _close(got, want, 1e-5, 'mu')
    # Constraint 1 becomes constraint 0 with its output layer negated: g_1 =
    # -g_0 exactly, so at a zero action with equal values their multipliers tie.
    p = jax.tree.map(np.array, jl.params)
    for k in ('w', 'b'):
        p[-1][k][1] = -p[-1][k][0]
    p[0]['w'][1], p[0]['b'][1] = p[0]['w'][0], p[0]['b'][0]
    jl.params = jax.tree.map(jnp.asarray, p)
    tl.load_state_dict(jax.tree.map(np.asarray, jl.state_dict()))
    obs = rng.normal(0, 1, (32, 4)).astype(np.float32)
    act = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    c = rng.normal(-0.1, 0.1, (32, 3)).astype(np.float32)
    act[:8] = 0.0
    c[:8, 0] = c[:8, 1] = np.abs(c[:8, 0]) + 0.01   # ties, both multipliers positive
    c[:8, 2] = -5.0
    got = tl.get_safe_action(obs, act, c).numpy()
    want = np.asarray(jl.get_safe_action(obs, act, c))
    assert 0 < np.abs(got - act).max() < 10 and (np.abs(got - act).max(axis=1) == 0).any()
    _close(got, want, 1e-5, 'projection')
    g0 = np.asarray(jl._g_all(jl.params, jnp.asarray(obs[:8])))[0]
    assert np.all(np.sign(got[:8]) == -np.sign(g0)), 'a tie must take constraint 0'
    _close(tl.get_safe_action(obs[0], act[0], c[0])[0], want[0], 1e-5, 'single row')


def test_pretrain_collect_matches_jax(tmp_path):
    task = dict(TASK, randomized_init=False, init_state={'init_theta': 0.05}, episode_len_sec=1)
    cfg = dict(rollout_batch_size=4, rollout_steps=16, pretraining=False, checkpoint_path='')
    jctrl = jmake('safe_explorer_ppo', functools.partial(jmake, 'cartpole', **task),
                  output_dir=str(tmp_path / 'j'), seed=0, **{**jget('safe_explorer_ppo'), **cfg})
    tctrl = tmake('safe_explorer_ppo', functools.partial(tmake, 'cartpole', device='cpu', **task),
                  output_dir=str(tmp_path / 't'), seed=0, **cfg)
    jctrl.reset()
    tctrl._env_states = env_state_from_numpy(_state_dict(jctrl._env_states), 'cpu')
    tctrl._obs = torch.tensor(np.asarray(jctrl._obs))
    tctrl._c = torch.tensor(np.asarray(jctrl._c))
    n, key = 40, jax.random.PRNGKey(3)
    uniforms, k = [], key
    for _ in range(n):
        k, k_act, _ = jax.random.split(k, 3)
        uniforms.append(np.asarray(jax.random.uniform(k_act, (4, 1))))
    est, obs, c, ys = jctrl._pretrain_collect_jit(jctrl._env_states, jctrl._obs, jctrl._c, key,
                                                  n_steps=n)
    got = tctrl.pretrain_collect(n, uniforms=np.stack(uniforms))
    for name, want in zip(('obs', 'act', 'c', 'c_next'), ys):
        _close(got[name], np.asarray(want).reshape(got[name].shape), 1e-4, name)
    _close(tctrl._c, c, 1e-4, 'c')
    _close(tctrl._env_states.state, est.state, 1e-4, 'state')
    # 15-step episodes: the envs reset twice, and c after a reset is the fresh
    # state's under a zero action, not the terminal one's.
    assert not np.allclose(got['c'][4 * 15:4 * 16].numpy(), got['c_next'][4 * 14:4 * 15].numpy())
    jctrl.close()
    tctrl.close()


@pytest.mark.parametrize('system', ['cartpole', 'quadrotor_2D'])
def test_committed_artifact_acts_as_jax(system, tmp_path):
    """The committed stab models' projected actions, port against JAX. The
    cartpole model's PPO parameters are NaN in the committed file, so its
    actions are NaN in both packages; the 2D quad's are finite."""
    env_id, task, algo = eval_config('safe_explorer_ppo', system)
    model = MODEL.replace('cartpole', system)
    jctrl = jmake('safe_explorer_ppo', functools.partial(jmake, env_id, **task), training=False,
                  output_dir=str(tmp_path / 'j'), **{**jget('safe_explorer_ppo'), **algo})
    jctrl.load(model)
    ctrl = tmake('safe_explorer_ppo', functools.partial(tmake, env_id, device='cpu', **task),
                 training=False, output_dir=str(tmp_path / 't'), **algo)
    ctrl.load(model)
    rng = np.random.default_rng(4)
    obs = rng.normal(0, 0.5, (64, ctrl.env.obs_dim)).astype(np.float32)
    cons = rng.normal(-0.5, 0.5, (64, ctrl.num_constraints)).astype(np.float32)
    got = np.stack([ctrl.select_action(o, {'constraint_values': c}) for o, c in zip(obs, cons)])
    want = np.stack([np.asarray(jctrl.select_action(o, {'constraint_values': c}))
                     for o, c in zip(obs, cons)])
    assert np.isfinite(got).all() == (system != 'cartpole')
    _close(got, want, 1e-5, 'actions')
    jctrl.close()
    ctrl.close()


def test_committed_cartpole_artifact_holds_its_episode(tmp_path):
    """tests/test_safe_explorer_behavior.py's bar, met as the JAX package
    meets it: the NaN actions leave the state NaN, which neither violates a
    constraint nor leaves the bounds, so the episode runs to its limit."""
    env_id, task, algo = eval_config('safe_explorer_ppo', 'cartpole')
    env_func = functools.partial(tmake, env_id, device='cpu', **task)
    ctrl = tmake('safe_explorer_ppo', env_func, training=False, output_dir=str(tmp_path),
                 **algo)
    ctrl.load(MODEL)
    exp = BaseExperiment(env=env_func(), ctrl=ctrl)
    data, metrics = exp.run_evaluation(n_episodes=1, verbose=False)
    exp.close()
    assert metrics['average_length'] >= 240, metrics
    assert metrics['average_constraint_violation'] == 0, metrics
    assert np.isnan(np.asarray(data['action'][0], np.float32)).all()
    ctrl.close()


def _port_se(tmp, seed=0, **over):
    cfg = dict(rollout_batch_size=4, rollout_steps=16, opt_epochs=2, mini_batch_size=32,
               pretraining=False, log_interval=0, checkpoint_path='')
    return tmake('safe_explorer_ppo', functools.partial(tmake, 'cartpole', device='cpu', **TASK),
                 training=True, output_dir=str(tmp), seed=seed, **{**cfg, **over})


def test_resume_matches_uninterrupted(tmp_path):
    a = _port_se(tmp_path / 'a', max_env_steps=512)
    a.reset()
    a.learn()
    b = _port_se(tmp_path / 'b', max_env_steps=256)
    b.reset()
    b.learn()
    ckpt = str(tmp_path / 'ckpt.pt')
    b.save(ckpt)
    c = _port_se(tmp_path / 'c', seed=55, max_env_steps=512)
    c.load(ckpt)
    c.learn()
    assert a.total_steps == c.total_steps == 512
    obs, info = np.full(4, 0.04, np.float32), {'constraint_values': np.zeros(a.num_constraints)}
    _close(c.select_action(obs, info), a.select_action(obs, info), 1e-5)
    for x in (a, b, c):
        x.close()


def test_learn_with_pretraining_saves_and_loads(tmp_path):
    ctrl = _port_se(tmp_path, max_env_steps=128, pretraining=True, constraint_epochs=2,
                    constraint_steps_per_epoch=400, constraint_batch_size=64,
                    constraint_lr=0.01, checkpoint_path='se.pt')
    ctrl.reset()
    before = [t.clone() for t in tree_leaves(ctrl.safety_layer.params)]
    ctrl.learn()
    assert ctrl.total_steps == 128
    assert int(ctrl.constraint_buffer.state.count) == 2 * 400
    assert any((a - b).abs().max() > 0 for a, b in zip(tree_leaves(ctrl.safety_layer.params),
                                                        before))
    assert all(np.isfinite(v) for v in ctrl.last_results.values())
    fresh = _port_se(tmp_path / 'f', seed=3)
    fresh.load(ctrl.checkpoint_path)
    for g, w in zip(tree_leaves(fresh.safety_layer.params), tree_leaves(ctrl.safety_layer.params)):
        _close(g, w, 0)
    other = _port_se(tmp_path / 'o', seed=4)
    other.load_safety_layer(ctrl.checkpoint_path)
    for g, w in zip(tree_leaves(other.safety_layer.params), tree_leaves(ctrl.safety_layer.params)):
        _close(g, w, 0)
    assert ctrl.run(n_episodes=1)['ep_returns'].shape == (1,)
    for x in (ctrl, fresh, other):
        x.close()
