"""The last public names of the JAX package in the port, against the JAX
package on the CPU.

* The public-name sweep: every module of ``safe_control_gym_tpu`` has its
  counterpart in ``safe_control_gym_tpu_torch`` with each of its public
  names (``__all__`` and the functions and classes it defines) and each
  public attribute those classes define, except the names ``LEFT_OUT``
  lists, each with its reason (also in ROADMAP.md).
* ``Environment``; ``BenchmarkEnv.set_reference`` on the 3D quadrotor's
  tracking task (the PID example's custom waypoints): the reward, the
  observation and the goal extension follow the new reference as JAX's do,
  the running episode's state is kept, the reference lives on the env's
  device, and a reference of the wrong width raises JAX's error.
* ``get_symbolic_constraint_models``; the stateful normalizers on numpy
  batches (state dicts both ways, read-only mode); ``cnn_apply`` and
  ``rnn_apply`` with JAX's parameters carried across (masks included,
  1e-5); ``GaussianProcessCollection.make_casadi_predict_func`` and
  ``make_fitc_predict_func`` on one trained collection, fed JAX's kmeans
  draws: against the port's per-GP means and JAX's, 1e-4 of the largest.
"""

import importlib
import inspect
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import safe_control_gym_tpu

# JAX module -> None (the whole module) or the names left out, with the reason.
LEFT_OUT = {
    'safe_control_gym_tpu.utils.native': (None, 'a test-only oracle of C++ dynamics and QP '
                                                'solvers; the port tests import the JAX one'),
    'safe_control_gym_tpu.ops.pallas_kernels': (None, 'the Pallas per-step kernels: the port\'s '
                                                      'are ops/physics_kernels.py (K1-K3)'),
    'safe_control_gym_tpu.envs.env_wrappers.vectorized_env.jax_vec_env': (
        None, 'the vectorized env over vmap: the port\'s is torch_vec_env.TorchVecEnv'),
    'safe_control_gym_tpu.envs.env_wrappers.vectorized_env': (
        {'JaxVecEnv'}, 'its counterpart is TorchVecEnv'),
    'safe_control_gym_tpu.envs.env_wrappers.vectorized_env.vec_env_utils': (
        {'CloudpickleWrapper'}, 'cloudpickle is not on the card\'s machine; SubprocVecEnv '
                                'sends plain-pickled env thunks'),
    'safe_control_gym_tpu.envs.env_wrappers.vectorized_env.subproc_vec_env': (
        {'CloudpickleWrapper'}, 'the same class, defined again there'),
    'safe_control_gym_tpu.ops.rollout_kernels': (
        {'cartpole_rollout_pallas', 'quad2d_rollout_pallas', 'quad3d_rollout_pallas'},
        'the Pallas launchers: the port\'s are cartpole_rollout, quad2d_rollout and '
        'quad3d_rollout (K4, K5)'),
    'safe_control_gym_tpu.experiments.benchmark_suite': (
        {'measure_single_env', 'run', 'REFERENCE_SPEEDUPS'},
        'measurement code of the benchmark PR (ROADMAP Queue 1, item 3)'),
    'safe_control_gym_tpu.utils.utils': (
        {'enable_persistent_compile_cache', 'restore_prng_key'},
        'XLA\'s compile cache and JAX\'s PRNG key formats; the port restores '
        'torch.Generator states directly'),
    'safe_control_gym_tpu.controllers.sac.sac_utils': (
        {'SACAgent.make_update_step'}, 'fused_iterations as one program: ROADMAP item 15'),
    'safe_control_gym_tpu.controllers.ddpg.ddpg_utils': (
        {'DDPGAgent.make_update_step'}, 'fused_iterations as one program: ROADMAP item 15'),
}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module, the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _public_names(mod):
    names = set(getattr(mod, '__all__', ()))
    names |= {k for k, v in vars(mod).items() if not k.startswith('_')
              and (inspect.isfunction(v) or inspect.isclass(v))
              and getattr(v, '__module__', None) == mod.__name__}
    return names


def _missing():
    missing = []
    for info in pkgutil.walk_packages(safe_control_gym_tpu.__path__, 'safe_control_gym_tpu.'):
        left, _ = LEFT_OUT.get(info.name, (set(), ''))
        if left is None:
            continue
        jax_mod = importlib.import_module(info.name)
        try:
            port = importlib.import_module(info.name.replace(
                'safe_control_gym_tpu', 'safe_control_gym_tpu_torch', 1))
        except ModuleNotFoundError:
            missing.append(info.name)
            continue
        for name in sorted(_public_names(jax_mod)):
            if name in left:
                continue
            if not hasattr(port, name):
                missing.append(f'{info.name}.{name}')
                continue
            jv, pv = getattr(jax_mod, name), getattr(port, name)
            if inspect.isclass(jv):
                missing += [f'{info.name}.{name}.{a}' for a in vars(jv)
                            if not a.startswith('_') and f'{name}.{a}' not in left
                            and not hasattr(pv, a)]
    return missing


def test_the_port_has_every_public_name_but_those_left_out():
    """In a process of its own: importing every module of the JAX package
    changes JAX's global config (experiments/benchmark_suite.py switches the
    default PRNG at import), which the JAX tests that this worker runs next
    must not see."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, '-c', 'import json; from tests.test_torch_api_parity import _missing; '
                               'print(json.dumps(_missing()))'],
        cwd=root, env=dict(os.environ, JAX_PLATFORMS='cpu'), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert all(reason for _, reason in LEFT_OUT.values())


def test_environment_enum():
    from safe_control_gym_tpu.envs.benchmark_env import Environment as JEnvironment
    from safe_control_gym_tpu_torch.envs.benchmark_env import Environment
    assert [(m.name, m.value) for m in Environment] == [(m.name, m.value) for m in JEnvironment]
    assert Environment.QUADROTOR == 'quadrotor' and Environment('cartpole') is Environment.CARTPOLE


QUAD3D_TRACK = dict(quad_type=3, seed=0, ctrl_freq=50, pyb_freq=1000, episode_len_sec=2,
                    task='traj_tracking', cost='rl_reward', obs_goal_horizon=2,
                    randomized_init=False, init_state=np.zeros(12),
                    task_info={'trajectory_type': 'circle', 'num_cycles': 1,
                               'trajectory_plane': 'xz', 'trajectory_position_offset': [0, 1],
                               'trajectory_scale': 0.5})


def _custom_reference(n):
    t = np.linspace(0, 4, n)
    x_goal = np.zeros((n, 12))
    x_goal[:, 0], x_goal[:, 2], x_goal[:, 4] = 0.1 * t, 0.05 * t ** 2, 1 + 0.1 * t
    return x_goal


def test_set_reference_matches_jax():
    from safe_control_gym_tpu.utils.registration import make as jmake
    from safe_control_gym_tpu_torch.utils.registration import make
    jenv, env = jmake('quadrotor', **QUAD3D_TRACK), make('quadrotor', device='cpu',
                                                         **QUAD3D_TRACK)
    jenv.reset()
    env.reset()
    action = np.asarray(env.U_GOAL, np.float32) * 1.05
    for _ in range(3):
        jenv.step(action)
        env.step(action)
    x_goal = _custom_reference(np.atleast_2d(env.X_GOAL).shape[0])
    state = env.state.copy()
    jenv.set_reference(x_goal)
    env.set_reference(x_goal)
    np.testing.assert_array_equal(env.state, state)        # the episode goes on
    assert env._x_goal.device == env.device and env._x_goal.shape == x_goal.shape
    np.testing.assert_array_equal(env.X_GOAL, np.asarray(jenv.X_GOAL))
    for _ in range(5):
        jobs, jrew, jdone, jinfo = jenv.step(action)
        obs, rew, done, info = env.step(action)
        np.testing.assert_allclose(obs, np.asarray(jobs), atol=1e-5)
        np.testing.assert_allclose(rew, jrew, rtol=1e-5)
        np.testing.assert_allclose(info['mse'], jinfo['mse'], rtol=1e-5)
        assert done == jdone
    with pytest.raises(ValueError) as jerr:
        jenv.set_reference(np.zeros((10, 6)))
    with pytest.raises(ValueError) as err:
        env.set_reference(np.zeros((10, 6)))
    assert str(err.value) == str(jerr.value)


def test_set_reference_moves_the_stabilization_goal():
    from safe_control_gym_tpu_torch.utils.registration import make
    env = make('cartpole', device='cpu', randomized_init=False, cost='quadratic',
               task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.05})
    env.reset()
    _, _, done, _ = env.step(np.zeros(1))
    assert done       # starts at the goal
    env.reset()
    env.set_reference(np.array([1.0, 0.0, 0.0, 0.0]))
    _, _, done, _ = env.step(np.zeros(1))
    assert not done and not env.goal_reached


def test_symbolic_constraint_models_match_jax():
    from safe_control_gym_tpu.envs.constraints import \
        get_symbolic_constraint_models as jax_models
    from safe_control_gym_tpu.utils.registration import make as jmake
    from safe_control_gym_tpu_torch.envs.constraints import get_symbolic_constraint_models
    from safe_control_gym_tpu_torch.utils.registration import make
    cons = [{'constraint_form': 'default_constraint', 'constrained_variable': 'state'},
            {'constraint_form': 'default_constraint', 'constrained_variable': 'input'},
            {'constraint_form': 'bounded_constraint', 'constrained_variable': 'state',
             'active_dims': [0, 2], 'upper_bounds': [0.5, 0.1], 'lower_bounds': [-0.5, -0.1]}]
    jenv, env = jmake('cartpole', constraints=cons), make('cartpole', device='cpu',
                                                          constraints=cons)
    jfns, fns = jax_models(jenv.constraints), get_symbolic_constraint_models(env.constraints)
    assert len(fns) == len(jfns) == 3
    rng = np.random.default_rng(0)
    for jfn, fn, dim in zip(jfns, fns, (4, 1, 4)):
        v = rng.normal(0, 0.5, dim).astype(np.float32)
        np.testing.assert_allclose(fn(torch.as_tensor(v)[None])[0].numpy(),
                                   np.asarray(jfn(v)), atol=1e-6)


def test_normalizers_match_jax():
    from safe_control_gym_tpu.math import normalization as jn
    from safe_control_gym_tpu_torch.math import normalization as tn
    rng = np.random.default_rng(0)
    batches = [rng.normal(1.0, 2.0, (16, 3)) for _ in range(4)]
    j, t = jn.MeanStdNormalizer(shape=(3,)), tn.MeanStdNormalizer(shape=(3,))
    for b in batches[:3]:
        np.testing.assert_allclose(t(b), j(b), rtol=1e-5, atol=1e-5)
    for key in ('mean', 'var', 'count'):
        np.testing.assert_allclose(t.state_dict()[key], j.state_dict()[key], rtol=1e-6)
    t.set_read_only()
    j.set_read_only()
    before = t.state_dict()
    np.testing.assert_allclose(t(batches[3] * 100), j(batches[3] * 100), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.state_dict()['mean'], before['mean'])
    t.unset_read_only()
    assert not t.read_only
    # State dicts carry across both ways.
    t2, j2 = tn.MeanStdNormalizer(shape=(3,)), jn.MeanStdNormalizer(shape=(3,))
    t2.load_state_dict(j.state_dict())
    j2.load_state_dict(t.state_dict())
    np.testing.assert_allclose(t2(batches[0]), j2(batches[0]), rtol=1e-5, atol=1e-5)

    jr, tr = jn.RewardStdNormalizer(gamma=0.9), tn.RewardStdNormalizer(gamma=0.9)
    for k in range(5):
        rews, dones = rng.normal(0, 1, 4), rng.random(4) < 0.3
        np.testing.assert_allclose(tr(rews, dones), jr(rews, dones), rtol=1e-5, atol=1e-6)
    tr2 = tn.RewardStdNormalizer(gamma=0.9)
    tr2.load_state_dict(jr.state_dict())
    np.testing.assert_allclose(tr2.state_dict()['ret'], jr.state_dict()['ret'])
    np.testing.assert_allclose(tr2.rms.var, np.asarray(jr.rms.var), rtol=1e-6)

    rms_j, rms_t = jn.RunningMeanStd(shape=(3,)), tn.RunningMeanStd(shape=(3,))
    for b in batches:
        rms_j.update(b)
        rms_t.update(b)
    np.testing.assert_allclose(rms_t.mean, rms_j.mean, rtol=1e-6)
    np.testing.assert_allclose(rms_t.var, rms_j.var, rtol=1e-5)

    class Space:
        low, high = np.array([-2.0, 0.0]), np.array([2.0, 1.0])
    act = rng.uniform(-1.5, 1.5, (5, 2))
    np.testing.assert_allclose(tn.ActionUnnormalizer(Space)(act), jn.ActionUnnormalizer(Space)(act))
    img = rng.integers(0, 256, (2, 4, 4, 3))
    np.testing.assert_allclose(tn.ImageNormalizer()(img), jn.ImageNormalizer()(img))
    np.testing.assert_allclose(tn.RescaleNormalizer(3.0)(act), jn.RescaleNormalizer(3.0)(act))
    assert tn.BaseNormalizer()(act) is act and tn.BaseNormalizer().state_dict() == {}
    assert tn.normalize_angle is not None


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and tree and not isinstance(tree[0], (int, float)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, tuple):
        return tree
    return torch.as_tensor(np.asarray(tree))


def test_cnn_and_rnn_match_jax_on_its_parameters():
    import jax
    import jax.numpy as jnp

    from safe_control_gym_tpu.math import networks as jnet
    from safe_control_gym_tpu_torch.math import networks as tnet
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(1)
    jcnn = jnet.cnn_init(key, (36, 36, 3), 5)
    x = rng.random((2, 36, 36, 3)).astype(np.float32)
    want = np.asarray(jnet.cnn_apply(jcnn, jnp.asarray(x)))
    got = tnet.cnn_apply(_to_torch(jcnn), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    jrnn = jnet.rnn_init(key, 4, 8)
    xs = rng.normal(size=(6, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(3, 8)).astype(np.float32)
    masks = (rng.random((6, 3, 1)) > 0.3).astype(np.float32)
    for m in (None, masks):
        want_seq, want_last = jnet.rnn_apply(jrnn, jnp.asarray(xs), jnp.asarray(h0),
                                             None if m is None else jnp.asarray(m))
        seq, last = tnet.rnn_apply(_to_torch(jrnn), torch.as_tensor(xs), torch.as_tensor(h0),
                                   None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), atol=1e-5)
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=1e-5)
    # The port's own init: the layouts and the bounds of JAX's.
    gen = torch.Generator().manual_seed(0)
    cnn = tnet.cnn_init(gen, (36, 36, 3), 5)
    assert [c['w'].shape for c in cnn['convs']] == [tuple(c['w'].shape) for c in jcnn['convs']]
    assert cnn['head'][0]['w'].shape == tuple(jcnn['head'][0]['w'].shape)
    rnn = tnet.rnn_init(gen, 4, 8)
    assert {k: tuple(v.shape) for k, v in rnn.items()} == {k: v.shape for k, v in jrnn.items()}
    assert float(rnn['wi'].abs().max()) <= 1 / np.sqrt(8)


def test_gp_collection_predict_funcs_match_jax(monkeypatch):
    """The stacked means against the port's per-GP means and JAX's stacked
    means, by tests/test_torch_gp_mpc.py's rule for the per-GP ones: 1e-4 of
    the largest mean. The float32 sums over the 40 points part by some 1e-5
    between the stacked and the per-GP forms (the alphas reach tens), and
    the port's factors of JAX's parameters by as much from JAX's."""
    from safe_control_gym_tpu.controllers.mpc import gp_utils as jgp
    from safe_control_gym_tpu_torch.controllers.mpc import gp_utils as tgp
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    Y = np.stack([np.sin(3 * X[:, 0]) + np.cos(3 * X[:, 1]) + 2 * X[:, 2] ** 2,
                  np.cos(3 * X[:, 2]) * X[:, 0] + np.sin(3 * X[:, 1])], 1).astype(np.float32)
    jcol = jgp.GaussianProcessCollection(target_dim=2)
    jcol.train(X, Y, n_train=100, learning_rate=0.05)
    col = tgp.GaussianProcessCollection(target_dim=2)
    col.load_state_dict(jcol.state_dict())
    zs = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    jfn, jz = jcol.make_fitc_predict_func(4, rand_state=0)
    # The port draws its first centroids from numpy: feed it JAX's draws.
    monkeypatch.setattr(tgp, 'kmeans_centriods', lambda n, data, rand_state=0: np.asarray(jz))
    fitc, z_ind = col.make_fitc_predict_func(4, rand_state=0)
    np.testing.assert_array_equal(z_ind, np.asarray(jz))
    exact = col.make_casadi_predict_func()
    for fn, jax_fn, per_gp in ((exact, jcol.make_casadi_predict_func(),
                                [gp.make_casadi_prediction_func() for gp in col.gps]),
                               (fitc, jfn, [gp.make_fitc_prediction_func(z_ind)
                                            for gp in col.gps])):
        got = np.stack([fn(torch.as_tensor(z)).numpy() for z in zs])
        own = np.array([[float(f(torch.as_tensor(z))) for f in per_gp] for z in zs])
        want = np.stack([np.asarray(jax_fn(z)) for z in zs])
        tol = 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got, own, rtol=0, atol=tol)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
