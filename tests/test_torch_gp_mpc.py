"""The port's GP-MPC (``safe_control_gym_tpu_torch/controllers/mpc/{gp_utils,
gp_mpc}.py``) and ``MPC.select_action_scenarios`` against the JAX package's
on the CPU, from the same seeded numpy inputs.

Configs: tests/test_gp_mpc_fused.py's constrained cartpole (10 Hz over 50
substeps, input and state boxes, horizon 10, pole length prior 1.0) and
tests/test_gp_mpc.py's 2D quad (30 Hz over 8 substeps, mass prior 0.035,
horizon 10), 60 samples and 120 Adam steps each. One controller a package
and system is trained in a module fixture, both on JAX's own bootstrap data
(``train_gp(input_data=..., target_data=...)``): the cartpole's random
actions come from gymnasium's action space in JAX and from a numpy generator
in the port, so only the quad's data is drawn alike (and is checked equal).
The cartpole pair is trained padded for online learning (ONLINE_BUFFER
slots), with its online updates off except in
test_online_learning_matches_jax, which reuses JAX's compiled solve.
The scenarios are examples/mpc/scenario_mpc_demo.py's problem.

Tolerances, and why:
* Kernels 1e-6 relative; the NLL 1e-6 relative and its gradient 1e-5 of its
  largest entry: float32, sums in another order.
* Trained log-parameters 2e-6 and posteriors (means, variances) 1e-5: 120
  Adam steps from the same start in float32 agree to a few ulps here (the
  loss is smooth; no chaos as in the RPI descent).
* FITC at JAX's inducing points: the mean 1e-4 of its largest value (the
  clipped eigendecompositions of LAPACK in both packages; no mode sits at the
  1e-5 sv cut on these data).
* k-means: Lloyd's steps from JAX's own first centroids to 1e-5. The first
  centroids differ by design (a numpy draw, not ``jax.random.choice``).
* ``lhs_sample`` and the quad's bootstrap states and inputs: equal (numpy on
  both sides); its next states to 1e-5 (one K2-plain step against JAX's
  XLA step in float32: up to 4.1e-6 apart at values near 2).
* The tightening: host and fused to 1e-5 of the largest, and to JAX's to
  1e-5; counts of capped rows equal.
* Solves and loops: actions within 1e-4, or, where JAX's own action moves by
  more under 1e-7 relative changes of its input, within 1e-4 of one of those
  answers (tests/test_torch_safety_filters.py's rule). Two causes could
  call for it: the polish's candidate is picked by rounding
  (tests/test_torch_mpc.py), and the batch's cold SQP (two iterations a
  pass) leaves some problems unconverged, their plans' defects under the GP
  dynamics up to 1.2 in both packages. On these data every action is within
  1e-4 of JAX's.
  Loops compare step by step: before each step the port takes JAX's
  observation and warm start.
* ``select_action_batch``: flags and capped-row counts equal; actions as the
  solves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.controllers.mpc import gp_utils as jgp
from safe_control_gym_tpu.controllers.mpc.mpc import MPC as JMPC
from safe_control_gym_tpu.envs.dynamics import CartPoleParams as JParams
from safe_control_gym_tpu.envs.dynamics import cartpole_dynamics as jcartpole
from safe_control_gym_tpu.envs.dynamics import rk4_step as jrk4
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.controllers.mpc import gp_utils as tgp
from safe_control_gym_tpu_torch.controllers.mpc.mpc import MPC as TMPC
from safe_control_gym_tpu_torch.envs.dynamics import CartPoleParams as TParams
from safe_control_gym_tpu_torch.envs.dynamics import cartpole_dynamics as tcartpole
from safe_control_gym_tpu_torch.envs.dynamics import rk4_step as trk4
from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.experiments.control_configs import control_config
from safe_control_gym_tpu_torch.utils.registration import make as tmake

OUT = {'output_dir': 'temp/test_torch_gp_mpc'}
ATOL = 1e-4
STEPS = 8
PERTURBED = 4
ONLINE_BUFFER = 8
CART = dict(seed=42, cost='quadratic', ctrl_freq=10, pyb_freq=500, episode_len_sec=2,
            randomized_init=False, init_state={'init_theta': 0.1},
            task_info={'stabilization_goal': [0.3], 'stabilization_goal_tolerance': 0.02},
            constraints=[{'constraint_form': 'default_constraint',
                          'constrained_variable': 'input'},
                         {'constraint_form': 'default_constraint',
                          'constrained_variable': 'state'}])
CART_ALGO = dict(q_mpc=[1], r_mpc=[0.1], horizon=10,
                 prior_info={'prior_prop': {'pole_length': 1.0}}, num_samples=60,
                 optimization_iterations=120, seed=0)
QUAD = dict(seed=42, cost='quadratic', quad_type=2, ctrl_freq=30, pyb_freq=240,
            episode_len_sec=2, randomized_init=False,
            init_state={'init_x': 0.3, 'init_x_dot': 0, 'init_z': 1.0, 'init_z_dot': 0,
                        'init_theta': 0, 'init_theta_dot': 0},
            task='stabilization',
            task_info={'stabilization_goal': [0, 1], 'stabilization_goal_tolerance': 0.005},
            done_on_out_of_bound=False,
            constraints=[{'constraint_form': 'default_constraint',
                          'constrained_variable': 'input'}])
QUAD_ALGO = dict(q_mpc=[5, 0.1, 5, 0.1, 0.1, 0.1], r_mpc=[0.1, 0.1], horizon=10,
                 prior_info={'prior_prop': {'M': 0.035}}, num_samples=60,
                 optimization_iterations=120, sparse_gp=False, seed=0)
SYSTEMS = {'cartpole': ('cartpole', CART, CART_ALGO), 'quadrotor_2D': ('quadrotor', QUAD,
                                                                         QUAD_ALGO)}
BOOTSTRAP = dict(randomized_init=True, init_state=None, cost='quadratic',
                 normalized_rl_action_space=False)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    # The port's small CPU solves run on one thread: torch's pool contends
    # with JAX's and with the other test workers (under pytest-xdist beside
    # five other workers, torch's default pool made tests/test_torch_gp_mpc.py
    # take 778 s against about 60 s alone). The prior count comes back at the
    # end of the module, so that the files a worker runs next keep theirs.
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _set_warm(ctrl, warm):
    ctrl.x_prev, ctrl.u_prev, ctrl._qp_warm = warm if warm is not None else (None,) * 3


def _warm_of(ctrl):
    return None if ctrl.x_prev is None else (
        ctrl.x_prev.copy(), np.array(ctrl.u_prev), tuple(np.asarray(a) for a in ctrl._qp_warm))


def _perturbed(rng, x):
    return (x * (1 + 1e-7 * rng.standard_normal(np.shape(x)))).astype(np.float32)


def _train(ctrl, system, inputs, targets):
    """``train_gp`` on the data; the cartpole's GPs padded with ONLINE_BUFFER
    online slots (``train_gp`` pads with ``online_learning``), its online
    updates then off."""
    ctrl.online_learning, ctrl.online_buffer = system == 'cartpole', ONLINE_BUFFER
    ctrl.train_gp(input_data=inputs, target_data=targets)
    ctrl.online_learning = False


def _make_pair(system):
    """JAX's and the port's controller trained on JAX's bootstrap data, and
    JAX's closed loop of STEPS steps with its answers to PERTURBED changes of
    each observation."""
    env_id, task, algo = SYSTEMS[system]
    j = jmake('gp_mpc', functools.partial(jmake, env_id, **task), **algo, **OUT)
    t = tmake('gp_mpc', functools.partial(tmake, env_id, device='cpu', **task), **algo, **OUT)
    j.reset()
    t.reset()
    data = j._gather_training_samples(j.env_func(**BOOTSTRAP), algo['num_samples'])
    inputs, targets = j.preprocess_training_data(*data)
    for c in (j, t):
        _train(c, system, inputs, targets)
    env = jmake(env_id, **task)
    obs, info = env.reset()
    rng = np.random.default_rng(1)
    j.setup_results_dict()
    steps = []
    for _ in range(STEPS):
        warm = _warm_of(j)
        perturbed = []
        for _ in range(PERTURBED):
            _set_warm(j, warm)
            perturbed.append(j.select_action(_perturbed(rng, obs), info))
        _set_warm(j, warm)
        action = j.select_action(obs, info)
        steps.append(dict(obs=obs, info=info, warm=warm, action=action, binds=j._last_cap_binds,
                          perturbed=np.array(perturbed), x=j.x_prev.copy()))
        obs, _, _, info = env.step(action)
    env.close()
    return j, t, data, steps


@pytest.fixture(scope='module')
def pairs():
    """``pairs(system)``: the system's trained pair and JAX's loop, made once
    for the module."""
    made = {}

    def get(system):
        if system not in made:
            made[system] = _make_pair(system)
        return made[system]
    yield get
    made.clear()


def _agree(got, want, variants):
    """tests/test_torch_safety_filters.py's rule: within ATOL of JAX's
    answer, or, where JAX's own answer moves by more than ATOL under 1e-7
    changes of its input (``variants``), within ATOL of one of those."""
    variants = np.reshape(variants, (-1,) + np.shape(want))
    spread = float(np.abs(variants - want).max())
    err = float(np.abs(got - want).max())
    nearest = float(np.abs(variants - got).reshape(len(variants), -1).max(axis=1).min())
    return err <= ATOL or (spread > ATOL and nearest <= ATOL), (err, spread, nearest)


# ---------------------------------------------------------------------------
# gp_utils
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('kernel', ['RBF', 'Matern'])
def test_kernels_nll_and_gradient_match_jax(kernel):
    rng = np.random.default_rng(0)
    x1, x2 = rng.normal(size=(7, 5)).astype(np.float32), rng.normal(size=(9, 5)).astype(np.float32)
    ls, sv = rng.uniform(0.5, 2, 5).astype(np.float32), np.float32(1.7)
    k_j = np.asarray(jgp._KERNELS[kernel](x1, x2, ls, sv))
    k_t = tgp.KERNELS[kernel](torch.tensor(x1), torch.tensor(x2), torch.tensor(ls),
                              torch.tensor(sv)).numpy()
    np.testing.assert_allclose(k_t, k_j, rtol=1e-6, atol=0)
    # The zero distance of the Matern's guard, and a stack of two GPs.
    k2 = tgp.KERNELS[kernel](torch.tensor(x1), torch.tensor(x1), torch.tensor(np.stack([ls, ls])),
                             torch.tensor([sv, sv]))
    np.testing.assert_allclose(k2[1].numpy(), np.asarray(jgp._KERNELS[kernel](x1, x1, ls, sv)),
                               rtol=1e-6)
    X, Y = rng.normal(size=(20, 5)).astype(np.float32), rng.normal(size=20).astype(np.float32)
    params = {'log_lengthscales': np.log(ls), 'log_signal_var': np.float32(0.3),
              'log_noise_var': np.float32(-2.0)}
    # Jitted, as JAX's training runs it: one compile, not one per eager op.
    nll = jax.jit(jax.value_and_grad(jgp._nll), static_argnums=3)
    l_j, g_j = nll({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(X),
                   jnp.asarray(Y), jgp._KERNELS[kernel])
    p_t = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    l_t = tgp._nll(p_t, torch.tensor(X), torch.tensor(Y), tgp.KERNELS[kernel])
    l_t.backward()
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-6)
    for k in params:
        g = np.asarray(g_j[k])
        np.testing.assert_allclose(p_t[k].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())


def _regression_data(n=50, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 5)).astype(np.float32)
    Y = np.stack([np.sin(2 * X[:, 0]) + 0.1 * X[:, 4], X[:, 1] * X[:, 2], np.cos(X[:, 3]),
                  0.01 * rng.standard_normal(n)], axis=1).astype(np.float32)
    return X, Y


def test_collection_training_matches_jax_and_sequential(pairs):
    """The port's collection trained vectorized on the quad pair's data
    against JAX's (the pair's, trained by ``train_gp``), the port's
    sequential training against its vectorized one, and the posteriors at
    64 points."""
    j, _, _, _ = pairs('quadrotor_2D')
    X, Y = j.data_inputs, j.data_targets
    xs = np.random.default_rng(1).uniform(X.min(0), X.max(0), (64, X.shape[1]))
    xs = xs.astype(np.float32)
    kw = dict(n_train=QUAD_ALGO['optimization_iterations'], learning_rate=j.learning_rate)
    t = tgp.GaussianProcessCollection(target_dim=Y.shape[1])
    losses = t.train(X, Y, **kw)
    s = tgp.GaussianProcessCollection(target_dim=Y.shape[1])
    np.testing.assert_allclose(s.train(X, Y, vectorized=False, **kw), losses, rtol=1e-5)
    for d, gj in enumerate(j.gaussian_process.gps):
        for k in tgp.PARAM_KEYS:
            np.testing.assert_allclose(_np(t.gps[d].params[k]), _np(gj.params[k]),
                                       rtol=0, atol=2e-6)
            np.testing.assert_allclose(_np(s.gps[d].params[k]), _np(t.gps[d].params[k]),
                                       rtol=0, atol=2e-6)
    for got, want in zip(t.predict(xs), j.gaussian_process.predict(xs)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for got, want in zip(s.predict(xs), t.predict(xs)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_batch_gp_keeps_the_best_test_iterate_as_jax():
    X, Y = _regression_data(40)
    Xt, Yt = _regression_data(20, seed=2)
    j = jgp.BatchGaussianProcess(5, 4, kernel='RBF')
    t = tgp.BatchGaussianProcess(5, 4, kernel='RBF')
    np.testing.assert_allclose(t.train(X, Y, Xt, Yt, n_train=80),
                               j.train(X, Y, Xt, Yt, n_train=80), rtol=1e-5)
    for k in tgp.PARAM_KEYS:
        np.testing.assert_allclose(_np(t.params[k]), _np(j.params[k]), rtol=0, atol=2e-6)
    for got, want in zip(t.predict(Xt), j.predict(Xt)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    z = torch.tensor(Xt[0])
    np.testing.assert_allclose(_np(t.make_batched_predict_func()(z)),
                               np.asarray(j.make_batched_predict_func()(jnp.asarray(Xt[0]))),
                               rtol=0, atol=1e-5)


def test_single_gp_fitc_jacobian_and_online_ring_match_jax(pairs):
    """One GP (the quad pair's for the target of the largest residual, the
    wrong mass's; trained alike in both packages):
    the mean's Jacobian and FITC at JAX's k-means points against JAX's;
    then a copy's padded ring of online slots through more adds than it
    holds: each slot as JAX's ring fills it, and the posterior that of the
    same rows unpadded (the 1e6 point noise hides the empty slots). The
    ring's slots and data against JAX's: test_online_learning_matches_jax."""
    jc, tc, _, _ = pairs('quadrotor_2D')
    d = int(np.argmax(np.abs(jc.data_targets).max(axis=0)))
    j, t0 = jc.gaussian_process.gps[d], tc.gaussian_process.gps[d]
    X = jc.data_inputs
    n, dim = X.shape
    z = X[5] + 0.1
    np.testing.assert_allclose(t0.prediction_jacobian(z), j.prediction_jacobian(z), rtol=0,
                               atol=1e-5)
    z_ind = jgp.kmeans_centriods(12, X, rand_state=0)
    xs = np.random.default_rng(3).uniform(X.min(0), X.max(0), (16, dim)).astype(np.float32)
    fitc_j = j.make_fitc_prediction_func(z_ind)
    mean_j = np.array([float(fitc_j(jnp.asarray(x))) for x in xs])
    fitc_t = t0.make_fitc_prediction_func(z_ind)
    mean_t = np.array([float(fitc_t(torch.tensor(x))) for x in xs])
    np.testing.assert_allclose(mean_t, mean_j, rtol=0, atol=1e-4 * np.abs(mean_j).max())
    t = tgp.GaussianProcess(dim)
    t.load_state_dict(t0.state_dict())
    before = t.predict(xs)
    t.pad_capacity(n + 4)
    for got, want in zip(t.predict(xs), before):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rows = np.random.default_rng(4).uniform(-1, 1, (6, dim + 1)).astype(np.float32)
    for k in range(3):   # 6 rows into 4 slots: the ring wraps
        t.add_data(rows[2 * k:2 * k + 2, :dim], rows[2 * k:2 * k + 2, dim])
    assert (t._n0, t._ptr) == (n, n + 2)
    kept = rows[[4, 5, 2, 3]]
    np.testing.assert_array_equal(_np(t.X)[n:], kept[:, :dim])
    assert float(t._point_noise.abs().max()) == 0.0
    plain = tgp.GaussianProcess(dim)
    plain.params = t.params
    plain.X = torch.tensor(np.vstack([X, kept[:, :dim]]), dtype=torch.float32)
    plain.Y = torch.cat([t0.Y, torch.tensor(kept[:, dim])])
    plain._precompute()
    for got, want in zip(t.predict(xs), plain.predict(xs)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert t.real_data()[0].shape[0] == n + 4
    sd = t.state_dict()
    r = tgp.GaussianProcess(dim)
    r.load_state_dict(sd)
    np.testing.assert_array_equal(_np(r._alpha), _np(t._alpha))
    assert r.state_dict()['ptr'] == sd['ptr'] == n + 2


def test_lloyd_from_jax_centroids_and_lhs_equal():
    X, _ = _regression_data(60)
    idx = jax.random.choice(jax.random.PRNGKey(0), X.shape[0], (10,), replace=False)
    want = jgp.kmeans_centriods(10, X, rand_state=0)
    got = tgp.lloyd_iterations(torch.tensor(X), torch.tensor(X[np.asarray(idx)]), 50).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    own = tgp.kmeans_centriods(10, X, rand_state=0)
    assert own.shape == (10, 5) and np.isfinite(own).all()
    lo, hi = [-1, -2, 0.5], [1, 3, 0.7]
    np.testing.assert_array_equal(tgp.lhs_sample(17, lo, hi, rand_state=3),
                                  jgp.lhs_sample(17, lo, hi, rand_state=3))


# ---------------------------------------------------------------------------
# GP-MPC: data, training, tightening, solves
# ---------------------------------------------------------------------------
def test_quad_bootstrap_data_equal_jax(pairs):
    """The LHS states and the quadrotor's inputs are numpy draws in both
    packages, so the port's own bootstrap gives JAX's transitions."""
    j, t, data, _ = pairs('quadrotor_2D')
    got = t._gather_training_samples(t.env_func(**BOOTSTRAP), QUAD_ALGO['num_samples'])
    np.testing.assert_array_equal(got[0], data[0])
    np.testing.assert_array_equal(got[1], data[1])
    np.testing.assert_allclose(got[2], data[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_trained_gps_match_jax(system, pairs):
    j, t, _, _ = pairs(system)
    for gj, gt in zip(j.gaussian_process.gps, t.gaussian_process.gps):
        for k in tgp.PARAM_KEYS:
            np.testing.assert_allclose(_np(gt.params[k]), _np(gj.params[k]), rtol=0, atol=2e-6)
    xs = j.data_inputs[::3] + 0.01
    for got, want in zip(t.gaussian_process.predict(xs), j.gaussian_process.predict(xs)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.inverse_cdf, j.inverse_cdf, rtol=1e-12)


def test_tightening_host_fused_and_jax_agree(pairs):
    j, t, _, steps = pairs('cartpole')
    for step in steps[1:4]:
        _set_warm(j, step['warm'])
        _set_warm(t, step['warm'])
        js, ju = (np.asarray(a) for a in j._constraint_tightening(0))
        hs, hu = (_np(a)[0] for a in t._constraint_tightening(0))
        host_binds = t._last_cap_binds
        X, U, has_prev = t._previous_plan()
        fs, fu, binds = t._tighten(X, U, t._tighten_params, has_prev)
        scale = np.abs(js).max()
        assert scale > 0
        np.testing.assert_allclose(hs, js, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(hu, ju, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(_np(fs)[0], hs, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(_np(fu)[0], hu, rtol=0, atol=1e-5 * scale)
        assert int(binds[0]) == host_binds == j._last_cap_binds == step['binds']
    # No previous plan: no tightening.
    X, U, _ = t._previous_plan()
    zs, zu, zb = t._tighten(X, U, t._tighten_params, torch.zeros(1))
    assert float(zs.abs().max()) == 0.0 and int(zb[0]) == 0


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_first_solve_and_closed_loop_match_jax(system, pairs):
    j, t, _, steps = pairs(system)
    t.setup_results_dict()
    for k, step in enumerate(steps):
        _set_warm(t, step['warm'])
        action = t.select_action(step['obs'], step['info'])
        ok, detail = _agree(action, step['action'], step['perturbed'])
        assert ok, (k, detail)
        assert t._last_cap_binds == step['binds'], k
        if k == 0:
            np.testing.assert_allclose(t.x_prev, step['x'], rtol=0, atol=ATOL)
    assert t.results_dict['tightening_cap_binds'] == [s['binds'] for s in steps]
    assert not t.terminate_loop


def test_select_action_batch_matches_jax(pairs):
    j, t, _, _ = pairs('cartpole')
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-0.3, 0.3, (8, 4)).astype(np.float32)
    u_t, f_t, b_t = t.select_action_batch(x0s)
    u_j, f_j, b_j = (np.asarray(a) for a in j.select_action_batch(x0s))
    variants = np.stack([np.asarray(j.select_action_batch(_perturbed(rng, x0s))[0])
                         for _ in range(PERTURBED)], axis=1)
    assert u_t.shape == (8, 1) and f_t.dtype == bool
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(b_t, b_j)
    for r in range(8):
        ok, detail = _agree(u_t[r], u_j[r], variants[r])
        assert ok, (r, detail)


def test_jax_saved_controller_loads_into_the_port(tmp_path, pairs):
    j, _, _, steps = pairs('cartpole')
    path = str(tmp_path / 'gp_mpc.pkl')
    j.save(path)
    env_id, task, algo = SYSTEMS['cartpole']
    t = tmake('gp_mpc', functools.partial(tmake, env_id, device='cpu', **task), **algo, **OUT)
    t.reset()
    t.load(path)
    np.testing.assert_array_equal(t.data_inputs, j.data_inputs)
    for step in steps[:3]:
        _set_warm(t, step['warm'])
        ok, detail = _agree(t.select_action(step['obs'], step['info']), step['action'],
                            step['perturbed'])
        assert ok, detail
    t.save(str(tmp_path / 'port.pkl'))
    r = tmake('gp_mpc', functools.partial(tmake, env_id, device='cpu', **task), **algo, **OUT)
    r.reset()
    r.load(str(tmp_path / 'port.pkl'))
    np.testing.assert_array_equal(_np(r.dynamics_params['alpha']), _np(t.dynamics_params['alpha']))


def test_online_learning_matches_jax(pairs):
    """The cartpole pair (its GPs padded for online learning) with online
    updates on, each step adding the last transition before its solve; the
    pair's GPs are restored after."""
    j, t, _, _ = pairs('cartpole')
    trained = [c.gaussian_process.state_dict() for c in (j, t)]
    try:
        for c in (j, t):
            c.online_learning = True
            c.reset_before_run()
            c.setup_results_dict()
        env = jmake('cartpole', **CART)
        obs, info = env.reset()
        for k in range(6):
            _set_warm(t, _warm_of(j))
            a_t = t.select_action(obs, info)
            a_j = j.select_action(obs, info)
            assert np.abs(a_t - a_j).max() <= ATOL, k
            obs, _, _, info = env.step(a_j)
        env.close()
        gj, gt = j.gaussian_process.gps[0], t.gaussian_process.gps[0]
        n = j.data_inputs.shape[0]
        assert gt._ptr == gj._ptr == n + 5 and gt.X.shape[0] == n + ONLINE_BUFFER
        # The rows added hold each package's own actions.
        np.testing.assert_allclose(_np(gt.X), _np(gj.X), rtol=0, atol=ATOL)
    finally:
        for c, sd in zip((j, t), trained):
            c.online_learning = False
            c.gaussian_process.load_state_dict(sd)
            c._refresh_dynamics_params()
            c.reset_before_run()


# ---------------------------------------------------------------------------
# Scenario MPC: examples/mpc/scenario_mpc_demo.py's problem
# ---------------------------------------------------------------------------
DEMO = dict(seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750, episode_len_sec=6,
            randomized_init=False, init_state={'init_theta': 0.15},
            task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.0},
            inertial_prop={'pole_length': 0.9}, done_on_out_of_bound=False,
            constraints=[{'constraint_form': 'default_constraint',
                          'constrained_variable': 'input'}])
DEMO_MPC = dict(q_mpc=[5, 0.1, 5, 0.1], r_mpc=[0.1], horizon=15, warmstart=True, sqp_iters=2,
                use_lqr_gain_and_terminal_cost=True,
                prior_info={'prior_prop': {'pole_length': 0.5}})
N_SCENARIOS = 16


class JScenario(JMPC):
    def dynamics_func_param(self, x, u, p):
        return jrk4(jcartpole, x, u, self.dt, p)


class TScenario(TMPC):
    def dynamics_func_param(self, x, u, p):
        return trk4(tcartpole, x, u, self.dt, TParams(**p))


def test_select_action_scenarios_matches_jax():
    """16 pole lengths (the demo's draw, the nominal first), three steps of
    the demo's multiple-model pick: candidates and flags against JAX's, the
    pick by one-step prediction error equal."""
    lengths = np.random.default_rng(0).uniform(0.4, 1.0, N_SCENARIOS)
    lengths[0] = 0.5
    full = lambda v: np.full(N_SCENARIOS, v, np.float32)
    scen = dict(pole_length=lengths.astype(np.float32), pole_mass=full(0.1),
                cart_mass=full(1.0), gravity=full(9.8))
    j = JScenario(functools.partial(jmake, 'cartpole', **DEMO), **DEMO_MPC)
    t = TScenario(functools.partial(tmake, 'cartpole', device='cpu', **DEMO), **DEMO_MPC)
    j.reset()
    t.reset()
    j_scen = JParams(**{k: jnp.asarray(v) for k, v in scen.items()})
    env = jmake('cartpole', **DEMO)
    obs, _ = env.reset()
    err, prev = np.zeros(N_SCENARIOS), None
    for _ in range(3):
        x = np.asarray(obs, np.float32)[:4]
        if prev is not None:
            n = N_SCENARIOS
            preds = trk4(tcartpole, torch.tensor(prev[0]).expand(n, 4),
                         torch.tensor(prev[1]).expand(n, 1),
                         t.dt, TParams(**{k: torch.tensor(v) for k, v in scen.items()}))
            err = 0.9 * err + np.linalg.norm(preds.numpy() - x[None], axis=1)
        u_j, f_j = (np.asarray(a) for a in j.select_action_scenarios(x, j_scen))
        u_t, f_t = t.select_action_scenarios(x, scen)
        assert u_t.shape == (N_SCENARIOS, 1)
        np.testing.assert_array_equal(f_t, f_j)
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=ATOL)
        pick = int(np.argmin(np.where(f_t, err, np.inf)))
        assert pick == int(np.argmin(np.where(f_j, err, np.inf)))
        prev = (x, np.atleast_1d(u_j[pick]).astype(np.float32))
        obs, _, _, _ = env.step(u_j[pick])
    env.close()


# ---------------------------------------------------------------------------
# The wrong prior, repaired (tests/test_gp_mpc.py through the port)
# ---------------------------------------------------------------------------
WRONG_PRIOR = dict(seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750, episode_len_sec=6,
                   randomized_init=False, init_state={'init_theta': 0.1},
                   task_info={'stabilization_goal': [0.3], 'stabilization_goal_tolerance': 0.02},
                   constraints=[{'constraint_form': 'default_constraint',
                                 'constrained_variable': 'input'}])


def _one_step_errors(ctrl, env, xs, us):
    def pred_err(dyn):
        errs = []
        for x, u in zip(xs, us):
            env.reset()
            env.set_state(x)
            xn, *_ = env.step(u)
            errs.append(np.linalg.norm(dyn(x, u) - xn[:len(x)]))
        return float(np.mean(errs))
    prior = pred_err(lambda x, u: ctrl.X_EQ + ctrl.Ad @ (x - ctrl.X_EQ) + ctrl.Bd @ (u - ctrl.U_EQ))
    ctrl.learn()
    gp = pred_err(lambda x, u: ctrl.dynamics_func(torch.tensor(x), torch.tensor(u)).numpy())
    return prior, gp


@pytest.mark.parametrize('sparse', [False, True])
def test_gp_mpc_corrects_wrong_prior(sparse):
    """The port's own bootstrap (its cartpole actions from a numpy generator)
    repairs the wrong pole length's one-step predictions by more than 3x, and
    the learned controller runs BaseExperiment's evaluation (its first 30 of
    90 steps, for the file's time)."""
    env_func = functools.partial(tmake, 'cartpole', device='cpu', **WRONG_PRIOR)
    ctrl = tmake('gp_mpc', env_func, q_mpc=[1], r_mpc=[0.1], horizon=15,
                 prior_info={'prior_prop': {'pole_length': 1.0}}, train_iterations=1,
                 num_samples=60, optimization_iterations=120, sparse_gp=sparse,
                 n_ind_points=40, seed=0, **OUT)
    ctrl.reset()
    env = env_func()
    env.reset()
    rng = np.random.default_rng(3)
    xs = rng.uniform(-0.5, 0.5, (30, 4)).astype(np.float32)
    us = rng.uniform(-3, 3, (30, 1)).astype(np.float32)
    e_prior, e_gp = _one_step_errors(ctrl, env, xs, us)
    assert e_gp < e_prior / 3.0, (e_prior, e_gp)
    assert set(ctrl.learn_seconds) == {'collection_s', 'training_s'}
    exp = BaseExperiment(env_func(), ctrl)
    _, metrics = exp.run_evaluation(n_steps=30, verbose=False)
    assert np.isfinite(metrics['average_rmse'])
    exp.close()


def test_gp_mpc_quadrotor_2d_corrects_wrong_prior(pairs):
    j, t, _, _ = pairs('quadrotor_2D')
    env_func = functools.partial(tmake, 'quadrotor', device='cpu', **QUAD)
    ctrl = tmake('gp_mpc', env_func, **QUAD_ALGO, **OUT)
    ctrl.reset()
    env = env_func()
    env.reset()
    rng = np.random.default_rng(3)
    hover = np.array([0.0, 0.0, 1.0, 0.0, 0.0, 0.0], np.float32)
    xs = (hover + rng.uniform(-0.2, 0.2, (20, 6))).astype(np.float32)
    us = (np.asarray(ctrl.U_EQ) + rng.uniform(-0.02, 0.02, (20, 2))).astype(np.float32)
    e_prior, e_gp = _one_step_errors(ctrl, env, xs, us)
    assert e_gp < e_prior / 2.0, (e_prior, e_gp)
    # The port's bootstrap is JAX's here, so is its training.
    np.testing.assert_array_equal(ctrl.data_inputs, j.data_inputs)
    res = ctrl.run(max_steps=5)
    assert res['action'].shape == (5, 2) and len(res['tightening_cap_binds']) == 5


def test_registry_and_example_config():
    env_id, task, algo = control_config('gp_mpc', 'cartpole', 'stab')
    assert env_id == 'cartpole' and algo['num_samples'] == 80 and algo['horizon'] == 15
    ctrl = tmake('gp_mpc', functools.partial(tmake, env_id, device='cpu', **task),
                 **dict(algo, num_samples=4, optimization_iterations=2), **OUT)
    assert type(ctrl).__name__ == 'GPMPC' and ctrl.sqp_iters == 2
    for unported in (dict(gp_approx='taylor'), dict(normalize_training_data=True)):
        with pytest.raises(NotImplementedError):
            tmake('gp_mpc', functools.partial(tmake, env_id, device='cpu', **task),
                  **unported, **OUT)
    with pytest.raises(RuntimeError, match='trained GP'):
        ctrl.select_action_batch(np.zeros((2, 4)))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_gp_training_and_loop_match_cpu(pairs):
    """The cartpole's GP trained on the card against the CPU's on the same
    data, and five steps of the card's controller against the CPU's fed the
    same observation and warm start."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    j, cpu, data, steps = pairs('cartpole')
    env_id, task, algo = SYSTEMS['cartpole']
    card = tmake('gp_mpc', functools.partial(tmake, env_id, device='cuda', **task), **algo, **OUT)
    card.reset()
    _train(card, 'cartpole', cpu.data_inputs, cpu.data_targets)
    for gc, gt in zip(card.gaussian_process.gps, cpu.gaussian_process.gps):
        for k in tgp.PARAM_KEYS:
            np.testing.assert_allclose(_np(gc.params[k]), _np(gt.params[k]), rtol=0, atol=1e-5)
    card.setup_results_dict()
    cpu.setup_results_dict()
    for step in steps[:5]:
        _set_warm(card, step['warm'])
        _set_warm(cpu, step['warm'])
        np.testing.assert_allclose(card.select_action(step['obs'], step['info']),
                                   cpu.select_action(step['obs'], step['info']), rtol=0,
                                   atol=ATOL)
        assert card._last_cap_binds == cpu._last_cap_binds
