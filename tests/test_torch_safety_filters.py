"""The port's safety filters (``safe_control_gym_tpu_torch/safety_filters``)
against the JAX package's on the CPU: the registry and configs, the RPI set,
the tube and its tightening after loading each committed ``.pkl``, linear
MPSC's solves, ladder and batch, CBF and CBF-NN, the replay ring, and the
env's action normalization.

Configs: tests/test_safety_filters.py's constrained cartpole (15 Hz over 50
substeps), the 2D quad of examples/mpsc (BASELINE.json's fifth config, the
filter's env: quadratic cost, physical actions, 50 Hz over 20 substeps) and
the 3D quad's example env, each filter loaded from its committed ``.pkl``.
The committed 2D P's box in theta_dot (2.0005) exceeds the state bound
(1.5): its tightened state set is empty and every 2D certification is
infeasible, in both packages. The 2D solves are therefore also held on the
same P times 4 (a tube half as wide), where states certify.

Tolerances, and why:
* The tube (``_lyapunov_rpi``, ``ellipse_bounding_box``,
  ``pontryagin_difference_AABB``, the tightened sets) to 1e-10: numpy in
  float64 on both sides, given the same P and LQR gain (the port's gain is
  held to JAX's at 1e-4 of its largest entry, tests/test_torch_control.py).
* ``compute_RPI_set``: the same candidate (descent or Lyapunov) and log det
  within 1e-3 relative of JAX's, or within JAX's own spread (the largest
  difference of its answers under two 1e-7 relative changes of the
  residuals) of one of JAX's answers. The float32 descent is chaotic where
  it rides the constraint's edge: the two descents agree to 1e-6 for 20
  steps and then part, and the certification's scale search moves log det
  in steps of nx ln 0.75 (1.15 at nx 4); JAX's own log det on the cartpole
  residuals moves by up to 4% under such changes.
* Solves and certifications: feasibility flags equal, actions within 1e-4,
  or, where JAX's own answer moves by more under 1e-7 relative changes of
  its state (the polish picks its candidate by rounding, as in
  tests/test_torch_mpc.py), one of JAX's answers to those changes within
  1e-4. The port's filter takes JAX's warm state before each step of the
  ladder, so the kinf sequences compare step by step.
* CBF: actions 1e-4 and flags equal; ``is_cbf`` equal.
* CBF-NN's residual terms on the committed model: 1e-6 (float32 MLP).
"""

import functools
import os
import pickle
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_tpu.safety_filters.mpsc import mpsc_utils as jutils
from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.controllers.off_policy_utils import (replay_init, replay_push,
                                                                     replay_sample)
from safe_control_gym_tpu_torch.experiments.control_configs import load, safety_config
from safe_control_gym_tpu_torch.math.metrics import compute_cvar
from safe_control_gym_tpu_torch.parallel.sharding import make_env_mesh
from safe_control_gym_tpu_torch.safety_filters.mpsc import mpsc_utils as tutils
from safe_control_gym_tpu_torch.utils.registration import get_config as tget
from safe_control_gym_tpu_torch.utils.registration import make as tmake
from tests.torch_sharding_ranks import one_rank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(ROOT, 'examples', 'mpsc', 'models')
ATOL = 1e-4
PERTURBED = 8
CONSTRAINED_CARTPOLE = dict(
    seed=42, cost='quadratic', ctrl_freq=15, pyb_freq=750, episode_len_sec=6,
    randomized_init=False, init_state={'init_theta': 0.1},
    task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.005},
    constraints=[{'constraint_form': 'default_constraint', 'constrained_variable': 'state',
                  'upper_bounds': [1.5, 2, 0.3, 2], 'lower_bounds': [-1.5, -2, -0.3, -2]},
                 {'constraint_form': 'default_constraint', 'constrained_variable': 'input',
                  'upper_bounds': [5], 'lower_bounds': [-5]}])
MPSC_CFG = dict(horizon=10, q_lin=[1], r_lin=[1], integration_algo='rk4', n_samples=120,
                tau=0.95, seed=0, use_terminal_set=False)
CBF_ENV = dict(seed=42, randomized_init=False,
               constraints=CONSTRAINED_CARTPOLE['constraints'])
# The JAX test's rows (tests/test_safety_filters.py:79-101, :134-151).
MPSC_STATES = np.stack([np.array([0.2, 0.1, 0.05, -0.1]), np.array([-0.5, 0.3, -0.08, 0.2]),
                        np.array([1.2, 0.5, 0.1, 0.3]),
                        np.random.default_rng(7).normal(0, 0.2, 4)]).astype(np.float32)
MPSC_ACTIONS = np.array([[0.5], [-1.0], [4.0], [0.2]], np.float32)
CBF_STATES = np.stack([np.zeros(4), np.array([0, 0, 0.28, 1.0]), np.array([0, 0, -0.2, -0.5]),
                       np.array([0.1, -0.2, 0.15, 0.4])]).astype(np.float32)
CBF_ACTIONS = np.array([[0.1], [3.0], [-3.0], [1.5]], np.float32)
# Hover and offsets about it (x, x_dot, z, z_dot, theta, theta_dot).
QUAD_STATES = np.array([[0.0, 0.0, 1.0, 0.0, 0.0, 0.0], [0.3, 0.1, 0.8, -0.1, 0.05, 0.2],
                        [-0.4, 0.2, 1.3, 0.1, -0.08, -0.3], [0.0, 0.0, 0.05, -0.8, 0.15, 1.2]],
                       np.float32)


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


def _quad_task():
    """The 2D quad env of the filter in examples/mpsc/mpsc_experiment.py."""
    _, task, _, _ = safety_config('mpsc', 'quadrotor_2D', 'stab', 'sac')
    return dict(task, randomized_init=False, cost='quadratic', normalized_rl_action_space=False)


def _quad3d_task():
    with open(os.path.join(ROOT, 'examples/mpsc/config_overrides/quadrotor_3D/'
                                 'quadrotor_3D_stab.yaml')) as f:
        task = yaml.safe_load(f)['task_config']
    return dict(task, randomized_init=False, cost='quadratic', normalized_rl_action_space=False)


TASKS = {'cartpole': ('cartpole', lambda: CONSTRAINED_CARTPOLE),
         'quadrotor_2D': ('quadrotor', _quad_task), 'quadrotor_3D': ('quadrotor', _quad3d_task)}


@functools.lru_cache(maxsize=None)
def _mpsc_pair(system):
    """JAX's and the port's LINEAR_MPSC on ``system``, the port's tube from
    JAX's gain, so that the tightening compares at 1e-10 (the gains
    themselves are compared below)."""
    env_id, task = TASKS[system]
    task = task()
    cfg = dict(MPSC_CFG, n_samples=4)
    j = jmake('linear_mpsc', functools.partial(jmake, env_id, **task), **cfg)
    t = tmake('linear_mpsc', functools.partial(tmake, env_id, device='cpu', **task), **cfg)
    t.own_gain, t.lqr_gain = t.lqr_gain, np.array(j.lqr_gain)
    return j, t


# The scale of the P each system's pair holds.
_SCALE = {}


def _mpsc(system, scale=1.0):
    """``_mpsc_pair(system)``, both filters loaded with the committed P
    (times ``scale``; a pair is loaded again when the scale changes)."""
    j, t = _mpsc_pair(system)
    if _SCALE.get(system) != scale:
        path = os.path.join(MODELS, f'linear_mpsc_{system}.pkl')
        with tempfile.TemporaryDirectory() as tmp:
            if scale != 1.0:
                with open(path, 'rb') as f:
                    P = pickle.load(f)['P'] * scale
                path = os.path.join(tmp, f'linear_mpsc_{system}_{scale}.pkl')
                with open(path, 'wb') as f:
                    pickle.dump({'P': P}, f)
            j.load(path)
            t.load(path)
        _SCALE[system] = scale
    return j, t


@functools.lru_cache(maxsize=None)
def _cbf(name):
    j = jmake(name, functools.partial(jmake, 'cartpole', **CBF_ENV), seed=0)
    t = tmake(name, functools.partial(tmake, 'cartpole', device='cpu', **CBF_ENV), seed=0)
    if name == 'cbf_nn':
        path = os.path.join(ROOT, 'examples', 'cbf', 'models', 'cbf_nn_cartpole.pt')
        j.load(path)
        t.load(path)
    return j, t


def _set_warm(sf, warm):
    sf.z_prev, sf.v_prev, sf._qp_warm, sf.kinf = warm


def _warm_of(j):
    copy = lambda a: None if a is None else np.array(a)
    qp = None if j._qp_warm is None else tuple(np.array(a) for a in j._qp_warm)
    return copy(j.z_prev), copy(j.v_prev), qp, j.kinf


def _agree(port, jax_answer, jax_fn, state):
    """The port's answer is JAX's within ATOL, or, where JAX's own answer
    moves by more than ATOL when ``state`` changes by 1e-7 relative
    (PERTURBED draws, numpy seed 1; ``jax_fn(state)`` gives JAX's answer, or
    None where it finds the state infeasible), one of JAX's answers to those
    changes within ATOL."""
    port, ref = np.atleast_1d(port), np.atleast_1d(jax_answer)
    if np.abs(port - ref).max() <= ATOL:
        return True
    rng = np.random.default_rng(1)
    spread = [np.atleast_1d(a) for a in (
        jax_fn((state * (1 + 1e-7 * rng.standard_normal(state.shape))).astype(np.float32))
        for _ in range(PERTURBED)) if a is not None]
    return (max(np.abs(a - ref).max() for a in spread) > ATOL
            and min(np.abs(port - a).max() for a in spread) <= ATOL)


# ---------------------------------------------------------------------------
# Registry and configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name', ['linear_mpsc', 'cbf', 'cbf_nn'])
def test_registry_defaults_equal_jax(name):
    assert tget(name) == jget(name)


@pytest.mark.parametrize('example,systems', [('mpsc', ('cartpole', 'quadrotor_2D')),
                                             ('cbf', ('cartpole',))])
def test_safety_configs_equal_the_example_yamls(example, systems):
    configs = load(example)
    folder = os.path.join(ROOT, 'examples', example, 'config_overrides')
    names = sorted(f'{s}/{f[:-5]}' for s in systems
                   for f in os.listdir(os.path.join(folder, s)) if f.endswith('.yaml'))
    assert sorted(configs) == names
    for name in names:
        with open(os.path.join(folder, name + '.yaml')) as f:
            assert configs[name] == yaml.safe_load(f), name


def test_safety_config_assembles_config_5():
    env_id, task, algo, sfs = safety_config('mpsc', 'quadrotor_2D', 'stab', 'sac')
    assert env_id == 'quadrotor' and task['quad_type'] == 2 and task['pyb_freq'] == 1000
    assert algo['hidden_dim'] == 256 and algo['activation'] == 'relu'
    assert sfs == {'linear_mpsc': load('mpsc')['quadrotor_2D/linear_mpsc_quadrotor_2D']
                   ['sf_config']}
    assert set(safety_config('cbf', 'cartpole', 'stab', 'lqr')[3]) == {'cbf', 'cbf_nn'}


# ---------------------------------------------------------------------------
# The tube
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('system', ['cartpole', 'quadrotor_2D', 'quadrotor_3D'])
def test_loaded_tube_matches_jax(system):
    j, t = _mpsc(system)
    nx = t.model.nx
    assert t.P.shape == (nx, nx)
    np.testing.assert_array_equal(t.P, j.P)
    # The gain the port computes itself, against JAX's.
    assert np.abs(t.own_gain - j.lqr_gain).max() <= 1e-4 * np.abs(j.lqr_gain).max()
    close = functools.partial(np.testing.assert_allclose, rtol=0, atol=1e-10)
    close(tutils.ellipse_bounding_box(j.P), jutils.ellipse_bounding_box(j.P))
    for name in ('omega_AABB_verts', 'K_omega_AABB_verts', 'U_vertices', 'X_vertices',
                 'tightened_input_constraint_verts', 'tightened_state_constraint_verts'):
        close(getattr(t, name), getattr(j, name))
    for name in ('tightened_input_constraint', 'tightened_state_constraint'):
        for attr in ('lower_bounds', 'upper_bounds'):
            close(getattr(getattr(t, name), attr), getattr(getattr(j, name), attr))
    rng = np.random.default_rng(3)
    A_cl = t.discrete_dfdx + t.discrete_dfdu @ t.lqr_gain
    W = rng.normal(0, 1e-3, (40, nx))
    close(tutils._lyapunov_rpi(A_cl, W, 0.95), jutils._lyapunov_rpi(A_cl, W, 0.95))
    v1, v2 = rng.normal(0, 1, (8, nx)), rng.normal(0, 0.1, (8, nx))
    (tv, tf), (jv, jf) = (m.pontryagin_difference_AABB(v1, v2) for m in (tutils, jutils))
    close(tv, jv)
    con = tf(env=t.env, constrained_variable='state')
    close(con.upper_bounds, jf(env=j.env, constrained_variable='state').upper_bounds)
    if system == 'quadrotor_2D':
        # The committed 2D P certifies nothing: its tightened state set is
        # the zero set (JAX's equal, above), so even hover is infeasible.
        assert not t.tightened_state_constraint.upper_bounds.any()
        t.reset_before_run()
        t.before_optimization(QUAD_STATES[0])
        assert t.solve_optimization(QUAD_STATES[0], t.U_EQ) == (None, False)


def test_rpi_set_matches_jax_and_is_invariant():
    """The cartpole residuals of the port's learn() (120 samples) through
    both compute_RPI_set; the port's P passes the invariance check of
    tests/test_safety_filters.py:104-131 and certifies every block."""
    t = tmake('linear_mpsc', functools.partial(tmake, 'cartpole', device='cpu',
                                               **CONSTRAINED_CARTPOLE),
              **MPSC_CFG)
    t.learn()
    assert set(t.learn_seconds) == {'collection_s', 'descent_s', 'bisection_s', 'setup_s'}
    A = t.discrete_dfdx + t.discrete_dfdu @ t.lqr_gain
    w = t.residuals
    rng = np.random.default_rng(1)
    ld = [float(np.linalg.slogdet(jutils.compute_RPI_set(
        A, w if k == 0 else w * (1 + 1e-7 * rng.standard_normal(w.shape)), 0.95))[1])
        for k in range(3)]
    ld_t = float(np.linalg.slogdet(t.P)[1])
    ld_lyap = _lyapunov_logdet(A, w, 0.95)
    # The same candidate: the descent's, tighter than the Lyapunov ellipse.
    assert ld[0] > ld_lyap + 1 and ld_t > ld_lyap + 1
    # Within JAX's own spread (its answers' largest pairwise difference) of
    # one of JAX's answers.
    spread = max(ld) - min(ld)
    assert min(abs(ld_t - x) for x in ld) <= max(1e-3 * abs(ld[0]), spread), (ld_t, ld)
    _assert_invariant(t.P, A, w)
    # Every sampled block negative semidefinite, in float64, in the
    # preconditioned coordinates of the certification.
    D = tutils._preconditioner(A, w.T)
    blocks = tutils._max_lmi_eigs(torch.tensor(t.P / np.outer(D, D)),
                                  torch.tensor((D[:, None] * A) / D[None, :]),
                                  torch.tensor(w.T * D[None, :]), 0.95)
    assert float(blocks.max()) <= 1e-6


def _lyapunov_logdet(A, w, tau):
    D = tutils._preconditioner(A, w.T)
    P = tutils._lyapunov_rpi((D[:, None] * A) / D[None, :], w.T * D[None, :], tau)
    return float(np.linalg.slogdet((D[:, None] * P) * D[None, :])[1])


def _assert_invariant(P, A, w):
    """For boundary points x'Px = 1 and every residual, (Ax+w)'P(Ax+w) <= 1."""
    nx = P.shape[0]
    rng = np.random.default_rng(0)
    assert np.linalg.eigvalsh(P).min() > 0
    xs = rng.normal(0, 1, (200, nx))
    L = np.linalg.cholesky(np.linalg.inv(P))
    xs = (xs / np.linalg.norm(xs, axis=1, keepdims=True)) @ L.T
    nxt = xs @ A.T
    lhs = (np.sum((nxt @ P) * nxt, axis=1)[:, None] + 2 * np.einsum('ij,jk,lk->il', nxt, P, w.T)
           + np.sum((w.T @ P) * w.T, axis=1)[None, :])
    assert float(lhs.max()) <= 1.0 + 1e-6, lhs.max()


def test_rpi_set_12dim_matches_jax():
    """tests/test_rpi_set_invariance_12dim's 12-state map and residuals,
    with 20 descent steps (the Lyapunov candidate, both, as up to 300): P
    equal to 1e-10 of its scale, and invariant."""
    rng = np.random.default_rng(0)
    nx = 12
    A = rng.normal(0, 0.3, (nx, nx))
    A = A / np.max(np.abs(np.linalg.eigvals(A))) * 0.97
    w = rng.normal(0, 1e-3, (nx, 300))
    P_j = jutils.compute_RPI_set(A, w, tau=0.975, iters=20)
    P_t = tutils.compute_RPI_set(A, w, tau=0.975, iters=20, device='cpu')
    assert abs(np.linalg.slogdet(P_t)[1] - _lyapunov_logdet(A, w, 0.975)) <= 1e-9
    np.testing.assert_allclose(P_t, P_j, rtol=0, atol=1e-10 * np.abs(P_j).max())
    _assert_invariant(P_t, A, w)


def test_descent_follows_jax_for_its_first_steps():
    """The descent from the Lyapunov start: 20 Adam steps equal JAX's
    compute_RPI_set's objective steps to 1e-5 (the objective and its
    gradient: the largest-eigenvalue hinge of every block, -logdet)."""
    import jax
    import optax
    rng = np.random.default_rng(2)
    A = np.diag([0.9, 0.8, 0.7, 0.6]) + rng.normal(0, 0.05, (4, 4))
    w = rng.normal(0, 1e-2, (4, 60))
    D = tutils._preconditioner(A, w.T)
    A_s, W_s = (D[:, None] * A) / D[None, :], w.T * D[None, :]
    L0 = np.linalg.cholesky(tutils._lyapunov_rpi(A_s, W_s, 0.95)).astype(np.float32)
    jutils._lmi_blocks.tau = 0.95
    A_j, W_j = jnp.asarray(A_s, jnp.float32), jnp.asarray(W_s, jnp.float32)

    def loss(L_flat):
        L = jnp.tril(L_flat)
        P = L @ L.T + 1e-8 * jnp.eye(4)
        blocks = jax.vmap(lambda wi: jutils._lmi_blocks(P, A_j, wi))(W_j)
        viol = jnp.clip(jnp.linalg.eigvalsh(blocks)[:, -1], 0.0, None)
        return -jnp.linalg.slogdet(P)[1] + 100 * jnp.sum(viol ** 2) + 100 * jnp.sum(viol)

    opt = optax.adam(5e-2)

    @jax.jit
    def steps(L):
        def body(carry, _):
            L, state = carry
            updates, state = opt.update(jax.grad(loss)(L), state)
            return (optax.apply_updates(L, updates), state), None
        with jax.default_matmul_precision('highest'):
            return jax.lax.scan(body, (L, opt.init(L)), None, length=20)[0][0]
    L = steps(jnp.asarray(L0))
    L_t = tutils._descend(torch.tensor(L0), torch.tensor(A_s, dtype=torch.float32),
                          torch.tensor(W_s, dtype=torch.float32), 0.95, 20, 5e-2, 100.0)
    L_j = np.tril(np.asarray(L))
    assert np.abs(L_t.numpy() - L_j).max() <= 1e-5 * np.abs(L_j).max()


# ---------------------------------------------------------------------------
# Linear MPSC: solves, the ladder, the batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('system,scale,states,actions', [
    ('cartpole', 1.0, MPSC_STATES, MPSC_ACTIONS),
    ('quadrotor_2D', 4.0, QUAD_STATES, None)])
def test_solve_optimization_matches_jax(system, scale, states, actions):
    j, t = _mpsc(system, scale)
    if actions is None:
        actions = np.tile(j.U_EQ, (len(states), 1)).astype(np.float32) * np.array(
            [[1.0], [1.05], [0.9], [1.2]][:len(states)], np.float32)
    assert (t._n_z, t._m_rows) == (j._n_z, j._m_rows)
    flags = []
    for state, action in zip(states, actions):
        def jax_solve(s):
            j.reset_before_run()
            j.before_optimization(s)
            return j.solve_optimization(s, action)
        u_j, ok_j = jax_solve(state)
        t.reset_before_run()
        t.before_optimization(state)
        u_t, ok_t = t.solve_optimization(state, action)
        assert ok_t == ok_j
        flags.append(ok_t)
        if ok_j:
            assert _agree(u_t, u_j, lambda s: jax_solve(s)[0], state), (u_t, u_j)
            j.before_optimization(state)
            jax_solve(state)
            np.testing.assert_allclose(t.z_prev[:, 0], j.z_prev[:, 0], rtol=0, atol=1e-3)
    assert any(flags) and not all(flags)


@pytest.mark.parametrize('system,scale', [('cartpole', 1.0), ('quadrotor_2D', 4.0)])
def test_certify_action_ladder_matches_jax(system, scale):
    """A run of certify_action through feasible and infeasible states: the
    port takes JAX's warm state before each step; kinf, the flags and the
    actions compare step by step."""
    j, t = _mpsc(system, scale)
    if system == 'cartpole':
        states = np.concatenate([MPSC_STATES[[0, 1]], MPSC_STATES[[2, 2, 2]],
                                 MPSC_STATES[[3, 0]]])
        actions = np.array([[0.5], [-1.0], [4.0], [4.0], [4.0], [0.2], [0.5]], np.float32)
    else:
        states = QUAD_STATES[[0, 1, 3, 3, 0, 2]]
        actions = np.tile(j.U_EQ, (6, 1)).astype(np.float32)
    j.reset_before_run()
    for k, (state, action) in enumerate(zip(states, actions)):
        warm = _warm_of(j)

        def jax_certify(s):
            _set_warm(j, warm)
            return j.certify_action(s, action)
        _set_warm(t, warm)
        u_t, ok_t = t.certify_action(state, action)
        u_j, ok_j = jax_certify(state)
        after = _warm_of(j)
        assert ((ok_t, t.results_dict['feasible'][-1], t.kinf)
                == (ok_j, j.results_dict['feasible'][-1], j.kinf)), k
        assert _agree(u_t, u_j, lambda s: jax_certify(s)[0], state), (k, u_t, u_j)
        _set_warm(j, after)
    assert 0 in j.results_dict['kinf'] and max(j.results_dict['kinf']) > 0


def test_certify_action_batch_matches_jax():
    j, t = _mpsc('cartpole')
    u_t, ok_t = t.certify_action_batch(MPSC_STATES, MPSC_ACTIONS)
    u_j, ok_j = j.certify_action_batch(MPSC_STATES, MPSC_ACTIONS)
    assert u_t.shape == (4, 1) and ok_t.dtype == bool
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(u_t, np.asarray(u_j), rtol=0, atol=ATOL)
    # A row of the batch alone through solve_optimization (cold).
    t.reset_before_run()
    t.before_optimization(MPSC_STATES[3])
    u, ok = t.solve_optimization(MPSC_STATES[3], MPSC_ACTIONS[3])
    assert ok and np.abs(u - u_t[3]).max() <= ATOL


def test_terminal_sets():
    """The terminal ball (its inner box, then the ball checked again) against
    JAX's, and the learned terminal polytope (tests/test_mpsc_terminal.py's
    structure) from the loaded P."""
    j, t = _mpsc('cartpole')
    state, action = MPSC_STATES[0] * 0.1, MPSC_ACTIONS[0]
    # The pair is shared: its attributes (JAX's compiled solves among them)
    # are put back afterwards.
    saved = [dict(vars(sf)) for sf in (j, t)]
    try:
        for sf in (j, t):
            sf.use_terminal_set = True
            sf.setup_optimizer()
        assert t._m_rows == j._m_rows == 144 + 4 and t._terminal_quadratic
        for sf in (j, t):
            sf.reset_before_run()
            sf.before_optimization(state)
        u_j, ok_j = j.solve_optimization(state, action)
        u_t, ok_t = t.solve_optimization(state, action)
        assert ok_t == ok_j
        if ok_j:
            assert _agree(u_t, u_j, lambda s: j.solve_optimization(s, action)[0], state)
            assert float(t.z_prev[:, -1] @ t.z_prev[:, -1]) <= t._term_tol + 2e-2
        t.learn_terminal_set, t.n_samples_terminal_set = True, 3
        t._learn_terminal_set(t.training_env)
        A, b = t.terminal_set
        assert A.shape[1] == 4 and A.shape[0] == b.shape[0]
        assert len(t.terminal_set_verts) % (t.horizon + 1) == 0
        t.reset_before_run()
        cert, _ = t.certify_action(np.array([0.0, 0.0, 0.05, 0.0], np.float32), np.array([0.1]))
        assert np.isfinite(np.atleast_1d(cert)).all()
    finally:
        for sf, attrs in zip((j, t), saved):
            vars(sf).clear()
            vars(sf).update(attrs)


def test_save_load_and_unported_paths(tmp_path):
    j, t = _mpsc('cartpole')
    path = str(tmp_path / 'mpsc.pkl')
    t.save(path)
    with open(path, 'rb') as f:
        assert set(pickle.load(f)) == {'P'}
    t2 = tmake('linear_mpsc', functools.partial(tmake, 'cartpole', device='cpu',
                                                **CONSTRAINED_CARTPOLE), **MPSC_CFG)
    with pytest.raises(RuntimeError, match='learn'):
        t2.solve_optimization(MPSC_STATES[0], MPSC_ACTIONS[0])
    t2.load(path)
    np.testing.assert_array_equal(t2.P, t.P)
    # Sharded over a world of one rank, the batch certifies as unsharded.
    want = t2.certify_action_batch(MPSC_STATES, MPSC_ACTIONS)
    with one_rank():
        t2.shard_over(make_env_mesh(axis_name='data'))
        got = t2.certify_action_batch(MPSC_STATES, MPSC_ACTIONS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    t2._solve_mesh = None
    with pytest.raises(NotImplementedError, match='select_action'):
        t2.select_action(MPSC_STATES[0])
    with open(path, 'wb') as f:
        pickle.dump({'P': t.P, 'evil': functools.partial(print)}, f)
    with pytest.raises(pickle.UnpicklingError):
        t2.load(path)


# ---------------------------------------------------------------------------
# CBF and CBF-NN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('name', ['cbf', 'cbf_nn'])
def test_cbf_solves_and_batch_match_jax(name):
    j, t = _cbf(name)
    assert t.is_control_affine() and j.is_control_affine()
    for state, action in zip(CBF_STATES, CBF_ACTIONS):
        u_j, ok_j = j.solve_optimization(state, action)
        u_t, ok_t = t.solve_optimization(state, action)
        assert ok_t == ok_j
        np.testing.assert_allclose(u_t, np.asarray(u_j), rtol=0, atol=ATOL)
    u_t, ok_t = t.certify_action_batch(CBF_STATES, CBF_ACTIONS)
    u_j, ok_j = j.certify_action_batch(CBF_STATES, CBF_ACTIONS)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(u_t, np.asarray(u_j), rtol=0, atol=ATOL)
    if name == 'cbf':
        # Outside the safe set, pushing beyond the bound: saturated, unsafe.
        c, s = t.certify_action(CBF_STATES[1], np.array([8.0]))
        assert not s and abs(float(c) - 5.0) < 1e-2


def test_cbf_is_cbf_matches_jax():
    j, t = _cbf('cbf')
    valid_j, bad_j = j.is_cbf(num_points=8)
    valid_t, bad_t = t.is_cbf(num_points=8)
    assert valid_t == valid_j
    np.testing.assert_array_equal(np.array(bad_t).reshape(-1, 4),
                                  np.array(bad_j).reshape(-1, 4))


def test_cbf_nn_terms_match_jax():
    j, t = _cbf('cbf_nn')
    for state in CBF_STATES:
        a_j, b_j = j._nn_terms(state)
        a_t, b_t = t._nn_terms(state)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6, atol=1e-6)
        assert abs(float(b_t) - float(b_j)) <= 1e-6 * max(1.0, abs(float(b_j)))
    a, b = t._nn_terms_batch(CBF_STATES)
    np.testing.assert_allclose(a.numpy()[:, 0], [float(t._nn_terms(s)[0][0]) for s in CBF_STATES],
                               rtol=1e-6)


def test_cbf_nn_learns_residual(tmp_path):
    """tests/test_safety_filters.py's size: two episodes of 40 steps with
    LQR, ten Adam steps each, from theta 0.1 (from rest the cart stays at
    rest and every target is 0)."""
    env_func = functools.partial(tmake, 'cartpole', device='cpu', init_state={'init_theta': 0.1},
                                 **CBF_ENV)
    ctrl = tmake('lqr', env_func, q_lqr=[1], r_lqr=[0.1])
    sf = tmake('cbf_nn', env_func, num_episodes=2, max_num_steps=40, train_iterations=10,
               uncertified_controller=ctrl, seed=0)
    sf.learn()
    assert int(sf.buffer.state.count) == 2 * 38
    losses = np.concatenate(sf.train_losses)
    assert losses.shape == (20,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    c, s = sf.certify_action(np.zeros(4, np.float32), np.array([0.5]))
    assert s
    states = np.stack([np.zeros(4), [0, 0, 0.2, 0.5]]).astype(np.float32)
    acts = np.array([[0.5], [2.0]], np.float32)
    bu, bok = sf.certify_action_batch(states, acts)
    for i in range(2):
        u_seq, ok_seq = sf.solve_optimization(states[i], acts[i])
        assert bool(bok[i]) == ok_seq
        np.testing.assert_allclose(bu[i], u_seq, rtol=0, atol=ATOL)
    path = str(tmp_path / 'cbf_nn.pt')
    sf.save(path)
    sf2 = tmake('cbf_nn', env_func, seed=1)
    sf2.load(path)
    for a, b in zip(sf2.mlp_params, sf.mlp_params):
        np.testing.assert_array_equal(a['w'].numpy(), b['w'].numpy())


# ---------------------------------------------------------------------------
# The replay ring, metrics and the env's action normalization
# ---------------------------------------------------------------------------
def test_replay_ring_wraps_and_samples_the_filled_rows():
    state = replay_init({'a': 2, 'b': 1}, 5, device='cpu')
    state = replay_push(state, {'a': torch.arange(6.0).reshape(3, 2), 'b': torch.ones(3, 1)})
    assert int(state.ptr) == 3 and int(state.count) == 3
    gen = torch.Generator().manual_seed(0)
    batch = replay_sample(state, gen, 200)
    assert set(batch['a'][:, 0].tolist()) == {0.0, 2.0, 4.0}
    state = replay_push(state, {'a': torch.full((4, 2), 9.0), 'b': torch.zeros(4, 1)})
    assert int(state.ptr) == 2 and int(state.count) == 7
    assert state.data['a'][:, 0].tolist() == [9.0, 9.0, 4.0, 9.0, 9.0]
    assert replay_sample(state, gen, 500)['a'][:, 0].unique().tolist() == [4.0, 9.0]


def test_compute_cvar_matches_jax():
    from safe_control_gym_tpu.math.metrics import compute_cvar as jcvar
    data = np.random.default_rng(0).normal(size=37)
    for alpha in (0.1, 0.5, 1.0):
        for lower in (True, False):
            assert compute_cvar(data, alpha, lower) == jcvar(data, alpha, lower)


@pytest.mark.parametrize('env_id,kw', [
    ('cartpole', {}), ('quadrotor', {'quad_type': 2}),
    ('quadrotor', {'quad_type': 3, 'task_info': {'stabilization_goal': [0, 0, 1]}})])
def test_action_normalization_matches_jax(env_id, kw):
    j = jmake(env_id, normalized_rl_action_space=True, **kw)
    t = tmake(env_id, device='cpu', normalized_rl_action_space=True, **kw)
    acts = np.random.default_rng(5).uniform(-1, 1, (16, t.action_space.shape[0]))
    for a in acts:
        np.testing.assert_allclose(t.denormalize_action(a), np.asarray(j.denormalize_action(a)),
                                   rtol=1e-6)
        np.testing.assert_allclose(t.normalize_action(t.denormalize_action(a)), a, atol=1e-6)
        np.testing.assert_allclose(t.normalize_action(a), np.asarray(j.normalize_action(a)),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_captured_stages_match_launched():
    """ops/qp.py's stages replayed as CUDA graphs against the same stages
    launched op by op, on random QPs at the filters' sizes."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from safe_control_gym_tpu_torch.ops.qp import admm_qp
    rng = np.random.default_rng(0)
    for B, n, m in ((1, 54, 144), (1, 86, 226), (8, 2, 3)):
        P = rng.normal(size=(n, n))
        args = [torch.tensor(a, dtype=torch.float32, device='cuda') for a in (
            P @ P.T / n + np.eye(n), rng.normal(size=(B, n)), rng.normal(size=(B, m, n)),
            -np.abs(rng.normal(size=(B, m))), np.abs(rng.normal(size=(B, m))))]
        a, b = (admm_qp(*args, iters=300, tol=1e-4, polish=True, capture=c) for c in (False, True))
        assert float((a.x - b.x).abs().max()) <= 1e-4
        np.testing.assert_array_equal(a.iterations.cpu().numpy(), b.iterations.cpu().numpy())
    # The graphs and static inputs kept are those of the last shapes alone.
    from safe_control_gym_tpu_torch.ops import qp
    assert qp._CAPTURED['shapes'][1][4] == (8, 3, 2)


@pytest.mark.gpu
def test_cuda_certification_matches_cpu():
    """One certified LQR loop (cartpole, the committed P) and one batch, the
    card's filter against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
    path = os.path.join(MODELS, 'linear_mpsc_cartpole.pkl')
    sfs = []
    for dev in ('cuda', 'cpu'):
        sf = tmake('linear_mpsc', functools.partial(tmake, 'cartpole', device=dev,
                                                    **CONSTRAINED_CARTPOLE), **MPSC_CFG)
        sf.load(path)
        sfs.append(sf)
    card, cpu = sfs
    env_func = functools.partial(tmake, 'cartpole', device='cuda', **CONSTRAINED_CARTPOLE)
    ctrl = tmake('lqr', env_func, q_lqr=[1], r_lqr=[0.1])
    steps = []
    certify = card.certify_action

    def recording(state, action, info=None):
        warm = _warm_of(card)
        out = certify(state, action, info)
        steps.append((np.array(state), np.array(action), warm, out))
        return out
    card.certify_action = recording
    BaseExperiment(env_func(), ctrl, safety_filter=card).run_evaluation(n_episodes=1,
                                                                        verbose=False)
    for state, action, warm, (u, ok) in steps:
        _set_warm(cpu, warm)
        u_c, ok_c = cpu.certify_action(state, action)
        assert ok_c == ok and np.abs(np.asarray(u_c) - u).max() <= ATOL
    u, ok = card.certify_action_batch(MPSC_STATES, MPSC_ACTIONS)
    u_c, ok_c = cpu.certify_action_batch(MPSC_STATES, MPSC_ACTIONS)
    np.testing.assert_array_equal(ok, ok_c)
    np.testing.assert_allclose(u, u_c, rtol=0, atol=ATOL)
