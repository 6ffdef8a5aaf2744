"""The port's MPC family (``safe_control_gym_tpu_torch/controllers/mpc``)
against the JAX package's on the CPU: the registry and configs, the first
solves, warm-started closed loops, the batched solve and MPC_ACADOS's
semantics.

Configs: ``examples/mpc/config_overrides`` (their JSON copies in
``experiments/control_configs/mpc.json``) at horizon 10: ``mpc`` on the
cartpole stabilization (3 SQP iterations, 50 substeps), ``linear_mpc`` on
the 2D quadrotor tracking (BASELINE.json's config, 20 substeps) and
``mpc_acados`` with RTI on the cartpole.

Tolerances, and why:
* First solve: the horizon's states and inputs to 1e-4 (both solve the same
  float32 QPs to the same polished optimum; sums in another order).
* Closed loop, 20 steps: the JAX loop runs; before each step the port's
  controller takes JAX's observation and warm start (its previous horizon
  and the QP's z, y), and its action must be JAX's to 1e-4. A free-running
  comparison would add each step's rounding to the next step's state. On a
  few steps JAX's own action moves by more than 1e-4 when its observation
  changes by 1e-7 relative (linear MPC on the 2D track: 1.0e-4, 2.8e-4
  and 1.1e-4 at steps 2, 7 and 8): ADMM exits at its tolerance, and the
  polish's candidates are accepted only if they lower both residuals,
  which compares dual residuals at float32's floor (1.8791e-6 against
  1.8789e-6), so rounding picks the candidate. There the port's action
  must be one of JAX's answers to those 16 changed observations, to 1e-4;
  everywhere else JAX's own to 1e-4.
* ``select_action_batch`` on 8 states (examples/mpc/batched_mpc_demo.py's
  cartpole, uniform +-0.3 from numpy seed 0): actions to 1e-4, feasibility
  flags equal.
* ``select_action_scenarios``: each scenario's candidate against its problem
  solved alone with the parameters shared, to 1e-4 (against JAX's:
  tests/test_torch_gp_mpc.py).
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_tpu.controllers.mpc import mpc_utils as jutils
from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.controllers.mpc import mpc_utils as tutils
from safe_control_gym_tpu_torch.controllers.mpc.mpc import MPC as TMPC
from safe_control_gym_tpu_torch.envs.dynamics import CartPoleParams, cartpole_dynamics, rk4_step
from safe_control_gym_tpu_torch.experiments.control_configs import control_config, load
from safe_control_gym_tpu_torch.utils.registration import get_config as tget
from safe_control_gym_tpu_torch.parallel.launch import spawn_local
from safe_control_gym_tpu_torch.utils.registration import make as tmake
from tests import torch_sharding_ranks


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = {'output_dir': 'temp/test_torch_mpc'}
ATOL = 1e-4
HORIZON = 10
STEPS = 20
PERTURBED = 16
LOOPS = {'mpc': ('cartpole', 'stab'), 'linear_mpc': ('quadrotor_2D', 'track'),
         'mpc_acados': ('cartpole', 'stab')}
# examples/mpc/batched_mpc_demo.py's problem.
DEMO_TASK = dict(seed=0, cost='quadratic', ctrl_freq=15, pyb_freq=750,
                 constraints=[{'constraint_form': 'default_constraint',
                               'constrained_variable': 'input'}],
                 task_info={'stabilization_goal': [0.0], 'stabilization_goal_tolerance': 0.01},
                 randomized_init=False)


def _both(algo, env_id, task_cfg, **algo_cfg):
    j = jmake(algo, functools.partial(jmake, env_id, **task_cfg), **algo_cfg, **OUT)
    t = tmake(algo, functools.partial(tmake, env_id, device='cpu', **task_cfg), **algo_cfg,
              **OUT)
    j.reset()
    t.reset()
    return j, t


def _set_warm(ctrl, warm):
    """A controller's warm start (previous horizon, inputs and QP z, y), or
    none."""
    ctrl.x_prev, ctrl.u_prev, ctrl._qp_warm = warm if warm is not None else (None,) * 3


@functools.lru_cache(maxsize=None)
def _loop(algo):
    """JAX's controller run for STEPS steps, with what the port needs to
    repeat each step (the observation and info, and the warm start), and
    JAX's own answers to the step's observation changed by 1e-7 relative
    (PERTURBED draws from numpy seed 1)."""
    system, task = LOOPS[algo]
    env_id, task_cfg, algo_cfg = control_config(algo, system, task)
    j, t = _both(algo, env_id, task_cfg, **dict(algo_cfg, horizon=HORIZON))
    env = jmake(env_id, **task_cfg)
    obs, info = env.reset()
    rng = np.random.default_rng(1)
    steps = []
    for _ in range(STEPS):
        warm = None if j.x_prev is None else (j.x_prev.copy(), np.array(j.u_prev),
                                              tuple(np.asarray(a) for a in j._qp_warm))
        perturbed = []
        for _ in range(PERTURBED):
            _set_warm(j, warm)
            noise = 1 + 1e-7 * rng.standard_normal(obs.shape)
            perturbed.append(j.select_action((obs * noise).astype(np.float32), info))
        _set_warm(j, warm)
        action = j.select_action(obs, info)
        steps.append(dict(obs=obs, info=info, warm=warm, action=action,
                          perturbed=np.array(perturbed), x=j.x_prev.copy(),
                          u=np.array(j.u_prev)))
        obs, _, done, info = env.step(action)
        assert not done
    return j, t, steps


# ---------------------------------------------------------------------------
# Registry and configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('algo', ['mpc', 'linear_mpc', 'mpc_acados', 'gp_mpc'])
def test_registry_defaults_equal_jax(algo):
    assert tget(algo) == jget(algo)
    ctrl = tmake(algo, functools.partial(tmake, 'cartpole', device='cpu'), **tget(algo), **OUT)
    assert type(ctrl).__name__ == {'mpc': 'MPC', 'linear_mpc': 'LinearMPC',
                                   'mpc_acados': 'MPC_ACADOS', 'gp_mpc': 'GPMPC'}[algo]
    assert ctrl.device.type == 'cpu'
    ctrl.close()


def test_mpc_configs_equal_the_example_yamls():
    configs = load('mpc')
    folder = os.path.join(ROOT, 'examples', 'mpc', 'config_overrides')
    names = sorted(os.path.relpath(os.path.join(d, f), folder)[:-5]
                   for d, _, files in os.walk(folder) for f in files if f.endswith('.yaml'))
    assert sorted(configs) == names
    for name in names:
        with open(os.path.join(folder, name + '.yaml')) as f:
            assert configs[name] == yaml.safe_load(f), name


# ---------------------------------------------------------------------------
# Solves and closed loops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('algo', ['mpc', 'linear_mpc'])
def test_first_solve_matches_jax(algo):
    j, t, steps = _loop(algo)
    t.reset_before_run()
    first = steps[0]
    action = t.select_action(first['obs'], first['info'])
    assert t._n_z == j._n_z and t._m_rows == j._m_rows
    assert t.x_prev.shape == first['x'].shape == (t.model.nx, HORIZON + 1)
    np.testing.assert_allclose(t.x_prev, first['x'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(t.u_prev), first['u'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(action, first['action'], rtol=0, atol=ATOL)
    assert t.results_dict['t_wall'] and not t.terminate_loop


@pytest.mark.parametrize('algo', ['mpc', 'linear_mpc', 'mpc_acados'])
def test_closed_loop_matches_jax(algo):
    _, t, steps = _loop(algo)
    t.reset_before_run()
    errs, spreads = [], []
    for step in steps:
        _set_warm(t, step['warm'])
        action = t.select_action(step['obs'], step['info'])
        answers = np.vstack([step['action'][None], step['perturbed']])
        errs.append(np.abs(answers - action).max(axis=1))
        spreads.append(np.abs(step['perturbed'] - step['action']).max())
    errs, spreads = np.array(errs), np.array(spreads)
    # Where JAX's own answer holds under 1e-7 changes of its input, the
    # port's is JAX's to ATOL; where JAX's moves (its polish takes another
    # candidate: see the module docstring), the port's is one of JAX's
    # answers to ATOL. Such steps are a few: at most a quarter.
    steady = spreads <= ATOL
    assert (errs[steady, 0] <= ATOL).all(), (errs[:, 0], spreads)
    assert (errs.min(axis=1) <= ATOL).all(), (errs.min(axis=1), spreads)
    assert steady.mean() >= 0.75, spreads
    assert not t.terminate_loop


def test_select_action_batch_matches_jax():
    j, t = _both('mpc', 'cartpole', DEMO_TASK, q_mpc=[1], r_mpc=[0.1], horizon=HORIZON,
                 sqp_iters=3)
    x0s = np.random.default_rng(0).uniform(-0.3, 0.3, (8, 4)).astype(np.float32)
    u_t, f_t = t.select_action_batch(x0s)
    u_j, f_j = j.select_action_batch(x0s)
    assert u_t.shape == (8, 1) and f_t.dtype == bool
    np.testing.assert_allclose(u_t, np.asarray(u_j), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(f_t, f_j)
    # One problem of the batch solved alone through select_action.
    t.reset_before_run()
    a = t.select_action(x0s[3])
    np.testing.assert_allclose(a, u_t[3], rtol=0, atol=ATOL)


def test_run_returns_the_results_dict():
    env_id, task_cfg, algo_cfg = control_config('mpc_acados', 'cartpole', 'stab')
    t = tmake('mpc_acados', functools.partial(tmake, env_id, device='cpu', **task_cfg),
              **dict(algo_cfg, horizon=HORIZON), **OUT)
    t.reset()
    res = t.run(max_steps=5)
    assert res['action'].shape == (5, 1) and res['state'].shape == (6, 4)
    assert len(res['t_wall']) == 5 and len(res['state_error']) == 5
    rmse, total = res['total_rmse_state_error']
    r2, t2 = tutils.compute_state_rmse(res['state'])
    np.testing.assert_array_equal(rmse, r2)
    assert total == t2


def test_unported_paths_raise(tmp_path):
    """``MPC.shard_over`` on two gloo ranks, and GP-MPC's, which inherits the
    split of its batch: a batch of 3 problems does not divide over them and
    raises ValueError on each rank, as the JAX package's placement refuses
    it."""
    messages = spawn_local(torch_sharding_ranks.mpc_indivisible, 2, args=(str(tmp_path),))
    assert [len(m) for m in messages] == [2, 2], messages
    assert all('a batch of 3 does not divide' in m for ms in messages for m in ms), messages


class _ScenarioMPC(TMPC):
    """MPC whose RK4 dynamics take the cartpole's parameters as an argument
    (examples/mpc/scenario_mpc_demo.py's controller)."""

    def dynamics_func_param(self, x, u, p):
        return rk4_step(cartpole_dynamics, x, u, self.dt, CartPoleParams(**p))


def test_select_action_scenarios_solves_each_scenario():
    """Each scenario's candidate is its problem solved alone with the
    parameters shared (the per-problem path against the shared one), to
    ATOL, flags equal; an MPC without the hook refuses. (JAX's scenarios:
    tests/test_torch_gp_mpc.py.)"""
    ctrl = _ScenarioMPC(functools.partial(tmake, 'cartpole', device='cpu', **DEMO_TASK),
                        q_mpc=[1], r_mpc=[0.1], horizon=5, sqp_iters=2, **OUT)
    ctrl.reset()
    n = 3
    scen = dict(pole_length=np.array([0.4, 0.5, 0.9], np.float32),
                pole_mass=np.full(n, 0.1, np.float32), cart_mass=np.full(n, 1.0, np.float32),
                gravity=np.full(n, 9.8, np.float32))
    x = np.array([0.1, 0.0, 0.2, 0.0], np.float32)
    u, feasible = ctrl.select_action_scenarios(x, scen)
    assert u.shape == (n, 1) and feasible.all()
    for b in range(n):
        ctrl.dynamics_params = {k: torch.tensor(v[b]) for k, v in scen.items()}
        u_b, f_b = ctrl.select_action_batch(x[None])
        np.testing.assert_allclose(u[b], u_b[0], rtol=0, atol=ATOL)
        assert f_b[0] == feasible[b]
    assert np.abs(u[0] - u[2]).max() > 10 * ATOL     # the scenarios differ
    plain = tmake('mpc', functools.partial(tmake, 'cartpole', device='cpu'), horizon=3, **OUT)
    plain.reset()
    with pytest.raises(ValueError, match='dynamics_func_param'):
        plain.select_action_scenarios(x, scen)


# ---------------------------------------------------------------------------
# MPC_ACADOS
# ---------------------------------------------------------------------------
def test_acados_linear_ls_hessian_matches_jax():
    """tests/test_mpc_acados.py's check: stage blocks Q/dt and R/dt, the
    terminal block the unscaled Q; the whole Hessian equal to JAX's."""
    env_id, task_cfg, _ = control_config('mpc_acados', 'cartpole', 'stab')
    j, t = _both('mpc_acados', env_id, task_cfg, horizon=4, q_mpc=[2, 1, 2, 1], r_mpc=[0.5],
                 seed=0)
    nx, nu, T, dt = t.model.nx, t.model.nu, t.T, t.dt
    P = t._P_qp.numpy()
    for k in range(T):
        np.testing.assert_allclose(P[k * nx:(k + 1) * nx, k * nx:(k + 1) * nx], t.Q / dt,
                                   rtol=1e-5)
    np.testing.assert_allclose(P[T * nx:(T + 1) * nx, T * nx:(T + 1) * nx], t.Q, rtol=1e-5)
    ofs = (T + 1) * nx
    for k in range(T):
        np.testing.assert_allclose(P[ofs + k * nu:ofs + (k + 1) * nu,
                                     ofs + k * nu:ofs + (k + 1) * nu], t.R / dt, rtol=1e-5)
    np.testing.assert_array_equal(P, np.asarray(j._P_qp))
    np.testing.assert_array_equal(t._A_base.numpy(), np.asarray(j._A_base))


@pytest.mark.parametrize('use_rti', [True, False])
def test_acados_rti_sets_the_sqp_iterations(use_rti):
    t = tmake('mpc_acados', functools.partial(tmake, 'cartpole', device='cpu'), horizon=3,
              use_RTI=use_rti, **OUT)
    assert t.sqp_iters == (1 if use_rti else 5) and t.use_RTI is use_rti


def test_acados_checks_erk_and_boxes():
    env_func = functools.partial(tmake, 'cartpole', device='cpu')
    with pytest.raises(ValueError, match='ERK'):
        tmake('mpc_acados', env_func, integrator_type='IRK', **OUT)
    quad = [{'constraint_form': 'quadratic_constraint', 'constrained_variable': 'state',
             'P': np.eye(4).tolist(), 'b': 1.0}]
    with pytest.raises(ValueError, match='BoundedConstraint'):
        tmake('mpc_acados', env_func, additional_constraints=quad, **OUT)
    tmake('mpc', env_func, additional_constraints=quad, **OUT)


# ---------------------------------------------------------------------------
# mpc_utils
# ---------------------------------------------------------------------------
def test_mpc_utils_match_jax():
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((4, 4)) * 0.5).astype(np.float32)
    B = rng.standard_normal((4, 1)).astype(np.float32)
    Q, R = np.eye(4), np.eye(1) * 0.1
    jg, jA, jB, jP = jutils.compute_discrete_lqr_gain_from_cont_linear_system(A, B, Q, R, 0.05)
    tg, tA, tB, tP = tutils.compute_discrete_lqr_gain_from_cont_linear_system(
        torch.tensor(A), torch.tensor(B), Q, R, 0.05)
    np.testing.assert_allclose(tA, np.asarray(jA), rtol=1e-6)
    np.testing.assert_allclose(tP, np.asarray(jP), rtol=0, atol=1e-4 * np.abs(jP).max())
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-4 * np.abs(jg).max())
    fc_j = lambda x, u: jnp.tanh(jnp.asarray(A) @ x) + jnp.asarray(B) @ u
    fc_t = lambda x, u: torch.tanh(torch.tensor(A) @ x) + torch.tensor(B) @ u
    x, u = rng.standard_normal(4).astype(np.float32), rng.standard_normal(1).astype(np.float32)
    np.testing.assert_allclose(
        tutils.rk_discrete(fc_t, 4, 1, 0.1)(torch.tensor(x), torch.tensor(u)).numpy(),
        np.asarray(jutils.rk_discrete(fc_j, 4, 1, 0.1)(jnp.asarray(x), jnp.asarray(u))),
        rtol=0, atol=1e-6)
    err = rng.standard_normal((30, 4))
    for a, b in zip(tutils.compute_state_rmse(err), jutils.compute_state_rmse(err)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_reset_constraints_refuses_state_and_input_constraints():
    env = tmake('cartpole', device='cpu')
    from safe_control_gym_tpu_torch.envs.constraints import LinearConstraint
    con = LinearConstraint(env, np.ones((1, 5)), np.ones(1), 'input_and_state')
    with pytest.raises(NotImplementedError):
        tutils.reset_constraints([con])
    lst, state_fns, input_fns = tutils.reset_constraints(
        [LinearConstraint(env, np.ones((1, 4)), np.ones(1), 'state')])
    assert len(lst) == 1 and len(state_fns) == 1 and not input_fns
