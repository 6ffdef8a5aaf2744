"""The port's model-based controllers (``controllers/lqr``, ``controllers/pid``)
against the JAX package's on the CPU: the registry and default configs, LQR's
gains and closed loops, iLQR's host loop, its fused solve and its batched
solve, and the cascaded PID.

Tolerances, and why:
* LQR gains: 1e-4 of the gain's largest entry. Both solve the DARE by SDA in
  float32, and on the quads that is ill-conditioned: against the float64
  gain (scipy) JAX's is off by 1.3e-4 of its largest entry on the 2D quad,
  the port's by 0.9e-4; the two differ by 5.6e-5 (2e-3 in the smallest
  entries).
* LQR closed loops, 30 steps: states and actions to 1e-4, the port's
  controller given JAX's gain, since the loop turns the gain's last digits
  into 5e-3 of state in 30 steps on the 2D quad (the gains are held above).
* iLQR (tests/test_ilqr_fused.py's env: cartpole, seed 8, 2 s at 15 Hz,
  pyb 750, goal x 0.6): costs rtol 1e-3, gains and feedforwards
  tests/test_ilqr_fused.py's rtol/atol 1e-3; iteration counts equal.
* PID, 50 steps: the JAX closed loop is recorded; the port's PID on its
  observations gives its actions, and the port's env under its actions gives
  its states, both to 1e-4. The free-running loops are not compared: at
  50 Hz control the reference PID is unstable about hover (a 1e-7 offset of
  the observation grows to 0.1-0.7 of state in 50 steps), so float32
  rounding alone separates two runs of it.
"""

import functools
import os

import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments.control_configs import control_config, load
from safe_control_gym_tpu_torch.utils.registration import get_config as tget
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
OUT = {'output_dir': 'temp/test_torch_control'}
SYSTEMS = ('cartpole', 'quadrotor_2D', 'quadrotor_3D')
# Fixed initial states off the stabilization goal (randomized_init=False).
INIT = {'cartpole': {'init_x': 0.3, 'init_theta': 0.05},
        'quadrotor_2D': {'init_x': 0.3, 'init_z': 0.8, 'init_theta': 0.1},
        'quadrotor_3D': {'init_x': 0.3, 'init_y': -0.2, 'init_z': 0.8, 'init_phi': 0.05,
                         'init_theta': -0.05}}


def _both(algo, system, task, **task_overrides):
    env_id, task_cfg, algo_cfg = control_config(algo, system, task)
    task_cfg = dict(task_cfg, **task_overrides)
    j = jmake(algo, functools.partial(jmake, env_id, **task_cfg), **algo_cfg, **OUT)
    t = tmake(algo, functools.partial(tmake, env_id, device='cpu', **task_cfg), **algo_cfg,
              **OUT)
    return j, t, env_id, task_cfg


# ---------------------------------------------------------------------------
# Registry and configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('algo', ['lqr', 'ilqr', 'pid'])
def test_registry_defaults_equal_jax(algo):
    assert tget(algo) == jget(algo)
    env_id = 'quadrotor' if algo == 'pid' else 'cartpole'
    ctrl = tmake(algo, functools.partial(tmake, env_id, device='cpu'), **tget(algo), **OUT)
    assert type(ctrl).__name__ == {'lqr': 'LQR', 'ilqr': 'iLQR', 'pid': 'PID'}[algo]
    ctrl.close()


@pytest.mark.parametrize('example', ['lqr', 'pid'])
def test_control_configs_equal_the_example_yamls(example):
    configs = load(example)
    folder = os.path.join(ROOT, 'examples', example, 'config_overrides')
    names = sorted(os.path.relpath(os.path.join(d, f), folder)[:-5]
                   for d, _, files in os.walk(folder) for f in files if f.endswith('.yaml'))
    assert sorted(configs) == names
    for name in names:
        with open(os.path.join(folder, name + '.yaml')) as f:
            assert configs[name] == yaml.safe_load(f), name


# ---------------------------------------------------------------------------
# LQR
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('task', ['stab', 'track'])
@pytest.mark.parametrize('system', SYSTEMS)
def test_lqr_gain_matches_jax(system, task):
    j, t, _, _ = _both('lqr', system, task)
    assert t.gain.shape == j.gain.shape
    assert np.abs(t.gain - j.gain).max() <= 1e-4 * np.abs(j.gain).max()


def _episode(ctrl, env, n):
    obs, info = env.reset()
    states, actions = [obs], []
    for _ in range(n):
        action = ctrl.select_action(obs, info)
        obs, _, done, info = env.step(action)
        states.append(obs)
        actions.append(action)
        if done:
            break
    return np.array(states), np.array(actions)


@pytest.mark.parametrize('system', SYSTEMS)
def test_lqr_closed_loop_matches_jax(system):
    j, t, env_id, task_cfg = _both('lqr', system, 'stab', randomized_init=False,
                                   init_state=INIT[system])
    t.gain = j.gain.copy()
    js, ja = _episode(j, jmake(env_id, **task_cfg), 30)
    ts, ta = _episode(t, tmake(env_id, device='cpu', **task_cfg), 30)
    assert ts.shape == js.shape == (31, j.model.nx)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# iLQR
# ---------------------------------------------------------------------------
ILQR_TASK = dict(seed=8, cost='quadratic', task='stabilization',
                 task_info={'stabilization_goal': [0.6, 0.0],
                            'stabilization_goal_tolerance': 0.0},
                 randomized_init=False, episode_len_sec=2, ctrl_freq=15, pyb_freq=750,
                 disturbances=None)


def _ilqr(make, **algo):
    kw = {'device': 'cpu'} if make is tmake else {}
    return make('ilqr', functools.partial(make, 'cartpole', **kw, **ILQR_TASK),
                **{**jget('ilqr'), 'max_iterations': 8, 'epsilon': 0.01, **OUT, **algo})


def _count_runs(ctrl):
    runs = []
    run = ctrl.run

    def counted(*args, **kwargs):
        runs.append(1)
        return run(*args, **kwargs)
    ctrl.run = counted
    return runs


def _close_policies(got, want):
    np.testing.assert_allclose(got.gains_fb_best, want.gains_fb_best, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.input_ff_best, want.input_ff_best, rtol=1e-3, atol=1e-3)


def test_ilqr_host_loop_matches_jax():
    j, t = _ilqr(jmake), _ilqr(tmake)
    j_runs, t_runs = _count_runs(j), _count_runs(t)
    j.learn()
    t.learn()
    assert len(t_runs) == len(j_runs) > 2
    assert t.total_cost == pytest.approx(j.total_cost, rel=1e-3, abs=1e-3)
    assert t.gains_fb_best.shape == j.gains_fb_best.shape
    _close_policies(t, j)


@functools.lru_cache(maxsize=None)
def _fused_pair():
    j, t = _ilqr(jmake, fused_solve=True), _ilqr(tmake, fused_solve=True)
    j.learn()
    t.learn()
    return j, t


def test_ilqr_learn_fused_matches_jax():
    j, t = _fused_pair()
    assert t.ite_counter == j.ite_counter > 1
    assert t.solve_aborted == j.solve_aborted
    assert t.total_cost == pytest.approx(j.total_cost, rel=1e-3, abs=1e-3)
    _close_policies(t, j)


def test_ilqr_solve_batch_matches_jax_and_the_single_solve():
    j, t = _fused_pair()
    nominal = np.asarray(t.env._nominal_init_state(), np.float32)
    x0s = nominal + np.random.default_rng(0).uniform(-0.2, 0.2, (8, 4)).astype(np.float32)
    x0s[0] = nominal
    want, got = j.solve_batch(x0s), t.solve_batch(x0s)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    for k in ('converged', 'aborted', 'iterations'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ('cost', 'cost_curves', 'gains_fb', 'input_ff'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3, err_msg=k)
    # Row 0 starts from the nominal state: the single solve's.
    assert got['cost'][0] == pytest.approx(t.total_cost, rel=1e-4, abs=1e-4)
    assert got['iterations'][0] == t.ite_counter
    np.testing.assert_allclose(got['gains_fb'][0], t.gains_fb_best, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('system', ['quadrotor_2D', 'quadrotor_3D'])
def test_ilqr_backward_pass_matches_jax(system):
    """The backward pass of the quads (H 2 x 2 in closed form, 4 x 4 by eigh)
    on a random trajectory about hover (numpy seed 0, T=12, lamb 1 and 10),
    against JAX's: gains and feedforwards rtol/atol 1e-3."""
    j, t, _, _ = _both('ilqr', system, 'stab')
    rng = np.random.default_rng(0)
    nx, nu, T = t.model.nx, t.model.nu, 12
    states = (np.asarray(t.env.X_GOAL) + rng.uniform(-0.3, 0.3, (T, nx))).astype(np.float32)
    inputs = (np.atleast_1d(t.model.U_EQ) * rng.uniform(0.8, 1.2, (T, nu))).astype(np.float32)
    goals, goal_term = (g.numpy() for g in t._goal_sequences(T))
    for lamb in (1.0, 10.0):
        K, ff, ok = (np.asarray(a) for a in j._backward_jit(states, inputs, goals, goal_term,
                                                             np.float32(lamb)))
        tK, tff, tok = t._backward(torch.tensor(states)[None], torch.tensor(inputs)[None],
                                   torch.tensor(goals), torch.tensor(goal_term),
                                   torch.tensor([lamb]))
        assert bool(tok[0]) == bool(ok)
        np.testing.assert_allclose(tK[0].numpy(), K, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(tff[0].numpy(), ff, rtol=1e-3, atol=1e-3)


def test_ilqr_fused_solve_replays_one_noise_draw():
    """With white action noise, the fused solve draws the noise once from the
    env's generator and replays it every iteration: re-seeding the env
    repeats the solve exactly, and the best policies, rolled out under the
    draw a re-seeded env gives, cost what the solve reports (its best came
    from a later iteration than the first, under the same noise)."""
    noisy = dict(ILQR_TASK, disturbances={'action': [{'disturbance_func': 'white_noise',
                                                      'std': 0.5}]})
    t = tmake('ilqr', functools.partial(tmake, 'cartpole', device='cpu', **noisy),
              **{**jget('ilqr'), 'max_iterations': 3, 'fused_solve': True, **OUT})
    x0s = np.repeat(np.asarray(t.env._nominal_init_state(), np.float32)[None], 2, axis=0)
    t.env.seed(5)
    first = t.solve_batch(x0s)
    t.env.seed(5)
    again = t.solve_batch(x0s)
    for k in first:
        np.testing.assert_array_equal(first[k], again[k], err_msg=k)
    assert first['cost_curves'][0, 0] != first['cost_curves'][1, 0]   # per-row draws
    assert (first['cost'] < first['cost_curves'][:, 0]).all()
    t.env.seed(5)
    replay = t.evaluate_batch(x0s, first['gains_fb'], first['input_ff'])
    np.testing.assert_allclose(replay, first['cost'], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# PID
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('task', ['stab', 'track'])
@pytest.mark.parametrize('system', ['quadrotor_2D', 'quadrotor_3D'])
def test_pid_matches_jax(system, task):
    init = INIT[system] if task == 'stab' else \
        control_config('pid', system, task)[1].get('init_state', {'init_z': 1.0})
    j, t, env_id, task_cfg = _both('pid', system, task, randomized_init=False,
                                   init_state=init)
    jenv, tenv = jmake(env_id, **task_cfg), tmake(env_id, device='cpu', **task_cfg)
    obs, info = jenv.reset()
    t_obs, _ = tenv.reset()
    np.testing.assert_array_equal(t_obs, obs)
    for _ in range(50):
        action = j.select_action(obs, info)
        np.testing.assert_allclose(t.select_action(obs, info), action, rtol=0, atol=1e-4)
        obs, _, done, info = jenv.step(action)
        t_obs, _, t_done, _ = tenv.step(action)
        np.testing.assert_allclose(t_obs, obs, rtol=0, atol=1e-4)
        assert t_done == done
        if done:
            break
    np.testing.assert_allclose(t.integral_pos_e, j.integral_pos_e, rtol=0, atol=1e-6)


def test_pid_prior_prop_sets_the_thrust_of_gravity():
    j, t, _, _ = _both('pid', 'quadrotor_3D', 'stab', randomized_init=False)
    assert t.GRAVITY == j.GRAVITY
    assert t.model.quad_mass == j.model.quad_mass == 0.027


def test_controllers_run_on_the_envs_device():
    """The model and the solves follow the env's device (the CUDA default and
    its error without a card: tests/test_torch_import.py)."""
    t = tmake('ilqr', functools.partial(tmake, 'cartpole', device='cpu'), **tget('ilqr'), **OUT)
    assert t.device.type == 'cpu' and t.model.device.type == 'cpu'
    assert t.model.df_func(np.zeros(4), np.zeros(1))['dfdx'].device.type == 'cpu'
