"""The port's example entry points (``safe_control_gym_tpu_torch/examples``)
against the JAX package's scripts under ``examples/``, on the CPU.

Each test runs the port's ``run()`` with ``--device cpu`` and the JAX
script's ``run()`` on the same command line, cut as the JAX package's own
tests cut it (``n_steps=10``, ``algo_config.horizon=10``,
``algo_config.max_iterations=2``), and holds the metrics (the same keys, the
values within 1e-4) or the printed arrays to each other. The JAX scripts are
loaded from their files under module names of their own
(``importlib.util.spec_from_file_location``), never by putting
``examples/<dir>`` on ``sys.path``: the JAX package's tests import the same
scripts by their bare names, and a worker may run both files.

The initial states of ``randomized_init`` tasks come from each package's own
random stream (torch's generator against JAX's PRNG, which the port does not
reproduce), so the cells of such tasks run with
``task_config.randomized_init=False`` on both sides (the RL and CBF cells
from a fixed state off the goal: a stabilization episode that starts at its goal
ends at its reset).
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, 'examples')
ATOL = 1e-4


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def load_jax_example(rel):
    """The JAX package's script ``examples/<rel>`` as a module named after
    its path (loaded once)."""
    name = '_jax_example_' + rel[:-len('.py')].replace('/', '_')
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, rel))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def overrides(directory, system, *names):
    return [os.path.join(EXAMPLES, directory, 'config_overrides', system, n) for n in names]


def run_both(monkeypatch, jax_run, port_run, argv, **kw):
    """``(jax_out, port_out)`` of the two ``run`` functions on ``argv`` (the
    port's with ``--device cpu``)."""
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv)
    jax_out = jax_run(**kw)
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv + ['--device', 'cpu'])
    return jax_out, port_run(**kw)


def assert_same_metrics(jax_metrics, port_metrics, atol=ATOL):
    assert set(port_metrics) == set(jax_metrics)
    for key, want in jax_metrics.items():
        np.testing.assert_allclose(np.asarray(port_metrics[key], np.float64),
                                   np.asarray(want, np.float64), rtol=atol, atol=atol,
                                   err_msg=key)


def test_verbose_api_prints_jax_arrays(monkeypatch, capsys):
    from safe_control_gym_tpu_torch.examples.no_controller import verbose_api
    argv = ['--task', 'cartpole', '--overrides',
            os.path.join(EXAMPLES, 'no_controller', 'config_overrides',
                         'verbose_api_cartpole.yaml'),
            '--kv_overrides', 'task_config.randomized_init=False']
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv)
    load_jax_example('no_controller/verbose_api.py').run()
    jax_text = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv + ['--device', 'cpu'])
    out = verbose_api.run()
    port_text = capsys.readouterr().out

    def numbers(text):
        # The model, constraint and step sections, up to the info dict.
        body = text[text.index('nx, nu, ny:'):text.index('info:')]
        body = re.sub(r'^[^:\n]*:', '', body, flags=re.M)
        return np.array([float(v) for v in re.findall(
            r'[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?|True|False', body)
            if v not in ('True', 'False')])

    assert 'ANALYTIC' in port_text and 'dfdx' in port_text
    want, got = numbers(jax_text), numbers(port_text)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(out['dfdx'], np.array([[0, 1, 0, 0], [0, 0, -0.7171, 0],
                                                      [0, 0, 0, 1], [0, 0, 15.7756, 0]]),
                               atol=1e-3)


@pytest.mark.parametrize('system,algo', [('cartpole', 'lqr'), ('quadrotor_3D', 'lqr')])
def test_lqr_experiment_matches_jax(system, algo, monkeypatch):
    from safe_control_gym_tpu_torch.examples.lqr import lqr_experiment
    task = 'quadrotor' if 'quadrotor' in system else system
    argv = ['--algo', algo, '--task', task, '--overrides',
            *overrides('lqr', system, f'{system}_stab.yaml', f'{algo}_{system}_stab.yaml'),
            '--kv_overrides', 'algo_config.max_iterations=2', 'task_config.randomized_init=False']
    (jt, jm), (pt, pm) = run_both(monkeypatch, load_jax_example('lqr/lqr_experiment.py').run,
                                  lqr_experiment.run, argv, n_episodes=None, n_steps=10)
    assert_same_metrics(jm, pm)
    np.testing.assert_allclose(np.concatenate(pt['action']), np.concatenate(jt['action']),
                               atol=ATOL)


def test_pid_custom_waypoints_match_jax(monkeypatch):
    """The 3D custom-waypoint cell: ``set_reference`` on the port's env."""
    from safe_control_gym_tpu_torch.examples.pid import pid_experiment
    argv = ['--algo', 'pid', '--task', 'quadrotor', '--overrides',
            *overrides('pid', 'quadrotor_3D', 'quadrotor_3D_track.yaml',
                       'pid_quadrotor_3D_track.yaml'),
            '--kv_overrides', 'task_config.task_info.trajectory_type=custom']
    (jt, jm), (pt, pm) = run_both(monkeypatch, load_jax_example('pid/pid_experiment.py').run,
                                  pid_experiment.run, argv, n_episodes=None, n_steps=10)
    assert_same_metrics(jm, pm)
    np.testing.assert_allclose(np.concatenate(pt['obs']), np.concatenate(jt['obs']), atol=ATOL)


@pytest.mark.parametrize('algo', ['linear_mpc', 'mpc_acados'])
def test_mpc_experiment_matches_jax(algo, monkeypatch):
    from safe_control_gym_tpu_torch.examples.mpc import mpc_experiment
    argv = ['--algo', algo, '--task', 'cartpole', '--overrides',
            *overrides('mpc', 'cartpole', 'cartpole_stab.yaml', f'{algo}_cartpole_stab.yaml'),
            '--kv_overrides', 'algo_config.horizon=10']
    (jt, jm), (pt, pm) = run_both(monkeypatch, load_jax_example('mpc/mpc_experiment.py').run,
                                  mpc_experiment.run, argv, n_episodes=None, n_steps=10)
    assert_same_metrics(jm, pm)
    np.testing.assert_allclose(np.concatenate(pt['action']), np.concatenate(jt['action']),
                               atol=ATOL)


@pytest.mark.parametrize('system,algo', [('cartpole', 'ppo'), ('quadrotor_2D', 'sac')])
def test_rl_experiment_on_committed_models_matches_jax(system, algo, monkeypatch):
    from safe_control_gym_tpu_torch.examples.rl import rl_experiment
    task = 'quadrotor' if 'quadrotor' in system else system
    argv = ['--algo', algo, '--task', task, '--overrides',
            *overrides('rl', system, f'{system}_stab.yaml', f'{algo}_{system}.yaml'),
            '--kv_overrides', 'algo_config.training=False', 'task_config.randomized_init=False',
            "task_config.init_state={'init_x': 0.1, 'init_theta': 0.05}"]
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv)
    jt, jm = load_jax_example('rl/rl_experiment.py').run(
        n_episodes=None, n_steps=10, curr_path=os.path.join(EXAMPLES, 'rl'))
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv + ['--device', 'cpu'])
    pt, pm = rl_experiment.run(n_episodes=None, n_steps=10)    # examples/rl by default
    assert_same_metrics(jm, pm)
    np.testing.assert_allclose(np.concatenate(pt['action']), np.concatenate(jt['action']),
                               atol=ATOL)


def test_mpsc_experiment_on_the_committed_filter_matches_jax(monkeypatch):
    from safe_control_gym_tpu_torch.examples.mpsc import mpsc_experiment
    argv = ['--task', 'cartpole', '--algo', 'lqr', '--safety_filter', 'linear_mpsc',
            '--overrides', *overrides('mpsc', 'cartpole', 'cartpole_stab.yaml',
                                      'lqr_cartpole.yaml', 'linear_mpsc_cartpole.yaml'),
            '--kv_overrides', 'sf_config.cost_function=one_step_cost']
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv)
    jax_u, jax_c = load_jax_example('mpsc/mpsc_experiment.py').run(
        training=False, n_episodes=None, n_steps=5, curr_path=os.path.join(EXAMPLES, 'mpsc'))
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv + ['--device', 'cpu'])
    port_u, port_c = mpsc_experiment.run(training=False, n_episodes=None, n_steps=5)
    assert_same_metrics(jax_u, port_u)
    assert_same_metrics(jax_c, port_c)


def test_cbf_experiment_matches_jax(monkeypatch):
    from safe_control_gym_tpu_torch.examples.cbf import cbf_experiment
    argv = ['--algo', 'lqr', '--task', 'cartpole', '--safety_filter', 'cbf', '--overrides',
            *overrides('cbf', 'cartpole', 'cartpole_stab.yaml', 'lqr_cartpole_stab.yaml',
                       'cbf_cartpole_stab.yaml'),
            '--kv_overrides', 'task_config.randomized_init=False',
            "task_config.init_state={'init_x': 0.1, 'init_theta': 0.05}"]
    (jt, jm), (pt, pm) = run_both(monkeypatch, load_jax_example('cbf/cbf_experiment.py').run,
                                  cbf_experiment.run, argv, training=False, n_episodes=None,
                                  n_steps=10)
    assert_same_metrics(jm, pm)
    np.testing.assert_allclose(np.concatenate(pt['safety_filter_data']['correction']),
                               np.concatenate(jt['safety_filter_data']['correction']),
                               atol=ATOL)
