"""The plain reference against the port at a size the CPU holds: the
parameter vectors it works out again, the start states it draws again, and
whole runs of every cell, whose checks compare the port's answers with it."""


import numpy as np
import pytest
import torch

from conftest import SMALL, small_config
from gpubench.harness import core
from gpubench.reference import envcfg
from gpubench.run import run_cell


def _env(config_name, overrides=None):
    from safe_control_gym_tpu_torch.utils.registration import make
    cfg = core.config(config_name)
    task = {**cfg['task_config'], **(overrides or {})}
    return make(cfg['env'], device='cpu', **task), task


@pytest.mark.parametrize('config_name', ['cartpole_ppo', 'quadrotor_3D_ppo'])
def test_parameter_vector_matches_the_port(config_name):
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    env, task = _env(config_name)
    system = core.config(config_name)['system']
    prog = (rk.cartpole_rollout_cfg if system == 'cartpole' else rk.quad_rollout_cfg)(env)
    np.testing.assert_array_equal(envcfg.CFGS[system](task), prog.numpy())
    assert envcfg.substeps(task) == (env.PYB_STEPS_PER_CTRL, env.PYB_TIMESTEP)
    env.close()


def test_start_states_match_the_port():
    from gpubench.drivers.closed_loop_eval import reference_starts
    env, task = _env('cartpole_ppo')
    est, _ = env.func.reset_batch(torch.Generator().manual_seed(123), 50)
    np.testing.assert_array_equal(
        reference_starts('cartpole', task, 50, 123, torch.device('cpu')).numpy(),
        est.state.numpy())
    env.close()


def test_quad_reset_matches_the_port():
    from gpubench.reference.ppo import Quad3D
    env, task = _env('quadrotor_3D_ppo')
    est, _ = env.func.reset_batch(torch.Generator().manual_seed(9), 40)
    x0, step = Quad3D(task, torch.device('cpu')).reset(torch.Generator().manual_seed(9), 40)
    np.testing.assert_array_equal(x0.numpy(), est.state.numpy())
    env.close()


@pytest.mark.parametrize('cell', sorted(SMALL))
def test_cell_is_correct_against_the_reference(cell):
    result, checks = run_cell(cell, 2 ** 31 + 12345, 0.3, False, device='cpu',
                              params=SMALL[cell], config=small_config(cell))
    assert result['correct'], [(c.name, c.value) for c in checks]
    assert checks and all(c.value == 0.0 for c in checks)
    assert result['attempted'] >= 1


def test_philox_matches_the_port():
    from gpubench.reference.rollout import philox_uniforms
    from safe_control_gym_tpu_torch.ops.rollout_kernels import philox_uniform4
    envs = np.array([0, 5, 77, 4095])
    got = philox_uniforms([2 ** 32 + 7] * 4, envs, 3, 2)
    for t in range(3):
        want = philox_uniform4(2 ** 32 + 7, torch.as_tensor(envs), t, 2)
        np.testing.assert_array_equal(got[t], torch.stack(want, 1).numpy())
