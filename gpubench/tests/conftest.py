"""The benchmark's CPU tests: the harness at sizes the CPU holds, with the
kernels' plain versions in place of the card. Tests that need the card carry
the ``gpu`` marker and skip inside the test without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# Sizes the CPU holds, merged over each cell's traffic parameters.
SMALL = {
    'quadrotor_3D_ppo.sim_open': dict(batch=64, n_steps=30, check_launches=2, check_envs=16),
    'cartpole_ppo.sim_open': dict(batch=64, n_steps=30, check_launches=2, check_envs=16),
    'cartpole_ppo.eval_policy': dict(batch=64, n_steps=30, check_calls=2, check_envs=16,
                                     use_kernel=True),
    'quadrotor_3D_ppo.train': {},
}


def small_config(cell):
    """The cell's configuration, with PPO's batch cut for the CPU."""
    from gpubench.harness import core
    cfg = core.config(core.workload(cell)['config'])
    if cell.endswith('.train'):
        cfg['algo_config'].update(rollout_batch_size=32, rollout_steps=8, mini_batch_size=64,
                                  opt_epochs=2)
    return cfg
