"""Each cell's ``correct`` fails its lower-precision control and every
planted fault the cell can have, at a size the CPU holds. The same readings
at each cell's own size come from ``python -m gpubench.controls`` on the
card."""

import pytest
import torch

from conftest import SMALL, small_config
from gpubench import controls

ROLLOUT_CELLS = ['quadrotor_3D_ppo.sim_open', 'cartpole_ppo.sim_open',
                 'cartpole_ppo.eval_policy']


@pytest.mark.parametrize('cell', ROLLOUT_CELLS)
def test_bfloat16_control_fails(cell):
    checks = controls.control(cell, 21, 'cpu', params=SMALL[cell], seconds=0.1)
    assert any(not c.passed for c in checks)


@pytest.mark.parametrize('fault', controls.FAULTS)
@pytest.mark.parametrize('cell', ROLLOUT_CELLS + ['quadrotor_3D_ppo.train'])
def test_planted_fault_fails(cell, fault):
    checks = controls.fault(cell, 22, 'cpu', fault, params=SMALL[cell],
                            config=small_config(cell), seconds=0.1)
    assert any(not c.passed for c in checks), [(c.name, c.value) for c in checks]


@pytest.mark.gpu
def test_tf32_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: TF32 exists only on the card')
    cell = 'quadrotor_3D_ppo.train'
    checks = controls.control(cell, 23, 'cuda', config=small_config(cell), seconds=0.1)
    assert any(not c.passed for c in checks)


@pytest.mark.parametrize('fault', controls.FAULTS)
def test_fault_in_the_window_alone_fails(fault):
    """A training fault that starts after set-up's checked iterations: only
    the window's checked iteration can see it."""
    cell = 'quadrotor_3D_ppo.train'
    checks = controls.fault(cell, 24, 'cpu', fault, config=small_config(cell), seconds=0.1,
                            late=True)
    assert any(not c.passed for c in checks), [(c.name, c.value) for c in checks]


@pytest.mark.parametrize('cell', ROLLOUT_CELLS + ['quadrotor_3D_ppo.train'])
def test_float64_witness_passes(cell):
    """The limits leave room above what a change of every rounding moves."""
    checks, _ = controls.readings(cell, 25, 'cpu', ('float64',), params=SMALL[cell],
                                  config=small_config(cell), seconds=0.1)['float64']
    assert all(c.passed for c in checks), [(c.name, c.value) for c in checks]


def test_rollout_rows_count_as_mismatched():
    """A row is mismatched by one step's reward more, a state that is not
    finite or a done count off by one; not by rounding."""
    import numpy as np
    from gpubench.drivers import open_loop
    want = {'state': np.ones((4, 3)), 'reward_sum': np.full(4, 900.0),
            'done_count': np.zeros(4), 'violation_count': np.zeros(4),
            'ctrl_step': np.full(4, 7.0)}
    prog = {k: v.astype(np.float32) for k, v in want.items()}
    prog['reward_sum'][0] = np.nextafter(np.float32(900.0), np.float32(1e9))
    prog['reward_sum'][1] += 1.0
    prog['state'][2, 0] = np.nan
    prog['done_count'][3] = 1
    got = {c.name: c.value for c in open_loop.compare(prog, want)}
    assert got == {'row_mismatch_share': 0.75}
