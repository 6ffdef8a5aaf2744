"""The frozen operation, byte and FLOP counts at small shapes, against the
port's own counts (``chip_smoke.py``) and against PyTorch's FLOP counter."""

import types
from functools import partial

import pytest

from gpubench.counts import ppo as ppo_counts
from gpubench.counts import rollout as counts


@pytest.fixture(scope='module')
def smoke():
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize('system', ['cartpole', 'quadrotor_3D'])
@pytest.mark.parametrize('constrained', [False, True])
@pytest.mark.parametrize('randomized_reset', [False, True])
def test_open_loop_counts_match_the_port(smoke, system, constrained, randomized_reset):
    kw = dict(draw_actions=True, constrained=constrained, randomized_reset=randomized_reset)
    want = smoke.rollout_ops(system, kw, 30, done_total=17.0, batch=64)
    got = counts.open_loop_ops(system, 64, 30, smoke.N_SUB, constrained=constrained,
                               randomized_reset=randomized_reset, done_total=17.0)
    assert got == want
    assert counts.open_loop_bytes(system, 64) == smoke.rollout_bytes(system, kw, 30, batch=64)


@pytest.mark.parametrize('system', ['cartpole', 'quadrotor_3D'])
def test_policy_counts_match_the_port(smoke, system):
    pp = types.SimpleNamespace(nx=counts.NX[system], h1=64, h2=32, nu_out=counts.NU[system])
    kw = dict(draw_actions=False, constrained=False, randomized_reset=True, policy_params=pp)
    want = smoke.policy_rollout_ops(system, kw, 30, done_total=5.0, batch=64)
    got = counts.policy_ops(system, 64, 30, smoke.N_SUB, 64, 32, randomized_reset=True,
                            done_total=5.0)
    assert got == want
    # The port's count charges the (T, B, nu) replayed actions of the open
    # loop's replay mode, which policy mode does not read.
    replay = 30 * 64 * pp.nu_out * 4
    assert counts.policy_bytes(system, 64, 64, 32) == \
        smoke.policy_rollout_bytes(system, kw, 30, batch=64) - replay
    assert counts.mlp_ops(pp.nx, 64, 32, pp.nu_out) == smoke.mlp_ops(pp, pp.nu_out)


def test_ppo_product_flops_match_the_flop_counter():
    """One iteration's products, counted by PyTorch, equal the frozen count
    without the env step."""
    from torch.utils.flop_counter import FlopCounterMode

    from gpubench.harness import core
    from safe_control_gym_tpu_torch.utils.registration import make
    cfg = core.config('quadrotor_3D_ppo')
    algo = {**cfg['algo_config'], 'rollout_batch_size': 16, 'rollout_steps': 4,
            'mini_batch_size': 16, 'opt_epochs': 2, 'hidden_dim': 8}
    env_func = partial(make, 'quadrotor', device='cpu', **cfg['task_config'])
    ctrl = make('ppo', env_func, training=True, checkpoint_path='', output_dir='temp',
                **algo)
    ctrl.reset()
    with FlopCounterMode(display=False) as fc:
        batch, _ = ctrl.rollout()
        ctrl.agent.update_tensors(batch, ctrl.gen)
    want = ppo_counts.iteration_flops('quadrotor_3D', 16, 4, 20, 12, 4, 8, 2, 16, 4, env=False)
    assert fc.get_total_flops() == want
    ctrl.close()
