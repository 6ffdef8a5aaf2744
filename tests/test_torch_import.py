"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import functools
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, 'safe_control_gym_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'chex', 'safe_control_gym_tpu')


def _port_sources():
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_import_leaves_jax_out_of_sys_modules():
    code = ('import sys, safe_control_gym_tpu_torch\n'
            'import safe_control_gym_tpu_torch.envs.cartpole\n'
            'import safe_control_gym_tpu_torch.envs.quadrotor\n'
            'import safe_control_gym_tpu_torch.ops.rollout_kernels\n'
            'import safe_control_gym_tpu_torch.experiments.benchmark_suite\n'
            'import safe_control_gym_tpu_torch.utils.convert\n'
            'import safe_control_gym_tpu_torch.experiments.fused_eval\n'
            'import safe_control_gym_tpu_torch.controllers.ppo.ppo\n'
            'import safe_control_gym_tpu_torch.controllers.sac.sac\n'
            'import safe_control_gym_tpu_torch.controllers.ddpg.ddpg\n'
            'from functools import partial\n'
            'from safe_control_gym_tpu_torch.utils.registration import make\n'
            'from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint\n'
            'for m in ("ppo/ppo_model_quadrotor_3D_stab.pt", "sac/sac_model_cartpole_stab.pt"):\n'
            '    load_checkpoint("examples/rl/models/" + m)\n'
            'ctrl = make("ppo", partial(make, "cartpole", device="cpu"))\n'
            'ctrl.load("examples/rl/models/ppo/ppo_model_cartpole_stab.pt")\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)\n'
            'print(bad); sys.exit(1 if bad else 0)' % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize('path', sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{path} imports {bad}'


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    from safe_control_gym_tpu_torch.experiments import benchmark_suite
    from safe_control_gym_tpu_torch.utils.registration import make
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make('cartpole')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make('quadrotor', quad_type=3)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_rollout_kernel('cartpole', False, batch=8,
                                               n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_batched('cartpole', False, batch=8, n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_rollout_kernel('quadrotor_3D', True, batch=8,
                                               n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        benchmark_suite.measure_closed_loop_kernel('cartpole', batch=8, n_steps=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make('sac', functools.partial(make, 'cartpole'))
    ctrl = make('ppo', functools.partial(make, 'cartpole', device='cpu'))
    assert ctrl.device.type == 'cpu' and ctrl.agent.params['logstd'].device.type == 'cpu'
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import PPOAgent
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        PPOAgent(ctrl.env.observation_space, ctrl.env.action_space)
    env = make('cartpole', device='cpu')
    assert env.device.type == 'cpu'
