"""Every example config pair through the port, against the JAX package's
configs (the counterpart of tests/test_examples/test_config_sweep.py).

For each (system x task) YAML and each algorithm or safety-filter YAML beside
it under ``examples/*/config_overrides/``: the port's ``ConfigFactory``
merges the command line ``--algo/--safety_filter, --task, --overrides task
algo`` into the JAX package's registry defaults deep-merged with the two
files (``get_config`` and ``merge_dict`` of the JAX package), key for key;
then the port's env constructs and resets on the CPU under the task config,
and the controller or filter constructs.
"""

import glob
import os
import re
from functools import partial

import pytest
import torch
import yaml

from safe_control_gym_tpu.utils.registration import get_config as jax_get_config
from safe_control_gym_tpu.utils.utils import merge_dict as jax_merge_dict
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make
from safe_control_gym_tpu_torch.utils.utils import unmunchify

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'examples')


def _pairs():
    """(task_yaml, algo_yaml) pairs of the config_overrides trees."""
    pairs = []
    for task_path in glob.glob(os.path.join(EXAMPLES, '*', 'config_overrides', '*', '*.yaml')):
        name = os.path.basename(task_path)
        if not re.fullmatch(r'(cartpole|quadrotor_2D|quadrotor_3D)_(stab|track)\.yaml', name):
            continue
        stem = name[:-len('.yaml')]
        for algo_path in glob.glob(os.path.join(os.path.dirname(task_path), f'*_{stem}.yaml')):
            if os.path.basename(algo_path) != name:
                pairs.append((task_path, algo_path))
    return sorted(pairs)


PAIRS = _pairs()


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module, the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def test_the_sweep_is_wide():
    assert len(PAIRS) >= 30, len(PAIRS)


@pytest.mark.parametrize('task_path,algo_path', PAIRS,
                         ids=[f'{p[0].split(os.sep)[-4]}:{os.path.basename(p[1])[:-5]}'
                              for p in PAIRS])
def test_config_pair_merges_as_jax_and_constructs(task_path, algo_path, tmp_path):
    with open(task_path) as f:
        task_spec = yaml.safe_load(f)
    with open(algo_path) as f:
        spec = yaml.safe_load(f)
    system = 'cartpole' if 'cartpole' in os.path.basename(task_path) else 'quadrotor'
    if 'algo' in spec:
        name, cfg_key, flag = spec['algo'], 'algo_config', '--algo'
    else:
        name, cfg_key, flag = spec['safety_filter'], 'sf_config', '--safety_filter'
    config = unmunchify(ConfigFactory().merge(argv=[
        flag, name, '--task', system, '--overrides', task_path, algo_path, '--device', 'cpu']))
    assert config[cfg_key] == jax_merge_dict(jax_get_config(name), spec.get(cfg_key) or {})
    assert config['task_config'] == jax_merge_dict(jax_get_config(system),
                                                   task_spec['task_config'])

    env_func = partial(make, system, device='cpu', **config['task_config'])
    env = env_func()
    env.reset()
    env.close()
    cfg = dict(config[cfg_key])
    cfg.pop('training', None)
    ctrl = make(name, env_func, output_dir=str(tmp_path), **cfg)
    assert ctrl is not None
    if hasattr(ctrl, 'close'):
        ctrl.close()
