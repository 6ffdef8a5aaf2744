"""Train an RL controller from the command line: the examples' training entry point.

Port of ``safe_control_gym_tpu/experiments/train_rl_controller.py``:
``ConfigFactory`` → ``partial(make, task, device=..., output_dir=...,
**task_config)`` → ``make(algo, env_func, ...)`` → ``reset``, ``learn``,
``save('model_latest.pt')`` → ``config.yaml`` (``utils/yaml_io.py``) → the
training curves under ``plots/`` → ``close``. The run goes to
``{output_dir}/{tag}/seed{n}_{time}_{sha}``. It trains on the card unless
``--device cpu`` is given, and raises without CUDA otherwise. Where
matplotlib is missing, the plots are skipped with one printed line; the
logs stay.

    python -m safe_control_gym_tpu_torch.experiments.train_rl_controller --algo ppo \\
        --task cartpole --overrides examples/rl/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/rl/config_overrides/cartpole/ppo_cartpole.yaml --output_dir results
"""

from __future__ import annotations

import os
from functools import partial

from safe_control_gym_tpu_torch.utils import yaml_io
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.device import resolve_device
from safe_control_gym_tpu_torch.utils.registration import make
from safe_control_gym_tpu_torch.utils.utils import (set_dir_from_config,
                                                    set_seed_from_config, unmunchify)

__all__ = ['train']


def train(argv=None):
    """Train as the command line ``argv`` (default ``sys.argv[1:]``) says; returns
    the run's output directory."""
    config = ConfigFactory().merge(argv=argv)
    resolve_device(config.device)
    set_seed_from_config(config)
    set_dir_from_config(config)
    env_func = partial(make, config.task, device=config.device,
                       output_dir=config.output_dir, **config.task_config)
    ctrl = make(config.algo, env_func,
                checkpoint_path=os.path.join(config.output_dir, 'model_latest.pt'),
                output_dir=config.output_dir, seed=config.seed, **config.algo_config)
    ctrl.reset()
    ctrl.learn()
    ctrl.save(os.path.join(config.output_dir, 'model_latest.pt'))
    with open(os.path.join(config.output_dir, 'config.yaml'), 'w') as f:
        yaml_io.dump(unmunchify(config), f)
    try:
        from safe_control_gym_tpu_torch.utils.plotting import plot_from_logs
        plot_from_logs(config.output_dir, os.path.join(config.output_dir, 'plots'))
    except ImportError as e:
        print(f'[WARNING] plotting skipped: {e}')
    ctrl.close()
    print(f'Training complete. Results in {config.output_dir}')
    return config.output_dir


if __name__ == '__main__':
    train()
