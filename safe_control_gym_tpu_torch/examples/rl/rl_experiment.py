"""Evaluate a trained RL policy through ``BaseExperiment``.

Port of ``examples/rl/rl_experiment.py``: the controller loads the model of
its (algo, system, task) cell, ``<curr_path>/models/<algo>/<algo>_model_
<system>_<task>.pt`` (default ``examples/rl/``: the committed models, the JAX
package's checkpoints, or the port's own), and ``run`` returns ``(trajs_data,
metrics)``:

    python -m safe_control_gym_tpu_torch.examples.rl.rl_experiment --algo ppo \\
        --task cartpole --overrides examples/rl/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/rl/config_overrides/cartpole/ppo_cartpole.yaml
"""

import os
from functools import partial

from safe_control_gym_tpu_torch.examples import example_dir, print_final_metrics
from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make


def system_name(config):
    """The models' system label: the quadrotor splits into 2D and 3D."""
    if config.task == 'quadrotor':
        return ('quadrotor_3D' if int(config.task_config.get('quad_type', 2)) >= 3
                else 'quadrotor_2D')
    return config.task


def task_name(config):
    return 'track' if config.task_config.get('task') == 'traj_tracking' else 'stab'


def model_path(curr_path, config):
    return os.path.join(curr_path, 'models', config.algo,
                        f'{config.algo}_model_{system_name(config)}_{task_name(config)}.pt')


def run(gui=False, plot=False, n_episodes=1, n_steps=None, curr_path=None, save_data=False):
    """The evaluation of the command line's config."""
    config = ConfigFactory().merge()
    curr_path = example_dir('rl') if curr_path is None else curr_path
    env_func = partial(make, config.task, device=config.device, **config.task_config)
    ctrl = make(config.algo, env_func, **dict(config.algo_config, training=False))
    path = model_path(curr_path, config)
    if os.path.exists(path):
        ctrl.load(path)
    experiment = BaseExperiment(env=env_func(gui=gui), ctrl=ctrl)
    if n_steps is None:
        trajs_data, metrics = experiment.run_evaluation(n_episodes=n_episodes)
    else:
        trajs_data, metrics = experiment.run_evaluation(n_steps=n_steps)
    experiment.close()
    print_final_metrics(metrics)
    return dict(trajs_data), metrics


if __name__ == '__main__':
    run()
