"""Model predictive safety certification: an uncertified run, then a certified one.

Port of ``examples/mpsc/mpsc_experiment.py``. RL controllers load the
committed policy of their cell (``<curr_path>/models/<algo>_model_<system>_
<task>.pt``, default ``examples/mpsc/``) and see the ``rl_reward`` env they
were trained on; model-based ones the quadratic-cost env in physical
actions. The filter works in physical actions on the quadratic-cost env; it
learns its RPI set (``training``) or loads the committed one
(``linear_mpsc_<system>.pkl``). ``run`` returns the uncertified and the
certified metrics:

    python -m safe_control_gym_tpu_torch.examples.mpsc.mpsc_experiment --task cartpole \\
        --algo lqr --safety_filter linear_mpsc --overrides \\
        examples/mpsc/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/mpsc/config_overrides/cartpole/lqr_cartpole.yaml \\
        examples/mpsc/config_overrides/cartpole/linear_mpsc_cartpole.yaml
"""

import os
from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.examples import example_dir
from safe_control_gym_tpu_torch.examples.rl.rl_experiment import system_name, task_name
from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make

RL_ALGOS = ('ppo', 'sac', 'ddpg', 'safe_explorer_ppo')


def run(gui=False, plot=False, training=True, n_episodes=1, n_steps=None, curr_path=None):
    """The uncertified and the certified evaluation of the command line's config."""
    config = ConfigFactory().merge()
    curr_path = example_dir('mpsc') if curr_path is None else curr_path
    system, task = system_name(config), task_name(config)
    config.task_config['randomized_init'] = False
    if config.algo in RL_ALGOS:
        config.task_config['cost'] = 'rl_reward'
    else:
        config.task_config['cost'] = 'quadratic'
        config.task_config['normalized_rl_action_space'] = False
    env_func = partial(make, config.task, device=config.device, **config.task_config)

    algo_config = dict(config.algo_config)
    if config.algo in RL_ALGOS:
        algo_config['training'] = False
    ctrl = make(config.algo, env_func, **algo_config)
    if config.algo in RL_ALGOS:
        path = os.path.join(curr_path, 'models', f'{config.algo}_model_{system}_{task}.pt')
        if os.path.exists(path):
            ctrl.load(path)

    env_func_filter = partial(make, config.task, device=config.device,
                              **dict(config.task_config, normalized_rl_action_space=False,
                                     cost='quadratic'))
    safety_filter = make(config.safety_filter, env_func_filter, **config.sf_config)
    if training:
        safety_filter.learn()
    else:
        safety_filter.load(os.path.join(curr_path, 'models',
                                        f'{config.safety_filter}_{system}.pkl'))

    experiment = BaseExperiment(env=env_func(), ctrl=ctrl)
    _, uncert_metrics = experiment.run_evaluation(n_episodes=n_episodes, n_steps=n_steps,
                                                  verbose=False)
    experiment.close()
    ctrl.reset()

    experiment = BaseExperiment(env=env_func(), ctrl=ctrl, safety_filter=safety_filter)
    cert_data, cert_metrics = experiment.run_evaluation(n_episodes=n_episodes,
                                                        n_steps=n_steps, verbose=False)
    experiment.close()

    corrections = [np.asarray(c) for c in cert_data['safety_filter_data']['correction']]
    print('Uncertified violations:', uncert_metrics['average_constraint_violation'])
    print('Certified violations:', cert_metrics['average_constraint_violation'])
    print('Mean correction:', float(np.mean([np.mean(c) for c in corrections])))
    return uncert_metrics, cert_metrics


if __name__ == '__main__':
    run()
