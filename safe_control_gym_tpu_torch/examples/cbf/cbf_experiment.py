"""A controller's actions certified by the CBF-QP safety filter.

Port of ``examples/cbf/cbf_experiment.py``: ``run`` returns ``(trajs_data,
metrics)`` of the certified evaluation:

    python -m safe_control_gym_tpu_torch.examples.cbf.cbf_experiment --algo lqr \\
        --task cartpole --safety_filter cbf --overrides \\
        examples/cbf/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/cbf/config_overrides/cartpole/lqr_cartpole_stab.yaml \\
        examples/cbf/config_overrides/cartpole/cbf_cartpole_stab.yaml
"""

from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make


def run(gui=False, plot=False, training=False, n_episodes=1, n_steps=None, curr_path='.'):
    config = ConfigFactory().merge()
    env_func = partial(make, config.task, device=config.device, **config.task_config)
    ctrl = make(config.algo, env_func, **config.algo_config)
    safety_filter = make(config.safety_filter, env_func, **config.sf_config)
    if training and hasattr(safety_filter, 'learn'):
        safety_filter.uncertified_controller = ctrl
        safety_filter.learn()

    experiment = BaseExperiment(env=env_func(), ctrl=ctrl, safety_filter=safety_filter)
    trajs_data, metrics = experiment.run_evaluation(n_episodes=n_episodes, n_steps=n_steps,
                                                    verbose=False)
    experiment.close()
    corrections = [np.asarray(c) for c in trajs_data['safety_filter_data']['correction']]
    print('Constraint violations:', metrics['average_constraint_violation'])
    print('Mean correction:', float(np.mean([np.mean(c) for c in corrections])))
    return dict(trajs_data), metrics


if __name__ == '__main__':
    run()
