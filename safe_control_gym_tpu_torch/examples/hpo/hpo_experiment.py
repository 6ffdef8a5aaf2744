"""Hyperparameter optimization of an RL algorithm on a task.

Port of ``examples/hpo/hpo_experiment.py``: ``HPO`` (``hyperparameters/
hpo.py``) over the study the config describes, trials sequential or, with
``hpo_config.vectorized_trials``, as populations; ``run`` returns the study:

    python -m safe_control_gym_tpu_torch.examples.hpo.hpo_experiment --algo ppo \\
        --task cartpole --overrides examples/hpo/config_overrides/ppo_cartpole_hpo.yaml \\
        --output_dir hpo_results
"""

from safe_control_gym_tpu_torch.hyperparameters.hpo import HPO
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory


def run(sampler='tpe'):
    factory = ConfigFactory()
    factory.add_argument('--sampler', type=str, default=sampler)
    config = factory.merge()
    hpo = HPO(config.algo, config.task, sampler=getattr(config, 'sampler', sampler),
              output_dir=config.output_dir, task_config=config.task_config,
              algo_config=config.algo_config, hpo_config=config.get('hpo_config', {}),
              device=config.device)
    study = hpo.hyperparameter_optimization()
    print('Best value:', study.best_value)
    print('Best params:', study.best_params)
    return study


if __name__ == '__main__':
    run()
