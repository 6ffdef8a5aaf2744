"""Train an RL controller and save its model where ``rl_experiment`` finds it.

Port of ``examples/rl/train_rl.py``: the model goes to ``<curr_path>/models/
<algo>/<algo>_model_<system>_<task>.pt`` (default: the working directory,
never the committed models) in the port's checkpoint format; ``run`` returns
its path:

    python -m safe_control_gym_tpu_torch.examples.rl.train_rl --algo ppo --task cartpole \\
        --overrides examples/rl/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/rl/config_overrides/cartpole/ppo_cartpole.yaml --output_dir results
"""

import os
from functools import partial

from safe_control_gym_tpu_torch.examples.rl.rl_experiment import model_path
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make


def run(curr_path='.'):
    config = ConfigFactory().merge()
    env_func = partial(make, config.task, device=config.device, **config.task_config)
    ctrl = make(config.algo, env_func, seed=config.seed, output_dir=config.output_dir,
                **config.algo_config)
    ctrl.reset()
    ctrl.learn()
    path = model_path(curr_path, config)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ctrl.save(path)
    print(f'Saved model to {path}')
    ctrl.close()
    return path


if __name__ == '__main__':
    run()
