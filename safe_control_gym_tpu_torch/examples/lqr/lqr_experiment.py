"""LQR and iLQR through ``BaseExperiment``, one static env an episode.

Port of ``examples/lqr/lqr_experiment.py``: ``run`` returns ``(trajs_data,
metrics)`` with the JAX package's metric keys. It runs on the card unless
``--device cpu`` is given:

    python -m safe_control_gym_tpu_torch.examples.lqr.lqr_experiment --algo lqr \\
        --task cartpole --overrides examples/lqr/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/lqr/config_overrides/cartpole/lqr_cartpole_stab.yaml
"""

import os
import pickle
from collections import defaultdict
from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.envs.benchmark_env import Task
from safe_control_gym_tpu_torch.examples import print_final_metrics
from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make


def run_static_episodes(config, n_episodes=1, n_steps=None, gui=False, plot_fn=None):
    """Each episode from a random env's reset state, on a static env with a
    training env beside it: ``launch_training``, then the evaluation. The
    LQR and MPC examples share it."""
    env_func = partial(make, config.task, device=config.device, **config.task_config)
    random_env = env_func(gui=False)
    ctrl = make(config.algo, env_func, **config.algo_config)
    all_trajs = defaultdict(list)
    for _ in range(1 if n_episodes is None else n_episodes):
        init_state, _ = random_env.reset()
        init_state = np.asarray(init_state)[:random_env.state_dim]
        static_env = env_func(gui=gui, randomized_init=False, init_state=init_state)
        static_train_env = env_func(gui=False, randomized_init=False, init_state=init_state)
        experiment = BaseExperiment(env=static_env, ctrl=ctrl, train_env=static_train_env)
        experiment.launch_training()
        if n_steps is None:
            trajs_data, _ = experiment.run_evaluation(training=True, n_episodes=1)
        else:
            trajs_data, _ = experiment.run_evaluation(training=True, n_steps=n_steps)
        if plot_fn is not None:
            plot_fn(trajs_data['obs'][0], trajs_data['action'][0], ctrl.env)
        static_env.close()
        static_train_env.close()
        for key, value in trajs_data.items():
            all_trajs[key] += value
    ctrl.close()
    random_env.close()
    return dict(all_trajs), experiment.compute_metrics(all_trajs)


def save_results(config, all_trajs, metrics):
    os.makedirs('./temp-data', exist_ok=True)
    with open(f'./temp-data/{config.algo}_data_{config.task}.pkl', 'wb') as file:
        pickle.dump({'trajs_data': all_trajs, 'metrics': metrics}, file)


def run(gui=False, plot=False, n_episodes=1, n_steps=None, save_data=False):
    """The LQR/iLQR experiment of the command line's config."""
    config = ConfigFactory().merge()
    all_trajs, metrics = run_static_episodes(config, n_episodes, n_steps, gui,
                                             post_analysis if plot else None)
    if save_data:
        save_results(config, all_trajs, metrics)
    print_final_metrics(metrics)
    return all_trajs, metrics


def post_analysis(state_stack, input_stack, env):
    """Plot the state trajectories against the reference (needs matplotlib)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    model = env.symbolic
    plot_length = np.min([np.shape(input_stack)[0], np.shape(state_stack)[0]])
    times = np.linspace(0, model.dt * plot_length, plot_length)
    reference = np.asarray(env.X_GOAL)
    if env.TASK == Task.STABILIZATION:
        reference = np.tile(reference.reshape(1, model.nx), (plot_length, 1))
    fig, axs = plt.subplots(model.nx, figsize=(8, model.nx * 1.5))
    for k in range(model.nx):
        axs[k].plot(times, np.array(state_stack).T[k, 0:plot_length], label='actual')
        axs[k].plot(times, reference.T[k, 0:plot_length], color='r', label='desired')
        axs[k].set(ylabel=env.STATE_LABELS[k])
    axs[0].set_title('State Trajectories')
    axs[-1].legend()
    axs[-1].set(xlabel='time (sec)')
    fig.savefig('./lqr_states.png')
    plt.close(fig)


if __name__ == '__main__':
    run()
