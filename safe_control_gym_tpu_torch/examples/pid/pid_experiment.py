"""PID on the 2D and 3D quadrotors, with the custom waypoint reference.

Port of ``examples/pid/pid_experiment.py``: ``run`` returns ``(trajs_data,
metrics)``. With ``task_config.task_info.trajectory_type=custom`` the env
tracks a degree-6 polynomial fit through fixed 3D waypoints, set through
``env.set_reference``:

    python -m safe_control_gym_tpu_torch.examples.pid.pid_experiment --algo pid \\
        --task quadrotor --overrides examples/pid/config_overrides/quadrotor_3D/quadrotor_3D_track.yaml \\
        examples/pid/config_overrides/quadrotor_3D/pid_quadrotor_3D_track.yaml \\
        --kv_overrides task_config.task_info.trajectory_type=custom
"""

from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.examples import print_final_metrics
from safe_control_gym_tpu_torch.experiments.base_experiment import BaseExperiment
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make

WAYPOINTS = np.array([(0, 0, 0), (0.2, 0.5, 0.5), (0.5, 0.1, 0.6), (1, 1, 1), (1.3, 1, 1.2)])


def custom_waypoint_reference(config, nx):
    """A degree-6 polynomial fit a position axis through ``WAYPOINTS``, at
    episode_len_sec x ctrl_freq + 2 points, in the x, y and z columns."""
    iterations = int(config.task_config['episode_len_sec']
                     * config.task_config['ctrl_freq']) + 2
    t = np.arange(WAYPOINTS.shape[0])
    t_scaled = np.linspace(t[0], t[-1], iterations)
    x_goal = np.zeros((iterations, nx))
    for col, axis in zip((0, 2, 4), range(3)):
        x_goal[:, col] = np.poly1d(np.polyfit(t, WAYPOINTS[:, axis], deg=6))(t_scaled)
    return x_goal


def run(gui=False, plot=False, n_episodes=1, n_steps=None, save_data=False):
    """The PID experiment of the command line's config."""
    config = ConfigFactory().merge()
    custom_trajectory = (config.task_config['task'] == 'traj_tracking'
                         and config.task_config['task_info']['trajectory_type'] == 'custom')
    if custom_trajectory:
        # A placeholder trajectory type; set_reference replaces X_GOAL below.
        config.task_config['task_info']['trajectory_type'] = 'circle'
        config.task_config['randomized_init'] = False
        config.task_config['init_state'] = np.zeros(12)

    env_func = partial(make, config.task, device=config.device, **config.task_config)
    env = env_func(gui=gui)
    ctrl = make(config.algo, env_func, **config.algo_config)
    if custom_trajectory:
        x_goal = custom_waypoint_reference(config, env.symbolic.nx)
        env.set_reference(x_goal)
        ctrl.reference = x_goal

    experiment = BaseExperiment(env=env, ctrl=ctrl)
    if n_steps is None:
        trajs_data, metrics = experiment.run_evaluation(n_episodes=n_episodes)
    else:
        trajs_data, metrics = experiment.run_evaluation(n_steps=n_steps)
    experiment.close()
    print_final_metrics(metrics)
    return dict(trajs_data), metrics


if __name__ == '__main__':
    run()
