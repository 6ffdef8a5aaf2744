"""MPC, linear MPC and MPC_ACADOS through ``BaseExperiment``.

Port of ``examples/mpc/mpc_experiment.py``: ``run`` returns ``(trajs_data,
metrics)``, one static env an episode (as the LQR example):

    python -m safe_control_gym_tpu_torch.examples.mpc.mpc_experiment --algo mpc \\
        --task cartpole --overrides examples/mpc/config_overrides/cartpole/cartpole_stab.yaml \\
        examples/mpc/config_overrides/cartpole/mpc_cartpole_stab.yaml
"""

from safe_control_gym_tpu_torch.examples import print_final_metrics
from safe_control_gym_tpu_torch.examples.lqr.lqr_experiment import (run_static_episodes,
                                                                    save_results)
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory


def run(gui=False, plot=False, n_episodes=1, n_steps=None, save_data=False):
    """The MPC experiment of the command line's config."""
    config = ConfigFactory().merge()
    all_trajs, metrics = run_static_episodes(config, n_episodes, n_steps, gui)
    if save_data:
        save_results(config, all_trajs, metrics)
    print_final_metrics(metrics)
    return all_trajs, metrics


if __name__ == '__main__':
    run()
