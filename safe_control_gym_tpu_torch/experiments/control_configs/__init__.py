"""The example configs of the model-based controllers.

JSON copies of ``examples/lqr/config_overrides/*/*.yaml`` (``lqr.json``: LQR
and iLQR), ``examples/pid/config_overrides/*/*.yaml`` (``pid.json``) and
``examples/mpc/config_overrides/*/*.yaml`` (``mpc.json``: MPC, linear MPC,
MPC_ACADOS and GP-MPC), keyed by ``<system>/<file stem>``, so that a machine
without a YAML parser can rebuild an example's env and controller:

    env_id, task_config, algo_config = control_config('ilqr', 'quadrotor_2D', 'stab')
    ctrl = make('ilqr', partial(make, env_id, device='cuda', **task_config),
                **algo_config)
"""

from __future__ import annotations

import json
import os

__all__ = ['EXAMPLE', 'SYSTEMS', 'control_config', 'load']

# The systems of the examples, and the env id each is made from.
SYSTEMS = {'cartpole': 'cartpole', 'quadrotor_2D': 'quadrotor',
           'quadrotor_3D': 'quadrotor'}

_DIR = os.path.dirname(os.path.abspath(__file__))
# The example folder (and JSON file) of each algorithm.
EXAMPLE = {'lqr': 'lqr', 'ilqr': 'lqr', 'pid': 'pid', 'mpc': 'mpc', 'linear_mpc': 'mpc',
           'mpc_acados': 'mpc'}


def load(example: str):
    """{'<system>/<file stem>': config} of ``example`` ('lqr', 'pid' or 'mpc')."""
    with open(os.path.join(_DIR, f'{example}.json')) as f:
        return json.load(f)


def control_config(algo: str, system: str, task: str):
    """``(env_id, task_config, algo_config)`` of the example of ``algo`` (a
    key of ``EXAMPLE``) on ``system`` in ``task`` ('stab' or 'track')."""
    configs = load(EXAMPLE[algo])
    return (SYSTEMS[system], configs[f'{system}/{system}_{task}']['task_config'],
            configs[f'{system}/{algo}_{system}_{task}']['algo_config'])
