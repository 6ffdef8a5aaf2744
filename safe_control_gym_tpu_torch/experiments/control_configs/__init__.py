"""The example configs of the model-based controllers.

JSON copies of ``examples/lqr/config_overrides/*/*.yaml`` (``lqr.json``: LQR
and iLQR), ``examples/pid/config_overrides/*/*.yaml`` (``pid.json``) and
``examples/mpc/config_overrides/*/*.yaml`` (``mpc.json``: MPC, linear MPC,
MPC_ACADOS and GP-MPC), and of the safety filters' examples,
``examples/mpsc/config_overrides/{cartpole,quadrotor_2D}/*.yaml``
(``mpsc.json``) and ``examples/cbf/config_overrides/cartpole/*.yaml``
(``cbf.json``), keyed by ``<system>/<file stem>``, so that a machine without
a YAML parser can rebuild an example's env, controller and filter:

    env_id, task_config, algo_config = control_config('ilqr', 'quadrotor_2D', 'stab')
    ctrl = make('ilqr', partial(make, env_id, device='cuda', **task_config),
                **algo_config)
    env_id, task_config, algo, sf = safety_config('mpsc', 'quadrotor_2D', 'stab', 'sac')
"""

from __future__ import annotations

import json
import os

__all__ = ['EXAMPLE', 'SYSTEMS', 'control_config', 'load', 'safety_config']

# The systems of the examples, and the env id each is made from.
SYSTEMS = {'cartpole': 'cartpole', 'quadrotor_2D': 'quadrotor',
           'quadrotor_3D': 'quadrotor'}

_DIR = os.path.dirname(os.path.abspath(__file__))
# The example folder (and JSON file) of each algorithm.
EXAMPLE = {'lqr': 'lqr', 'ilqr': 'lqr', 'pid': 'pid', 'mpc': 'mpc', 'linear_mpc': 'mpc',
           'mpc_acados': 'mpc', 'gp_mpc': 'mpc'}


def load(example: str):
    """{'<system>/<file stem>': config} of ``example`` ('lqr', 'pid', 'mpc', 'mpsc'
    or 'cbf')."""
    with open(os.path.join(_DIR, f'{example}.json')) as f:
        return json.load(f)


def control_config(algo: str, system: str, task: str):
    """``(env_id, task_config, algo_config)`` of the example of ``algo`` (a
    key of ``EXAMPLE``) on ``system`` in ``task`` ('stab' or 'track')."""
    configs = load(EXAMPLE[algo])
    return (SYSTEMS[system], configs[f'{system}/{system}_{task}']['task_config'],
            configs[f'{system}/{algo}_{system}_{task}']['algo_config'])


def safety_config(example: str, system: str, task: str, algo: str):
    """``(env_id, task_config, algo_config, {safety_filter: sf_config})`` of
    the safety-filter example ``example`` ('mpsc' or 'cbf') on ``system`` in
    ``task`` ('stab' or 'track') with the controller ``algo``, and every
    filter of that system's example. A controller's file is
    ``<algo>_<system>_<task>`` or ``<algo>_<system>``."""
    configs = load(example)

    def find(stem):
        for key in (f'{system}/{stem}_{system}_{task}', f'{system}/{stem}_{system}'):
            if key in configs:
                return configs[key]
        raise KeyError(f'no {stem} config for {system} in examples/{example}')
    return (SYSTEMS[system], configs[f'{system}/{system}_{task}']['task_config'],
            find(algo)['algo_config'],
            {v['safety_filter']: v['sf_config'] for k, v in configs.items()
             if k.startswith(f'{system}/') and 'safety_filter' in v})
