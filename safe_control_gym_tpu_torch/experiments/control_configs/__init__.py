"""The example configs of the model-based controllers.

JSON copies of ``examples/lqr/config_overrides/*/*.yaml`` (``lqr.json``: LQR
and iLQR) and ``examples/pid/config_overrides/*/*.yaml`` (``pid.json``),
keyed by ``<system>/<file stem>``, so that a machine without a YAML parser
can rebuild an example's env and controller:

    env_id, task_config, algo_config = control_config('ilqr', 'quadrotor_2D', 'stab')
    ctrl = make('ilqr', partial(make, env_id, device='cuda', **task_config),
                **algo_config)
"""

from __future__ import annotations

import json
import os

__all__ = ['SYSTEMS', 'control_config', 'load']

# The systems of the examples, and the env id each is made from.
SYSTEMS = {'cartpole': 'cartpole', 'quadrotor_2D': 'quadrotor',
           'quadrotor_3D': 'quadrotor'}

_DIR = os.path.dirname(os.path.abspath(__file__))


def load(example: str):
    """{'<system>/<file stem>': config} of ``example`` ('lqr' or 'pid')."""
    with open(os.path.join(_DIR, f'{example}.json')) as f:
        return json.load(f)


def control_config(algo: str, system: str, task: str):
    """``(env_id, task_config, algo_config)`` of the example of ``algo``
    ('lqr', 'ilqr' or 'pid') on ``system`` in ``task`` ('stab' or 'track')."""
    configs = load('pid' if algo == 'pid' else 'lqr')
    return (SYSTEMS[system], configs[f'{system}/{system}_{task}']['task_config'],
            configs[f'{system}/{algo}_{system}_{task}']['algo_config'])
