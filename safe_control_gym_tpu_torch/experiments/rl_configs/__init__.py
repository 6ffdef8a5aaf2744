"""The eval configs of the committed RL models under ``examples/rl/models/``.

JSON copies of ``examples/rl/config_overrides/<system>/<system>_stab.yaml``
(``task_config``) and ``<algo>_<system>.yaml`` (``algo``, ``algo_config``), so
that a machine without a YAML parser can rebuild a model's env and controller:

    env_id, task_config, algo_config = eval_config('sac', 'quadrotor_3D')
    ctrl = make('sac', partial(make, env_id, device='cuda', **task_config),
                **algo_config)
"""

from __future__ import annotations

import json
import os

__all__ = ['SYSTEMS', 'eval_config']

# The systems of the committed models, and the env id each is made from.
SYSTEMS = {'cartpole': 'cartpole', 'quadrotor_2D': 'quadrotor',
           'quadrotor_3D': 'quadrotor'}

_DIR = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    with open(os.path.join(_DIR, f'{name}.json')) as f:
        return json.load(f)


def eval_config(algo: str, system: str):
    """``(env_id, task_config, algo_config)`` of the committed ``algo`` model
    ('ppo' or 'sac') of ``system`` ('cartpole', 'quadrotor_2D' or
    'quadrotor_3D') in its stabilization task."""
    return (SYSTEMS[system], _load(f'{system}_stab')['task_config'],
            _load(f'{algo}_{system}')['algo_config'])
