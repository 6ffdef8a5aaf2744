"""The configs of the committed RL models under ``examples/rl/models/``.

JSON copies of ``examples/rl/config_overrides/<system>/<system>_stab.yaml``
(``task_config``) and ``<algo>_<system>[_<variant>].yaml`` (``algo``,
``algo_config`` and, for SafeExplorerPPO, a ``task_config`` of constraints
laid over the stab task's; its ``pretrain`` variant turns ``pretraining``
on), so that a machine without a YAML parser can rebuild a model's env and
controller:

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


def eval_config(algo: str, system: str, variant: str = None):
    """``(env_id, task_config, algo_config)`` of the committed ``algo`` model
    ('ppo', 'sac' or 'safe_explorer_ppo') of ``system`` ('cartpole',
    'quadrotor_2D' or 'quadrotor_3D') in its stabilization task; ``variant``
    names another config of the algorithm ('pretrain')."""
    spec = _load(f'{algo}_{system}' + (f'_{variant}' if variant else ''))
    task = {**_load(f'{system}_stab')['task_config'], **spec.get('task_config', {})}
    return SYSTEMS[system], task, spec['algo_config']
