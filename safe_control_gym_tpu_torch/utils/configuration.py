"""The experiment config: argparse, registry defaults, override files and key-value overrides.

Port of ``safe_control_gym_tpu/utils/configuration.py``. ``ConfigFactory.merge``
builds a ``ConfigDict`` in the JAX package's order:

1. the base dict ``{tag, seed, use_gpu, output_dir, restore, device}``;
2. ``--restore DIR``: the ``config.yaml`` saved there;
3. the registry's defaults for ``--algo``, ``--task`` and ``--safety_filter``
   under ``algo_config``, ``task_config`` and ``sf_config``;
4. the ``--overrides`` files (YAML through ``utils/yaml_io.py``, or JSON),
   merged deep in order;
5. the ``--kv_overrides`` pairs ``a.b.c=value``, each value read with
   ``ast.literal_eval`` (a string where that fails);
6. the base arguments given on the command line, and ``seed`` 0 if unset.

``device`` is the port's explicit device (``'cuda'`` unless the command line
or a file says otherwise); the entry points hand it to the env factory.

    config = ConfigFactory().merge()   # reads sys.argv
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Dict, Optional

from safe_control_gym_tpu_torch.utils.registration import get_config
from safe_control_gym_tpu_torch.utils.utils import (ConfigDict, deep_set, merge_dict,
                                                    munchify, read_file)

__all__ = ['ConfigFactory']

_CLI_BASE = ('tag', 'seed', 'output_dir', 'restore', 'device')


class ConfigFactory:
    """Builds an experiment's config from the command line and config files."""

    def __init__(self):
        self.parser = argparse.ArgumentParser(description='Benchmark')
        self.add_arguments()
        self.base_dict = dict(tag='temp', seed=None, use_gpu=False,
                              output_dir='./results', restore=None, device='cuda')

    def add_argument(self, *args, **kwargs):
        self.parser.add_argument(*args, **kwargs)

    def add_arguments(self):
        self.add_argument('--tag', type=str, help='id of the experiment')
        self.add_argument('--seed', type=int, help='random seed')
        self.add_argument('--use_gpu', action='store_true',
                          help='accepted for the reference configs; --device places the run')
        self.add_argument('--device', type=str, help="'cuda' (default) or 'cpu'")
        self.add_argument('--output_dir', type=str, help='output saving folder')
        self.add_argument('--restore', type=str, help='folder to reload from')
        self.add_argument('--algo', type=str, help='algorithm id')
        self.add_argument('--task', type=str, help='task/environment id')
        self.add_argument('--safety_filter', type=str, help='safety filter id')
        self.add_argument('--overrides', nargs='+', type=str, help='override config files')
        self.add_argument('--kv_overrides', nargs='+', type=str,
                          help='override key-value pairs')

    def merge(self, config_override: Optional[Dict] = None, argv=None) -> ConfigDict:
        """The config of the command line ``argv`` (default ``sys.argv[1:]``);
        unknown arguments are ignored."""
        config_dict = dict(self.base_dict)
        args, _ = self.parser.parse_known_args(argv)
        if config_override:
            config_dict.update(config_override)
        if args.restore:
            config_dict.update(read_file(os.path.join(args.restore, 'config.yaml')) or {})
        if args.algo:
            config_dict['algo'] = args.algo
            config_dict['algo_config'] = get_config(args.algo)
        if args.task:
            config_dict['task'] = args.task
            config_dict['task_config'] = get_config(args.task)
        if args.safety_filter:
            config_dict['safety_filter'] = args.safety_filter
            config_dict['sf_config'] = get_config(args.safety_filter)
        for path in args.overrides or ():
            merge_dict(config_dict, read_file(path) or {})
        for kv in args.kv_overrides or ():
            k, v = kv.split('=', 1)
            try:
                value = ast.literal_eval(v.strip())
            except (ValueError, SyntaxError):
                value = v.strip()
            deep_set(config_dict, k.strip(), value)
        for k in _CLI_BASE:
            v = getattr(args, k, None)
            if v is not None:
                config_dict[k] = v
        if args.use_gpu:
            config_dict['use_gpu'] = True
        if config_dict.get('seed') is None:
            config_dict['seed'] = 0
        return munchify(config_dict)
