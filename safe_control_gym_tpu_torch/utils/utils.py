"""General utilities: attribute dicts, config files, deep merge, seeding and run dirs.

Port of ``safe_control_gym_tpu/utils/utils.py``: ``ConfigDict`` (the
``munch.Munch`` role), ``munchify``/``unmunchify``, ``read_file``,
``merge_dict``, ``deep_set``, ``set_seed`` (``random``, numpy and torch),
``set_seed_from_config``, ``get_random_state``/``set_random_state``,
``timestamp``, ``mkdirs``, ``set_dir_from_config``, ``save_video``,
``unwrap_wrapper`` and ``is_wrapped``. YAML goes through ``utils/yaml_io.py``,
since the machines the port runs on need not have PyYAML.

Left out: ``enable_persistent_compile_cache``, which configures JAX's compile
cache and has no counterpart here, and ``restore_prng_key``, which restores a
JAX PRNG key (the port's checkpoints restore ``torch.Generator`` states,
``utils/checkpoint.py``).
"""

from __future__ import annotations

import datetime
import json
import os
import random
import subprocess
import sys
from copy import deepcopy
from typing import Any, Dict

import numpy as np
import torch

from safe_control_gym_tpu_torch.utils import yaml_io

__all__ = [
    'ConfigDict', 'munchify', 'unmunchify', 'read_file', 'merge_dict',
    'deep_set', 'set_seed', 'set_seed_from_config', 'set_dir_from_config',
    'get_random_state', 'set_random_state', 'mkdirs', 'save_video', 'unwrap_wrapper',
    'is_wrapped', 'timestamp',
]


class ConfigDict(dict):
    """A dict with attribute access that converts nested dicts on the way in."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = self._convert(v)

    @classmethod
    def _convert(cls, v):
        if isinstance(v, ConfigDict):
            return v
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._convert(i) for i in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._convert(v))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return type(self)({k: deepcopy(v, memo) for k, v in self.items()})

    def toDict(self) -> dict:
        return unmunchify(self)


def munchify(d: Any) -> Any:
    """Dicts to ``ConfigDict``, recursively."""
    return ConfigDict._convert(d)


def unmunchify(d: Any) -> Any:
    """``ConfigDict``s back to plain dicts, recursively."""
    if isinstance(d, dict):
        return {k: unmunchify(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(unmunchify(i) for i in d)
    return d


def read_file(file_path: str, sep: str = ','):
    """A YAML, JSON or text file's content (a text file as rows split at
    ``sep``); None where the path is None or does not exist."""
    if file_path is None or not os.path.exists(file_path):
        return None
    ext = os.path.splitext(file_path)[-1].lower()
    if ext in ('.yaml', '.yml'):
        return yaml_io.load_file(file_path)
    with open(file_path) as f:
        if ext == '.json':
            return json.load(f)
        return [line.strip().split(sep) for line in f if line.strip()]


def merge_dict(source: Dict, update: Dict) -> Dict:
    """Merge ``update`` into ``source`` in place, recursing into dicts."""
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(source.get(k), dict):
            merge_dict(source[k], v)
        else:
            source[k] = v
    return source


def deep_set(d: Dict, path: str, value: Any, sep: str = '.') -> None:
    """Set the nested key ``'a.b.c'``, making dicts along the way."""
    keys = path.split(sep)
    for k in keys[:-1]:
        if k not in d or not isinstance(d[k], dict):
            d[k] = ConfigDict() if isinstance(d, ConfigDict) else {}
        d = d[k]
    d[keys[-1]] = value


def set_seed(seed: int, cuda: bool = False) -> None:
    """Seed ``random``, numpy's global generator and torch (every device)."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def set_seed_from_config(config) -> None:
    seed = config.get('seed', None) if hasattr(config, 'get') else None
    if seed is not None:
        set_seed(seed)


def get_random_state() -> Dict[str, Any]:
    """The host generators' states: ``random``, numpy's and torch's CPU one."""
    return {'random': random.getstate(), 'numpy': np.random.get_state(),
            'torch': torch.get_rng_state()}


def set_random_state(state: Dict[str, Any]) -> None:
    random.setstate(state['random'])
    np.random.set_state(state['numpy'])
    if 'torch' in state:
        torch.set_rng_state(state['torch'])


def timestamp() -> str:
    return datetime.datetime.now().strftime('%m.%d.%H.%M.%S')


def _git_sha() -> str:
    try:
        return subprocess.check_output(['git', 'rev-parse', '--short', 'HEAD'],
                                       stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return 'nogit'


def mkdirs(*paths: str) -> None:
    for p in paths:
        if p:
            os.makedirs(p, exist_ok=True)


def set_dir_from_config(config) -> None:
    """Make the run's directory ``{output_dir}/{tag}/seed{n}_{time}_{sha}``, point
    ``config.output_dir`` at it, and write ``config.yaml`` and the command line
    (``cmd.txt``) there."""
    base = os.path.join(config.output_dir, config.tag,
                        f'seed{config.seed}_{timestamp()}_{_git_sha()}')
    config.output_dir = base
    mkdirs(base)
    with open(os.path.join(base, 'config.yaml'), 'w') as f:
        yaml_io.dump(unmunchify(config), f)
    with open(os.path.join(base, 'cmd.txt'), 'a') as f:
        f.write(' '.join(sys.argv) + '\n')


def save_video(name: str, frames, fps: int = 20) -> None:
    """Save HxWx3 uint8 frames as a .gif or .mp4 through imageio; where
    imageio is missing, every len(frames) // 16-th frame goes to
    ``<name>_<i>.png`` through matplotlib instead, with a printed warning."""
    assert name.endswith('.gif') or name.endswith('.mp4'), \
        'Video name must end in .gif or .mp4.'
    try:
        import imageio
        imageio.mimsave(name, frames, fps=fps)
    except ImportError:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        base = os.path.splitext(name)[0]
        for i, frame in enumerate(frames[:: max(1, len(frames) // 16)]):
            plt.imsave(f'{base}_{i:03d}.png', frame)
        print(f'[WARNING] imageio unavailable; dumped frames to {base}_*.png')


def unwrap_wrapper(env, wrapper_class):
    """The instance of ``wrapper_class`` in a chain of ``.env`` wrappers, or None."""
    env_tmp = env
    while hasattr(env_tmp, 'env'):
        if isinstance(env_tmp, wrapper_class):
            return env_tmp
        env_tmp = env_tmp.env
    return None


def is_wrapped(env, wrapper_class) -> bool:
    return unwrap_wrapper(env, wrapper_class) is not None
