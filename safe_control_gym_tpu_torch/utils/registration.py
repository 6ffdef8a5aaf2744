"""Registry of the port's environments: ``register``, ``make``, ``spec``, ``get_config``.

Port of ``safe_control_gym_tpu/utils/registration.py``. A ``Spec`` maps an id to
an ``entry_point`` ("module:Class") and an optional ``config_entry_point``
("module:file.json") holding the default config; the port keeps its defaults as
JSON, since the machines it runs on need not have a YAML parser.

    env = make('cartpole', device='cuda', **get_config('cartpole'))
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict, Optional

__all__ = ['Spec', 'Registry', 'register', 'make', 'spec', 'get_config',
           'registry']


def _load_entry_point(entry_point: str):
    mod_name, attr = entry_point.split(':')
    return getattr(importlib.import_module(mod_name), attr)


class Spec:
    """An id with its entry point and default config."""

    def __init__(self, idx: str, entry_point: str,
                 config_entry_point: Optional[str] = None):
        self.idx = idx
        self.entry_point = entry_point
        self.config_entry_point = config_entry_point

    def get_config(self) -> Dict[str, Any]:
        """The default config dict (a fresh copy on every call)."""
        if self.config_entry_point is None:
            return {}
        mod_name, fname = self.config_entry_point.split(':')
        mod = importlib.import_module(mod_name)
        with open(os.path.join(os.path.dirname(mod.__file__), fname)) as f:
            return json.load(f)

    def make(self, *args, **kwargs):
        return _load_entry_point(self.entry_point)(*args, **kwargs)

    def __repr__(self):
        return f'Spec({self.idx})'


class Registry:
    """Id -> Spec."""

    def __init__(self):
        self.specs: Dict[str, Spec] = {}

    def register(self, idx: str, entry_point: str,
                 config_entry_point: Optional[str] = None):
        if idx in self.specs:
            existing = self.specs[idx]
            if (existing.entry_point == entry_point
                    and existing.config_entry_point == config_entry_point):
                return
            raise ValueError(f'Cannot re-register id: {idx}')
        self.specs[idx] = Spec(idx, entry_point, config_entry_point)

    def get(self, idx: str) -> Spec:
        if idx not in self.specs:
            raise KeyError(f'No registered spec with id: {idx}')
        return self.specs[idx]

    def all(self):
        return self.specs.values()


registry = Registry()


def register(idx: str, entry_point: str, config_entry_point: Optional[str] = None):
    registry.register(idx, entry_point, config_entry_point)


def make(idx: str, *args, **kwargs):
    """Instantiate the class registered under ``idx``; envs take ``device=``
    (default ``'cuda'``)."""
    return registry.get(idx).make(*args, **kwargs)


def spec(idx: str) -> Spec:
    return registry.get(idx)


def get_config(idx: str) -> Dict[str, Any]:
    """Default config dict for ``idx``."""
    return registry.get(idx).get_config()
