"""Read an actor's weights from a committed RL checkpoint, for the reference.

The committed models are pickles of numpy arrays in which the optimizer's
and the environment's state objects are classes of other packages. This
reader resolves numpy's array globals and turns every other class into an
inert placeholder, so it imports nothing of those packages and executes no
code of theirs; only the plain arrays of the actor are taken."""

from __future__ import annotations

import importlib
import pickle

import numpy as np

_NUMPY = {'ndarray', 'dtype', '_reconstruct', 'scalar'}


class _Placeholder:
    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __setstate__(self, state):
        self.state = state


class _Reader(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split('.')[0] == 'numpy' and name in _NUMPY:
            if module == 'numpy':
                return getattr(np, name)
            tail = module.rsplit('.', 1)[-1]
            for root in ('numpy._core', 'numpy.core'):
                try:
                    return getattr(importlib.import_module(f'{root}.{tail}'), name)
                except (ImportError, AttributeError):
                    continue
        return type(name, (_Placeholder,), {})


def actor_layers(path: str):
    """The actor MLP of a PPO checkpoint: a list of (w (in, out), b) float32
    numpy pairs, and the observation normalizer's (mean, var) or None."""
    with open(path, 'rb') as f:
        raw = _Reader(f).load()
    layers = [(np.asarray(l['w'], np.float32), np.asarray(l['b'], np.float32))
              for l in raw['agent']['params']['actor']]
    norm = raw.get('obs_norm_state')
    if isinstance(norm, dict) and norm.get('mean') is not None:
        return layers, (np.asarray(norm['mean'], np.float32), np.asarray(norm['var'], np.float32))
    return layers, None
