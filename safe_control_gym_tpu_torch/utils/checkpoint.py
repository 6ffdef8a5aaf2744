"""Load the JAX package's RL checkpoints without the JAX stack, and write the port's own.

The checkpoints under ``examples/rl/models/`` are pickles written by the JAX
package's ``PPO.save``, ``SAC.save``, ``DDPG.save`` and
``SafeExplorerPPO.save`` (RARL's and RAP's are alike): dicts of numpy
arrays, but with optax optimizer states and, in training checkpoints, the
saved vectorized env's ``EnvState``, dynamics parameters and the off-policy
replay ring inside. A plain ``pickle.load``
would import optax and the JAX package. ``CheckpointUnpickler`` resolves only:

* numpy's array reconstructors and ``dtype``, from ``numpy._core`` (numpy >= 2,
  which wrote the files) or else ``numpy.core``;
* the optax states and the JAX package's state classes, to inert stand-ins
  defined here (they keep their fields; ``plain`` turns them into dicts);

and refuses every other global with ``pickle.UnpicklingError``.

``save_checkpoint`` writes the port's own format: a pickle of numpy arrays,
scalars and plain dicts and lists only, which the same unpickler reads.

    ckpt = load_checkpoint('examples/rl/models/sac/sac_model_cartpole_stab.pt')
    ckpt['params']['actor']        # [{'w': (in, out), 'b': (out,)}, ...] numpy
    ckpt['obs_norm_state']         # {'mean', 'var', 'count'} numpy, or None
"""

from __future__ import annotations

import importlib
import os
import pickle

__all__ = ['CheckpointUnpickler', 'load_checkpoint', 'plain', 'save_checkpoint']


class _Inert:
    """Stand-in for a class of optax or of the JAX package: it keeps what the
    pickle hands it and does nothing else. A named tuple's fields arrive as
    the arguments of ``__new__`` (the pickle's NEWOBJ), a dataclass's as the
    state of ``__setstate__``."""

    FIELDS = ()   # the field names of a named tuple, in order

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        obj.kwargs = kwargs
        return obj

    def __setstate__(self, state):
        self.state = state

    def fields(self) -> dict:
        """The fields the pickle set, by name (dataclass state, named-tuple
        arguments or kwargs)."""
        state = getattr(self, 'state', None)
        if isinstance(state, tuple) and len(state) == 2 and state[0] is None:
            state = state[1]          # (None, slotstate) of a slotted class
        if isinstance(state, dict):
            return dict(state)
        return {**dict(zip(self.FIELDS, self.args)), **self.kwargs}


def _stand_in(qualname: str, fields=()):
    return type(qualname.rsplit('.', 1)[-1], (_Inert,),
                {'__qualname__': qualname, 'FIELDS': tuple(fields)})


_STAND_INS = {(mod, name): _stand_in(f'{mod}.{name}', fields) for mod, name, fields in (
    ('optax._src.base', 'EmptyState', ()),
    ('optax._src.transform', 'ScaleByAdamState', ('count', 'mu', 'nu')),
    ('safe_control_gym_tpu.envs.benchmark_env', 'EnvState', ()),
    ('safe_control_gym_tpu.controllers.off_policy_utils', 'ReplayState', ()),
    ('safe_control_gym_tpu.envs.dynamics', 'CartPoleParams', ()),
    ('safe_control_gym_tpu.envs.dynamics', 'QuadParams', ()),
    ('safe_control_gym_tpu.math.normalization', 'NormalizerState', ()),
    ('safe_control_gym_tpu.math.normalization', 'RetState', ()),
)}

# numpy's globals a pickled array needs, under either of numpy's module names.
_NUMPY = {('numpy', 'ndarray'), ('numpy', 'dtype'),
          ('numpy._core.multiarray', '_reconstruct'),
          ('numpy._core.multiarray', 'scalar'),
          ('numpy.core.multiarray', '_reconstruct'),
          ('numpy.core.multiarray', 'scalar')}


def _numpy_global(module: str, name: str):
    if module == 'numpy':
        return getattr(importlib.import_module('numpy'), name)
    tail = module.split('.', 2)[2]   # 'multiarray'
    for root in ('numpy._core', 'numpy.core'):
        try:
            return getattr(importlib.import_module(f'{root}.{tail}'), name)
        except ImportError:
            continue
    raise pickle.UnpicklingError(f'no numpy module for {module}.{name}')


class CheckpointUnpickler(pickle.Unpickler):
    """An unpickler that resolves numpy's array globals and the known JAX-side
    state classes (to inert stand-ins), and refuses everything else."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY:
            return _numpy_global(module, name)
        if (module, name) in _STAND_INS:
            return _STAND_INS[(module, name)]
        raise pickle.UnpicklingError(
            f'checkpoint refers to {module}.{name}, which this loader does not '
            'allow')


def plain(obj):
    """``obj`` with every stand-in replaced by the dict of its fields, down
    through dicts, lists and tuples (an optax chain's state stays a tuple)."""
    if isinstance(obj, _Inert):
        return {k: plain(v) for k, v in obj.fields().items()}
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    return obj


def load_checkpoint(path) -> dict:
    """Read a checkpoint of an RL controller (the JAX package's or the port's).

    Returns ``params`` (the agent's parameter pytree: dicts and lists of numpy
    arrays; None in a file without an agent), ``obs_norm_state`` (a dict of
    ``mean``, ``var`` and ``count``, or None) and ``raw`` (everything the file
    holds, with stand-ins in place of the optax and JAX package objects)."""
    with open(path, 'rb') as f:
        raw = CheckpointUnpickler(f).load()
    return {'params': raw.get('agent', {}).get('params'),
            'obs_norm_state': plain(raw.get('obs_norm_state')),
            'raw': raw}


def save_checkpoint(path, state: dict):
    """Write the port's checkpoint: ``state`` must hold only numpy arrays,
    Python scalars, None, and dicts and lists of them, so that
    ``CheckpointUnpickler`` reads it back. Missing directories are made."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(state, f)
