"""Vec-env utilities: stacking observations, tiling frames, MPI variables.

Port of ``safe_control_gym_tpu/envs/env_wrappers/vectorized_env/vec_env_utils.py``.
Its ``CloudpickleWrapper`` is left out: the machines the port runs on need not
have cloudpickle, and ``SubprocVecEnv`` sends its workers plain-pickled env
thunks instead.
"""

from __future__ import annotations

import contextlib
import os
from collections import OrderedDict

import numpy as np

__all__ = ['_flatten_obs', '_unflatten_obs', 'tile_images', 'clear_mpi_env_vars']


def _flatten_obs(obs, space):
    """Stack a list of observations (dicts, tuples or arrays)."""
    assert isinstance(obs, (list, tuple)), 'expected list or tuple of observations'
    assert len(obs) > 0, 'need observations from at least one environment'
    if isinstance(obs[0], dict):
        return OrderedDict([(k, np.stack([o[k] for o in obs])) for k in obs[0].keys()])
    if isinstance(obs[0], tuple):
        return tuple(np.stack([o[i] for o in obs]) for i in range(len(obs[0])))
    return np.stack(obs)


def _unflatten_obs(obs):
    """Inverse of ``_flatten_obs``."""
    if isinstance(obs, dict):
        n = len(next(iter(obs.values())))
        return [{k: v[i] for k, v in obs.items()} for i in range(n)]
    if isinstance(obs, tuple):
        return [tuple(o[i] for o in obs) for i in range(len(obs[0]))]
    return [o for o in obs]


def tile_images(img_nhwc):
    """Tile N images of (h, w, c) into one grid image."""
    img_nhwc = np.asarray(img_nhwc)
    n, h, w, c = img_nhwc.shape
    H = int(np.ceil(np.sqrt(n)))
    W = int(np.ceil(float(n) / H))
    img_nhwc = np.array(list(img_nhwc) + [img_nhwc[0] * 0 for _ in range(n, H * W)])
    out = img_nhwc.reshape(H, W, h, w, c).transpose(0, 2, 1, 3, 4)
    return out.reshape(H * h, W * w, c)


@contextlib.contextmanager
def clear_mpi_env_vars():
    """Strip the OMPI_ and PMI_ variables while subprocesses start, so that
    they do not inherit an MPI context."""
    removed = {}
    for k, v in list(os.environ.items()):
        if k.startswith(('OMPI_', 'PMI_')):
            removed[k] = v
            del os.environ[k]
    try:
        yield
    finally:
        os.environ.update(removed)
