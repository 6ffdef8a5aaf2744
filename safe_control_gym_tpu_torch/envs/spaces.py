"""A minimal ``Box`` space, in the role of ``gymnasium.spaces.Box``.

The JAX envs use gymnasium's ``Box``; the port does not depend on
gymnasium. This one keeps what the envs and their callers read (``low``,
``high``, ``shape``, ``dtype``) and samples only from a generator the
caller passes, never from hidden state.
"""

from __future__ import annotations

import numpy as np

__all__ = ['Box']


class Box:
    """A box [low, high] in R^n with bounds broadcast to ``shape``."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self, generator: np.random.Generator) -> np.ndarray:
        """One uniform draw from the box, made with ``generator``."""
        return generator.uniform(self.low, self.high).astype(self.dtype)

    def __repr__(self):
        return f'Box({self.low}, {self.high}, {self.shape}, {self.dtype})'
