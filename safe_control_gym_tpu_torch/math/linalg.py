"""Linear-algebra helpers for control.

Port of ``safe_control_gym_tpu/math/linalg.py``, so far only the host-side
``get_cost_weight_matrix`` that the env needs. The Riccati solvers, ``expm``
and the LQR gain come with the solver slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ['get_cost_weight_matrix']


def get_cost_weight_matrix(weights, dim: int) -> np.ndarray:
    """Diagonal weight matrix from a 1- or ``dim``-long list (identity for
    ``None``)."""
    if weights is None:
        weights = [1.0]
    w = np.atleast_1d(np.asarray(weights, dtype=np.float64)).ravel()
    if len(w) == dim:
        return np.diag(w)
    if len(w) == 1:
        return np.diag(w[0] * np.ones(dim))
    raise ValueError('Wrong dimension for cost weights.')
