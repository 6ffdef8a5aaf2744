"""Performance metrics.

Port of ``safe_control_gym_tpu/math/metrics.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = ['compute_cvar']


def compute_cvar(data: np.ndarray, alpha: float, lower_range: bool = True) -> float:
    """Conditional value at risk of ``data`` at level ``alpha``: the mean of
    the lowest (``lower_range``) or highest alpha-fraction of the values."""
    data = np.asarray(data, dtype=float)
    assert 0 < alpha <= 1
    sorted_data = np.sort(data)
    k = int(np.ceil(len(sorted_data) * alpha))
    if k == 0:
        return float('nan')
    if lower_range:
        return float(sorted_data[:k].mean())
    return float(sorted_data[-k:].mean())
