"""The one-step MPSC cost ``|| u_L - next_u ||^2``.

Port of ``safe_control_gym_tpu/safety_filters/mpsc/mpsc_cost_function/one_step_cost.py``.
``next_u = v_0 + U_EQ + K (x_init - z_0)`` is affine in d = [z_0; v_0], so the
cost is ``|| c0 + M d ||^2`` with ``c0 = u_L - U_EQ - K x_init``; ``get_cost``
returns M.
"""

from __future__ import annotations

import numpy as np

from safe_control_gym_tpu_torch.safety_filters.mpsc.mpsc_cost_function.abstract_cost import \
    MPSC_COST

__all__ = ['ONE_STEP_COST']


class ONE_STEP_COST(MPSC_COST):
    """Standard one-step MPSC cost function."""

    def get_cost(self, opti_dict):
        """M = [K, -I], (nu, nx + nu)."""
        K = np.asarray(opti_dict['lqr_gain'])
        nu = K.shape[0]
        return np.concatenate([K, -np.eye(nu)], axis=1)
