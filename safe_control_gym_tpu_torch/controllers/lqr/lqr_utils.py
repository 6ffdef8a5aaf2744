"""LQR helpers: the gain of a model linearized at a point.

Port of ``safe_control_gym_tpu/controllers/lqr/lqr_utils.py``. The Riccati
solvers are ``math/linalg.py``'s, on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_tpu_torch.math.linalg import (discretize_linear_system,
                                                    full_matmul_precision,
                                                    get_cost_weight_matrix, solve_care,
                                                    solve_dare)

__all__ = ['compute_lqr_gain', 'discretize_linear_system', 'get_cost_weight_matrix']


@full_matmul_precision
def compute_lqr_gain(model, x_0, u_0, Q, R, discrete_dynamics: bool = True) -> np.ndarray:
    """The LQR gain K (u = -K (x - x_goal) + u_eq) of ``model`` linearized at
    (x_0, u_0): with ``discrete_dynamics``, the exact discretization over
    ``model.dt`` and the DARE, else the CARE. The Riccati solution is float32
    on the model's device and the last solve float64, as the JAX package's
    (whose last solve is numpy's, with the float64 Q and R). Returns a float64
    numpy array."""
    df = model.df_func(np.atleast_1d(x_0), np.atleast_1d(u_0))
    A, B = df['dfdx'], df['dfdu']
    R64 = torch.as_tensor(np.asarray(R, np.float64), device=A.device)
    if discrete_dynamics:
        Ad, Bd = discretize_linear_system(A, B, model.dt, exact=True)
        P = solve_dare(Ad, Bd, Q, R)
        btp = Bd.T @ P
        gain = torch.linalg.solve((btp @ Bd).double() + R64, (btp @ Ad).double())
    else:
        P = solve_care(A, B, Q, R)
        gain = torch.linalg.solve(R64, (B.T @ P).double())
    return gain.cpu().numpy()
