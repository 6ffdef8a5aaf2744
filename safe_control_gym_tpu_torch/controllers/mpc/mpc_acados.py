"""Real-time-iteration MPC with acados' semantics, on the port's SQP + ADMM.

Port of ``safe_control_gym_tpu/controllers/mpc/mpc_acados.py``
(``MPC_ACADOS``), which mirrors the reference's acados solver without acados:

* LINEAR_LS cost: the stage weights are ``W = blkdiag(Q/dt, R/dt)``, the
  terminal ``W_e`` the unscaled Q (or the DARE's P);
* the ERK integrator: the parent's RK4 over dt; any other
  ``integrator_type`` raises;
* box constraints only (``BoundedConstraint`` and its descendants); any
  other constraint raises;
* ``use_RTI``: one warm-started SQP iteration a control step, else 5.
"""

from __future__ import annotations

import numpy as np

from safe_control_gym_tpu_torch.controllers.mpc.mpc import MPC
from safe_control_gym_tpu_torch.envs.constraints import BoundedConstraint

__all__ = ['MPC_ACADOS']


class MPC_ACADOS(MPC):
    """MPC with acados' cost, constraint and solve-schedule semantics."""

    def __init__(self, env_func, horizon: int = 5, q_mpc: list = [1],
                 r_mpc: list = [1], warmstart: bool = True,
                 soft_constraints: bool = False, soft_penalty: float = 10000,
                 constraint_tol: float = 1e-6, use_RTI: bool = False,
                 integrator_type: str = 'ERK', **kwargs):
        kwargs.setdefault('sqp_iters', 1 if use_RTI else 5)
        super().__init__(env_func, horizon=horizon, q_mpc=q_mpc, r_mpc=r_mpc,
                         warmstart=warmstart, soft_constraints=soft_constraints,
                         soft_penalty=soft_penalty, constraint_tol=constraint_tol,
                         **kwargs)
        self.use_RTI = use_RTI
        if integrator_type != 'ERK':
            raise ValueError(
                f"integrator_type '{integrator_type}' is not supported; only 'ERK' "
                '(explicit RK4) is implemented, as the reference always uses ERK.')
        self.integrator_type = integrator_type
        for con in self.constraints.state_constraints + self.constraints.input_constraints:
            if not isinstance(con, BoundedConstraint):
                raise ValueError('Constraint type not supported. Support only for '
                                 'BoundedConstraint and descendants. Check constraints.py.')
        # The LINEAR_LS stage weights, read by setup_optimizer.
        self.Q_stage = np.asarray(self.Q) / self.dt
        self.R_stage = np.asarray(self.R) / self.dt
