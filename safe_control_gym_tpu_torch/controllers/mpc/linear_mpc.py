"""Linear MPC: the MPC skeleton on the prior model linearized once.

Port of ``safe_control_gym_tpu/controllers/mpc/linear_mpc.py``
(``LinearMPC``). The dynamics are the exact (zero-order-hold) discretization
at (X_EQ, U_EQ),

    x+ = X_EQ + Ad (x - X_EQ) + Bd (u - U_EQ),

whose Jacobians are constant, so one SQP iteration is exact: one ADMM QP a
control step (``sqp_iters`` 1).
"""

from __future__ import annotations

from safe_control_gym_tpu_torch.controllers.mpc.mpc import MPC

__all__ = ['LinearMPC']


class LinearMPC(MPC):
    """MPC with the linearized prior model."""

    def __init__(self, env_func, horizon: int = 5, q_mpc: list = [1],
                 r_mpc: list = [1], warmstart: bool = True,
                 soft_constraints: bool = False, soft_penalty: float = 10000,
                 constraint_tol: float = 1e-6, solver: str = 'qp', **kwargs):
        kwargs.setdefault('sqp_iters', 1)
        super().__init__(env_func, horizon=horizon, q_mpc=q_mpc, r_mpc=r_mpc,
                         warmstart=warmstart, soft_constraints=soft_constraints,
                         soft_penalty=soft_penalty, constraint_tol=constraint_tol,
                         solver=solver, **kwargs)

    def set_dynamics_func(self):
        """The LTI dynamics of the exact discretization at the equilibrium."""
        super().set_dynamics_func()
        Ad, Bd = self._f32(self.Ad), self._f32(self.Bd)
        X_EQ, U_EQ = self._f32(self.X_EQ), self._f32(self.U_EQ)

        def linear_dynamics(x, u):
            return X_EQ + Ad @ (x - X_EQ) + Bd @ (u - U_EQ)

        self.dynamics_func = linear_dynamics
        self.linear_dynamics_func = linear_dynamics
