"""Control barrier function QP safety filter.

Port of ``safe_control_gym_tpu/safety_filters/cbf/cbf.py`` (``CBF``). The
filter solves

    min ||u - u_des||^2 (+ slack penalty)  s.t.  -alpha(h(x)) - L_f h(x, u) <= slack,
    the input constraints, slack >= 0.

The Lie derivative is ``torch.func.grad`` of the barrier dotted with the
prior's x_dot. The dynamics are control-affine (checked numerically by
``jacfwd(jacfwd(.))``), so L_f h = a0 + b0'u and the constraint is linear in
u. The soft problem eliminates the slack (its optimum is max(0, -b'u - rhs)),
which leaves two candidate QPs: the hard CBF QP, and the QP with the penalty
active; the first is taken where its residual is under ``feas_tol``. Both
candidates of B problems are one batched solve of ``ops/qp.py``'s ADMM QP (2B
problems: the second candidate carries an inert row, -big <= 0 <= big, so
that both have the same rows), on the env's device, each ADMM stage a
captured CUDA graph on the card.

``shard_over(mesh)`` splits the B problems of ``certify_action_batch`` over
``torch.distributed`` ranks (``parallel/sharding.batch_split``); CBF_NN
inherits it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from safe_control_gym_tpu_torch.controllers.mpc.mpc import BIG
from safe_control_gym_tpu_torch.math.linalg import full_matmul_precision
from safe_control_gym_tpu_torch.ops.qp import admm_qp
from safe_control_gym_tpu_torch.parallel.sharding import batch_split
from safe_control_gym_tpu_torch.safety_filters.base_safety_filter import BaseSafetyFilter
from safe_control_gym_tpu_torch.safety_filters.cbf.cbf_utils import (cartesian_product,
                                                                     cbf_cartpole,
                                                                     linear_function)

__all__ = ['CBF']


class CBF(BaseSafetyFilter):
    """Control barrier function QP filter."""

    def __init__(self, env_func, slope: float = 0.1, soft_constrained: bool = True,
                 slack_weight: float = 10000.0, slack_tolerance: float = 1.0e-3,
                 feas_tol: float = 1.0e-3, **kwargs):
        super().__init__(env_func=env_func, **kwargs)
        self.env = self.env_func()
        self.device = self.env.device
        self.slope = slope
        self.soft_constrained = soft_constrained
        self.slack_weight = slack_weight
        self.slack_tolerance = slack_tolerance
        # The QP's feasibility threshold on its final primal residual.
        self.feas_tol = float(feas_tol)
        input_constraints = self.env.constraints.input_constraints
        state_constraints = self.env.constraints.state_constraints
        if len(input_constraints) > 1 or len(state_constraints) > 1:
            raise NotImplementedError("CBF currently can't handle more than 1 constraint")
        if len(input_constraints) == 0:
            raise Exception('CBF requires at least 1 input constraint')
        if len(state_constraints) == 0:
            raise Exception('CBF requires at least 1 state constraint')
        self.input_constraint = input_constraints[0]
        self.state_constraint = state_constraints[0]
        self.reset()
        if self.env.NAME == 'cartpole':
            self.state_limits = [min(abs(self.state_constraint.upper_bounds[i]),
                                     abs(self.state_constraint.lower_bounds[i]))
                                 for i in range(self.model.nx)]
            self.cbf = cbf_cartpole(self.state_limits, self.device)
        else:
            raise NotImplementedError(
                '[Error] Currently CBF is only implemented for the cartpole system.')
        assert self.is_control_affine()
        self.linear_func = linear_function(self.slope)
        self.setup_optimizer()

    def _f32(self, a):
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def get_lie_derivative(self):
        """L_f h(x, u) = grad h(x) . f(x, u), a function of one (x, u)."""
        fc, cbf = self.model.fc_fn, self.cbf

        def lie(x, u):
            return grad(cbf)(x) @ fc(x, u)
        return lie

    def is_control_affine(self) -> bool:
        """d^2 f / du^2 = 0 at a state drawn from numpy's generator seeded 0
        and u = 1."""
        x = self._f32(np.random.default_rng(0).standard_normal(self.model.nx)) * 0.1
        hess = jacfwd(jacfwd(self.model.fc_fn, argnums=1), argnums=1)(
            x, torch.ones(self.model.nu, device=self.device))
        return bool(np.allclose(hess.cpu().numpy(), 0.0, atol=1e-5))

    # ------------------------------------------------------------------
    def setup_optimizer(self):
        """The QP's constant data: the input constraint rows."""
        self._lie = self.get_lie_derivative()
        self._A_u = self._f32(self.input_constraint.A)
        self._b_u = self._f32(self.input_constraint.b)

    @full_matmul_precision
    def _solve(self, x, u_des, nn_a, nn_b):
        """The two-candidate CBF QP of B problems: x (B, nx), u_des (B, nu),
        the learned residual terms nn_a (B, nu) and nn_b (B,). Returns u (B,
        nu), the slack (B,) and the primal residual (B,)."""
        B, nu = u_des.shape
        m_u = self._A_u.shape[0]
        zeros = torch.zeros((B, nu), device=self.device)
        a0 = vmap(self._lie)(x, zeros)
        b0 = vmap(jacfwd(self._lie, argnums=1))(x, zeros)
        h = vmap(self.cbf)(x)
        bt = b0 + nn_a
        rhs = self.slope * h + a0 + nn_b
        eye = torch.eye(nu, device=self.device)
        A_u = self._A_u.expand(B, m_u, nu)
        u_rows = torch.cat([rhs[:, None], self._b_u.expand(B, m_u)], dim=1)
        # Candidate 1: the hard CBF row -bt'u <= rhs.
        P, q = eye.expand(B, nu, nu), -u_des
        A = torch.cat([-bt[:, None, :], A_u], dim=1)
        u = u_rows
        if self.soft_constrained:
            # Candidate 2: the penalty active, 0.5||u - u_des||^2 + w (bt'u +
            # rhs)^2, under the input rows (and the inert row).
            w2 = 2.0 * self.slack_weight
            P = torch.cat([P, eye + w2 * bt[:, :, None] * bt[:, None, :]])
            q = torch.cat([q, -u_des + w2 * rhs[:, None] * bt])
            A = torch.cat([A, torch.cat([zeros[:, None, :], A_u], dim=1)])
            u = torch.cat([u, torch.cat([torch.full((B, 1), BIG, device=self.device),
                                         u_rows[:, 1:]], dim=1)])
        l = torch.full_like(u, -BIG)
        sol = admm_qp(P, q, A, l, u, rho=1.0, iters=300, polish=True, capture=True)
        x1, res1 = sol.x[:B], sol.prim_res[:B]
        if not self.soft_constrained:
            return x1, torch.zeros_like(res1), res1
        x2, res2 = sol.x[B:], sol.prim_res[B:]
        slack2 = torch.clamp(-(bt * x2).sum(-1) - rhs, min=0.0)
        ok1 = res1 < self.feas_tol
        return (torch.where(ok1[:, None], x1, x2), torch.where(ok1, 0.0, slack2),
                torch.where(ok1, res1, res2))

    def _feasible(self, slack, res):
        feasible = np.isfinite(res) & (res < self.feas_tol)
        if self.soft_constrained:
            feasible &= slack <= self.slack_tolerance
        return feasible

    def solve_optimization(self, current_state, uncertified_action) -> Tuple[np.ndarray, bool]:
        """One certification QP; one read from the device."""
        nn_a, nn_b = self._nn_terms(current_state)
        u, slack, res = self._solve(self._f32(current_state)[None],
                                    self._f32(np.atleast_1d(uncertified_action))[None],
                                    nn_a[None], nn_b[None])
        host = torch.cat([u[0], slack, res]).cpu().numpy()
        nu = self.model.nu
        return host[:nu], bool(self._feasible(host[nu], host[nu + 1]))

    def _nn_terms(self, state):
        """The learned residual terms of one state, (nu,) and (): zero for
        plain CBF."""
        return (torch.zeros((self.model.nu,), device=self.device),
                torch.zeros((), device=self.device))

    def _nn_terms_batch(self, states):
        """The learned residual terms, (B, nu) and (B,): zero for plain CBF."""
        B = states.shape[0]
        return (torch.zeros((B, self.model.nu), device=self.device),
                torch.zeros((B,), device=self.device))

    @batch_split(2)
    def certify_action_batch(self, states, actions):
        """B (state, action) pairs certified as one batched solve. Returns
        ``(certified_actions (B, nu), feasible (B,) bool)``, numpy."""
        lo, hi = self.env.physical_action_bounds
        states = np.asarray(states, np.float32)
        actions = np.clip(np.atleast_2d(np.asarray(actions, np.float32)), lo, hi)
        nn_a, nn_b = self._nn_terms_batch(states)
        u, slack, res = self._solve(self._f32(states), self._f32(actions), nn_a, nn_b)
        host = torch.cat([u, slack[:, None], res[:, None]], dim=1).cpu().numpy()
        nu = self.model.nu
        return host[:, :nu], self._feasible(host[:, nu], host[:, nu + 1])

    def shard_over(self, mesh, axis_name: str = 'data'):
        """Split the B problems of ``certify_action_batch`` over ``axis_name``
        of ``mesh`` (``parallel/sharding.py``): rank r certifies rows ``[r
        B/W, (r+1) B/W)`` and every rank returns the whole batch. A B that
        does not divide over the axis raises ValueError."""
        mesh.check_device(self.device)
        self._solve_mesh, self._solve_mesh_axis = mesh, axis_name

    def certify_action(self, current_state, uncertified_action, info=None
                       ) -> Tuple[np.ndarray, bool]:
        uncertified_action = np.clip(uncertified_action, self.env.physical_action_bounds[0],
                                     self.env.physical_action_bounds[1])
        self.results_dict['uncertified_action'].append(uncertified_action)
        certified_action, success = self.solve_optimization(current_state, uncertified_action)
        self.results_dict['feasible'].append(success)
        certified_action = np.squeeze(np.array(certified_action))
        self.results_dict['certified_action'].append(certified_action)
        self.results_dict['correction'].append(
            np.linalg.norm(certified_action - uncertified_action))
        return certified_action, success

    # ------------------------------------------------------------------
    def is_cbf(self, num_points: int = 100, tolerance: float = 0.01):
        """Certify u = 1 on a grid over the state limits (plus ``tolerance``):
        the barrier is valid if every infeasible state lies outside the safe
        set. Returns (valid, infeasible states)."""
        epsilon = 1e-6
        max_bounds = np.array(self.state_limits) + tolerance
        nx, nu = self.model.nx, self.model.nu
        num_points = max(2 * nx, num_points + num_points % (2 * nx))
        states_to_sample = [np.linspace(-max_bounds[i], max_bounds[i], num_points // nx)
                            for i in range(nx)]
        control_input = np.ones((nu,))
        num_infeasible_inside = 0
        infeasible_states = []
        for state in cartesian_product(*states_to_sample):
            _, success = self.certify_action(state, control_input)
            if not success:
                infeasible_states.append(state)
                if float(self.cbf(self._f32(state))) > epsilon:
                    num_infeasible_inside += 1
        return num_infeasible_inside == 0, infeasible_states

    def setup_results_dict(self):
        self.results_dict = {'feasible': [], 'uncertified_action': [],
                             'certified_action': [], 'correction': []}

    def reset(self):
        self.model = self.get_prior(self.env, self.prior_info)
        self.env.reset()
        self.setup_results_dict()

    def close(self):
        self.env.close()
