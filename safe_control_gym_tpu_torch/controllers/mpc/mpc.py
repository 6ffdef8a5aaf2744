"""Nonlinear model predictive control: SQP over the multiple-shooting QP,
each QP solved by the batched ADMM of ``ops/qp.py``.

Port of ``safe_control_gym_tpu/controllers/mpc/mpc.py`` (``MPC``):

* RK4-discretized prior dynamics (``mpc_utils.rk_discrete``) of
  ``env.symbolic``;
* each SQP iteration linearizes the dynamics and the constraints about the
  current guess, by ``torch.func.vmap(jacfwd(.))`` over every point of the
  horizon (and of the batch), and solves the QP over states, inputs and
  shared slacks (the reference's variable layout): ``sqp_iters - 1``
  unpolished solves, then one polished;
* the QP's structure is built once (``setup_optimizer``): the constant
  Hessian, the constant rows of A, and the flat indices its Jacobian blocks
  are copied into, one ``index_copy_`` a block type per solve;
* ``select_action``: a warm start from the shifted previous solution, a
  cold retry if the warm-started solve is infeasible, then the reference's
  fallback ladder; one read from the device a step (X, U, the residual and
  the QP's warm start in one copy), besides the QP's stage exits;
* ``select_action_batch``: B cold-started problems as one batched solve;
* ``select_action_scenarios``: one problem under B sets of parameters of the
  dynamics (``dynamics_func_param``), each problem of the batch linearized
  under its own set.

Every solve runs on the env's device (``partial(make, env_id, device=...)``).
``shard_over(mesh)`` splits the B problems of ``select_action_batch`` over
``torch.distributed`` ranks (``parallel/sharding.batch_split``): each rank
solves its rows and every rank returns the whole batch; GPMPC and LinearMPC
inherit it.
"""

from __future__ import annotations

import time
from copy import deepcopy
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap
from torch.utils._pytree import tree_leaves, tree_map

from safe_control_gym_tpu_torch.controllers.base_controller import BaseController
from safe_control_gym_tpu_torch.controllers.mpc.mpc_utils import (
    compute_discrete_lqr_gain_from_cont_linear_system, compute_state_rmse, reset_constraints,
    rk_discrete)
from safe_control_gym_tpu_torch.envs.benchmark_env import Task
from safe_control_gym_tpu_torch.envs.constraints import (GENERAL_CONSTRAINTS,
                                                         create_constraint_list)
from safe_control_gym_tpu_torch.math.linalg import (discretize_linear_system,
                                                    full_matmul_precision,
                                                    get_cost_weight_matrix)
from safe_control_gym_tpu_torch.ops.qp import admm_qp
from safe_control_gym_tpu_torch.parallel.sharding import batch_split

__all__ = ['MPC']

# The bound of an open side of a QP row.
BIG = 1e8


def _block_indices(row0, col0, n_blocks, br, bc, row_stride, col_stride, n_cols):
    """Flat indices (row * n_cols + col) of ``n_blocks`` (br, bc) blocks,
    block k at (row0 + k row_stride, col0 + k col_stride), in (k, i, j) order."""
    k = np.arange(n_blocks)[:, None, None]
    rows = row0 + k * row_stride + np.arange(br)[None, :, None]
    cols = col0 + k * col_stride + np.arange(bc)[None, None, :]
    return (np.broadcast_to(rows, (n_blocks, br, bc)) * n_cols
            + np.broadcast_to(cols, (n_blocks, br, bc))).reshape(-1)


class MPC(BaseController):
    """MPC with the full nonlinear prior model, solved by SQP + ADMM."""

    def __init__(self,
                 env_func,
                 horizon: int = 5,
                 q_mpc: list = [1],
                 r_mpc: list = [1],
                 warmstart: bool = True,
                 soft_constraints: bool = False,
                 soft_penalty: float = 10000,
                 constraint_tol: float = 1e-6,
                 use_lqr_gain_and_terminal_cost: bool = False,
                 solver: str = 'sqp',
                 sqp_iters: int = 3,
                 qp_iters: int = 4000,
                 feas_tol: float = 1e-2,
                 feas_tol_relative: bool = True,
                 additional_constraints: Optional[list] = None,
                 **kwargs):
        super().__init__(env_func=env_func, **kwargs)
        self.env = env_func()
        self.device = self.env.device
        env_constraints = self.env.constraints.constraints if self.env.constraints else []
        if additional_constraints is not None:
            self.additional_constraints = create_constraint_list(
                additional_constraints, GENERAL_CONSTRAINTS, self.env).constraints
        else:
            self.additional_constraints = []
        (self.constraints, self.state_constraints_sym,
         self.input_constraints_sym) = reset_constraints(
            env_constraints + self.additional_constraints)
        self.model = self.get_prior(self.env)
        self.dt = self.model.dt
        self.T = int(horizon)
        self.Q = get_cost_weight_matrix(q_mpc, self.model.nx)
        self.R = get_cost_weight_matrix(r_mpc, self.model.nu)
        self.constraint_tol = constraint_tol
        self.soft_constraints = soft_constraints
        self.soft_penalty = soft_penalty
        self.warmstart = warmstart
        self.use_lqr_gain_and_terminal_cost = use_lqr_gain_and_terminal_cost
        self.solver = solver
        self.sqp_iters = int(sqp_iters)
        self.qp_iters = int(qp_iters)
        # Feasibility is the final QP primal residual under feas_tol, scaled
        # with the data (OSQP's eps_abs + eps_rel * scale) if relative.
        self.feas_tol = float(feas_tol)
        self.feas_tol_relative = bool(feas_tol_relative)
        self.X_EQ = np.atleast_1d(np.asarray(self.model.X_EQ))
        self.U_EQ = np.atleast_1d(np.asarray(self.model.U_EQ))
        if self.env.TASK == Task.STABILIZATION:
            self.x_goal = self.env.X_GOAL
        elif self.env.TASK == Task.TRAJ_TRACKING:
            self.traj = self.env.X_GOAL.T
        self.terminate_loop = False

    def _f32(self, a):
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def add_constraints(self, constraints):
        (self.constraints, self.state_constraints_sym,
         self.input_constraints_sym) = reset_constraints(
            constraints + self.constraints.constraints)

    def remove_constraints(self, constraints):
        old = self.constraints.constraints
        for c in constraints:
            if c not in old:
                raise ValueError('This constraint is not in the current list of constraints')
            old.remove(c)
        (self.constraints, self.state_constraints_sym,
         self.input_constraints_sym) = reset_constraints(old)

    def close(self):
        self.env.close()

    def reset_before_run(self, obs=None, info=None, env=None):
        self.x_prev = None
        self.u_prev = None
        self._qp_warm = None
        super().reset_before_run(obs, info, env)

    def reset(self):
        """The dynamics, then the QP's structure."""
        self.set_dynamics_func()
        self.setup_optimizer(self.solver)
        self.reset_before_run()

    # ------------------------------------------------------------------
    def set_dynamics_func(self):
        """RK4 dynamics of the prior model, its exact discretization at the
        equilibrium and the ancillary LQR gain and terminal cost."""
        df = self.model.df_func(x=self.X_EQ, u=self.U_EQ)
        self.dfdx, self.dfdu = df['dfdx'].cpu().numpy(), df['dfdu'].cpu().numpy()
        Ad, Bd = discretize_linear_system(df['dfdx'], df['dfdu'], self.dt, exact=True)
        self.Ad, self.Bd = Ad.cpu().numpy(), Bd.cpu().numpy()
        self.lqr_gain, _, _, self.P = compute_discrete_lqr_gain_from_cont_linear_system(
            df['dfdx'], df['dfdu'], self.Q, self.R, self.dt)
        self.dynamics_func = rk_discrete(self.model.fc_fn, self.model.nx, self.model.nu,
                                         self.dt)

    def _stacked(self, fns, dim):
        """g(v) of one point: the constraints' values stacked, and their count."""
        if not fns:
            return None, 0

        def g(v):
            return torch.cat([f(v[None])[0] for f in fns])
        return g, int(sum(f(torch.zeros((1, dim), device=self.device)).shape[-1]
                          for f in fns))

    # ------------------------------------------------------------------
    def setup_optimizer(self, solver='sqp'):
        """The QP's constant structure: the Hessian, A's constant rows and
        the flat indices of its Jacobian blocks (all on the env's device)."""
        nx, nu, T = self.model.nx, self.model.nu, self.T
        self._g_fn, ms = self._stacked(self.state_constraints_sym, nx)
        self._h_fn, mu = self._stacked(self.input_constraints_sym, nu)
        n_slack = (ms + mu) if self.soft_constraints else 0
        nX, nU = (T + 1) * nx, T * nu
        n_z = nX + nU + n_slack
        # Rows: initial state, dynamics, state constraints ((T+1) ms), input
        # constraints (T mu), slack >= 0.
        m_rows = nx + T * nx + (T + 1) * ms + T * mu + n_slack

        # The Hessian: stage Q (or Q_stage), terminal Q or P, R (or R_stage),
        # the slacks' quadratic penalty.
        Q_stage = np.asarray(getattr(self, 'Q_stage', self.Q))
        R_stage = np.asarray(getattr(self, 'R_stage', self.R))
        Qterm = self.P if self.use_lqr_gain_and_terminal_cost else self.Q
        blocks = ([Q_stage] * T + [Qterm] + [R_stage] * T
                  + ([np.eye(n_slack) * 2 * self.soft_penalty] if n_slack else []))
        P_qp = np.zeros((n_z, n_z))
        ofs = 0
        for blk in blocks:
            P_qp[ofs:ofs + blk.shape[0], ofs:ofs + blk.shape[0]] = blk
            ofs += blk.shape[0]
        self._P_qp = self._f32(P_qp)

        r_dyn0, r_sc0 = nx, nx + T * nx
        r_ic0 = r_sc0 + (T + 1) * ms
        r_sl0 = r_ic0 + T * mu
        idx = lambda *a: torch.as_tensor(_block_indices(*a, n_z), device=self.device)
        self._idx_dynA = idx(r_dyn0, 0, T, nx, nx, nx, nx)
        self._idx_dynB = idx(r_dyn0, nX, T, nx, nu, nx, nu)
        self._idx_G = idx(r_sc0, 0, T + 1, ms, nx, ms, nx) if ms else None
        self._idx_H = idx(r_ic0, nX, T, mu, nu, mu, nu) if mu else None

        # A's constant rows: the initial-state identity, the dynamics' +I,
        # the slacks' coupling and positivity.
        A_base = np.zeros((m_rows, n_z))
        A_base[:nx, :nx] = np.eye(nx)
        for k in range(T):
            A_base[r_dyn0 + k * nx:r_dyn0 + (k + 1) * nx, (k + 1) * nx:(k + 2) * nx] = np.eye(nx)
        if n_slack and ms:
            for k in range(T + 1):
                A_base[r_sc0 + k * ms:r_sc0 + (k + 1) * ms, nX + nU:nX + nU + ms] = -np.eye(ms)
        if n_slack and mu:
            for k in range(T):
                A_base[r_ic0 + k * mu:r_ic0 + (k + 1) * mu,
                       nX + nU + ms:nX + nU + ms + mu] = -np.eye(mu)
        if n_slack:
            A_base[r_sl0:r_sl0 + n_slack, nX + nU:nX + nU + n_slack] = np.eye(n_slack)
        self._A_base = self._f32(A_base)

        self._Q_stage, self._R_stage = self._f32(Q_stage), self._f32(R_stage)
        self._Qterm = self._f32(Qterm)
        self._U_EQ = self._f32(self.U_EQ)
        self._n_z, self._m_rows = n_z, m_rows
        self._ms, self._mu, self._n_slack = ms, mu, n_slack
        self._zero_tightening = None

    def _dynamics(self, dp):
        """fd(x, u): the closed-over dynamics, or a subclass's
        ``dynamics_func_param(x, u, dp)`` (parametric dynamics, GP-MPC)."""
        fd_param = getattr(self, 'dynamics_func_param', None)
        if fd_param is None:
            return self.dynamics_func
        return lambda x, u: fd_param(x, u, dp)

    def _build_and_solve(self, x_init, goal, X, U, z0, y0, tight_s, tight_u, dp,
                         polish=True, dp_batched=False):
        """One SQP iteration of B problems: linearize about (X, U), assemble
        the QP and solve it. ``x_init`` (B, nx), ``goal`` (B, T+1, nx), ``X``
        (B, T+1, nx), ``U`` (B, T, nu), the QP warm start ``z0`` (B, n_z) and
        ``y0`` (B, m), tightenings (B, T+1, ms) and (B, T, mu). With
        ``dp_batched`` every leaf of ``dp`` has a leading (B,) axis, problem b
        taking the parameters at b."""
        nx, nu, T = self.model.nx, self.model.nu, self.T
        ms, mu, n_slack = self._ms, self._mu, self._n_slack
        n_z, m_rows = self._n_z, self._m_rows
        B = X.shape[0]
        Xs, Us = X[:, :-1].reshape(-1, nx), U.reshape(-1, nu)
        if dp_batched:
            # Each horizon point takes its problem's parameters.
            dp_points = tree_map(lambda leaf: leaf.repeat_interleave(T, dim=0), dp)
            (A_k, B_k), f_k = vmap(jacfwd(
                lambda x, u, p: (self.dynamics_func_param(x, u, p),) * 2, argnums=(0, 1),
                has_aux=True))(Xs, Us, dp_points)
        else:
            fd = self._dynamics(dp)
            (A_k, B_k), f_k = vmap(jacfwd(lambda x, u: (fd(x, u),) * 2, argnums=(0, 1),
                                          has_aux=True))(Xs, Us)
        c_k = (f_k - (A_k @ Xs[..., None])[..., 0] - (B_k @ Us[..., None])[..., 0])
        A_mat = self._A_base.expand(B, m_rows, n_z).clone()
        flat = A_mat.view(B, -1)
        flat.index_copy_(1, self._idx_dynA, -A_k.reshape(B, -1))
        flat.index_copy_(1, self._idx_dynB, -B_k.reshape(B, -1))
        c_k = c_k.reshape(B, T * nx)
        tol = 0.0 if self.soft_constraints else float(self.constraint_tol)
        upper = []
        for fn, V, tight, idx in ((self._g_fn, X, tight_s, self._idx_G),
                                  (self._h_fn, U, tight_u, self._idx_H)):
            if fn is None:
                continue
            Vf = V.reshape(-1, V.shape[-1])
            G_k, g_val = vmap(jacfwd(lambda v: (fn(v),) * 2, has_aux=True))(Vf)
            b = (G_k @ Vf[..., None])[..., 0] - g_val - tight.reshape(g_val.shape)
            if tol:
                b = b - tol
            flat.index_copy_(1, idx, G_k.reshape(B, -1))
            upper.append(b.reshape(B, -1))
        n_ineq = (T + 1) * ms + T * mu
        big = torch.full((B, n_ineq + n_slack), BIG, device=self.device)
        l = torch.cat([x_init, c_k, -big[:, :n_ineq], torch.zeros_like(big[:, n_ineq:])], dim=1)
        u = torch.cat([x_init, c_k, *upper, big[:, n_ineq:]], dim=1)
        # The linear cost from the references: stage -Q xr, terminal
        # -Qterm xr, inputs -R u_eq.
        q_x = (-goal[:, :T] @ self._Q_stage).reshape(B, -1)
        q_xT = -(goal[:, T] @ self._Qterm.T)
        q_u = (-(self._R_stage @ self._U_EQ)).repeat(T).expand(B, T * nu)
        q = torch.cat([q_x, q_xT, q_u, torch.zeros((B, n_slack), device=self.device)], dim=1)
        # qp_iters is a budget: the stages exit early at 0.1 feas_tol.
        sol = admm_qp(self._P_qp, q, A_mat, l, u, x0=z0, y0=y0, iters=self.qp_iters,
                      tol=0.1 * float(self.feas_tol), polish=polish)
        self.qp_iterations.append(sol.iterations)
        nX = (T + 1) * nx
        return (sol.x[:, :nX].reshape(B, T + 1, nx), sol.x[:, nX:nX + T * nu].reshape(B, T, nu),
                sol.x, sol.y, sol.prim_res)

    @full_matmul_precision
    def _solve(self, x_init, goal, X, U, z, y, tight_s, tight_u, dp=None, dp_batched=False):
        """``sqp_iters`` SQP iterations of B problems: the earlier ones
        unpolished (they are re-linearized anyway), the last polished.
        Returns X, U, the QP's x and y (the next warm start) and its primal
        residual (B,). ``qp_iterations`` keeps each QP's ADMM iterations,
        (B,) tensors on the device."""
        self.qp_iterations = []
        for _ in range(self.sqp_iters - 1):
            X, U, z, y, _ = self._build_and_solve(x_init, goal, X, U, z, y, tight_s, tight_u,
                                                  dp, polish=False, dp_batched=dp_batched)
        return self._build_and_solve(x_init, goal, X, U, z, y, tight_s, tight_u, dp,
                                     polish=True, dp_batched=dp_batched)

    def _cold_start(self, x0):
        """The cold guess of B problems from their (B, nx) initial states."""
        B, T = x0.shape[0], self.T
        X0 = x0[:, None, :].expand(B, T + 1, self.model.nx)
        U0 = self._U_EQ.expand(B, T, self.model.nu)
        return (X0, U0, torch.zeros((B, self._n_z), device=self.device),
                torch.zeros((B, self._m_rows), device=self.device))

    def _tightening(self, B):
        """Zero constraint tightenings of B problems (GP-MPC's chance
        constraints would set them)."""
        cached = self._zero_tightening
        if cached is None or cached[0].shape[0] != B:
            cached = (torch.zeros((B, self.T + 1, self._ms), device=self.device),
                      torch.zeros((B, self.T, self._mu), device=self.device))
            self._zero_tightening = cached
        return cached

    def _feas_scale(self, obs, goal):
        """feas_tol's scale of each problem: max(1, |obs|, |goal|) if relative."""
        if not self.feas_tol_relative:
            return np.ones(obs.shape[0])
        scale = np.maximum(1.0, np.abs(obs).max(axis=1))
        return np.maximum(scale, float(np.max(np.abs(goal))))

    # -- batched / multi-GPU solves ---------------------------------------
    def shard_over(self, mesh, axis_name: str = 'data'):
        """Split the B problems of ``select_action_batch`` over ``axis_name``
        of ``mesh`` (``parallel/sharding.py``): rank r solves rows ``[r B/W,
        (r+1) B/W)`` (the ADMM stages capture their graphs at that shape) and
        every rank returns the whole batch, gathered; ``batch_horizons`` holds
        the rank's rows. A B that does not divide over the axis raises
        ValueError. No collective runs inside the solve."""
        mesh.check_device(self.device)
        self._solve_mesh, self._solve_mesh_axis = mesh, axis_name

    def select_action_scenarios(self, obs, dynamics_params_batch, step: int = 0):
        """The same cold-started receding-horizon problem at ``obs`` under B
        sets of parameters of the dynamics, as one batched solve: the
        scenario sweep of domain-randomized or minimax robust MPC. It needs
        the parametric hook ``dynamics_func_param(x, u, params)``;
        ``dynamics_params_batch`` is a pytree of tensors (dicts, lists,
        tuples) whose leaves have a leading scenario axis B. Returns
        ``(actions (B, nu), feasible (B,) bool)``, numpy: one candidate action
        a scenario (examples/mpc/scenario_mpc_demo.py picks among them);
        ``batch_horizons`` keeps the horizons on the device."""
        if getattr(self, 'dynamics_func_param', None) is None:
            raise ValueError('select_action_scenarios requires dynamics_func_param')
        nx = self.model.nx
        obs_np = np.asarray(obs, np.float32)[:nx]
        goal = self.get_references(step)
        dp = tree_map(lambda leaf: torch.as_tensor(leaf, dtype=torch.float32,
                                                   device=self.device), dynamics_params_batch)
        B = tree_leaves(dp)[0].shape[0]
        x0 = self._f32(obs_np[None]).expand(B, nx)
        goal_t = self._f32(goal.T).expand(B, self.T + 1, nx)
        return self._batch_answers(
            self._solve(x0, goal_t, *self._cold_start(x0), *self._tightening(B), dp,
                        dp_batched=True), obs_np[None], goal)

    @batch_split(1)
    def select_action_batch(self, obs_batch, step: int = 0):
        """B independent cold-started receding-horizon solves as one batched
        solve on the env's device. Returns ``(actions (B, nu), feasible (B,)
        bool)``, numpy; ``batch_horizons`` keeps the solve's horizons, X (B,
        T+1, nx) and U (B, T, nu), on the device."""
        nx = self.model.nx
        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))[:, :nx]
        B = obs_batch.shape[0]
        goal = self.get_references(step)
        x0 = self._f32(obs_batch)
        goal_t = self._f32(goal.T).expand(B, self.T + 1, nx)
        return self._batch_answers(
            self._solve(x0, goal_t, *self._cold_start(x0), *self._tightening(B),
                        getattr(self, 'dynamics_params', None)), obs_batch, goal)

    def _batch_answers(self, solution, obs_batch, goal, extra=None):
        """The first inputs and feasibility flags of a batched solve (and
        the (B,) tensor ``extra``'s values), read back in one copy."""
        X, U, _, _, res = solution
        self.batch_horizons = (X, U)
        cols = [U[:, 0], res[:, None]] + ([extra[:, None].to(res.dtype)] if extra is not None
                                          else [])
        host = torch.cat(cols, dim=1).cpu().numpy()
        nu = U.shape[-1]
        u0, res_np = host[:, :nu], host[:, nu]
        feasible = np.isfinite(res_np) & (res_np < self.feas_tol * self._feas_scale(
            obs_batch, goal))
        if extra is not None:
            return u0, feasible, host[:, nu + 1]
        return u0, feasible

    # ------------------------------------------------------------------
    def select_action(self, obs, info=None):
        """The warm-started receding-horizon solve; returns the first input."""
        t0 = time.perf_counter()
        nx, nu, T = self.model.nx, self.model.nu, self.T
        step = self.extract_step(info)
        goal_states = self.get_references(step)  # (nx, T+1)
        obs_np = np.asarray(obs, np.float32)
        used_warmstart = self.warmstart and self.x_prev is not None and self.u_prev is not None
        if used_warmstart:
            x_guess = np.roll(self.x_prev, -1, axis=1)
            x_guess[:, -1] = self.x_prev[:, -1]
            u_guess = np.roll(np.atleast_2d(self.u_prev), -1, axis=-1)
            guess = (x_guess.T, u_guess.reshape(nu, T).T) + self._qp_warm
        else:
            guess = None
        X_np, U_np, res_v, z, y = self._dispatch_solve(obs_np, goal_states, guess, step)
        tol = self.feas_tol * float(self._feas_scale(obs_np[None], goal_states)[0])
        feasible = bool(np.isfinite(res_v) and res_v < tol)
        if not feasible and used_warmstart:
            # A stale warm start is not infeasibility: retry cold first.
            X_np, U_np, res_v, z, y = self._dispatch_solve(obs_np, goal_states, None, step)
            feasible = bool(np.isfinite(res_v) and res_v < tol)
        if feasible:
            x_val = X_np.T                # (nx, T+1), as the reference's
            u_val = U_np.T.squeeze()      # (nu, T), squeezed
            self._qp_warm = (z, y)
        else:
            # The reference's fallback ladder.
            if self.u_prev is None:
                u_val = np.zeros((nu, T)).squeeze()
                x_val = np.zeros((nx, T + 1))
            else:
                u_val = self.u_prev
                x_val = self.x_prev
            self.terminate_loop = True
        self.x_prev = x_val
        self.u_prev = u_val
        self.results_dict['horizon_states'].append(deepcopy(self.x_prev))
        self.results_dict['horizon_inputs'].append(deepcopy(self.u_prev))
        self.results_dict['goal_states'].append(deepcopy(goal_states))
        self.results_dict['t_wall'].append(time.perf_counter() - t0)
        u_arr = np.atleast_2d(u_val)
        if u_arr.shape[0] != nu:
            u_arr = u_arr.reshape(nu, -1)
        action = np.array(u_arr[:, 0]).reshape(nu)
        if self.use_lqr_gain_and_terminal_cost:
            action = action + self.lqr_gain @ (np.asarray(obs) - x_val[:, 0])
        self.prev_action = action
        return action

    def _dispatch_solve(self, obs_np, goal_states, guess, step):
        """One solve of the problem at ``obs_np`` from ``guess`` (X0, U0, z0,
        y0, numpy), or cold; returns X (T+1, nx), U (T, nu), the residual, z
        and y as numpy, read back in one copy."""
        nx, nu, T = self.model.nx, self.model.nu, self.T
        x0 = self._f32(obs_np[None])
        if guess is None:
            start = self._cold_start(x0)
        else:
            start = tuple(self._f32(a)[None] for a in guess)
        X, U, z, y, res = self._solve(x0, self._f32(goal_states.T)[None], *start,
                                      *self._constraint_tightening(step),
                                      getattr(self, 'dynamics_params', None))
        host = torch.cat([X.reshape(-1), U.reshape(-1), res, z.reshape(-1),
                          y.reshape(-1)]).cpu().numpy()
        sizes = np.cumsum([(T + 1) * nx, T * nu, 1, self._n_z])
        X_np, U_np, res_v, z_np, y_np = np.split(host, sizes)
        return (X_np.reshape(T + 1, nx), U_np.reshape(T, nu), float(res_v[0]), z_np, y_np)

    def _constraint_tightening(self, step):
        """Per-step tightening of the constraint bounds, (1, T+1, ms) and
        (1, T, mu): zeros (GP-MPC overrides it)."""
        return self._tightening(1)

    def get_references(self, step):
        """The reference window over the horizon, (nx, T+1)."""
        if self.env.TASK == Task.STABILIZATION:
            return np.tile(self.env.X_GOAL.reshape(-1, 1), (1, self.T + 1))
        if self.env.TASK == Task.TRAJ_TRACKING:
            start = min(step, self.traj.shape[-1])
            end = min(step + self.T + 1, self.traj.shape[-1])
            remain = max(0, self.T + 1 - (end - start))
            return np.concatenate([self.traj[:, start:end],
                                   np.tile(self.traj[:, -1:], (1, remain))], -1)
        raise Exception('Reference for this mode is not implemented.')

    def setup_results_dict(self):
        self.results_dict = {'obs': [], 'reward': [], 'done': [], 'info': [],
                             'action': [], 'horizon_inputs': [],
                             'horizon_states': [], 'goal_states': [],
                             'frames': [], 'state_mse': [], 'common_cost': [],
                             'state': [], 'state_error': [], 't_wall': []}

    def learn(self, env=None, **kwargs):
        return

    def run(self, env=None, render=False, logging=False, max_steps=None,
            terminate_run_on_done=None):
        """A closed-loop episode with the current controller; returns the
        results dict (observations, states, actions, per-step errors and
        solve times, and the RMSEs; with ``render``, each step's RGB frame
        under ``frames``)."""
        if env is None:
            env = self.env
        if terminate_run_on_done is None:
            terminate_run_on_done = getattr(self, 'terminate_run_on_done', True)
        self.reset_before_run()
        obs, info = env.reset()
        self.setup_results_dict()
        self.results_dict['obs'].append(obs)
        self.results_dict['state'].append(env.state)
        if max_steps is None:
            if env.TASK == Task.TRAJ_TRACKING:
                max_steps = self.traj.shape[1]
            else:
                max_steps = int(env.CTRL_FREQ * env.EPISODE_LEN_SEC)
        self.terminate_loop = False
        done = False
        i = 0
        common_metric = 0.0
        while (not (done and terminate_run_on_done) and i < max_steps
               and not self.terminate_loop):
            action = self.select_action(obs, info)
            if self.terminate_loop:
                break
            obs, reward, done, info = env.step(action)
            self.results_dict['obs'].append(obs)
            self.results_dict['reward'].append(reward)
            self.results_dict['done'].append(done)
            self.results_dict['info'].append(info)
            self.results_dict['action'].append(action)
            self.results_dict['state'].append(env.state)
            self.results_dict['state_mse'].append(info['mse'])
            goal_i = env.X_GOAL[i, :] if env.X_GOAL.ndim > 1 else env.X_GOAL
            self.results_dict['state_error'].append(env.state - goal_i)
            common_metric += info['mse']
            if render:
                self.results_dict['frames'].append(env.render('rgb_array'))
            i += 1
        self.results_dict['obs'] = np.vstack(self.results_dict['obs'])
        self.results_dict['state'] = np.vstack(self.results_dict['state'])
        try:
            self.results_dict['reward'] = np.vstack(self.results_dict['reward'])
            self.results_dict['action'] = np.vstack(self.results_dict['action'])
            self.results_dict['full_traj_common_cost'] = common_metric
            # The reference feeds the raw states and observations here, not
            # the errors: kept for its metrics.
            self.results_dict['total_rmse_state_error'] = compute_state_rmse(
                self.results_dict['state'])
            self.results_dict['total_rmse_obs_error'] = compute_state_rmse(
                self.results_dict['obs'])
        except ValueError as exc:
            raise RuntimeError(
                '[ERROR] mpc.run(): MPC could not find a solution for the first step '
                'given the initial conditions. Check that the initial conditions are '
                'feasible.') from exc
        return deepcopy(self.results_dict)
