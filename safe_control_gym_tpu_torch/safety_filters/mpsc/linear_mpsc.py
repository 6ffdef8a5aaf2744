"""Linear model predictive safety certification.

Port of ``safe_control_gym_tpu/safety_filters/mpsc/linear_mpsc.py``
(``LINEAR_MPSC``):

* ``learn()`` collects ``n_samples`` one-step residuals w = x_next_real -
  x_next_model from the training env (each step a K1 or K2 launch on the
  card) and computes the RPI ellipse P on the env's device
  (``mpsc_utils.compute_RPI_set``), then the tightening and the optimizer;
* the tightening is the exact box Pontryagin difference of the constraint
  boxes and the ellipse's bounding box;
* an optional terminal set grows a polytope from feasible solves (scipy's
  qhull);
* the certification problem is a tube MPC over z (H+1 states) and v (H
  inputs): the dynamics, the tightened state and input constraints, a
  terminal set, and the ellipse on x_init - z_0 enforced as its certified
  eigen-aligned inner box; the cost ``|| u_L - next_u ||^2`` with
  ``next_u = v_0 + U_EQ + K (x_init - z_0)``, plus a small pull of z_0
  toward x_init that picks the tube's centre among equal-cost optima;
* each solve is ``sqp_iters`` SQP iterations of the batched ADMM QP
  (``ops/qp.py``, each ADMM stage a captured CUDA graph on the card): the
  dynamics linearized by ``torch.func.vmap(jacfwd(.))`` over the horizon, A
  a clone of the constant rows with the Jacobian blocks copied in by
  ``index_copy_``; the last iteration polished;
* feasibility is the QP's primal residual under ``feas_tol`` (relative to
  the data's size with ``feas_tol_relative``), then the true ellipse and the
  terminal ball are checked again on the host;
* ``solve_optimization`` warm-starts from the shifted last plan and the
  QP's last (x, y), with one read from the device a solve besides the QP's
  stage exits; ``certify_action_batch`` solves B cold problems at once;
* the re-linearization point X_EQ follows the observation's position
  (``before_optimization``); it is an argument of the solve, never a
  constant of ``setup_optimizer``;
* ``save``/``load`` keep P (and the terminal set's vertices) as a pickle of
  numpy arrays, read through the port's restricted unpickler.

``shard_over(mesh)`` splits the B problems of ``certify_action_batch`` over
``torch.distributed`` ranks (``parallel/sharding.batch_split``): each rank
certifies its rows and every rank returns the whole batch.
"""

from __future__ import annotations

import time
from itertools import product

import numpy as np
import torch
from torch.func import jacfwd, vmap

from safe_control_gym_tpu_torch.controllers.mpc.mpc import BIG, _block_indices
from safe_control_gym_tpu_torch.controllers.mpc.mpc_utils import rk_discrete
from safe_control_gym_tpu_torch.envs.benchmark_env import Task
from safe_control_gym_tpu_torch.envs.constraints import (ConstrainedVariableType,
                                                         QuadraticConstraint)
from safe_control_gym_tpu_torch.math.linalg import (discretize_linear_system,
                                                    full_matmul_precision)
from safe_control_gym_tpu_torch.ops.qp import admm_qp
from safe_control_gym_tpu_torch.parallel.sharding import batch_split
from safe_control_gym_tpu_torch.safety_filters.mpsc.mpsc import MPSC
from safe_control_gym_tpu_torch.safety_filters.mpsc.mpsc_utils import (
    Cost_Function, compute_RPI_set, ellipse_bounding_box, pontryagin_difference_AABB,
    vertices_to_halfspaces)
from safe_control_gym_tpu_torch.utils.checkpoint import CheckpointUnpickler, save_checkpoint

__all__ = ['LINEAR_MPSC']

# The weight of the pull of z_0 toward x_init, (z_0 - x_init)' P (z_0 - x_init).
W_OMEGA = 1e-2


class LINEAR_MPSC(MPSC):
    """Model predictive safety certification with a linear tube."""

    def __init__(self, env_func, horizon: int = 10, q_lin: list = None, r_lin: list = None,
                 integration_algo: str = 'rk4', n_samples: int = 600,
                 n_samples_terminal_set: int = 100, tau: float = 0.95,
                 warmstart: bool = True, additional_constraints: list = None,
                 use_terminal_set: bool = True, learn_terminal_set: bool = False,
                 sqp_iters: int = 2, qp_iters: int = 1000, feas_tol: float = 5e-3,
                 feas_tol_relative: bool = True,
                 cost_function: str = Cost_Function.ONE_STEP_COST, **kwargs):
        self.n_samples = n_samples
        self.n_samples_terminal_set = n_samples_terminal_set
        self.tau = tau
        self.learn_terminal_set = learn_terminal_set
        self.sqp_iters = int(sqp_iters)
        self.qp_iters = int(qp_iters)
        # Feasibility: the final QP primal residual under feas_tol, scaled
        # with the data (OSQP's eps_abs + eps_rel convention) if relative.
        self.feas_tol = float(feas_tol)
        self.feas_tol_relative = bool(feas_tol_relative)
        super().__init__(env_func, horizon, q_lin, r_lin, integration_algo, warmstart,
                         additional_constraints, use_terminal_set, cost_function, **kwargs)
        self.terminal_set_verts = None
        self._solver_ready = False
        self._qp_warm = None

    def _f32(self, a):
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def set_dynamics(self):
        """The delta-coordinate dynamics: the Euler discretization at the
        origin ('LTI') or RK4 of the nonlinear prior with u = v + U_EQ."""
        df = self.model.df_func(x=np.zeros(self.model.nx),
                                u=np.atleast_1d(np.asarray(self.model.U_EQ)))
        Ad, Bd = discretize_linear_system(df['dfdx'], df['dfdu'], self.model.dt)
        self.discrete_dfdx, self.discrete_dfdu = Ad.cpu().numpy(), Bd.cpu().numpy()
        if self.integration_algo == 'LTI':
            Ad_t, Bd_t = self._f32(self.discrete_dfdx), self._f32(self.discrete_dfdu)

            def dynamics_func(z, v):
                return Ad_t @ z + Bd_t @ v
        else:
            U_EQ = self._f32(np.atleast_1d(np.asarray(self.model.U_EQ)))
            rk = rk_discrete(self.model.fc_fn, self.model.nx, self.model.nu, self.model.dt)

            def dynamics_func(z, v):
                return rk(z, v + U_EQ)
        self.dynamics_func = dynamics_func

    def _dynamics_for_residual(self, x0_delta, u):
        """The model's next delta state from x0_delta under the absolute
        input u (both modes take v = u - U_EQ)."""
        with torch.no_grad():
            return self.dynamics_func(self._f32(x0_delta),
                                      self._f32(u - self.U_EQ)).cpu().numpy()

    # ------------------------------------------------------------------
    def learn(self, env=None, **kwargs):
        """Residuals -> RPI set -> tightening -> optimizer. The inputs are
        drawn from ``np.random.default_rng(seed)`` (the JAX package draws the
        cartpole's from its gymnasium space instead). ``learn_seconds``
        keeps the split: residual collection, the descent, the
        certification search, and the rest (tightening and set-up)."""
        if env is None:
            env = self.training_env
        nx, nu = self.model.nx, self.model.nu
        t0 = time.perf_counter()
        self._learn_rng = np.random.default_rng(self.seed)
        w = np.zeros((nx, self.n_samples))
        for i in range(self.n_samples):
            init_state, _ = env.reset()
            init_state = init_state[:nx]
            if self.env.NAME == 'quadrotor':
                u = self._learn_rng.random(nu) / 20 - 1 / 40 + self.U_EQ
            else:
                u = env.action_space.sample(self._learn_rng)
            x_next_obs, _, _, _ = env.step(u)
            x_next_linear = self._dynamics_for_residual(init_state - self.X_EQ, u) + self.X_EQ
            w[:, i] = x_next_obs[:nx] - x_next_linear
        timings = {'collection_s': time.perf_counter() - t0}
        A_cl = self.discrete_dfdx + self.discrete_dfdu @ self.lqr_gain
        self.P = compute_RPI_set(A_cl, w, self.tau, device=self.device, timings=timings)
        self.residuals = w
        t1 = time.perf_counter()
        self._set_tube()
        if self.learn_terminal_set:
            self._learn_terminal_set(env)
        timings['setup_s'] = time.perf_counter() - t1
        self.learn_seconds = timings

    def _set_tube(self):
        """The ellipse's box, the tightening, the ellipse constraint and the
        optimizer, from ``self.P``."""
        self.omega_AABB_verts = ellipse_bounding_box(self.P)
        self.tighten_state_and_input_constraints()
        self.omega_constraint = QuadraticConstraint(
            self.env, self.P, 1.0, constrained_variable=ConstrainedVariableType.STATE)
        self.setup_optimizer()

    def _learn_terminal_set(self, env):
        """Grow a terminal polytope from the plans of feasible solves, the
        samples drawn from the filter's seeded stream (numpy's legacy
        generator, which the JAX package seeds globally)."""
        nx, nu = self.model.nx, self.model.nu
        verts = np.asarray(self.env.X_GOAL) if self.env.TASK == Task.TRAJ_TRACKING else None
        rng = self._np_random
        points = None
        for _ in range(self.n_samples_terminal_set):
            if verts is None:
                init_state = np.asarray(self.X_EQ, dtype=float).copy()
            else:
                init_state = verts[rng.choice(verts.shape[0])].copy()
            init_state = init_state + (rng.rand(nx) - 0.5) / 2
            if self.env.NAME == 'quadrotor':
                u = rng.rand(nu) / 6 - 1 / 12 + self.U_EQ
            else:
                u = env.action_space.sample(rng)
            _, feasible = self.solve_optimization(obs=init_state, uncertified_action=u)
            if feasible:
                new_pts = self.z_prev.T
                points = new_pts if points is None else np.vstack((points, new_pts))
                if verts is not None:
                    points = np.vstack((points, verts))
                try:
                    self.terminal_set = vertices_to_halfspaces(points)
                    self.setup_optimizer()
                except Exception:
                    pass
        self.terminal_set_verts = points

    # ------------------------------------------------------------------
    def load(self, path):
        """P (and the terminal set, with ``learn_terminal_set``) from a
        pickle of numpy arrays, read by the restricted unpickler."""
        with open(path, 'rb') as f:
            parameters = CheckpointUnpickler(f).load()
        self.P = parameters['P']
        if self.learn_terminal_set and 'terminal_set' in parameters:
            self.terminal_set_verts = parameters['terminal_set']
            self.terminal_set = vertices_to_halfspaces(self.terminal_set_verts)
        self._set_tube()

    def save(self, path):
        parameters = {'P': self.P}
        if self.learn_terminal_set and self.terminal_set_verts is not None:
            parameters['terminal_set'] = self.terminal_set_verts
        save_checkpoint(path, parameters)

    # ------------------------------------------------------------------
    def tighten_state_and_input_constraints(self):
        """The constraint boxes less the ellipse's box (states) and less K
        times it (inputs)."""
        K_verts_raw = (self.lqr_gain @ self.omega_AABB_verts.T).T
        lims = np.array([np.amax(K_verts_raw, axis=0), np.amin(K_verts_raw, axis=0)])
        self.K_omega_AABB_verts = np.vstack(list(product(*(lims.T))))
        input_constraint = self.constraints.input_constraints
        if len(input_constraint) > 1:
            raise NotImplementedError("MPSC currently can't handle more than 1 constraint")
        input_constraint = input_constraint[0]
        quad = self.training_env.NAME == 'quadrotor'
        if not quad:
            U_verts_raw = [(input_constraint.upper_bounds[i], input_constraint.lower_bounds[i])
                           for i in range(self.model.nu)]
        else:
            U_verts_raw = [(input_constraint.upper_bounds[i], -input_constraint.upper_bounds[i])
                           for i in range(self.model.nu)]
        self.U_vertices = np.clip(np.vstack(list(product(*U_verts_raw))), -100, 100)
        (self.tightened_input_constraint_verts,
         tightened_input_func) = pontryagin_difference_AABB(self.U_vertices,
                                                            self.K_omega_AABB_verts)
        if quad:
            min_input = (input_constraint.lower_bounds[0] + np.max(self.U_vertices)
                         - np.max(self.tightened_input_constraint_verts))
            self.tightened_input_constraint_verts = np.clip(
                self.tightened_input_constraint_verts, min_input, 100)
        self.tightened_input_constraint = tightened_input_func(
            env=self.env, constrained_variable=ConstrainedVariableType.INPUT)
        state_constraints = self.constraints.state_constraints
        if len(state_constraints) > 1:
            raise NotImplementedError("MPSC currently can't handle more than 1 constraint")
        state_constraints = state_constraints[0]
        X_verts_raw = [(state_constraints.upper_bounds[i], state_constraints.lower_bounds[i])
                       for i in range(self.model.nx)]
        self.X_vertices = np.clip(np.vstack(list(product(*X_verts_raw))), -100, 100)
        (self.tightened_state_constraint_verts,
         tightened_state_func) = pontryagin_difference_AABB(self.X_vertices,
                                                            self.omega_AABB_verts)
        self.tightened_state_constraint = tightened_state_func(
            env=self.env, constrained_variable=ConstrainedVariableType.STATE)
        self.simple_terminal_set = QuadraticConstraint(
            env=self.env, P=np.eye(self.model.nx),
            b=float(self.env.TASK_INFO['stabilization_goal_tolerance']),
            constrained_variable=ConstrainedVariableType.STATE)

    # ------------------------------------------------------------------
    def setup_optimizer(self):
        """The tube QP's constant structure on the env's device: the Hessian,
        A's constant rows, the bounds of the constant rows and the flat
        indices of the dynamics' Jacobian blocks."""
        H = self.horizon
        nx, nu = self.model.nx, self.model.nu
        nZ, nV = (H + 1) * nx, H * nu
        n_z = nZ + nV
        A_u = np.asarray(self.tightened_input_constraint.A, np.float32)
        b_u = np.asarray(self.tightened_input_constraint.b, np.float32)
        A_s = np.asarray(self.tightened_state_constraint.A, np.float32)
        b_s = np.asarray(self.tightened_state_constraint.b, np.float32)
        m_u, m_s = A_u.shape[0], A_s.shape[0]
        self._terminal_quadratic = False
        self._term_tol = None
        if self.use_terminal_set and self.terminal_set is not None:
            A_t = np.asarray(self.terminal_set[0], np.float32)
            b_t = np.asarray(self.terminal_set[1], np.float32)
            m_t = A_t.shape[0]
            t_lo, t_hi = np.full(m_t, -BIG, np.float32), b_t
        elif self.use_terminal_set:
            # The ball ||z_T||^2 <= tol as its certified inner box
            # |z_T,i| <= sqrt(tol / nx) (a linearized ball is a relaxation);
            # the ball itself is checked again before 'feasible'.
            self._terminal_quadratic = True
            self._term_tol = float(self.env.TASK_INFO['stabilization_goal_tolerance'])
            term_hw = float(np.sqrt(max(self._term_tol, 0.0) / nx))
            A_t, m_t = np.eye(nx, dtype=np.float32), nx
            t_lo, t_hi = np.full(m_t, -term_hw, np.float32), np.full(m_t, term_hw, np.float32)
        else:
            m_t = 0
        # The one-step cost ||c0 + M d||^2 over d = [z0; v0], a 1e-6
        # regularization of every variable, and the pull of z0 toward x_init.
        M = np.asarray(self.cost_function.get_cost({'lqr_gain': self.lqr_gain}), np.float32)
        MtM = 2.0 * M.T @ M
        P_qp = np.zeros((n_z, n_z), np.float32)
        d_idx = np.r_[0:nx, nZ:nZ + nu]
        P_qp[np.ix_(d_idx, d_idx)] += MtM
        P_qp += np.eye(n_z, dtype=np.float32) * 1e-6
        P_qp[:nx, :nx] += 2.0 * W_OMEGA * np.asarray(self.P, np.float32)
        # The ellipse (x_init - z0)'P(x_init - z0) <= 1 as the eigen-aligned
        # box |V'(x_init - z0)|_i <= 1 / sqrt(nx lam_i), P = V diag(lam) V':
        # exact linear rows whose box lies inside the ellipse.
        lam, Vp = np.linalg.eigh(np.asarray(self.P, np.float64))
        omega_rows = np.asarray(Vp.T, np.float32)
        omega_hw = np.asarray(1.0 / np.sqrt(nx * np.clip(lam, 1e-12, None)), np.float32)
        # Rows: dynamics, states (z_0..z_H-1), inputs, terminal, omega box.
        r0 = H * nx
        r1 = r0 + H * m_s
        r2 = r1 + H * m_u
        r3 = r2 + m_t
        m_rows = r3 + nx
        A_base = np.zeros((m_rows, n_z), np.float32)
        for k in range(H):
            A_base[k * nx:(k + 1) * nx, (k + 1) * nx:(k + 2) * nx] = np.eye(nx)
            A_base[r0 + k * m_s:r0 + (k + 1) * m_s, k * nx:(k + 1) * nx] = A_s
            A_base[r1 + k * m_u:r1 + (k + 1) * m_u, nZ + k * nu:nZ + (k + 1) * nu] = A_u
        if m_t:
            A_base[r2:r3, H * nx:(H + 1) * nx] = A_t
        A_base[r3:, :nx] = omega_rows
        U_EQ = np.asarray(self.U_EQ, np.float32)
        # The bounds of the input and terminal rows (constant); the state
        # rows' upper bounds b_s - A_s xeq follow each problem's xeq.
        mid_l = np.concatenate([np.full(H * m_u, -BIG, np.float32),
                                t_lo if m_t else np.zeros(0, np.float32)])
        mid_u = np.concatenate([np.tile(b_u - A_u @ U_EQ, H),
                                t_hi if m_t else np.zeros(0, np.float32)])
        idx = lambda *a: torch.as_tensor(_block_indices(*a, n_z), device=self.device)
        self._idx_dynA = idx(0, 0, H, nx, nx, nx, nx)
        self._idx_dynB = idx(0, nZ, H, nx, nu, nx, nu)
        self._P_qp = self._f32(P_qp)
        self._A_base = self._f32(A_base)
        self._mid_l, self._mid_u = self._f32(mid_l), self._f32(mid_u)
        self._A_s, self._b_s = self._f32(A_s), self._f32(b_s)
        self._omega_rows, self._omega_hw = self._f32(omega_rows), self._f32(omega_hw)
        self._M_cost, self._K = self._f32(M), self._f32(self.lqr_gain)
        self._P_omega_w = self._f32(2.0 * W_OMEGA * np.asarray(self.P))
        self._U_EQ_t = self._f32(U_EQ)
        self._n_z, self._m_rows = n_z, m_rows
        self._m_s_rows = H * m_s
        self._solver_ready = True
        self._qp_warm = None

    def _build_and_solve(self, x_init, u_L, xeq, Z, V, z_ws, y_ws, polish):
        """One SQP iteration of B problems: linearize about (Z, V), assemble
        the QP and solve it. ``x_init``, ``xeq`` (B, nx), ``u_L`` (B, nu),
        ``Z`` (B, H+1, nx), ``V`` (B, H, nu), the QP warm start ``z_ws`` (B,
        n_z) and ``y_ws`` (B, m)."""
        H, nx, nu = self.horizon, self.model.nx, self.model.nu
        n_z, m_rows = self._n_z, self._m_rows
        B = Z.shape[0]
        Zs, Vs = Z[:, :-1].reshape(-1, nx), V.reshape(-1, nu)
        (A_k, B_k), f_k = vmap(jacfwd(lambda z, v: (self.dynamics_func(z, v),) * 2,
                                      argnums=(0, 1), has_aux=True))(Zs, Vs)
        c_k = (f_k - (A_k @ Zs[..., None])[..., 0]
               - (B_k @ Vs[..., None])[..., 0]).reshape(B, H * nx)
        A_mat = self._A_base.expand(B, m_rows, n_z).clone()
        flat = A_mat.view(B, -1)
        flat.index_copy_(1, self._idx_dynA, -A_k.reshape(B, -1))
        flat.index_copy_(1, self._idx_dynB, -B_k.reshape(B, -1))
        # The state rows bound z_k + xeq; the omega rows bound V'z0 about
        # V'x_init.
        s_u = (self._b_s - xeq @ self._A_s.T).repeat(1, H)
        xi_c = x_init @ self._omega_rows.T
        l = torch.cat([c_k, torch.full((B, self._m_s_rows), -BIG, device=self.device),
                       self._mid_l.expand(B, -1), xi_c - self._omega_hw], dim=1)
        u = torch.cat([c_k, s_u, self._mid_u.expand(B, -1), xi_c + self._omega_hw], dim=1)
        # The linear cost from ||c0 + M d||^2, c0 = u_L - U_EQ - K x_init.
        c0 = u_L - self._U_EQ_t - x_init @ self._K.T
        q_d = 2.0 * (c0 @ self._M_cost)
        zeros = torch.zeros((B, n_z), device=self.device)
        nZ = (H + 1) * nx
        q = torch.cat([q_d[:, :nx] - x_init @ self._P_omega_w.T, zeros[:, :nZ - nx],
                       q_d[:, nx:], zeros[:, :H * nu - nu]], dim=1)
        # qp_iters is a budget: the stages exit early at 0.1 feas_tol. A
        # certification runs up to sqp_iters x qp_iters ADMM iterations; on the
        # card each stage of them replays as one CUDA graph.
        sol = admm_qp(self._P_qp, q, A_mat, l, u, x0=z_ws, y0=y_ws, iters=self.qp_iters,
                      tol=0.1 * self.feas_tol, polish=polish, capture=True)
        self.qp_iterations.append(sol.iterations)
        return (sol.x[:, :nZ].reshape(B, H + 1, nx), sol.x[:, nZ:].reshape(B, H, nu),
                sol.x, sol.y, sol.prim_res)

    @full_matmul_precision
    def _solve(self, x_init, u_L, xeq, Z, V, z_ws, y_ws):
        """``sqp_iters`` SQP iterations of B problems, the last polished.
        Returns Z, V, the QP's x and y and its primal residual (B,);
        ``qp_iterations`` keeps each QP's ADMM iterations."""
        self.qp_iterations = []
        for _ in range(self.sqp_iters - 1):
            Z, V, z_ws, y_ws, _ = self._build_and_solve(x_init, u_L, xeq, Z, V, z_ws, y_ws,
                                                        polish=False)
        return self._build_and_solve(x_init, u_L, xeq, Z, V, z_ws, y_ws, polish=True)

    def _check_ready(self):
        if not self._solver_ready:
            raise RuntimeError('[ERROR] LINEAR_MPSC must run learn() or load() before '
                               'certification.')

    def shard_over(self, mesh, axis_name: str = 'data'):
        """Split the B problems of ``certify_action_batch`` over ``axis_name``
        of ``mesh`` (``parallel/sharding.py``): rank r certifies rows ``[r
        B/W, (r+1) B/W)`` and every rank returns the whole batch;
        ``batch_plans`` holds the rank's rows. A B that does not divide over
        the axis raises ValueError."""
        mesh.check_device(self.device)
        self._solve_mesh, self._solve_mesh_axis = mesh, axis_name

    def _xeq_for(self, obs):
        """The re-linearization point of one observation (the rule of
        ``before_optimization``)."""
        obs = np.asarray(obs)
        out = np.zeros(self.model.nx, np.float32)
        if self.env.NAME == 'cartpole':
            out[0] = obs[0]
        elif self.env.NAME == 'quadrotor' and self.model.nx == 6:
            out[0], out[2] = obs[0], obs[2]
        return out

    def _omega_ok(self, e, tol):
        """The true ellipse check of x_init - z0 (B, nx): a residual of tol
        on the box rows can inflate ||e||_P by at most tol sum_i sqrt(P_ii)."""
        slack = tol * float(np.sum(np.sqrt(np.clip(np.diag(self.P), 0, None))))
        return np.einsum('bi,ij,bj->b', e, np.asarray(self.P), e) <= (1.0 + slack) ** 2 + 1e-6

    @batch_split(2)
    def certify_action_batch(self, states, uncertified_actions):
        """B independent cold-started tube solves as one batched solve on
        the env's device. Infeasible rows take the last rung of the ladder,
        clipped LQR (a batch row has no plan to replay). Returns
        ``(certified_actions (B, nu), feasible (B,) bool)``, numpy."""
        self._check_ready()
        nx, nu, H = self.model.nx, self.model.nu, self.horizon
        states = np.atleast_2d(np.asarray(states, np.float32))[:, :nx]
        acts = np.atleast_2d(np.asarray(uncertified_actions, np.float32))
        acts = np.clip(acts, self.env.physical_action_bounds[0],
                       self.env.physical_action_bounds[1])
        B = states.shape[0]
        xeqs = np.stack([self._xeq_for(s) for s in states])
        x_np = states - xeqs
        x_inits = self._f32(x_np)
        Z0 = x_inits[:, None, :].expand(B, H + 1, nx)
        V0 = torch.zeros((B, H, nu), device=self.device)
        zw = torch.zeros((B, self._n_z), device=self.device)
        yw = torch.zeros((B, self._m_rows), device=self.device)
        Z, V, _, _, res = self._solve(x_inits, self._f32(acts), self._f32(xeqs), Z0, V0, zw, yw)
        self.batch_plans = (Z, V)
        host = torch.cat([Z[:, 0], V[:, 0], res[:, None]], dim=1).cpu().numpy()
        z0, v0, res = host[:, :nx], host[:, nx:nx + nu], host[:, -1]
        scale = np.maximum(1.0, np.maximum(np.abs(states).max(axis=1), np.abs(acts).max(axis=1)))
        tol = self.feas_tol * (scale if self.feas_tol_relative else np.ones(B))
        e = x_np - z0
        feasible = np.isfinite(res) & (res < tol) & self._omega_ok(e, tol)
        K = np.asarray(self.lqr_gain)
        u_eq = np.atleast_1d(np.asarray(self.U_EQ, np.float32))
        next_u = v0 + u_eq[None, :] + e @ K.T
        # Clipped LQR toward the re-linearization point (+ U_EQ in both
        # modes, as in certify_action's ladder).
        lqr_u = x_np @ K.T + u_eq[None, :]
        in_con = self.constraints.input_constraints[0]
        lqr_u = np.clip(lqr_u, in_con.lower_bounds, in_con.upper_bounds)
        return np.where(feasible[:, None], next_u, lqr_u), feasible

    def before_optimization(self, obs):
        """The re-linearization point of this step: the observation's
        position (cart, or the 2D quad's x and z)."""
        if self.env.NAME in ('cartpole', 'quadrotor'):
            self.X_EQ = self._xeq_for(obs)

    def solve_optimization(self, obs, uncertified_action, iteration=None):
        """One certification solve from the warm start (the shifted last
        plan and the QP's last x, y) or cold; returns ``(next_u, True)`` or
        ``(None, False)``."""
        self._check_ready()
        nx, nu, H = self.model.nx, self.model.nu, self.horizon
        obs = np.asarray(obs).reshape(nx)
        x_init = np.asarray(obs - self.X_EQ, np.float32)
        u_L = np.asarray(np.atleast_1d(uncertified_action), np.float32)
        if (self.warmstart and self.z_prev is not None and self.v_prev is not None
                and self._qp_warm is not None):
            z_guess = np.roll(self.z_prev, -1, axis=1)
            z_guess[:, -1] = self.z_prev[:, -1]
            v_guess = np.roll(self.v_prev, -1, axis=1)
            start = (self._f32(z_guess.T)[None], self._f32(v_guess.T)[None],
                     *(self._f32(a)[None] for a in self._qp_warm))
        else:
            start = (self._f32(np.tile(x_init, (H + 1, 1)))[None],
                     torch.zeros((1, H, nu), device=self.device),
                     torch.zeros((1, self._n_z), device=self.device),
                     torch.zeros((1, self._m_rows), device=self.device))
        Z, V, z, y, res = self._solve(self._f32(x_init)[None], self._f32(u_L)[None],
                                      self._f32(self.X_EQ)[None], *start)
        host = torch.cat([Z.reshape(-1), V.reshape(-1), res, z.reshape(-1),
                          y.reshape(-1)]).cpu().numpy()
        Z_np, V_np, res_v, z_np, y_np = np.split(
            host, np.cumsum([(H + 1) * nx, H * nu, 1, self._n_z]))
        Z_np, V_np, res_v = Z_np.reshape(H + 1, nx), V_np.reshape(H, nu), float(res_v[0])
        tol = self.feas_tol
        if self.feas_tol_relative:
            tol = tol * max(1.0, float(np.max(np.abs(obs))), float(np.max(np.abs(u_L))))
        feasible = bool(np.isfinite(res_v) and res_v < tol)
        if feasible:
            # The true ellipse on x_init - z0 (the QP enforces its inner box):
            # a false 'feasible' is a safety false positive.
            feasible = bool(self._omega_ok((x_init - Z_np[0])[None], tol)[0])
        if feasible and self._terminal_quadratic:
            zT = Z_np[-1]
            feasible = bool(float(zT @ zT) <= self._term_tol + 2.0 * tol + 1e-6)
        if not feasible:
            return None, False
        self.z_prev = Z_np.T
        self.v_prev = V_np.T.reshape(nu, H)
        self._qp_warm = (z_np, y_np)
        next_u = V_np[0] + self.U_EQ + np.asarray(self.lqr_gain) @ (obs - self.X_EQ - Z_np[0])
        self.next_u_prev = next_u
        self.prev_action = next_u
        return next_u, True
