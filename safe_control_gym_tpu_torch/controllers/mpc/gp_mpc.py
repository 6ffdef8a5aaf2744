"""GP-MPC (cautious MPC, Hewing et al. 2020): linear MPC on the prior model
plus a Gaussian-process model of its residual dynamics, with chance
constraints.

Port of ``safe_control_gym_tpu/controllers/mpc/gp_mpc.py`` (``GPMPC``):

* the residual targets are ``x_next`` less the linear prior's prediction;
* the data come from a one-shot Latin-hypercube bootstrap of one-step
  transitions (``num_epochs`` 1) or from the epoch loop, which trains on the
  controller's own closed-loop runs;
* one GP an output dimension (``gp_utils``), trained on the env's device;
* the GP's posterior mean enters the MPC dynamics directly, through the
  ``dynamics_func_param(x, u, dp)`` hook: the GP data ``dp`` (X and alpha,
  or the FITC weights) goes through the solve as an argument, so an online
  update changes values, not the solve;
* the chance constraints: the state covariance propagated along the
  previous plan under the LQR feedback, the GP's variance added a step, gives
  each constraint row its tightening (the inverse normal CDF of ``prob``
  times the row's standard deviation), capped at ``max_tightening_frac`` of
  the row's margin. ``_tighten`` does it for B problems at once with tensors
  on the device, a loop over the horizon where JAX has ``lax.scan``;
  ``_constraint_tightening`` is the host reference it is tested against;
* a control step is the tightening and the SQP solve with one read from the
  device (the plan, the QP's warm start and the count of capped rows);
* ``online_learning`` adds each observed transition to the GPs (a ring of
  padded slots) before the next solve;
* ``select_action_batch`` solves B cold problems, each pass after the first
  tightened along the previous pass's own plan.

Departures, each recorded in ROADMAP.md: the cartpole's random actions of
the bootstrap come from ``np.random.default_rng(seed)`` (the JAX package
samples its gymnasium action space); the k-means inducing points of
``sparse_gp`` start from a numpy draw (``gp_utils.kmeans_centriods``).
"""

from __future__ import annotations

import time
from statistics import NormalDist
from typing import Optional

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.mpc.gp_utils import (GaussianProcessCollection,
                                                                 kmeans_centriods, lhs_sample)
from safe_control_gym_tpu_torch.controllers.mpc.linear_mpc import LinearMPC
from safe_control_gym_tpu_torch.math.linalg import full_matmul_precision
from safe_control_gym_tpu_torch.parallel.sharding import batch_split
from safe_control_gym_tpu_torch.utils.checkpoint import CheckpointUnpickler, save_checkpoint

__all__ = ['GPMPC']


class GPMPC(LinearMPC):
    """MPC with Gaussian-process residual dynamics and chance constraints."""

    def __init__(self,
                 env_func,
                 horizon: int = 10,
                 q_mpc: list = [1],
                 r_mpc: list = [1],
                 warmstart: bool = True,
                 soft_constraints: bool = False,
                 constraint_tol: float = 1e-6,
                 train_iterations: int = 1,
                 optimization_iterations: int = 300,
                 learning_rate: float = 0.01,
                 normalize_training_data: bool = False,
                 prob: float = 0.955,
                 kernel: str = 'Matern',
                 input_mask: Optional[list] = None,
                 target_mask: Optional[list] = None,
                 gp_approx: str = 'mean_eq',
                 initial_rollout_std: float = 0.005,
                 max_tightening_frac: float = 0.45,
                 sparse_gp: bool = False,
                 n_ind_points: int = 30,
                 online_learning: bool = False,
                 online_buffer: int = 64,
                 num_samples: int = 200,
                 num_epochs: int = 1,
                 num_train_episodes_per_epoch: int = 1,
                 num_test_episodes_per_epoch: int = 1,
                 same_train_initial_state: bool = False,
                 same_test_initial_state: bool = True,
                 rand_data_selection: bool = False,
                 overwrite_saved_data: bool = True,
                 terminate_train_on_done: bool = True,
                 terminate_test_on_done: bool = False,
                 terminate_run_on_done: bool = True,
                 **kwargs):
        kwargs.setdefault('sqp_iters', 2)
        super().__init__(env_func, horizon=horizon, q_mpc=q_mpc, r_mpc=r_mpc,
                         warmstart=warmstart, soft_constraints=soft_constraints,
                         constraint_tol=constraint_tol, **kwargs)
        self.train_iterations = int(train_iterations)
        self.optimization_iterations = int(optimization_iterations or 300)
        self.learning_rate = float(learning_rate or 0.01)
        self.prob = prob
        # The reference stores this option and never reads it: its GPs train
        # on the raw data. The key stays in the defaults; a true value raises.
        if normalize_training_data:
            raise NotImplementedError('normalize_training_data is not implemented: the GPs '
                                      'train on the raw data.')
        # Mean equivalence is the only propagation the reference implements.
        if gp_approx != 'mean_eq':
            raise NotImplementedError(
                f"gp_approx '{gp_approx}' is not implemented; only 'mean_eq' is supported.")
        self.gp_approx = gp_approx
        self.initial_rollout_std = float(initial_rollout_std)
        # A row's tightening is capped at this fraction of its margin |b|, so
        # that an uncertain GP cannot tighten a pair of bounds into an empty
        # set; the capped rows are counted (``tightening_cap_binds``).
        self.max_tightening_frac = float(max_tightening_frac)
        self.sparse_gp = sparse_gp
        self.n_ind_points = n_ind_points
        self.online_learning = bool(online_learning)
        self.online_buffer = int(online_buffer)
        self.num_samples = int(num_samples)
        self.num_epochs = int(num_epochs)
        self.num_train_episodes_per_epoch = int(num_train_episodes_per_epoch)
        self.num_test_episodes_per_epoch = int(num_test_episodes_per_epoch)
        self.same_train_initial_state = bool(same_train_initial_state)
        self.same_test_initial_state = bool(same_test_initial_state)
        self.rand_data_selection = bool(rand_data_selection)
        self.overwrite_saved_data = bool(overwrite_saved_data)
        self.terminate_train_on_done = bool(terminate_train_on_done)
        self.terminate_test_on_done = bool(terminate_test_on_done)
        self.terminate_run_on_done = bool(terminate_run_on_done)
        nx, nu = self.model.nx, self.model.nu
        self.input_mask = list(range(nx + nu)) if input_mask is None else list(input_mask)
        self.target_mask = list(range(nx)) if target_mask is None else list(target_mask)
        self.gaussian_process = GaussianProcessCollection(
            target_dim=len(self.target_mask), input_mask=self.input_mask,
            target_mask=self.target_mask, kernel=kernel, device=self.device)
        self.inverse_cdf = NormalDist().inv_cdf(1 - (1 / nx - (self.prob + 1) / (2 * nx)))
        self._gp_trained = False
        self._tighten_consts = None
        self._tighten_params = None
        self._last_cap_binds = 0
        self.data_inputs = None
        self.data_targets = None
        self.dynamics_func_param = None
        self.dynamics_params = None
        self.last_obs = None
        self.last_action = None
        self.train_runs = None
        self.test_runs = None
        self.learn_seconds = {}

    # ------------------------------------------------------------------
    def preprocess_training_data(self, x_seq, u_seq, x_next_seq):
        """Inputs (x, u) and residual targets x_next less the linear prior's
        prediction (numpy)."""
        x_seq = np.atleast_2d(np.asarray(x_seq))
        u_seq = np.atleast_2d(np.asarray(u_seq))
        x_next_seq = np.atleast_2d(np.asarray(x_next_seq))
        x_pred = (self.X_EQ[None, :] + (x_seq - self.X_EQ[None, :]) @ self.Ad.T
                  + (u_seq - self.U_EQ[None, :]) @ self.Bd.T)
        return np.concatenate([x_seq, u_seq], axis=1), x_next_seq - x_pred

    # -- data collection -----------------------------------------------
    def _gather_training_samples(self, env, n_samples, use_lhs=True):
        """One-step transitions from Latin-hypercube initial states over a
        quarter of the state box (at most 2 a side). The inputs: the
        quadrotor's ``rng.random(nu) / 20 - 1/40 + U_EQ``, the cartpole's a
        draw of its action space, both from ``np.random.default_rng(seed)``."""
        nx, nu = self.model.nx, self.model.nu
        xs, us, xns = [], [], []
        rng = np.random.default_rng(self.seed)
        if use_lhs:
            lo = np.maximum(np.asarray(env.state_space.low) * 0.25, -2.0)
            hi = np.minimum(np.asarray(env.state_space.high) * 0.25, 2.0)
            init_states = lhs_sample(n_samples, lo, hi, rand_state=self.seed)
        for i in range(n_samples):
            obs, _ = env.reset()
            if use_lhs:
                obs = env.set_state(init_states[i])
            if self.env.NAME == 'quadrotor':
                u = rng.random(nu) / 20 - 1 / 40 + self.U_EQ
            else:
                u = env.action_space.sample(rng)
            obs_next, _, _, _ = env.step(u)
            xs.append(np.asarray(obs)[:nx])
            us.append(np.atleast_1d(u))
            xns.append(np.asarray(obs_next)[:nx])
        return np.stack(xs), np.stack(us), np.stack(xns)

    def gather_training_samples(self, all_runs, epoch_i, num_samples, rand_generator=None):
        """Transitions sampled from the recorded closed-loop runs of an epoch."""
        nx = self.model.nx
        n_episodes = len(all_runs[epoch_i])
        per_episode = int(num_samples / n_episodes)
        xs, us, xns = [], [], []
        for episode_i in range(n_episodes):
            run = all_runs[epoch_i][episode_i]
            obs = np.atleast_2d(np.asarray(run['obs']))[:, :nx]
            act = np.atleast_2d(np.asarray(run['action']))
            n = act.shape[0]
            if per_episode < n:
                inds = (rand_generator.choice(n - 1, per_episode, replace=False)
                        if rand_generator is not None else np.arange(per_episode))
            else:
                inds = np.arange(n - 1)
            xs.append(obs[inds])
            us.append(act[inds])
            xns.append(obs[inds + 1])
        xs, us, xns = np.vstack(xs), np.vstack(us), np.vstack(xns)
        if xs.shape[0] == 0:
            raise RuntimeError(
                '[ERROR] gather_training_samples: the recorded runs contain no usable '
                'transitions (episodes of length < 2: the MPC likely went infeasible on '
                'the first step).')
        return xs, us, xns

    # -- learning ------------------------------------------------------
    def learn(self, env=None, **kwargs):
        """With ``num_epochs`` 1, the one-shot bootstrap: ``num_samples``
        transitions, then ``train_gp``; ``learn_seconds`` keeps the split
        (collection, training). With more epochs, the reference's loop: epoch
        0 runs the untrained (prior) controller, every later one trains on
        the previous epoch's train runs and runs test and train episodes."""
        if self.num_epochs <= 1:
            close_env = env is None
            if env is None:
                env = self.env_func(randomized_init=True, init_state=None, cost='quadratic',
                                    normalized_rl_action_space=False)
            self.learn_seconds = {'collection_s': 0.0, 'training_s': 0.0}
            for _ in range(max(1, self.train_iterations)):
                t0 = time.perf_counter()
                x_seq, u_seq, x_next_seq = self._gather_training_samples(env, self.num_samples)
                inputs, targets = self.preprocess_training_data(x_seq, u_seq, x_next_seq)
                t1 = time.perf_counter()
                self.train_gp(input_data=inputs, target_data=targets,
                              overwrite_saved_data=False)
                self.learn_seconds['collection_s'] += t1 - t0
                self.learn_seconds['training_s'] += time.perf_counter() - t1
            if close_env:
                env.close()
            return None, None

        train_runs, test_runs = {0: {}}, {0: {}}
        if self.same_train_initial_state:
            train_envs = [self.env_func(randomized_init=True, seed=self.seed)
                          for _ in range(self.num_epochs)]
        else:
            train_envs = [self.env_func(randomized_init=True, seed=self.seed)] * self.num_epochs
        if self.same_test_initial_state:
            test_envs = [self.env_func(randomized_init=True, seed=self.seed * 111)
                         for _ in range(self.num_epochs)]
        else:
            test_envs = ([self.env_func(randomized_init=True, seed=self.seed * 111)]
                         * self.num_epochs)
        # Epoch 0: the untrained controller is the prior controller.
        for episode in range(self.num_train_episodes_per_epoch):
            train_runs[0][episode] = self.run(env=train_envs[0],
                                              terminate_run_on_done=self.terminate_train_on_done)
        for test_ep in range(self.num_test_episodes_per_epoch):
            test_runs[0][test_ep] = self.run(env=test_envs[0],
                                             terminate_run_on_done=self.terminate_test_on_done)
        for epoch in range(1, self.num_epochs):
            rand_gen = (np.random.default_rng(self.seed + epoch)
                        if self.rand_data_selection else None)
            x_seq, u_seq, x_next_seq = self.gather_training_samples(
                train_runs, epoch - 1, self.num_samples, rand_gen)
            inputs, targets = self.preprocess_training_data(x_seq, u_seq, x_next_seq)
            self.train_gp(input_data=inputs, target_data=targets)
            test_runs[epoch] = {}
            for test_ep in range(self.num_test_episodes_per_epoch):
                test_runs[epoch][test_ep] = self.run(
                    env=test_envs[epoch], terminate_run_on_done=self.terminate_test_on_done)
            train_runs[epoch] = {}
            for episode in range(self.num_train_episodes_per_epoch):
                train_runs[epoch][episode] = self.run(
                    env=train_envs[epoch], terminate_run_on_done=self.terminate_train_on_done)
        for e in {id(e): e for e in train_envs + test_envs}.values():
            e.close()
        self.train_runs, self.test_runs = train_runs, test_runs
        return train_runs, test_runs

    def train_gp(self, input_data=None, target_data=None, overwrite_saved_data=None,
                 **kwargs):
        """Fit the per-dim GPs on the data (the bootstrap's if none is given)
        and set up the GP dynamics and the solve."""
        if overwrite_saved_data is None:
            overwrite_saved_data = self.overwrite_saved_data
        if input_data is None and target_data is None:
            env = self.env_func(randomized_init=True, init_state=None, cost='quadratic',
                                normalized_rl_action_space=False)
            x_seq, u_seq, x_next_seq = self._gather_training_samples(env, self.num_samples)
            env.close()
            input_data, target_data = self.preprocess_training_data(x_seq, u_seq, x_next_seq)
        if self.data_inputs is None or overwrite_saved_data:
            self.data_inputs, self.data_targets = input_data, target_data
        else:
            self.data_inputs = np.vstack([self.data_inputs, input_data])
            self.data_targets = np.vstack([self.data_targets, target_data])
        if self.data_inputs.shape[0] == 0:
            raise ValueError('[ERROR] train_gp called with no training data.')
        capacity = (self.data_inputs.shape[0] + self.online_buffer
                    if self.online_learning else None)
        self.gaussian_process.train(self.data_inputs, self.data_targets,
                                    n_train=self.optimization_iterations,
                                    learning_rate=self.learning_rate, capacity=capacity)
        self._gp_trained = True
        self.set_gp_dynamics_func()
        self.setup_optimizer(self.solver)
        self.reset_before_run()

    # -- dynamics ------------------------------------------------------
    def set_gp_dynamics_func(self):
        """The prior's linear dynamics plus the GP's posterior mean, as
        ``dynamics_func_param(x, u, dp)``; with ``sparse_gp`` the FITC mean
        over k-means inducing points replaces the exact posterior's."""
        gps = self.gaussian_process.gps
        ls, sv, _ = self.gaussian_process.hyper()
        kernel_fn = gps[0].kernel_fn
        Ad, Bd = self._f32(self.Ad), self._f32(self.Bd)
        X_EQ, U_EQ = self._f32(self.X_EQ), self._f32(self.U_EQ)
        input_mask = torch.as_tensor(self.input_mask, device=self.device)
        # The residual of target dim d lands on state target_mask[d]: S (nx, D).
        S = torch.zeros((self.model.nx, len(self.target_mask)), device=self.device)
        S[self.target_mask, range(len(self.target_mask))] = 1.0
        if self.sparse_gp:
            X_real = gps[0].real_data()[0].cpu().numpy()
            self.z_ind = kmeans_centriods(min(self.n_ind_points, X_real.shape[0]), X_real,
                                          rand_state=self.seed)
            Z = self._f32(self.z_ind)

            def gp_mean(z, p):
                return torch.sum(kernel_fn(z[None], Z, ls, sv)[:, 0] * p['w'], dim=1)
        else:
            def gp_mean(z, p):
                return torch.sum(kernel_fn(z[None], p['X'], ls, sv)[:, 0] * p['alpha'], dim=1)

        @full_matmul_precision
        def gp_dynamics(x, u, p):
            prior = X_EQ + Ad @ (x - X_EQ) + Bd @ (u - U_EQ)
            return prior + S @ gp_mean(torch.cat([x, u])[input_mask], p)

        self.dynamics_func_param = gp_dynamics
        self._refresh_dynamics_params()
        # The dynamics on the live GP data, for callers without dp.
        self.dynamics_func = lambda x, u: gp_dynamics(x, u, self.dynamics_params)

    def _refresh_dynamics_params(self):
        """The solve's GP data from the current GPs (after training and after
        every online update), and the tightening's."""
        gps = self.gaussian_process.gps
        stack = self.gaussian_process.stacked
        if self.sparse_gp:
            self.dynamics_params = {'w': stack(lambda gp: gp.fitc_weights(self.z_ind))}
        else:
            self.dynamics_params = {'X': gps[0].X, 'alpha': stack(lambda gp: gp._alpha)}
        # The exact posterior's variance in both modes, as the host reference.
        ls, sv, nv = self.gaussian_process.hyper()
        self._tighten_params = {'X': gps[0].X, 'chol': stack(lambda gp: gp._chol),
                                'ls': ls, 'sv': sv, 'noise_var': nv}

    # -- tightening and solve --------------------------------------------
    def setup_optimizer(self, solver='qp'):
        """The parent's QP structure, and the tightening's constants: the
        constraint rows' |A| and |b|, the LQR gain and closed loop."""
        super().setup_optimizer(solver)
        self._tighten_consts = None
        self._last_cap_binds = 0
        if not self._gp_trained:
            return
        state_cons = self.constraints.state_constraints
        input_cons = self.constraints.input_constraints
        if any(not hasattr(c, 'A') for c in state_cons + input_cons):
            return  # defined for linear constraint rows only: the host path
        nx, nu = self.model.nx, self.model.nu

        def rows(cons, dim):
            if not cons:
                return self._f32(np.zeros((0, dim))), self._f32(np.zeros((0,)))
            return (self._f32(np.vstack([np.abs(np.atleast_2d(c.A)) for c in cons])),
                    self._f32(np.concatenate([np.abs(np.atleast_1d(c.b)) for c in cons])))
        A_s, b_s = rows(state_cons, nx)
        A_u, b_u = rows(input_cons, nu)
        K = np.asarray(self.lqr_gain)
        self._tighten_consts = dict(
            A_s=A_s, lim_s=self.max_tightening_frac * b_s, A_u=A_u,
            lim_u=self.max_tightening_frac * b_u, K=self._f32(K),
            A_cl=self._f32(self.Ad + self.Bd @ K),
            icdf=float(np.float32(self.inverse_cdf)),
            s0=float(np.float32(self.initial_rollout_std)),
            input_mask=torch.as_tensor(self.input_mask, device=self.device),
            target_mask=torch.as_tensor(self.target_mask, device=self.device))

    @full_matmul_precision
    def _tighten(self, X, U, tp, has_prev):
        """B previous plans X (B, T+1, nx), U (B, T, nu) -> the tightenings
        (B, T+1, ms) and (B, T, mu) and the count of capped rows (B,),
        times ``has_prev`` (B,) (0 gives no tightening). Tensors on the
        device, no host read."""
        c = self._tighten_consts
        nx, T = self.model.nx, self.T
        B = X.shape[0]
        z = torch.cat([X[:, :T], U], dim=2)[..., c['input_mask']].reshape(B * T, -1)
        k = self.gaussian_process.gps[0].kernel_fn(z, tp['X'], tp['ls'], tp['sv'])
        v = torch.cholesky_solve(k.transpose(1, 2), tp['chol'])
        gp_var = (tp['sv'][:, None] - torch.sum(k * v.transpose(1, 2), dim=2))  # (D, B T)
        gp_var = gp_var.T.reshape(B, T, -1)
        cov = (torch.eye(nx, device=self.device) * c['s0'] ** 2).expand(B, nx, nx)
        K, A_cl = c['K'], c['A_cl']

        def rows(cov, A, lim):
            sd = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=1, dim2=2), min=0.0))
            raw = c['icdf'] * (sd @ A.T)
            return torch.minimum(raw, lim), torch.sum(raw > lim, dim=1)
        ts, tu, binds = [], [], 0
        for step in range(T):
            t_u, b_u = rows(K @ cov @ K.T, c['A_u'], c['lim_u'])
            t_s, b_s = rows(cov, c['A_s'], c['lim_s'])
            ts.append(t_s)
            tu.append(t_u)
            binds = binds + b_u + b_s
            var = torch.clamp(gp_var[:, step], min=0.0) + tp['noise_var']
            cov_d = torch.diag_embed(torch.zeros((B, nx), device=self.device).index_copy(
                1, c['target_mask'], var))
            cov = A_cl @ cov @ A_cl.T + cov_d
        t_s, b_s = rows(cov, c['A_s'], c['lim_s'])
        ts.append(t_s)
        gate = has_prev.to(torch.float32)
        return (torch.stack(ts, dim=1) * gate[:, None, None],
                torch.stack(tu, dim=1) * gate[:, None, None],
                (binds + b_s) * has_prev.to(torch.int64))

    def _previous_plan(self):
        """The previous plan as (1, T+1, nx), (1, T, nu) tensors and whether
        there is one (1,)."""
        nx, nu, T = self.model.nx, self.model.nu, self.T
        if self.x_prev is not None and self.u_prev is not None:
            X = np.asarray(self.x_prev).T
            U = np.atleast_2d(self.u_prev).reshape(nu, T).T
            return self._f32(X)[None], self._f32(U)[None], torch.ones(1, device=self.device)
        return (torch.zeros((1, T + 1, nx), device=self.device),
                torch.zeros((1, T, nu), device=self.device), torch.zeros(1, device=self.device))

    def _dispatch_solve(self, obs_np, goal_states, guess, step):
        """The tightening along the previous plan and the SQP solve, read back
        in one copy with the count of capped rows."""
        if self._tighten_consts is None:
            return super()._dispatch_solve(obs_np, goal_states, guess, step)
        nx, nu, T = self.model.nx, self.model.nu, self.T
        x0 = self._f32(obs_np[None])
        start = (self._cold_start(x0) if guess is None
                 else tuple(self._f32(a)[None] for a in guess))
        X_prev, U_prev, has_prev = self._previous_plan()
        tight_s, tight_u, binds = self._tighten(X_prev, U_prev, self._tighten_params, has_prev)
        X, U, z, y, res = self._solve(x0, self._f32(goal_states.T)[None], *start, tight_s,
                                      tight_u, self.dynamics_params)
        host = torch.cat([X.reshape(-1), U.reshape(-1), res, z.reshape(-1), y.reshape(-1),
                          binds.to(torch.float32)]).cpu().numpy()
        self._last_cap_binds = int(host[-1])
        sizes = np.cumsum([(T + 1) * nx, T * nu, 1, self._n_z])
        X_np, U_np, res_v, z_np, y_np = np.split(host[:-1], sizes)
        return X_np.reshape(T + 1, nx), U_np.reshape(T, nu), float(res_v[0]), z_np, y_np

    # -- batched control -------------------------------------------------
    @batch_split(1)
    def select_action_batch(self, obs_batch, step: int = 0, passes: int = 2):
        """B cold-started GP-MPC solves as one batched solve: GP-mean
        dynamics and chance-tightened constraints. Without a previous plan,
        the first pass solves untightened and every later one tightens along
        the previous pass's plan, warm-started from it. Returns ``(actions
        (B, nu), feasible (B,) bool, n_binds (B,))``, numpy."""
        if not self._gp_trained or self._tighten_consts is None:
            raise RuntimeError('select_action_batch requires a trained GP and linear '
                               'constraints (call learn()/train_gp() first).')
        nx = self.model.nx
        obs_batch = np.atleast_2d(np.asarray(obs_batch, np.float32))[:, :nx]
        B = obs_batch.shape[0]
        goal = self.get_references(step)
        x0 = self._f32(obs_batch)
        goal_t = self._f32(goal.T).expand(B, self.T + 1, nx)
        dp = self.dynamics_params
        solution = self._solve(x0, goal_t, *self._cold_start(x0), *self._tightening(B), dp)
        qp_iterations = list(self.qp_iterations)
        binds = torch.zeros(B, dtype=torch.int64, device=self.device)
        for _ in range(max(1, int(passes)) - 1):
            X, U, z, y, _ = solution
            tight_s, tight_u, binds = self._tighten(X, U, self._tighten_params,
                                                    torch.ones(B, device=self.device))
            solution = self._solve(x0, goal_t, X, U, z, y, tight_s, tight_u, dp)
            qp_iterations += self.qp_iterations
        self.qp_iterations = qp_iterations
        u0, feasible, n_binds = self._batch_answers(solution, obs_batch, goal, extra=binds)
        return u0, feasible, n_binds.astype(np.int64)

    # -- control ---------------------------------------------------------
    def select_action(self, obs, info=None):
        """The receding-horizon solve; with ``online_learning`` the
        transition observed since the last call goes into the GPs first.
        ``results_dict['tightening_cap_binds']`` counts the capped rows a
        step (where the chance constraint's probability is weakened)."""
        if (self.online_learning and self._gp_trained and self.last_obs is not None
                and self.last_action is not None):
            nx = self.model.nx
            inp, tgt = self.preprocess_training_data(
                np.asarray(self.last_obs)[None, :nx],
                np.atleast_1d(np.asarray(self.last_action))[None],
                np.asarray(obs)[None, :nx])
            self.gaussian_process.add_data(inp, tgt)
            self._refresh_dynamics_params()
        action = super().select_action(obs, info)
        if hasattr(self, 'results_dict'):
            self.results_dict.setdefault('tightening_cap_binds', []).append(
                int(self._last_cap_binds))
        self.last_obs = np.asarray(obs)
        self.last_action = np.asarray(action)
        return action

    def reset_before_run(self, obs=None, info=None, env=None):
        self.last_obs = None
        self.last_action = None
        super().reset_before_run(obs, info, env)

    def _constraint_tightening(self, step):
        """The host reference of the tightening (numpy, a loop over the
        horizon), returned as (1, T+1, ms) and (1, T, mu) tensors; it sets
        ``_last_cap_binds``. Zeros before training or without a plan."""
        T, ms, mu = self.T, self._ms, self._mu
        tight_s = np.zeros((T + 1, ms), np.float32)
        tight_u = np.zeros((T, mu), np.float32)
        if not self._gp_trained or self.x_prev is None:
            return self._f32(tight_s)[None], self._f32(tight_u)[None]
        nx, nu = self.model.nx, self.model.nu
        K = np.asarray(self.lqr_gain)
        A_cl = self.Ad + self.Bd @ K
        # The GP's variance along the previous plan (full (x, u) rows: predict
        # applies the input mask) and the learned noise variance.
        z_prev = np.concatenate([self.x_prev[:, :-1].T,
                                 np.atleast_2d(self.u_prev).reshape(nu, T).T], axis=1)
        _, gp_var = self.gaussian_process.predict(z_prev)
        noise_var = np.array([float(np.exp(gp.params['log_noise_var'].item()))
                              for gp in self.gaussian_process.gps])
        cov_x = np.eye(nx) * self.initial_rollout_std ** 2
        state_cons = self.constraints.state_constraints
        input_cons = self.constraints.input_constraints
        cap_binds = [0]

        def cap(rows, con):
            lim = self.max_tightening_frac * np.abs(con.b)
            raw = self.inverse_cdf * rows
            cap_binds[0] += int(np.sum(raw > lim))
            return np.minimum(raw, lim)

        def fill(out, k, cons, sd):
            ofs = 0
            for con in cons:
                out[k, ofs:ofs + con.num_constraints] = cap(np.abs(con.A) @ sd, con)
                ofs += con.num_constraints

        for k in range(T):
            su = np.sqrt(np.clip(np.diag(K @ cov_x @ K.T), 0, None))
            fill(tight_u, k, input_cons, su)
            fill(tight_s, k, state_cons, np.sqrt(np.clip(np.diag(cov_x), 0, None)))
            cov_d = np.zeros((nx, nx))
            cov_d[np.ix_(self.target_mask, self.target_mask)] = np.diag(
                np.clip(gp_var[min(k, gp_var.shape[0] - 1)], 0, None) + noise_var)
            cov_x = A_cl @ cov_x @ A_cl.T + cov_d
        fill(tight_s, T, state_cons, np.sqrt(np.clip(np.diag(cov_x), 0, None)))
        self._last_cap_binds = cap_binds[0]
        return self._f32(tight_s)[None], self._f32(tight_u)[None]

    # ------------------------------------------------------------------
    def reset(self):
        self.set_dynamics_func()
        if self._gp_trained:
            self.set_gp_dynamics_func()
        else:
            self.dynamics_func_param = None
            self.dynamics_params = None
        self.setup_optimizer(self.solver)
        self.reset_before_run()

    def state_dict(self):
        """The GPs' state dicts and the data: numpy arrays and ints (the JAX
        package's layout of ``GPMPC.save``)."""
        return {'gps': self.gaussian_process.state_dict(), 'data_inputs': self.data_inputs,
                'data_targets': self.data_targets}

    def load_state_dict(self, sd):
        """The GPs and data of :meth:`state_dict` (the port's or the JAX
        package's), then the GP dynamics and the solve."""
        self.gaussian_process.load_state_dict(sd['gps'])
        self.data_inputs = sd.get('data_inputs')
        self.data_targets = sd.get('data_targets')
        self._gp_trained = True
        self.set_gp_dynamics_func()
        self.setup_optimizer(self.solver)
        self.reset_before_run()

    def save(self, path):
        save_checkpoint(path, self.state_dict())

    def load(self, path):
        """A file of :meth:`save`, the port's or the JAX package's
        ``GPMPC.save``, read by the restricted unpickler."""
        with open(path, 'rb') as f:
            self.load_state_dict(CheckpointUnpickler(f).load())
