"""Iterative LQR: the host loop, and the whole optimization as one fixed-count
loop of batched tensor ops for B problems at once.

Port of ``safe_control_gym_tpu/controllers/lqr/ilqr.py``. Iteration 0 rolls
out the LQR policy; each later iteration runs the backward pass over the
realized trajectory (per-step Jacobians of ``env.symbolic`` by
``torch.func.vmap(jacfwd(.))``, Euler-discretized; the quadratic cost; the
Riccati-like recursion with H's eigenvalues clipped at 0 and ``lamb`` added).
A cost increase (or a non-finite H) reverts to the best policy and multiplies
``lamb`` by ``lamb_factor`` up to ``lamb_max``; two improving iterations in a
row with |delta cost| < ``epsilon`` converge.

* ``learn`` (host loop): each rollout steps the stateful env, a batch of one,
  so each step is one K1, K2 or K3 launch on the card; the backward pass runs
  on the env's device.
* ``learn_fused`` / ``solve_batch``: ``max_iterations`` x (a closed-loop
  rollout through ``env.func.step`` that freezes each problem after its done,
  the backward pass, the improve / revert / converge / abort ladder) as
  ``torch.where``s over (B,) flags, with no read of the device inside, as the
  JAX package's ``lax.scan`` does: the results and the iteration count are
  the JAX solve's. A stochastic disturbance is drawn once for the solve and
  replayed every iteration (``func.step``'s drawn mode), as JAX replays one
  realization.

H is ``nu`` x ``nu``: for ``nu`` <= 2 its eigendecomposition is in closed
form, with no ``torch.linalg.eigh``, which waits for the device on CUDA (one
wait a backward step); the 3D quad (``nu`` = 4) takes ``eigh``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.func import jacfwd, vmap

from safe_control_gym_tpu_torch.controllers.lqr.lqr import LQR
from safe_control_gym_tpu_torch.envs.benchmark_env import Cost, Task
from safe_control_gym_tpu_torch.math.linalg import full_matmul_precision

__all__ = ['iLQR']


def _t(M):
    return M.transpose(-1, -2)


def _keep_where(mask, old, new):
    """``new`` with ``old``'s rows where the (B,) ``mask`` is set."""
    return torch.where(mask.reshape(-1, *[1] * (new.dim() - 1)), old, new)


def _regularized_inverse(H, lamb):
    """V diag(1 / (max(lambda, 0) + lamb)) V' of the symmetric (B, n, n) H,
    ``lamb`` (B,)."""
    n = H.shape[-1]
    lamb = lamb[:, None, None]
    if n == 1:
        return 1.0 / (torch.clamp(H, min=0.0) + lamb)
    if n == 2:
        a, b, c = H[:, 0:1, 0:1], H[:, 0:1, 1:2], H[:, 1:2, 1:2]
        half_gap = torch.hypot(0.5 * (a - c), b)
        mean = 0.5 * (a + c)
        mu_lo = torch.clamp(mean - half_gap, min=0.0) + lamb
        mu_hi = torch.clamp(mean + half_gap, min=0.0) + lamb
        eye = torch.eye(2, dtype=H.dtype, device=H.device)
        # The projector onto the upper eigenvalue's eigenvector; with equal
        # eigenvalues its weight 1/mu_hi - 1/mu_lo is 0 and any projector does.
        proj = torch.where(half_gap > 0,
                           (H - (mean - half_gap) * eye) / (2.0 * half_gap),
                           torch.zeros_like(H))
        return eye / mu_lo + proj * (1.0 / mu_hi - 1.0 / mu_lo)
    evals, evecs = torch.linalg.eigh(H)
    evals = torch.clamp(evals, min=0.0) + lamb[..., 0]
    return (evecs * (1.0 / evals)[:, None, :]) @ _t(evecs)


class iLQR(LQR):
    """Iterative linear quadratic regulator."""

    def __init__(self, env_func, q_lqr=None, r_lqr=None, discrete_dynamics=True,
                 max_iterations=15, lamb_factor=10, lamb_max=1000, epsilon=0.01,
                 fused_solve=False, **kwargs):
        super().__init__(env_func, q_lqr=q_lqr, r_lqr=r_lqr,
                         discrete_dynamics=discrete_dynamics, **kwargs)
        self.max_iterations = max_iterations
        self.lamb_factor = lamb_factor
        self.lamb_max = lamb_max
        self.epsilon = epsilon
        # fused_solve=True routes learn() through learn_fused.
        self.fused_solve = bool(fused_solve)
        self.device = self.env.device
        self.ite_counter = 0
        self.traj_step = 0
        self.input_ff = None
        self.gains_fb = None
        self.input_ff_best = None
        self.gains_fb_best = None
        self.lamb = 1.0
        self.update_unstable = False

    def _f32(self, a):
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------
    @full_matmul_precision
    def _backward(self, states, inputs, goals, goal_term, lamb):
        """The backward pass of B trajectories: ``states`` (B, T, nx),
        ``inputs`` (B, T, nu), ``goals`` (T, nx), ``goal_term`` (nx,), ``lamb``
        (B,). Returns the gains (B, T, nu, nx), the feedforwards (B, T, nu) and
        (B,) whether every H was finite."""
        model = self.model
        nx, nu, dt = model.nx, model.nu, model.dt
        n, T = states.shape[0], states.shape[1]
        Q, R = self._f32(self.Q), self._f32(self.R)
        u_eq = self._f32(np.atleast_1d(model.U_EQ))
        A, Bm = vmap(jacfwd(model.fc_fn, argnums=(0, 1)))(states.reshape(-1, nx),
                                                           inputs.reshape(-1, nu))
        eye = torch.eye(nx, dtype=torch.float32, device=self.device)
        Ad = (eye + dt * A).reshape(n, T, nx, nx)
        Bd = (dt * Bm).reshape(n, T, nx, nu)
        Qv = (states - goals) @ Q.T
        Rv = (inputs - u_eq) @ R.T
        Sv = (states[:, -1] - goal_term) @ Q.T
        Sm = Q.expand(n, nx, nx)
        ok = torch.ones(n, dtype=torch.bool, device=self.device)
        K_seq, ff_seq = [None] * T, [None] * T
        for t in range(T - 1, -1, -1):
            A_t, B_t, x_t, u_t = Ad[:, t], Bd[:, t], states[:, t], inputs[:, t]
            g = Rv[:, t, :, None] + _t(B_t) @ Sv[..., None]
            G = _t(B_t) @ (Sm @ A_t)
            H = R + _t(B_t) @ (Sm @ B_t)
            H = 0.5 * (H + _t(H))
            H_inv = _regularized_inverse(H, lamb)
            duff = -H_inv @ g
            K = -H_inv @ G
            ff_seq[t] = u_t + duff[..., 0] - (K @ x_t[..., None])[..., 0]
            K_seq[t] = K
            Sm = Q + _t(A_t) @ (Sm @ A_t) + _t(K) @ (H @ K) + _t(K) @ G + _t(G) @ K
            Sv = Qv[:, t] + (_t(A_t) @ Sv[..., None])[..., 0] + (
                _t(K) @ (H @ duff) + _t(K) @ g + _t(G) @ duff)[..., 0]
            ok = ok & torch.isfinite(H).flatten(1).all(dim=1)
        return torch.stack(K_seq, dim=1), torch.stack(ff_seq, dim=1), ok

    def update_policy(self, env):
        """The backward pass over the last rollout: new ``gains_fb`` and
        ``input_ff``, or ``update_unstable`` if an H was not finite."""
        T = self.input_stack.shape[0]
        states = self._f32(self.state_stack[:T])[None]
        inputs = self._f32(np.atleast_2d(self.input_stack)[:T].reshape(T, -1))[None]
        goals, goal_term = self._goal_sequences(T)
        K, ff, ok = self._backward(states, inputs, goals, goal_term,
                                   torch.full((1,), float(self.lamb), device=self.device))
        if bool(ok[0]):
            self.gains_fb = K[0].cpu().numpy()
            self.input_ff = ff[0].T.cpu().numpy()  # (nu, T)
        else:
            self.update_unstable = True

    # ------------------------------------------------------------------
    # The fused solve of B problems
    # ------------------------------------------------------------------
    def _goal_sequences(self, T):
        """The (T, nx) reference rows and the terminal goal, on the device."""
        X_GOAL = np.asarray(self.env.X_GOAL, np.float32)
        if self.env.TASK == Task.STABILIZATION:
            return (self._f32(np.broadcast_to(X_GOAL, (T, self.model.nx))),
                    self._f32(X_GOAL))
        idx = np.clip(np.arange(T), 0, X_GOAL.shape[0] - 1)
        return self._f32(X_GOAL[idx]), self._f32(X_GOAL[-1])

    def _draw_noise(self, T, n):
        """Each stochastic disturbance channel's noise for T steps of n envs,
        drawn once from the env's generator: [{channel: (n, k)}] * T, or None."""
        channels = [ch for ch, dl in self.env.disturbances.items() if dl and dl.noise_size > 0]
        if not channels:
            return None
        return [{ch: self.env.disturbances[ch].draw(self.env.generator, n)
                 for ch in channels} for _ in range(T)]

    def _rollout(self, est0, obs0, K_seq, ff_seq, drawn):
        """Closed-loop rollout of B problems through ``env.func.step``; a done
        problem keeps stepping and its result is discarded (every field of
        its state frozen). Returns states (B, T, nx), inputs (B, T, nu), the
        costs (B,) and whether each left the bounds (B,)."""
        func, nx = self.env.func, self.model.nx
        n, T = K_seq.shape[0], K_seq.shape[1]
        est, obs = est0, obs0
        done = torch.zeros(n, dtype=torch.bool, device=self.device)
        oob = torch.zeros_like(done)
        total = torch.zeros(n, dtype=torch.float32, device=self.device)
        states, inputs = [], []
        for t in range(T):
            x = obs[:, :nx]
            a = (K_seq[:, t] @ x[..., None])[..., 0] + ff_seq[:, t]
            est2, out = func.step(est, a, drawn=None if drawn is None else drawn[t])
            est = dataclasses.replace(est2, **{
                f.name: _keep_where(done, getattr(est, f.name), getattr(est2, f.name))
                for f in dataclasses.fields(est2)
                if isinstance(getattr(est2, f.name), torch.Tensor)})
            total = total + torch.where(done, torch.zeros_like(total), -out.reward)
            oob = oob | (~done & out.out_of_bounds)
            obs = torch.where(done[:, None], obs, out.obs)
            done = done | out.done
            states.append(x)
            inputs.append(a)
        return torch.stack(states, dim=1), torch.stack(inputs, dim=1), total, oob

    @full_matmul_precision
    def _solve(self, est0, obs0):
        """``max_iterations`` iLQR iterations of B problems from the env
        states ``est0`` and observations ``obs0``, as one fixed-count loop:
        every problem runs every iteration, and a converged or aborted one
        keeps its carry. No value is read back to the host inside."""
        n = obs0.shape[0]
        T = int(self.env.CTRL_FREQ * self.env.EPISODE_LEN_SEC)
        nx, nu = self.model.nx, self.model.nu
        dev = self.device
        goals, goal_term = self._goal_sequences(T)
        gain = self._f32(self.gain)
        u_eq = self._f32(np.atleast_1d(self.model.U_EQ))
        # Iteration 0's policy is calculate_lqr_action's.
        K0 = (-gain).expand(n, T, nu, nx)
        ff0 = (goals @ gain.T + u_eq).expand(n, T, nu)
        oob_breaks = bool(getattr(self.env, 'done_on_out_of_bound', False))
        drawn = self._draw_noise(T, n)
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        K, ff, Kb, ffb = K0, ff0, K0, ff0
        prev_cost = torch.full((n,), float('inf'), device=dev)
        lamb = torch.ones(n, device=dev)
        prev_imp, conv, abort = false, false, false
        costs, frozen_seq = [], []
        for i in range(int(self.max_iterations)):
            frozen = conv | abort
            states, inputs, cost, oob = self._rollout(est0, obs0, K, ff, drawn)
            first = i == 0
            stop0 = oob if (first and oob_breaks) else false
            delta = cost - prev_cost
            K_new, ff_new, ok = self._backward(states, inputs, goals, goal_term, lamb)
            improved = ~false if first else (delta <= 0.0) & ok
            pick = functools.partial(_keep_where, improved)
            lamb2 = pick(lamb, torch.clamp(lamb * float(self.lamb_factor),
                                           max=float(self.lamb_max)))
            Kb2, ffb2, prev2 = pick(K, Kb), pick(ff, ffb), pick(cost, prev_cost)
            newconv = false if first else (
                improved & (torch.abs(delta) < float(self.epsilon)) & prev_imp)
            prev_imp2 = false if first else improved
            K2, ff2 = pick(K_new, Kb2), pick(ff_new, ffb2)
            costs.append(torch.where(frozen, prev_cost, cost))
            frozen_seq.append(frozen)
            keep = functools.partial(_keep_where, frozen)
            K, ff, Kb, ffb = keep(K, K2), keep(ff, ff2), keep(Kb, Kb2), keep(ffb, ffb2)
            prev_cost, lamb = keep(prev_cost, prev2), keep(lamb, lamb2)
            prev_imp = keep(prev_imp, prev_imp2)
            conv, abort = keep(conv, conv | newconv), keep(abort, abort | stop0)
        n_iters = (~torch.stack(frozen_seq, dim=1)).sum(dim=1)
        return Kb, ffb, prev_cost, torch.stack(costs, dim=1), conv, abort, n_iters

    def learn_fused(self, env=None, **kwargs):
        """``learn`` as the fused solve of one problem from a fresh reset of
        the env; sets the best-policy attributes ``select_action`` reads.
        Unlike the host loop, a randomized-init env is solved from one drawn
        initial state, and a disturbed env replays one noise realization every
        iteration; the two agree on deterministic envs."""
        est0, obs0 = self.env.func.reset_batch(self.env.generator, 1)
        K, ff, cost, _costs, _conv, abort, n_it = self._solve(est0, obs0)
        self.gains_fb_best = K[0].cpu().numpy()
        self.input_ff_best = ff[0].T.cpu().numpy()  # (nu, T)
        self.gains_fb = self.gains_fb_best
        self.input_ff = self.input_ff_best
        self.total_cost = float(cost[0])
        self.ite_counter = int(n_it[0])
        self.solve_aborted = bool(abort[0])
        self.traj_step = 0
        self.max_steps = int(self.env.CTRL_FREQ * self.env.EPISODE_LEN_SEC)
        return self.total_cost

    def _batch_start(self, x0s):
        """Env states of a fresh batch reset with the states and counters
        replaced by ``x0s`` (B, nx) and zeros, and ``x0s`` as observations."""
        x0s = torch.atleast_2d(x0s.to(self.device, torch.float32)
                               if isinstance(x0s, torch.Tensor) else self._f32(x0s))
        n = x0s.shape[0]
        est, _obs = self.env.func.reset_batch(self.env.generator, n)
        return est.replace(state=x0s, ctrl_step=torch.zeros(n, dtype=torch.int32,
                                                            device=self.device)), x0s

    def solve_batch(self, x0s):
        """B independent iLQR solves from the initial states ``x0s`` (B, nx),
        in one fused solve on the env's device. Returns numpy arrays: the best
        gains (B, T, nu, nx) and feedforwards (B, nu, T), the best costs (B,),
        the cost curves (B, max_iterations), and (B,) converged, aborted and
        iterations."""
        if self.env.COST != Cost.QUADRATIC:
            raise ValueError('solve_batch assumes quadratic-cost envs (obs == state)')
        K, ff, cost, costs, conv, abort, n_it = self._solve(*self._batch_start(x0s))
        host = lambda t: t.cpu().numpy()
        return {'gains_fb': host(K), 'input_ff': host(ff.transpose(1, 2)),
                'cost': host(cost), 'cost_curves': host(costs), 'converged': host(conv),
                'aborted': host(abort), 'iterations': host(n_it)}

    @full_matmul_precision
    def evaluate_batch(self, x0s, gains_fb, input_ff):
        """The cost (B,) of B time-varying policies, gains (B, T, nu, nx) and
        feedforwards (B, nu, T) as ``solve_batch`` returns them, each rolled
        out in closed loop from its state in ``x0s`` (B, nx) on this
        controller's env and device. On a noiseless env it gives
        ``solve_batch``'s best costs for its best policies."""
        est, obs = self._batch_start(x0s)
        K = torch.as_tensor(np.asarray(gains_fb, np.float32), device=self.device)
        ff = torch.as_tensor(np.asarray(input_ff, np.float32), device=self.device)
        drawn = self._draw_noise(K.shape[1], obs.shape[0])
        return self._rollout(est, obs, K, ff.transpose(1, 2), drawn)[2].cpu().numpy()

    # ------------------------------------------------------------------
    # The host loop
    # ------------------------------------------------------------------
    def learn(self, env=None, **kwargs):
        """The outer iLQR loop over rollouts of the stateful env."""
        if self.fused_solve and (env is None or env is self.env):
            return self.learn_fused(**kwargs)
        if env is None:
            env = self.env
        self.lamb = 1.0
        self.ite_counter = 0
        self.update_unstable = False
        previous_total_cost = -float('inf')
        prev_ite_improved = False
        self.max_steps = int(env.CTRL_FREQ * env.EPISODE_LEN_SEC)
        while self.ite_counter < self.max_iterations:
            self.traj_step = 0
            self.run(env=env, max_steps=self.max_steps, training=True)
            self.state_stack = np.vstack((self.state_stack, self.final_obs))
            if (self.ite_counter == 0 and env.done_on_out_of_bound
                    and self.final_info.get('out_of_bounds', False)):
                break
            delta_cost = self.total_cost - previous_total_cost
            if self.ite_counter == 0:
                previous_total_cost = self.total_cost
                self.input_ff_best = np.copy(self.input_ff)
                self.gains_fb_best = np.copy(self.gains_fb)
                self.update_policy(env)
                prev_ite_improved = False
            elif delta_cost > 0.0 or self.update_unstable:
                # Cost increased: revert and raise lambda.
                self.lamb = min(self.lamb * self.lamb_factor, self.lamb_max)
                self.input_ff = np.copy(self.input_ff_best)
                self.gains_fb = np.copy(self.gains_fb_best)
                prev_ite_improved = False
                self.update_unstable = False
            else:
                previous_total_cost = self.total_cost
                self.input_ff_best = np.copy(self.input_ff)
                self.gains_fb_best = np.copy(self.gains_fb)
                if abs(delta_cost) < self.epsilon and prev_ite_improved:
                    break
                prev_ite_improved = True
                self.update_policy(env)
            self.ite_counter += 1
        self.reset()

    def select_action(self, obs, info=None, training=False):
        """Time-indexed feedback and feedforward: the LQR policy in
        iteration 0 (recording its gains), the current policy while
        training, the best one after."""
        nu, nx = self.model.nu, self.model.nx
        if training:
            if self.ite_counter == 0:
                action, gains_fb, input_ff = self.calculate_lqr_action(obs, self.traj_step)
                if self.traj_step == 0:
                    self.gains_fb = gains_fb.reshape((1, nu, nx))
                    self.input_ff = input_ff.reshape(nu, 1)
                else:
                    self.gains_fb = np.append(self.gains_fb, gains_fb.reshape((1, nu, nx)),
                                              axis=0)
                    self.input_ff = np.append(self.input_ff, input_ff.reshape(nu, 1), axis=1)
            else:
                # A rollout that ended early recorded fewer gains than this
                # one may need.
                step = min(self.traj_step, len(self.gains_fb) - 1)
                action = self.gains_fb[step] @ obs + self.input_ff[:, step]
        elif self.gains_fb_best is not None:
            step = min(self.traj_step, len(self.gains_fb_best) - 1)
            action = self.gains_fb_best[step] @ obs + self.input_ff_best[:, step]
        else:
            action, _, _ = self.calculate_lqr_action(obs, self.traj_step)
        if self.traj_step < self.max_steps - 1:
            self.traj_step += 1
        return np.asarray(action)

    def calculate_lqr_action(self, obs, step):
        """Iteration 0's policy: the LQR gain about the goal (the waypoint
        ``step`` when tracking)."""
        goal = self.env.X_GOAL if self.env.TASK == Task.STABILIZATION \
            else self.env.X_GOAL[min(step, len(self.env.X_GOAL) - 1)]
        gains_fb = -self.gain
        input_ff = self.gain @ goal + np.atleast_1d(self.model.U_EQ)
        return gains_fb @ obs + input_ff, gains_fb, input_ff

    def reset(self):
        self.env.reset()
        self.ite_counter = 0
        self.traj_step = 0
        if not hasattr(self, 'max_steps'):
            self.max_steps = int(self.env.CTRL_FREQ * self.env.EPISODE_LEN_SEC)

    def reset_before_run(self, obs=None, info=None, env=None):
        self.traj_step = 0
        self.setup_results_dict()

    def run(self, env=None, max_steps=500, training=True):
        """Roll the current policy out from a reset of ``env``; records the
        states, inputs, final observation and info, and the total cost."""
        if env is None:
            env = self.env
        obs, info = env.reset()
        total_cost = 0.0
        for step in range(max_steps):
            action = self.select_action(obs=obs, info=info, training=training)
            if step == 0:
                self.state_stack = obs
                self.input_stack = action
            else:
                self.state_stack = np.vstack((self.state_stack, obs))
                self.input_stack = np.vstack((self.input_stack, action))
            obs, cost, done, info = env.step(action)
            total_cost -= cost
            if done:
                break
        self.final_obs = obs
        self.final_info = info
        self.total_cost = total_cost
