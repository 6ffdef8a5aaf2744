"""CartPole: the cartpole stabilization / tracking task, batched, in PyTorch.

Port of ``safe_control_gym_tpu/envs/cartpole.py``. The physics advance of a
batch with parameters shared by the batch goes through
``ops.physics_kernels.cartpole_advance`` (K1): its CUDA kernel for a batch on
the card, its plain version for a batch on the CPU. That is the role the JAX
package's ``custom_vmap`` rule plays for its Pallas kernel. With per-env
randomized parameters (``randomized_inertial_prop``), or without
``pallas_physics``, the step runs K1's plain twin on any device, as the JAX
package runs its scan there; ``physics_route`` names the route taken.

Parity with the JAX env: action scale 10 and normalization; state-space
thresholds (x 2.4 m, theta 90 deg, doubled for the box); the tab-force
dynamics disturbance at the pole COM; the RL reward on the wrapped angle and
the noisy action, or the quadratic cost on the clipped action; done on goal /
out of bounds; the weighted-MSE info; the additive randomization of the pole
length, cart mass and pole mass; the scene drawing of ``render`` and the
viewer.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from safe_control_gym_tpu_torch.envs import constraints as constraints_mod
from safe_control_gym_tpu_torch.envs.benchmark_env import (BenchmarkEnv, Cost, Task,
                                                           _compile_rand_sampler)
from safe_control_gym_tpu_torch.envs.dynamics import CartPoleParams, cartpole_dynamics
from safe_control_gym_tpu_torch.envs.spaces import Box
from safe_control_gym_tpu_torch.envs.symbolic import AnalyticModel
from safe_control_gym_tpu_torch.math.linalg import get_cost_weight_matrix
from safe_control_gym_tpu_torch.math.rotations import normalize_angle
from safe_control_gym_tpu_torch.ops.physics_kernels import (cartpole_advance,
                                                            cartpole_advance_plain)

__all__ = ['CartPole']


class CartPole(BenchmarkEnv):
    """Cartpole stabilization/tracking benchmark task."""

    NAME = 'cartpole'

    AVAILABLE_CONSTRAINTS = dict(
        abs_bound=constraints_mod.SymmetricStateConstraint,
        **constraints_mod.GENERAL_CONSTRAINTS,
    )

    DISTURBANCE_MODES = {'observation': {'dim': 4}, 'action': {'dim': 1},
                         'dynamics': {'dim': 2}}

    INERTIAL_PROP_RAND_INFO = {
        'pole_length': {'distrib': 'choice', 'args': [[1, 5, 10]]},
        'cart_mass': {'distrib': 'uniform', 'low': 0.5, 'high': 1.5},
        'pole_mass': {'distrib': 'uniform', 'low': 0.05, 'high': 0.15},
    }

    INIT_STATE_RAND_INFO = {
        'init_x': {'distrib': 'uniform', 'low': -0.05, 'high': 0.05},
        'init_x_dot': {'distrib': 'uniform', 'low': -0.05, 'high': 0.05},
        'init_theta': {'distrib': 'uniform', 'low': -0.05, 'high': 0.05},
        'init_theta_dot': {'distrib': 'uniform', 'low': -0.05, 'high': 0.05},
    }

    TASK_INFO = {
        'stabilization_goal': [0],
        'stabilization_goal_tolerance': 0.05,
        'trajectory_type': 'circle',
        'num_cycles': 1,
        'trajectory_plane': 'zx',
        'trajectory_position_offset': [0, 0],
        'trajectory_scale': 0.2,
    }

    def __init__(self,
                 init_state=None,
                 inertial_prop=None,
                 obs_goal_horizon: int = 0,
                 obs_wrap_angle: bool = False,
                 rew_state_weight=1.0,
                 rew_act_weight=0.0001,
                 rew_exponential: bool = True,
                 done_on_out_of_bound: bool = True,
                 info_mse_metric_state_weight=None,
                 **kwargs):
        self.obs_goal_horizon = obs_goal_horizon
        self.obs_wrap_angle = obs_wrap_angle
        self.rew_state_weight = np.array(rew_state_weight, ndmin=1, dtype=float)
        self.rew_act_weight = np.array(rew_act_weight, ndmin=1, dtype=float)
        self.Q = get_cost_weight_matrix(self.rew_state_weight, 4)
        self.R = get_cost_weight_matrix(self.rew_act_weight, 1)
        self.rew_exponential = rew_exponential
        self.done_on_out_of_bound = done_on_out_of_bound
        if info_mse_metric_state_weight is None:
            self.info_mse_metric_state_weight = np.array([1, 0, 1, 0], dtype=float)
        else:
            if len(info_mse_metric_state_weight) != 4:
                raise ValueError('[ERROR] in CartPole.__init__(), wrong '
                                 'info_mse_metric_state_weight argument size.')
            self.info_mse_metric_state_weight = np.array(
                info_mse_metric_state_weight, ndmin=1, dtype=float)

        # Default physical parameters.
        self.GRAVITY_ACC = 9.8
        EFFECTIVE_POLE_LENGTH, POLE_MASS, CART_MASS = 0.5, 0.1, 1.0
        if inertial_prop is None:
            self.EFFECTIVE_POLE_LENGTH = EFFECTIVE_POLE_LENGTH
            self.POLE_MASS = POLE_MASS
            self.CART_MASS = CART_MASS
        elif isinstance(inertial_prop, dict):
            self.EFFECTIVE_POLE_LENGTH = inertial_prop.get('pole_length', EFFECTIVE_POLE_LENGTH)
            self.POLE_MASS = inertial_prop.get('pole_mass', POLE_MASS)
            self.CART_MASS = inertial_prop.get('cart_mass', CART_MASS)
        else:
            raise ValueError('[ERROR] in CartPole.__init__(), inertial_prop incorrect format.')

        # Initial state config.
        if init_state is None:
            self.INIT_X = self.INIT_X_DOT = self.INIT_THETA = self.INIT_THETA_DOT = 0.0
        elif isinstance(init_state, (np.ndarray, list, tuple)):
            self.INIT_X, self.INIT_X_DOT, self.INIT_THETA, self.INIT_THETA_DOT = init_state
        elif isinstance(init_state, dict):
            self.INIT_X = init_state.get('init_x', 0)
            self.INIT_X_DOT = init_state.get('init_x_dot', 0)
            self.INIT_THETA = init_state.get('init_theta', 0)
            self.INIT_THETA_DOT = init_state.get('init_theta_dot', 0)
        else:
            raise ValueError('[ERROR] in CartPole.__init__(), init_state incorrect format.')

        super().__init__(init_state=init_state, inertial_prop=inertial_prop,
                         **kwargs)

        self._set_action_space()
        self._set_observation_space()
        self._setup_task_references()
        self._setup_symbolic()
        self._setup_constraints()
        self._setup_disturbances()
        self._prop_sampler = _compile_rand_sampler(
            self.INERTIAL_PROP_RAND_INFO, ['pole_length', 'cart_mass', 'pole_mass'])
        self._init_sampler = _compile_rand_sampler(
            self.INIT_STATE_RAND_INFO,
            ['init_x', 'init_x_dot', 'init_theta', 'init_theta_dot'])
        self._reward_weights()
        self.physics_route = ('K1' if self.pallas_physics and not self.RANDOMIZED_INERTIAL_PROP
                              else 'K1 plain twin')
        self._build_functional()

    # ------------------------------------------------------------------
    # Spaces
    # ------------------------------------------------------------------
    def _set_action_space(self):
        self.action_scale = 10
        self.physical_action_bounds = (-np.atleast_1d(float(self.action_scale)),
                                       np.atleast_1d(float(self.action_scale)))
        self.action_threshold = 1 if self.NORMALIZED_RL_ACTION_SPACE else self.action_scale
        self.action_space = Box(low=-self.action_threshold,
                                high=self.action_threshold, shape=(1,))
        self.ACTION_LABELS = ['U']
        self.ACTION_UNITS = ['N'] if not self.NORMALIZED_RL_ACTION_SPACE else ['-']

    def _set_observation_space(self):
        self.x_threshold = 2.4
        self.x_dot_threshold = 20
        self.theta_threshold_radians = 90 * math.pi / 180
        self.theta_dot_threshold = 20
        obs_bound = np.array([self.x_threshold * 2, self.x_dot_threshold,
                              self.theta_threshold_radians * 2,
                              self.theta_dot_threshold])
        self.state_space = Box(low=-obs_bound, high=obs_bound, dtype=np.float32)
        if self.COST == Cost.RL_REWARD and self.TASK == Task.TRAJ_TRACKING \
                and self.obs_goal_horizon > 0:
            obs_bound = np.concatenate([obs_bound] * (1 + self.obs_goal_horizon))
        elif self.COST == Cost.RL_REWARD and self.TASK == Task.STABILIZATION \
                and self.obs_goal_horizon > 0:
            obs_bound = np.concatenate([obs_bound] * 2)
        self.observation_space = Box(low=-obs_bound, high=obs_bound,
                                     dtype=np.float32)
        self.STATE_LABELS = ['x', 'x_dot', 'theta', 'theta_dot']
        self.STATE_UNITS = ['m', 'm/s', 'rad', 'rad/s']

    # ------------------------------------------------------------------
    # Task references
    # ------------------------------------------------------------------
    def _setup_task_references(self):
        self.U_GOAL = np.zeros(1)
        if self.TASK == Task.STABILIZATION:
            self.X_GOAL = np.hstack(
                [self.TASK_INFO['stabilization_goal'][0], 0.0, 0.0, 0.0])
        elif self.TASK == Task.TRAJ_TRACKING:
            POS_REF, VEL_REF, _ = self._generate_trajectory(
                traj_type=self.TASK_INFO['trajectory_type'],
                traj_length=self.EPISODE_LEN_SEC,
                num_cycles=self.TASK_INFO['num_cycles'],
                traj_plane=self.TASK_INFO['trajectory_plane'],
                position_offset=np.array(self.TASK_INFO['trajectory_position_offset']),
                scaling=self.TASK_INFO['trajectory_scale'],
                sample_time=self.CTRL_TIMESTEP)
            self.X_GOAL = np.vstack([
                POS_REF[:, 0], VEL_REF[:, 0],
                np.zeros(POS_REF.shape[0]), np.zeros(VEL_REF.shape[0]),
            ]).T

    # ------------------------------------------------------------------
    # Symbolic prior
    # ------------------------------------------------------------------
    def _setup_symbolic(self, prior_prop={}, **kwargs):
        """``self.symbolic``: the analytic model with the nominal inertial
        properties, or those ``prior_prop`` overrides."""
        length = prior_prop.get('pole_length', self.EFFECTIVE_POLE_LENGTH)
        m = prior_prop.get('pole_mass', self.POLE_MASS)
        M = prior_prop.get('cart_mass', self.CART_MASS)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        params = CartPoleParams(pole_length=f32(length), pole_mass=f32(m),
                                cart_mass=f32(M), gravity=f32(self.GRAVITY_ACC))
        self.symbolic = AnalyticModel(
            dyn_fn=lambda x, u: cartpole_dynamics(x, u, params),
            nx=4, nu=1, dt=self.CTRL_TIMESTEP, device=self.device,
            params={'pole_length': length, 'pole_mass': m, 'cart_mass': M,
                    'X_EQ': np.zeros(4), 'U_EQ': np.atleast_2d(self.U_GOAL)[0, :]})

    # ------------------------------------------------------------------
    # Functional-core hooks (batched)
    # ------------------------------------------------------------------
    def _reward_weights(self):
        """Reward weights and goal as float32 tensors on the env's device."""
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        w_s = self.rew_state_weight
        self._w_state = f32(w_s if len(w_s) == 4 else np.full(4, w_s[0]))
        self._w_act = f32(self.rew_act_weight)
        self._Q = f32(self.Q)
        self._R = f32(self.R)
        self._u_goal = f32(self.U_GOAL)
        self._w_mse = f32(self.info_mse_metric_state_weight)

    def _nominal_dyn_params(self):
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        return CartPoleParams(pole_length=f32(self.EFFECTIVE_POLE_LENGTH),
                              pole_mass=f32(self.POLE_MASS),
                              cart_mass=f32(self.CART_MASS),
                              gravity=f32(self.GRAVITY_ACC))

    def _sample_dyn_params(self, gen, nominal: CartPoleParams, n: int) -> CartPoleParams:
        """``n`` draws of the properties that INERTIAL_PROP_RAND_INFO randomizes
        (of the pole length, cart mass and pole mass), each such field (n,);
        the rest stay shared."""
        names = [k for k in ('pole_length', 'cart_mass', 'pole_mass')
                 if k in self.INERTIAL_PROP_RAND_INFO]
        d = self._prop_sampler(gen, {k: getattr(nominal, k).expand(n) for k in names})
        return dataclasses.replace(nominal, **{k: d[k].to(torch.float32) for k in names})

    def _nominal_init_state(self):
        return np.array([self.INIT_X, self.INIT_X_DOT, self.INIT_THETA,
                         self.INIT_THETA_DOT], dtype=np.float32)

    def _sample_init_state_batch(self, gen, nominal, n: int):
        names = ('init_x', 'init_x_dot', 'init_theta', 'init_theta_dot')
        base = {name: nominal[k].expand(n) for k, name in enumerate(names)}
        d = self._init_sampler(gen, base)
        return torch.stack([d[name].to(torch.float32) for name in names], dim=1)

    def _denormalize_action(self, action):
        if self.NORMALIZED_RL_ACTION_SPACE:
            return self.action_scale * action
        return action

    def denormalize_action(self, action):
        return self._denormalize_action(action)

    def normalize_action(self, action):
        if self.NORMALIZED_RL_ACTION_SPACE:
            return action / self.action_scale
        return action

    def _advance(self, x, clipped_action, dyn_force, params):
        """PYB_STEPS_PER_CTRL semi-implicit-Euler substeps with the force and
        the tab-force disturbance held (``physics_route``: K1, or its plain
        twin, which also takes the (B, 4) parameters of randomized envs)."""
        advance = cartpole_advance if self.physics_route == 'K1' else cartpole_advance_plain
        return advance(x.contiguous(), clipped_action[:, 0].contiguous(),
                       dyn_force.contiguous(), params.vector(),
                       self.PYB_STEPS_PER_CTRL, self.PYB_TIMESTEP)

    def _draw_state(self, ax):
        """The scene for ``render`` and the viewer: the track with its x
        limits, the goal or the reference, the cart, the pole, the axle."""
        from matplotlib.patches import Circle, Rectangle
        x, _, theta, _ = np.asarray(self.state)
        L = 2 * float(self.EFFECTIVE_POLE_LENGTH)
        ax.plot([-2.5, 2.5], [0, 0], 'k-', lw=1)
        for thr in (-self.x_threshold, self.x_threshold):
            ax.plot([thr, thr], [-0.08, 0.08], 'k:', lw=1)
        if self.TASK == Task.TRAJ_TRACKING and np.ndim(self.X_GOAL) == 2:
            ax.plot(self.X_GOAL[:, 0], np.full(self.X_GOAL.shape[0], -0.12), 'g--', lw=0.8)
            wp = min(int(self.ctrl_step_counter), self.X_GOAL.shape[0] - 1)
            ax.plot([self.X_GOAL[wp, 0]], [-0.12], 'g^', ms=6)
        else:
            g = np.atleast_2d(self.X_GOAL)[0]
            ax.plot([g[0]], [-0.12], 'g*', ms=10)
        ax.add_patch(Rectangle((x - 0.15, -0.05), 0.3, 0.1, color='tab:blue'))
        ax.plot([x, x + L * np.sin(theta)], [0.05, 0.05 + L * np.cos(theta)],
                'r-', lw=3, solid_capstyle='round')
        ax.add_patch(Circle((x, 0.05), 0.03, color='k', zorder=3))
        ax.set_xlim(-2.6, 2.6)
        ax.set_ylim(-0.5, 1.5)

    def _obs_transform(self, state):
        if self.obs_wrap_angle:
            state = state.clone()
            state[:, 2] = normalize_angle(state[:, 2])
        return state

    def _goal_rows(self, step, offset):
        """(B, 4) reference rows: the goal, or X_GOAL[step + offset] clamped."""
        X_GOAL = self._x_goal
        if self.TASK == Task.STABILIZATION:
            return X_GOAL[0].expand(step.shape[0], -1)
        idx = torch.clamp(step.to(torch.int64) + offset, 0, X_GOAL.shape[0] - 1)
        return X_GOAL[idx]

    def _rl_reward(self, state, noisy_action, step):
        """Negative quadratic reward on the wrapped angle and the raw noisy
        action, exponentiated unless ``rew_exponential`` is off."""
        wrapped = state.clone()
        wrapped[:, 2] = normalize_angle(state[:, 2])
        err = wrapped - self._goal_rows(step, 1)
        dist = (self._w_state * err * err).sum(dim=1) \
            + (self._w_act * noisy_action * noisy_action).sum(dim=1)
        rew = -dist
        if self.rew_exponential:
            rew = torch.exp(rew)
        return rew

    def _quadratic_reward(self, state, clipped_action, step):
        """Minus the quadratic loss 0.5 dx'Q dx + 0.5 du'R du."""
        dx = state - self._goal_rows(step, 0)
        du = clipped_action - self._u_goal
        return -(0.5 * ((dx @ self._Q) * dx).sum(dim=1)
                 + 0.5 * ((du @ self._R) * du).sum(dim=1))

    def _oob(self, state):
        return (torch.abs(state[:, 0]) > self.x_threshold) \
            | (torch.abs(state[:, 2]) > self.theta_threshold_radians)

    def _mse(self, state, step):
        """Weighted squared error against the reference (info['mse'])."""
        if self.TASK == Task.STABILIZATION:
            err = state - self._goal_rows(step, 0)
        else:
            wrapped = state.clone()
            wrapped[:, 2] = normalize_angle(state[:, 2])
            err = wrapped - self._goal_rows(step, 1)
        err = err * self._w_mse
        return (err ** 2).sum(dim=1)
