"""Quadrotor: the 1D, 2D and 3D quadrotor stabilization / tracking tasks, batched, in PyTorch.

Port of ``safe_control_gym_tpu/envs/quadrotor.py``. The commanded thrusts
pass through the motor model (thrust -> PWM -> RPM -> per-motor forces,
``envs/dynamics.py``), so motor saturation is kept.

The physics advance takes one of two routes, chosen once per env by
``_uses_physics_kernel``, the predicate of the JAX package's
``_install_pallas_advance``: plain ``'pyb'`` physics of a 2D or 3D quad with
parameters shared by the batch goes through
``ops.physics_kernels.quad2d_advance`` (K2) or ``quad3d_advance`` (K3), the
CUDA kernel for a batch on the card and the plain version for a batch on the
CPU (their plain twins themselves under ``pallas_physics=False``). Every
other case (the 1D quad, the modes ``dyn``, ``pyb_gnd``, ``pyb_drag``,
``pyb_dw`` and ``pyb_gnd_drag_dw``, and per-env randomized parameters) runs
``_advance_general``, the batched PyTorch form of JAX's ``_sim_xdot``,
``_sim_pos_rates`` and the substep scan of ``_advance_pure``, as the JAX
package runs them on its scan path. ``physics_route`` names the route taken.

Physics modes: ``pyb`` is semi-implicit Euler on the analytic ODE; ``dyn``
explicit Euler; ``pyb_gnd`` adds the ground effect (the height clipped at
``GND_EFF_H_CLIP``; in 3D only while ``|phi|, |theta| < pi/2``);
``pyb_drag`` the rotor drag, rotated into the world frame; ``pyb_dw`` adds
nothing, since downwash needs a second drone; ``pyb_gnd_drag_dw`` both.

Parity with the JAX env: the CF2X constants and derived motor constants, the
``inertial_prop`` overrides, the init state and its randomization filtered by
quad type, the inertial-property randomization (``M``, ``Ixx``, ``Iyy``,
``Izz``, additive, per env), the spaces, ``X_GOAL`` / ``U_GOAL`` (3D
tracking projected onto the ``proj_point`` / ``proj_normal`` plane), the RL
reward on state error and action error against ``U_GOAL``, the quadratic
cost, both on the waypoint ``X_GOAL[step + 1]`` when tracking, the two-sided
out-of-bounds check on the position and angle dims, the weighted-MSE info,
and the scene drawing of ``render`` and the viewer (the xz plane, and a 3D
wireframe for the 3D quad's ``render``).
"""

from __future__ import annotations

import dataclasses
import math
from copy import deepcopy
from enum import IntEnum

import numpy as np
import torch

from safe_control_gym_tpu_torch.envs import constraints as constraints_mod
from safe_control_gym_tpu_torch.envs.benchmark_env import (BenchmarkEnv, Cost, Task,
                                                           _compile_rand_sampler)
from safe_control_gym_tpu_torch.envs.dynamics import (QuadParams, _sqrt2, cmd2pwm,
                                                      pwm2rpm, quad1d_dynamics,
                                                      quad2d_dynamics, quad3d_dynamics,
                                                      rpm2forces)
from safe_control_gym_tpu_torch.envs.spaces import Box
from safe_control_gym_tpu_torch.envs.symbolic import AnalyticModel
from safe_control_gym_tpu_torch.math.linalg import get_cost_weight_matrix
from safe_control_gym_tpu_torch.math.rotations import (normalize_angle, rot_xyz,
                                                       transform_trajectory)
from safe_control_gym_tpu_torch.ops.physics_kernels import (quad2d_advance,
                                                            quad2d_advance_plain,
                                                            quad3d_advance,
                                                            quad3d_advance_plain)

__all__ = ['QuadType', 'Quadrotor']


class QuadType(IntEnum):
    """Quadrotor motion types."""
    ONE_D = 1
    TWO_D = 2
    THREE_D = 3


GROUND_PLANE_Z = -0.05

# Per quad type: state, action and dynamics-disturbance dims; the position
# and angle dims checked for out of bounds; the default info['mse'] weights
# (the position coordinates); the angle dims wrapped for the tracking MSE.
_NX = {QuadType.ONE_D: 2, QuadType.TWO_D: 6, QuadType.THREE_D: 12}
_NU = {QuadType.ONE_D: 1, QuadType.TWO_D: 2, QuadType.THREE_D: 4}
_DYN_DIM = {QuadType.ONE_D: 1, QuadType.TWO_D: 2, QuadType.THREE_D: 3}
_OOB_MASK = {QuadType.ONE_D: [1, 0],
             QuadType.TWO_D: [1, 0, 1, 0, 1, 0],
             QuadType.THREE_D: [1, 0, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0]}
_MSE_WEIGHT = {QuadType.ONE_D: [1, 0],
               QuadType.TWO_D: [1, 0, 1, 0, 0, 0],
               QuadType.THREE_D: [1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0]}
_ANGLE_DIMS = {QuadType.ONE_D: [], QuadType.TWO_D: [4], QuadType.THREE_D: [6, 7, 8]}
# The velocity coordinates and the position coordinates they advance, in the
# order of the semi-implicit substep.
_VEL_IDX = {QuadType.ONE_D: [1], QuadType.TWO_D: [1, 3, 5],
            QuadType.THREE_D: [1, 3, 5, 9, 10, 11]}
_POS_IDX = {QuadType.ONE_D: [0], QuadType.TWO_D: [0, 2, 4],
            QuadType.THREE_D: [0, 2, 4, 6, 7, 8]}


class Quadrotor(BenchmarkEnv):
    """2D/3D quadrotor stabilization and tracking benchmark."""

    NAME = 'quadrotor'

    AVAILABLE_CONSTRAINTS = dict(constraints_mod.GENERAL_CONSTRAINTS)

    DISTURBANCE_MODES = {  # dims set per instance from QUAD_TYPE
        'observation': {'dim': -1}, 'action': {'dim': -1}, 'dynamics': {'dim': -1}}

    BASE_INERTIAL_PROP_RAND_INFO = {
        'M': {'distrib': 'uniform', 'low': 0.022, 'high': 0.032},
        'Ixx': {'distrib': 'uniform', 'low': 1.3e-5, 'high': 1.5e-5},
        'Iyy': {'distrib': 'uniform', 'low': 1.3e-5, 'high': 1.5e-5},
        'Izz': {'distrib': 'uniform', 'low': 2.07e-5, 'high': 2.27e-5},
    }

    BASE_INIT_STATE_RAND_INFO = {
        'init_x': {'distrib': 'uniform', 'low': -0.5, 'high': 0.5},
        'init_x_dot': {'distrib': 'uniform', 'low': -0.01, 'high': 0.01},
        'init_y': {'distrib': 'uniform', 'low': -0.5, 'high': 0.5},
        'init_y_dot': {'distrib': 'uniform', 'low': -0.01, 'high': 0.01},
        'init_z': {'distrib': 'uniform', 'low': 0.1, 'high': 1.5},
        'init_z_dot': {'distrib': 'uniform', 'low': -0.01, 'high': 0.01},
        'init_phi': {'distrib': 'uniform', 'low': -0.3, 'high': 0.3},
        'init_theta': {'distrib': 'uniform', 'low': -0.3, 'high': 0.3},
        'init_psi': {'distrib': 'uniform', 'low': -0.3, 'high': 0.3},
        'init_p': {'distrib': 'uniform', 'low': -0.01, 'high': 0.01},
        'init_theta_dot': {'distrib': 'uniform', 'low': -0.01, 'high': 0.01},
        'init_q': {'distrib': 'uniform', 'low': -0.01, 'high': 0.01},
        'init_r': {'distrib': 'uniform', 'low': -0.01, 'high': 0.01},
    }

    INIT_STATE_LABELS = {
        QuadType.ONE_D: ['init_x', 'init_x_dot'],
        QuadType.TWO_D: ['init_x', 'init_x_dot', 'init_z', 'init_z_dot',
                         'init_theta', 'init_theta_dot'],
        QuadType.THREE_D: ['init_x', 'init_x_dot', 'init_y', 'init_y_dot',
                           'init_z', 'init_z_dot', 'init_phi', 'init_theta',
                           'init_psi', 'init_p', 'init_q', 'init_r'],
    }

    TASK_INFO = {
        'stabilization_goal': [0, 1],
        'stabilization_goal_tolerance': 0.05,
        'trajectory_type': 'circle',
        'num_cycles': 1,
        'trajectory_plane': 'zx',
        'trajectory_position_offset': [0.5, 0],
        'trajectory_scale': -0.5,
        'proj_point': [0, 0, 0.5],
        'proj_normal': [0, 1, 1],
    }

    def __init__(self,
                 init_state=None,
                 inertial_prop=None,
                 quad_type: QuadType = QuadType.TWO_D,
                 physics: str = 'pyb',
                 norm_act_scale: float = 0.1,
                 obs_goal_horizon: int = 0,
                 rew_state_weight=1.0,
                 rew_act_weight=0.0001,
                 rew_exponential: bool = True,
                 done_on_out_of_bound: bool = True,
                 info_mse_metric_state_weight=None,
                 **kwargs):
        self.QUAD_TYPE = QuadType(quad_type)
        self.PHYSICS = physics
        self.norm_act_scale = norm_act_scale
        self.obs_goal_horizon = obs_goal_horizon
        self.rew_state_weight = np.array(rew_state_weight, ndmin=1, dtype=float)
        self.rew_act_weight = np.array(rew_act_weight, ndmin=1, dtype=float)
        self.rew_exponential = rew_exponential
        self.done_on_out_of_bound = done_on_out_of_bound

        nx, nu = _NX[self.QUAD_TYPE], _NU[self.QUAD_TYPE]
        if info_mse_metric_state_weight is None:
            self.info_mse_metric_state_weight = np.array(_MSE_WEIGHT[self.QUAD_TYPE],
                                                         dtype=float)
        else:
            if len(info_mse_metric_state_weight) != nx:
                raise ValueError('[ERROR] in Quadrotor.__init__(), wrong '
                                 'info_mse_metric_state_weight argument size.')
            self.info_mse_metric_state_weight = np.array(
                info_mse_metric_state_weight, ndmin=1, dtype=float)

        # CF2X physical constants (cf2x.urdf and the reference's base aviary).
        self.GRAVITY_ACC = 9.8
        self.MASS = 0.027
        self.L = 0.0397
        self.J = np.diag([1.4e-5, 1.4e-5, 2.17e-5])
        self.KF = 3.16e-10
        self.KM = 7.94e-12
        self.THRUST2WEIGHT_RATIO = 2.25
        self.GND_EFF_COEFF = 11.36859
        self.PROP_RADIUS = 2.31348e-2
        self.DRAG_COEFF = np.array([9.1785e-7, 9.1785e-7, 10.311e-7])
        self.PWM2RPM_SCALE = 0.2685
        self.PWM2RPM_CONST = 4070.3
        self.MIN_PWM = 20000.0
        self.MAX_PWM = 65535.0
        self.GROUND_PLANE_Z = GROUND_PLANE_Z

        # Inertial property overrides.
        if inertial_prop is None:
            pass
        elif self.QUAD_TYPE == QuadType.ONE_D and np.array(inertial_prop).shape == (1,):
            self.MASS = float(np.array(inertial_prop)[0])
        elif self.QUAD_TYPE == QuadType.TWO_D and np.array(inertial_prop).shape == (2,):
            self.MASS, self.J[1, 1] = np.array(inertial_prop)
        elif self.QUAD_TYPE == QuadType.THREE_D and np.array(inertial_prop).shape == (4,):
            self.MASS, self.J[0, 0], self.J[1, 1], self.J[2, 2] = np.array(inertial_prop)
        elif isinstance(inertial_prop, dict):
            self.MASS = inertial_prop.get('M', self.MASS)
            self.J[0, 0] = inertial_prop.get('Ixx', self.J[0, 0])
            self.J[1, 1] = inertial_prop.get('Iyy', self.J[1, 1])
            self.J[2, 2] = inertial_prop.get('Izz', self.J[2, 2])
        else:
            raise ValueError('[ERROR] in Quadrotor.__init__(), inertial_prop incorrect format.')

        # Derived motor constants.
        self.GRAVITY = self.GRAVITY_ACC * self.MASS
        self.HOVER_RPM = np.sqrt(self.GRAVITY / (4 * self.KF))
        self.MAX_RPM = np.sqrt((self.THRUST2WEIGHT_RATIO * self.GRAVITY) / (4 * self.KF))
        self.MAX_THRUST = 4 * self.KF * self.MAX_RPM ** 2
        self.GND_EFF_H_CLIP = 0.25 * self.PROP_RADIUS * np.sqrt(
            (15 * self.MAX_RPM ** 2 * self.KF * self.GND_EFF_COEFF) / self.MAX_THRUST)

        # Initial state.
        labels = self.INIT_STATE_LABELS[self.QUAD_TYPE]
        if init_state is None:
            for name in labels:
                setattr(self, name.upper(), 0.0)
        elif isinstance(init_state, (np.ndarray, list, tuple)):
            for i, name in enumerate(labels):
                setattr(self, name.upper(), float(np.asarray(init_state)[i]))
        elif isinstance(init_state, dict):
            for name in labels:
                setattr(self, name.upper(), float(init_state.get(name, 0.0)))
        else:
            raise ValueError('[ERROR] in Quadrotor.__init__(), init_state incorrect format.')

        # Randomization info filtered by quad type.
        self.INIT_STATE_RAND_INFO = {
            k: v for k, v in deepcopy(self.BASE_INIT_STATE_RAND_INFO).items()
            if k in labels}
        self.INERTIAL_PROP_RAND_INFO = deepcopy(self.BASE_INERTIAL_PROP_RAND_INFO)
        unused = {QuadType.ONE_D: ('Ixx', 'Iyy', 'Izz'), QuadType.TWO_D: ('Ixx', 'Izz'),
                  QuadType.THREE_D: ()}[self.QUAD_TYPE]
        for k in unused:
            self.INERTIAL_PROP_RAND_INFO.pop(k, None)

        self.DISTURBANCE_MODES = {'observation': {'dim': nx}, 'action': {'dim': nu},
                                  'dynamics': {'dim': _DYN_DIM[self.QUAD_TYPE]}}

        super().__init__(init_state=init_state, inertial_prop=inertial_prop,
                         **kwargs)

        self._set_action_space()
        self._set_observation_space()
        self._setup_task_references()
        self._setup_symbolic()
        self._setup_constraints()
        self._setup_disturbances()
        self._prop_sampler = _compile_rand_sampler(self.INERTIAL_PROP_RAND_INFO,
                                                   ['M', 'Ixx', 'Iyy', 'Izz'])
        self._init_sampler = _compile_rand_sampler(self.INIT_STATE_RAND_INFO, labels)
        self._reward_weights()
        self._setup_physics()
        self._build_functional()

    # ------------------------------------------------------------------
    # Spaces
    # ------------------------------------------------------------------
    def _set_action_space(self):
        action_dim = _NU[self.QUAD_TYPE]
        self.ACTION_LABELS = ['T'] if action_dim == 1 else \
            [f'T{i + 1}' for i in range(action_dim)]
        self.ACTION_UNITS = (['N'] * action_dim if not self.NORMALIZED_RL_ACTION_SPACE
                             else ['-'] * action_dim)
        n_mot = 4 / action_dim
        a_low = self.KF * n_mot * (self.PWM2RPM_SCALE * self.MIN_PWM + self.PWM2RPM_CONST) ** 2
        a_high = self.KF * n_mot * (self.PWM2RPM_SCALE * self.MAX_PWM + self.PWM2RPM_CONST) ** 2
        self.physical_action_bounds = (np.full(action_dim, a_low, np.float32),
                                       np.full(action_dim, a_high, np.float32))
        self.hover_thrust = self.GRAVITY_ACC * self.MASS / action_dim
        if self.NORMALIZED_RL_ACTION_SPACE:
            self.action_space = Box(low=-np.ones(action_dim), high=np.ones(action_dim))
        else:
            self.action_space = Box(low=self.physical_action_bounds[0],
                                    high=self.physical_action_bounds[1])

    def _set_observation_space(self):
        self.x_threshold = 2
        self.y_threshold = 2
        self.z_threshold = 2
        self.x_dot_threshold = 30
        self.y_dot_threshold = 30
        self.z_dot_threshold = 30
        self.phi_threshold_radians = 85 * math.pi / 180
        self.theta_threshold_radians = 85 * math.pi / 180
        self.psi_threshold_radians = 180 * math.pi / 180
        ang_dot = 500 * math.pi / 180
        if self.QUAD_TYPE == QuadType.ONE_D:
            low = np.array([self.GROUND_PLANE_Z, -self.z_dot_threshold])
            high = np.array([self.z_threshold, self.z_dot_threshold])
            self.STATE_LABELS = ['z', 'z_dot']
            self.STATE_UNITS = ['m', 'm/s']
        elif self.QUAD_TYPE == QuadType.TWO_D:
            low = np.array([-self.x_threshold, -self.x_dot_threshold,
                            self.GROUND_PLANE_Z, -self.z_dot_threshold,
                            -self.theta_threshold_radians, -ang_dot])
            high = np.array([self.x_threshold, self.x_dot_threshold,
                             self.z_threshold, self.z_dot_threshold,
                             self.theta_threshold_radians, ang_dot])
            self.STATE_LABELS = ['x', 'x_dot', 'z', 'z_dot', 'theta', 'theta_dot']
            self.STATE_UNITS = ['m', 'm/s', 'm', 'm/s', 'rad', 'rad/s']
        else:
            low = np.array([-self.x_threshold, -self.x_dot_threshold,
                            -self.y_threshold, -self.y_dot_threshold,
                            self.GROUND_PLANE_Z, -self.z_dot_threshold,
                            -self.phi_threshold_radians,
                            -self.theta_threshold_radians,
                            -self.psi_threshold_radians,
                            -ang_dot, -ang_dot, -ang_dot])
            high = np.array([self.x_threshold, self.x_dot_threshold,
                             self.y_threshold, self.y_dot_threshold,
                             self.z_threshold, self.z_dot_threshold,
                             self.phi_threshold_radians,
                             self.theta_threshold_radians,
                             self.psi_threshold_radians,
                             ang_dot, ang_dot, ang_dot])
            self.STATE_LABELS = ['x', 'x_dot', 'y', 'y_dot', 'z', 'z_dot',
                                 'phi', 'theta', 'psi', 'p', 'q', 'r']
            self.STATE_UNITS = ['m', 'm/s', 'm', 'm/s', 'm', 'm/s',
                                'rad', 'rad', 'rad', 'rad/s', 'rad/s', 'rad/s']
        self.state_space = Box(low=low, high=high, dtype=np.float32)
        if self.COST == Cost.RL_REWARD and self.TASK == Task.TRAJ_TRACKING \
                and self.obs_goal_horizon > 0:
            mul = 1 + self.obs_goal_horizon
            low = np.concatenate([low] * mul)
            high = np.concatenate([high] * mul)
        elif self.COST == Cost.RL_REWARD and self.TASK == Task.STABILIZATION \
                and self.obs_goal_horizon > 0:
            low = np.concatenate([low] * 2)
            high = np.concatenate([high] * 2)
        self.observation_space = Box(low=low, high=high, dtype=np.float32)

    # ------------------------------------------------------------------
    # Task references
    # ------------------------------------------------------------------
    def _setup_task_references(self):
        self.U_GOAL = np.ones(self.action_dim) * self.MASS * self.GRAVITY_ACC / self.action_dim
        if self.TASK == Task.STABILIZATION:
            goal = self.TASK_INFO['stabilization_goal']
            if self.QUAD_TYPE == QuadType.ONE_D:
                self.X_GOAL = np.hstack([goal[1], 0.0])
            elif self.QUAD_TYPE == QuadType.TWO_D:
                self.X_GOAL = np.hstack([goal[0], 0.0, goal[1], 0.0, 0.0, 0.0])
            else:
                self.X_GOAL = np.hstack([goal[0], 0.0, goal[1], 0.0, goal[2],
                                         0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
            return
        POS_REF, VEL_REF, _ = self._generate_trajectory(
            traj_type=self.TASK_INFO['trajectory_type'],
            traj_length=self.EPISODE_LEN_SEC,
            num_cycles=self.TASK_INFO['num_cycles'],
            traj_plane=self.TASK_INFO['trajectory_plane'],
            position_offset=np.asarray(self.TASK_INFO['trajectory_position_offset']),
            scaling=self.TASK_INFO['trajectory_scale'],
            sample_time=self.CTRL_TIMESTEP)
        z = np.zeros(POS_REF.shape[0])
        if self.QUAD_TYPE == QuadType.ONE_D:
            self.X_GOAL = np.vstack([POS_REF[:, 2], VEL_REF[:, 2]]).T
            return
        if self.QUAD_TYPE == QuadType.TWO_D:
            self.X_GOAL = np.vstack([POS_REF[:, 0], VEL_REF[:, 0],
                                     POS_REF[:, 2], VEL_REF[:, 2], z, z]).T
            return
        # The plane projection runs in float32, as the JAX package's does.
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        POS_T, VEL_T = transform_trajectory(
            f32(POS_REF), f32(VEL_REF), trans_info={
                'point': self.TASK_INFO['proj_point'],
                'normal': self.TASK_INFO['proj_normal']})
        POS_T, VEL_T = POS_T.numpy(), VEL_T.numpy()
        self.X_GOAL = np.vstack([POS_T[:, 0], VEL_T[:, 0], POS_T[:, 1], VEL_T[:, 1],
                                 POS_T[:, 2], VEL_T[:, 2], z, z, z, z, z, z]).T

    # ------------------------------------------------------------------
    # Symbolic prior
    # ------------------------------------------------------------------
    def _setup_symbolic(self, prior_prop={}, **kwargs):
        """``self.symbolic``: the analytic model of the 1D, 2D or 3D quad with the
        nominal inertial properties, or those ``prior_prop`` overrides; also
        the cost matrices ``Q`` and ``R``."""
        m = prior_prop.get('M', self.MASS)
        Iyy = prior_prop.get('Iyy', self.J[1, 1])
        Ixx = prior_prop.get('Ixx', self.J[0, 0])
        Izz = prior_prop.get('Izz', self.J[2, 2])
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        params = QuadParams(mass=f32(m), Ixx=f32(Ixx), Iyy=f32(Iyy), Izz=f32(Izz),
                            arm_length=f32(self.L), kf=f32(self.KF), km=f32(self.KM),
                            gravity=f32(self.GRAVITY_ACC)).to(self.device)
        nx, nu = _NX[self.QUAD_TYPE], _NU[self.QUAD_TYPE]
        ode = {QuadType.ONE_D: quad1d_dynamics, QuadType.TWO_D: quad2d_dynamics,
               QuadType.THREE_D: quad3d_dynamics}[self.QUAD_TYPE]
        self.Q = get_cost_weight_matrix(self.rew_state_weight, nx)
        self.R = get_cost_weight_matrix(self.rew_act_weight, nu)
        three_d = self.QUAD_TYPE == QuadType.THREE_D
        self.symbolic = AnalyticModel(
            dyn_fn=lambda x, u: ode(x, u, params), nx=nx, nu=nu, dt=self.CTRL_TIMESTEP,
            device=self.device,
            params={'quad_mass': m, 'quad_Iyy': Iyy,
                    'quad_Ixx': Ixx if three_d else None,
                    'quad_Izz': Izz if three_d else None,
                    'X_EQ': np.zeros(nx), 'U_EQ': np.ones(nu) * m * self.GRAVITY_ACC / nu})

    # ------------------------------------------------------------------
    # Functional-core hooks (batched)
    # ------------------------------------------------------------------
    def _reward_weights(self):
        """Reward weights, cost matrices and bounds as float32 tensors on the
        env's device."""
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        nx, nu = self.state_dim, self.action_dim
        w_s, w_a = self.rew_state_weight, self.rew_act_weight
        self._w_state = f32(w_s if len(w_s) == nx else np.full(nx, w_s[0]))
        self._w_act = f32(w_a if len(w_a) == nu else np.full(nu, w_a[0]))
        self._Q = f32(self.Q)
        self._R = f32(self.R)
        self._u_goal = f32(self.U_GOAL)
        self._w_mse = f32(self.info_mse_metric_state_weight)
        self._state_lo = f32(self.state_space.low)
        self._state_hi = f32(self.state_space.high)
        self._oob_mask = torch.as_tensor(_OOB_MASK[self.QUAD_TYPE], dtype=torch.bool,
                                         device=self.device)

    def _nominal_dyn_params(self):
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        return QuadParams(**{f: f32(v) for f, v in (
            ('mass', self.MASS), ('Ixx', self.J[0, 0]), ('Iyy', self.J[1, 1]),
            ('Izz', self.J[2, 2]), ('arm_length', self.L), ('kf', self.KF),
            ('km', self.KM), ('gravity', self.GRAVITY_ACC))}).to(self.device)

    def _nominal_init_state(self):
        return np.array([getattr(self, n.upper())
                         for n in self.INIT_STATE_LABELS[self.QUAD_TYPE]],
                        dtype=np.float32)

    def _sample_init_state_batch(self, gen, nominal, n: int):
        labels = self.INIT_STATE_LABELS[self.QUAD_TYPE]
        base = {name: nominal[k].expand(n) for k, name in enumerate(labels)}
        d = self._init_sampler(gen, base)
        return torch.stack([d[name].to(torch.float32) for name in labels], dim=1)

    def _denormalize_action(self, action):
        """A normalized action is +-norm_act_scale around the hover thrust."""
        if self.NORMALIZED_RL_ACTION_SPACE:
            return (1 + self.norm_act_scale * action) * self.hover_thrust
        return action

    def denormalize_action(self, action):
        return self._denormalize_action(action)

    def normalize_action(self, action):
        if self.NORMALIZED_RL_ACTION_SPACE:
            return (action / self.hover_thrust - 1) / self.norm_act_scale
        return action

    def _motor_forces(self, thrust, params: QuadParams):
        """Commanded thrusts (B, nu) -> per-motor forces (B, 4), yaw torque
        (B,) and RPMs (B, 4) through the PWM/RPM motor model, which keeps the
        motors' saturation."""
        rpm = pwm2rpm(cmd2pwm(thrust, params), params)
        forces, z_torque = rpm2forces(rpm, params)
        return forces, z_torque, rpm

    def _uses_physics_kernel(self) -> bool:
        """The predicate of the JAX package's ``_install_pallas_advance``: plain
        'pyb' physics of a 2D or 3D quad with parameters shared by the batch
        takes K2/K3; every other case the general advance."""
        return (not self.RANDOMIZED_INERTIAL_PROP
                and self.QUAD_TYPE in (QuadType.TWO_D, QuadType.THREE_D)
                and self.PHYSICS == 'pyb')

    def _setup_physics(self):
        """The route of the physics advance (``physics_route``) and the drag
        coefficients of the general advance, rounded to float32."""
        self.physics_route = 'general'
        if self._uses_physics_kernel():
            kname = 'K2' if self.QUAD_TYPE == QuadType.TWO_D else 'K3'
            self.physics_route = kname if self.pallas_physics else f'{kname} plain twin'
        self._drag_coeff = [float(c) for c in np.asarray(self.DRAG_COEFF, np.float32)]

    def _sample_dyn_params(self, gen, nominal: QuadParams, n: int) -> QuadParams:
        """``n`` draws of the inertial properties that INERTIAL_PROP_RAND_INFO
        randomizes (of ``M``, ``Ixx``, ``Iyy``, ``Izz``), each such field (n,);
        the rest stay shared."""
        fields = {'M': 'mass', 'Ixx': 'Ixx', 'Iyy': 'Iyy', 'Izz': 'Izz'}
        drawn = [k for k in fields if k in self.INERTIAL_PROP_RAND_INFO]
        d = self._prop_sampler(gen, {k: getattr(nominal, fields[k]).expand(n) for k in drawn})
        return dataclasses.replace(nominal, **{fields[k]: d[k].to(torch.float32)
                                               for k in drawn})

    def _advance(self, x, clipped_action, dyn_force, params):
        """The motor model, then PYB_STEPS_PER_CTRL substeps with the forces
        and the world disturbance force held, by ``physics_route``: K2 in 2D
        on the rotor-pair thrusts, K3 in 3D (their plain twins without
        ``pallas_physics``), or the general advance."""
        forces, z_torque, rpm = self._motor_forces(clipped_action, params)
        if self.physics_route == 'general':
            return self._advance_general(x, forces, z_torque, rpm, dyn_force, params)
        kernel = self.pallas_physics
        if self.QUAD_TYPE == QuadType.TWO_D:
            t1 = forces[:, 0] + forces[:, 3]
            t2 = forces[:, 1] + forces[:, 2]
            advance = quad2d_advance if kernel else quad2d_advance_plain
            return advance(x.contiguous(), t1, t2, dyn_force.contiguous(),
                           params.vector2d(), self.PYB_STEPS_PER_CTRL, self.PYB_TIMESTEP)
        advance = quad3d_advance if kernel else quad3d_advance_plain
        return advance(x.contiguous(), forces.contiguous(), z_torque,
                       dyn_force.contiguous(), params.vector3d(),
                       self.PYB_STEPS_PER_CTRL, self.PYB_TIMESTEP)

    def _ground_effect(self, forces, z, p: QuadParams):
        """The extra thrust of the ground effect, (B,), with the height
        clipped from below at GND_EFF_H_CLIP."""
        z = torch.clamp(z, min=float(self.GND_EFF_H_CLIP))
        ratio = (p.prop_radius / (4 * z)) ** 2
        return (forces * self.GND_EFF_COEFF * ratio[:, None]).sum(dim=1)

    def _drag(self, rpm, vel):
        """The rotor drag force along each axis of ``vel`` (3 columns): minus
        the drag coefficient times the rotors' summed angular speed, times the
        velocity."""
        omega_sum = (2 * math.pi * rpm / 60.0).sum(dim=1)
        return [-self._drag_coeff[k] * omega_sum * v for k, v in enumerate(vel)]

    def _sim_xdot(self, c, forces, z_torque, rpm, dyn_force, p: QuadParams):
        """The continuous dynamics of the simulation, with the ground effect
        and drag of the physics mode; ``c`` and the result are lists of the
        (B,) state columns. Rotations are written out: R = Rz(psi) Ry(theta)
        Rx(phi), whose third column carries the thrust."""
        use_gnd = self.PHYSICS in ('pyb_gnd', 'pyb_gnd_drag_dw')
        use_drag = self.PHYSICS in ('pyb_drag', 'pyb_gnd_drag_dw')
        m, g = p.mass, p.gravity
        if self.QUAD_TYPE == QuadType.ONE_D:
            T = forces.sum(dim=1)
            if use_gnd:
                T = T + self._ground_effect(forces, c[0], p)
            return [c[1], T / m - g + dyn_force[:, 0] / m]
        if self.QUAD_TYPE == QuadType.TWO_D:
            st, ct = torch.sin(c[4]), torch.cos(c[4])
            T1 = forces[:, 0] + forces[:, 3]
            T2 = forces[:, 1] + forces[:, 2]
            total = T1 + T2
            if use_gnd:
                total = total + self._ground_effect(forces, c[2], p)
            x_ddot = st * total / m + dyn_force[:, 0] / m
            z_ddot = ct * total / m - g + dyn_force[:, 1] / m
            if use_drag:
                # The drag of the x and z velocities, rotated by Ry(theta).
                dx, _, dz = self._drag(rpm, (c[1], 0.0 * c[1], c[3]))
                x_ddot = x_ddot + (ct * dx + st * dz) / m
                z_ddot = z_ddot + (ct * dz - st * dx) / m
            theta_ddot = p.arm_length * (T2 - T1) / p.Iyy / _sqrt2(c[4])
            return [c[1], x_ddot, c[3], z_ddot, c[5], theta_ddot]
        phi, theta, psi = c[6], c[7], c[8]
        sphi, cphi = torch.sin(phi), torch.cos(phi)
        sth, cth = torch.sin(theta), torch.cos(theta)
        spsi, cpsi = torch.sin(psi), torch.cos(psi)
        R = [[cpsi * cth, cpsi * sth * sphi - spsi * cphi, cpsi * sth * cphi + spsi * sphi],
             [spsi * cth, spsi * sth * sphi + cpsi * cphi, spsi * sth * cphi - cpsi * sphi],
             [-sth, cth * sphi, cth * cphi]]
        total = forces.sum(dim=1)
        if use_gnd:
            in_range = (torch.abs(phi) < math.pi / 2) & (torch.abs(theta) < math.pi / 2)
            total = total + torch.where(in_range, self._ground_effect(forces, c[4], p), 0.0)
        acc = [R[k][2] * total / m for k in range(3)]
        acc[2] = acc[2] - g
        acc = [a + dyn_force[:, k] / m for k, a in enumerate(acc)]
        if use_drag:
            d = self._drag(rpm, (c[1], c[3], c[5]))
            acc = [a + (R[k][0] * d[0] + R[k][1] * d[1] + R[k][2] * d[2]) / m
                   for k, a in enumerate(acc)]
        Ixx, Iyy, Izz = p.Ixx, p.Iyy, p.Izz
        l_sq2 = p.arm_length / _sqrt2(phi)
        f0, f1, f2, f3 = forces.unbind(1)
        Mx = l_sq2 * (f0 + f1 - f2 - f3)
        My = l_sq2 * (-f0 + f1 + f2 - f3)
        wp, wq, wr = c[9], c[10], c[11]
        # Euler's equations of a diagonal inertia: J w_dot = M - w x (J w).
        p_dot = (1.0 / Ixx) * (Mx - (wq * (Izz * wr) - wr * (Iyy * wq)))
        q_dot = (1.0 / Iyy) * (My - (wr * (Ixx * wp) - wp * (Izz * wr)))
        r_dot = (1.0 / Izz) * (z_torque - (wp * (Iyy * wq) - wq * (Ixx * wp)))
        return [c[1], acc[0], c[3], acc[1], c[5], acc[2],
                *self._euler_rates(sphi, cphi, torch.tan(theta), cth, wp, wq, wr),
                p_dot, q_dot, r_dot]

    @staticmethod
    def _euler_rates(sphi, cphi, tth, cth, wp, wq, wr):
        """The Euler-angle rates of the body rates (wp, wq, wr)."""
        return [wp + sphi * tth * wq + cphi * tth * wr,
                cphi * wq - sphi * wr,
                sphi / cth * wq + cphi / cth * wr]

    def _sim_pos_rates(self, c):
        """The position coordinates' rates from the (updated) velocities: the
        Euler angles' from the body rates in 3D."""
        if self.QUAD_TYPE == QuadType.ONE_D:
            return [c[1]]
        if self.QUAD_TYPE == QuadType.TWO_D:
            return [c[1], c[3], c[5]]
        ang = self._euler_rates(torch.sin(c[6]), torch.cos(c[6]), torch.tan(c[7]),
                                torch.cos(c[7]), c[9], c[10], c[11])
        return [c[1], c[3], c[5], *ang]

    def _advance_general(self, x, forces, z_torque, rpm, dyn_force, params):
        """PYB_STEPS_PER_CTRL substeps of ``_sim_xdot`` with the motors and the
        disturbance held: explicit Euler under 'dyn', else semi-implicit
        (velocities first, then the positions with the new rates)."""
        dt = self.PYB_TIMESTEP
        vel_idx, pos_idx = _VEL_IDX[self.QUAD_TYPE], _POS_IDX[self.QUAD_TYPE]
        c = list(x.unbind(1))
        for _ in range(self.PYB_STEPS_PER_CTRL):
            xdot = self._sim_xdot(c, forces, z_torque, rpm, dyn_force, params)
            if self.PHYSICS == 'dyn':
                c = [ci + dt * di for ci, di in zip(c, xdot)]
                continue
            mid = list(c)
            for k in vel_idx:
                mid[k] = c[k] + dt * xdot[k]
            rates = self._sim_pos_rates(mid)
            for k, r in zip(pos_idx, rates):
                mid[k] = c[k] + dt * r
            c = mid
        return torch.stack(c, dim=1)

    def _goal_rows(self, step):
        """(B, nx) reference rows: the goal, or the waypoint X_GOAL[step + 1]
        clamped to the trajectory."""
        X_GOAL = self._x_goal
        if self.TASK == Task.STABILIZATION:
            return X_GOAL[0].expand(step.shape[0], -1)
        idx = torch.clamp(step.to(torch.int64) + 1, 0, X_GOAL.shape[0] - 1)
        return X_GOAL[idx]

    def _rl_reward(self, state, noisy_action, step):
        """Negative quadratic on the state error and the action error against
        U_GOAL (no angle wrap), exponentiated unless ``rew_exponential`` is off."""
        err = state - self._goal_rows(step)
        act_err = noisy_action - self._u_goal
        dist = (self._w_state * err * err).sum(dim=1) \
            + (self._w_act * act_err * act_err).sum(dim=1)
        rew = -dist
        if self.rew_exponential:
            rew = torch.exp(rew)
        return rew

    def _quadratic_reward(self, state, clipped_action, step):
        """Minus the quadratic loss 0.5 dx'Q dx + 0.5 du'R du."""
        dx = state - self._goal_rows(step)
        du = clipped_action - self._u_goal
        return -(0.5 * ((dx @ self._Q) * dx).sum(dim=1)
                 + 0.5 * ((du @ self._R) * du).sum(dim=1))

    def _oob(self, state):
        """Position or angle outside the state box, on either side."""
        out = (state < self._state_lo) | (state > self._state_hi)
        return (out & self._oob_mask).any(dim=1)

    def _mse(self, state, step):
        """Weighted squared error against the reference (info['mse']), with
        the angles wrapped when tracking."""
        if self.TASK == Task.TRAJ_TRACKING:
            state = state.clone()
            for k in _ANGLE_DIMS[self.QUAD_TYPE]:
                state[:, k] = normalize_angle(state[:, k])
        err = (state - self._goal_rows(step)) * self._w_mse
        return (err ** 2).sum(dim=1)

    # ------------------------------------------------------------------
    # Drawing
    # ------------------------------------------------------------------
    def render(self, mode='rgb_array'):
        """The 3D quad renders a 3D wireframe frame; the 1D and 2D quads, and
        ``mode='human'``, take the planar view of ``_draw_state``."""
        if self.QUAD_TYPE != QuadType.THREE_D or mode == 'human':
            return super().render(mode)
        fig, ax = self._render_figure(projection='3d')
        s = np.asarray(self.state)
        pos = np.array([s[0], s[2], s[4]])
        angles = torch.as_tensor(s[6:9], dtype=torch.float32)
        R = rot_xyz(*angles.unbind(0)).numpy()
        # The CF2X frame: arms 45 degrees off the body axes, a rotor disk at
        # each tip, drawn in the body plane and rotated into the world frame.
        arm = 0.12
        r_rot = 0.045
        c45 = np.sqrt(0.5)
        tips = arm * np.array([[c45, c45, 0], [-c45, c45, 0],
                               [-c45, -c45, 0], [c45, -c45, 0]])
        th = np.linspace(0, 2 * np.pi, 17)
        circle = np.stack([r_rot * np.cos(th), r_rot * np.sin(th), np.zeros_like(th)], axis=1)
        for tip in tips:
            a = R @ tip
            ax.plot([pos[0], pos[0] + a[0]], [pos[1], pos[1] + a[1]],
                    [pos[2], pos[2] + a[2]], color='k', lw=2)
            ring = (R @ (tip + circle).T).T + pos
            # Front rotors (body +x) red, rear blue: the CF2X's LED cue.
            ax.plot(ring[:, 0], ring[:, 1], ring[:, 2],
                    color=('r' if tip[0] > 0 else 'b'), lw=1.2)
        up = R @ np.array([0, 0, 0.06])
        ax.plot([pos[0], pos[0] + up[0]], [pos[1], pos[1] + up[1]],
                [pos[2], pos[2] + up[2]], color='g', lw=2)
        if self.TASK == Task.TRAJ_TRACKING and np.ndim(self.X_GOAL) == 2:
            ax.plot(self.X_GOAL[:, 0], self.X_GOAL[:, 2], self.X_GOAL[:, 4], 'g--', lw=0.7)
        elif self.TASK == Task.STABILIZATION:
            g = np.atleast_2d(self.X_GOAL)[0]
            ax.scatter([g[0]], [g[2]], [g[4]], color='g', marker='*', s=30)
        ax.set_xlim(-2, 2)
        ax.set_ylim(-2, 2)
        ax.set_zlim(0, 2.5)
        return self._frame(fig)

    def _draw_state(self, ax):
        """The scene in the xz plane for ``render`` and the viewer: the
        ground, the CF2X frame with its rotor disks, the goal or the
        reference."""
        from matplotlib.patches import Circle
        s = np.asarray(self.state)
        if self.QUAD_TYPE == QuadType.ONE_D:
            x, z, th = 0.0, s[0], 0.0
        elif self.QUAD_TYPE == QuadType.TWO_D:
            x, z, th = s[0], s[2], s[4]
        else:
            x, z, th = s[0], s[4], s[7]
        ax.axhspan(-0.2, 0.0, color='0.85', zorder=0)
        ax.plot([-2.2, 2.2], [0, 0], 'k-', lw=1)
        arm = 0.12
        r_rot = 0.045
        dx, dz = arm * np.cos(th), arm * np.sin(th)
        ax.plot([x - dx, x + dx], [z + dz, z - dz], 'k-', lw=3, solid_capstyle='round')
        # Rotor disks at the arm tips (front red, rear blue), above the arm.
        ux, uz = -np.sin(th), np.cos(th)
        for sgn, col in ((1.0, 'r'), (-1.0, 'b')):
            cx, cz = x + sgn * dx, z - sgn * dz
            ax.add_patch(Circle((cx + 0.02 * ux, cz + 0.02 * uz), r_rot,
                                fill=False, color=col, lw=1.2, zorder=3))
        ax.plot([x], [z], 'ko', ms=3)
        xz = {QuadType.ONE_D: None, QuadType.TWO_D: (0, 2),
              QuadType.THREE_D: (0, 4)}[self.QUAD_TYPE]
        if self.TASK == Task.TRAJ_TRACKING and np.ndim(self.X_GOAL) == 2:
            if xz is None:
                ax.plot(np.zeros(self.X_GOAL.shape[0]), self.X_GOAL[:, 0], 'g--', lw=0.7)
            else:
                ax.plot(self.X_GOAL[:, xz[0]], self.X_GOAL[:, xz[1]], 'g--', lw=0.7)
        else:
            g = np.atleast_2d(self.X_GOAL)[0]
            gx, gz = (0.0, g[0]) if xz is None else (g[xz[0]], g[xz[1]])
            ax.plot([gx], [gz], 'g*', ms=10)
        ax.set_xlim(-2.2, 2.2)
        ax.set_ylim(-0.2, 2.2)
