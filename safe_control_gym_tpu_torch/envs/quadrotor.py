"""Quadrotor: the 2D and 3D quadrotor stabilization / tracking tasks, batched, in PyTorch.

Port of ``safe_control_gym_tpu/envs/quadrotor.py`` without the scene
drawing. The commanded thrusts pass through the motor
model (thrust -> PWM -> RPM -> per-motor forces, ``envs/dynamics.py``), so
motor saturation is kept. The physics advance of a batch then goes through
``ops.physics_kernels.quad2d_advance`` (K2) or ``quad3d_advance`` (K3): the
CUDA kernel for a batch on the card, the plain version for a batch on the
CPU. That is the role the JAX package's ``custom_vmap`` rule
(``_install_pallas_advance``) plays for its Pallas kernels.

Parity with the JAX env: the CF2X constants and derived motor constants, the
``inertial_prop`` overrides, the init state and its randomization filtered by
quad type, the spaces, ``X_GOAL`` / ``U_GOAL`` (3D tracking projected onto
the ``proj_point`` / ``proj_normal`` plane), the RL reward on state error and
action error against ``U_GOAL``, the quadratic cost, both on the waypoint
``X_GOAL[step + 1]`` when tracking, the two-sided out-of-bounds check on the
position and angle dims, and the weighted-MSE info.

Only the plain ``'pyb'`` physics of the 2D and 3D quads runs here; the JAX
package runs ``quad_type=1`` and the ``dyn`` / ``pyb_gnd`` / ``pyb_drag`` /
``pyb_dw`` modes on its scan path only, and the port raises
``NotImplementedError`` on them until a later slice.
"""

from __future__ import annotations

import math
from copy import deepcopy
from enum import IntEnum

import numpy as np
import torch

from safe_control_gym_tpu_torch.envs import constraints as constraints_mod
from safe_control_gym_tpu_torch.envs.benchmark_env import (BenchmarkEnv, Cost, Task,
                                                           _compile_rand_sampler)
from safe_control_gym_tpu_torch.envs.dynamics import (QuadParams, cmd2pwm, pwm2rpm,
                                                      quad2d_dynamics, quad3d_dynamics,
                                                      rpm2forces)
from safe_control_gym_tpu_torch.envs.spaces import Box
from safe_control_gym_tpu_torch.envs.symbolic import AnalyticModel
from safe_control_gym_tpu_torch.math.linalg import get_cost_weight_matrix
from safe_control_gym_tpu_torch.math.rotations import (normalize_angle,
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
_NX = {QuadType.TWO_D: 6, QuadType.THREE_D: 12}
_NU = {QuadType.TWO_D: 2, QuadType.THREE_D: 4}
_DYN_DIM = {QuadType.TWO_D: 2, QuadType.THREE_D: 3}
_OOB_MASK = {QuadType.TWO_D: [1, 0, 1, 0, 1, 0],
             QuadType.THREE_D: [1, 0, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0]}
_MSE_WEIGHT = {QuadType.TWO_D: [1, 0, 1, 0, 0, 0],
               QuadType.THREE_D: [1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0]}
_ANGLE_DIMS = {QuadType.TWO_D: [4], QuadType.THREE_D: [6, 7, 8]}


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
        if self.QUAD_TYPE == QuadType.ONE_D or physics != 'pyb':
            raise NotImplementedError(
                f'quad_type={int(self.QUAD_TYPE)} physics={physics!r}: the 1D quad '
                "and the physics modes other than 'pyb' come with the slice of the "
                'port for the 1D quad and the aerodynamic physics modes')
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
        if self.QUAD_TYPE == QuadType.TWO_D:
            for k in ('Ixx', 'Izz'):
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
        self._init_sampler = _compile_rand_sampler(self.INIT_STATE_RAND_INFO, labels)
        self._reward_weights()
        self._build_functional()

    # ------------------------------------------------------------------
    # Spaces
    # ------------------------------------------------------------------
    def _set_action_space(self):
        action_dim = _NU[self.QUAD_TYPE]
        self.ACTION_LABELS = [f'T{i + 1}' for i in range(action_dim)]
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
        if self.QUAD_TYPE == QuadType.TWO_D:
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
            if self.QUAD_TYPE == QuadType.TWO_D:
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
        """``self.symbolic``: the analytic model of the 2D or 3D quad with the
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
        ode = quad2d_dynamics if self.QUAD_TYPE == QuadType.TWO_D else quad3d_dynamics
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

    def _advance(self, x, clipped_action, dyn_force, params):
        """The motor model, then PYB_STEPS_PER_CTRL semi-implicit-Euler
        substeps with the forces and the world disturbance force held (K2 in
        2D on the rotor-pair thrusts, K3 in 3D; their plain twins without
        ``pallas_physics``)."""
        forces, z_torque, _ = self._motor_forces(clipped_action, params)
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
