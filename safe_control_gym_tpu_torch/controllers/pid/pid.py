"""Cascaded PID of the Crazyflie quadrotor.

Port of ``safe_control_gym_tpu/controllers/pid/pid.py`` (the DSL firmware's
PID): a position PID gives the thrust and the target attitude, an attitude
PID on the rotation-matrix error gives per-motor PWMs through the CF2X mixer,
then RPMs and thrusts; the 2D quad sums the motor pairs. Its math runs on
the host in numpy, as the JAX package's does; the quad env it drives steps
on its own device (K2 or K3 on the card). The attitude's rotation matrix is
taken in float32, as the JAX package's rotation helpers give it.

    ctrl = make('pid', partial(make, 'quadrotor', device='cuda', **task_config))
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.base_controller import BaseController
from safe_control_gym_tpu_torch.envs.benchmark_env import Task
from safe_control_gym_tpu_torch.math.rotations import euler_to_quat, quat_to_rot

__all__ = ['PID']


class PID(BaseController):
    """Crazyflie cascaded position and attitude PID."""

    def __init__(self, env_func=None, g: float = 9.8, kf: float = 3.16e-10,
                 km: float = 7.94e-12,
                 p_coeff_for=(0.4, 0.4, 1.25),
                 i_coeff_for=(0.05, 0.05, 0.05),
                 d_coeff_for=(0.2, 0.2, 0.5),
                 p_coeff_tor=(70000.0, 70000.0, 60000.0),
                 i_coeff_tor=(0.0, 0.0, 500.0),
                 d_coeff_tor=(20000.0, 20000.0, 12000.0),
                 pwm2rpm_scale: float = 0.2685,
                 pwm2rpm_const: float = 4070.3,
                 min_pwm: float = 20000,
                 max_pwm: float = 65535,
                 **kwargs):
        super().__init__(env_func, **kwargs)
        self.env = env_func()
        if self.env.NAME != 'quadrotor':
            raise NotImplementedError(
                '[ERROR] PID not implemented for any system other than Quadrotor (2D and 3D).')
        self.env.reset()
        self.g = g
        self.KF = kf
        self.KM = km
        self.P_COEFF_FOR = np.array(p_coeff_for)
        self.I_COEFF_FOR = np.array(i_coeff_for)
        self.D_COEFF_FOR = np.array(d_coeff_for)
        self.P_COEFF_TOR = np.array(p_coeff_tor)
        self.I_COEFF_TOR = np.array(i_coeff_tor)
        self.D_COEFF_TOR = np.array(d_coeff_tor)
        self.PWM2RPM_SCALE = np.array(pwm2rpm_scale)
        self.PWM2RPM_CONST = np.array(pwm2rpm_const)
        self.MIN_PWM = np.array(min_pwm)
        self.MAX_PWM = np.array(max_pwm)
        self.MIXER_MATRIX = np.array([[0.5, -0.5, -1], [0.5, 0.5, 1],
                                      [-0.5, 0.5, -1], [-0.5, -0.5, 1]])
        self.control_timestep = self.env.CTRL_TIMESTEP
        self.reference = self.env.X_GOAL
        self.reset()

    def select_action(self, obs, info=None):
        """The motor thrusts (rotor-pair thrusts in 2D) from the cascaded PID."""
        step = self.extract_step(info)
        if self.env.QUAD_TYPE == 2:
            cur_pos = np.array([obs[0], 0, obs[2]])
            cur_rpy = np.array([0.0, obs[4], 0.0])
            cur_vel = np.array([obs[1], 0, obs[3]])
            pos_idx = (0, None, 2)
        elif self.env.QUAD_TYPE == 3:
            cur_pos = np.array([obs[0], obs[2], obs[4]])
            cur_rpy = np.array([obs[6], obs[7], obs[8]])
            cur_vel = np.array([obs[1], obs[3], obs[5]])
            pos_idx = (0, 2, 4)
        else:
            raise NotImplementedError('[ERROR] PID supports 2D/3D quadrotors.')
        rpy32 = torch.as_tensor(np.asarray(cur_rpy, np.float32))
        cur_rotation = quat_to_rot(euler_to_quat(rpy32)).numpy()

        ref = np.asarray(self.reference)
        pick = lambda row, off: np.array([0 if i is None else row[i + off] for i in pos_idx])
        if self.env.TASK == Task.TRAJ_TRACKING:
            row = ref[min(step, ref.shape[0] - 1)]
            target_pos, target_vel = pick(row, 0), pick(row, 1)
        else:
            target_pos, target_vel = pick(ref, 0), np.zeros(3)

        thrust, target_rotation = self._dsl_pid_position_control(
            cur_pos, cur_rotation, cur_vel, target_pos, np.zeros(3), target_vel)
        rpm = self._dsl_pid_attitude_control(
            thrust, cur_rotation, cur_rpy, target_rotation, np.zeros(3))
        action = self.KF * rpm ** 2
        if self.env.QUAD_TYPE == 2:
            action = np.array([action[0] + action[3], action[1] + action[2]])
        return action

    def _dsl_pid_position_control(self, cur_pos, cur_rotation, cur_vel,
                                  target_pos, target_rpy, target_vel):
        """Position PID: the thrust's PWM and the target rotation."""
        pos_e = target_pos - cur_pos
        vel_e = target_vel - cur_vel
        self.integral_pos_e = self.integral_pos_e + pos_e * self.control_timestep
        self.integral_pos_e = np.clip(self.integral_pos_e, -2.0, 2.0)
        self.integral_pos_e[2] = np.clip(self.integral_pos_e[2], -0.15, 0.15)
        target_thrust = (self.P_COEFF_FOR * pos_e
                         + self.I_COEFF_FOR * self.integral_pos_e
                         + self.D_COEFF_FOR * vel_e
                         + np.array([0, 0, self.GRAVITY]))
        scalar_thrust = max(0.0, float(target_thrust @ cur_rotation[:, 2]))
        thrust = ((math.sqrt(scalar_thrust / (4 * self.KF))
                   - self.PWM2RPM_CONST) / self.PWM2RPM_SCALE)
        target_z_ax = target_thrust / np.linalg.norm(target_thrust)
        target_x_c = np.array([math.cos(target_rpy[2]), math.sin(target_rpy[2]), 0])
        yx = np.cross(target_z_ax, target_x_c)
        target_y_ax = yx / np.linalg.norm(yx)
        target_x_ax = np.cross(target_y_ax, target_z_ax)
        target_rotation = np.vstack([target_x_ax, target_y_ax, target_z_ax]).T
        return thrust, target_rotation

    def _dsl_pid_attitude_control(self, thrust, cur_rotation, cur_rpy,
                                  target_rotation, target_rpy_rates):
        """Attitude PID: the motors' RPMs."""
        rot_matrix_e = (target_rotation.T @ cur_rotation
                        - cur_rotation.T @ target_rotation)
        rot_e = np.array([rot_matrix_e[2, 1], rot_matrix_e[0, 2], rot_matrix_e[1, 0]])
        rpy_rates_e = (target_rpy_rates
                       - (cur_rpy - self.last_rpy) / self.control_timestep)
        self.last_rpy = cur_rpy
        self.integral_rpy_e = self.integral_rpy_e - rot_e * self.control_timestep
        self.integral_rpy_e = np.clip(self.integral_rpy_e, -1500.0, 1500.0)
        self.integral_rpy_e[0:2] = np.clip(self.integral_rpy_e[0:2], -1.0, 1.0)
        target_torques = (-self.P_COEFF_TOR * rot_e
                          + self.D_COEFF_TOR * rpy_rates_e
                          + self.I_COEFF_TOR * self.integral_rpy_e)
        target_torques = np.clip(target_torques, -3200, 3200)
        pwm = thrust + self.MIXER_MATRIX @ target_torques
        pwm = np.clip(pwm, self.MIN_PWM, self.MAX_PWM)
        return self.PWM2RPM_SCALE * pwm + self.PWM2RPM_CONST

    def reset(self):
        """Rebuild the prior model, reset the env and the integral states."""
        self.model = self.get_prior(self.env, self.prior_info)
        self.GRAVITY = self.g * self.model.quad_mass
        self.env.reset()
        self.reset_before_run()

    def reset_before_run(self, obs=None, info=None, env=None):
        self.integral_pos_e = np.zeros(3)
        self.last_rpy = np.zeros(3)
        self.integral_rpy_e = np.zeros(3)
        self.setup_results_dict()

    def save(self, path):
        """Save the integral states."""
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        np.save(path, (self.integral_pos_e, self.last_rpy, self.integral_rpy_e))

    def load(self, path):
        self.integral_pos_e, self.last_rpy, self.integral_rpy_e = np.load(path)
