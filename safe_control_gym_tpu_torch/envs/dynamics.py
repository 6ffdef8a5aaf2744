"""Analytic cartpole dynamics, the quadrotor motor model and the integrators, in PyTorch.

Port of ``safe_control_gym_tpu/envs/dynamics.py`` without the quadrotor ODEs:
``CartPoleParams``, ``QuadParams``, ``cartpole_dynamics``,
``cartpole_dynamics_forced``, the motor model ``cmd2pwm``, ``pwm2rpm`` and
``rpm2forces``, and the integrators ``rk4_step``, ``euler_step``,
``symplectic_euler_step`` and ``integrate_substeps``. The quadrotor ODEs
``quad{1d,2d,3d}_dynamics`` serve only the symbolic model and come with it.

Every function takes states with any number of leading batch dimensions,
(..., 4) for the cartpole, where the JAX versions act on one state under
``vmap``. ``integrate_substeps`` is a Python loop where JAX has ``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Callable

import torch

__all__ = [
    'CartPoleParams', 'QuadParams', 'cartpole_dynamics',
    'cartpole_dynamics_forced', 'cmd2pwm', 'pwm2rpm', 'rpm2forces',
    'rk4_step', 'euler_step', 'symplectic_euler_step', 'integrate_substeps',
]


def _f32(v):
    return field(default_factory=lambda: torch.tensor(v, dtype=torch.float32))


class _Params:
    """``to(device)`` for a dataclass of float32 tensors."""

    def to(self, device):
        return type(self)(**{f.name: getattr(self, f.name).to(device)
                             for f in fields(self)})

    def _stack(self, *names) -> torch.Tensor:
        return torch.stack([getattr(self, n) for n in names]).to(torch.float32)


@dataclass
class CartPoleParams(_Params):
    """Inertial parameters of the cartpole: effective (half) pole length
    0.5 m, pole mass 0.1 kg, cart mass 1.0 kg, g = 9.8 (float32 tensors)."""
    pole_length: torch.Tensor = _f32(0.5)
    pole_mass: torch.Tensor = _f32(0.1)
    cart_mass: torch.Tensor = _f32(1.0)
    gravity: torch.Tensor = _f32(9.8)

    def vector(self) -> torch.Tensor:
        """(4,) float32 [pole_mass, cart_mass, pole_length, gravity]: the
        parameter layout of the physics kernel (ops/physics_kernels.py)."""
        return self._stack('pole_mass', 'cart_mass', 'pole_length', 'gravity')


@dataclass
class QuadParams(_Params):
    """Crazyflie 2.x (CF2X) parameters, float32 tensors: inertia, motor
    constants, the PWM/RPM motor model, and the aerodynamic extras of the
    ground-effect and drag physics modes (unused by the plain 'pyb' mode)."""
    mass: torch.Tensor = _f32(0.027)
    Ixx: torch.Tensor = _f32(1.4e-5)
    Iyy: torch.Tensor = _f32(1.4e-5)
    Izz: torch.Tensor = _f32(2.17e-5)
    arm_length: torch.Tensor = _f32(0.0397)
    kf: torch.Tensor = _f32(3.16e-10)
    km: torch.Tensor = _f32(7.94e-12)
    gravity: torch.Tensor = _f32(9.8)
    pwm2rpm_scale: torch.Tensor = _f32(0.2685)
    pwm2rpm_const: torch.Tensor = _f32(4070.3)
    pwm_min: torch.Tensor = _f32(20000.0)
    pwm_max: torch.Tensor = _f32(65535.0)
    thrust2weight: torch.Tensor = _f32(2.25)
    gnd_eff_coeff: torch.Tensor = _f32(11.36859)
    prop_radius: torch.Tensor = _f32(2.31348e-2)
    drag_coeff_xy: torch.Tensor = _f32(9.1785e-7)
    drag_coeff_z: torch.Tensor = _f32(10.311e-7)

    def vector2d(self) -> torch.Tensor:
        """(4,) float32 [mass, Iyy, arm_length, gravity]: the parameter
        layout of the 2D physics kernel (ops/physics_kernels.py)."""
        return self._stack('mass', 'Iyy', 'arm_length', 'gravity')

    def vector3d(self) -> torch.Tensor:
        """(6,) float32 [mass, Ixx, Iyy, Izz, arm_length, gravity]: the
        parameter layout of the 3D physics kernel."""
        return self._stack('mass', 'Ixx', 'Iyy', 'Izz', 'arm_length', 'gravity')


def cartpole_dynamics(x, u, p: CartPoleParams):
    """Cartpole ODE. State [x, x_dot, theta, theta_dot], input [force]:
    pole-on-cart with a uniform-rod pole (the 4/3 factor)."""
    x_dot, theta, theta_dot = x[..., 1], x[..., 2], x[..., 3]
    force = u[..., 0]
    m, M, L, g = p.pole_mass, p.cart_mass, p.pole_length, p.gravity
    Mm = m + M
    ml = m * L
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    temp = (force + ml * theta_dot ** 2 * sin_t) / Mm
    theta_ddot = (g * sin_t - cos_t * temp) / (L * (4.0 / 3.0 - m * cos_t ** 2 / Mm))
    x_ddot = temp - ml * theta_ddot * cos_t / Mm
    return torch.stack([x_dot, x_ddot, theta_dot, theta_ddot], dim=-1)


def cartpole_dynamics_forced(x, u, tab_force, p: CartPoleParams):
    """Cartpole ODE with an external world-frame force (fx, fz) at the pole
    centre of mass, solved in manipulator form

        [M+m,      m l cos(th)] [x_dd ]   [F + fx + m l th_d^2 sin(th)]
        [m l cos,  4/3 m l^2  ] [th_dd] = [m g l sin + fx l cos - fz l sin]

    which reduces to :func:`cartpole_dynamics` when the tab force is zero.
    """
    x_dot, theta, theta_dot = x[..., 1], x[..., 2], x[..., 3]
    force = u[..., 0]
    fx, fz = tab_force[..., 0], tab_force[..., 1]
    m, M, L, g = p.pole_mass, p.cart_mass, p.pole_length, p.gravity
    ml = m * L
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a11 = M + m
    a12 = ml * cos_t
    a22 = (4.0 / 3.0) * m * L ** 2
    b1 = force + fx + ml * theta_dot ** 2 * sin_t
    b2 = m * g * L * sin_t + fx * L * cos_t - fz * L * sin_t
    det = a11 * a22 - a12 * a12
    x_ddot = (a22 * b1 - a12 * b2) / det
    theta_ddot = (a11 * b2 - a12 * b1) / det
    return torch.stack([x_dot, x_ddot, theta_dot, theta_ddot], dim=-1)


def cmd2pwm(thrust, p: QuadParams):
    """Thrust commands (B, n) -> per-motor PWM (B, 4), clipped. ``n`` is 1
    (total thrust, repeated over the four motors), 2 (motor pairs, paired as
    the columns [m0, m1, m1, m0]) or 4 (per motor)."""
    n = thrust.shape[-1]
    n_motor = 4 // n
    thrust = torch.clamp(thrust, min=0.0)
    motor_pwm = (torch.sqrt(thrust / n_motor / p.kf) - p.pwm2rpm_const) / p.pwm2rpm_scale
    if n == 1:
        motor_pwm = motor_pwm.expand(*motor_pwm.shape[:-1], 4)
    elif n == 2:
        motor_pwm = torch.cat([motor_pwm, motor_pwm.flip(-1)], dim=-1)
    return torch.clamp(motor_pwm, p.pwm_min, p.pwm_max)


def pwm2rpm(pwm, p: QuadParams):
    """Affine PWM -> RPM map."""
    return p.pwm2rpm_scale * pwm + p.pwm2rpm_const


def rpm2forces(rpm, p: QuadParams):
    """Per-motor forces (B, 4) and the net yaw torque (B,) from RPMs (B, 4)."""
    forces = rpm ** 2 * p.kf
    torques = rpm ** 2 * p.km
    z_torque = -torques[..., 0] + torques[..., 1] - torques[..., 2] + torques[..., 3]
    return forces, z_torque


def rk4_step(f: Callable, x, u, dt: float, params):
    """Classic RK4 step with zero-order-hold input."""
    k1 = f(x, u, params)
    k2 = f(x + 0.5 * dt * k1, u, params)
    k3 = f(x + 0.5 * dt * k2, u, params)
    k4 = f(x + dt * k3, u, params)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def euler_step(f: Callable, x, u, dt: float, params):
    """Explicit Euler step."""
    return x + dt * f(x, u, params)


def symplectic_euler_step(f: Callable, x, u, dt: float, params, vel_idx,
                          pos_idx):
    """Semi-implicit Euler (PyBullet's scheme): velocities first, then the
    positions from the new velocities. ``vel_idx``/``pos_idx`` pair each
    position coordinate with its velocity along the last dimension."""
    xdot = f(x, u, params)
    v_new = x[..., vel_idx] + dt * xdot[..., vel_idx]
    x_new = x.clone()
    x_new[..., vel_idx] = v_new
    x_new[..., pos_idx] = x[..., pos_idx] + dt * v_new
    return x_new


def integrate_substeps(step_fn: Callable, x, u, n_substeps: int):
    """Run ``n_substeps`` inner physics steps with the input held."""
    for _ in range(n_substeps):
        x = step_fn(x, u)
    return x
