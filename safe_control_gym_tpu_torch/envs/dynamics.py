"""Analytic cartpole dynamics, the quadrotor motor model and the integrators, in PyTorch.

Port of ``safe_control_gym_tpu/envs/dynamics.py``: ``CartPoleParams``,
``QuadParams``, ``cartpole_dynamics``, ``cartpole_dynamics_forced``, the
quadrotor ODEs ``quad1d_dynamics``, ``quad2d_dynamics`` and
``quad3d_dynamics`` (the symbolic model's priors), the motor model
``cmd2pwm``, ``pwm2rpm`` and ``rpm2forces``, and the integrators ``rk4_step``,
``euler_step``, ``symplectic_euler_step`` and ``integrate_substeps``.

Every function takes states with any number of leading batch dimensions,
(..., 4) for the cartpole, where the JAX versions act on one state under
``vmap``. A parameter field is a 0-d tensor, shared by the batch, or a (B,)
tensor, one value an env (domain randomization); both broadcast against the
(B, ...) states and inputs. The ODEs do no in-place update and no host read, so
``torch.func.jacfwd`` and ``vmap`` trace them. ``integrate_substeps`` is a
Python loop where JAX has ``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Callable

import torch

from safe_control_gym_tpu_torch.math.rotations import rot_xyz, skew

__all__ = [
    'CartPoleParams', 'QuadParams', 'cartpole_dynamics',
    'cartpole_dynamics_forced', 'quad1d_dynamics', 'quad2d_dynamics',
    'quad3d_dynamics', 'cmd2pwm', 'pwm2rpm', 'rpm2forces',
    'rk4_step', 'euler_step', 'symplectic_euler_step', 'integrate_substeps',
]


def _f32(v):
    return field(default_factory=lambda: torch.tensor(v, dtype=torch.float32))


def _rows(v):
    """A parameter as a column against (B, k) operands: a (B,) field becomes
    (B, 1); a shared 0-d field stays as it is."""
    return v if v.ndim == 0 else v.unsqueeze(-1)


class _Params:
    """``to(device)`` for a dataclass of float32 tensors."""

    def to(self, device):
        return type(self)(**{f.name: getattr(self, f.name).to(device)
                             for f in fields(self)})

    def replace(self, **changes):
        return replace(self, **changes)

    def _stack(self, *names) -> torch.Tensor:
        """The fields ``names`` side by side: (k,) where each is shared, (B, k)
        where any is per env."""
        fields_ = torch.broadcast_tensors(*[getattr(self, n) for n in names])
        return torch.stack(fields_, dim=-1).to(torch.float32)


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
        parameter layout of the physics kernel (ops/physics_kernels.py); (B, 4)
        where the parameters are per env."""
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


def _sqrt2(t):
    """sqrt(2) rounded to float32 as a 0-d tensor on ``t``'s device, divided
    by as a tensor so that the quotient is a true division (as
    ``jnp.sqrt(2.0)``'s), not a multiplication by a rounded reciprocal."""
    return torch.sqrt(torch.tensor(2.0, dtype=torch.float32, device=t.device))


def quad1d_dynamics(x, u, p: QuadParams):
    """1D quadrotor: state [z, z_dot], input [total thrust T];
    z_ddot = T/m - g."""
    return torch.stack([x[..., 1], u[..., 0] / p.mass - p.gravity], dim=-1)


def quad2d_dynamics(x, u, p: QuadParams):
    """Planar quadrotor: state [x, x_dot, z, z_dot, theta, theta_dot], input
    [T1, T2] (the rotor-pair thrusts):
    x_ddot = sin(theta) (T1+T2)/m, z_ddot = cos(theta) (T1+T2)/m - g,
    theta_ddot = L (T2 - T1) / (Iyy sqrt(2))."""
    theta = x[..., 4]
    T1, T2 = u[..., 0], u[..., 1]
    total = (T1 + T2) / p.mass
    x_ddot = torch.sin(theta) * total
    z_ddot = torch.cos(theta) * total - p.gravity
    theta_ddot = p.arm_length * (T2 - T1) / p.Iyy / _sqrt2(x)
    return torch.stack([x[..., 1], x_ddot, x[..., 3], z_ddot, x[..., 5], theta_ddot],
                       dim=-1)


def quad3d_dynamics(x, u, p: QuadParams):
    """3D quadrotor rigid body with the CF2X mixer. State [x, x_dot, y, y_dot,
    z, z_dot, phi, theta, psi, p, q, r] (body rates p, q, r), input the four
    motor thrusts; the rotation R = Rz Ry Rx (SDFormat)."""
    phi, theta, psi = x[..., 6], x[..., 7], x[..., 8]
    omega = x[..., 9:12]
    f = u
    m, g, L = p.mass, p.gravity, p.arm_length
    # (3,) shared or (B, 3) per env; a diagonal inertia acts entrywise.
    inertia = torch.stack([p.Ixx, p.Iyy, p.Izz], dim=-1)
    gamma = p.km / p.kf
    R = rot_xyz(phi, theta, psi)
    total = f[..., 0] + f[..., 1] + f[..., 2] + f[..., 3]
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype, device=x.device)
    # R @ (0, 0, total) is R's third column times the total thrust.
    acc = R[..., :, 2] * total[..., None] / _rows(m) - e3 * _rows(g)
    l_sq2 = L / _sqrt2(x)
    Mb = torch.stack([
        l_sq2 * (f[..., 0] + f[..., 1] - f[..., 2] - f[..., 3]),
        l_sq2 * (-f[..., 0] + f[..., 1] + f[..., 2] - f[..., 3]),
        gamma * (-f[..., 0] + f[..., 1] - f[..., 2] + f[..., 3]),
    ], dim=-1)
    Jw = inertia * omega
    gyro = (skew(omega) @ Jw[..., None])[..., 0]
    rate_dot = (1.0 / inertia) * (Mb - gyro)
    # Euler-angle kinematics: body rates -> Euler rates.
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    tth, cth = torch.tan(theta), torch.cos(theta)
    one, zero_a = torch.ones_like(phi), torch.zeros_like(phi)
    W = torch.stack([torch.stack([one, sphi * tth, cphi * tth], dim=-1),
                     torch.stack([zero_a, cphi, -sphi], dim=-1),
                     torch.stack([zero_a, sphi / cth, cphi / cth], dim=-1)], dim=-2)
    ang_dot = (W @ omega[..., None])[..., 0]
    return torch.cat([
        torch.stack([x[..., 1], acc[..., 0], x[..., 3], acc[..., 1], x[..., 5],
                     acc[..., 2]], dim=-1),
        ang_dot, rate_dot], dim=-1)


def cmd2pwm(thrust, p: QuadParams):
    """Thrust commands (B, n) -> per-motor PWM (B, 4), clipped. ``n`` is 1
    (total thrust, repeated over the four motors), 2 (motor pairs, paired as
    the columns [m0, m1, m1, m0]) or 4 (per motor)."""
    n = thrust.shape[-1]
    n_motor = 4 // n
    thrust = torch.clamp(thrust, min=0.0)
    motor_pwm = (torch.sqrt(thrust / n_motor / _rows(p.kf)) - _rows(p.pwm2rpm_const)) \
        / _rows(p.pwm2rpm_scale)
    if n == 1:
        motor_pwm = motor_pwm.expand(*motor_pwm.shape[:-1], 4)
    elif n == 2:
        motor_pwm = torch.cat([motor_pwm, motor_pwm.flip(-1)], dim=-1)
    return torch.clamp(motor_pwm, _rows(p.pwm_min), _rows(p.pwm_max))


def pwm2rpm(pwm, p: QuadParams):
    """Affine PWM -> RPM map."""
    return _rows(p.pwm2rpm_scale) * pwm + _rows(p.pwm2rpm_const)


def rpm2forces(rpm, p: QuadParams):
    """Per-motor forces (B, 4) and the net yaw torque (B,) from RPMs (B, 4)."""
    forces = rpm ** 2 * _rows(p.kf)
    torques = rpm ** 2 * _rows(p.km)
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
