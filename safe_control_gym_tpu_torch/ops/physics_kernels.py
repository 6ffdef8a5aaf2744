"""K1, K2, K3: one physics control step for a batch, as CUDA kernels and in plain PyTorch.

Port of ``safe_control_gym_tpu/ops/pallas_kernels.py``:

* K1, cartpole: ``cartpole_substeps`` (the math) and ``cartpole_advance_pallas``
  (the TPU kernel), as ``cartpole_advance_kernel`` in
  ``csrc/cartpole_kernels.cu``;
* K2, planar quadrotor: ``quad2d_substeps`` and ``quad2d_advance_pallas``, as
  ``quad2d_advance_kernel`` in ``csrc/quad_kernels.cu``;
* K3, 3D quadrotor: ``quad3d_substeps`` and ``quad3d_advance_pallas``, as
  ``quad3d_advance_kernel`` in ``csrc/quad_kernels.cu``.

Each CUDA kernel runs one thread per env with the state in registers for all
``n_substeps`` semi-implicit-Euler updates and reads the (B, nx) rows in
place (the TPU kernels' (8, B), (16, B) and (24, B) repacking is a TPU
layout, not part of the function).

Bound on the card: per env, K1 moves 44 bytes, K2 64 and K3 128, against
20 substeps of one to three sin/cos pairs and 20-60 other float ops. At the
env step's batch sizes each is bound by its launch and the latency of its
serial chain, not by bytes or FLOP/s.

The wrappers ``cartpole_advance``, ``quad2d_advance`` and ``quad3d_advance``
are the entry points: a CPU batch goes to the ``*_plain`` version, a CUDA
batch to the kernel. ``<wrapper>.launches`` counts kernel launches. The plain
versions repeat the kernels' float operations in the same order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops._launch import block_size, check_tensor

__all__ = ['cartpole_substeps', 'cartpole_advance_plain', 'cartpole_advance',
           'quad2d_substeps', 'quad2d_advance_plain', 'quad2d_advance',
           'quad3d_substeps', 'quad3d_advance_plain', 'quad3d_advance']

_FOUR_THIRDS = 4.0 / 3.0
# sqrt(2) rounded to float32, as jnp.sqrt(2.0) and the kernels' constant.
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def _sqrt2_on(t):
    """_SQRT2_F32 as a 0-d float32 tensor on ``t``'s device. The plain versions
    divide by it as a tensor: PyTorch's CUDA kernel turns a division by a
    Python scalar into a multiplication by its reciprocal, which rounds
    otherwise than the kernels' true division."""
    return torch.tensor(_SQRT2_F32, dtype=torch.float32, device=t.device)


def cartpole_substeps(x, xd, th, thd, force, fx, fz, m, M, L, g,
                      n_substeps: int, dt: float):
    """``n_substeps`` semi-implicit-Euler cartpole updates in manipulator form,
    with a pole-COM tab force (fx, fz). Loop invariants are hoisted, leaving
    one reciprocal per substep; every argument is a tensor or scalar that
    broadcasts against the state columns."""
    Mm = m + M
    ml = m * L
    a11 = Mm
    a22 = _FOUR_THIRDS * m * L * L
    f1 = force + fx
    mgL = m * g * L
    fxL = fx * L
    fzL = fz * L
    a11a22 = a11 * a22
    for _ in range(n_substeps):
        sin_t = torch.sin(th)
        cos_t = torch.cos(th)
        a12 = ml * cos_t
        b1 = f1 + ml * thd * thd * sin_t
        b2 = mgL * sin_t + fxL * cos_t - fzL * sin_t
        inv_det = 1.0 / (a11a22 - a12 * a12)
        x_dd = (a22 * b1 - a12 * b2) * inv_det
        th_dd = (a11 * b2 - a12 * b1) * inv_det
        # Velocities first, then positions from the new velocities.
        xd = xd + dt * x_dd
        thd = thd + dt * th_dd
        x = x + dt * xd
        th = th + dt * thd
    return x, xd, th, thd


def cartpole_advance_plain(states, forces, tab_forces, params,
                           n_substeps: int, dt: float):
    """The plain version of K1. ``states`` (B, 4), ``forces`` (B,),
    ``tab_forces`` (B, 2), ``params`` (4,) [pole_mass, cart_mass,
    pole_length, gravity]; returns the (B, 4) states one control step later."""
    x, xd, th, thd = cartpole_substeps(
        states[:, 0], states[:, 1], states[:, 2], states[:, 3], forces,
        tab_forces[:, 0], tab_forces[:, 1], params[0], params[1], params[2],
        params[3], n_substeps, dt)
    return torch.stack([x, xd, th, thd], dim=1)


def cartpole_advance(states, forces, tab_forces, params, n_substeps: int,
                     dt: float):
    """Advance B cartpoles by one control step (K1).

    Args:
        states: (B, 4) float32 [x, x_dot, theta, theta_dot].
        forces: (B,) float32 applied (clipped) cart forces.
        tab_forces: (B, 2) float32 pole-COM disturbance forces (fx, fz).
        params: (4,) float32 [pole_mass, cart_mass, pole_length, gravity],
            shared by the batch.
        n_substeps, dt: inner physics steps and their timestep.

    Returns:
        (B, 4) float32 states. On the CPU the plain version computes them; on
        a CUDA device the kernel does.
    """
    dev = states.device
    if dev.type == 'cpu':
        return cartpole_advance_plain(states, forces, tab_forces, params,
                                      n_substeps, dt)
    if dev.type != 'cuda':
        raise ValueError(f'cartpole_advance: unsupported device {dev}')
    B = states.shape[0]
    check_tensor(states, 'states', (B, 4), dev)
    check_tensor(forces, 'forces', (B,), dev)
    check_tensor(tab_forces, 'tab_forces', (B, 2), dev)
    check_tensor(params, 'params', (4,), dev)
    out = torch.empty_like(states)
    lib = _cuda_lib('cartpole_kernels', 'scg_cartpole_advance', 5)
    err = lib.scg_cartpole_advance(
        states.data_ptr(), forces.data_ptr(), tab_forces.data_ptr(),
        params.data_ptr(), out.data_ptr(), B, int(n_substeps), float(dt),
        block_size(B, dev), torch.cuda.current_stream(dev).cuda_stream)
    cartpole_advance.launches += 1
    _build.check(lib, err, 'cartpole_advance')
    return out


cartpole_advance.launches = 0


def _cuda_lib(lib_name, entry, n_ptr):
    """The library of ``entry`` with its argtypes set: ``n_ptr`` pointers,
    then B, n_substeps, dt, threads and the stream."""
    lib = _build.load_library(lib_name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * n_ptr + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# K2: planar quadrotor
# ---------------------------------------------------------------------------

def quad2d_substeps(x, xd, z, zd, th, thd, T1, T2, fx, fz, m, Iyy, L, g,
                    n_substeps: int, dt: float):
    """``n_substeps`` semi-implicit-Euler updates of the planar quadrotor
    (plain 'pyb' physics) with the rotor-pair thrusts T1, T2 and the world
    force (fx, fz) held. The torque does not depend on the state, so the
    angular acceleration is constant and every divide is hoisted out of the
    loop. Scalar parameters are 0-d float32 tensors, so the hoisted terms
    round as the kernel's float32 ones do."""
    th_dd = L * (T2 - T1) / Iyy / _sqrt2_on(T1)
    inv_m = 1.0 / m
    tom = (T1 + T2) * inv_m
    fxm = fx * inv_m
    fzm_g = fz * inv_m - g
    for _ in range(n_substeps):
        sin_t = torch.sin(th)
        cos_t = torch.cos(th)
        x_dd = sin_t * tom + fxm
        z_dd = cos_t * tom + fzm_g
        xd = xd + dt * x_dd
        zd = zd + dt * z_dd
        thd = thd + dt * th_dd
        x = x + dt * xd
        z = z + dt * zd
        th = th + dt * thd
    return x, xd, z, zd, th, thd


def quad2d_advance_plain(states, t1, t2, dyn_forces, params, n_substeps: int,
                         dt: float):
    """The plain version of K2. ``states`` (B, 6) [x, x_dot, z, z_dot, theta,
    theta_dot], ``t1``/``t2`` (B,) rotor-pair thrusts, ``dyn_forces`` (B, 2)
    world force (fx, fz), ``params`` (4,) [mass, Iyy, arm_length, gravity];
    returns the (B, 6) states one control step later."""
    out = quad2d_substeps(*states.unbind(1), t1, t2, dyn_forces[:, 0],
                          dyn_forces[:, 1], *params.unbind(0), n_substeps, dt)
    return torch.stack(out, dim=1)


def quad2d_advance(states, t1, t2, dyn_forces, params, n_substeps: int,
                   dt: float):
    """Advance B planar quadrotors by one control step (K2).

    Args:
        states: (B, 6) float32 [x, x_dot, z, z_dot, theta, theta_dot].
        t1, t2: (B,) float32 rotor-pair thrusts, held over the step.
        dyn_forces: (B, 2) float32 world-frame disturbance force (fx, fz).
        params: (4,) float32 [mass, Iyy, arm_length, gravity].
        n_substeps, dt: inner physics steps and their timestep.

    Returns:
        (B, 6) float32 states: the plain version's on the CPU, the kernel's
        on a CUDA device.
    """
    dev = states.device
    if dev.type == 'cpu':
        return quad2d_advance_plain(states, t1, t2, dyn_forces, params,
                                    n_substeps, dt)
    if dev.type != 'cuda':
        raise ValueError(f'quad2d_advance: unsupported device {dev}')
    B = states.shape[0]
    check_tensor(states, 'states', (B, 6), dev)
    check_tensor(t1, 't1', (B,), dev)
    check_tensor(t2, 't2', (B,), dev)
    check_tensor(dyn_forces, 'dyn_forces', (B, 2), dev)
    check_tensor(params, 'params', (4,), dev)
    out = torch.empty_like(states)
    lib = _cuda_lib('quad_kernels', 'scg_quad2d_advance', 6)
    err = lib.scg_quad2d_advance(
        states.data_ptr(), t1.data_ptr(), t2.data_ptr(), dyn_forces.data_ptr(),
        params.data_ptr(), out.data_ptr(), B, int(n_substeps), float(dt),
        block_size(B, dev), torch.cuda.current_stream(dev).cuda_stream)
    quad2d_advance.launches += 1
    _build.check(lib, err, 'quad2d_advance')
    return out


quad2d_advance.launches = 0


# ---------------------------------------------------------------------------
# K3: 3D quadrotor
# ---------------------------------------------------------------------------

def quad3d_substeps(state, forces, zt, dist, m, Ixx, Iyy, Izz, L, g,
                    n_substeps: int, dt: float):
    """``n_substeps`` semi-implicit-Euler updates of the 12-state rigid body
    (plain 'pyb' physics). ``state`` is the 12-tuple [x, x_dot, y, y_dot, z,
    z_dot, phi, theta, psi, p, q, r], ``forces`` the per-motor 4-tuple,
    ``zt`` the yaw torque, ``dist`` the world force 3-tuple (fx, fy, fz).

    Thrust direction is the third column of Rz(psi) Ry(theta) Rx(phi); body
    rates follow the Euler equations of a diagonal inertia; velocities and
    body rates update first, positions with the new velocities, Euler angles
    with W(old angles) times the new rates. Every loop-invariant divide is
    hoisted; a substep keeps the three divides by cos(theta)."""
    x, xd, y, yd, z, zd, phi, th, psi, p, q, r = state
    f0, f1, f2, f3 = forces
    fx, fy, fz = dist
    total = f0 + f1 + f2 + f3
    l_sq2 = L / _sqrt2_on(f0)
    Mx = l_sq2 * (f0 + f1 - f2 - f3)
    My = l_sq2 * (-f0 + f1 + f2 - f3)
    inv_m = 1.0 / m
    tom = total * inv_m
    fxm = fx * inv_m
    fym = fy * inv_m
    fzm_g = fz * inv_m - g
    c_p = (Izz - Iyy) / Ixx
    c_q = (Ixx - Izz) / Iyy
    c_r = (Iyy - Ixx) / Izz
    Mx_I = Mx / Ixx
    My_I = My / Iyy
    zt_I = zt / Izz
    for _ in range(n_substeps):
        sphi, cphi = torch.sin(phi), torch.cos(phi)
        sth, cth = torch.sin(th), torch.cos(th)
        spsi, cpsi = torch.sin(psi), torch.cos(psi)
        x_dd = (cphi * sth * cpsi + sphi * spsi) * tom + fxm
        y_dd = (cphi * sth * spsi - sphi * cpsi) * tom + fym
        z_dd = cphi * cth * tom + fzm_g
        p_d = Mx_I - q * r * c_p
        q_d = My_I - p * r * c_q
        r_d = zt_I - p * q * c_r
        xd = xd + dt * x_dd
        yd = yd + dt * y_dd
        zd = zd + dt * z_dd
        p = p + dt * p_d
        q = q + dt * q_d
        r = r + dt * r_d
        x = x + dt * xd
        y = y + dt * yd
        z = z + dt * zd
        tth = sth / cth
        phi_d = p + sphi * tth * q + cphi * tth * r
        th_d = cphi * q - sphi * r
        psi_d = sphi / cth * q + cphi / cth * r
        phi = phi + dt * phi_d
        th = th + dt * th_d
        psi = psi + dt * psi_d
    return x, xd, y, yd, z, zd, phi, th, psi, p, q, r


def quad3d_advance_plain(states, forces, z_torque, dyn_forces, params,
                         n_substeps: int, dt: float):
    """The plain version of K3. ``states`` (B, 12), ``forces`` (B, 4)
    per-motor forces, ``z_torque`` (B,), ``dyn_forces`` (B, 3) world force,
    ``params`` (6,) [mass, Ixx, Iyy, Izz, arm_length, gravity]; returns the
    (B, 12) states one control step later."""
    out = quad3d_substeps(states.unbind(1), forces.unbind(1), z_torque,
                          dyn_forces.unbind(1), *params.unbind(0), n_substeps, dt)
    return torch.stack(out, dim=1)


def quad3d_advance(states, forces, z_torque, dyn_forces, params,
                   n_substeps: int, dt: float):
    """Advance B 3D quadrotors by one control step (K3).

    Args:
        states: (B, 12) float32 [x, x_dot, y, y_dot, z, z_dot, phi, theta,
            psi, p, q, r].
        forces: (B, 4) float32 per-motor forces, held over the step.
        z_torque: (B,) float32 net yaw torque.
        dyn_forces: (B, 3) float32 world-frame disturbance force.
        params: (6,) float32 [mass, Ixx, Iyy, Izz, arm_length, gravity].
        n_substeps, dt: inner physics steps and their timestep.

    Returns:
        (B, 12) float32 states: the plain version's on the CPU, the kernel's
        on a CUDA device.
    """
    dev = states.device
    if dev.type == 'cpu':
        return quad3d_advance_plain(states, forces, z_torque, dyn_forces, params,
                                    n_substeps, dt)
    if dev.type != 'cuda':
        raise ValueError(f'quad3d_advance: unsupported device {dev}')
    B = states.shape[0]
    check_tensor(states, 'states', (B, 12), dev)
    check_tensor(forces, 'forces', (B, 4), dev)
    check_tensor(z_torque, 'z_torque', (B,), dev)
    check_tensor(dyn_forces, 'dyn_forces', (B, 3), dev)
    check_tensor(params, 'params', (6,), dev)
    out = torch.empty_like(states)
    lib = _cuda_lib('quad_kernels', 'scg_quad3d_advance', 6)
    err = lib.scg_quad3d_advance(
        states.data_ptr(), forces.data_ptr(), z_torque.data_ptr(),
        dyn_forces.data_ptr(), params.data_ptr(), out.data_ptr(), B,
        int(n_substeps), float(dt), block_size(B, dev),
        torch.cuda.current_stream(dev).cuda_stream)
    quad3d_advance.launches += 1
    _build.check(lib, err, 'quad3d_advance')
    return out


quad3d_advance.launches = 0
