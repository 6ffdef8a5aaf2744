"""Rotation and trajectory-projection helpers in PyTorch.

Port of ``safe_control_gym_tpu/math/rotations.py``. The JAX functions act on
one angle or vector and are batched with ``vmap``; these take any number of
leading batch dimensions: ``rot_x(phi)`` with ``phi`` of shape (...) returns
(..., 3, 3), ``euler_to_quat`` maps (..., 3) to (..., 4), and so on.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    'normalize_angle', 'rot_x', 'rot_y', 'rot_z', 'rot_xyz',
    'euler_to_quat', 'quat_to_rot', 'euler_to_rot', 'quat_to_euler',
    'projection_matrix', 'transform_trajectory', 'skew',
]


def normalize_angle(x):
    """Wrap angle to [-pi, pi) with floor-mod semantics, as Python's ``%``
    (``torch.remainder``; ``torch.fmod`` differs for negative angles)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def _mat3(rows):
    """(..., 3, 3) from nine (...)-shaped entries given row by row."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(phi):
    phi = torch.as_tensor(phi)
    c, s = torch.cos(phi), torch.sin(phi)
    one, zero = torch.ones_like(phi), torch.zeros_like(phi)
    return _mat3([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def rot_y(theta):
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    return _mat3([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def rot_z(psi):
    psi = torch.as_tensor(psi)
    c, s = torch.cos(psi), torch.sin(psi)
    one, zero = torch.ones_like(psi), torch.zeros_like(psi)
    return _mat3([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def rot_xyz(phi, theta, psi):
    """Body-to-world rotation R = Rz(psi) @ Ry(theta) @ Rx(phi) (SDFormat)."""
    return rot_z(psi) @ rot_y(theta) @ rot_x(phi)


euler_to_rot = rot_xyz


def skew(v):
    """Skew-symmetric cross-product matrix of (..., 3) vectors."""
    zero = torch.zeros_like(v[..., 0])
    return _mat3([[zero, -v[..., 2], v[..., 1]],
                  [v[..., 2], zero, -v[..., 0]],
                  [-v[..., 1], v[..., 0], zero]])


def euler_to_quat(rpy):
    """XYZ Euler angles (..., 3) to quaternions (x, y, z, w), PyBullet order."""
    half = 0.5 * rpy
    cr, cp, cy = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    sr, sp, sy = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    qw = cr * cp * cy + sr * sp * sy
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quat_to_rot(q):
    """Quaternions (x, y, z, w) of shape (..., 4) to (..., 3, 3) rotations."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _mat3([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def quat_to_euler(q):
    """Quaternions (x, y, z, w) to XYZ Euler angles (roll, pitch, yaw)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def projection_matrix(normal):
    """(3, 2) orthonormal basis of the plane with the given normal: the
    normalized projection of e_x (or e_y when the normal is near e_x) onto
    the plane, then normal x that."""
    n = torch.as_tensor(normal)
    if not n.is_floating_point():
        n = n.to(torch.float32)
    n = n / torch.linalg.vector_norm(n)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    seed = torch.where(torch.abs(n @ ex) > 0.9, ey, ex)
    b1 = seed - (seed @ n) * n
    b1 = b1 / torch.linalg.vector_norm(b1)
    b2 = torch.linalg.cross(n, b1)
    return torch.stack([b1, b2], dim=1)


def transform_trajectory(pos, vel, trans_info):
    """Map planar trajectories (columns 0 and 1 of the (T, 3) ``pos``/``vel``)
    onto the plane through ``trans_info['point']`` with normal
    ``trans_info['normal']``."""
    pos, vel = torch.as_tensor(pos), torch.as_tensor(vel)
    point = torch.as_tensor(trans_info['point'], dtype=pos.dtype)
    PM = projection_matrix(torch.as_tensor(trans_info['normal'], dtype=pos.dtype))
    return pos[:, :2] @ PM.T + point, vel[:, :2] @ PM.T
