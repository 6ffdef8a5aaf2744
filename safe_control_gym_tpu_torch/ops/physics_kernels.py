"""K1: one cartpole control step for a batch, as a CUDA kernel and in plain PyTorch.

Port of the cartpole part of ``safe_control_gym_tpu/ops/pallas_kernels.py``:
``cartpole_substeps`` (the math) and ``cartpole_advance_pallas`` (the TPU
kernel). The CUDA kernel is ``cartpole_advance_kernel`` in
``csrc/cartpole_kernels.cu``: one thread per env, the state in registers for
all ``n_substeps`` semi-implicit-Euler updates, the (B, 4) and (B, 2) rows
read in place (the TPU kernel's (8, B) repacking is a TPU layout, not part of
the function).

Bound on the card: 44 bytes moved per env against 20 substeps of sin, cos,
one reciprocal and ~25 other float ops, so at the env step's batch sizes it
is bound by its launch and the memory system's latency, not by FLOP/s.

``cartpole_advance`` is the entry point: a CPU batch goes to
``cartpole_advance_plain``, a CUDA batch to the kernel. ``cartpole_advance.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops._launch import block_size, check_tensor

__all__ = ['cartpole_substeps', 'cartpole_advance_plain', 'cartpole_advance']

_FOUR_THIRDS = 4.0 / 3.0


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
    lib = _lib()
    err = lib.scg_cartpole_advance(
        states.data_ptr(), forces.data_ptr(), tab_forces.data_ptr(),
        params.data_ptr(), out.data_ptr(), B, int(n_substeps), float(dt),
        block_size(B, dev), torch.cuda.current_stream(dev).cuda_stream)
    cartpole_advance.launches += 1
    _build.check(lib, err, 'cartpole_advance')
    return out


cartpole_advance.launches = 0


def _lib():
    lib = _build.load_library('cartpole_kernels')
    if lib.scg_cartpole_advance.argtypes is None:
        p = ctypes.c_void_p
        lib.scg_cartpole_advance.argtypes = [p, p, p, p, p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_float,
                                             ctypes.c_int, p]
        lib.scg_cartpole_advance.restype = ctypes.c_int
    return lib
