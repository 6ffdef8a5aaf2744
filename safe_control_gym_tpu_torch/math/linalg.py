"""Linear algebra for control: the Riccati solvers, the matrix exponential,
discretization and the LQR gain.

Port of ``safe_control_gym_tpu/math/linalg.py``:

* ``solve_dare``: the discrete algebraic Riccati equation by the
  structure-preserving doubling algorithm (SDA), 60 iterations;
* ``solve_care``: the continuous one by the matrix sign function with
  determinant scaling, then a least-squares solve for the stable subspace;
* ``expm``: scaling and squaring of an order-8 Taylor series, 8 squarings
  (not ``torch.linalg.matrix_exp``, so that results track the JAX package's);
* ``discretize_linear_system``: Euler or exact zero-order hold;
* ``compute_lqr_gain`` and the host-side ``get_cost_weight_matrix``.

Every solver is float32, takes any number of leading batch dimensions and
runs on its inputs' device with a fixed iteration count. They run under
``full_matmul_precision``: the fixed-point iterations diverge if a product
rounds its operands to TF32. Their solves are ``solve_ex``/``inv_ex``, which
do not wait for the device to report singular systems, as
``torch.linalg.solve`` does on CUDA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ['full_matmul_precision', 'expm', 'solve_dare', 'solve_care',
           'discretize_linear_system', 'get_cost_weight_matrix', 'compute_lqr_gain']


def full_matmul_precision(fn):
    """Run ``fn`` with float32 products in full float32
    (``torch.set_float32_matmul_precision('highest')``), and restore the
    caller's setting after."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        old = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision('highest')
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(old)
    return wrapper


def _f32(*arrays, device=None):
    """Float32 tensors on ``device`` (the first tensor's, else the CPU)."""
    if device is None:
        device = next((a.device for a in arrays if isinstance(a, torch.Tensor)), 'cpu')
    return [a.to(device=device, dtype=torch.float32) if isinstance(a, torch.Tensor)
            else torch.as_tensor(np.asarray(a, np.float32), device=device) for a in arrays]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(A, B):
    return torch.linalg.solve_ex(A, B)[0]


def _t(M):
    return M.transpose(-1, -2)


@full_matmul_precision
def expm(A, order: int = 8, squarings: int = 8):
    """Matrix exponential: an order-``order`` Taylor series of A / 2^squarings,
    squared ``squarings`` times."""
    A, = _f32(A)
    eye = _eye(A.shape[-1], A)
    A_scaled = A / (2.0 ** squarings)
    term = eye
    result = eye
    for k in range(1, order + 1):
        term = term @ A_scaled / k
        result = result + term
    for _ in range(squarings):
        result = result @ result
    return result


@full_matmul_precision
def solve_dare(A, B, Q, R, iters: int = 60):
    """P of ``P = A'PA - A'PB (R + B'PB)^-1 B'PA + Q`` by SDA (``iters``
    doubling steps; quadratic convergence)."""
    A, B, Q, R = _f32(A, B, Q, R)
    eye = _eye(A.shape[-1], A)
    G = B @ _solve(R, _t(B))
    Ak, H = A, Q
    for _ in range(iters):
        W = eye + G @ H
        WinvA = _solve(W, Ak)
        A_next = Ak @ WinvA
        G = G + Ak @ _solve(W, G @ _t(Ak))
        H = H + _t(WinvA) @ (H @ Ak)
        Ak = A_next
    return 0.5 * (H + _t(H))


@full_matmul_precision
def solve_care(A, B, Q, R, iters: int = 40):
    """P of ``A'P + PA - PBR^-1B'P + Q = 0`` by the matrix sign of the
    Hamiltonian (Newton with determinant scaling, ``iters`` steps), then the
    least-squares solve ``[S12; S22 + I] P = -[S11 + I; S21]`` of its stable
    subspace (by QR: CUDA's ``lstsq`` has only the full-rank ``gels``)."""
    A, B, Q, R = _f32(A, B, Q, R)
    n = A.shape[-1]
    G = B @ _solve(R, _t(B))
    batch = torch.broadcast_shapes(A.shape[:-2], G.shape[:-2], Q.shape[:-2])
    A, G, Q = (M.expand(*batch, n, n) for M in (A, G, Q))
    Z = torch.cat([torch.cat([A, -G], dim=-1), torch.cat([-Q, -_t(A)], dim=-1)], dim=-2)
    for _ in range(iters):
        Zinv = torch.linalg.inv_ex(Z)[0]
        c = torch.abs(torch.linalg.det(Z)) ** (-1.0 / (2 * n))
        c = torch.where(torch.isfinite(c) & (c > 0), c, torch.ones_like(c))[..., None, None]
        Z = 0.5 * (c * Z + Zinv / c)
    SpI = Z + _eye(2 * n, A)
    M = torch.cat([SpI[..., :n, n:], SpI[..., n:, n:]], dim=-2)
    rhs = -torch.cat([SpI[..., :n, :n], SpI[..., n:, :n]], dim=-2)
    Qm, Rm = torch.linalg.qr(M)
    P = torch.linalg.solve_triangular(Rm, _t(Qm) @ rhs, upper=True)
    return 0.5 * (P + _t(P))


@full_matmul_precision
def discretize_linear_system(A, B, dt: float, exact: bool = False):
    """Discretize continuous (A, B) over ``dt``: forward Euler
    (``I + dt A``, ``dt B``) or, with ``exact``, the zero-order hold from
    ``expm`` of the block matrix [[A, B], [0, 0]] dt."""
    A, B = _f32(A, B)
    n, m = A.shape[-1], B.shape[-1]
    if exact:
        batch = A.shape[:-2]
        M = torch.cat([torch.cat([A, B], dim=-1),
                       torch.zeros((*batch, m, n + m), dtype=A.dtype, device=A.device)],
                      dim=-2)
        Md = expm(M * dt)
        return Md[..., :n, :n], Md[..., :n, n:]
    return _eye(n, A) + dt * A, dt * B


def get_cost_weight_matrix(weights, dim: int) -> np.ndarray:
    """Diagonal weight matrix from a 1- or ``dim``-long list (identity for
    ``None``)."""
    if weights is None:
        weights = [1.0]
    w = np.atleast_1d(np.asarray(weights, dtype=np.float64)).ravel()
    if len(w) == dim:
        return np.diag(w)
    if len(w) == 1:
        return np.diag(w[0] * np.ones(dim))
    raise ValueError('Wrong dimension for cost weights.')


@full_matmul_precision
def compute_lqr_gain(A, B, Q, R, discrete: bool = True):
    """LQR gain K of u = -K (x - x_goal): ``(R + B'PB)^-1 B'PA`` with P from
    the DARE, or ``R^-1 B'P`` with P from the CARE."""
    A, B, Q, R = _f32(A, B, Q, R)
    if discrete:
        P = solve_dare(A, B, Q, R)
        return _solve(R + _t(B) @ P @ B, _t(B) @ P @ A)
    P = solve_care(A, B, Q, R)
    return _solve(R, _t(B) @ P)
