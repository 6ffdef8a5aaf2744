"""MPSC utilities: the robust positively invariant (RPI) ellipse, the box
tightening and the terminal set's half-spaces.

Port of ``safe_control_gym_tpu/safety_filters/mpsc/mpsc_utils.py``.
``compute_RPI_set`` solves the S-procedure problem

    max log det P  s.t.  [[A'PA - tau P, A'P w_i], [w_i'PA, w_i'P w_i + tau - 1]] <= 0

on the given device: P = L L' (PSD by construction), each semidefinite
constraint a hinge penalty on the largest eigenvalue of its (nx+1)-block
(``torch.linalg.eigvalsh`` over the batch of blocks), Adam on
``-logdet P + penalty * hinge`` for ``iters`` steps, then a search over a
scalar shrink factor that certifies every sampled constraint. A diagonal
rescaling of the state preconditions both the descent and the Lyapunov
fallback (``_lyapunov_rpi``), which is kept when it is the tighter
certified set. The rest is numpy on the host, as in the JAX package: the
bounding box of the ellipse, the exact box Pontryagin difference, scipy's
qhull for a vertex set's half-spaces and the reference window.
"""

from __future__ import annotations

import time
from enum import Enum
from functools import partial
from itertools import product

import numpy as np
import torch

from safe_control_gym_tpu_torch.envs.benchmark_env import Task
from safe_control_gym_tpu_torch.envs.constraints import BoundedConstraint
from safe_control_gym_tpu_torch.math.linalg import full_matmul_precision
from safe_control_gym_tpu_torch.math.optim import adam_init, adam_update
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['Cost_Function', 'compute_RPI_set', 'ellipse_bounding_box',
           'pontryagin_difference_AABB', 'get_trajectory_on_horizon',
           'vertices_to_halfspaces']


class Cost_Function(str, Enum):
    """MPSC cost functions."""
    ONE_STEP_COST = 'one_step_cost'


def _max_lmi_eigs(P, Acl, W, tau):
    """The largest eigenvalue of the (nx+1)-block of each residual row of W
    (n, nx), (n,). The blocks are symmetrized before ``eigvalsh``."""
    n, nx = W.shape
    APA = Acl.T @ P @ Acl
    APw = W @ (Acl.T @ P).T                        # rows (A'P w_i)'
    wPw = ((W @ P) * W).sum(-1)
    top = torch.cat([(APA - tau * P).expand(n, nx, nx), APw[:, :, None]], dim=2)
    bot = torch.cat([APw[:, None, :], (wPw + tau - 1.0)[:, None, None]], dim=2)
    blocks = torch.cat([top, bot], dim=1)
    return torch.linalg.eigvalsh(0.5 * (blocks + blocks.transpose(1, 2)))[:, -1]


def _preconditioner(Acl64, W64):
    """The diagonal state scaling D: 1 / the half-widths of a certified
    over-approximation of the minimal RPI box, sum_k |A^k| r."""
    nx = Acl64.shape[0]
    r = np.abs(W64).max(axis=0)
    hw = np.zeros(nx)
    Ak = np.eye(nx)
    for _ in range(5000):
        hw += np.abs(Ak) @ r
        Ak = Ak @ Acl64
        if np.abs(Ak).max() < 1e-12:
            break
    hw = np.maximum(hw, max(float(hw.max()), 1e-12) * 1e-6)
    return 1.0 / hw


@full_matmul_precision
def _descend(L0, Acl, W, tau, iters, lr, penalty):
    """``iters`` Adam steps on L of ``-logdet(L L' + 1e-8 I) + penalty *
    (sum hinge^2 + sum hinge)`` (optax's Adam, ``math/optim.py``)."""
    nx = L0.shape[0]
    eye = torch.eye(nx, device=L0.device)

    def loss_fn(L_flat):
        L = torch.tril(L_flat)
        P = L @ L.T + 1e-8 * eye
        viol = torch.clamp(_max_lmi_eigs(P, Acl, W, tau), min=0.0)
        return (-torch.linalg.slogdet(P)[1] + penalty * torch.sum(viol ** 2)
                + penalty * torch.sum(viol))

    L = L0.clone()
    state = adam_init([L])
    for _ in range(iters):
        with torch.enable_grad():
            leaf = L.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(leaf), leaf)
        updates, state = adam_update([g], state, lr)
        L = L + updates[0]
    return torch.tril(L)


def compute_RPI_set(Acl, w, tau, iters: int = 3000, lr: float = 5e-2,
                    penalty: float = 100.0, seed: int = 0, device='cuda',
                    timings: dict = None):
    """Robust positively invariant ellipse P: x'Px <= 1 is invariant under
    x+ = Acl x + w_i for every sampled residual.

    Args:
        Acl: closed-loop A + BK (nx, nx).
        w: residual samples (nx, n_samples).
        tau: S-procedure coefficient (about 0.95).
        device: where the descent and its eigenvalues run.
        timings: if a dict, it receives the seconds of the descent
            (``descent_s``) and of the certification search (``bisection_s``).

    Returns:
        P (ndarray, float64), certified where the descent or the Lyapunov
        fallback could be.
    """
    dev = resolve_device(device)
    Acl64 = np.asarray(Acl, np.float64)
    W64 = np.asarray(w, np.float64).T               # (n_samples, nx)
    nx = Acl64.shape[0]
    D = _preconditioner(Acl64, W64)
    Acl_s = (D[:, None] * Acl64) / D[None, :]       # D A D^-1
    W_s = W64 * D[None, :]                          # rows (Dw)'
    Acl_t = torch.tensor(Acl_s, dtype=torch.float32, device=dev)
    W_t = torch.tensor(W_s, dtype=torch.float32, device=dev)
    tau = float(tau)

    # From the certified Lyapunov ellipse when there is one (a feasible
    # start), else a mid-scale identity from the residuals' size.
    P_lyap = _lyapunov_rpi(Acl_s, W_s, tau)
    if P_lyap is not None:
        L0 = torch.tensor(np.linalg.cholesky(P_lyap), dtype=torch.float32, device=dev)
    else:
        w_scale = float(W_t.abs().max()) + 1e-6
        L0 = torch.eye(nx, device=dev) * (0.3 / w_scale)
    t0 = time.perf_counter()
    L = _descend(L0, Acl_t, W_t, tau, iters, lr, penalty)
    P = (L @ L.T).cpu().numpy()
    t1 = time.perf_counter()

    @full_matmul_precision
    def max_eig(Pm):
        Pm = torch.tensor(np.asarray(Pm), dtype=torch.float32, device=dev)
        return float(_max_lmi_eigs(Pm, Acl_t, W_t, tau).max())

    # Certify: the largest scale s in geomspace(1, 1e-3) with s P feasible.
    P_desc = None
    if max_eig(P) <= 1e-6:
        P_desc = P
    else:
        for s in np.geomspace(1.0, 1e-3, 25):
            if max_eig(P * s) <= 1e-6:
                P_desc = P * s
                break
    if timings is not None:
        timings['descent_s'] = t1 - t0
        timings['bisection_s'] = time.perf_counter() - t1

    def unscale(P_s):
        # P = D P~ D maps the scaled certificate back (congruence).
        return (D[:, None] * np.asarray(P_s, np.float64)) * D[None, :]

    # The tighter (larger log det) of the certified candidates.
    candidates = [c for c in (P_desc, P_lyap) if c is not None]
    if candidates:
        return unscale(max(candidates, key=lambda c: np.linalg.slogdet(c)[1]))
    print('[WARNING] compute_RPI_set: could not certify the RPI set; '
          'returning best-effort P.')
    return unscale(P)


def _lyapunov_rpi(Acl, W, tau):
    """A certified (conservative) RPI ellipse from a discrete Lyapunov
    equation: for tau_c in (rho(Acl)^2, 1), ``Acl' P Acl - tau_c P = -I``
    makes the top-left block ``-s I`` under ``s P``, and the largest
    certified scale is ``(1 - tau_c) / max_i (w'Pw + |Acl'Pw|^2)``. The
    tightest over a grid of tau_c (with ``tau`` where valid).

    Args:
        Acl: (nx, nx) closed-loop map (float64).
        W: (n_samples, nx) residual samples.
        tau: the configured S-procedure coefficient.

    Returns:
        P (ndarray), or None if Acl is not strictly stable.
    """
    rho = float(np.max(np.abs(np.linalg.eigvals(Acl))))
    if rho >= 0.9995:
        return None
    nx = Acl.shape[0]

    def solve(tau_c):
        M = Acl / np.sqrt(tau_c)
        # P = sum_k (M')^k (I / tau_c) M^k by doubling.
        P = np.eye(nx) / tau_c
        Mk = M.copy()
        for _ in range(64):
            P = P + Mk.T @ P @ Mk
            Mk = Mk @ Mk
            if np.abs(Mk).max() < 1e-14:
                break
        PW = W @ P                                       # rows w'P
        quad = np.sum(PW * W, axis=1)                    # w'Pw
        cross = np.sum((PW @ Acl) ** 2, axis=1)          # |Acl'Pw|^2
        denom = float(np.max(quad + cross))
        return P if denom <= 0 else P * ((1.0 - tau_c) / denom)

    lo = rho ** 2 + 1e-4
    grid = list(np.linspace(lo, 0.9995, 12))
    if tau > rho ** 2:
        grid.append(tau)
    best, best_logdet = None, -np.inf
    for tau_c in grid:
        P = solve(min(float(tau_c), 0.9995))
        logdet = np.linalg.slogdet(P)[1]
        if np.isfinite(logdet) and logdet > best_logdet:
            best, best_logdet = P, logdet
    return best


def ellipse_bounding_box(P):
    """The vertices of the axis-aligned box around x'Px <= 1."""
    P = np.asarray(P)
    c = np.eye(P.shape[0])
    Pinv = np.linalg.inv(P)
    extremes = []
    for i in range(P.shape[0]):
        e = np.sqrt(c[:, i, None].T @ Pinv @ c[:, i, None])[0, 0]
        extremes.append((e, -e))
    return np.vstack(list(product(*extremes)))


def pontryagin_difference_AABB(verts1, verts2):
    """The exact Pontryagin difference of two boxes given by their vertices:
    [l1 - l2, u1 - u2] (the zero set if empty). Returns its vertices and a
    ``BoundedConstraint`` factory."""
    verts1 = np.asarray(verts1, dtype=float)
    verts2 = np.asarray(verts2, dtype=float)
    if verts1.ndim == 1:
        verts1 = verts1[:, None]
    if verts2.ndim == 1:
        verts2 = verts2[:, None]
    l1, u1 = verts1.min(axis=0), verts1.max(axis=0)
    l2, u2 = verts2.min(axis=0), verts2.max(axis=0)
    lower = l1 - l2
    upper = u1 - u2
    if np.any(upper < lower):
        print('Warning: Tightened set is the Zero set.')
        lower = np.zeros_like(lower)
        upper = np.zeros_like(upper)
    const_func = partial(BoundedConstraint, lower_bounds=lower, upper_bounds=upper)
    if verts1.shape[1] > 1:
        return np.vstack(list(product(*zip(upper, lower)))), const_func
    return np.vstack((lower, upper)), const_func


def vertices_to_halfspaces(vertices):
    """A vertex set's convex hull as half-spaces A x <= b (scipy's qhull)."""
    from scipy.spatial import ConvexHull
    hull = ConvexHull(np.asarray(vertices), qhull_options='QJ')
    # hull.equations: [A | b0] with A x + b0 <= 0.
    return hull.equations[:, :-1], -hull.equations[:, -1]


def get_trajectory_on_horizon(env, iteration, horizon):
    """The reference over the next ``horizon`` steps, padded with its last
    state."""
    if env.TASK == Task.TRAJ_TRACKING:
        iteration = int(iteration)
        wp_idx = [min(iteration + i, env.X_GOAL.shape[0] - 1) for i in range(horizon)]
        return env.X_GOAL[wp_idx]
    return env.X_GOAL
