"""Batched dense QP by staged ADMM (OSQP's algorithm), in PyTorch.

Port of ``safe_control_gym_tpu/ops/qp.py`` (``QPSolution``, ``admm_qp``,
``_polish_kkt``, ``_admm_qp_body``, ``make_qp_solver``). It solves B
problems at once,

    min 0.5 z'Pz + q'z   s.t.  l <= Az <= u,

every argument with a leading batch axis (B=1 is the single solve), with
the JAX solver's math:

* 3 rounds of Ruiz equilibration of rows and columns;
* rho per row, 1e3 x rho on equality rows (u - l < 1e-9);
* 10 stages, each with the Cholesky inverse of ``P + sigma I + A' diag(rho)
  A``, one Newton-Schulz step on it, ``stage_iters`` relaxed ADMM
  iterations (alpha) and the rho update (x [0.2, 5], then into [1e-4, 1e4]);
  with ``capture`` on a CUDA device, a stage's iterations replay as one
  captured CUDA graph (about 17 launches an iteration otherwise, each a few
  microseconds of device time but more of the host's);
* ``tol=None``: uniform stages (JAX's ``lax.scan``); ``tol`` set: stages of
  geometrically growing size with the early exit (JAX's ``while_loop``);
* ``polish``: the active-set KKT solve at three margins, one batched LU with
  one refinement pass, each candidate kept only if it improves both
  residuals.

The JAX package solves a batch with ``jax.vmap`` over its ``while_loop``.
Here the batch is native and reproduces that: a problem whose residuals
fell below ``tol`` stops changing (a (B,) mask and ``torch.where``), and the
stages go on while any problem is unconverged. That reads one boolean from
the device per stage, at most 9 a solve; the iterations inside a stage read
nothing back, so a stage can be captured whole.

The JAX solver is XLA code, not a Pallas kernel, so this port is library
calls (``cholesky_ex``, ``cholesky_solve``, ``lu_factor_ex``, ``lu_solve``,
batched products), all at full float32 (``full_matmul_precision``): with
TF32 products ADMM stalls, as bfloat16 stalled it on the TPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from safe_control_gym_tpu_torch.math.linalg import full_matmul_precision

__all__ = ['QPSolution', 'admm_qp', 'make_qp_solver', 'stage_sizes', 'N_STAGES']

N_STAGES = 10


class QPSolution(NamedTuple):
    x: torch.Tensor           # (B, n) primal solution
    z: torch.Tensor           # (B, m) slack (Ax projected), equilibrated scaling
    y: torch.Tensor           # (B, m) dual
    prim_res: torch.Tensor    # (B,) violation of [l, u], equilibrated scaling
    dual_res: torch.Tensor    # (B,) ||Px + q + A'y||_inf, equilibrated scaling
    iterations: torch.Tensor  # (B,) int32 ADMM iterations each problem ran


def stage_sizes(iters: int, tol) -> list:
    """ADMM iterations of each of the 10 stages: ``iters // 10`` each without
    ``tol``; with it, halves of the remaining budget, ascending (sum
    ``iters``)."""
    if tol is None:
        return [max(iters // N_STAGES, 1)] * N_STAGES
    desc, rem = [], iters
    for _ in range(N_STAGES - 1):
        half = max(rem // 2, 4)
        desc.append(half)
        rem = max(rem - half, 1)
    desc.append(max(rem, 1))
    return desc[::-1]


def _mv(M, v):
    """M v for (B, r, c) M and (B, c) v."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _vm(v, M):
    """M' v for (B, r) v and (B, r, c) M, without transposing M."""
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def _batched(t, B, dims):
    """``t`` as float32 with the batch axis (expanded if it has none)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return t.expand(B, *t.shape) if t.dim() == dims else t


def _inf_norm(v):
    return v.abs().amax(dim=-1)


def _violation(Ax, l, u):
    return _inf_norm(Ax - torch.clamp(Ax, l, u))


@full_matmul_precision
def admm_qp(P, q, A, l, u, x0=None, y0=None, rho: float = 0.1,
            sigma: float = 1e-6, alpha: float = 1.6, iters: int = 200,
            tol: Optional[float] = None, polish: bool = False,
            capture: bool = False) -> QPSolution:
    """Solve B QPs by staged ADMM; returns a :class:`QPSolution`.

    Args:
        P: (B, n, n) symmetric PSD cost Hessians (or (n, n), shared).
        q: (B, n) linear costs. A: (B, m, n) constraint matrices.
        l, u: (B, m) bounds (infinite where a side is open; l == u for an
            equality row). q, A, l, u may also drop the batch axis.
        x0, y0: (B, n) and (B, m) warm starts (zeros if None).
        rho, sigma, alpha: ADMM step, regularization and relaxation.
        iters: the iteration budget of the 10 stages.
        tol: early exit once the (equilibrated) primal residual < tol and
            the dual one < 10 tol, per problem; None runs every stage.
        polish: the active-set polish after ADMM.
        capture: on a CUDA device, run each stage's iterations as one CUDA
            graph replay (the same kernels; cuBLAS may round a product
            differently under capture, so an answer near a polish tie can
            move by rounding).
    """
    A = torch.as_tensor(A, dtype=torch.float32)
    B = A.shape[0] if A.dim() == 3 else 1
    A = _batched(A, B, 2)
    P, q, l, u = _batched(P, B, 2), _batched(q, B, 1), _batched(l, B, 1), _batched(u, B, 1)
    n, m = P.shape[-1], A.shape[-2]
    dev = A.device
    x = torch.zeros((B, n), device=dev) if x0 is None else _batched(x0, B, 1)
    y = torch.zeros((B, m), device=dev) if y0 is None else _batched(y0, B, 1)
    eye = torch.eye(n, dtype=torch.float32, device=dev)

    # Ruiz equilibration of rows and columns (unit inf-norms); x and y are
    # rescaled on entry and exit.
    c = torch.ones((B, n), device=dev)
    d = torch.ones((B, m), device=dev)
    for _ in range(3):
        col_norm = torch.maximum(P.abs().amax(dim=-2), A.abs().amax(dim=-2))
        dc = 1.0 / torch.sqrt(torch.clamp(col_norm, min=1e-8))
        P = P * dc[:, None, :] * dc[:, :, None]
        A = A * dc[:, None, :]
        c = c * dc
        dr = 1.0 / torch.clamp(A.abs().amax(dim=-1), min=1e-8)
        A = A * dr[:, :, None]
        d = d * dr
    q = q * c
    l = torch.where(torch.isfinite(l), l * d, l)
    u = torch.where(torch.isfinite(u), u * d, u)
    x = x / c
    y = y / d
    z = torch.clamp(_mv(A, x), l, u)
    eq_mask = (u - l) < 1e-9
    At = A.transpose(-1, -2)

    def stage(x, z, y, rho_s, n_iter):
        rho_vec = torch.where(eq_mask, rho_s[:, None] * 1e3, rho_s[:, None])
        K = P + sigma * eye + (At * rho_vec[:, None, :]) @ A
        K = 0.5 * (K + K.transpose(-1, -2))
        # The explicit inverse, so that an iteration is products only; one
        # Newton-Schulz step squares its residual.
        Kinv = torch.cholesky_solve(eye.expand(B, n, n), torch.linalg.cholesky_ex(K)[0])
        Kinv = Kinv + Kinv @ (eye - K @ Kinv)
        run = _captured_iterations if (capture and dev.type == 'cuda') else _iterations
        x, z, y = run(x, z, y, Kinv, A, q, l, u, rho_vec, sigma, alpha, n_iter)
        Ax = _mv(A, x)
        pr = _inf_norm(Ax - z) + 1e-12
        dr = _inf_norm(_mv(P, x) + q + _vm(y, A)) + 1e-12
        scale = torch.clamp(torch.sqrt(pr / dr), 0.2, 5.0)
        rho_next = torch.clamp(rho_s * scale, 1e-4, 1e4)
        # The early exit reads the violation of [l, u], as prim_res does.
        return x, z, y, rho_next, _violation(Ax, l, u), dr

    rho_s = torch.full((B,), float(rho), device=dev)
    sizes = stage_sizes(iters, tol)
    iterations = torch.zeros((B,), dtype=torch.int32, device=dev)
    if tol is None:
        for n_iter in sizes:
            x, z, y, rho_s, _, _ = stage(x, z, y, rho_s, n_iter)
        iterations += sum(sizes)
    else:
        tol_t = torch.tensor(float(tol), dtype=torch.float32, device=dev)
        tol10 = 10.0 * tol_t
        pr = torch.full((B,), float('inf'), device=dev)
        dr = pr.clone()
        for k, n_iter in enumerate(sizes):
            active = (pr > tol_t) | (dr > tol10)
            # Every problem is active in stage 0; later, one read a stage.
            if k > 0 and not bool(active.any()):
                break
            out = stage(x, z, y, rho_s, n_iter)
            col = active[:, None]
            x, z, y = (torch.where(col, new, old) for new, old in zip(out[:3], (x, z, y)))
            rho_s, pr, dr = (torch.where(active, new, old)
                             for new, old in zip(out[3:], (rho_s, pr, dr)))
            iterations += active.to(torch.int32) * n_iter
    Ax = _mv(A, x)
    prim_res = _violation(Ax, l, u)
    dual_res = _inf_norm(_mv(P, x) + q + _vm(y, A))
    if polish:
        x, z, y, prim_res, dual_res = _polish(P, q, A, l, u, x, z, y, prim_res, dual_res,
                                              sigma)
    return QPSolution(x=x * c, z=z, y=y * d, prim_res=prim_res, dual_res=dual_res,
                      iterations=iterations)


def _iterations(x, z, y, Kinv, A, q, l, u, rho_vec, sigma, alpha, n_iter):
    """``n_iter`` relaxed ADMM iterations with the stage's KKT inverse."""
    for _ in range(n_iter):
        rhs = sigma * x - q + _vm(rho_vec * z - y, A)
        x = _mv(Kinv, rhs)
        Ax_rel = alpha * _mv(A, x) + (1 - alpha) * z
        z_new = torch.clamp(Ax_rel + y / rho_vec, l, u)
        y = y + rho_vec * (Ax_rel - z_new)
        z = z_new
    return x, z, y


# CUDA graphs of the iterations for one set of inputs' shapes (and device):
# the static inputs they share, and a graph per (sigma, alpha, iteration
# count), at most one per stage size. A call of other shapes frees them all
# before it captures its own, so the device memory they hold is that of the
# last shapes alone.
_CAPTURED = {'shapes': None, 'static': None, 'graphs': {}}


def _captured_iterations(x, z, y, Kinv, A, q, l, u, rho_vec, sigma, alpha, n_iter):
    """``_iterations`` as one CUDA graph replay: the inputs are copied into
    the graph's static tensors, the graph runs the n_iter iterations' launches
    with no host work between them, and the outputs are copied out. The
    graph is captured on the first call of its shapes and count (after one
    iteration run on a side stream, as CUDA graphs need)."""
    inputs = (x, z, y, Kinv, A, q, l, u, rho_vec)
    shapes = (x.device, tuple(tuple(t.shape) for t in inputs))
    if _CAPTURED['shapes'] != shapes:
        _CAPTURED.update(shapes=None, static=None, graphs={})
        _CAPTURED.update(shapes=shapes, static=[
            torch.empty_like(t, memory_format=torch.contiguous_format) for t in inputs])
    static, graphs = _CAPTURED['static'], _CAPTURED['graphs']
    for buf, t in zip(static, inputs):
        buf.copy_(t)
    key = (float(sigma), float(alpha), int(n_iter))
    if key not in graphs:
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            _iterations(*static, sigma, alpha, 1)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = _iterations(*static, sigma, alpha, n_iter)
        graphs[key] = (graph, outputs)
    graph, outputs = graphs[key]
    graph.replay()
    return tuple(o.clone() for o in outputs)


def _polish_kkt(P, q, A, l, u, x, sigma, eps_act):
    """The active-set KKT solve of the equilibrated problems at the margins
    ``eps_act`` (B, k): rows whose Ax lies within the margin of a finite
    bound are active; inactive rows get a unit dual diagonal, so their
    multipliers come out 0. One batched LU of the B k saddle systems and one
    refinement pass. Returns x (B, k, n) and y (B, k, m)."""
    B, k = eps_act.shape
    n, m = P.shape[-1], A.shape[-2]
    Ax = _mv(A, x)[:, None, :]
    eps = eps_act[..., None]
    act_l = torch.isfinite(l)[:, None, :] & ((Ax - l[:, None, :]) < eps)
    act_u = torch.isfinite(u)[:, None, :] & ((u[:, None, :] - Ax) < eps)
    act = act_l | act_u
    a = act.to(torch.float32)
    zero = torch.zeros((), device=x.device)
    b = torch.where(act_u, u[:, None, :], torch.where(act_l, l[:, None, :], zero)) * a
    A_eff = A[:, None] * a[..., None]
    eye = torch.eye(n, dtype=torch.float32, device=x.device)
    top = torch.cat([(P + sigma * eye)[:, None].expand(B, k, n, n),
                     A_eff.transpose(-1, -2)], dim=-1)
    diag = torch.diag_embed(-torch.where(act, 1e-7, 1.0))
    M = torch.cat([top, torch.cat([A_eff, diag], dim=-1)], dim=-2).reshape(B * k, n + m, n + m)
    rhs = torch.cat([(-q)[:, None].expand(B, k, n), b], dim=-1).reshape(B * k, n + m, 1)
    LU, pivots, _ = torch.linalg.lu_factor_ex(M)
    sol = torch.linalg.lu_solve(LU, pivots, rhs)
    sol = sol + torch.linalg.lu_solve(LU, pivots, rhs - M @ sol)
    sol = sol.reshape(B, k, n + m)
    return sol[..., :n], sol[..., n:]


def _polish(P, q, A, l, u, x, z, y, prim_res, dual_res, sigma):
    """Polish every problem at the margins 1e-4, 1e-3 and max(1e-4,
    5 prim_res) (one batched LU), then take the candidates in order, each
    only if it improves both residuals of the iterate kept so far."""
    eps = torch.stack([torch.full_like(prim_res, 1e-4), torch.full_like(prim_res, 1e-3),
                       torch.clamp(5.0 * prim_res, min=1e-4)], dim=1)
    xs, ys = _polish_kkt(P, q, A, l, u, x, sigma, eps)
    Axs = xs @ A.transpose(-1, -2)
    prs = _inf_norm(Axs - torch.clamp(Axs, l[:, None, :], u[:, None, :]))
    drs = _inf_norm(xs @ P.transpose(-1, -2) + q[:, None, :] + ys @ A)
    for i in range(eps.shape[1]):
        ok = (prs[:, i] <= torch.clamp(prim_res, min=1e-6)) & (drs[:, i] <= dual_res)
        col = ok[:, None]
        x = torch.where(col, xs[:, i], x)
        y = torch.where(col, ys[:, i], y)
        z = torch.where(col, torch.clamp(Axs[:, i], l, u), z)
        prim_res = torch.where(ok, prs[:, i], prim_res)
        dual_res = torch.where(ok, drs[:, i], dual_res)
    return x, z, y, prim_res, dual_res


def make_qp_solver(iters: int = 200, rho: float = 0.1, sigma: float = 1e-6,
                   alpha: float = 1.6):
    """``solve(P, q, A, l, u, x0=None, y0=None)`` with these settings fixed."""
    def solve(P, q, A, l, u, x0=None, y0=None):
        return admm_qp(P, q, A, l, u, x0=x0, y0=y0, rho=rho, sigma=sigma,
                       alpha=alpha, iters=iters)
    return solve
