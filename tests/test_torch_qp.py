"""The port's batched ADMM QP (``safe_control_gym_tpu_torch/ops/qp.py``)
against the JAX package's ``admm_qp`` on the CPU, the analytic cases of
tests/test_mpc.py and the C++ oracle of tests/test_native_qp_oracle.py.

Inputs: strictly convex QPs made from numpy seeds (P = GG'/n + I, box rows,
three equality rows, one row open below and one open above); the port
solves them as one batch, JAX each alone.

Tolerances, and why:
* x and y to 1e-4 of max(1, |x|_inf), prim_res and dual_res to 1e-4: both
  run the same float32 iterations, summed in another order; on problems
  solved to these tolerances the two iterates converge to the same point
  (before convergence ADMM's rho adaptation turns a 1e-7 change of the data
  into 1e-2 after 10 iterations, in either package, so the budgets here are
  ones that converge).
* The mixed batch against its problems solved alone: the per-problem early
  exit makes each problem's stages and answer its own, so iteration counts
  are equal and x, y within 1e-6 (the batched products may block their sums
  otherwise than the single ones).
* The oracle: tests/test_native_qp_oracle.py's own bounds (port prim_res
  < 1e-4, |x - x_oracle| < 5e-3, objectives within 1e-4 relative).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.ops.qp import admm_qp as jax_qp
from safe_control_gym_tpu_torch.ops import qp as tqp


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


TOL = 1e-4


def _qp(rng, n=10, m=15, n_eq=3, ridge=1.0):
    G = rng.normal(size=(n, n))
    P = G @ G.T / n + ridge * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    ctr = A @ rng.normal(size=n) * 0.3
    width = np.abs(rng.normal(size=m)) + 0.5
    l, u = ctr - width, ctr + width
    l[:n_eq] = u[:n_eq] = ctr[:n_eq]
    l[-2], u[-1] = -np.inf, np.inf
    return [a.astype(np.float32) for a in (P, q, A, l, u)]


def _problems(seed, count=4, **kw):
    rng = np.random.default_rng(seed)
    return [_qp(rng, **kw) for _ in range(count)]


def _port(problems, **kw):
    return tqp.admm_qp(*(torch.tensor(np.stack(a)) for a in zip(*problems)), **kw)


def _assert_matches_jax(problems, sol, **kw):
    for i, prob in enumerate(problems):
        ref = jax_qp(*map(jnp.asarray, prob), **kw)
        scale = max(1.0, float(np.abs(np.asarray(ref.x)).max()))
        np.testing.assert_allclose(sol.x[i].numpy(), np.asarray(ref.x), rtol=0, atol=TOL * scale)
        np.testing.assert_allclose(sol.y[i].numpy(), np.asarray(ref.y), rtol=0, atol=TOL * scale)
        assert abs(float(sol.prim_res[i]) - float(ref.prim_res)) <= TOL
        assert abs(float(sol.dual_res[i]) - float(ref.dual_res)) <= TOL


def test_fixed_iterations_match_jax():
    problems = _problems(0)
    sol = _port(problems, iters=400)
    assert sol.x.shape == (4, 10) and sol.y.shape == (4, 15) and sol.prim_res.shape == (4,)
    assert (sol.iterations == 400).all()
    _assert_matches_jax(problems, sol, iters=400)


def test_tol_path_matches_jax():
    problems = _problems(1)
    sol = _port(problems, iters=2000, tol=1e-5)
    assert (sol.iterations < 2000).all()
    _assert_matches_jax(problems, sol, iters=2000, tol=1e-5)


def test_polish_matches_jax():
    problems = _problems(2)
    sol = _port(problems, iters=300, tol=1e-3, polish=True)
    rough = _port(problems, iters=300, tol=1e-3)
    # The polish is taken: the residuals fall past the ADMM exit's.
    assert (sol.prim_res <= rough.prim_res).all() and (sol.dual_res < rough.dual_res).all()
    _assert_matches_jax(problems, sol, iters=300, tol=1e-3, polish=True)


def test_mixed_batch_gives_each_problem_its_own_answer():
    easy = _problems(3, count=2)
    hard = _problems(4, count=2, ridge=1e-3)
    problems = [easy[0], hard[0], easy[1], hard[1]]
    kw = dict(iters=4000, tol=1e-5, polish=True)
    sol = _port(problems, **kw)
    alone = [_port([p], **kw) for p in problems]
    iters = [int(a.iterations[0]) for a in alone]
    assert sol.iterations.tolist() == iters
    assert max(iters[0], iters[2]) < min(iters[1], iters[3])
    for i, a in enumerate(alone):
        np.testing.assert_allclose(sol.x[i].numpy(), a.x[0].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(sol.y[i].numpy(), a.y[0].numpy(), rtol=0, atol=1e-6)
    _assert_matches_jax(problems, sol, **kw)


def test_stage_sizes_are_jax_schedule():
    assert tqp.stage_sizes(4000, 1e-3) == [8, 8, 16, 31, 62, 125, 250, 500, 1000, 2000]
    assert sum(tqp.stage_sizes(4000, 1e-3)) == 4000
    assert tqp.stage_sizes(400, None) == [40] * 10
    assert tqp.stage_sizes(5, None) == [1] * 10


def test_analytic_equality_and_bounds():
    # tests/test_mpc.py: min 0.5 x'x - x1 s.t. x1 + x2 = 1, x >= 0.2.
    P = torch.eye(2)
    q = torch.tensor([-1.0, 0.0])
    A = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    l = torch.tensor([1.0, 0.2, 0.2])
    u = torch.tensor([1.0, float('inf'), float('inf')])
    sol = tqp.admm_qp(P, q[None], A[None], l[None], u[None], iters=400)
    np.testing.assert_allclose(sol.x[0].numpy(), [0.8, 0.2], atol=1e-4)
    assert float(sol.prim_res[0]) < 1e-5


def test_unconstrained_matches_solve():
    rng = np.random.default_rng(0)
    n = 8
    M = rng.standard_normal((n, n))
    P = M @ M.T + np.eye(n)
    q = rng.standard_normal(n)
    solve = tqp.make_qp_solver(iters=400)
    sol = solve(torch.tensor(P, dtype=torch.float32), torch.tensor(q, dtype=torch.float32)[None],
                torch.zeros((1, 1, n)), torch.tensor([[-np.inf]], dtype=torch.float32),
                torch.tensor([[np.inf]], dtype=torch.float32))
    np.testing.assert_allclose(sol.x[0].numpy(), np.linalg.solve(P, -q), atol=1e-3)


def test_oracle_agrees_on_random_qps():
    if shutil.which('g++') is None:
        pytest.skip('g++ not available for native/qp_oracle.cpp')
    from safe_control_gym_tpu.utils.native import qp_solve_oracle
    rng = np.random.default_rng(0)
    problems, oracle = [], []
    for _ in range(5):
        G = rng.normal(size=(12, 12))
        P = G @ G.T + np.eye(12) / 10.0
        q = rng.normal(size=12)
        A = rng.normal(size=(20, 12))
        ctr = A @ rng.normal(size=12)
        width = np.abs(rng.normal(size=20)) + 0.5
        prob = (P, q, A, ctr - width, ctr + width)
        problems.append([a.astype(np.float32) for a in prob])
        oracle.append(qp_solve_oracle(*prob, iters=2000, tol=1e-6, polish=True))
    sol = _port(problems, iters=2000, tol=1e-6, polish=True)
    for i, (xo, _yo, pro, _dro) in enumerate(oracle):
        P, q = (np.asarray(a, np.float64) for a in problems[i][:2])
        xd = sol.x[i].numpy().astype(np.float64)
        assert pro < 1e-5 and float(sol.prim_res[i]) < 1e-4, i
        assert np.max(np.abs(xo - xd)) < 5e-3, i
        fo, fd = 0.5 * xo @ P @ xo + q @ xo, 0.5 * xd @ P @ xd + q @ xd
        assert abs(fo - fd) <= 1e-4 * max(1.0, abs(fo)), i
