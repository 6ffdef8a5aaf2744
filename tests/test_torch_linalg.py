"""The port's control linear algebra (``safe_control_gym_tpu_torch/math/linalg.py``)
against the JAX package's and against scipy, on the systems of
tests/test_linalg.py (numpy seed 0: four random 4-state, 2-input systems,
Q = I, R = 0.1 I).

Tolerances: against JAX, rtol 1e-4 of each result's largest entry (both are
float32 with fixed iteration counts; they differ in the order of their
sums); against scipy, tests/test_linalg.py's own tolerances (its
``np.allclose``: rtol 1e-5 plus atol 1e-4 for DARE and CARE, 2e-4 for expm,
1e-6 for the exact discretization, 1e-3 and 1e-4 for Euler against exact)."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from safe_control_gym_tpu.math import linalg as jl
from safe_control_gym_tpu_torch.math import linalg as tl


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


RTOL = 1e-4


def _systems():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(4):
        n, m = 4, 2
        A = rng.standard_normal((n, n)) * 0.5
        B = rng.standard_normal((n, m))
        out.append((A, B, np.eye(n), np.eye(m) * 0.1))
    return out


SYSTEMS = _systems()


def _close_to(port, ref, rtol=RTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= rtol * np.abs(ref).max(), (err, np.abs(ref).max())


CASES = {
    'expm': lambda m, A, B, Q, R: m.expm(A),
    'solve_dare': lambda m, A, B, Q, R: m.solve_dare(A, B, Q, R),
    'solve_care': lambda m, A, B, Q, R: m.solve_care(A, B, Q, R),
    'discretize_exact': lambda m, A, B, Q, R: np.concatenate(
        [np.asarray(M) for M in m.discretize_linear_system(A, B, 0.05, exact=True)], axis=-1),
    'discretize_euler': lambda m, A, B, Q, R: np.concatenate(
        [np.asarray(M) for M in m.discretize_linear_system(A, B, 0.05, exact=False)], axis=-1),
    'gain_discrete': lambda m, A, B, Q, R: m.compute_lqr_gain(A, B, Q, R, discrete=True),
    'gain_continuous': lambda m, A, B, Q, R: m.compute_lqr_gain(A, B, Q, R, discrete=False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_jax(case):
    for A, B, Q, R in SYSTEMS:
        _close_to(CASES[case](tl, A, B, Q, R), CASES[case](jl, A, B, Q, R))


def test_dare_and_care_match_scipy():
    for A, B, Q, R in SYSTEMS:
        np.testing.assert_allclose(tl.solve_dare(A, B, Q, R).numpy(),
                                   sla.solve_discrete_are(A, B, Q, R), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tl.solve_care(A, B, Q, R).numpy(),
                                   sla.solve_continuous_are(A, B, Q, R), rtol=1e-5, atol=1e-4)


def test_expm_matches_scipy():
    for A, _, _, _ in SYSTEMS:
        np.testing.assert_allclose(tl.expm(A).numpy(), sla.expm(A), rtol=1e-5, atol=2e-4)


def test_discretize_exact_vs_euler_and_scipy():
    A = np.array([[0.0, 1.0], [-2.0, -0.5]])
    B = np.array([[0.0], [1.0]])
    Ad, Bd = (M.numpy() for M in tl.discretize_linear_system(A, B, 0.01, exact=True))
    Ad_e, Bd_e = (M.numpy() for M in tl.discretize_linear_system(A, B, 0.01, exact=False))
    np.testing.assert_allclose(Ad, Ad_e, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(Bd, Bd_e, rtol=1e-5, atol=1e-4)
    Md = sla.expm(np.block([[A, B], [np.zeros((1, 3))]]) * 0.01)
    np.testing.assert_allclose(Ad, Md[:2, :2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Bd, Md[:2, 2:], rtol=1e-5, atol=1e-6)


def test_discrete_gain_stabilizes():
    for A, B, Q, R in SYSTEMS:
        Ad, Bd = tl.discretize_linear_system(A, B, 0.05, exact=True)
        K = tl.compute_lqr_gain(Ad, Bd, Q, R, discrete=True)
        assert np.all(np.abs(np.linalg.eigvals((Ad - Bd @ K).numpy())) < 1.0)


@pytest.mark.parametrize('case', ['solve_dare', 'solve_care', 'discretize_exact',
                                  'gain_discrete', 'gain_continuous'])
def test_batched_equals_one_by_one(case):
    """A leading batch of the four systems gives each system's own result
    (rtol 1e-4 of its largest entry)."""
    As, Bs = np.stack([s[0] for s in SYSTEMS]), np.stack([s[1] for s in SYSTEMS])
    Q, R = SYSTEMS[0][2], SYSTEMS[0][3]
    batched = np.asarray(CASES[case](tl, As, Bs, Q, R))
    for k, (A, B, _, _) in enumerate(SYSTEMS):
        _close_to(batched[k], CASES[case](tl, A, B, Q, R))


def test_full_matmul_precision_restores_the_setting():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('medium')
    try:
        seen = tl.full_matmul_precision(torch.get_float32_matmul_precision)()
        assert seen == 'highest'
        assert torch.get_float32_matmul_precision() == 'medium'
    finally:
        torch.set_float32_matmul_precision(old)


def test_results_are_float32_on_the_inputs_device():
    A, B, Q, R = SYSTEMS[0]
    P = tl.solve_dare(torch.tensor(A), B, Q, R)
    assert P.dtype == torch.float32 and P.device.type == 'cpu'


def test_cost_weight_matrix():
    assert np.allclose(tl.get_cost_weight_matrix([5.0], 3), np.eye(3) * 5)
    assert np.allclose(tl.get_cost_weight_matrix([1.0, 2.0], 2), np.diag([1.0, 2.0]))
    assert np.allclose(tl.get_cost_weight_matrix(None, 2), np.eye(2))
    with pytest.raises(ValueError):
        tl.get_cost_weight_matrix([1.0, 2.0], 3)
