"""Gradients through the port's env step: K1-K3 are differentiated through
their plain twins (``ops/physics_kernels._PlainGrad``), ``pallas_physics``
opts the env out of the kernels, and the rollout kernels K4/K5 refuse
autograd.

* Against ``jax.grad`` on examples/differentiable_sim_demo.py's cost (the
  cartpole at 15 Hz over 750 Hz physics, init_theta 0.4, quadratic cost;
  state cost w x^2 plus 0.001 |a|^2 over T=8 actions from numpy seed 0):
  the cost and the gradient to rtol 1e-4 (float32 through 400 substeps,
  summed in another order).
* ``_PlainGrad`` on the CPU, its forward a stand-in for the kernel (the
  plain twin itself): the gradient equals autograd's through the twin, bit
  for bit (the same float ops).
* On a CUDA device (marked ``gpu``): K1-K3's gradient through the kernel
  against the CPU twin's, 1e-4 of the gradient's largest entry (the
  twin's backward runs on the card's libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.ops import physics_kernels as pk
from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
from safe_control_gym_tpu_torch.utils.registration import make as tmake


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


DEMO = dict(seed=0, ctrl_freq=15, pyb_freq=750, init_state={'init_theta': 0.4},
            randomized_init=False, cost='quadratic')
W = [1.0, 0.1, 5.0, 0.1]
T = 8
RTOL = 1e-4


def _actions():
    return np.random.default_rng(0).uniform(-2.0, 2.0, (T, 1)).astype(np.float32)


def _jax_cost_and_grad(actions):
    func = jmake('cartpole', **DEMO).func
    w = jnp.asarray(W)

    def rollout_cost(actions):
        state, _ = func.reset(jax.random.PRNGKey(0))

        def body(state, a):
            state, _ = func.step(state, a)
            x = state.state
            return state, jnp.sum(w * x * x) + 0.001 * jnp.sum(a * a)
        return jax.lax.scan(body, state, actions)[1].sum()
    cost, grad = jax.value_and_grad(rollout_cost)(jnp.asarray(actions))
    return float(cost), np.asarray(grad)


def _port_cost_and_grad(actions, device='cpu', **env_kw):
    env = tmake('cartpole', device=device, **DEMO, **env_kw)
    w = torch.tensor(W, device=env.device)
    a = torch.tensor(actions, device=env.device, requires_grad=True)
    est, _ = env.func.reset_batch(env.generator, 1)
    cost = torch.zeros((), device=env.device)
    for t in range(T):
        est, _ = env.func.step(est, a[t][None])
        x = est.state[0]
        cost = cost + (w * x * x).sum() + 0.001 * (a[t] * a[t]).sum()
    cost.backward()
    return float(cost.detach()), a.grad.cpu().numpy()


@pytest.mark.parametrize('pallas_physics', [True, False])
def test_cpu_gradient_matches_jax_grad(pallas_physics):
    actions = _actions()
    j_cost, j_grad = _jax_cost_and_grad(actions)
    t_cost, t_grad = _port_cost_and_grad(actions, pallas_physics=pallas_physics)
    assert np.isfinite(t_grad).all() and np.abs(t_grad).max() > 0
    np.testing.assert_allclose(t_cost, j_cost, rtol=RTOL)
    np.testing.assert_allclose(t_grad, j_grad, rtol=RTOL, atol=RTOL * np.abs(j_grad).max())


def test_pallas_physics_false_runs_the_twin():
    env = tmake('cartpole', device='cpu', pallas_physics=False, **DEMO)
    assert env.pallas_physics is False
    assert tmake('cartpole', device='cpu', **DEMO).pallas_physics is True
    quad = tmake('quadrotor', device='cpu', quad_type=2, pallas_physics=False)
    quad.reset()
    before = pk.quad2d_advance.launches
    quad.step(quad.U_GOAL)
    assert pk.quad2d_advance.launches == before


def _physics_args(name, B, dev, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=-1.0, hi=1.0: torch.tensor(
        rng.uniform(lo, hi, shape).astype(np.float32), device=dev)
    if name == 'cartpole_advance':
        return [f(B, 4, lo=-0.5, hi=0.5), f(B, lo=-5, hi=5), f(B, 2, lo=-0.1, hi=0.1),
                torch.tensor([0.1, 1.0, 0.5, 9.8], device=dev)]
    if name == 'quad2d_advance':
        return [f(B, 6, lo=-0.5, hi=0.5), f(B, lo=0.1, hi=0.2), f(B, lo=0.1, hi=0.2),
                f(B, 2, lo=-0.01, hi=0.01), torch.tensor([0.027, 1.4e-5, 0.0397, 9.8], device=dev)]
    return [f(B, 12, lo=-0.5, hi=0.5), f(B, 4, lo=0.05, hi=0.1), f(B, lo=-1e-3, hi=1e-3),
            f(B, 3, lo=-0.01, hi=0.01),
            torch.tensor([0.027, 1.4e-5, 1.4e-5, 2.17e-5, 0.0397, 9.8], device=dev)]


def _grads(fn, args, n_sub=20, dt=1e-3):
    args = [a.clone().requires_grad_(True) for a in args]
    out = fn(*args, n_sub, dt)
    weights = torch.linspace(0.5, 1.5, out.numel(), device=out.device).reshape(out.shape)
    (out * weights).sum().backward()
    return out.detach(), [a.grad for a in args]


KERNELS = ['cartpole_advance', 'quad2d_advance', 'quad3d_advance']


@pytest.mark.parametrize('name', KERNELS)
def test_plain_grad_backward_is_the_twins_gradient(name):
    plain = getattr(pk, name + '_plain')
    stand_in = lambda *a: pk._PlainGrad.apply(plain, plain, a[-2], a[-1], *a[:-2])
    out, grads = _grads(stand_in, _physics_args(name, 64, 'cpu'))
    ref_out, ref_grads = _grads(plain, _physics_args(name, 64, 'cpu'))
    assert torch.equal(out, ref_out)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def test_rollout_kernels_refuse_autograd():
    state0 = torch.zeros((4, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match='no gradient'):
        rk._refuse_grad('cartpole_rollout', state0, torch.zeros(3), None, None, None)
    with torch.no_grad():
        rk._refuse_grad('cartpole_rollout', state0, torch.zeros(3), None, None, None)
    rk._refuse_grad('quad2d_rollout', state0.detach(), torch.zeros(3), None, None, None)


@pytest.mark.gpu
@pytest.mark.parametrize('name', KERNELS)
def test_cuda_gradient_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    kernel, plain = getattr(pk, name), getattr(pk, name + '_plain')
    before = kernel.launches
    out, grads = _grads(kernel, _physics_args(name, 4096, 'cuda'))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref_out, ref_grads = _grads(plain, _physics_args(name, 4096, 'cpu'))
    assert float((out.cpu() - ref_out).abs().max()) <= 1e-5
    for g, r in zip(grads, ref_grads):
        assert g is not None
        assert float((g.cpu() - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.gpu
def test_cuda_env_gradient_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    actions = _actions()
    c_cost, c_grad = _port_cost_and_grad(actions, device='cuda')
    h_cost, h_grad = _port_cost_and_grad(actions)
    np.testing.assert_allclose(c_cost, h_cost, rtol=RTOL)
    np.testing.assert_allclose(c_grad, h_grad, rtol=RTOL, atol=RTOL * np.abs(h_grad).max())
    assert np.abs(c_grad).max() > 0
