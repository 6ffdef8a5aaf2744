"""The port's prior model (``envs/symbolic.py``, built by each env's
``_setup_symbolic``) against the JAX package's ``env.symbolic``, on the
cartpole and the 2D and 3D quadrotors, and ``BaseController.get_prior`` with a
``prior_prop`` against JAX's.

Every function of the model is held at 16 random (x, u) drawn from numpy
seed 0 (states in [-1, 1], inputs within 20% of the equilibrium thrust or
+-5 N on the cartpole), atol 1e-5: both packages compute in float32, their
Jacobians by forward mode in the same operation order; the largest entries
(d theta_ddot / dT of the quads, about 2005) then agree to a few ulp."""

import functools

import numpy as np
import pytest
import torch

from safe_control_gym_tpu.controllers.base_controller import BaseController as JBase
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.controllers.base_controller import BaseController as TBase
from safe_control_gym_tpu_torch.utils.registration import make as tmake


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


ATOL = 1e-5
N_POINTS = 16
SYSTEMS = {
    'cartpole': ('cartpole', {}),
    'quadrotor_2D': ('quadrotor', {'quad_type': 2}),
    'quadrotor_3D': ('quadrotor', {'quad_type': 3,
                                   'task_info': {'stabilization_goal': [0, 0, 1]}}),
}
FUNCTIONS = ('fc_func', 'fd_func', 'g_func', 'df_func', 'dg_func', 'fc_linear_func',
             'fd_linear_func', 'loss')


@functools.lru_cache(maxsize=None)
def _envs(system):
    env_id, cfg = SYSTEMS[system]
    return jmake(env_id, seed=0, **cfg), tmake(env_id, device='cpu', seed=0, **cfg)


def _points(model, seed=0):
    """N_POINTS random (x, u, x_eval, u_eval, Xr, Ur, Q, R) as float32 numpy."""
    rng = np.random.default_rng(seed)
    nx, nu = model.nx, model.nu
    u_eq = np.atleast_1d(model.U_EQ)
    if np.all(u_eq == 0):
        u = lambda: rng.uniform(-5.0, 5.0, nu)
    else:
        u = lambda: u_eq * rng.uniform(0.8, 1.2, nu)
    f32 = lambda a: np.asarray(a, np.float32)
    return [tuple(f32(a) for a in (rng.uniform(-1, 1, nx), u(), rng.uniform(-1, 1, nx), u(),
                                   rng.uniform(-1, 1, nx), u(),
                                   np.diag(rng.uniform(0.1, 5.0, nx)),
                                   np.diag(rng.uniform(0.01, 1.0, nu))))
            for _ in range(N_POINTS)]


def _call(model, name, p):
    x, u, x_eval, u_eval, Xr, Ur, Q, R = p
    if name == 'loss':
        return model.loss(x, u, Xr, Ur, Q, R)
    if name.endswith('linear_func'):
        return getattr(model, name)(x_eval, u_eval, x, u)
    return getattr(model, name)(x, u)


def _as_dict(out):
    out = out if isinstance(out, dict) else {'value': out}
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


@pytest.mark.parametrize('function', FUNCTIONS)
@pytest.mark.parametrize('system', sorted(SYSTEMS))
def test_function_matches_jax(system, function):
    jenv, tenv = _envs(system)
    for p in _points(jenv.symbolic):
        want, got = _as_dict(_call(jenv.symbolic, function, p)), \
            _as_dict(_call(tenv.symbolic, function, p))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize('system', sorted(SYSTEMS))
def test_params_dims_and_reset_info(system):
    jenv, tenv = _envs(system)
    jm, tm = jenv.symbolic, tenv.symbolic
    assert (tm.nx, tm.nu, tm.ny, tm.dt) == (jm.nx, jm.nu, jm.ny, jm.dt)
    assert sorted(tm.params) == sorted(jm.params)
    for k, v in jm.params.items():
        if v is None:
            assert tm.params[k] is None
        else:
            np.testing.assert_allclose(np.asarray(tm.params[k]), np.asarray(v), rtol=0, atol=0)
            np.testing.assert_allclose(np.asarray(getattr(tm, k)), np.asarray(v), rtol=0, atol=0)
    np.testing.assert_allclose(tenv.Q, jenv.Q, rtol=0, atol=0)
    np.testing.assert_allclose(tenv.R, jenv.R, rtol=0, atol=0)
    _, info = tenv.reset()
    assert info['symbolic_model'] is tm


@pytest.mark.parametrize('system', sorted(SYSTEMS))
def test_keyword_calls_equal_positional(system):
    _, tenv = _envs(system)
    m = tenv.symbolic
    x, u, x_eval, u_eval, Xr, Ur, Q, R = _points(m, seed=1)[0]
    assert torch.equal(m.fd_func(x0=x, p=u), m.fd_func(x, u))
    df = m.df_func(x=x, u=u)
    assert all(torch.equal(df[k], m.df_func(x, u)[k]) for k in df)
    assert torch.equal(m.fc_linear_func(x_eval=x_eval, u_eval=u_eval, x=x, u=u),
                       m.fc_linear_func(x_eval, u_eval, x, u))
    assert torch.equal(m.loss(x=x, u=u, Xr=Xr, Ur=Ur, Q=Q, R=R)['l_xu'],
                       m.loss(x, u, Xr, Ur, Q, R)['l_xu'])
    raw = m.fc_fn(torch.as_tensor(x), torch.as_tensor(u))
    assert torch.equal(raw, m.fc_func(x, u)) and raw.dtype == torch.float32


def _probe(base):
    class Probe(base):
        def select_action(self, obs, info=None):
            return None

        def reset(self):
            pass

        def close(self):
            pass
    return Probe


PRIORS = {
    'cartpole': {'prior_prop': {'pole_length': 0.6, 'pole_mass': 0.12, 'cart_mass': 1.1}},
    'quadrotor_2D': {'prior_prop': {'M': 0.03, 'Iyy': 1.5e-5}},
    'quadrotor_3D': {'prior_prop': {'M': 0.03, 'Ixx': 1.5e-5, 'Iyy': 1.3e-5, 'Izz': 2.2e-5},
                     'randomize_prior_prop': True,
                     'prior_prop_rand_info': {
                         'M': {'distrib': 'uniform', 'low': -0.002, 'high': 0.002},
                         'Ixx': {'distrib': 'normal', 'loc': 0.0, 'scale': 1e-7}}},
}


@pytest.mark.parametrize('system', sorted(SYSTEMS))
def test_get_prior_matches_jax(system):
    """get_prior with a prior_prop (on the 3D quad also randomized from
    np.random.default_rng(seed)) gives JAX's parameters exactly and its
    model's dynamics to 1e-5."""
    env_id, cfg = SYSTEMS[system]
    jenv, tenv = jmake(env_id, seed=0, **cfg), tmake(env_id, device='cpu', seed=0, **cfg)
    jm = _probe(JBase)(None, seed=3).get_prior(jenv, PRIORS[system])
    tm = _probe(TBase)(None, seed=3).get_prior(tenv, PRIORS[system])
    for k, v in jm.params.items():
        if v is not None:
            np.testing.assert_allclose(np.asarray(tm.params[k]), np.asarray(v), rtol=0, atol=0)
    for p in _points(jm, seed=2)[:4]:
        np.testing.assert_allclose(tm.fc_func(p[0], p[1]).numpy(),
                                   np.asarray(jm.fc_func(p[0], p[1])), rtol=0, atol=ATOL)
