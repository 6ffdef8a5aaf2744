"""AnalyticModel: an env's prior model (dynamics, observation, quadratic cost
and their derivatives) for the model-based controllers, in PyTorch.

Port of ``safe_control_gym_tpu/envs/symbolic.py``. Each env builds one in
``_setup_symbolic`` and exposes it as ``env.symbolic``; LQR, iLQR and PID read
it (``BaseController.get_prior``). The Jacobians and Hessians come from
``torch.func`` (``jacfwd``, ``grad``, ``hessian``) where JAX has
``jax.jacfwd``/``jax.hessian``, so a controller can batch them with
``torch.func.vmap``.

* ``fc_func(x, u)`` -> x_dot
* ``fd_func(x, u)`` -> x one ``dt`` later (RK4 or Euler over
  ``integration_substeps``)
* ``g_func(x, u)`` -> y
* ``df_func(x, u)`` -> {'dfdx', 'dfdu'}
* ``dg_func(x, u)`` -> {'dgdx', 'dgdu'}
* ``fc_linear_func(x_eval, u_eval, x, u)``, ``fd_linear_func(...)``: the
  model linearized at (x, u), evaluated at (x_eval, u_eval)
* ``loss(x, u, Xr, Ur, Q, R)`` -> {'l', 'l_x', 'l_xx', 'l_u', 'l_uu', 'l_xu'}

The public functions take tensors or arrays, positionally or by name (with
the integrator-style aliases ``x0=`` and ``p=``), and return float32 tensors
on the model's device. ``fc_fn``, ``fd_fn``, ``g_fn``, ``df_fn`` and
``loss_fn`` are the raw functions of one (x, u), strictly positional, for
controllers that compose them under ``torch.func.vmap``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from safe_control_gym_tpu_torch.envs.dynamics import rk4_step

__all__ = ['AnalyticModel']

_KWARG_ALIASES = {'x0': 'x', 'p': 'u'}


def _vec(a, device):
    """``a`` as a float32 vector (at least 1-d, squeezed) on ``device``."""
    if isinstance(a, torch.Tensor):
        t = a.to(device=device, dtype=torch.float32)
    else:
        t = torch.as_tensor(np.asarray(a, np.float32), device=device)
    return torch.atleast_1d(t.squeeze())


def _positional_or_kw(fn, names, device):
    """``fn(*vectors)`` that also takes the arguments by name."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if kwargs:
            kwargs = {_KWARG_ALIASES.get(k, k): v for k, v in kwargs.items()}
            args = args + tuple(kwargs[n] for n in names[len(args):])
        return fn(*(_vec(a, device) for a in args))
    return wrapper


class AnalyticModel:
    """Differentiable prior model of a system: dynamics, cost, derivatives."""

    def __init__(self,
                 dyn_fn: Callable,
                 nx: int,
                 nu: int,
                 dt: float,
                 obs_fn: Optional[Callable] = None,
                 params: Optional[Dict[str, Any]] = None,
                 integration_algo: str = 'rk4',
                 integration_substeps: int = 1,
                 device='cpu'):
        """
        Args:
            dyn_fn: continuous dynamics ``f(x, u) -> x_dot`` of tensors, its
                parameters bound (tensors on ``device``).
            nx, nu: state and input dims. dt: the control timestep.
            obs_fn: observation ``g(x, u) -> y``; the state if None.
            params: prior properties (with X_EQ and U_EQ), each also set as
                an attribute.
            integration_algo: 'rk4' (default) or 'euler'.
            integration_substeps: inner steps of ``fd_func`` over one dt.
            device: where the model's inputs and results live.
        """
        self.nx, self.nu = nx, nu
        self.dt = float(dt)
        self.integration_algo = integration_algo
        self.device = torch.device(device)
        self._dyn = dyn_fn
        self._obs = obs_fn if obs_fn is not None else (lambda x, u: x)
        self.ny = nx if obs_fn is None else int(obs_fn(
            torch.zeros(nx, device=self.device), torch.zeros(nu, device=self.device)).shape[0])
        self.params = dict(params or {})
        for name, param in self.params.items():
            assert name not in self.__dict__
            setattr(self, name, param)

        sub = max(1, int(integration_substeps))
        h = self.dt / sub

        def _fc(x, u):
            return dyn_fn(x, u)

        def _fd(x, u):
            for _ in range(sub):
                if integration_algo == 'euler':
                    x = x + h * dyn_fn(x, u)
                else:
                    x = rk4_step(lambda s, a, _p: dyn_fn(s, a), x, u, h, None)
            return x

        def _g(x, u):
            return self._obs(x, u)

        def _df(x, u):
            return {'dfdx': jacfwd(_fc, argnums=0)(x, u),
                    'dfdu': jacfwd(_fc, argnums=1)(x, u)}

        def _dg(x, u):
            return {'dgdx': jacfwd(_g, argnums=0)(x, u),
                    'dgdu': jacfwd(_g, argnums=1)(x, u)}

        def _fc_linear(x_eval, u_eval, x, u):
            d = _df(x, u)
            return _fc(x, u) + d['dfdx'] @ (x_eval - x) + d['dfdu'] @ (u_eval - u)

        def _fd_linear(x_eval, u_eval, x, u):
            # The frozen linearization integrated over dt (RK4 on the affine ODE).
            lin_dyn = lambda s, _a, _p: _fc_linear(s, u_eval, x, u)
            out = x_eval
            for _ in range(sub):
                out = rk4_step(lin_dyn, out, u_eval, h, None)
            return out

        def _quad_cost(x, u, Xr, Ur, Q, R):
            dx = x - Xr
            du = u - Ur
            return 0.5 * dx @ Q @ dx + 0.5 * du @ R @ du

        def _loss(x, u, Xr, Ur, Q, R):
            args = (x, u, Xr, Ur, Q, R)
            return {'l': _quad_cost(*args),
                    'l_x': grad(_quad_cost, argnums=0)(*args),
                    'l_xx': hessian(_quad_cost, argnums=0)(*args),
                    'l_u': grad(_quad_cost, argnums=1)(*args),
                    'l_uu': hessian(_quad_cost, argnums=1)(*args),
                    'l_xu': jacfwd(grad(_quad_cost, argnums=0), argnums=1)(*args)}

        dev = self.device
        self.fc_func = _positional_or_kw(_fc, ['x', 'u'], dev)
        self.fd_func = _positional_or_kw(_fd, ['x', 'u'], dev)
        self.g_func = _positional_or_kw(_g, ['x', 'u'], dev)
        self.df_func = _positional_or_kw(_df, ['x', 'u'], dev)
        self.dg_func = _positional_or_kw(_dg, ['x', 'u'], dev)
        self.fc_linear_func = _positional_or_kw(_fc_linear, ['x_eval', 'u_eval', 'x', 'u'],
                                                dev)
        self.fd_linear_func = _positional_or_kw(_fd_linear, ['x_eval', 'u_eval', 'x', 'u'],
                                                dev)

        def loss(*args, **kwargs):
            names = ['x', 'u', 'Xr', 'Ur', 'Q', 'R']
            vals = list(args) + [kwargs[n] for n in names[len(args):]] if kwargs \
                else list(args)
            x, u, Xr, Ur = (_vec(v, dev) for v in vals[:4])
            Q, R = (torch.atleast_2d(_vec(v, dev)) for v in vals[4:])
            return _loss(x, u, Xr, Ur, Q, R)

        self.loss = loss
        self.fc_fn = _fc
        self.fd_fn = _fd
        self.g_fn = _g
        self.df_fn = _df
        self.loss_fn = _loss
