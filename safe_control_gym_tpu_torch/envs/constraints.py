"""Constraint framework g(x) <= 0, in PyTorch.

Port of ``safe_control_gym_tpu/envs/constraints.py``: the same class
taxonomy (Quadratic / Linear / Bounded / Default / SymmetricState) over
STATE, INPUT or INPUT_AND_STATE variables, with ``active_dims`` filters,
``strict`` violation, ``tolerance`` and a ``ConstraintList``.

Where the JAX ``sym_func`` maps one variable vector under ``vmap``, here it
maps a batch: (B, dim) to (B, n). ``value_from``/``values_from`` take
(B, nx) states and (B, nu) inputs. ``get_symbolic_constraint_models`` comes
with the symbolic slice.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = [
    'ConstrainedVariableType', 'Constraint', 'QuadraticConstraint',
    'LinearConstraint', 'BoundedConstraint', 'DefaultConstraint',
    'SymmetricStateConstraint', 'ConstraintList', 'GENERAL_CONSTRAINTS',
    'create_constraint_list',
]


class ConstrainedVariableType(str, Enum):
    STATE = 'state'
    INPUT = 'input'
    INPUT_AND_STATE = 'input_and_state'


def _t(a, like):
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device)


class Constraint:
    """Base constraint g(x) <= 0."""

    def __init__(self, env, constrained_variable, strict=False,
                 active_dims=None, tolerance=None, decimals=8, **kwargs):
        self.constrained_variable = ConstrainedVariableType(constrained_variable)
        if self.constrained_variable == ConstrainedVariableType.STATE:
            self.dim = env.state_dim
        elif self.constrained_variable == ConstrainedVariableType.INPUT:
            self.dim = env.action_dim
        else:
            self.dim = env.state_dim + env.action_dim
        self.strict = strict
        self.decimals = decimals
        if active_dims is not None:
            if isinstance(active_dims, int):
                active_dims = [active_dims]
            if (len(active_dims) > self.dim
                    or any(int(n) >= self.dim for n in active_dims)
                    or len(active_dims) != len(set(active_dims))):
                raise ValueError(f'bad active_dims {active_dims} for dim {self.dim}')
            self.constraint_filter = np.eye(self.dim)[[int(n) for n in active_dims]]
            self.dim = len(active_dims)
        else:
            self.constraint_filter = np.eye(self.dim)
        self.tolerance = np.array(tolerance, ndmin=1) if tolerance is not None else None

    def reset(self):
        pass

    def get_symbolic_model(self):
        """The batched function g: (B, dim) -> (B, n)."""
        return self.sym_func

    def _round(self, v):
        scale = 10.0 ** self.decimals
        return torch.round(v * scale) / scale

    def _variable(self, state, inp):
        if self.constrained_variable == ConstrainedVariableType.STATE:
            return state
        if self.constrained_variable == ConstrainedVariableType.INPUT:
            return inp
        return torch.cat([state, inp], dim=-1)

    def value_from(self, state, inp):
        """(B, n) values from (B, nx) states and (B, nu) inputs."""
        return self._round(self.sym_func(self._variable(state, inp)))

    def get_env_constraint_var(self, env):
        if self.constrained_variable == ConstrainedVariableType.STATE:
            return env.state
        if self.constrained_variable == ConstrainedVariableType.INPUT:
            return env.current_noisy_physical_action
        return (env.state, env.current_noisy_physical_action)

    def get_value(self, env):
        """Values for the stateful shim's current state/input (numpy, (n,))."""
        var = self.get_env_constraint_var(env)
        if isinstance(var, tuple):
            var = np.concatenate([np.atleast_1d(v) for v in var])
        var = torch.as_tensor(np.atleast_1d(np.asarray(var, np.float32)))[None]
        return self._round(self.sym_func(var))[0].numpy()

    def is_violated(self, env, c_value=None):
        if c_value is None:
            c_value = self.get_value(env)
        if self.strict:
            return bool(np.any(np.greater_equal(np.asarray(c_value), 0.0)))
        return bool(np.any(np.greater(np.asarray(c_value), 0.0)))

    def is_almost_active(self, env, c_value=None):
        if self.tolerance is None:
            return False
        if c_value is None:
            c_value = self.get_value(env)
        return bool(np.any(np.greater(np.asarray(c_value) + self.tolerance, 0.0)))

    def check_tolerance_shape(self):
        if self.tolerance is not None and len(self.tolerance) != self.num_constraints:
            raise ValueError('[ERROR] tolerance dim != num_constraints.')


class QuadraticConstraint(Constraint):
    """x' P x <= b."""

    def __init__(self, env, P, b, constrained_variable, strict=False,
                 active_dims=None, tolerance=None, decimals=8):
        super().__init__(env, constrained_variable, strict=strict,
                         active_dims=active_dims, tolerance=tolerance,
                         decimals=decimals)
        P = np.array(P, ndmin=2)
        if P.shape != (self.dim, self.dim):
            raise ValueError(f'P must be {self.dim}x{self.dim}, got {P.shape}')
        self.P = P
        self.b = float(b)
        self.num_constraints = 1
        F = np.asarray(self.constraint_filter, np.float32)
        P32 = np.asarray(P, np.float32)

        def sym_func(x):
            y = x @ _t(F, x).T
            return ((y @ _t(P32, x)) * y).sum(-1, keepdim=True) - self.b
        self.sym_func = sym_func
        self.check_tolerance_shape()


class LinearConstraint(Constraint):
    """A x <= b."""

    def __init__(self, env, A, b, constrained_variable, strict=False,
                 active_dims=None, tolerance=None, decimals=8):
        super().__init__(env, constrained_variable, strict=strict,
                         active_dims=active_dims, tolerance=tolerance,
                         decimals=decimals)
        A = np.asarray(A, dtype=np.float32).reshape(-1, self.dim)
        b = np.asarray(b, dtype=np.float32).reshape(-1)
        if b.shape[0] != A.shape[0]:
            raise ValueError('A and b disagree on the number of constraints')
        self.A = A
        self.b = b
        self.num_constraints = A.shape[0]
        AF = A @ np.asarray(self.constraint_filter, np.float32)
        self.sym_func = lambda x: x @ _t(AF, x).T - _t(b, x)
        self.check_tolerance_shape()


class BoundedConstraint(LinearConstraint):
    """lb <= x <= ub as stacked linear constraints."""

    def __init__(self, env, lower_bounds, upper_bounds, constrained_variable,
                 strict=False, active_dims=None, tolerance=None, decimals=8):
        self.lower_bounds = np.array(lower_bounds, ndmin=1)
        self.upper_bounds = np.array(upper_bounds, ndmin=1)
        dim = self.lower_bounds.shape[0]
        A = np.vstack((-np.eye(dim), np.eye(dim)))
        b = np.hstack((-self.lower_bounds, self.upper_bounds))
        super().__init__(env, A, b, constrained_variable, strict=strict,
                         active_dims=active_dims, tolerance=tolerance,
                         decimals=decimals)
        self.check_tolerance_shape()


class DefaultConstraint(BoundedConstraint):
    """Bounds from the env's state space or physical action bounds."""

    def __init__(self, env, constrained_variable, lower_bounds=None,
                 upper_bounds=None, strict=False, tolerance=None, decimals=8):
        constrained_variable = ConstrainedVariableType(constrained_variable)
        if constrained_variable == ConstrainedVariableType.STATE:
            space = getattr(env, 'state_space', None) or env.observation_space
            lo, hi = space.low, space.high
        elif constrained_variable == ConstrainedVariableType.INPUT:
            lo, hi = env.physical_action_bounds
        else:
            raise NotImplementedError(
                '[ERROR] DefaultConstraint can only be STATE or INPUT.')
        upper_bounds = (np.asarray(hi) if upper_bounds is None
                        else np.array(upper_bounds, ndmin=1))
        lower_bounds = (np.asarray(lo) if lower_bounds is None
                        else np.array(lower_bounds, ndmin=1))
        if (len(upper_bounds) != len(np.atleast_1d(hi))
                or len(lower_bounds) != len(np.atleast_1d(lo))):
            raise ValueError('default constraint bounds have the wrong length')
        super().__init__(env, lower_bounds.astype(np.float64),
                         upper_bounds.astype(np.float64), constrained_variable,
                         strict=strict, active_dims=None, tolerance=tolerance,
                         decimals=decimals)


class SymmetricStateConstraint(BoundedConstraint):
    """|x| <= b on the state."""

    def __init__(self, env, constrained_variable, bound, strict=False,
                 active_dims=None, tolerance=None, decimals=8, **kwargs):
        if bound is None:
            raise ValueError('SymmetricStateConstraint needs a bound')
        self.bound = np.array(bound, ndmin=1)
        super().__init__(env, lower_bounds=-self.bound, upper_bounds=self.bound,
                         constrained_variable=constrained_variable,
                         strict=strict, active_dims=active_dims,
                         tolerance=tolerance, decimals=decimals)
        self.num_constraints = self.bound.shape[0]
        F = np.asarray(self.constraint_filter, np.float32)
        bound32 = np.asarray(self.bound, np.float32)
        self.sym_func = lambda x: torch.abs(x @ _t(F, x).T) - _t(bound32, x)

    def value_from(self, state, inp):
        return self._round(self.sym_func(state))

    def get_value(self, env):
        x = torch.as_tensor(np.asarray(env.state, np.float32))[None]
        return self._round(self.sym_func(x))[0].numpy()

    def check_tolerance_shape(self):
        if self.tolerance is not None and len(self.tolerance) != len(self.bound):
            raise ValueError('[ERROR] tolerance dim != num constraints.')


class ConstraintList:
    """Collection of constraints with stacked, batched evaluation."""

    def __init__(self, constraints: Sequence[Constraint]):
        self.constraints = list(constraints)
        self.constraint_lengths = [con.num_constraints for con in self.constraints]
        self.constraint_indices = np.cumsum([0] + self.constraint_lengths)
        self.num_constraints = int(sum(self.constraint_lengths))
        by_type = {t: [c for c in self.constraints if c.constrained_variable == t]
                   for t in ConstrainedVariableType}
        self.state_constraints = by_type[ConstrainedVariableType.STATE]
        self.input_constraints = by_type[ConstrainedVariableType.INPUT]
        self.input_state_constraints = by_type[ConstrainedVariableType.INPUT_AND_STATE]
        self.num_state_constraints = sum(c.num_constraints for c in self.state_constraints)
        self.num_input_constraints = sum(c.num_constraints for c in self.input_constraints)
        self.num_input_state_constraints = sum(
            c.num_constraints for c in self.input_state_constraints)

    def __len__(self):
        return len(self.constraints)

    def get_all_symbolic_models(self):
        return [con.get_symbolic_model() for con in self.constraints]

    def get_state_constraint_symbolic_models(self):
        return [con.get_symbolic_model() for con in self.state_constraints]

    def get_input_constraint_symbolic_models(self):
        return [con.get_symbolic_model() for con in self.input_constraints]

    def values_from(self, state, inp):
        """(B, num_constraints) stacked values."""
        if not self.constraints:
            return state.new_zeros((state.shape[0], 0))
        return torch.cat([con.value_from(state, inp) for con in self.constraints],
                         dim=-1)

    def get_values(self, env, only_state=False):
        cons = self.state_constraints if only_state else self.constraints
        if not cons:
            return np.zeros(0)
        return np.concatenate([np.atleast_1d(con.get_value(env)) for con in cons])

    def _split(self, c_value):
        return [np.asarray(c_value)[self.constraint_indices[i]:self.constraint_indices[i + 1]]
                for i in range(len(self.constraints))]

    def is_violated(self, env, c_value=None):
        if c_value is not None:
            return any(con.is_violated(env, c_value=cv)
                       for con, cv in zip(self.constraints, self._split(c_value)))
        return any(con.is_violated(env) for con in self.constraints)

    def violated_mask(self, c_value):
        """(B,) bool: any constraint of the row violated (``strict`` ones at 0)."""
        mask = torch.zeros(c_value.shape[0], dtype=torch.bool, device=c_value.device)
        i = 0
        for con in self.constraints:
            cv = c_value[:, i:i + con.num_constraints]
            mask = mask | ((cv >= 0.0) if con.strict else (cv > 0.0)).any(dim=1)
            i += con.num_constraints
        return mask

    def is_almost_active(self, env, c_value=None):
        if c_value is not None:
            return any(con.is_almost_active(env, c_value=cv)
                       for con, cv in zip(self.constraints, self._split(c_value)))
        return any(con.is_almost_active(env) for con in self.constraints)


GENERAL_CONSTRAINTS = {
    'linear_constraint': LinearConstraint,
    'quadratic_constraint': QuadraticConstraint,
    'bounded_constraint': BoundedConstraint,
    'default_constraint': DefaultConstraint,
}


def create_constraint_list(constraint_specs: Sequence[Dict[str, Any]],
                           available_constraints: Dict[str, Any], env
                           ) -> Optional[ConstraintList]:
    """A ConstraintList from config spec dicts (each with a ``constraint_form``)."""
    constraint_list = []
    for constraint in constraint_specs:
        if not isinstance(constraint, dict) or 'constraint_form' not in constraint:
            raise ValueError('[ERROR]: Each constraint must be a dict with a '
                             'constraint_form.')
        con_form = constraint['constraint_form']
        if con_form not in available_constraints:
            raise ValueError(f'[ERROR]: Unknown constraint form {con_form}.')
        cfg = {k: v for k, v in constraint.items() if k != 'constraint_form'}
        constraint_list.append(available_constraints[con_form](env, **cfg))
    return ConstraintList(constraint_list)
