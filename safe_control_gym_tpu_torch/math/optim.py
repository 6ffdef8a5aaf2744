"""Functional Adam behind a global-norm gradient clip, over lists of tensors.

The port's copy of the optimizer the JAX package's PPO builds with
``optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))``
(``safe_control_gym_tpu/controllers/ppo/ppo_utils.py:117-122``), in optax's
order of operations:

* the clip keeps the gradients where their global norm is below
  ``max_norm`` (strictly), else scales each to ``(g / norm) * max_norm``;
* Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  ``count + 1``, the update ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with the
  bias-corrected moments (b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0).

The optimizer runs over the leaves of a parameter pytree in JAX's order
(``tree_leaves``), the order the global norm sums in. The state
``{'count', 'mu', 'nu'}`` is a value: ``clip_adam_step`` returns a
new one and leaves its input alone, so a caller can keep the old state and
pick between the two with ``torch.where`` (PPO's KL gate rejects a whole
actor step, the optimizer state included). ``torch.optim.Adam`` and
``clip_grad_norm_`` differ: they step in place, and the clip multiplies by
``max_norm / (norm + 1e-6)``.

    state = adam_init(params)                       # params: a list of tensors
    params, state = clip_adam_step(params, grads, state, lr=3e-4, max_norm=0.5)
"""

from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ['B1', 'B2', 'EPS', 'tree_leaves', 'tree_unflatten', 'adam_init', 'global_norm',
           'clip_by_global_norm', 'adam_update', 'clip_adam_step', 'select']

B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a parameter pytree in JAX's order (dict keys sorted,
    lists in order), which ``global_norm`` sums in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The pytree shaped as ``like`` with ``leaves`` (``tree_leaves``'s order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def adam_init(params: List[torch.Tensor]) -> Dict:
    """Count 0 (int32) and zero moments shaped as ``params``."""
    return {'count': torch.zeros((), dtype=torch.int32, device=params[0].device),
            'mu': [torch.zeros_like(p) for p in params],
            'nu': [torch.zeros_like(p) for p in params]}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt`` of the sum of every element's square, summed tensor by tensor."""
    total = 0
    for t in tensors:
        total = total + torch.sum(t * t)
    return torch.sqrt(total)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def adam_update(grads: List[torch.Tensor], state: Dict, lr: float):
    """``(updates, new_state)``: the steps to add to the parameters."""
    mu = [(1 - B1) * g + B1 * m for g, m in zip(grads, state['mu'])]
    nu = [(1 - B2) * (g * g) + B2 * v for g, v in zip(grads, state['nu'])]
    count = state['count'] + 1
    t = count.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=t.device), t)
    updates = [-lr * ((m / c1) / (torch.sqrt(v / c2) + EPS)) for m, v in zip(mu, nu)]
    return updates, {'count': count, 'mu': mu, 'nu': nu}


def clip_adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
                   lr: float, max_norm: float):
    """One step of the chain: ``(new_params, new_state)``."""
    updates, state = adam_update(clip_by_global_norm(grads, max_norm), state, lr)
    return [p + u for p, u in zip(params, updates)], state


def select(cond: torch.Tensor, new, old):
    """``torch.where(cond, new, old)`` leaf by leaf over equal lists or
    equal optimizer states (``cond`` a 0-dim bool tensor)."""
    if isinstance(new, dict):
        return {k: select(cond, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [torch.where(cond, n, o) for n, o in zip(new, old)]
    return torch.where(cond, new, old)
