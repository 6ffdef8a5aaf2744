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

``adam_step`` is plain ``optax.adam(lr)`` with no clip (SAC's and DDPG's
optimizers), and ``polyak`` their soft target update.
"""

from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ['B1', 'B2', 'EPS', 'tree_leaves', 'tree_unflatten', 'adam_init', 'global_norm',
           'clip_by_global_norm', 'adam_update', 'adam_step', 'clip_adam_step', 'select',
           'polyak']

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
    """The pytree shaped as ``like`` with ``leaves`` (``tree_leaves``'s order).
    A list with a ``rebuild`` method (``parallel/sharding.TPMLP``) keeps its
    type."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return t.rebuild(out) if hasattr(t, 'rebuild') else out
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


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor = None) -> List[torch.Tensor]:
    """``grads`` clipped to ``max_norm``; ``norm``, where given, is their
    global norm (split tensors' norm, summed over their shards)."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def adam_update(grads: List[torch.Tensor], state: Dict, lr: float):
    """``(updates, new_state)``: the steps to add to the parameters. Each
    line is one ``torch._foreach`` op over all the leaves (a few kernels on
    the card, not one a leaf), with the per-leaf formulas' roundings."""
    grads = list(grads)
    mu = list(torch._foreach_mul(grads, 1 - B1))
    torch._foreach_add_(mu, torch._foreach_mul(state['mu'], B1))
    nu = list(torch._foreach_mul(grads, grads))
    torch._foreach_mul_(nu, 1 - B2)
    torch._foreach_add_(nu, torch._foreach_mul(state['nu'], B2))
    count = state['count'] + 1
    t = count.to(torch.float32)
    # A Python base: a tensor made from it on the card would be a host copy,
    # which synchronizes the stream.
    c1 = 1 - torch.pow(B1, t)
    c2 = 1 - torch.pow(B2, t)
    denom = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    updates = list(torch._foreach_div(mu, c1))
    torch._foreach_div_(updates, denom)
    torch._foreach_mul_(updates, -lr)
    return updates, {'count': count, 'mu': mu, 'nu': nu}


def adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict, lr: float):
    """One step of ``optax.adam(lr)``: ``(new_params, new_state)``, the new
    parameters detached from any graph."""
    updates, state = adam_update(grads, state, lr)
    return list(torch._foreach_add([p.detach() for p in params], updates)), state


def clip_adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
                   lr: float, max_norm: float, norm: torch.Tensor = None):
    """One step of the chain: ``(new_params, new_state)``; ``norm`` as in
    ``clip_by_global_norm``."""
    updates, state = adam_update(clip_by_global_norm(grads, max_norm, norm), state, lr)
    return list(torch._foreach_add(params, updates)), state


def select(cond: torch.Tensor, new, old):
    """``torch.where(cond, new, old)`` leaf by leaf over equal lists or
    equal optimizer states (``cond`` a 0-dim bool tensor)."""
    if isinstance(new, dict):
        return {k: select(cond, new[k], old[k]) for k in new}
    if isinstance(new, list):
        return [torch.where(cond, n, o) for n, o in zip(new, old)]
    return torch.where(cond, new, old)


def polyak(target, source, tau: float):
    """``(1 - tau) * target + tau * source``, leaf by leaf over two pytrees of
    one shape (a soft target update)."""
    out = list(torch._foreach_mul(tree_leaves(target), 1 - tau))
    torch._foreach_add_(out, torch._foreach_mul(tree_leaves(source), tau))
    return tree_unflatten(target, out)
