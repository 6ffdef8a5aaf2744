"""The safety layer of safe exploration (Dalal et al. 2018) and its constraint buffer.

Port of ``safe_control_gym_tpu/controllers/safe_explorer/safe_explorer_utils.py``.
Each of the C constraints has a linear model of its next value, ``c' ~ c +
g_i(obs) . a``, with ``g_i`` a one-hidden-layer relu MLP. The C MLPs are one
stacked parameter list (each leaf with a leading axis of C), so that one
batched forward (``torch.bmm``) gives every ``g_i``. ``SafetyLayer`` fits
them by the sum of the C mean squared errors with Adam (optax's defaults,
``math/optim.adam_step``) and projects an action in closed form
(``get_safe_action``): the largest of the C Lagrange multipliers
``relu((g_i . a + c_i + slack_i) / (g_i . g_i + 1e-8))``, ties to the first
constraint as ``argmax`` breaks them, times its ``g_i``, is taken off the
action. ``ConstraintBuffer`` is the replay ring of (obs, act, c, c_next)
transitions (``controllers/off_policy_utils.py``).

    layer = SafetyLayer(obs_space, act_space, num_constraints=4, device='cuda')
    losses = layer.update(buffer.sample(gen))
    safe = layer.get_safe_action(obs, act, c)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.off_policy_utils import (replay_init, replay_push,
                                                                     replay_sample)
from safe_control_gym_tpu_torch.math import optim
from safe_control_gym_tpu_torch.math.networks import mlp_init
from safe_control_gym_tpu_torch.math.optim import tree_leaves, tree_unflatten
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['g_all', 'SafetyLayer', 'ConstraintBuffer']


def g_all(params, obs):
    """(C, B, act_dim) sensitivities of every constraint on ``obs`` (B,
    obs_dim) from the stacked relu MLPs ``params`` (w (C, in, out), b (C,
    out))."""
    h = obs.expand(params[0]['w'].shape[0], *obs.shape)
    for layer in params[:-1]:
        h = torch.relu(torch.bmm(h, layer['w']) + layer['b'][:, None, :])
    return torch.bmm(h, params[-1]['w']) + params[-1]['b'][:, None, :]


class SafetyLayer:
    """C per-constraint sensitivity models, their fit and the projection."""

    def __init__(self, obs_space, act_space, hidden_dim=10, num_constraints=1, lr=0.001,
                 slack=None, seed=0, device='cuda', **kwargs):
        self.device = resolve_device(device)
        self.num_constraints = int(num_constraints)
        self.obs_dim = obs_space.shape[0]
        self.act_dim = act_space.shape[0]
        self.lr = lr
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        layers = [mlp_init(gen, self.obs_dim, self.act_dim, [int(hidden_dim)], orthogonal=False)
                  for _ in range(self.num_constraints)]
        self.params = [{k: torch.stack([m[i][k] for m in layers]) for k in ('w', 'b')}
                       for i in range(len(layers[0]))]
        if slack is None:
            slack = [0.0] * self.num_constraints
        elif np.isscalar(slack):
            slack = [float(slack)] * self.num_constraints
        if len(slack) != self.num_constraints:
            raise ValueError(f'{len(slack)} slacks for {self.num_constraints} constraints')
        self.slack = torch.tensor(np.asarray(slack, np.float32), device=self.device)
        self.opt_state = optim.adam_init(tree_leaves(self.params))

    def _losses(self, params, batch):
        """The C mean squared errors of the models on ``batch``."""
        g = g_all(params, batch['obs'])                                  # (C, B, A)
        pred = batch['c'].T + torch.einsum('cba,ba->cb', g, batch['act'])
        return torch.mean((batch['c_next'].T - pred) ** 2, dim=1)

    def compute_loss(self, batch) -> torch.Tensor:
        """The C losses, unread."""
        with torch.no_grad():
            return self._losses(self.params, batch)

    def update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One Adam step on the sum of the C losses; returns the C losses
        before the step, unread."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params)]
        with torch.enable_grad():
            losses = self._losses(tree_unflatten(self.params, leaves), batch)
            grads = torch.autograd.grad(losses.sum(), leaves)
        new, self.opt_state = optim.adam_step(leaves, grads, self.opt_state, self.lr)
        self.params = tree_unflatten(self.params, new)
        return losses.detach()

    @torch.no_grad()
    def get_safe_action(self, obs, act, c):
        """The projected actions of ``act`` on ``obs`` with constraint values
        ``c`` (single rows or batches; tensors or arrays); returns a (B,
        act_dim) tensor."""
        def as2d(x):
            x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))
            return torch.atleast_2d(x.to(self.device, torch.float32))
        obs, act, c = as2d(obs), as2d(act), as2d(c)
        g = g_all(self.params, obs)                                      # (C, B, A)
        numer = torch.einsum('cba,ba->bc', g, act) + c + self.slack[None, :]
        denom = torch.einsum('cba,cba->cb', g, g).T + 1e-8
        mult = torch.relu(numer / denom)                                 # (B, C)
        # argmax breaks ties to the first index, as jnp.argmax does.
        max_idx = torch.argmax(mult, dim=-1)
        max_mult = torch.gather(mult, 1, max_idx[:, None])
        max_g = g.permute(1, 0, 2)[torch.arange(g.shape[1], device=g.device), max_idx]
        return act - max_mult * max_g

    def state_dict(self):
        from safe_control_gym_tpu_torch.utils.convert import adam_state_to_numpy, tree_to_numpy
        return {'params': tree_to_numpy(self.params),
                'opt_state': adam_state_to_numpy(self.opt_state)}

    def load_state_dict(self, sd):
        """From ``state_dict``'s layout or the JAX package's."""
        from safe_control_gym_tpu_torch.utils.convert import adam_state_from_numpy, tree_from_numpy
        self.params = tree_from_numpy(sd['params'], self.device)
        self.opt_state = adam_state_from_numpy(sd['opt_state'], self.device)


class ConstraintBuffer:
    """The ring of (obs, act, c, c_next) transitions the safety layer fits on."""

    def __init__(self, obs_dim, act_dim, num_constraints, max_size, batch_size=64,
                 device='cuda'):
        self.batch_size = int(batch_size)
        self.state = replay_init({'obs': obs_dim, 'act': act_dim, 'c': num_constraints,
                                  'c_next': num_constraints}, int(max_size), device=device)

    def push(self, batch):
        replay_push(self.state, batch)

    def sample(self, gen: torch.Generator, batch_size=None):
        return replay_sample(self.state, gen, batch_size or self.batch_size)
