"""The MLP of the RL actors and critics: init from an explicit generator, and apply.

Port of ``mlp_init`` and ``mlp_apply`` of ``safe_control_gym_tpu/math/networks.py``.
The parameters keep the JAX package's layout, a list with one dict per layer,
``w`` of shape (in, out) and ``b`` of shape (out,), so that a JAX checkpoint
carries across as a copy (``utils/convert.py``). ``MLP`` wraps such a list in
an ``nn.Module``.

    params = mlp_init(torch.Generator().manual_seed(0), 4, 1, [64, 64])
    out = mlp_apply(params, obs, 'tanh')
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

__all__ = ['ACTIVATIONS', 'mlp_init', 'mlp_apply', 'MLP']

ACTIVATIONS = {
    'tanh': torch.tanh,
    'relu': torch.relu,
    'elu': nn.functional.elu,
    'gelu': nn.functional.gelu,
    'sigmoid': torch.sigmoid,
    'identity': lambda x: x,
}


def _orthogonal(gen, shape, gain, device):
    """Orthogonal init: the Q factor of a Gaussian matrix, signs fixed by R's
    diagonal, scaled by ``gain``."""
    n_rows, n_cols = shape
    mat = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)), generator=gen,
                      device=gen.device)
    q, r = torch.linalg.qr(mat)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return (gain * q[:n_rows, :n_cols]).to(device=device, dtype=torch.float32)


def mlp_init(gen: torch.Generator, in_dim: int, out_dim: int,
             hidden_dims: Sequence[int], init_std: float = float(np.sqrt(2)),
             out_gain: float = 0.01, orthogonal: bool = True, device=None):
    """MLP parameters drawn from ``gen``: orthogonal weights (gain ``init_std``,
    ``out_gain`` on the last layer) or uniform in +-1/sqrt(fan_in), zero
    biases. The tensors go to ``device`` (default: the generator's)."""
    device = gen.device if device is None else torch.device(device)
    dims = [in_dim] + list(hidden_dims) + [out_dim]
    params = []
    for i in range(len(dims) - 1):
        shape = (dims[i], dims[i + 1])
        if orthogonal:
            gain = out_gain if i == len(dims) - 2 else init_std
            w = _orthogonal(gen, shape, gain, device)
        else:
            bound = 1.0 / np.sqrt(dims[i])
            w = (torch.rand(shape, generator=gen, device=gen.device) * (2 * bound)
                 - bound).to(device)
        params.append({'w': w, 'b': torch.zeros(dims[i + 1], device=device)})
    return params


def mlp_apply(params, x, activation: str = 'tanh', out_activation: str = 'identity'):
    """Forward pass over any leading batch shape. A tensor-parallel layer
    list (``parallel/sharding.TPMLP``) runs its own pass, with the model
    axis's collectives."""
    if hasattr(params, 'apply'):
        return params.apply(x, activation, out_activation)
    act, out_act = ACTIVATIONS[activation], ACTIVATIONS[out_activation]
    h = x
    for layer in params[:-1]:
        h = act(torch.matmul(h, layer['w']) + layer['b'])
    return out_act(torch.matmul(h, params[-1]['w']) + params[-1]['b'])


class MLP(nn.Module):
    """An ``nn.Module`` over the parameter list of :func:`mlp_init`."""

    def __init__(self, params, activation: str = 'tanh',
                 out_activation: str = 'identity'):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(torch.as_tensor(p['w'])) for p in params])
        self.b = nn.ParameterList([nn.Parameter(torch.as_tensor(p['b'])) for p in params])
        self.activation = activation
        self.out_activation = out_activation

    def layers(self):
        """The parameters in :func:`mlp_init`'s layout."""
        return [{'w': w, 'b': b} for w, b in zip(self.w, self.b)]

    def forward(self, x):
        return mlp_apply(self.layers(), x, self.activation, self.out_activation)
