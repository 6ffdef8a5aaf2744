"""The networks of the RL agents: init from an explicit generator, and apply.

Port of ``safe_control_gym_tpu/math/networks.py``: the MLP of the actors and
critics (``mlp_init``, ``mlp_apply``), the conv stack with a dense head
(``cnn_init``, ``cnn_apply``) and the GRU cell run over masked sequences
(``rnn_init``, ``rnn_apply``). The parameters keep the JAX package's layout,
so that a JAX checkpoint carries across as a copy (``utils/convert.py``): an
MLP is a list with one dict per layer, ``w`` of shape (in, out) and ``b`` of
shape (out,); a CNN is ``{'convs': [{'w': (k, k, c_in, c_out), 'b'}, ...],
'head': <MLP>, 'strides': (...)}`` over NHWC images; a GRU is ``{'wi': (in,
3H), 'wh': (H, 3H), 'b': (3H,)}`` with the gates in the order r, z, n.
``MLP`` wraps a layer list in an ``nn.Module``.

    params = mlp_init(torch.Generator().manual_seed(0), 4, 1, [64, 64])
    out = mlp_apply(params, obs, 'tanh')
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

__all__ = ['ACTIVATIONS', 'mlp_init', 'mlp_apply', 'MLP', 'cnn_init', 'cnn_apply',
           'rnn_init', 'rnn_apply']

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


def _uniform(gen, shape, bound, device):
    """Uniform in [-bound, bound) from ``gen``, on ``device``."""
    return (torch.rand(shape, generator=gen, device=gen.device) * (2 * bound)
            - bound).to(device)


def cnn_init(gen: torch.Generator, input_hwc, out_dim: int, channels=(32, 64),
             kernel_sizes=(8, 4), strides=(4, 2), device=None):
    """A conv stack (VALID padding, uniform weights in +-1/sqrt(fan_in), zero
    biases) and a dense head sized from the (H, W, C) input."""
    device = gen.device if device is None else torch.device(device)
    H, W, c_in = input_hwc
    convs = []
    for c_out, ks, st in zip(channels, kernel_sizes, strides):
        bound = 1.0 / np.sqrt(c_in * ks * ks)
        convs.append({'w': _uniform(gen, (ks, ks, c_in, c_out), bound, device),
                      'b': torch.zeros(c_out, device=device)})
        c_in = c_out
        H = (H - ks) // st + 1
        W = (W - ks) // st + 1
    head = mlp_init(gen, H * W * c_in, out_dim, [], orthogonal=False, device=device)
    return {'convs': convs, 'head': head, 'strides': tuple(strides)}


def cnn_apply(params, x, activation: str = 'relu'):
    """An NHWC image batch through the convs and the dense head (flattened
    in NHWC order, as the JAX package's)."""
    act = ACTIVATIONS[activation]
    h = x.permute(0, 3, 1, 2)
    for conv, stride in zip(params['convs'], params['strides']):
        h = nn.functional.conv2d(h, conv['w'].permute(3, 2, 0, 1), stride=stride)
        h = act(h + conv['b'][:, None, None])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return mlp_apply(params['head'], h, activation='identity')


def rnn_init(gen: torch.Generator, in_dim: int, hidden_dim: int, device=None):
    """GRU cell parameters, uniform in +-1/sqrt(hidden_dim), zero biases."""
    device = gen.device if device is None else torch.device(device)
    scale = 1.0 / np.sqrt(hidden_dim)
    return {'wi': _uniform(gen, (in_dim, 3 * hidden_dim), scale, device),
            'wh': _uniform(gen, (hidden_dim, 3 * hidden_dim), scale, device),
            'b': torch.zeros(3 * hidden_dim, device=device)}


def rnn_apply(params, x_seq, h0, masks=None):
    """The GRU over a (T, B, in_dim) sequence from ``h0`` (B, H); ``masks``
    (T, B, 1) zero the hidden state where an episode starts. Returns the
    hidden states (T, B, H) and the last one."""
    if masks is None:
        masks = torch.ones(x_seq.shape[:-1] + (1,), dtype=x_seq.dtype, device=x_seq.device)
    h, hs = h0, []
    for x, m in zip(x_seq, masks):
        h = h * m
        rx, zx, nx = torch.chunk(x @ params['wi'] + params['b'], 3, dim=-1)
        rh, zh, nh = torch.chunk(h @ params['wh'], 3, dim=-1)
        r = torch.sigmoid(rx + rh)
        z = torch.sigmoid(zx + zh)
        n = torch.tanh(nx + r * nh)
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs), h


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
