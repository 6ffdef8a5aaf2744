"""The SAC actor at inference: a tanh-squashed Gaussian, unscaled to the action box.

Port of ``sac_actor_forward`` of
``safe_control_gym_tpu/controllers/sac/sac_utils.py``. The actor MLP puts out
[mean, log-std] in one layer of 2 * act_dim. ``SACAgent``, the Q networks'
update and the replay ring come with ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from safe_control_gym_tpu_torch.math.networks import mlp_apply

__all__ = ['LOG_STD_MIN', 'LOG_STD_MAX', 'sac_actor_forward']

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def sac_actor_forward(actor_params, obs, gen, act_low, act_high, activation='relu',
                      deterministic=False, with_logprob=True):
    """``(action, logp)``: tanh of the mean (``deterministic``) or of a draw
    from ``gen``, mapped affinely from [-1, 1] onto [act_low, act_high];
    ``logp`` is None unless ``with_logprob``."""
    out = mlp_apply(actor_params, obs, activation)
    mu, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    if deterministic:
        pre = mu
    else:
        noise = torch.randn(mu.shape, generator=gen, device=gen.device).to(mu.device)
        pre = mu + std * noise
    logp = None
    if with_logprob:
        logp = torch.sum(-0.5 * ((pre - mu) / std) ** 2 - log_std
                         - 0.5 * math.log(2 * math.pi), dim=-1, keepdim=True)
        # The tanh correction.
        logp = logp - torch.sum(2 * (math.log(2.0) - pre - F.softplus(-2 * pre)),
                                dim=-1, keepdim=True)
    action = torch.tanh(pre)
    return act_low + 0.5 * (action + 1.0) * (act_high - act_low), logp
