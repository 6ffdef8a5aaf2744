"""The PPO actor-critic at inference: init, the actor's distribution and the critic.

Port of ``init_actor_critic``, ``actor_dist`` and ``critic_value`` of
``safe_control_gym_tpu/controllers/ppo/ppo_utils.py``. The parameters are the
JAX package's pytree as tensors: ``{'actor': [...], 'critic': [...],
'logstd': (act_dim,)}`` with the layer layout of ``math/networks.py``.
``PPOAgent`` and its update come with PPO training (ROADMAP Queue 1 item 8),
and so does the discrete (Categorical) actor.
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.math.distributions import Normal
from safe_control_gym_tpu_torch.math.networks import mlp_apply, mlp_init

__all__ = ['init_actor_critic', 'actor_dist', 'critic_value']


def init_actor_critic(gen: torch.Generator, obs_dim: int, act_dim: int, hidden_dims,
                      init_logstd: float = -0.5, device=None):
    """Actor (MLP -> mean, with a learned logstd) and critic MLP parameters
    drawn from ``gen``."""
    device = gen.device if device is None else torch.device(device)
    return {
        'actor': mlp_init(gen, obs_dim, act_dim, hidden_dims, device=device),
        'critic': mlp_init(gen, obs_dim, 1, hidden_dims, out_gain=1.0, device=device),
        'logstd': torch.full((act_dim,), init_logstd, device=device),
    }


def actor_dist(params, obs, activation='tanh'):
    """The Gaussian policy on ``obs``: the actor's output as mean,
    ``exp(logstd)`` as std."""
    if 'logstd' not in params:
        raise NotImplementedError('the discrete PPO actor comes with PPO training '
                                  '(ROADMAP Queue 1 item 8)')
    return Normal(mlp_apply(params['actor'], obs, activation), torch.exp(params['logstd']))


def critic_value(params, obs, activation='tanh'):
    return mlp_apply(params['critic'], obs, activation)
