"""The DDPG actor at inference: a deterministic tanh policy, unscaled to the action box.

Port of ``ddpg_actor_forward`` of
``safe_control_gym_tpu/controllers/ddpg/ddpg_utils.py``. ``DDPGAgent``, its Q
network and the exploration processes come with ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.math.networks import mlp_apply

__all__ = ['ddpg_actor_forward']


def ddpg_actor_forward(actor_params, obs, act_low, act_high, activation='relu'):
    """tanh of the actor's output mapped affinely from [-1, 1] onto
    [act_low, act_high]."""
    a = torch.tanh(mlp_apply(actor_params, obs, activation))
    return act_low + 0.5 * (a + 1.0) * (act_high - act_low)
