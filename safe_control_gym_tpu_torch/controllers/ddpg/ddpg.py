"""DDPG at inference: the deterministic tanh policy of a trained actor.

Port of the inference half of ``safe_control_gym_tpu/controllers/ddpg/ddpg.py``:
the constructor, ``select_action`` (tanh of the actor's output, unscaled to
the action box), ``load`` from a JAX package checkpoint, ``evaluate_fused``
and ``close``. ``learn`` raises until DDPG training lands (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.controllers.base_controller import ActorAgent, RLController
from safe_control_gym_tpu_torch.controllers.ddpg.ddpg_utils import ddpg_actor_forward
from safe_control_gym_tpu_torch.math.networks import mlp_init

__all__ = ['DDPG']


class DDPG(RLController):
    """Deep deterministic policy gradient, at inference."""

    ALGO = 'DDPG'
    LEARN_ITEM = 'ROADMAP Queue 1 item 9'

    def __init__(self, env_func, **kwargs):
        super().__init__(env_func, **kwargs)
        obs_dim = self.env.observation_space.shape[0]
        act_dim = self.env.action_space.shape[0]
        actor = mlp_init(self.gen, obs_dim, act_dim, [int(self.hidden_dim)] * 2,
                         orthogonal=False)
        self.agent = ActorAgent({'actor': actor}, getattr(self, 'activation', 'relu'))
        self.act_low = self._tensor(self.env.action_space.low)
        self.act_high = self._tensor(self.env.action_space.high)

    def select_action(self, obs, info=None):
        """The deterministic action, as numpy float32."""
        with torch.no_grad():
            act = ddpg_actor_forward(self.agent.params['actor'], self._tensor(obs),
                                     self.act_low, self.act_high, self.agent.activation)
        return act.cpu().numpy()
