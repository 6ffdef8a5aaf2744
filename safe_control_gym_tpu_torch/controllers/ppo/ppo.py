"""PPO at inference: the deterministic or sampled Gaussian policy of a trained actor.

Port of the inference half of ``safe_control_gym_tpu/controllers/ppo/ppo.py``:
the constructor, ``select_action`` (the mode of the actor's Gaussian on the
obs, normalized by the frozen normalizer where the config has ``norm_obs``),
``load`` from a JAX package checkpoint, ``evaluate_fused`` and ``close``.
``learn`` raises until PPO training lands (ROADMAP Queue 1 item 8).

    ctrl = make('ppo', partial(make, 'cartpole', device='cuda', **task_config),
                **algo_config)
    ctrl.load('examples/rl/models/ppo/ppo_model_cartpole_stab.pt')
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.controllers.base_controller import (ActorAgent,
                                                                     RLEvalController)
from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import (actor_dist,
                                                                  init_actor_critic)
from safe_control_gym_tpu_torch.math.normalization import rms_normalize

__all__ = ['PPO']


class PPO(RLEvalController):
    """Proximal policy optimization, at inference."""

    ALGO = 'PPO'
    LEARN_ITEM = 'ROADMAP Queue 1 item 8'

    def __init__(self, env_func, **kwargs):
        super().__init__(env_func, **kwargs)
        obs_dim = self.env.observation_space.shape[0]
        act_dim = self.env.action_space.shape[0]
        self.agent = ActorAgent(init_actor_critic(self.gen, obs_dim, act_dim,
                                                  [int(self.hidden_dim)] * 2),
                                self.activation)
        self.obs_norm_state = None   # the frozen normalizer, from a checkpoint

    def select_action(self, obs, info=None):
        """The mode action on the (normalized) obs, as numpy float32."""
        obs = self._obs(obs)
        if self.norm_obs and self.obs_norm_state is not None:
            obs = rms_normalize(self.obs_norm_state, obs, float(self.clip_obs))
        with torch.no_grad():
            act = actor_dist(self.agent.params, obs, self.agent.activation).mode()
        return act.cpu().numpy()
