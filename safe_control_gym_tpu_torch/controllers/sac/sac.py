"""SAC at inference: the deterministic tanh policy of a trained actor.

Port of the inference half of ``safe_control_gym_tpu/controllers/sac/sac.py``:
the constructor, ``select_action`` (tanh of the actor's mean, unscaled to the
action box), ``load`` from a JAX package checkpoint, ``evaluate_fused`` and
``close``. ``learn`` raises until SAC training lands (ROADMAP Queue 1 item 9).

    ctrl = make('sac', partial(make, 'quadrotor', device='cuda', **task_config),
                **algo_config)
    ctrl.load('examples/rl/models/sac/sac_model_quadrotor_3D_stab.pt')
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.controllers.base_controller import ActorAgent, RLController
from safe_control_gym_tpu_torch.controllers.sac.sac_utils import sac_actor_forward
from safe_control_gym_tpu_torch.math.networks import mlp_init

__all__ = ['SAC']


class SAC(RLController):
    """Soft actor-critic, at inference."""

    ALGO = 'SAC'
    LEARN_ITEM = 'ROADMAP Queue 1 item 9'

    def __init__(self, env_func, **kwargs):
        super().__init__(env_func, **kwargs)
        obs_dim = self.env.observation_space.shape[0]
        act_dim = self.env.action_space.shape[0]
        # The actor puts out [mean, log-std]: 2 * act_dim.
        actor = mlp_init(self.gen, obs_dim, 2 * act_dim, [int(self.hidden_dim)] * 2,
                         orthogonal=False)
        self.agent = ActorAgent({'actor': actor}, getattr(self, 'activation', 'relu'))
        self.act_low = self._tensor(self.env.action_space.low)
        self.act_high = self._tensor(self.env.action_space.high)

    def select_action(self, obs, info=None):
        """The deterministic action (tanh of the mean), as numpy float32."""
        with torch.no_grad():
            act, _ = sac_actor_forward(self.agent.params['actor'], self._tensor(obs),
                                       self.gen, self.act_low, self.act_high,
                                       self.agent.activation, deterministic=True,
                                       with_logprob=False)
        return act.cpu().numpy()
