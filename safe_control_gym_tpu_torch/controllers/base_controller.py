"""What the port's RL controllers share at inference.

``RLEvalController`` is what PPO, SAC and DDPG have in common when they
evaluate a trained actor: the env from ``env_func`` (on the device
``env_func`` gives it), ``load`` through the port's restricted unpickler,
``evaluate_fused`` and ``close``. The JAX package's ``BaseController`` template
and ``get_prior`` (which needs the symbolic model: ROADMAP Queue 1 item 11)
come with the controllers that use them. Training (``learn``) comes with
ROADMAP Queue 1 items 8 (PPO) and 9 (SAC, DDPG).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ['ActorAgent', 'RLEvalController']


@dataclass
class ActorAgent:
    """The agent of an RL controller at inference: its parameter pytree
    (tensors, the JAX package's layout) and the hidden activation."""
    params: dict
    activation: str


class RLEvalController:
    """An RL controller at inference: the env from ``env_func(seed=seed)``
    (pick its device with ``partial(make, env_id, device=...)``), the actor's
    parameters on the env's device, ``load`` from a JAX package checkpoint
    and ``evaluate_fused``. The algorithm's default config (``<algo>.json``)
    fills in every key the caller leaves out, and every key becomes an
    attribute. Subclasses build ``self.agent`` (``params`` and
    ``activation``) and ``select_action``."""

    ALGO = 'rl'
    LEARN_ITEM = ''

    def __init__(self, env_func, seed: int = 0, **config):
        from safe_control_gym_tpu_torch.utils.registration import get_config
        for key, value in {**get_config(self.ALGO.lower()), **config}.items():
            self.__dict__[key] = value
        self.seed = seed if seed is not None else 0
        self.env = env_func(seed=self.seed)
        self.device = self.env.device
        self.gen = torch.Generator(device=self.device).manual_seed(int(self.seed))

    def _obs(self, obs):
        return torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)

    def learn(self, env=None, **kwargs):
        raise NotImplementedError(f'{self.ALGO} training comes with {self.LEARN_ITEM}; '
                                  'this controller evaluates loaded checkpoints')

    def close(self):
        self.env.close()

    def load(self, path):
        """Restore the agent's parameters (and PPO's observation normalizer)
        from a checkpoint the JAX package wrote."""
        from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint
        from safe_control_gym_tpu_torch.utils.convert import (mlp_params_from_numpy,
                                                              normalizer_from_numpy)
        ckpt = load_checkpoint(path)
        self.agent.params = {
            k: (mlp_params_from_numpy(v, self.device) if isinstance(v, list)
                else torch.tensor(np.asarray(v, np.float32), device=self.device))
            for k, v in ckpt['params'].items()}
        self.obs_norm_state = normalizer_from_numpy(ckpt['obs_norm_state'], self.device)

    def evaluate_fused(self, env=None, batch=1024, n_steps=4096, seed=0, **kwargs):
        """Closed-loop evaluation over a ``batch``-env fleet: the actor inside
        the rollout kernel where the gates pass, else the per-step path (see
        ``experiments/fused_eval.py``)."""
        from safe_control_gym_tpu_torch.experiments.fused_eval import evaluate_policy_fused
        return evaluate_policy_fused(self, env=env, batch=batch, n_steps=n_steps,
                                     seed=seed, **kwargs)
