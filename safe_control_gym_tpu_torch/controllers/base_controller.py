"""What the port's RL controllers share: the env, the config, the output paths and ``load``.

``RLController`` holds what PPO, SAC and DDPG have in common: the env from
``env_func`` (on the device ``env_func`` gives it), the algorithm's config as
attributes, the generator on the env's device, ``load`` through the port's
restricted unpickler, ``evaluate_fused`` and ``close``; and the training half
of the JAX package's ``BaseController``
(``safe_control_gym_tpu/controllers/base_controller.py:20-72``): ``training``,
``output_dir``, ``checkpoint_path`` (a bare filename resolves under
``output_dir``), ``setup_results_dict``, ``reset_before_run`` and
``extract_step``. PPO trains (``controllers/ppo/ppo.py``); SAC's and DDPG's
``learn`` raise until ROADMAP Queue 1 item 9. ``get_prior`` (which needs the
symbolic model) comes with ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ['ActorAgent', 'RLController']


@dataclass
class ActorAgent:
    """The agent of an RL controller at inference: its parameter pytree
    (tensors, the JAX package's layout) and the hidden activation."""
    params: dict
    activation: str


class RLController:
    """An RL controller: the env from ``env_func(seed=seed)`` (pick its device
    with ``partial(make, env_id, device=...)``), the actor's parameters on the
    env's device, ``load`` from a JAX package checkpoint and
    ``evaluate_fused``. The algorithm's default config (``<algo>.json``) fills
    in every key the caller leaves out, and every key becomes an attribute.
    Subclasses build ``self.agent`` (``params`` and ``activation``) and
    ``select_action``; one that trains overrides ``learn``."""

    ALGO = 'rl'
    LEARN_ITEM = ''

    def __init__(self, env_func, training: bool = True,
                 checkpoint_path: str = 'model_latest.pt', output_dir: str = 'temp',
                 seed: int = 0, **config):
        from safe_control_gym_tpu_torch.utils.registration import get_config
        for key, value in {**get_config(self.ALGO.lower()), **config}.items():
            self.__dict__[key] = value
        self.env_func = env_func
        self.training = training
        # Bare filenames resolve under output_dir, so that the end-of-training
        # save never lands in the caller's working directory.
        if checkpoint_path and not os.path.dirname(checkpoint_path):
            checkpoint_path = os.path.join(output_dir, checkpoint_path)
        self.checkpoint_path = checkpoint_path
        self.output_dir = output_dir
        self.seed = seed if seed is not None else 0
        self.env = env_func(seed=self.seed)
        self.device = self.env.device
        self.gen = torch.Generator(device=self.device).manual_seed(int(self.seed))
        self.setup_results_dict()

    def _tensor(self, obs):
        return torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)

    def learn(self, env=None, **kwargs):
        raise NotImplementedError(f'{self.ALGO} training comes with {self.LEARN_ITEM}; '
                                  'this controller evaluates loaded checkpoints')

    def extract_step(self, info=None) -> int:
        """The current step from the env's info (0 without one)."""
        return info['current_step'] if info is not None else 0

    def setup_results_dict(self):
        self.results_dict = {}

    def reset_before_run(self, obs=None, info=None, env=None):
        self.setup_results_dict()

    def close(self):
        self.env.close()

    def load(self, path):
        """Restore the agent's parameters and the observation normalizer from
        a checkpoint the JAX package wrote (PPO restores its whole training
        state instead)."""
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
