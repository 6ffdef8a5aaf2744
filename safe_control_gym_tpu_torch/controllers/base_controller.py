"""The port's controller template, and what its RL controllers share.

``BaseController`` ports ``safe_control_gym_tpu/controllers/base_controller.py``:
``training``, ``output_dir``, ``checkpoint_path`` (a bare filename resolves
under ``output_dir``), ``seed``, the algorithm's config as attributes,
``setup_results_dict``, ``reset_before_run``, ``extract_step`` and
``get_prior``, the env's prior model (``envs/symbolic.py``), perturbed by a
``prior_prop`` and, with ``randomize_prior_prop``, draws from
``np.random.default_rng(seed)``. LQR, iLQR and PID derive from it.

``RLController`` adds what PPO, SAC and DDPG have in common: the env from
``env_func(seed=seed)`` (on the device ``env_func`` gives it), the default
config of the algorithm, the generator on the env's device, ``load``
through the port's restricted unpickler and ``evaluate_fused``. PPO trains
(``controllers/ppo/ppo.py``); SAC's and DDPG's ``learn`` raise until ROADMAP
Queue 1 item 9.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ['ActorAgent', 'BaseController', 'RLController']


@dataclass
class ActorAgent:
    """The agent of an RL controller at inference: its parameter pytree
    (tensors, the JAX package's layout) and the hidden activation."""
    params: dict
    activation: str


class BaseController(ABC):
    """Template of a controller: ``select_action``, ``reset``, ``close``,
    ``learn``, ``run``-time results and the env's prior model."""

    def __init__(self,
                 env_func: Callable,
                 training: bool = True,
                 checkpoint_path: str = 'temp/model_latest.pt',
                 output_dir: str = 'temp',
                 use_gpu: bool = False,
                 seed: int = 0,
                 **kwargs):
        """``use_gpu`` is accepted for the reference's configs and not read:
        the env's device (``partial(make, env_id, device=...)``) places the
        controller."""
        self.env_func = env_func
        self.training = training
        # Bare filenames resolve under output_dir, so that the end-of-training
        # save never lands in the caller's working directory.
        if checkpoint_path and not os.path.dirname(checkpoint_path):
            checkpoint_path = os.path.join(output_dir, checkpoint_path)
        self.checkpoint_path = checkpoint_path
        self.output_dir = output_dir
        self.use_gpu = use_gpu
        self.seed = seed if seed is not None else 0
        self.prior_info: Dict[str, Any] = {}
        for key, value in kwargs.items():
            self.__dict__[key] = value
        self.setup_results_dict()

    @abstractmethod
    def select_action(self, obs, info=None):
        raise NotImplementedError

    def extract_step(self, info=None) -> int:
        """The current step from the env's info (0 without one)."""
        return info['current_step'] if info is not None else 0

    def learn(self, env=None, **kwargs):
        return

    def reset(self):
        raise NotImplementedError

    def reset_before_run(self, obs=None, info=None, env=None):
        self.setup_results_dict()

    def close(self):
        self.env.close()

    def save(self, path):
        return

    def load(self, path):
        return

    def setup_results_dict(self):
        self.results_dict: Dict[str, Any] = {}

    def get_prior(self, env, prior_info={}):
        """The env's prior model, rebuilt with ``prior_info['prior_prop']``
        where given; with ``randomize_prior_prop``, each property named in
        ``prior_prop_rand_info`` moves by a draw of its distribution from
        ``np.random.default_rng(seed)``."""
        if not prior_info:
            prior_info = getattr(self, 'prior_info', {}) or {}
        prior_prop = dict(prior_info.get('prior_prop', {}) or {})
        randomize = prior_info.get('randomize_prior_prop', False)
        rand_info = prior_info.get('prior_prop_rand_info', {}) or {}
        if randomize and rand_info:
            for k in rand_info:
                assert k in prior_prop, \
                    'A prior param to randomize does not have a base value in prior_prop.'
            rng = np.random.default_rng(self.seed)
            for k, info in rand_info.items():
                info = dict(info)
                distrib = getattr(rng, info.pop('distrib'))
                args = info.pop('args', [])
                prior_prop[k] += distrib(*args, **info)
        if prior_prop:
            env._setup_symbolic(prior_prop=prior_prop)
        return env.symbolic


class RLController(BaseController):
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
        super().__init__(env_func, training=training, checkpoint_path=checkpoint_path,
                         output_dir=output_dir, seed=seed,
                         **{**get_config(self.ALGO.lower()), **config})
        self.env = env_func(seed=self.seed)
        self.device = self.env.device
        self.gen = torch.Generator(device=self.device).manual_seed(int(self.seed))

    def _tensor(self, obs):
        return torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)

    def learn(self, env=None, **kwargs):
        raise NotImplementedError(f'{self.ALGO} training comes with {self.LEARN_ITEM}; '
                                  'this controller evaluates loaded checkpoints')

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
