"""The port's controller template, and what its RL controllers share.

``BaseController`` ports ``safe_control_gym_tpu/controllers/base_controller.py``:
``training``, ``output_dir``, ``checkpoint_path`` (a bare filename resolves
under ``output_dir``), ``seed``, the algorithm's config as attributes,
``setup_results_dict``, ``reset_before_run``, ``extract_step`` and
``get_prior``, the env's prior model (``envs/symbolic.py``), perturbed by a
``prior_prop`` and, with ``randomize_prior_prop``, draws from
``np.random.default_rng(seed)``. LQR, iLQR and PID derive from it.

``RLController`` adds what the RL learners (PPO, SAC, DDPG,
SafeExplorerPPO, RARL, RAP) have in common: the env from
``env_func(seed=seed)`` (on the device ``env_func`` gives it), the default
config of the algorithm, the generator on the env's device, the logger, the
device-timing marks, the batched deterministic evaluation, ``load`` through
the port's restricted unpickler and ``evaluate_fused``; and, for the
learners that ``shard_over`` a mesh (PPO, SAC, RARL, RAP), the N training
envs as this rank's rows (``_shards``, a ``parallel/sharding.EnvShards``):
their start, step and draws at the global width, and ``is_lead``.
"""

from __future__ import annotations

import os
import time
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ['BaseController', 'RLController']


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
    with ``partial(make, env_id, device=...)``), the agent's parameters on the
    env's device, its own generator there, the experiment logger, the
    batched deterministic evaluation, ``load`` of a checkpoint's agent and
    ``evaluate_fused``. The algorithm's default config (``<algo>.json``)
    fills in every key the caller leaves out, and every key becomes an
    attribute. Subclasses build ``self.agent`` (``params`` and
    ``activation``), ``select_action`` and ``learn``."""

    ALGO = 'rl'

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
        self._logger = None
        self._shards = None

    @property
    def logger(self):
        """The experiment logger under ``output_dir``, made on first use."""
        if self._logger is None:
            from safe_control_gym_tpu_torch.utils.logging import ExperimentLogger
            self._logger = ExperimentLogger(self.output_dir,
                                            use_tensorboard=getattr(self, 'tensorboard', False))
        return self._logger

    def close(self):
        self.env.close()
        if getattr(self, 'eval_env', None) is not None:
            self.eval_env.close()
        if self._logger is not None:
            self._logger.close()

    def setup_results_dict(self):
        self.results_dict = {'obs': [], 'reward': [], 'done': [], 'info': [], 'action': []}

    # -- the N training envs, whole or this rank's rows ----------------------
    @property
    def is_lead(self):
        """Whether this process writes logs and checkpoints (rank 0, or not
        sharded)."""
        return self._shards is None or self._shards.mesh.rank == 0

    def _start_envs(self):
        """``(EnvState, obs)`` of the N training envs afresh (this rank's rows
        when sharded), drawn from the generator."""
        start = self.func_env.reset_batch(self.gen, self.N)
        return self._shards.take(start) if self._shards else start

    def _step_envs(self, est, act):
        """``step_autoreset`` of the training envs (sharded: this rank's rows,
        drawn at the global width)."""
        if self._shards:
            return self._shards.step(self.func_env, est, act, self.gen)
        return self.func_env.step_autoreset(est, act, self.gen)

    def _sample(self, dist, draws=None):
        """A draw of ``dist`` for the training envs (at the global width when
        sharded), or ``loc + scale * draws``, ``draws`` of all N envs."""
        sh = self._shards
        if draws is None:
            return dist.sample(self.gen, rows=sh.draw_rows if sh else None)
        return dist.loc + dist.scale * (sh.take(draws) if sh else draws)

    def _whole_envs(self):
        """The training envs' ``(EnvState, obs)`` of all N (gathered when
        sharded: every rank calls it)."""
        start = (self._env_states, self._obs)
        return self._shards.gather(start) if self._shards else start

    def _tensor(self, obs):
        return torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)

    def _mark(self):
        """A point in time: a recorded CUDA event on the card, else the host clock."""
        if self.device.type == 'cuda':
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    @staticmethod
    def _seconds(a, b):
        return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a

    def _restore_generator(self, key):
        """The generator's state from a checkpoint's ``key``: the port's
        (uint8 state) is restored where it is a state of this device's
        generator. A JAX PRNG key, or a state of the other device's generator
        (a checkpoint saved on the card loaded on the CPU, or the reverse),
        has no counterpart, so the generator is re-seeded from the
        controller's seed instead."""
        key = None if key is None else np.asarray(key)
        if (key is not None and key.dtype == np.uint8
                and key.size == self.gen.get_state().numel()):
            self.gen.set_state(torch.from_numpy(np.array(key, np.uint8)))
        else:
            self.gen.manual_seed(int(self.seed))

    @torch.no_grad()
    def _evaluate(self, env, n_episodes, action_fn):
        """Deterministic evaluation: ``n_episodes`` envs of ``env`` from fresh
        resets, stepped ``max_steps + 1`` times with ``action_fn(obs)``, each
        counted until its first done. Returns numpy ``ep_returns``,
        ``ep_lengths`` and ``ep_mse`` (the mean over the alive steps)."""
        func = env.func
        n = int(n_episodes)
        est, obs = func.reset_batch(self.gen, n)
        alive = torch.ones(n, dtype=torch.bool, device=self.device)
        rews, lengths, mses = [], [], []
        for _ in range(func.max_steps + 1):
            est, out = func.step(est, action_fn(obs), gen=self.gen)
            zero = torch.zeros_like(out.reward)
            rews.append(torch.where(alive, out.reward, zero))
            lengths.append(alive.to(torch.float32))
            mses.append(torch.where(alive, out.mse, zero))
            alive = alive & ~out.done
            obs = out.obs
        ep_len = torch.stack(lengths).sum(0)
        ep_ret, ep_mse = torch.stack(rews).sum(0), torch.stack(mses).sum(0)
        ep = torch.stack([ep_ret, ep_len, ep_mse / torch.clamp(ep_len, min=1.0)]).cpu().numpy()
        return {'ep_returns': ep[0], 'ep_lengths': ep[1], 'ep_mse': ep[2]}

    def _run_episodes(self, env, n_episodes):
        """``n_episodes`` episodes of ``select_action`` on the stateful
        ``env``, each to its done; numpy ``ep_returns``."""
        returns = []
        for _ in range(int(n_episodes)):
            obs, info = env.reset()
            done, ep_ret = False, 0.0
            while not done:
                obs, rew, done, info = env.step(self.select_action(obs, info))
                ep_ret += rew
            returns.append(ep_ret)
        return {'ep_returns': np.asarray(returns)}

    def load(self, path):
        """Restore the agent's parameters and the observation normalizer from
        a checkpoint (the learners that train restore their whole training
        state instead)."""
        from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint
        from safe_control_gym_tpu_torch.utils.convert import (normalizer_from_numpy,
                                                              tree_from_numpy)
        ckpt = load_checkpoint(path)
        self.agent.params = tree_from_numpy(ckpt['params'], self.device)
        self.obs_norm_state = normalizer_from_numpy(ckpt['obs_norm_state'], self.device)

    def evaluate_fused(self, env=None, batch=1024, n_steps=4096, seed=0, **kwargs):
        """Closed-loop evaluation over a ``batch``-env fleet: the actor inside
        the rollout kernel where the gates pass, else the per-step path (see
        ``experiments/fused_eval.py``)."""
        from safe_control_gym_tpu_torch.experiments.fused_eval import evaluate_policy_fused
        return evaluate_policy_fused(self, env=env, batch=batch, n_steps=n_steps,
                                     seed=seed, **kwargs)
