"""Proximal policy optimization: on-device rollouts, GAE, the KL-gated update and resume.

Port of ``safe_control_gym_tpu/controllers/ppo/ppo.py``. One training
iteration collects ``rollout_steps`` (T) steps of ``rollout_batch_size`` (N)
envs through ``FuncEnv.step_autoreset`` (on the card, the physics step is
K1, K2 or K3 of ``ops/physics_kernels.py``), with the observation and return
normalizers, the value bootstrap of time-truncated episodes and auto-reset;
computes returns and (GAE) advantages; then runs ``opt_epochs`` epochs of
minibatch updates with the KL-gated actor step (``ppo_utils.PPOAgent``). No
tensor is read back inside an iteration: its scalars come back once, with
``fused_iterations`` K iterations run back to back before that read.
``run`` evaluates the mode of the policy on ``n_episodes`` envs at once.

``save`` writes every piece of training state as numpy
(``utils/checkpoint.save_checkpoint``), the generator's state included, so
that ``load`` resumes training exactly. ``load`` also takes a checkpoint the
JAX package wrote (params, both optimizer states, both normalizers,
``total_steps``, the env states and obs); the JAX PRNG key has no
counterpart, so the controller's generator is then re-seeded from its seed.

    ctrl = make('ppo', partial(make, 'cartpole', device='cuda', **task_config),
                training=True, output_dir='temp/ppo', seed=0, **algo_config)
    ctrl.reset(); ctrl.learn(); ctrl.run(n_episodes=10); ctrl.save('temp/ppo/m.pt')
"""

from __future__ import annotations

import os
import time
from collections import deque

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.base_controller import RLController
from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import (LOSS_NAMES, PPOAgent,
                                                                  actor_dist,
                                                                  compute_returns_and_advantages,
                                                                  critic_value)
from safe_control_gym_tpu_torch.math.normalization import (rms_init, rms_normalize,
                                                           rms_update, ret_init,
                                                           ret_normalize, ret_update)

__all__ = ['PPO']

STAT_NAMES = ('mean_reward', 'dones', 'mean_mse', 'constraint_violations')


class PPO(RLController):
    """Proximal policy optimization."""

    ALGO = 'PPO'

    def __init__(self, env_func, training=True, checkpoint_path='model_latest.pt',
                 output_dir='temp', seed: int = 0, **kwargs):
        super().__init__(env_func, training=training, checkpoint_path=checkpoint_path,
                         output_dir=output_dir, seed=seed, **kwargs)
        self.eval_env = env_func(seed=self.seed * 111 + 1)
        self.func_env = self.env.func
        self.N = int(self.rollout_batch_size)
        self.T = int(self.rollout_steps)
        self.gamma = float(self.gamma)
        self.agent = PPOAgent(self.env.observation_space, self.env.action_space,
                              hidden_dim=self.hidden_dim,
                              use_clipped_value=self.use_clipped_value,
                              clip_param=self.clip_param, target_kl=self.target_kl,
                              entropy_coef=self.entropy_coef, actor_lr=self.actor_lr,
                              critic_lr=self.critic_lr, opt_epochs=self.opt_epochs,
                              mini_batch_size=self.mini_batch_size,
                              activation=self.activation, max_grad_norm=self.max_grad_norm,
                              seed=self.seed, device=self.device)
        obs_dim = self.env.observation_space.shape[0]
        self.obs_norm_state = rms_init((obs_dim,), device=self.device) if self.norm_obs else None
        self.ret_norm_state = ret_init(self.N, device=self.device) if self.norm_reward else None
        self.total_steps = 0
        # Seconds of device time in the rollouts and in the updates of learn().
        self.train_seconds = {'rollout': 0.0, 'update': 0.0}
        self.last_results = {}     # the last training iteration's scalars
        self._logger = None
        self._env_states = None
        self._obs = None

    @property
    def logger(self):
        """The experiment logger under ``output_dir``, made on first use."""
        if self._logger is None:
            from safe_control_gym_tpu_torch.utils.logging import ExperimentLogger
            self._logger = ExperimentLogger(self.output_dir,
                                            use_tensorboard=getattr(self, 'tensorboard', False))
        return self._logger

    def reset(self):
        """Start the N training envs afresh (when training) and clear the results."""
        if self.training:
            self._env_states, self._obs = self.func_env.reset_batch(self.gen, self.N)
        self.setup_results_dict()

    def close(self):
        self.env.close()
        self.eval_env.close()
        if self._logger is not None:
            self._logger.close()

    def setup_results_dict(self):
        self.results_dict = {'obs': [], 'reward': [], 'done': [], 'info': [], 'action': []}

    def _normalize_obs(self, obs_norm, obs):
        return rms_normalize(obs_norm, obs, float(self.clip_obs)) if self.norm_obs else obs

    # ------------------------------------------------------------------
    def select_action(self, obs, info=None):
        """The mode action on the (normalized) obs, as numpy float32."""
        obs = self._tensor(obs)
        if self.norm_obs and self.obs_norm_state is not None:
            obs = rms_normalize(self.obs_norm_state, obs, float(self.clip_obs))
        return self.agent.act(obs).cpu().numpy().astype(np.float32)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, noise=None):
        """T steps of the N envs from the current env states; returns
        ``(batch, stats)``: the flattened (T N, ...) tensors the update takes
        (``obs``, ``act``, ``logp``, ``adv``, ``ret``, ``v``) and the
        rollout's mean reward, done count, mean mse and violation count,
        unread. ``noise`` (T, N, act_dim), pre-drawn standard normals, takes
        the place of the actions' draws from the generator."""
        params, activation = self.agent.params, self.agent.activation
        est, obs = self._env_states, self._obs
        obs_norm, ret_state = self.obs_norm_state, self.ret_norm_state
        ys = {k: [] for k in ('obs', 'act', 'rew', 'mask', 'v', 'logp', 'term_v', 'raw_rew',
                              'done', 'mse', 'cviol')}
        for t in range(self.T):
            if self.norm_obs:
                obs_norm = rms_update(obs_norm, obs)
            obs_n = self._normalize_obs(obs_norm, obs)
            dist = actor_dist(params, obs_n, activation)
            act = dist.sample(self.gen) if noise is None else dist.loc + dist.scale * noise[t]
            logp = dist.log_prob(act)
            v = critic_value(params, obs_n, activation)
            est, out, next_obs = self.func_env.step_autoreset(est, act, self.gen)
            rew = out.reward
            if self.norm_reward:
                ret_state = ret_update(ret_state, rew, out.done, self.gamma)
                rew_n = ret_normalize(ret_state, rew, float(self.clip_reward))
            else:
                rew_n = rew
            # The value of a time-truncated episode's final obs bootstraps
            # its return.
            term_v = critic_value(params, self._normalize_obs(obs_norm, out.obs), activation)
            for k, y in (('obs', obs_n), ('act', act), ('rew', rew_n[:, None]),
                         ('mask', 1.0 - out.done.to(torch.float32)[:, None]), ('v', v),
                         ('logp', logp),
                         ('term_v', torch.where(out.truncated[:, None], term_v,
                                                torch.zeros_like(term_v))),
                         ('raw_rew', rew), ('done', out.done), ('mse', out.mse),
                         ('cviol', out.constraint_violation)):
                ys[k].append(y)
            obs = next_obs
        ys = {k: torch.stack(v) for k, v in ys.items()}
        last_val = critic_value(params, self._normalize_obs(obs_norm, obs), activation)
        rets, advs = compute_returns_and_advantages(
            ys['rew'], ys['v'], ys['mask'], ys['term_v'], last_val, self.gamma,
            bool(self.use_gae), float(self.gae_lambda))
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-6)
        m = self.T * self.N
        batch = {'obs': ys['obs'].reshape(m, -1), 'act': ys['act'].reshape(m, -1),
                 'logp': ys['logp'].reshape(m, -1), 'adv': advs.reshape(m, -1),
                 'ret': rets.reshape(m, -1), 'v': ys['v'].reshape(m, -1)}
        stats = {'mean_reward': ys['raw_rew'].mean(),
                 'dones': ys['done'].sum().to(torch.float32),
                 'mean_mse': ys['mse'].mean(),
                 'constraint_violations': ys['cviol'].sum().to(torch.float32)}
        self._env_states, self._obs = est, obs
        if self.norm_obs:
            self.obs_norm_state = obs_norm
        if self.norm_reward:
            self.ret_norm_state = ret_state
        return batch, stats

    def _mark(self):
        if self.device.type == 'cuda':
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    @staticmethod
    def _seconds(a, b):
        return a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) else b - a

    def _iterations(self, k: int):
        """``k`` iterations (rollout, then update) back to back; returns the
        mean of their losses and stats, read back once, and the seconds of
        the rollouts and of the updates."""
        values, marks = [], []
        for _ in range(k):
            m0 = self._mark()
            batch, stats = self.rollout()
            m1 = self._mark()
            losses = self.agent.update_tensors(batch, self.gen)
            marks.append((m0, m1, self._mark()))
            values.append(torch.cat([losses, torch.stack([stats[n] for n in STAT_NAMES])]))
        mean = torch.stack(values).mean(dim=0).cpu().numpy()
        results = {n: float(v) for n, v in zip(LOSS_NAMES + STAT_NAMES, mean)}
        for m0, m1, m2 in marks:
            self.train_seconds['rollout'] += self._seconds(m0, m1)
            self.train_seconds['update'] += self._seconds(m1, m2)
        return results

    def learn(self, env=None, **kwargs):
        """Train until ``total_steps`` reaches ``max_env_steps``, with the
        log, save, checkpoint and eval intervals, then save to
        ``checkpoint_path``."""
        if self._env_states is None:
            self.reset()
        max_env_steps = int(self.max_env_steps)
        steps_per_iter = self.N * self.T
        best_eval_return = -np.inf
        ep_returns = deque(maxlen=int(self.deque_size))
        fused_k = max(1, int(getattr(self, 'fused_iterations', 1)))
        while self.total_steps < max_env_steps:
            start = time.time()
            results = self._iterations(fused_k)
            self.total_steps += steps_per_iter * fused_k
            results['elapsed_time'] = time.time() - start
            results['step'] = self.total_steps
            if self.log_interval and self.total_steps % self.log_interval < steps_per_iter:
                self.log_step(results)
            if self.save_interval and self.total_steps % self.save_interval < steps_per_iter:
                self.save(os.path.join(self.output_dir, 'checkpoints',
                                       f'model_{self.total_steps}.pt'))
            nckpt = int(getattr(self, 'num_checkpoints', 0) or 0)
            if nckpt > 0:
                interval = max(max_env_steps // nckpt, steps_per_iter)
                if self.total_steps % interval < steps_per_iter:
                    self.save(os.path.join(self.output_dir, 'checkpoints',
                                           f'model_{self.total_steps}.pt'))
            if self.eval_interval and self.total_steps % self.eval_interval < steps_per_iter:
                eval_results = self.run(env=self.eval_env, n_episodes=int(self.eval_batch_size))
                results['eval_return'] = float(eval_results['ep_returns'].mean())
                ep_returns.append(results['eval_return'])
                if self.eval_save_best and results['eval_return'] > best_eval_return:
                    best_eval_return = results['eval_return']
                    self.save(os.path.join(self.output_dir, 'model_best.pt'))
            self.last_results = results
        self.save(self.checkpoint_path)

    @torch.no_grad()
    def run(self, env=None, render=False, n_episodes=10, verbose=False, **kwargs):
        """Deterministic evaluation: ``n_episodes`` envs from fresh resets,
        stepped ``max_steps + 1`` times with the policy's mode, each counted
        until its first done. Returns numpy ``ep_returns``, ``ep_lengths``
        and ``ep_mse`` (the mean over the alive steps)."""
        env = self.eval_env if env is None else env
        func = env.func
        n = int(n_episodes)
        obs_norm = (self.obs_norm_state if self.obs_norm_state is not None
                    else rms_init((self.env.observation_space.shape[0],), device=self.device))
        est, obs = func.reset_batch(self.gen, n)
        alive = torch.ones(n, dtype=torch.bool, device=self.device)
        rews, lengths, mses = [], [], []
        for _ in range(func.max_steps + 1):
            act = actor_dist(self.agent.params, self._normalize_obs(obs_norm, obs),
                             self.agent.activation).mode()
            est, out = func.step(est, act, gen=self.gen)
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

    # ------------------------------------------------------------------
    def log_step(self, results):
        """Log the training scalars."""
        step = results.get('step', self.total_steps)
        for k in ('policy_loss', 'value_loss', 'entropy_loss', 'approx_kl', 'mean_reward',
                  'eval_return', 'elapsed_time'):
            if k in results:
                self.logger.add_scalar(f'ppo/{k}', results[k], step)
        self.logger.dump_scalars()

    def save(self, path):
        """Checkpoint params, optimizers, normalizers, ``total_steps``, the
        generator's state (as ``key``) and, when training, the env states and
        obs, for an exact resume."""
        if not path:
            return
        from safe_control_gym_tpu_torch.utils.checkpoint import save_checkpoint
        from safe_control_gym_tpu_torch.utils.convert import (env_state_to_numpy,
                                                              normalizer_to_numpy)
        state = {'agent': self.agent.state_dict(),
                 'obs_norm_state': normalizer_to_numpy(self.obs_norm_state),
                 'ret_norm_state': normalizer_to_numpy(self.ret_norm_state),
                 'total_steps': int(self.total_steps),
                 'key': self.gen.get_state().numpy()}
        if self.training and self._env_states is not None:
            state['env_states'] = env_state_to_numpy(self._env_states)
            state['obs'] = self._obs.cpu().numpy()
        save_checkpoint(path, state)

    def load(self, path):
        """Restore a checkpoint of the port or of the JAX package. A JAX
        checkpoint's PRNG key cannot carry over: the generator is re-seeded
        from the controller's seed instead."""
        from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, plain
        from safe_control_gym_tpu_torch.utils.convert import (env_state_from_numpy,
                                                              normalizer_from_numpy,
                                                              ret_state_from_numpy)
        state = plain(load_checkpoint(path)['raw'])
        self.agent.load_state_dict(state['agent'])
        if state.get('obs_norm_state') is not None:
            self.obs_norm_state = normalizer_from_numpy(state['obs_norm_state'], self.device)
        if state.get('ret_norm_state') is not None:
            self.ret_norm_state = ret_state_from_numpy(state['ret_norm_state'], self.device)
        self.total_steps = int(state.get('total_steps', 0))
        key = state.get('key')
        if key is not None and np.asarray(key).dtype == np.uint8:
            self.gen.set_state(torch.from_numpy(np.array(key, np.uint8)))
        else:
            self.gen.manual_seed(int(self.seed))
        if 'env_states' in state:
            self._env_states = env_state_from_numpy(state['env_states'], self.device)
            self._obs = torch.tensor(np.asarray(state['obs'], np.float32), device=self.device)
