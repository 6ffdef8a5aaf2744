"""Safe-exploration PPO: a pretrained safety layer projects every PPO action.

Port of ``safe_control_gym_tpu/controllers/safe_explorer/safe_ppo.py``. Two
phases:

* ``pretrain_safety_layer``: ``constraint_epochs`` epochs, each
  ``constraint_steps_per_epoch // N`` steps of the N envs with uniform random
  actions (through ``FuncEnv.step_autoreset``: K1-K3 on the card), every
  transition (obs, act, c, c_next) pushed into the ``ConstraintBuffer``, then
  ``M // constraint_batch_size`` Adam steps of the ``SafetyLayer`` on batches
  drawn from it;
* PPO (``controllers/ppo/ppo_utils.PPOAgent``, no normalizers): each rollout
  step samples the policy, projects the action through the safety layer
  (``get_safe_action``) and steps the envs with the projected action, whose
  log-prob the update uses.

The constraint values ``c`` an action is projected with thread through the
steps: after an auto-reset they are the fresh state's values under a zero
action, not the terminal state's. With ``fused_iterations`` K, K iterations
run back to back before one read. ``run`` plays ``n_episodes`` episodes of
the deterministic projected policy on the stateful env. Checkpoints hold the
agent, the safety layer, ``total_steps``, the generator's state and, when
training, the env states, obs and ``c``; ``load`` also takes the JAX
package's (``examples/rl/models/safe_explorer_ppo/*.pt``).

    ctrl = make('safe_explorer_ppo', partial(make, 'cartpole', device='cuda', **task),
                training=True, seed=0, **algo_config)
    ctrl.reset(); ctrl.learn()
"""

from __future__ import annotations

import time

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.base_controller import RLController
from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import (LOSS_NAMES, PPOAgent,
                                                                  actor_dist,
                                                                  compute_returns_and_advantages,
                                                                  critic_value)
from safe_control_gym_tpu_torch.controllers.safe_explorer.safe_explorer_utils import (
    ConstraintBuffer, SafetyLayer)

__all__ = ['SafeExplorerPPO']

STAT_NAMES = ('mean_reward', 'constraint_violations')


class SafeExplorerPPO(RLController):
    """PPO with a pretrained safety layer projecting its actions."""

    ALGO = 'safe_explorer_ppo'

    def __init__(self, env_func, training=True, checkpoint_path='model_latest.pt',
                 output_dir='temp', seed: int = 0, **kwargs):
        super().__init__(env_func, training=training, checkpoint_path=checkpoint_path,
                         output_dir=output_dir, seed=seed, **kwargs)
        self.eval_env = env_func(seed=self.seed * 111 + 1)
        self.func_env = self.env.func
        self.N = int(self.rollout_batch_size)
        self.T = int(self.rollout_steps)
        self.gamma = float(self.gamma)
        if self.env.constraints is None or self.env.num_constraints == 0:
            raise ValueError('[ERROR] SafeExplorerPPO requires env constraints.')
        self.num_constraints = self.env.num_constraints
        obs_space, act_space = self.env.observation_space, self.env.action_space
        self.safety_layer = SafetyLayer(obs_space, act_space,
                                        hidden_dim=self.constraint_hidden_dim,
                                        num_constraints=self.num_constraints,
                                        lr=self.constraint_lr, slack=self.constraint_slack,
                                        seed=self.seed, device=self.device)
        self.constraint_buffer = ConstraintBuffer(obs_space.shape[0], act_space.shape[0],
                                                  self.num_constraints,
                                                  self.constraint_buffer_size,
                                                  self.constraint_batch_size, device=self.device)
        self.agent = PPOAgent(obs_space, act_space, hidden_dim=self.hidden_dim,
                              use_clipped_value=self.use_clipped_value,
                              clip_param=self.clip_param, target_kl=self.target_kl,
                              entropy_coef=self.entropy_coef, actor_lr=self.actor_lr,
                              critic_lr=self.critic_lr, opt_epochs=self.opt_epochs,
                              mini_batch_size=self.mini_batch_size,
                              activation=getattr(self, 'activation', 'tanh'),
                              max_grad_norm=self.max_grad_norm, seed=self.seed,
                              device=self.device)
        self.act_low = self._tensor(act_space.low)
        self.act_high = self._tensor(act_space.high)
        self.total_steps = 0
        # Seconds: the pretraining's collects and fits; the PPO rollouts and updates.
        self.train_seconds = {'pretrain_collect': 0.0, 'pretrain_fit': 0.0, 'rollout': 0.0,
                              'update': 0.0}
        self.last_results = {}
        self._env_states = None
        self._obs = None
        self._c = None

    def _c_of_state(self, state):
        """The constraint values of ``state`` (B, nx) under a zero action."""
        zero = torch.zeros((state.shape[0], self.env.action_dim), device=state.device)
        return self.env.constraints.values_from(state, zero)

    def reset(self):
        """Start the N training envs afresh (when training) and clear the results."""
        if self.training:
            self._env_states, self._obs = self.func_env.reset_batch(self.gen, self.N)
            self._c = self._c_of_state(self._env_states.state)
        self.setup_results_dict()

    def select_action(self, obs, info=None):
        """The projected mode action, as numpy float32; the constraint values
        are ``info['constraint_values']`` where given, else zeros."""
        act = self.agent.act(self._tensor(obs))
        if info is not None and 'constraint_values' in info:
            c = np.asarray(info['constraint_values'], np.float32)
        else:
            c = np.zeros(self.num_constraints, np.float32)
        safe = self.safety_layer.get_safe_action(self._tensor(obs)[None], act[None],
                                                 self._tensor(c)[None])
        return safe[0].cpu().numpy()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def pretrain_collect(self, n_steps: int, uniforms=None):
        """``n_steps`` steps of the N envs with uniform random actions (or
        ``low + u (high - low)`` of the given U[0, 1) ``uniforms``, (n_steps,
        N, act_dim)); returns (obs, act, c, c_next), each (n_steps N, ...)."""
        est, obs, c = self._env_states, self._obs, self._c
        ys = {k: [] for k in ('obs', 'act', 'c', 'c_next')}
        for t in range(n_steps):
            u = (torch.rand((self.N,) + tuple(self.act_low.shape), generator=self.gen,
                            device=self.device) if uniforms is None else
                 torch.as_tensor(uniforms[t], dtype=torch.float32, device=self.device))
            act = torch.maximum(self.act_low, u * (self.act_high - self.act_low) + self.act_low)
            est, out, next_obs = self.func_env.step_autoreset(est, act, self.gen)
            c_next = out.constraint_values
            for k, y in (('obs', obs), ('act', act), ('c', c), ('c_next', c_next)):
                ys[k].append(y)
            c = torch.where(out.done[:, None], self._c_of_state(est.state), c_next)
            obs = next_obs
        self._env_states, self._obs, self._c = est, obs, c
        return {k: torch.cat(v) for k, v in ys.items()}

    def pretrain_safety_layer(self):
        """Collect random transitions and fit the constraint models, epoch by
        epoch; returns the last fit's C losses (numpy)."""
        if self._env_states is None:
            self.reset()
        steps = max(1, int(self.constraint_steps_per_epoch) // self.N)
        losses = None
        for _ in range(int(self.constraint_epochs)):
            m0 = self._mark()
            self.constraint_buffer.push(self.pretrain_collect(steps))
            m1 = self._mark()
            for _ in range(max(1, steps * self.N // int(self.constraint_batch_size))):
                losses = self.safety_layer.update(self.constraint_buffer.sample(self.gen))
            m2 = self._mark()
            self.train_seconds['pretrain_collect'] += self._seconds(m0, m1)
            self.train_seconds['pretrain_fit'] += self._seconds(m1, m2)
        return losses.cpu().numpy()

    @torch.no_grad()
    def rollout(self, noise=None):
        """T steps of the N envs with projected actions; returns ``(batch,
        stats)`` as ``PPO.rollout`` does (no normalizers). ``noise`` (T, N,
        act_dim): standard normals in place of the policy's draws."""
        params, activation = self.agent.params, self.agent.activation
        est, obs, c = self._env_states, self._obs, self._c
        ys = {k: [] for k in ('obs', 'act', 'rew', 'mask', 'v', 'logp', 'term_v', 'cviol')}
        for t in range(self.T):
            dist = actor_dist(params, obs, activation)
            raw = dist.sample(self.gen) if noise is None else dist.loc + dist.scale * noise[t]
            act = self.safety_layer.get_safe_action(obs, raw, c)
            logp = dist.log_prob(act)
            v = critic_value(params, obs, activation)
            est, out, next_obs = self.func_env.step_autoreset(est, act, self.gen)
            term_v = critic_value(params, out.obs, activation)
            for k, y in (('obs', obs), ('act', act), ('rew', out.reward[:, None]),
                         ('mask', 1.0 - out.done.to(torch.float32)[:, None]), ('v', v),
                         ('logp', logp),
                         ('term_v', torch.where(out.truncated[:, None], term_v,
                                                torch.zeros_like(term_v))),
                         ('cviol', out.constraint_violation)):
                ys[k].append(y)
            c = torch.where(out.done[:, None], self._c_of_state(est.state),
                            out.constraint_values)
            obs = next_obs
        ys = {k: torch.stack(v) for k, v in ys.items()}
        last_val = critic_value(params, obs, activation)
        rets, advs = compute_returns_and_advantages(
            ys['rew'], ys['v'], ys['mask'], ys['term_v'], last_val, self.gamma,
            bool(self.use_gae), float(self.gae_lambda))
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-6)
        m = self.T * self.N
        batch = {'obs': ys['obs'].reshape(m, -1), 'act': ys['act'].reshape(m, -1),
                 'logp': ys['logp'].reshape(m, -1), 'adv': advs.reshape(m, -1),
                 'ret': rets.reshape(m, -1), 'v': ys['v'].reshape(m, -1)}
        stats = {'mean_reward': ys['rew'].mean(),
                 'constraint_violations': ys['cviol'].sum().to(torch.float32)}
        self._env_states, self._obs, self._c = est, obs, c
        return batch, stats

    def learn(self, env=None, **kwargs):
        """Pretrain the safety layer (``pretraining``) or load it
        (``pretrained``), then PPO until ``total_steps`` reaches
        ``max_env_steps``; save to ``checkpoint_path``."""
        if self._env_states is None:
            self.reset()
        if getattr(self, 'pretraining', True):
            self.pretrain_safety_layer()
        if getattr(self, 'pretrained', None):
            self.load_safety_layer(self.pretrained)
        max_env_steps = int(self.max_env_steps)
        steps_per_iter = self.N * self.T
        fused_k = max(1, int(getattr(self, 'fused_iterations', 1)))
        while self.total_steps < max_env_steps:
            start = time.time()
            values = []
            for _ in range(fused_k):
                m0 = self._mark()
                batch, stats = self.rollout()
                m1 = self._mark()
                losses = self.agent.update_tensors(batch, self.gen)
                m2 = self._mark()
                values.append(torch.cat([losses, torch.stack([stats[n] for n in STAT_NAMES])]))
                self.train_seconds['rollout'] += self._seconds(m0, m1)
                self.train_seconds['update'] += self._seconds(m1, m2)
            self.total_steps += steps_per_iter * fused_k
            mean = torch.stack(values).mean(dim=0).cpu().numpy()
            results = {n: float(v) for n, v in zip(LOSS_NAMES + STAT_NAMES, mean)}
            results['elapsed_time'] = time.time() - start
            if self.log_interval and self.total_steps % self.log_interval < steps_per_iter:
                for k, v in results.items():
                    self.logger.add_scalar(f'safe_ppo/{k}', v, self.total_steps)
                self.logger.dump_scalars()
            self.last_results = results
        self.save(self.checkpoint_path)

    def run(self, env=None, n_episodes=10, **kwargs):
        """``n_episodes`` episodes of the projected mode policy on the
        stateful ``env`` (the eval env by default); numpy ``ep_returns``."""
        return self._run_episodes(self.eval_env if env is None else env, n_episodes)

    # ------------------------------------------------------------------
    def save(self, path):
        """Checkpoint the agent, the safety layer, ``total_steps``, the
        generator's state and, when training, the env states, obs and c."""
        if not path:
            return
        from safe_control_gym_tpu_torch.utils.checkpoint import save_checkpoint
        from safe_control_gym_tpu_torch.utils.convert import env_state_to_numpy
        state = {'agent': self.agent.state_dict(),
                 'safety_layer': self.safety_layer.state_dict(),
                 'total_steps': int(self.total_steps), 'key': self.gen.get_state().numpy()}
        if self.training and self._env_states is not None:
            state['env_states'] = env_state_to_numpy(self._env_states)
            state['obs'] = self._obs.cpu().numpy()
            state['c'] = self._c.cpu().numpy()
        save_checkpoint(path, state)

    def load(self, path):
        """Restore a checkpoint of the port or of the JAX package (a JAX PRNG
        key re-seeds the generator from the controller's seed)."""
        from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, plain
        from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy
        state = plain(load_checkpoint(path)['raw'])
        self.agent.load_state_dict(state['agent'])
        self.safety_layer.load_state_dict(state['safety_layer'])
        self.total_steps = int(state.get('total_steps', 0))
        self._restore_generator(state.get('key'))
        if 'env_states' in state:
            self._env_states = env_state_from_numpy(state['env_states'], self.device)
            f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=self.device)
            self._obs, self._c = f32(state['obs']), f32(state['c'])

    def load_safety_layer(self, path):
        """The safety layer alone, from a checkpoint or a bare layer state."""
        from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, plain
        state = plain(load_checkpoint(path)['raw'])
        self.safety_layer.load_state_dict(state.get('safety_layer', state))
