"""Robust adversarial RL (RARL): a protagonist and an adversary PPO agent, trained in turns.

Port of ``safe_control_gym_tpu/controllers/rarl/rarl.py``. The env must have
an adversary channel (``adversary_disturbance``). Both agents are
``ppo_utils.PPOAgent``\\ s on the same observation; the adversary acts on the
env's ``adversary_action_space`` and its reward is the negated reward. Each
rollout step samples both agents, writes the adversary's force
(``clip(a, -1, 1) * scale + offset``) into every env state's ``adv_action``
with ``adv_valid`` set (cleared in the protagonist phase when
``train_adversary`` is off), and steps the protagonist's action through
``FuncEnv.step_autoreset``: on the card, K1-K3 take the force as their force
operand (the 'dynamics' mode) or the step adds it to the action ('action').
Training alternates ``agent_iterations`` protagonist updates and
``adversary_iterations`` adversary updates (``train_protagonist``,
``train_adversary``). With ``fused_iterations`` K, K such cycles run between
host reads, with the JAX package's tail rule for ``total_steps``. ``run``
plays episodes of the protagonist's mode on the stateful env, without the
adversary. Checkpoints hold both agents, ``total_steps``, the generator's
state and, when training, the env states and obs.

``shard_over(mesh)`` trains data parallel over ``torch.distributed`` ranks
(``parallel/sharding.py``), as ``PPO.shard_over``: each rank steps its rows
of the envs, draws at the global width from the one generator, and both
agents' updates sum their gradients over the ranks; every agent stays
identical on every rank. Only rank 0 writes logs and checkpoints.

    ctrl = make('rarl', partial(make, 'cartpole', device='cuda',
                                adversary_disturbance='dynamics', **task),
                training=True, seed=0, **algo_config)
    ctrl.reset(); ctrl.learn()
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.base_controller import RLController
from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import (LOSS_NAMES, PPOAgent,
                                                                  actor_dist,
                                                                  compute_returns_and_advantages,
                                                                  critic_value,
                                                                  normalize_advantages)

__all__ = ['RARL', 'flat_batch']


def flat_batch(obs, act, logp, adv, ret, v):
    """The update's batch from (T, N, ...) tensors, flattened to (T N, ...)."""
    m = obs.shape[0] * obs.shape[1]
    return {k: x.reshape(m, -1) for k, x in (('obs', obs), ('act', act), ('logp', logp),
                                             ('adv', adv), ('ret', ret), ('v', v))}


class RARL(RLController):
    """Robust adversarial reinforcement learning with PPO agents."""

    ALGO = 'RARL'

    def __init__(self, env_func, training=True, checkpoint_path='model_latest.pt',
                 output_dir='temp', seed: int = 0, **kwargs):
        super().__init__(env_func, training=training, checkpoint_path=checkpoint_path,
                         output_dir=output_dir, seed=seed, **kwargs)
        self.eval_env = env_func(seed=self.seed * 111 + 1)
        if self.env.adversary_disturbance is None:
            raise ValueError(f'[ERROR] {self.ALGO} requires an env with adversary_disturbance set.')
        self.func_env = self.env.func
        self.N = int(self.rollout_batch_size)
        self.T = int(self.rollout_steps)
        self.gamma = float(self.gamma)
        self.agent = self._ppo_agent(self.env.action_space, self.seed)
        self.adversary = self._ppo_agent(self.env.adversary_action_space, self.seed + 1)
        self.adv_scale = float(self.env.adversary_disturbance_scale)
        self.adv_offset = float(self.env.adversary_disturbance_offset)
        self.total_steps = 0
        # Seconds of device time in the rollouts and in the updates of learn().
        self.train_seconds = {'rollout': 0.0, 'update': 0.0}
        self.last_results = {}
        self._env_states = None
        self._obs = None
        self._batch_rows = None

    def _ppo_agent(self, act_space, seed):
        return PPOAgent(self.env.observation_space, act_space, hidden_dim=self.hidden_dim,
                        use_clipped_value=self.use_clipped_value, clip_param=self.clip_param,
                        target_kl=self.target_kl, entropy_coef=self.entropy_coef,
                        actor_lr=self.actor_lr, critic_lr=self.critic_lr,
                        opt_epochs=self.opt_epochs, mini_batch_size=self.mini_batch_size,
                        activation=getattr(self, 'activation', 'tanh'),
                        max_grad_norm=self.max_grad_norm, seed=seed, device=self.device)

    def reset(self):
        """Start the N training envs afresh (when training; sharded, this
        rank's rows of them) and clear the results."""
        if self.training:
            self._env_states, self._obs = self._start_envs()
        self.setup_results_dict()

    def _all_agents(self):
        return [self.agent, self.adversary]

    def shard_over(self, mesh, axis_name: str = 'env'):
        """Train data parallel over ``mesh`` (``parallel/sharding.py``): this
        rank keeps its rows of the env states and obs, every agent takes rank
        0's parameters and optimizer states, and both updates sum over
        ``axis_name``. Every rank calls it, and then ``learn``, alike."""
        from safe_control_gym_tpu_torch.parallel.sharding import EnvShards
        shards = EnvShards(mesh, axis_name, self.N, self.device)
        if self._env_states is None:
            self.reset()
        self._env_states, self._obs = shards.take((self._env_states, self._obs))
        for agent in self._all_agents():
            agent.shard(mesh, axis_name)
        self._shards, self._batch_rows = shards, shards.batch_rows(self.T)[0]

    def select_action(self, obs, info=None):
        """The protagonist's mode action, as numpy float32."""
        return self.agent.act(self._tensor(obs)).cpu().numpy()

    # ------------------------------------------------------------------
    def _adversary_force(self, a_act, est, use_adversary):
        """``est`` with the adversary's force written into ``adv_action``
        (padded to adv_dim) and ``adv_valid`` set to ``use_adversary``."""
        force = torch.clamp(a_act, -1.0, 1.0) * self.adv_scale + self.adv_offset
        n = force.shape[0]
        padded = torch.zeros((n, self.env.adv_action_dim), device=self.device)
        padded[:, :force.shape[1]] = force
        return est.replace(adv_action=padded,
                           adv_valid=torch.full((n,), bool(use_adversary), device=self.device))

    def _adversary_step(self, obs, draws):
        """The adversary's action, log-prob and value on ``obs``."""
        p = self.adversary.params
        dist = actor_dist(p, obs, self.adversary.activation)
        a = self._sample(dist, draws)
        return a, dist.log_prob(a), critic_value(p, obs, self.adversary.activation)

    def _adversary_terminal_value(self, obs):
        return critic_value(self.adversary.params, obs, self.adversary.activation)

    def _adversary_batch(self, ys, a_last):
        """The adversary's update data from the rollout's (T, N, ...) tensors."""
        a_rets, a_advs = compute_returns_and_advantages(
            -ys['rew'], ys['a_v'], ys['mask'], -ys['term_av'], a_last, self.gamma,
            bool(self.use_gae), float(self.gae_lambda))
        return flat_batch(ys['obs'], ys['a_act'], ys['a_logp'], self._normalized(a_advs),
                          a_rets, ys['a_v'])

    def _normalized(self, advs):
        return normalize_advantages(advs, self._shards.psum if self._shards else None)

    @torch.no_grad()
    def rollout(self, use_adversary=True, p_noise=None, a_noise=None):
        """T steps of the N envs with both agents; returns ``(p_batch,
        a_batch, mean_reward)`` (the reward unread). ``p_noise`` (T, N,
        act_dim) and ``a_noise`` (T, N, adv_dim): standard normals in place of
        the two agents' draws (of all N envs also when sharded)."""
        pp, act_fn = self.agent.params, self.agent.activation
        est, obs = self._env_states, self._obs
        ys = {k: [] for k in ('obs', 'p_act', 'a_act', 'rew', 'mask', 'p_v', 'a_v', 'p_logp',
                              'a_logp', 'term_pv', 'term_av')}
        for t in range(self.T):
            p_dist = actor_dist(pp, obs, act_fn)
            p_act = self._sample(p_dist, None if p_noise is None else p_noise[t])
            a_act, a_logp, a_v = self._adversary_step(obs, None if a_noise is None
                                                      else a_noise[t])
            est = self._adversary_force(a_act, est, use_adversary)
            est, out, next_obs = self._step_envs(est, p_act)
            trunc = out.truncated[:, None]
            term_pv = critic_value(pp, out.obs, act_fn)
            term_av = self._adversary_terminal_value(out.obs)
            for k, y in (('obs', obs), ('p_act', p_act), ('a_act', a_act),
                         ('rew', out.reward[:, None]),
                         ('mask', 1.0 - out.done.to(torch.float32)[:, None]),
                         ('p_v', critic_value(pp, obs, act_fn)), ('a_v', a_v),
                         ('p_logp', p_dist.log_prob(p_act)), ('a_logp', a_logp),
                         ('term_pv', torch.where(trunc, term_pv, torch.zeros_like(term_pv))),
                         ('term_av', torch.where(trunc, term_av, torch.zeros_like(term_av)))):
                ys[k].append(y)
            obs = next_obs
        ys = {k: torch.stack(v) for k, v in ys.items()}
        p_last = critic_value(pp, obs, act_fn)
        p_rets, p_advs = compute_returns_and_advantages(
            ys['rew'], ys['p_v'], ys['mask'], ys['term_pv'], p_last, self.gamma,
            bool(self.use_gae), float(self.gae_lambda))
        p_batch = flat_batch(ys['obs'], ys['p_act'], ys['p_logp'], self._normalized(p_advs),
                             p_rets, ys['p_v'])
        a_batch = self._adversary_batch(ys, self._adversary_terminal_value(obs))
        self._env_states, self._obs = est, obs
        mean_rew = self._shards.psum.mean(ys['rew']) if self._shards else ys['rew'].mean()
        return p_batch, a_batch, mean_rew

    def _phase_iteration(self, protagonist: bool, train: bool, use_adversary: bool):
        """One rollout and, with ``train``, one update of the protagonist
        (``protagonist``) or of the adversary; returns the mean reward and
        the update's four losses (None without ``train``), unread."""
        m0 = self._mark()
        p_batch, a_batch, mean_rew = self.rollout(use_adversary)
        m1 = self._mark()
        losses = self._update(protagonist, p_batch, a_batch) if train else None
        self._marks.append((m0, m1, self._mark()))
        return mean_rew, losses

    def _update(self, protagonist, p_batch, a_batch):
        if protagonist:
            return self.agent.update_tensors(p_batch, self.gen, rows=self._batch_rows)
        return self.adversary.update_tensors(a_batch, self.gen, rows=self._batch_rows)

    def _cycle(self, max_env_steps=None):
        """``agent_iterations`` protagonist iterations, then
        ``adversary_iterations`` adversary ones; with ``max_env_steps`` each
        phase stops once ``total_steps`` reaches it. Returns the rewards and
        each role's update losses."""
        train_prot = bool(getattr(self, 'train_protagonist', True))
        train_adv = bool(getattr(self, 'train_adversary', True))
        rews, losses = [], {'protagonist': [], 'adversary': []}
        for role, n, train, use_adv in (
                ('protagonist', int(self.agent_iterations), train_prot, train_adv),
                ('adversary', int(self.adversary_iterations), train_adv, True)):
            for _ in range(n):
                if max_env_steps is not None and self.total_steps >= max_env_steps:
                    break
                rew, loss = self._phase_iteration(role == 'protagonist', train, use_adv)
                rews.append(rew)
                if loss is not None:
                    losses[role].append(loss)
                self.total_steps += self.N * self.T
        return rews, losses

    def learn(self, env=None, **kwargs):
        """Alternate the two phases until ``total_steps`` reaches
        ``max_env_steps``; save to ``checkpoint_path``."""
        if self._env_states is None:
            self.reset()
        max_env_steps = int(self.max_env_steps)
        fused_k = max(1, int(getattr(self, 'fused_iterations', 1)))
        steps_per_cycle = ((int(self.agent_iterations) + int(self.adversary_iterations))
                           * self.N * self.T)
        while self.total_steps < max_env_steps:
            self._marks = []
            # K cycles between reads; the last dispatch shrinks only when that
            # saves at least half of K (the JAX package's tail rule).
            remaining = max_env_steps - self.total_steps
            k_needed = max(1, -(-remaining // steps_per_cycle))
            k_this = k_needed if k_needed <= fused_k // 2 else fused_k
            rews, losses = [], {'protagonist': [], 'adversary': []}
            for _ in range(k_this):
                r, ls = self._cycle(max_env_steps if fused_k == 1 else None)
                rews += r
                for role in losses:
                    losses[role] += ls[role]
            # One read: the mean reward, then each trained role's mean losses.
            roles = [role for role in losses if losses[role]]
            values = torch.cat([torch.stack(rews).mean()[None]]
                               + [torch.stack(losses[role]).mean(dim=0) for role in roles])
            values = values.cpu().numpy()
            results = {'mean_reward': float(values[0]), 'step': self.total_steps}
            for i, role in enumerate(roles):
                results.update({f'{role}_{name}': float(v) for name, v in
                                zip(LOSS_NAMES, values[1 + 4 * i:5 + 4 * i])})
            for m0, m1, m2 in self._marks:
                self.train_seconds['rollout'] += self._seconds(m0, m1)
                self.train_seconds['update'] += self._seconds(m1, m2)
            self.last_results = results
            if self.log_interval and self.is_lead:
                self.logger.add_scalar(f'{self.ALGO.lower()}/mean_reward',
                                       results['mean_reward'], self.total_steps)
                self.logger.dump_scalars()
        self.save(self.checkpoint_path)

    def run(self, env=None, n_episodes=10, **kwargs):
        """``n_episodes`` episodes of the protagonist's mode on the stateful
        ``env`` (the eval env by default), no adversary; numpy ``ep_returns``."""
        return self._run_episodes(self.eval_env if env is None else env, n_episodes)

    # ------------------------------------------------------------------
    def _agents_state(self):
        return {'agent': self.agent.state_dict(), 'adversary': self.adversary.state_dict()}

    def _load_agents(self, state):
        self.agent.load_state_dict(state['agent'])
        if 'adversary' in state:
            self.adversary.load_state_dict(state['adversary'])

    def save(self, path):
        """Checkpoint both agents, ``total_steps``, the generator's state and,
        when training, the env states and obs (sharded: gathered by every
        rank, written by rank 0)."""
        if not path:
            return
        from safe_control_gym_tpu_torch.utils.checkpoint import save_checkpoint
        from safe_control_gym_tpu_torch.utils.convert import env_state_to_numpy
        state = {**self._agents_state(), 'total_steps': int(self.total_steps),
                 'key': self.gen.get_state().numpy()}
        if self.training and self._env_states is not None:
            est, obs = self._whole_envs()
            state['env_states'] = env_state_to_numpy(est)
            state['obs'] = obs.cpu().numpy()
        if self.is_lead:
            save_checkpoint(path, state)

    def load(self, path):
        """Restore a checkpoint of the port or of the JAX package (a JAX PRNG
        key re-seeds the generator from the controller's seed)."""
        from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, plain
        from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy
        state = plain(load_checkpoint(path)['raw'])
        self._load_agents(state)
        self.total_steps = int(state.get('total_steps', 0))
        self._restore_generator(state.get('key'))
        if 'env_states' in state:
            self._env_states = env_state_from_numpy(state['env_states'], self.device)
            self._obs = torch.tensor(np.asarray(state['obs'], np.float32), device=self.device)
