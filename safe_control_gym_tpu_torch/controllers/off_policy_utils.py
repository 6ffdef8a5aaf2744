"""The off-policy learners' replay ring on the device, and their shared training loop.

Port of ``safe_control_gym_tpu/controllers/off_policy_utils.py``: a dict of
preallocated (max_size, dim) float32 tensors with a write pointer and a
count of rows pushed, so that pushing and sampling stay on the device. CBF-NN,
SAC, DDPG and SafeExplorerPPO's constraint buffer train from it. A push
writes its rows into the ring in place.

    state = replay_init({'obs': 4, 'act': 1}, max_size=1000, device='cuda')
    replay_push(state, {'obs': obs, 'act': act})   # N rows each
    batch = replay_sample(state, torch.Generator('cuda').manual_seed(0), 64)

Sharded over ``torch.distributed`` ranks (``SAC.shard_over``), each rank's
ring holds its own envs' rows, so that a push stays local: with N envs over
W ranks and ``max_size`` a multiple of N, row ``s N + e`` of the one-process
ring is row ``s N/W + e - lo`` of the ring of the rank that holds env e.
``replay_sample_sharded`` draws the indices of the one-process sample from
the shared generator and sums each rank's rows of it into the whole batch on
every rank (``replay_take`` and ``replay_gather`` convert between the two
layouts).

``OffPolicyController`` is what SAC and DDPG (``controllers/sac/sac.py``,
``controllers/ddpg/ddpg.py``) share: the collect into the ring, the train
phase, ``learn`` with the JAX package's interval and ``fused_iterations``
bookkeeping, the batched evaluation, ``save`` and ``load``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from safe_control_gym_tpu_torch.controllers.base_controller import RLController
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['ReplayState', 'replay_init', 'replay_push', 'replay_sample', 'replay_take',
           'replay_gather', 'replay_sample_sharded', 'OffPolicyController']


@dataclass
class ReplayState:
    data: Dict[str, torch.Tensor]   # each (max_size, dim)
    ptr: torch.Tensor               # int64, the next row to write
    count: torch.Tensor             # int64, rows pushed (may exceed max_size)

    def replace(self, **changes) -> 'ReplayState':
        return dataclasses.replace(self, **changes)


def replay_init(specs: Dict[str, int], max_size: int, device='cuda') -> ReplayState:
    """An empty ring of ``max_size`` rows; ``specs`` maps a name to its width."""
    dev = resolve_device(device)
    data = {k: torch.zeros((int(max_size), d), device=dev) for k, d in specs.items()}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return ReplayState(data=data, ptr=zero, count=zero.clone())


def replay_push(state: ReplayState, batch: Dict[str, torch.Tensor]) -> ReplayState:
    """Write the N rows of ``batch`` into ``state``'s tensors at the pointer
    (ring order), in place, so that a push costs the rows and not a copy of
    the ring; returns ``state``."""
    n = next(iter(batch.values())).shape[0]
    max_size = next(iter(state.data.values())).shape[0]
    idx = (state.ptr + torch.arange(n, device=state.ptr.device)) % max_size
    for k, v in state.data.items():
        v.index_copy_(0, idx, batch[k].reshape(n, -1).to(v))
    state.ptr = (state.ptr + n) % max_size
    state.count = state.count + n
    return state


def replay_sample(state: ReplayState, gen: torch.Generator, batch_size: int
                  ) -> Dict[str, torch.Tensor]:
    """``batch_size`` rows drawn uniformly, with replacement, from the filled
    part, from ``gen`` (on the ring's device), with no read to the host."""
    max_size = next(iter(state.data.values())).shape[0]
    filled = torch.clamp(state.count, min=1, max=max_size)
    u = torch.rand((batch_size,), generator=gen, device=state.ptr.device)
    idx = torch.minimum((u * filled).long(), filled - 1)
    return {k: v[idx] for k, v in state.data.items()}


def replay_take(state: ReplayState, shards) -> ReplayState:
    """A rank's ring (``parallel/sharding.EnvShards`` ``shards``) from the
    one-process ring of the N envs."""
    n, nl = shards.n, shards.hi - shards.lo
    max_size = next(iter(state.data.values())).shape[0]
    if max_size % n != 0:
        raise ValueError(f'a sharded replay ring needs max_buffer_size ({max_size}) to be a '
                         f'multiple of rollout_batch_size ({n})')
    data = {k: v.reshape(max_size // n, n, -1)[:, shards.lo:shards.hi].reshape(-1, v.shape[1])
            .clone() for k, v in state.data.items()}
    return ReplayState(data=data, ptr=state.ptr * nl // n, count=state.count * nl // n)


def replay_gather(state: ReplayState, shards) -> ReplayState:
    """``replay_take``'s inverse: the one-process ring, on every rank."""
    n, nl = shards.n, shards.hi - shards.lo
    out = {}
    for k, v in state.data.items():
        slots = v.shape[0] // nl
        full = v.new_zeros((slots, n, v.shape[1]))
        full[:, shards.lo:shards.hi] = v.reshape(slots, nl, -1)
        out[k] = shards.psum(full).reshape(slots * n, -1)
    return ReplayState(data=out, ptr=state.ptr * n // nl, count=state.count * n // nl)


def replay_sample_sharded(state: ReplayState, gen: torch.Generator, batch_size: int,
                          shards) -> Dict[str, torch.Tensor]:
    """``replay_sample`` of the one-process ring when each rank holds its
    envs' rows (``replay_take``): the same indices, drawn from ``gen`` at the
    global width, and every rank's rows of them summed (the others' are
    zeros) into the whole batch, on every rank."""
    n, nl, lo = shards.n, shards.hi - shards.lo, shards.lo
    local_max = next(iter(state.data.values())).shape[0]
    filled = torch.clamp(state.count * (n // nl), min=1, max=local_max * (n // nl))
    u = torch.rand((batch_size,), generator=gen, device=state.ptr.device)
    idx = torch.minimum((u * filled).long(), filled - 1)
    env = idx % n
    mine = (env >= lo) & (env < lo + nl)
    local = torch.where(mine, (idx // n) * nl + env - lo, torch.zeros_like(idx))
    names = list(state.data)
    rows = torch.cat([state.data[k][local] for k in names], dim=1)
    rows = shards.psum(torch.where(mine[:, None], rows, torch.zeros_like(rows)))
    return dict(zip(names, torch.split(rows, [state.data[k].shape[1] for k in names], dim=1)))


LOSS_NAMES = ('policy_loss', 'critic_loss')


class OffPolicyController(RLController):
    """What SAC and DDPG share: the N training envs and the replay ring on
    the device, the collect-and-update loop of ``learn``, the batched
    evaluation, ``save`` and ``load``. A subclass builds ``self.agent`` (with
    ``update``, ``state_dict``, ``load_state_dict``) before calling
    ``_setup_training``, and gives ``_explore`` (a collect step's action)
    and ``_deterministic_action``."""

    def _setup_training(self):
        self.eval_env = self.env_func(seed=self.seed * 111 + 1)
        self.func_env = self.env.func
        self.N = int(self.rollout_batch_size)
        self.steps_per_iter = max(1, int(self.train_interval) // self.N)
        obs_dim = self.env.observation_space.shape[0]
        act_dim = self.env.action_space.shape[0]
        self.act_low = self._tensor(self.env.action_space.low)
        self.act_high = self._tensor(self.env.action_space.high)
        self.buffer = replay_init({'obs': obs_dim, 'act': act_dim, 'rew': 1,
                                   'next_obs': obs_dim, 'mask': 1},
                                  int(self.max_buffer_size), device=self.device)
        self.total_steps = 0
        # Seconds of device time in the collects and in the updates of learn().
        self.train_seconds = {'collect': 0.0, 'update': 0.0}
        self.last_results = {}     # the last training iteration's scalars
        self._env_states = None
        self._obs = None

    def reset(self):
        """Start the N training envs afresh (when training; sharded, this
        rank's rows of them) and clear the results."""
        if self.training:
            self._env_states, self._obs = self._start_envs()
            self._reset_noise()
        self.setup_results_dict()

    def _shard_envs(self, mesh, axis_name):
        """This rank's rows of the envs and of the ring, and rank 0's agent
        (``SAC.shard_over``)."""
        from safe_control_gym_tpu_torch.parallel.sharding import EnvShards, replicate
        shards = EnvShards(mesh, axis_name, self.N, self.device)
        if self._env_states is None:
            self.reset()
        self._env_states, self._obs = shards.take((self._env_states, self._obs))
        self.buffer = replay_take(self.buffer, shards)
        replicate(mesh, self.agent.train_state())
        self._shards = shards

    def _reset_noise(self):
        pass

    def _random_action(self, u):
        """Uniform in the action box from U[0, 1) draws ``u``, as
        ``jax.random.uniform`` maps them."""
        return torch.maximum(self.act_low, u * (self.act_high - self.act_low) + self.act_low)

    def _explore(self, obs, random_phase, draws):
        """A collect step's actions on ``obs`` (N, obs_dim)."""
        raise NotImplementedError

    def _deterministic_action(self, obs):
        raise NotImplementedError

    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect(self, random_phase: bool, draws=None):
        """``steps_per_iter`` steps of the N envs from the current env states,
        each transition written into the ring; returns the mean reward,
        unread. ``draws[t]``, where given, takes the place of step t's draws
        from the generator (see the subclass's ``_explore``)."""
        est, obs = self._env_states, self._obs
        rews = []
        for t in range(self.steps_per_iter):
            act = self._explore(obs, random_phase, None if draws is None else draws[t])
            est, out, next_obs = self._step_envs(est, act)
            self._after_step(out)
            # The terminal obs is next_obs; a time limit keeps the bootstrap.
            mask = 1.0 - (out.done & ~out.truncated).to(torch.float32)
            replay_push(self.buffer, {'obs': obs, 'act': act, 'rew': out.reward[:, None],
                                       'next_obs': out.obs, 'mask': mask[:, None]})
            obs = next_obs
            rews.append(out.reward)
        self._env_states, self._obs = est, obs
        rews = torch.stack(rews)
        return self._shards.psum.mean(rews) if self._shards else rews.mean()

    def _after_step(self, out):
        pass

    def train_phase(self, batches=None, noises=None):
        """``train_interval`` updates on batches drawn from the ring (or the
        given ``batches``, with ``noises`` for the agent's draws); returns the
        mean ``[policy_loss, critic_loss]``, unread."""
        losses = []
        for i in range(int(self.train_interval)):
            if batches is not None:
                batch = batches[i]
            elif self._shards:
                batch = replay_sample_sharded(self.buffer, self.gen, int(self.train_batch_size),
                                              self._shards)
            else:
                batch = replay_sample(self.buffer, self.gen, int(self.train_batch_size))
            losses.append(self.agent.update(batch, self.gen,
                                            None if noises is None else noises[i]))
        return torch.stack(losses).mean(dim=0)

    def _iteration(self, random_phase, train):
        """One collect and, with ``train``, one train phase; the scalars as
        one tensor ``[mean_reward, policy_loss, critic_loss]`` (NaN losses
        without ``train``), unread."""
        m0 = self._mark()
        mean_rew = self.collect(random_phase)
        m1 = self._mark()
        if train:
            losses = self.train_phase()
        else:
            losses = torch.full((2,), float('nan'), device=self.device)
        m2 = self._mark()
        self._marks.append((m0, m1, m2))
        return torch.cat([mean_rew[None], losses])

    def learn(self, env=None, **kwargs):
        """Train until ``total_steps`` reaches ``max_env_steps``, with the
        log, save and eval intervals, then save to ``checkpoint_path`` with
        the ring."""
        if self._env_states is None:
            self.reset()
        max_env_steps = int(self.max_env_steps)
        warm_up = int(self.warm_up_steps)
        steps_per_iter = self.steps_per_iter * self.N
        fused_k = max(1, int(getattr(self, 'fused_iterations', 1)))
        best_eval = -np.inf
        while self.total_steps < max_env_steps:
            start = time.time()
            self._marks = []
            self._advance_schedule(steps_per_iter)
            if self.total_steps >= warm_up and fused_k > 1:
                out = torch.stack([self._iteration(False, True)
                                   for _ in range(fused_k)]).mean(dim=0)
                self.total_steps += steps_per_iter * (fused_k - 1)
            else:
                out = self._iteration(self.total_steps < warm_up, self.total_steps >= warm_up)
            values = out.cpu().numpy()
            results = {'mean_reward': float(values[0])}
            if not np.isnan(values[1]):
                results.update(zip(LOSS_NAMES, map(float, values[1:])))
            for m0, m1, m2 in self._marks:
                self.train_seconds['collect'] += self._seconds(m0, m1)
                self.train_seconds['update'] += self._seconds(m1, m2)
            self.total_steps += steps_per_iter
            results['elapsed_time'] = time.time() - start
            results['step'] = self.total_steps
            if (self.log_interval and self.total_steps % self.log_interval < steps_per_iter
                    and self.is_lead):
                for k, v in results.items():
                    if k != 'step':
                        self.logger.add_scalar(f'{self.ALGO.lower()}/{k}', v, self.total_steps)
                self.logger.dump_scalars()
            if self.save_interval and self.total_steps % self.save_interval < steps_per_iter:
                self.save(os.path.join(self.output_dir, 'checkpoints',
                                       f'model_{self.total_steps}.pt'))
            if self.eval_interval and self.total_steps % self.eval_interval < steps_per_iter:
                results['eval_return'] = float(
                    self.run(n_episodes=int(self.eval_batch_size))['ep_returns'].mean())
                if self.eval_save_best and results['eval_return'] > best_eval:
                    best_eval = results['eval_return']
                    self.save(os.path.join(self.output_dir, 'model_best.pt'))
            self.last_results = results
        # The last checkpoint carries the ring, for an exact resume.
        self.save(self.checkpoint_path, save_buffer=True)

    def _advance_schedule(self, steps):
        pass

    def run(self, env=None, n_episodes=10, **kwargs):
        """Deterministic evaluation on ``n_episodes`` envs at once
        (``RLController._evaluate``): numpy ``ep_returns``, ``ep_lengths``
        and ``ep_mse``."""
        return self._evaluate(self.eval_env if env is None else env, n_episodes,
                              self._deterministic_action)

    def select_action(self, obs, info=None):
        """The deterministic action, as numpy float32."""
        with torch.no_grad():
            return self._deterministic_action(self._tensor(obs)).cpu().numpy()

    # ------------------------------------------------------------------
    def _extra_state(self):
        return {}

    def _restore_extra(self, state):
        pass

    def save(self, path, save_buffer=False):
        """Checkpoint the agent, ``total_steps`` and the generator's state (as
        ``key``) and, when training, the env states and obs; ``save_buffer``
        adds the replay ring. Sharded, every rank calls it (the state is
        gathered in the one-process layout) and rank 0 writes."""
        if not path:
            return
        from safe_control_gym_tpu_torch.utils.checkpoint import save_checkpoint
        from safe_control_gym_tpu_torch.utils.convert import env_state_to_numpy, replay_to_numpy
        sh = self._shards
        state = {'agent': self.agent.state_dict(), 'total_steps': int(self.total_steps),
                 'key': self.gen.get_state().numpy()}
        if self.training and self._env_states is not None:
            est, obs = self._whole_envs()
            state['env_states'] = env_state_to_numpy(est)
            state['obs'] = obs.cpu().numpy()
            state.update(self._extra_state())
            if save_buffer:
                state['buffer'] = replay_to_numpy(self.buffer if sh is None
                                                  else replay_gather(self.buffer, sh))
        if self.is_lead:
            save_checkpoint(path, state)

    def load(self, path):
        """Restore a checkpoint of the port or of the JAX package (a JAX PRNG
        key re-seeds the generator from the controller's seed)."""
        from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, plain
        from safe_control_gym_tpu_torch.utils.convert import (env_state_from_numpy,
                                                              replay_from_numpy)
        state = plain(load_checkpoint(path)['raw'])
        self.agent.load_state_dict(state['agent'])
        self.total_steps = int(state.get('total_steps', 0))
        self._restore_generator(state.get('key'))
        if 'env_states' in state:
            self._env_states = env_state_from_numpy(state['env_states'], self.device)
            self._obs = torch.tensor(np.asarray(state['obs'], np.float32), device=self.device)
            self._restore_extra(state)
        if 'buffer' in state:
            self.buffer = replay_from_numpy(state['buffer'], self.device)
