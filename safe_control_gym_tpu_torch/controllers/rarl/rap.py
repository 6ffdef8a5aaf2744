"""RARL with adversarial populations (RAP): each env faces one of ``num_adversaries``.

Port of ``safe_control_gym_tpu/controllers/rarl/rap.py``. Before each rollout
every env is assigned a member of the population, a balanced assignment (the
round-robin ``arange(N) % A`` under a random permutation), and each rollout
step draws each env's adversary action from its member: the members' stacked
weights are gathered by the assignment and applied with ``torch.bmm``, one
product a layer for the whole batch. The adversary's data keep the (T, N)
layout; in the adversary phase each member updates on its own envs' columns.
As in the JAX package, the population's returns use no terminal or last
value, and the adversary acts in both phases. Checkpoints hold the
protagonist and every member.

    ctrl = make('rap', partial(make, 'cartpole', device='cuda',
                               adversary_disturbance='dynamics', **task),
                training=True, seed=0, num_adversaries=2, **algo_config)
    ctrl.reset(); ctrl.learn()
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import compute_returns_and_advantages
from safe_control_gym_tpu_torch.controllers.rarl.rarl import RARL
from safe_control_gym_tpu_torch.math.distributions import Normal
from safe_control_gym_tpu_torch.math.networks import ACTIVATIONS
from safe_control_gym_tpu_torch.math.optim import tree_leaves, tree_unflatten

__all__ = ['RAP', 'member_forward']


def member_forward(stack, assign, obs, activation='tanh'):
    """The MLP ``stack`` (layers of w (A, in, out), b (A, out)) with each row
    of ``obs`` (N, in) through its member ``assign`` (N,): (N, out)."""
    act = ACTIVATIONS[activation]
    h = obs[:, None, :]
    for i, layer in enumerate(stack):
        h = torch.bmm(h, layer['w'][assign]) + layer['b'][assign][:, None, :]
        if i < len(stack) - 1:
            h = act(h)
    return h[:, 0, :]


class RAP(RARL):
    """RARL with a population of adversaries."""

    ALGO = 'RAP'

    def __init__(self, env_func, num_adversaries: int = 2, **kwargs):
        super().__init__(env_func, **kwargs)
        # After the base class, which sets the default config's count.
        self.num_adversaries = int(num_adversaries)
        self.adversaries = [self._ppo_agent(self.env.adversary_action_space, self.seed + 1 + i)
                            for i in range(self.num_adversaries)]
        if self.N % self.num_adversaries != 0:
            raise ValueError('rollout_batch_size must be divisible by num_adversaries')
        self._assign = None

    def _all_agents(self):
        return [self.agent, *self.adversaries]

    def sample_assignment(self):
        """A balanced random assignment of the N envs to the members (of all
        N, also when sharded)."""
        base = torch.arange(self.N, device=self.device) % self.num_adversaries
        return base[torch.randperm(self.N, generator=self.gen, device=self.device)]

    def _stacked(self):
        """The members' parameters stacked leaf by leaf (leading axis A)."""
        leaves = [tree_leaves(a.params) for a in self.adversaries]
        return tree_unflatten(self.adversaries[0].params,
                              [torch.stack(ls) for ls in zip(*leaves)])

    def _adversary_step(self, obs, draws):
        """Each env's action, log-prob and value from its assigned member."""
        stack = self._stacked_params
        assign = self._shards.take(self._assign) if self._shards else self._assign
        activation = self.adversaries[0].activation
        dist = Normal(member_forward(stack['actor'], assign, obs, activation),
                      torch.exp(stack['logstd'][assign]))
        a = self._sample(dist, draws)
        return a, dist.log_prob(a), member_forward(stack['critic'], assign, obs, activation)

    def _adversary_terminal_value(self, obs):
        return torch.zeros((obs.shape[0], 1), device=obs.device)

    def _adversary_batch(self, ys, a_last):
        """The population's data in the (T, N, ...) layout, its returns with
        no terminal or last value."""
        a_rets, a_advs = compute_returns_and_advantages(
            -ys['rew'], ys['a_v'], ys['mask'], torch.zeros_like(ys['rew']),
            torch.zeros_like(a_last), self.gamma, bool(self.use_gae), float(self.gae_lambda))
        return {'obs': ys['obs'], 'act': ys['a_act'], 'logp': ys['a_logp'],
                'adv': self._normalized(a_advs), 'ret': a_rets, 'v': ys['a_v']}

    @torch.no_grad()
    def rollout(self, use_adversary=True, p_noise=None, a_noise=None, assign=None):
        """``RARL.rollout`` with each env's adversary its member under
        ``assign`` (N,), drawn afresh where not given."""
        self._assign = self.sample_assignment() if assign is None else torch.as_tensor(
            assign, dtype=torch.int64, device=self.device)
        self._stacked_params = self._stacked()
        return super().rollout(True, p_noise, a_noise)

    def _update(self, protagonist, p_batch, a_data):
        """The protagonist's update, or each member's on its envs' columns;
        returns the losses (the members' mean), unread."""
        if protagonist:
            return self.agent.update_tensors(p_batch, self.gen, rows=self._batch_rows)
        T = a_data['obs'].shape[0]
        losses = []
        for k, member in enumerate(self.adversaries):
            idx = torch.nonzero(self._assign == k)[:, 0]
            rows = None
            if self._shards:
                # The member's envs of all N; this rank's columns of them.
                rows, idx = self._shards.batch_rows(T, idx)
            losses.append(member.update_tensors({name: v[:, idx].reshape(T * idx.shape[0], -1)
                                                 for name, v in a_data.items()}, self.gen,
                                                rows=rows))
        return torch.stack(losses).mean(dim=0)

    def _agents_state(self):
        return {'agent': self.agent.state_dict(),
                'adversaries': [a.state_dict() for a in self.adversaries]}

    def _load_agents(self, state):
        self.agent.load_state_dict(state['agent'])
        for member, sd in zip(self.adversaries, state.get('adversaries', [])):
            member.load_state_dict(sd)
