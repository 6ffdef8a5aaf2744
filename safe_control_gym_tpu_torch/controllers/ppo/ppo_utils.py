"""The PPO actor-critic, GAE and the agent with its KL-gated update.

Port of ``safe_control_gym_tpu/controllers/ppo/ppo_utils.py``. The parameters
are the JAX package's pytree as tensors: ``{'actor': [...], 'critic': [...],
'logstd': (act_dim,)}`` (no ``logstd`` for a discrete actor, whose outputs
are the logits of a Categorical) with the layer layout of
``math/networks.py``. The gradients are ``torch.autograd`` over the plain
forward pass; the optimizers are ``math/optim.py``'s functional
clip-and-Adam, so that the KL gate can reject a whole actor step, optimizer
state included, with ``torch.where`` and no read-back.

    agent = PPOAgent(obs_space, act_space, hidden_dim=64, device='cuda')
    losses = agent.update(batch, gen)   # batch: dict of (M, ...) tensors

After ``agent.shard(mesh, 'env')`` (``PPO.shard_over``) each rank holds its
rows of the batch and the update is data parallel: a minibatch's rows live
on several ranks, each rank's losses are its rows' part of the minibatch
mean, and the gradients and losses are summed over the env axis in one
``all_reduce`` a minibatch, so that every rank takes the same step, KL gate
included. With ``model_axis`` the MLPs are also split over the model axis
(``parallel/sharding.TPMLP``), their Adam moments with them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from safe_control_gym_tpu_torch.math import optim
from safe_control_gym_tpu_torch.math.distributions import Categorical, Normal
from safe_control_gym_tpu_torch.math.networks import mlp_apply, mlp_init
from safe_control_gym_tpu_torch.math.optim import tree_leaves, tree_unflatten
from safe_control_gym_tpu_torch.utils.device import resolve_device
from safe_control_gym_tpu_torch.utils.profiling import annotate

__all__ = ['init_actor_critic', 'actor_dist', 'critic_value',
           'compute_returns_and_advantages', 'normalize_advantages', 'PPOAgent']

LOSS_NAMES = ('policy_loss', 'value_loss', 'entropy_loss', 'approx_kl')


def init_actor_critic(gen: torch.Generator, obs_dim: int, act_dim: int, hidden_dims,
                      init_logstd: float = -0.5, discrete: bool = False, device=None):
    """Actor (MLP -> mean with a learned logstd, or logits when ``discrete``)
    and critic MLP parameters drawn from ``gen``."""
    device = gen.device if device is None else torch.device(device)
    params = {
        'actor': mlp_init(gen, obs_dim, act_dim, hidden_dims, device=device),
        'critic': mlp_init(gen, obs_dim, 1, hidden_dims, out_gain=1.0, device=device),
    }
    if not discrete:
        params['logstd'] = torch.full((act_dim,), init_logstd, device=device)
    return params


def actor_dist(params, obs, activation='tanh'):
    """The Gaussian policy on ``obs`` (the actor's output as mean,
    ``exp(logstd)`` as std), or a Categorical over the actor's logits where
    the parameters hold no ``logstd``."""
    out = mlp_apply(params['actor'], obs, activation)
    if 'logstd' in params:
        return Normal(out, torch.exp(params['logstd']))
    return Categorical(out)


def critic_value(params, obs, activation='tanh'):
    return mlp_apply(params['critic'], obs, activation)


def compute_returns_and_advantages(rews, vals, masks, terminal_vals=None, last_val=None,
                                   gamma=0.99, use_gae=False, gae_lambda=0.95):
    """Discounted returns and advantages (GAE or ``ret - v``), by a loop over
    reversed time. ``rews``, ``vals``, ``masks``, ``terminal_vals`` (T, N, 1),
    ``last_val`` (N, 1); returns ``(rets, advs)``, each (T, N, 1). The value
    of a truncated step's final obs, ``terminal_vals``, is added to its
    reward, discounted."""
    if terminal_vals is None:
        terminal_vals = torch.zeros_like(rews)
    if last_val is None:
        last_val = torch.zeros_like(rews[0])
    rews = rews + gamma * terminal_vals
    vals_next = torch.cat([vals[1:], last_val[None]], dim=0)
    ret, adv = last_val, torch.zeros_like(last_val)
    rets, advs = [], []
    for t in range(rews.shape[0] - 1, -1, -1):
        ret = rews[t] + gamma * masks[t] * ret
        if use_gae:
            td = rews[t] + gamma * masks[t] * vals_next[t] - vals[t]
            adv = adv * gae_lambda * gamma * masks[t] + td
        else:
            adv = ret - vals[t]
        rets.append(ret)
        advs.append(adv)
    return torch.stack(rets[::-1]), torch.stack(advs[::-1])


def normalize_advantages(advs, psum=None):
    """``(advs - mean) / (std + 1e-6)``, the population std; ``psum``
    (``parallel/sharding.AxisSum``) takes the statistics over every rank's
    advantages."""
    if psum is None:
        return (advs - advs.mean()) / (advs.std(correction=0) + 1e-6)
    mean = psum.mean(advs)
    std = torch.sqrt(psum.mean((advs - mean) ** 2))
    return (advs - mean) / (std + 1e-6)


def _mean(x, own):
    """The minibatch mean of the per-row ``x``; with ``own`` (the rows this
    rank holds), this rank's part of it."""
    if own is None:
        return x.mean()
    return torch.where(own, x, torch.zeros_like(x)).sum() / x.numel()


class PPOAgent:
    """The actor-critic's parameters, the two optimizer states and the update.

    ``act_space`` with an ``n`` is discrete (a Categorical actor), else a box
    of ``shape[0]`` actions. ``seed`` draws the parameters from a generator
    on ``device`` (the card unless the caller passes the CPU)."""

    def __init__(self, obs_space, act_space, hidden_dim=64, use_clipped_value=False,
                 clip_param=0.2, target_kl=0.01, entropy_coef=0.01, actor_lr=3e-4,
                 critic_lr=1e-3, opt_epochs=10, mini_batch_size=64, activation='tanh',
                 max_grad_norm=0.5, seed=0, device='cuda', **kwargs):
        self.device = resolve_device(device)
        self.obs_dim = obs_space.shape[0]
        self.discrete = hasattr(act_space, 'n')
        self.act_dim = int(act_space.n) if self.discrete else act_space.shape[0]
        self.use_clipped_value = use_clipped_value
        self.clip_param = clip_param
        self.target_kl = target_kl
        self.entropy_coef = entropy_coef
        self.actor_lr = actor_lr
        self.critic_lr = critic_lr
        self.opt_epochs = opt_epochs
        self.mini_batch_size = mini_batch_size
        self.activation = activation
        self.max_grad_norm = max_grad_norm
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.params = init_actor_critic(gen, self.obs_dim, self.act_dim,
                                        [int(hidden_dim)] * 2, discrete=self.discrete)
        self.actor_opt_state = optim.adam_init(tree_leaves(self._actor_sub(self.params)))
        self.critic_opt_state = optim.adam_init(tree_leaves(self.params['critic']))
        self.mesh = self.env_axis = self.model_axis = None

    def shard(self, mesh, env_axis='env', model_axis=None):
        """Take rank 0's parameters and optimizer states on every rank, and
        update data parallel over ``env_axis``; with ``model_axis`` (of more
        than one rank) split the MLPs and their Adam moments over it."""
        from safe_control_gym_tpu_torch.parallel import sharding
        mesh.check_device(self.device)
        sharding.replicate(mesh, (self.params, self.actor_opt_state, self.critic_opt_state))
        self.mesh, self.env_axis = mesh, env_axis
        if model_axis is not None and mesh.shape[model_axis] > 1:
            self.model_axis = model_axis
            specs = sharding.actor_critic_tp_shardings(mesh, self.params, model_axis)
            self.params = sharding.shard_params(mesh, self.params, specs, model_axis)
            self.actor_opt_state = sharding.shard_adam(mesh, model_axis, self.actor_opt_state,
                                                       self._actor_sub(self.params))
            self.critic_opt_state = sharding.shard_adam(mesh, model_axis, self.critic_opt_state,
                                                        self.params['critic'])

    def full_params(self):
        """The whole parameters (gathered over the model axis when split)."""
        if self.model_axis is None:
            return self.params
        from safe_control_gym_tpu_torch.parallel.sharding import gather_params
        return gather_params(self.params)

    @staticmethod
    def _actor_sub(params):
        return {k: params[k] for k in ('actor', 'logstd') if k in params}

    # -- losses -----------------------------------------------------------
    def policy_loss_fn(self, actor_params, obs, act, logp_old, adv, own=None):
        """Clipped surrogate plus entropy; returns ``(total, (policy_loss,
        entropy_loss, approx_kl))``. The log-ratio is clipped to +-20 before
        ``exp``, so a far off-policy action keeps the loss finite. ``own``
        (M, 1) bool: the rows this rank holds of a sharded minibatch, whose
        part of each mean the losses are."""
        dist = actor_dist(actor_params, obs, self.activation)
        logp = dist.log_prob(act)
        ratio = torch.exp(torch.clamp(logp - logp_old, -20.0, 20.0))
        clip_adv = torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param) * adv
        policy_loss = -_mean(torch.minimum(ratio * adv, clip_adv), own)
        entropy_loss = -_mean(dist.entropy(), own)
        approx_kl = _mean(logp_old - logp, own)
        return policy_loss + self.entropy_coef * entropy_loss, (policy_loss, entropy_loss,
                                                                approx_kl)

    def value_loss_fn(self, critic_params, obs, ret, v_old, own=None):
        """Half the mean squared error of the value, optionally clipped
        (``own`` as in ``policy_loss_fn``)."""
        v_cur = mlp_apply(critic_params, obs, self.activation)
        if self.use_clipped_value:
            v_clipped = v_old + torch.clamp(v_cur - v_old, -self.clip_param, self.clip_param)
            return 0.5 * _mean(torch.maximum((v_cur - ret) ** 2, (v_clipped - ret) ** 2), own)
        return 0.5 * _mean((v_cur - ret) ** 2, own)

    # -- update -----------------------------------------------------------
    def minibatch_plan(self, m: int):
        """``(mb, num_mb, used)``: the minibatch size clamped to the batch,
        the minibatches an epoch and the rows they use (the tail past
        ``used`` is dropped)."""
        mb = min(int(self.mini_batch_size), m)
        num_mb = max(m // mb, 1)
        return mb, num_mb, num_mb * mb

    def _reduce(self, a_grads, c_grads, losses):
        """The gradients and the losses summed over the env axis, in one
        ``all_reduce``."""
        grads = a_grads + c_grads
        flat = self.mesh.psum(torch.cat([g.reshape(-1) for g in grads] + [losses]),
                              self.env_axis)
        pieces = torch.split(flat, [g.numel() for g in grads] + [losses.numel()])
        grads = [p.view_as(g) for p, g in zip(pieces, grads)]
        return grads[:len(a_grads)], grads[len(a_grads):], pieces[-1]

    def _norm(self, grads, tree):
        """The global norm of split gradients (None where nothing is split:
        the optimizer takes it whole)."""
        if self.model_axis is None:
            return None
        from safe_control_gym_tpu_torch.parallel.sharding import leaf_dims, tp_sq_norm
        return torch.sqrt(tp_sq_norm(self.mesh, self.model_axis, grads, leaf_dims(tree)))

    def _minibatch_step(self, mbatch):
        own = mbatch.get('own')
        actor_sub = self._actor_sub(self.params)
        a_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(actor_sub)]
        with torch.enable_grad():
            total, (p_loss, e_loss, kl) = self.policy_loss_fn(
                tree_unflatten(actor_sub, a_leaves), mbatch['obs'], mbatch['act'],
                mbatch['logp'], mbatch['adv'], own)
            a_grads = list(torch.autograd.grad(total, a_leaves))
        c_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params['critic'])]
        with torch.enable_grad():
            v_loss = self.value_loss_fn(tree_unflatten(self.params['critic'], c_leaves),
                                        mbatch['obs'], mbatch['ret'], mbatch['v'], own)
            c_grads = list(torch.autograd.grad(v_loss, c_leaves))
        losses = torch.stack([p_loss, v_loss, e_loss, kl]).detach()
        if self.mesh is not None:
            a_grads, c_grads, losses = self._reduce(a_grads, c_grads, losses)
            kl = losses[3]
        with annotate('ppo.update.optim'):
            a_old = [p.detach() for p in a_leaves]
            a_new, a_state_new = optim.clip_adam_step(a_old, a_grads, self.actor_opt_state,
                                                      self.actor_lr, self.max_grad_norm,
                                                      self._norm(a_grads, actor_sub))
            # The KL gate: a step whose approximate KL passes 1.5 target_kl is
            # rejected whole, the actor's optimizer state included.
            if self.target_kl <= 0:
                a_applied, a_state = a_new, a_state_new
            else:
                gate = kl.detach() <= 1.5 * self.target_kl
                a_applied = optim.select(gate, a_new, a_old)
                a_state = optim.select(gate, a_state_new, self.actor_opt_state)
            c_new, self.critic_opt_state = optim.clip_adam_step(
                [p.detach() for p in c_leaves], c_grads, self.critic_opt_state,
                self.critic_lr, self.max_grad_norm, self._norm(c_grads, self.params['critic']))
            self.actor_opt_state = a_state
            self.params = {**tree_unflatten(actor_sub, a_applied),
                           'critic': tree_unflatten(self.params['critic'], c_new)}
        return losses

    def update_tensors(self, batch: Dict[str, torch.Tensor], gen: torch.Generator = None,
                       perms=None, rows=None) -> torch.Tensor:
        """``opt_epochs`` epochs of minibatch steps over ``batch`` (dict of
        (M, ...) tensors), each epoch on ``torch.randperm(M, generator=gen)``
        cut to the rows used, or on ``perms[epoch]`` where given. Returns the
        four mean losses as one tensor on the device, unread.

        ``rows``, after ``shard``: the (M,) int64 map of the whole batch's
        rows to this rank's rows of ``batch`` (-1 where another rank holds
        the row); the permutations run over the M rows of the whole batch."""
        m = batch['obs'].shape[0] if rows is None else rows.shape[0]
        if rows is not None:
            # Rows of other ranks read a zero row past this rank's and count
            # for nothing (``own``), so a rank may hold none of a minibatch.
            pad = batch['obs'].shape[0]
            rows = torch.where(rows < 0, torch.full_like(rows, pad), rows)
            own_all = rows < pad
            batch = {k: torch.cat([v, v.new_zeros((1,) + v.shape[1:])]) for k, v in batch.items()}
        mb, num_mb, used = self.minibatch_plan(m)

        def minibatch(idx):
            if rows is None:
                return {k: v[idx] for k, v in batch.items()}
            loc = rows[idx]
            return {**{k: v[loc] for k, v in batch.items()}, 'own': own_all[idx][:, None]}

        def step(idx):
            # The span holds the row gather, both losses and their gradients;
            # the step's optimizer part is its nested ``ppo.update.optim``.
            with annotate('ppo.update.grad'):
                return self._minibatch_step(minibatch(idx))

        with annotate('ppo.update'):
            epoch_losses = []
            for epoch in range(int(self.opt_epochs)):
                if perms is not None:
                    perm = torch.tensor(np.asarray(perms[epoch]), device=self.device)
                else:
                    perm = torch.randperm(m, generator=gen, device=self.device)[:used]
                losses = [step(perm[i * mb:(i + 1) * mb]) for i in range(num_mb)]
                epoch_losses.append(torch.stack(losses).mean(dim=0))
            return torch.stack(epoch_losses).mean(dim=0)

    def update(self, batch, gen=None, perms=None) -> Dict[str, float]:
        """``update_tensors``, with the mean losses read back once."""
        losses = self.update_tensors(batch, gen, perms).cpu().numpy()
        return {k: float(v) for k, v in zip(LOSS_NAMES, losses)}

    # -- acting -----------------------------------------------------------
    @torch.no_grad()
    def step(self, obs, gen: torch.Generator):
        """A sampled action, the value and the action's log-prob."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        dist = actor_dist(self.params, obs, self.activation)
        action = dist.sample(gen)
        return action, critic_value(self.params, obs, self.activation), dist.log_prob(action)

    @torch.no_grad()
    def act(self, obs):
        """The distribution's mode (the mean, or the argmax of the logits)."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        return actor_dist(self.full_params(), obs, self.activation).mode()

    # -- checkpoint -------------------------------------------------------
    def state_dict(self):
        """The JAX layout as numpy: ``params``, and ``actor_opt_state`` and
        ``critic_opt_state`` as ``{'count', 'mu', 'nu'}`` over the leaves."""
        from safe_control_gym_tpu_torch.utils.convert import adam_state_to_numpy
        full = self.full_params()
        params = tree_unflatten(full, [t.detach().cpu().numpy() for t in tree_leaves(full)])
        return {'params': params,
                'actor_opt_state': adam_state_to_numpy(self._full_opt_state(
                    self.actor_opt_state, self._actor_sub(self.params))),
                'critic_opt_state': adam_state_to_numpy(self._full_opt_state(
                    self.critic_opt_state, self.params['critic']))}

    def _full_opt_state(self, state, tree):
        """An Adam state with its moments gathered where split."""
        if self.model_axis is None:
            return state
        from safe_control_gym_tpu_torch.parallel.sharding import gather_adam
        return gather_adam(self.mesh, self.model_axis, state, tree)

    def load_state_dict(self, sd):
        """From ``state_dict``'s layout, or from the JAX package's (optax
        chain states, as ``utils/checkpoint.plain`` gives them)."""
        from safe_control_gym_tpu_torch.utils.convert import adam_state_from_numpy
        self.params = tree_unflatten(sd['params'], [
            torch.tensor(np.asarray(a, np.float32), device=self.device)
            for a in tree_leaves(sd['params'])])
        self.actor_opt_state = adam_state_from_numpy(sd['actor_opt_state'], self.device)
        self.critic_opt_state = adam_state_from_numpy(sd['critic_opt_state'], self.device)
