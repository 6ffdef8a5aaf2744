"""SAC's networks and agent: the tanh-squashed Gaussian actor, twin Q and the update.

Port of ``safe_control_gym_tpu/controllers/sac/sac_utils.py``. The parameters
are the JAX package's pytree as tensors: ``params = {'actor', 'q1', 'q2'}``
(each an ``mlp_init`` list; the actor puts out [mean, log-std] in one layer of
2 * act_dim), ``target = {'q1', 'q2'}`` and the scalar ``log_alpha``. One
update (``SACAgent.update``) is, in JAX's order:

* the twin-Q critic against a target built under ``torch.no_grad`` from the
  pre-update actor, the target networks and the pre-update alpha;
* the actor against the *updated* Q networks, alpha held fixed;
* with ``use_entropy_tuning``, the temperature from the actor loss's log-prob;
* the Polyak average of the targets, last.

The three optimizers are plain Adam in optax's defaults, no clipping
(``math/optim.adam_update``), each over its parameters' leaves in JAX's order
(``math/optim.tree_leaves``), so that a JAX checkpoint resumes as JAX would.
The update's two actor draws come from a generator, or from ``noise``, two
arrays of standard normals drawn beforehand.

    agent = SACAgent(obs_space, act_space, hidden_dim=256, device='cuda')
    losses = agent.update(batch, gen)   # batch: obs, act, rew, next_obs, mask
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from safe_control_gym_tpu_torch.math import optim
from safe_control_gym_tpu_torch.math.networks import mlp_apply, mlp_init
from safe_control_gym_tpu_torch.math.optim import adam_step, polyak, tree_leaves, tree_unflatten
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['LOG_STD_MIN', 'LOG_STD_MAX', 'init_sac_params', 'sac_actor_forward', 'q_value',
           'SACAgent']

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def init_sac_params(gen: torch.Generator, obs_dim, act_dim, hidden_dims, init_temperature=0.2,
                    device=None):
    """``(params, target, log_alpha)`` drawn from ``gen``: the actor and twin
    Q networks (uniform in +-1/sqrt(fan_in)), the targets as copies."""
    device = gen.device if device is None else torch.device(device)
    params = {
        'actor': mlp_init(gen, obs_dim, 2 * act_dim, hidden_dims, orthogonal=False, device=device),
        'q1': mlp_init(gen, obs_dim + act_dim, 1, hidden_dims, orthogonal=False, device=device),
        'q2': mlp_init(gen, obs_dim + act_dim, 1, hidden_dims, orthogonal=False, device=device),
    }
    target = {k: [{n: t.clone() for n, t in layer.items()} for layer in params[k]]
              for k in ('q1', 'q2')}
    log_alpha = torch.tensor(np.log(init_temperature), dtype=torch.float32, device=device)
    return params, target, log_alpha


def sac_actor_forward(actor_params, obs, gen, act_low, act_high, activation='relu',
                      deterministic=False, with_logprob=True, noise=None):
    """``(action, logp)``: tanh of the mean (``deterministic``) or of a draw
    (from ``gen``, or ``noise``: standard normals shaped as the mean), mapped
    affinely from [-1, 1] onto [act_low, act_high]; ``logp`` is None unless
    ``with_logprob``."""
    out = mlp_apply(actor_params, obs, activation)
    mu, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    if deterministic:
        pre = mu
    else:
        if noise is None:
            noise = torch.randn(mu.shape, generator=gen, device=gen.device)
        pre = mu + std * torch.as_tensor(noise, dtype=mu.dtype).to(mu.device)
    logp = None
    if with_logprob:
        logp = torch.sum(-0.5 * ((pre - mu) / std) ** 2 - log_std
                         - 0.5 * math.log(2 * math.pi), dim=-1, keepdim=True)
        # The tanh correction.
        logp = logp - torch.sum(2 * (math.log(2.0) - pre - F.softplus(-2 * pre)),
                                dim=-1, keepdim=True)
    action = torch.tanh(pre)
    return act_low + 0.5 * (action + 1.0) * (act_high - act_low), logp


def q_value(q_params, obs, act, activation='relu'):
    return mlp_apply(q_params, torch.cat([obs, act], dim=-1), activation)


class SACAgent:
    """SAC's parameters, targets, temperature, three Adam states and the update.

    ``seed`` draws the parameters from a generator on ``device`` (the card
    unless the caller passes the CPU)."""

    def __init__(self, obs_space, act_space, hidden_dim=256, gamma=0.99, tau=0.005,
                 init_temperature=0.2, use_entropy_tuning=False, target_entropy=None,
                 actor_lr=1e-3, critic_lr=1e-3, entropy_lr=1e-3, activation='relu', seed=0,
                 device='cuda', **kwargs):
        self.device = resolve_device(device)
        self.obs_dim = obs_space.shape[0]
        self.act_dim = act_space.shape[0]
        self.act_low = torch.as_tensor(np.asarray(act_space.low, np.float32), device=self.device)
        self.act_high = torch.as_tensor(np.asarray(act_space.high, np.float32), device=self.device)
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.use_entropy_tuning = bool(use_entropy_tuning)
        self.target_entropy = (float(target_entropy) if target_entropy is not None
                               else -float(self.act_dim))
        self.actor_lr, self.critic_lr, self.entropy_lr = actor_lr, critic_lr, entropy_lr
        self.activation = activation
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.params, self.target, self.log_alpha = init_sac_params(
            gen, self.obs_dim, self.act_dim, [int(hidden_dim)] * 2, init_temperature)
        self.actor_opt_state = optim.adam_init(tree_leaves(self.params['actor']))
        self.critic_opt_state = optim.adam_init(tree_leaves(self._q(self.params)))
        self.alpha_opt_state = optim.adam_init([self.log_alpha])
        self.mesh = self.model_axis = None

    def split(self, mesh, model_axis='model'):
        """Split the actor, twin Q and targets and their Adam moments over
        ``model_axis`` of ``mesh`` (``parallel/sharding.mlp_tp_shardings``);
        the update then runs with the model axis's collectives."""
        from safe_control_gym_tpu_torch.parallel import sharding
        specs = sharding.actor_critic_tp_shardings(mesh, self.params, model_axis)
        self.mesh, self.model_axis = mesh, model_axis
        self.params = sharding.shard_params(mesh, self.params, specs, model_axis)
        self.target = sharding.shard_params(mesh, self.target, specs, model_axis)
        self.actor_opt_state = sharding.shard_adam(mesh, model_axis, self.actor_opt_state,
                                                   self.params['actor'])
        self.critic_opt_state = sharding.shard_adam(mesh, model_axis, self.critic_opt_state,
                                                    self._q(self.params))

    def full_params(self):
        """The whole parameters (gathered over the model axis when split)."""
        if self.model_axis is None:
            return self.params
        from safe_control_gym_tpu_torch.parallel.sharding import gather_params
        return gather_params(self.params)

    @staticmethod
    def _q(params):
        return {'q1': params['q1'], 'q2': params['q2']}

    # -- update -----------------------------------------------------------
    def update(self, batch, gen: torch.Generator = None, noise=None) -> torch.Tensor:
        """One step of critic, actor, temperature and targets on ``batch``
        (dict of (B, ...) tensors: obs, act, rew, next_obs, mask). ``noise``:
        ``(n1, n2)``, the standard normals of the next action and of the
        policy action, each (B, act_dim), in place of draws from ``gen``.
        Returns ``[policy_loss, critic_loss]`` on the device, unread."""
        act_low, act_high, activation = self.act_low, self.act_high, self.activation
        n1, n2 = noise if noise is not None else (None, None)
        alpha = torch.exp(self.log_alpha)
        obs, act = batch['obs'], batch['act']
        # The critic's target: the pre-update actor and alpha, the targets.
        with torch.no_grad():
            next_act, next_logp = sac_actor_forward(self.params['actor'], batch['next_obs'], gen,
                                                    act_low, act_high, activation, noise=n1)
            nsa = torch.cat([batch['next_obs'], next_act], dim=-1)
            nq = (torch.minimum(mlp_apply(self.target['q1'], nsa, activation),
                                mlp_apply(self.target['q2'], nsa, activation))
                  - alpha * next_logp)
            q_targ = batch['rew'] + self.gamma * batch['mask'] * nq
        q_tree = self._q(self.params)
        c_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(q_tree)]
        sa = torch.cat([obs, act], dim=-1)
        with torch.enable_grad():
            q = tree_unflatten(q_tree, c_leaves)
            q1 = mlp_apply(q['q1'], sa, activation)
            q2 = mlp_apply(q['q2'], sa, activation)
            c_loss = ((q1 - q_targ) ** 2).mean() + ((q2 - q_targ) ** 2).mean()
            c_grads = torch.autograd.grad(c_loss, c_leaves)
        c_new, self.critic_opt_state = adam_step(c_leaves, c_grads, self.critic_opt_state,
                                                 self.critic_lr)
        q = tree_unflatten(q_tree, c_new)
        # The actor, against the updated Q networks.
        a_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params['actor'])]
        with torch.enable_grad():
            pi, logp = sac_actor_forward(tree_unflatten(self.params['actor'], a_leaves), obs, gen,
                                         act_low, act_high, activation, noise=n2)
            spi = torch.cat([obs, pi], dim=-1)
            q_pi = torch.minimum(mlp_apply(q['q1'], spi, activation),
                                 mlp_apply(q['q2'], spi, activation))
            p_loss = (alpha.detach() * logp - q_pi).mean()
            a_grads = torch.autograd.grad(p_loss, a_leaves)
        a_new, self.actor_opt_state = adam_step(a_leaves, a_grads, self.actor_opt_state,
                                                self.actor_lr)
        self.params = {'actor': tree_unflatten(self.params['actor'], a_new), **q}
        if self.use_entropy_tuning:
            # d/d log_alpha of -(log_alpha * (logp + target_entropy)).mean().
            al_grad = -(logp.detach() + self.target_entropy).mean()
            (self.log_alpha,), self.alpha_opt_state = adam_step(
                [self.log_alpha], [al_grad], self.alpha_opt_state, self.entropy_lr)
        self.target = polyak(self.target, q, self.tau)
        return torch.stack([p_loss.detach(), c_loss.detach()])

    # -- acting -----------------------------------------------------------
    @torch.no_grad()
    def act(self, obs, deterministic=True, gen=None):
        """The action on ``obs`` (tanh of the mean, or of a draw from ``gen``)."""
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        return sac_actor_forward(self.params['actor'], obs, gen, self.act_low, self.act_high,
                                 self.activation, deterministic=deterministic,
                                 with_logprob=False)[0]

    # -- checkpoint -------------------------------------------------------
    def train_state(self):
        return (self.params, self.target, self.log_alpha, self.actor_opt_state,
                self.critic_opt_state, self.alpha_opt_state)

    def set_train_state(self, ts):
        (self.params, self.target, self.log_alpha, self.actor_opt_state,
         self.critic_opt_state, self.alpha_opt_state) = ts

    def state_dict(self):
        """The JAX layout as numpy: params, target, log_alpha and the three
        Adam states (``{'count', 'mu', 'nu'}`` over the leaves)."""
        from safe_control_gym_tpu_torch.utils.convert import adam_state_to_numpy, tree_to_numpy
        target, a_opt, c_opt = self.target, self.actor_opt_state, self.critic_opt_state
        if self.model_axis is not None:
            from safe_control_gym_tpu_torch.parallel.sharding import gather_adam, gather_params
            target = gather_params(target)
            a_opt = gather_adam(self.mesh, self.model_axis, a_opt, self.params['actor'])
            c_opt = gather_adam(self.mesh, self.model_axis, c_opt, self._q(self.params))
        return {'params': tree_to_numpy(self.full_params()), 'target': tree_to_numpy(target),
                'log_alpha': self.log_alpha.detach().cpu().numpy(),
                'actor_opt_state': adam_state_to_numpy(a_opt),
                'critic_opt_state': adam_state_to_numpy(c_opt),
                'alpha_opt_state': adam_state_to_numpy(self.alpha_opt_state)}

    def load_state_dict(self, sd):
        """From ``state_dict``'s layout or the JAX package's (optax states as
        ``utils/checkpoint.plain`` gives them)."""
        from safe_control_gym_tpu_torch.utils.convert import adam_state_from_numpy, tree_from_numpy
        self.params = tree_from_numpy(sd['params'], self.device)
        self.target = tree_from_numpy(sd['target'], self.device)
        self.log_alpha = torch.tensor(np.asarray(sd['log_alpha'], np.float32), device=self.device)
        for name in ('actor_opt_state', 'critic_opt_state', 'alpha_opt_state'):
            setattr(self, name, adam_state_from_numpy(sd[name], self.device))
