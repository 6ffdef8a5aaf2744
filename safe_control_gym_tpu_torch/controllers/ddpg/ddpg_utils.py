"""DDPG's networks and agent: the deterministic tanh actor, one Q network and the update.

Port of ``safe_control_gym_tpu/controllers/ddpg/ddpg_utils.py``. The
parameters are the JAX package's pytree as tensors: ``params = {'actor',
'q'}`` (each an ``mlp_init`` list; the actor's last layer drawn in +-3e-3, so
that the tanh starts unsaturated) and ``target``, a copy of the same tree.
One update (``DDPGAgent.update``) is, in JAX's order: the critic against a
target built under ``torch.no_grad`` from the target actor and Q; the actor
against the *updated* Q; the Polyak average of the whole target tree. The two
optimizers are plain Adam in optax's defaults (``math/optim.adam_update``)
over their leaves in JAX's order. ``make_action_noise_process`` builds the
exploration noise from the config's ``random_process`` spec.

    agent = DDPGAgent(obs_space, act_space, hidden_dim=256, device='cuda')
    losses = agent.update(batch)   # batch: obs, act, rew, next_obs, mask
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_tpu_torch.math import optim
from safe_control_gym_tpu_torch.math.networks import mlp_apply, mlp_init
from safe_control_gym_tpu_torch.math.optim import adam_step, polyak, tree_leaves, tree_unflatten
from safe_control_gym_tpu_torch.math.random_processes import (GaussianProcess,
                                                              OrnsteinUhlenbeckProcess)
from safe_control_gym_tpu_torch.math.schedules import ConstantSchedule, LinearSchedule
from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['init_ddpg_params', 'ddpg_actor_forward', 'ddpg_q_value', 'noise_schedule',
           'make_action_noise_process', 'DDPGAgent']


def init_ddpg_params(gen: torch.Generator, obs_dim, act_dim, hidden_dims, device=None):
    """``(params, target)`` drawn from ``gen``: uniform in +-1/sqrt(fan_in),
    the actor's last weights in +-3e-3; the target a copy."""
    device = gen.device if device is None else torch.device(device)
    actor = mlp_init(gen, obs_dim, act_dim, hidden_dims, orthogonal=False, device=device)
    actor[-1]['w'] = (torch.rand(actor[-1]['w'].shape, generator=gen, device=gen.device)
                      * 6e-3 - 3e-3).to(device)
    params = {'actor': actor,
              'q': mlp_init(gen, obs_dim + act_dim, 1, hidden_dims, orthogonal=False,
                            device=device)}
    target = tree_unflatten(params, [t.clone() for t in tree_leaves(params)])
    return params, target


def ddpg_actor_forward(actor_params, obs, act_low, act_high, activation='relu'):
    """tanh of the actor's output mapped affinely from [-1, 1] onto
    [act_low, act_high]."""
    a = torch.tanh(mlp_apply(actor_params, obs, activation))
    return act_low + 0.5 * (a + 1.0) * (act_high - act_low)


def ddpg_q_value(q_params, obs, act, activation='relu'):
    return mlp_apply(q_params, torch.cat([obs, act], dim=-1), activation)


def noise_schedule(noise_config):
    """``(std_schedule, process_name, process_kwargs)`` from a
    ``random_process`` spec: ``{'func': 'OrnsteinUhlenbeckProcess' |
    'GaussianProcess', 'std': {'func': 'LinearSchedule' | 'ConstantSchedule',
    'args': ...}, ...}``."""
    noise_config = dict(noise_config or {})
    process_name = noise_config.pop('func', 'OrnsteinUhlenbeckProcess')
    std_config = dict(noise_config.pop('std', {'func': 'LinearSchedule', 'args': 0.2}))
    std_args = std_config.pop('args', 0.2)
    if not isinstance(std_args, (list, tuple)):
        std_args = [std_args]
    std_cls = {'LinearSchedule': LinearSchedule,
               'ConstantSchedule': ConstantSchedule}[std_config.pop('func', 'LinearSchedule')]
    return std_cls(*std_args), process_name, noise_config


def make_action_noise_process(noise_config, act_space, seed=0, device='cpu'):
    """The OU or Gaussian exploration process of a ``random_process`` spec."""
    std, process_name, kwargs = noise_schedule(noise_config)
    proc_cls = {'OrnsteinUhlenbeckProcess': OrnsteinUhlenbeckProcess,
                'GaussianProcess': GaussianProcess}[process_name]
    return proc_cls(size=act_space.shape[0], std=std, seed=seed, device=device, **kwargs)


class DDPGAgent:
    """DDPG's parameters, target, two Adam states and the update.

    ``seed`` draws the parameters from a generator on ``device`` (the card
    unless the caller passes the CPU)."""

    def __init__(self, obs_space, act_space, hidden_dim=256, gamma=0.99, tau=0.005,
                 actor_lr=1e-3, critic_lr=1e-3, activation='relu', seed=0, device='cuda',
                 **kwargs):
        self.device = resolve_device(device)
        self.obs_dim = obs_space.shape[0]
        self.act_dim = act_space.shape[0]
        self.act_low = torch.as_tensor(np.asarray(act_space.low, np.float32), device=self.device)
        self.act_high = torch.as_tensor(np.asarray(act_space.high, np.float32), device=self.device)
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.actor_lr, self.critic_lr = actor_lr, critic_lr
        self.activation = activation
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.params, self.target = init_ddpg_params(gen, self.obs_dim, self.act_dim,
                                                    [int(hidden_dim)] * 2)
        self.actor_opt_state = optim.adam_init(tree_leaves(self.params['actor']))
        self.critic_opt_state = optim.adam_init(tree_leaves(self.params['q']))

    def update(self, batch, gen=None, noise=None) -> torch.Tensor:
        """One step of critic, actor and target on ``batch`` (dict of (B, ...)
        tensors: obs, act, rew, next_obs, mask). DDPG's update draws nothing:
        ``gen`` and ``noise`` are accepted for SAC's signature. Returns
        ``[policy_loss, critic_loss]`` on the device, unread."""
        act_low, act_high, activation = self.act_low, self.act_high, self.activation
        obs = batch['obs']
        with torch.no_grad():
            next_act = ddpg_actor_forward(self.target['actor'], batch['next_obs'], act_low,
                                          act_high, activation)
            nq = ddpg_q_value(self.target['q'], batch['next_obs'], next_act, activation)
            q_targ = batch['rew'] + self.gamma * batch['mask'] * nq
        c_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params['q'])]
        with torch.enable_grad():
            q = ddpg_q_value(tree_unflatten(self.params['q'], c_leaves), obs, batch['act'],
                             activation)
            c_loss = ((q - q_targ) ** 2).mean()
            c_grads = torch.autograd.grad(c_loss, c_leaves)
        c_new, self.critic_opt_state = adam_step(c_leaves, c_grads, self.critic_opt_state,
                                                 self.critic_lr)
        q_params = tree_unflatten(self.params['q'], c_new)
        a_leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params['actor'])]
        with torch.enable_grad():
            pi = ddpg_actor_forward(tree_unflatten(self.params['actor'], a_leaves), obs,
                                    act_low, act_high, activation)
            p_loss = -ddpg_q_value(q_params, obs, pi, activation).mean()
            a_grads = torch.autograd.grad(p_loss, a_leaves)
        a_new, self.actor_opt_state = adam_step(a_leaves, a_grads, self.actor_opt_state,
                                                self.actor_lr)
        self.params = {'actor': tree_unflatten(self.params['actor'], a_new), 'q': q_params}
        self.target = polyak(self.target, self.params, self.tau)
        return torch.stack([p_loss.detach(), c_loss.detach()])

    @torch.no_grad()
    def act(self, obs, **kwargs):
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        return ddpg_actor_forward(self.params['actor'], obs, self.act_low, self.act_high,
                                  self.activation)

    def train_state(self):
        return (self.params, self.target, self.actor_opt_state, self.critic_opt_state)

    def set_train_state(self, ts):
        (self.params, self.target, self.actor_opt_state, self.critic_opt_state) = ts

    def state_dict(self):
        from safe_control_gym_tpu_torch.utils.convert import adam_state_to_numpy, tree_to_numpy
        return {'params': tree_to_numpy(self.params), 'target': tree_to_numpy(self.target),
                'actor_opt_state': adam_state_to_numpy(self.actor_opt_state),
                'critic_opt_state': adam_state_to_numpy(self.critic_opt_state)}

    def load_state_dict(self, sd):
        from safe_control_gym_tpu_torch.utils.convert import adam_state_from_numpy, tree_from_numpy
        self.params = tree_from_numpy(sd['params'], self.device)
        self.target = tree_from_numpy(sd['target'], self.device)
        self.actor_opt_state = adam_state_from_numpy(sd['actor_opt_state'], self.device)
        self.critic_opt_state = adam_state_from_numpy(sd['critic_opt_state'], self.device)
