"""CBF QP with a learned residual of the Lie derivative.

Port of ``safe_control_gym_tpu/safety_filters/cbf/cbf_nn.py`` (``CBF_NN``).
An MLP (``math/networks.py``, relu) maps the state to residual terms (a, b)
of the CBF row,

    -alpha(h(x)) - L_f h(x, u) - a(x)'u - b(x) <= slack.

``learn()`` runs episodes with the uncertified controller (or random inputs
from ``np.random.default_rng(seed)``), blending its actions with the
certified ones more each episode, takes the barrier's symmetric finite
difference against the model's Lie derivative, and regresses the residual
with Adam (optax's defaults, ``math/optim.py``) on samples of the replay
ring. ``save``/``load`` keep ``{'mlp': [{'w', 'b'}, ...]}`` of numpy arrays,
the JAX package's format, read through the port's restricted unpickler.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_control_gym_tpu_torch.math.networks import mlp_apply, mlp_init
from safe_control_gym_tpu_torch.math.optim import adam_init, adam_update
from safe_control_gym_tpu_torch.safety_filters.cbf.cbf import CBF
from safe_control_gym_tpu_torch.safety_filters.cbf.cbf_utils import CBFBuffer
from safe_control_gym_tpu_torch.utils.checkpoint import CheckpointUnpickler, save_checkpoint
from safe_control_gym_tpu_torch.utils.convert import mlp_params_from_numpy

__all__ = ['CBF_NN']


class CBF_NN(CBF):
    """CBF QP safety filter with a neural Lie-derivative correction."""

    def __init__(self, env_func, slope: float = 0.1, soft_constrained: bool = True,
                 slack_weight: float = 10000.0, slack_tolerance: float = 1.0e-3,
                 max_num_steps: int = 250, hidden_dims=(256, 256),
                 learning_rate: float = 0.001, num_episodes: int = 20,
                 max_buffer_size: int = 1_000_000, train_batch_size: int = 64,
                 train_iterations: int = 200, uncertified_controller=None, **kwargs):
        self.max_num_steps = int(max_num_steps)
        self.hidden_dims = list(hidden_dims)
        self.learning_rate = learning_rate
        self.num_episodes = int(num_episodes)
        self.max_buffer_size = int(max_buffer_size)
        self.train_batch_size = int(train_batch_size)
        self.train_iterations = int(train_iterations)
        self.uncertified_controller = uncertified_controller
        super().__init__(env_func, slope=slope, soft_constrained=soft_constrained,
                         slack_weight=slack_weight, slack_tolerance=slack_tolerance, **kwargs)
        nx, nu = self.model.nx, self.model.nu
        gen = torch.Generator(device=self.device).manual_seed(int(self.seed))
        self.mlp_params = mlp_init(gen, nx, nu + 1, self.hidden_dims, orthogonal=False)
        self.opt_state = adam_init(self._leaves())
        self.buffer = CBFBuffer(nx, nu, self.max_buffer_size, self.train_batch_size,
                                self.device)

    def _leaves(self):
        """The MLP's tensors in JAX's leaf order (per layer 'b', then 'w')."""
        return [layer[k] for layer in self.mlp_params for k in ('b', 'w')]

    def _loss(self, leaves, batch):
        """The mean square error of the estimated barrier derivative against
        the finite difference."""
        params = [{'b': leaves[2 * i], 'w': leaves[2 * i + 1]}
                  for i in range(len(self.mlp_params))]
        nu = self.model.nu
        a_b = mlp_apply(params, batch['state'], 'relu')
        h_dot_est = (batch['barrier_dot'] + torch.sum(a_b[:, :nu] * batch['act'], dim=-1,
                                                      keepdim=True) + a_b[:, nu:nu + 1])
        return ((h_dot_est - batch['barrier_dot_approx']) ** 2).mean()

    def _train_step(self, batch):
        """One Adam step on a batch; returns the loss (a tensor)."""
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in self._leaves()]
            loss = self._loss(leaves, batch)
            grads = torch.autograd.grad(loss, leaves)
        updates, self.opt_state = adam_update(list(grads), self.opt_state, self.learning_rate)
        new = [t.detach() + d for t, d in zip(leaves, updates)]
        self.mlp_params = [{'b': new[2 * i], 'w': new[2 * i + 1]}
                           for i in range(len(self.mlp_params))]
        return loss.detach()

    def _nn_terms(self, state):
        """The residual (a, b) of one state, (nu,) and ()."""
        a_b = mlp_apply(self.mlp_params, self._f32(state)[None], 'relu')[0]
        return a_b[:self.model.nu], a_b[self.model.nu]

    def _nn_terms_batch(self, states):
        """The residual terms of a batch of states in one MLP application."""
        a_b = mlp_apply(self.mlp_params, self._f32(states), 'relu')
        return a_b[:, :self.model.nu], a_b[:, self.model.nu]

    # ------------------------------------------------------------------
    def learn(self, env=None, **kwargs):
        """Collect the episodes and regress the residual; ``train_losses``
        keeps each episode's losses."""
        if env is None:
            env = self.env
        nx, nu = self.model.nx, self.model.nu
        lie = self.get_lie_derivative()
        rng = np.random.default_rng(self.seed)
        if self.num_episodes > 1:
            blend = np.arange(self.num_episodes) / (self.num_episodes - 1)
        else:
            blend = np.ones(1)
        self.train_losses = []
        for i in range(self.num_episodes):
            obs, info = env.reset()
            states = np.zeros((self.max_num_steps, nx))
            inputs = np.zeros((self.max_num_steps, nu))
            barrier_values = np.zeros((self.max_num_steps, 1))
            lie_values = np.zeros((self.max_num_steps, 1))
            for counter in range(self.max_num_steps):
                if self.uncertified_controller is None:
                    uncertified_action = self.env.action_space.sample(rng)
                else:
                    uncertified_action = self.uncertified_controller.select_action(obs, info)
                safe_action, _ = self.certify_action(obs[:nx], uncertified_action)
                blended = ((1 - blend[i]) * np.atleast_1d(uncertified_action)
                           + blend[i] * np.atleast_1d(safe_action))
                obs, _, done, info = env.step(blended)
                x = self._f32(obs[:nx])
                states[counter] = obs[:nx]
                inputs[counter] = blended
                with torch.no_grad():
                    barrier_values[counter, 0] = float(self.cbf(x))
                    lie_values[counter, 0] = float(lie(x, self._f32(blended)))
                if done:
                    obs, info = env.reset()
            # The barrier's symmetric finite difference.
            barrier_dot_approx = ((barrier_values[2:] - barrier_values[:-2])
                                  / (2 * 1 / env.CTRL_FREQ))
            self.buffer.push({'state': states[1:-1], 'act': inputs[1:-1],
                              'barrier_dot': lie_values[1:-1],
                              'barrier_dot_approx': barrier_dot_approx})
            losses = [self._train_step(self.buffer.sample(self.train_batch_size))
                      for _ in range(self.train_iterations)]
            self.train_losses.append(torch.stack(losses).cpu().numpy() if losses
                                     else np.zeros(0))

    # ------------------------------------------------------------------
    def save(self, path):
        save_checkpoint(path, {'mlp': [{k: v.cpu().numpy() for k, v in layer.items()}
                                       for layer in self.mlp_params]})

    def load(self, path):
        with open(path, 'rb') as f:
            saved = CheckpointUnpickler(f).load()
        self.mlp_params = mlp_params_from_numpy(saved['mlp'], self.device)
