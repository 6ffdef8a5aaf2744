"""Soft actor-critic: on-device collects into a replay ring, the twin-Q update, resume.

Port of ``safe_control_gym_tpu/controllers/sac/sac.py``; the loop is
``off_policy_utils.OffPolicyController``, shared with DDPG. One training
iteration collects ``steps_per_iter = max(1, train_interval // N)`` steps of
``rollout_batch_size`` (N) envs through ``FuncEnv.step_autoreset`` (on the
card, the physics step is K1, K2 or K3 of ``ops/physics_kernels.py``) under
``torch.no_grad``, with uniform random actions until ``warm_up_steps`` and
the sampled tanh policy after, and writes each transition into the replay
ring on the device. The ring stores the terminal observation of an episode as
``next_obs`` with ``mask = 1 - (done and not truncated)``, so a time limit
does not cut the bootstrap. Past the warm-up, ``train_interval`` updates
(``sac_utils.SACAgent.update``) follow each collect, on batches drawn from
the ring. No tensor is read back inside an iteration; with
``fused_iterations`` K > 1, K iterations past the warm-up run back to back
before one read, and ``total_steps`` advances by K iterations.

``run`` evaluates the deterministic policy on ``n_episodes`` envs at once.
``shard_over(mesh)`` trains data parallel over ``torch.distributed`` ranks
(``parallel/sharding.py``): each rank steps its rows of the N envs, draws
every random tensor at the global width from the one generator and pushes
its envs' rows into its own ring; each update's batch is drawn as the
one-process run draws it, gathered on every rank, and the update runs
replicated, so that every rank holds the same agent. With ``model_axis``
the actor, twin Q and targets and their Adam moments are also split over
the model axis. Only rank 0 writes logs and checkpoints.
``save(path, save_buffer=True)`` (the end of ``learn``) also writes the ring,
the env states and the generator's state, so that ``load`` resumes training
exactly; ``load`` also takes a checkpoint of the JAX package, whose PRNG key
re-seeds the generator from the controller's seed.

    ctrl = make('sac', partial(make, 'cartpole', device='cuda', **task_config),
                training=True, output_dir='temp/sac', seed=0, **algo_config)
    ctrl.reset(); ctrl.learn(); ctrl.run(n_episodes=10)
"""

from __future__ import annotations

import torch

from safe_control_gym_tpu_torch.controllers.off_policy_utils import OffPolicyController
from safe_control_gym_tpu_torch.controllers.sac.sac_utils import SACAgent, sac_actor_forward

__all__ = ['SAC']

class SAC(OffPolicyController):
    """Soft actor-critic."""

    ALGO = 'SAC'

    def __init__(self, env_func, training=True, checkpoint_path='model_latest.pt',
                 output_dir='temp', seed: int = 0, **kwargs):
        super().__init__(env_func, training=training, checkpoint_path=checkpoint_path,
                         output_dir=output_dir, seed=seed, **kwargs)
        self.agent = SACAgent(self.env.observation_space, self.env.action_space,
                              hidden_dim=self.hidden_dim, gamma=self.gamma, tau=self.tau,
                              init_temperature=self.init_temperature,
                              use_entropy_tuning=self.use_entropy_tuning,
                              target_entropy=self.target_entropy, actor_lr=self.actor_lr,
                              critic_lr=self.critic_lr, entropy_lr=self.entropy_lr,
                              activation=getattr(self, 'activation', 'relu'), seed=self.seed,
                              device=self.device)
        self._setup_training()

    def shard_over(self, mesh, axis_name: str = 'env', model_axis: str = None):
        """Train data parallel over ``mesh`` (``parallel/sharding.py``): this
        rank keeps its rows of the envs and of the replay ring and rank 0's
        agent; with ``model_axis`` (a ``make_dp_tp_mesh``) the networks and
        their Adam moments are split over that axis. ``max_buffer_size``
        must be a multiple of ``rollout_batch_size``. Every rank calls it,
        and then ``learn``, alike."""
        self._shard_envs(mesh, axis_name)
        if model_axis is not None and mesh.shape[model_axis] > 1:
            self.agent.split(mesh, model_axis)

    def _explore(self, obs, random_phase, draws):
        """Uniform in the action box in the random phase (``draws``: its
        U[0, 1) numbers), else a draw of the squashed Gaussian policy
        (``draws``: its standard normals)."""
        sh = self._shards
        if random_phase:
            if draws is None:
                draws = torch.rand((self.N,) + tuple(self.act_low.shape), generator=self.gen,
                                   device=self.device)
            return self._random_action(sh.take(draws) if sh else draws)
        if sh:
            # The one-process run's normals of all N envs; this rank's rows.
            draws = sh.take(torch.randn((self.N,) + tuple(self.act_low.shape), generator=self.gen,
                                        device=self.device) if draws is None else draws)
        return sac_actor_forward(self.agent.params['actor'], obs, self.gen, self.act_low,
                                 self.act_high, self.agent.activation, with_logprob=False,
                                 noise=draws)[0]

    def _deterministic_action(self, obs):
        return sac_actor_forward(self.agent.full_params()['actor'], obs, self.gen, self.act_low,
                                 self.act_high, self.agent.activation, deterministic=True,
                                 with_logprob=False)[0]
