"""Traffic driver: PPO training, ``PPO.learn`` one iteration at a time.

The user trains a policy and pays for the wall time to it: each iteration
collects ``rollout_steps`` steps of ``rollout_batch_size`` envs
(``FuncEnv.step_autoreset``, the physics in K3) and trains on them for
``opt_epochs`` epochs of minibatches. Set-up builds the controller from the
configuration, gives it weights drawn from the seed, and runs its first
``warm_iterations`` iterations through the same call the window makes; the
reference follows those from the same weights and generator seed. The window
then goes on with the same controller, and one of its iterations, drawn from
the seed (a reservoir of one, so every iteration of the window is as likely),
is checked too: the program's state is kept just before it, and the reference
runs that one iteration from the kept state. Log, eval, save and checkpoint
intervals are off.

Parameters: ``warm_iterations`` (3), ``trace_seconds``.

The end-to-end metric is the card's busy time a whole iteration of the
window (``metrics/train_device_ms_per_iter.py``). The rate, N x T env steps
collected and trained on for each whole iteration over the window's wall
time, is set by the host's pace and is reported per layer, in traced runs.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from gpubench.harness import core, seeds
from gpubench.harness.checks import Check
from gpubench.reference import envcfg
from gpubench.reference import ppo as ref

QUIET = dict(log_interval=0, eval_interval=0, save_interval=0, num_checkpoints=0,
             tensorboard=False)


def make_controller(config, seed, device):
    from safe_control_gym_tpu_torch.utils.registration import make
    env_func = partial(make, config['env'], device=device, **config['task_config'])
    return make(config['algo'], env_func, training=True, checkpoint_path='',
                output_dir=os.path.join(core.ROOT, '.gpubench_cache', 'out'),
                seed=seeds.derive(seed, 'controller'), **{**config['algo_config'], **QUIET})


def start_params(config, seed, device):
    algo = config['algo_config']
    return ref.init_params(seeds.derive(seed, 'weights'), 12, 4, int(algo['hidden_dim']),
                           device)


def _norms(tensors):
    return np.asarray([float(torch.linalg.vector_norm(t.double())) for t in tensors])


@dataclass
class Stage:
    """A stretch of training that both sides ran from the same start: its
    iterations' results (``policy_loss``, ``value_loss``, ``entropy_loss``,
    ``mean_reward``, ``dones``), the first minibatch's gradient as Adam took
    it, and the parameters' change over the stretch, leaf by leaf."""
    results: list
    first_grad: list
    change: list


def _clone(ts):
    return [t.detach().clone() for t in ts]


def _grad(mu_after, mu_before):
    """The gradient of an Adam step, from its first moments before and after:
    mu' = B1 mu + (1 - B1) g."""
    if mu_after is None:
        return None
    if mu_before is None:
        return [m / (1 - ref.B1) for m in mu_after]
    return [(m - ref.B1 * m0) / (1 - ref.B1) for m, m0 in zip(mu_after, mu_before)]


def _as_results(it):
    return dict(policy_loss=it.losses[0], value_loss=it.losses[1], entropy_loss=it.losses[2],
                approx_kl=it.losses[3], mean_reward=it.mean_reward, dones=it.dones)


class PPOTrain:
    def __init__(self, cell, config, seed, device, spans):
        p = cell['params']
        self.config, self.system = config, config['system']
        self.seed, self.device, self.spans = seed, device, spans
        self.ctrl = make_controller(config, seed, device)
        params = start_params(config, seed, device)
        self.ctrl.agent.params = {'actor': [dict(l) for l in params['actor']],
                                  'critic': [dict(l) for l in params['critic']],
                                  'logstd': params['logstd'].clone()}
        self.steps_per_iter = self.ctrl.N * self.ctrl.T
        self.start = _clone(ref.leaves(self.ctrl.agent.params))
        self.first_mu = None
        self._watch_first_step()
        self.warm = []
        for _ in range(int(p.get('warm_iterations', 3))):
            self._iterate()
            self.warm.append(dict(self.ctrl.last_results))
        self.after_warm = _clone(ref.leaves(self.ctrl.agent.params))
        self.warm_mu = self.first_mu
        self.pick = random.Random(seeds.derive(seed, 'checked iteration'))
        self.picked = None
        self.iterations = 0
        self.seconds = (0.0, 0.0)

    def _watch_first_step(self):
        """Keep Adam's first moments after the next minibatch step."""
        agent = self.ctrl.agent
        own = vars(agent).get('_minibatch_step')
        step = agent._minibatch_step

        def first_step(mbatch):
            losses = step(mbatch)
            self.first_mu = _clone(agent.actor_opt_state['mu'] + agent.critic_opt_state['mu'])
            # Back to what the agent had: its class's method unless it had
            # one of its own.
            if own is None:
                del agent._minibatch_step
            else:
                agent._minibatch_step = own
            return losses

        agent._minibatch_step = first_step

    def _snapshot(self):
        """The program's state before an iteration: what the reference needs
        to run that iteration."""
        c, a = self.ctrl, self.ctrl.agent
        adam = lambda s: {'count': s['count'].clone(), 'mu': _clone(s['mu']),
                          'nu': _clone(s['nu'])}
        return {'params': _clone(ref.leaves(a.params)), 'actor_state': adam(a.actor_opt_state),
                'critic_state': adam(a.critic_opt_state), 'x': c._env_states.state.clone(),
                'step': c._env_states.ctrl_step.clone(), 'obs': c._obs.clone(),
                'gen': c.gen.get_state()}

    def _iterate(self):
        self.ctrl.max_env_steps = self.ctrl.total_steps + self.steps_per_iter
        with self.spans('learn iteration'):
            self.ctrl.learn()

    def window(self, seconds):
        ts0 = dict(self.ctrl.train_seconds)
        t0 = time.perf_counter()
        i = 0
        while True:
            i += 1
            # A reservoir of one: iteration i replaces the kept one with
            # chance 1/i.
            keep = self.pick.randrange(i) == 0
            if keep:
                before = self._snapshot()
                self.first_mu = None
                self._watch_first_step()
            self._iterate()
            if keep:
                self.picked = (i, before, dict(self.ctrl.last_results), self.first_mu,
                               _clone(ref.leaves(self.ctrl.agent.params)))
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.iterations = i
        ts = self.ctrl.train_seconds
        self.seconds = (ts['rollout'] - ts0['rollout'], ts['update'] - ts0['update'])
        return {'work': i * self.steps_per_iter, 'wall_s': wall, 'attempted': i}

    def layer_counts(self):
        from gpubench.counts.ppo import iteration_flops
        a = self.config['algo_config']
        n_sub, _ = envcfg.substeps(self.config['task_config'])
        m = self.steps_per_iter
        mb = min(int(a['mini_batch_size']), m)
        flops = iteration_flops(self.system, self.ctrl.N, self.ctrl.T, n_sub, 12, 4,
                                int(a['hidden_dim']), int(a['opt_epochs']), mb, m // mb)
        return {'iterations': self.iterations, 'rollout_s': self.seconds[0],
                'update_s': self.seconds[1], 'flops': flops * self.iterations}

    def release(self):
        self.ctrl.close()
        self.ctrl = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32):
        """The reference's stages: the first ``warm_iterations`` iterations
        from the same weights and generator seed, and the window's checked
        iteration from the program's state before it. ``dtype`` float64 is
        the float64 witness (``gpubench/controls.py``)."""
        cfg = self.config
        r = ref.PPORef(cfg['task_config'], cfg['algo_config'],
                       start_params(cfg, self.seed, self.device),
                       seeds.derive(self.seed, 'controller'), self.device, dtype)
        its = [_as_results(r.iteration()) for _ in self.warm]
        stages = [Stage(its, _grad(r.first_step_mu, None),
                        [a - s for a, s in zip(ref.leaves(r.params), self.start)])]
        if self.picked is not None:
            _, snap, _, _, _ = self.picked
            r = ref.PPORef.from_state(cfg['task_config'], cfg['algo_config'], snap,
                                      self.device, dtype)
            it = _as_results(r.iteration())
            stages.append(Stage([it], _grad(r.first_step_mu, _mu(snap)),
                                [a - s for a, s in zip(ref.leaves(r.params), snap['params'])]))
        return stages

    def program(self):
        """The program's stages, as ``reference`` gives the reference's."""
        stages = [Stage(self.warm, _grad(self.warm_mu, None),
                        [a - s for a, s in zip(self.after_warm, self.start)])]
        if self.picked is not None:
            _, snap, results, mu, after = self.picked
            stages.append(Stage([results], _grad(mu, _mu(snap)),
                                [a - s for a, s in zip(after, snap['params'])]))
        return stages

    def check(self):
        return compare(self.program(), self.reference(),
                       float(self.config['algo_config']['entropy_coef']))


def _mu(snap):
    return snap['actor_state']['mu'] + snap['critic_state']['mu']


def _worst_leaf_gap(prog, want, keep):
    """max over the kept leaves of | |prog| - |want| | over the larger of the
    leaf's reference norm and the median leaf's."""
    p, w = _norms(prog), _norms(want)
    med = float(np.median(w[keep]))
    return float(np.max(np.abs(p - w)[keep] / np.maximum(w[keep], med)))


def compare(program, reference, entropy_coef):
    """The numbers that decide a training cell's ``correct``, each the worst
    over the stages (set-up's first iterations, the window's checked one):
    each iteration's loss and mean reward against the reference's, its done
    count, the first gradient's norm as Adam took it and the parameters'
    change over the stage, both by the worst leaf."""
    loss = lambda d: d['policy_loss'] + entropy_coef * d['entropy_loss'] + d['value_loss']
    gaps = dict.fromkeys(LIMITS, 0.0)
    for prog, want in zip(program, reference):
        for w, it in zip(prog.results, want.results):
            gaps['loss_rel_gap'] = max(gaps['loss_rel_gap'],
                                       abs(loss(w) - loss(it)) / abs(loss(it)))
            gaps['mean_reward_rel_gap'] = max(
                gaps['mean_reward_rel_gap'],
                abs(w['mean_reward'] - it['mean_reward']) / abs(it['mean_reward']))
            gaps['dones_gap'] = max(gaps['dones_gap'], abs(w['dones'] - it['dones']))
        ref_norms = _norms(want.first_grad)
        # Leaves whose reference gradient is nought to rounding move under
        # Adam by round-off alone: left out of both measures.
        keep = ref_norms >= 1e-3 * float(np.median(ref_norms))
        first = prog.first_grad if prog.first_grad is not None else \
            [torch.zeros_like(g) for g in want.first_grad]
        gaps['first_grad_norm_gap'] = max(gaps['first_grad_norm_gap'],
                                          _worst_leaf_gap(first, want.first_grad, keep))
        gaps['param_change_gap'] = max(gaps['param_change_gap'],
                                       _worst_leaf_gap(prog.change, want.change, keep))
    bad = lambda v: v if np.isfinite(v) else float('inf')
    return [Check(name, bad(v), LIMITS[name]) for name, v in gaps.items()]


# Each limit lies between the float64 witness's largest reading (sound runs
# read 0.0: the reference repeats the program's operations) and the smallest
# reading of the TF32 control and of the planted faults at the cell's size on
# the card, about ten times from each; the readings are in PERF.md.
LIMITS = {'loss_rel_gap': 1e-4, 'mean_reward_rel_gap': 5e-5, 'dones_gap': 0.5,
          'first_grad_norm_gap': 1e-5, 'param_change_gap': 1e-4}


def make(cell, config, seed, device, spans):
    return PPOTrain(cell, config, seed, device, spans)
