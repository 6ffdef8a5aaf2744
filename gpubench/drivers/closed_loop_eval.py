"""Traffic driver: closed-loop evaluation of a trained policy over a large
fleet, ``evaluate_policy_fused`` called back to back.

The user scores a policy on many episodes at once (returns, violations):
each call runs ``batch`` envs for ``n_steps`` control steps from start states
drawn from the call's seed, with the actor inside the rollout kernel (the
``policy-in-kernel`` path; any other path fails the run). A call runs the
rollout once for its per-env statistics and ``n_reps`` times more timed, as
the entry point does; every step it runs counts.

Parameters: ``batch``, ``n_steps``, ``n_reps``, ``stochastic`` (false: the
actor's mean), ``use_kernel`` (the entry point's argument; None lets
it choose, which on the card must be the kernel), ``check_calls`` and ``check_envs`` (the sample the reference
recomputes), ``trace_seconds``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gpubench.harness import core, seeds
from gpubench.harness.checks import Reservoir, rel_gaps, row_mismatch
from gpubench.reference import checkpoint, envcfg
from gpubench.reference import rollout as ref

KERNEL_NAME = {'cartpole': 'cartpole_policy_rollout_kernel',
               'quadrotor_3D': 'quad_policy_rollout_kernel'}
_SYSTEM_LABELS = {'cartpole': envcfg.CARTPOLE_LABELS, 'quadrotor_3D': envcfg.QUAD3D_LABELS}


def make_controller(config, device):
    from functools import partial

    from safe_control_gym_tpu_torch.utils.registration import make
    env_func = partial(make, config['env'], device=device, **config['task_config'])
    ctrl = make(config['algo'], env_func, training=False, checkpoint_path='',
                output_dir=os.path.join(core.ROOT, '.gpubench_cache', 'out'),
                **config['algo_config'])
    ctrl.load(os.path.join(core.ROOT, config['model']))
    return ctrl


def reference_starts(system, task, batch, seed, device):
    """The ``batch`` start states the entry point draws from ``seed``: each
    randomized coordinate, in the state's order, one uniform draw of the
    batch from a generator seeded with ``seed``, added to the nominal state."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    labels = _SYSTEM_LABELS[system]
    init = task.get('init_state') or {}
    rand = task.get('init_state_randomization_info') or (
        envcfg.CARTPOLE['init_rand'] if system == 'cartpole' else {})
    cols = []
    for name in labels:
        b = torch.full((batch,), float(init.get(name, 0.0)), dtype=torch.float32,
                       device=device)
        info = rand.get(name) if task.get('randomized_init', True) else None
        if info is not None:
            u = torch.rand((batch,), generator=g, device=device)
            low = torch.as_tensor(info['low'], dtype=torch.float32, device=device)
            high = torch.as_tensor(info['high'], dtype=torch.float32, device=device)
            b = b + torch.maximum(low, u * (high - low) + low)
        cols.append(b)
    return torch.stack(cols, dim=1)


class ClosedLoopEval:
    def __init__(self, cell, config, seed, device, spans):
        from safe_control_gym_tpu_torch.experiments.fused_eval import evaluate_policy_fused
        p = cell['params']
        self.eval = evaluate_policy_fused
        self.config, self.system = config, config['system']
        self.seed, self.device, self.spans = seed, device, spans
        self.batch, self.n_steps = int(p['batch']), int(p['n_steps'])
        self.n_reps, self.stochastic = int(p.get('n_reps', 1)), bool(p.get('stochastic', False))
        self.use_kernel = p.get('use_kernel')
        self.n_check = (int(p.get('check_calls', 4)), int(p.get('check_envs', 256)))
        self.ctrl = make_controller(config, device)
        self.key0 = seeds.derive(seed, 'call seeds')
        self.sample = Reservoir(self.n_check[0], seeds.derive(seed, 'checked calls'))
        self.calls = 0
        self.done_total = 0.0
        self._call(self.key0 ^ 0xFFFFFFFF)      # warm-up: build, load, one call

    def key(self, i: int) -> int:
        return (self.key0 + i) & 0xFFFFFFFF

    def _call(self, key):
        with self.spans('evaluate_policy_fused'):
            out = self.eval(self.ctrl, batch=self.batch, n_steps=self.n_steps, seed=key,
                            stochastic=self.stochastic, n_reps=self.n_reps,
                            use_kernel=self.use_kernel, return_per_env=True)
        if out['path'] != 'policy-in-kernel':
            raise RuntimeError(f'evaluate_policy_fused took the {out["path"]} path, not '
                               f'policy-in-kernel: {out.get("kernel_refusal")}')
        return out

    def window(self, seconds):
        t0 = time.perf_counter()
        i = 0
        while True:
            out = self._call(self.key(i))
            self.sample.offer((i, out['per_env']))
            self.done_total += out['episodes']
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.calls = i
        return {'work': i * (1 + self.n_reps) * self.batch * self.n_steps, 'wall_s': wall,
                'attempted': i}

    def layer_counts(self):
        from gpubench.counts import rollout as counts
        pp = self.ctrl.agent.params['actor']
        h1, h2 = int(pp[0]['w'].shape[1]), int(pp[1]['w'].shape[1])
        n_sub, _ = envcfg.substeps(self.config['task_config'])
        launches = self.calls * (1 + self.n_reps)
        rr = bool(self.config['task_config'].get('randomized_init', True))
        # The warm-up launch's done count stands for each of the call's launches.
        ops = counts.policy_ops(self.system, self.batch, self.n_steps, n_sub, h1, h2,
                                randomized_reset=rr) * launches \
            + counts.policy_ops(self.system, 0, 0, n_sub, h1, h2, randomized_reset=rr,
                                done_total=self.done_total * (1 + self.n_reps))
        return {'launches': launches, 'kernel': KERNEL_NAME[self.system],
                'kernel_ops': ops, 'flops': ops,
                'kernel_bytes': counts.policy_bytes(self.system, self.batch, h1, h2) * launches}

    def release(self):
        rng = seeds.rng(self.seed, 'checked envs')
        n_env = min(self.n_check[1], self.batch)
        self.checked = [(i, np.sort(np.asarray(rng.sample(range(self.batch), n_env))), per_env)
                        for i, per_env in self.sample.sample()]
        self.sample = None
        self.ctrl.close()
        self.ctrl = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32):
        task = self.config['task_config']
        keys, envs, s0 = [], [], []
        for i, e, _ in self.checked:
            starts = reference_starts(self.system, task, self.batch, self.key(i), self.device)
            s0.append(starts[torch.as_tensor(e, device=self.device)].cpu().numpy())
            keys += [self.key(i)] * len(e)
            envs += list(e)
        layers, norm = checkpoint.actor_layers(os.path.join(core.ROOT, self.config['model']))
        use_norm = bool(self.config['algo_config'].get('norm_obs', False)) and norm is not None
        actor = ref.Actor(layers, *(norm if use_norm else (None, None)),
                          activation=self.config['algo_config'].get('activation', 'tanh'),
                          clip_obs=float(self.config['algo_config'].get('clip_obs', 10))
                          if use_norm else 1e30, device=self.device, dtype=dtype)
        cfg = envcfg.CFGS[self.system](task)
        n_sub, dt = envcfg.substeps(task)
        return ref.ROLLOUTS[self.system](
            cfg, keys, envs, np.concatenate(s0), self.n_steps, n_sub, dt, draw_actions=False,
            constrained=False, action_noise=False,
            randomized_reset=bool(task.get('randomized_init', True)), actor=actor,
            device=self.device, dtype=dtype)

    def program_rows(self):
        out = {}
        for k in ('reward_sum', 'done_count'):
            out[k] = np.concatenate([per_env[k][e] for _, e, per_env in self.checked])
        return out

    def check(self):
        return compare(self.program_rows(), self.reference())


def row_gaps(prog, want):
    """Per checked row: whether its done count differs, and its reward sum's
    relative gap (``checks.rel_gaps``)."""
    counts = np.asarray(prog['done_count']) != np.asarray(want['done_count'])
    return counts, rel_gaps(prog['reward_sum'], want['reward_sum'])


def compare(prog, want):
    """The share of the checked rows whose answer parts from the
    reference's (``checks.row_mismatch``)."""
    return [row_mismatch(*row_gaps(prog, want))]


def make(cell, config, seed, device, spans):
    return ClosedLoopEval(cell, config, seed, device, spans)
