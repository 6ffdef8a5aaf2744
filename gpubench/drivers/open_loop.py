"""Traffic driver: open-loop whole rollouts, one kernel launch each (K4, K5).

The user simulates a large fleet of envs on random actions, the reference
environment's published "realtime" benchmark: ``batch`` envs, ``n_steps``
control steps a launch, actions drawn on the card, the constraints and the
action disturbance of the cell's ``task_overrides``, and auto-reset to
randomized start states. Each launch gets its own Philox key, drawn from the
run's seed; every launch starts from the same ``batch`` start states, which
the driver draws from the seed inside the configuration's start box.

Parameters (``params`` of the cell's file): ``batch``, ``n_steps``,
``task_overrides`` (laid over the configuration's task), ``in_flight`` (the
launches queued on the card at once), ``check_launches`` and ``check_envs``
(the sample the reference recomputes), ``trace_seconds`` (the traced
window's length, at most the run's).

The end-to-end rate is ``batch * n_steps`` control steps a launch, over every
launch of the window, over the window's wall time up to the last launch's
end.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from gpubench.harness import seeds
from gpubench.harness.checks import Reservoir, rel_gaps, row_mismatch
from gpubench.reference import envcfg
from gpubench.reference import rollout as ref

# The kernel's name in the trace (a substring of the mangled name).
KERNEL_NAME = {'cartpole': 'cartpole_rollout_kernel', 'quadrotor_3D': 'quad_rollout_kernel'}


def task_config(config, params):
    return {**config['task_config'], **params.get('task_overrides', {})}


def noise_std(task) -> float:
    """The white action noise's std of a task's disturbances (0 if none)."""
    for spec in (task.get('disturbances') or {}).get('action', []):
        if spec.get('disturbance_func') == 'white_noise':
            return float(spec['std'])
    return 0.0


def make_env(config, task, device):
    from safe_control_gym_tpu_torch.utils.registration import make
    return make(config['env'], device=device, **task)


def program_kernel(system):
    """(cfg function, rollout wrapper, cfg layout) of the program's kernel."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    return {'cartpole': (rk.cartpole_rollout_cfg, rk.cartpole_rollout, rk._C),
            'quadrotor_3D': (rk.quad_rollout_cfg, rk.quad3d_rollout, rk._Q)}[system]


def start_states(system, task, batch, seed, device):
    """``batch`` start states drawn from ``seed`` uniformly in the
    configuration's start box (the reference's own vector)."""
    cfg = envcfg.CFGS[system](task)
    L = envcfg.CARTPOLE_LAYOUT if system == 'cartpole' else envcfg.QUAD_LAYOUT
    nx = 4 if system == 'cartpole' else 12
    lo = torch.as_tensor(cfg[L['INIT_LO']:L['INIT_LO'] + nx], device=device)
    hi = torch.as_tensor(cfg[L['INIT_HI']:L['INIT_HI'] + nx], device=device)
    g = torch.Generator(device=device).manual_seed(seeds.derive(seed, 'start states'))
    u = torch.rand((batch, nx), generator=g, device=device)
    return (lo + (hi - lo) * u).contiguous()


class OpenLoop:
    def __init__(self, cell, config, seed, device, spans):
        p = cell['params']
        self.system = config['system']
        self.task = task_config(config, p)
        self.seed, self.device, self.spans = seed, device, spans
        self.batch, self.n_steps = int(p['batch']), int(p['n_steps'])
        self.in_flight = int(p.get('in_flight', 2))
        self.n_check = (int(p.get('check_launches', 4)), int(p.get('check_envs', 256)))
        self.env = make_env(config, self.task, device)
        cfg_fn, self.roll, layout = program_kernel(self.system)
        self.cfg = cfg_fn(self.env)
        self.noise = noise_std(self.task)
        self.cfg[layout['NOISE_STD']] = self.noise
        self.constrained = bool(self.task.get('constraints'))
        from safe_control_gym_tpu_torch.ops.rollout_kernels import rollout_task_kwargs
        self.kw = dict(n_substeps=self.env.PYB_STEPS_PER_CTRL, dt=self.env.PYB_TIMESTEP,
                       draw_actions=True, constrained=self.constrained,
                       action_noise=self.noise > 0,
                       randomized_reset=bool(self.env.RANDOMIZED_INIT),
                       **rollout_task_kwargs(self.env))
        self.state0 = start_states(self.system, self.task, self.batch, seed, device)
        self.key0 = seeds.derive(seed, 'launch keys')
        self.sample = Reservoir(self.n_check[0], seeds.derive(seed, 'checked launches'))
        self.launches = 0
        self.done_total = None
        # Warm-up: the kernel's build and load, and one launch at the cell's
        # shape, on a key the window does not use.
        self._launch(self.key0 ^ 0xFFFFFFFF)
        self._sync()

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _launch(self, key):
        with self.spans('rollout launch'):
            return self.roll(self.state0, self.cfg, key, n_steps=self.n_steps, **self.kw)

    def key(self, i: int) -> int:
        return (self.key0 + i) & 0xFFFFFFFF

    def window(self, seconds):
        cuda = self.device.type == 'cuda'
        queue = collections.deque()
        traced = self.spans.enabled
        done_total = torch.zeros((), dtype=torch.float64, device=self.device)
        self._sync()
        t0 = time.perf_counter()
        i = 0
        while True:
            out = self._launch(self.key(i))
            self.sample.offer((i, {k: out[k] for k in ('state', 'ctrl_step', 'reward_sum',
                                                       'done_count', 'violation_count')}))
            if traced:
                done_total += out['done_count'].sum(dtype=torch.float64)
            i += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                queue.append(ev)
                if len(queue) > self.in_flight:
                    with self.spans('throttle wait'):
                        queue.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        self.launches = i
        self.done_total = float(done_total) if traced else None
        return {'work': i * self.batch * self.n_steps, 'wall_s': wall, 'attempted': i}

    def layer_counts(self):
        from gpubench.counts import rollout as counts
        n_sub = self.kw['n_substeps']
        ops = counts.open_loop_ops(self.system, self.batch, self.n_steps, n_sub,
                                   constrained=self.constrained,
                                   randomized_reset=self.kw['randomized_reset'],
                                   done_total=0.0) * self.launches
        if self.done_total is not None:
            ops += counts.open_loop_ops(self.system, 0, 0, n_sub,
                                        randomized_reset=self.kw['randomized_reset'],
                                        done_total=self.done_total)
        return {'launches': self.launches, 'kernel': KERNEL_NAME[self.system],
                'kernel_ops': ops,
                'kernel_bytes': counts.open_loop_bytes(self.system, self.batch) * self.launches,
                'rollout_steps': self.launches * self.batch * self.n_steps}

    def release(self):
        """Keep the sampled answers' rows on the host, then free the program."""
        rng = seeds.rng(self.seed, 'checked envs')
        n_env = min(self.n_check[1], self.batch)
        self.checked = []
        for i, out in self.sample.sample():
            envs = np.sort(np.asarray(rng.sample(range(self.batch), n_env)))
            idx = torch.as_tensor(envs, device=self.device)
            rows = {k: v.index_select(0, idx).cpu().numpy() for k, v in out.items()}
            self.checked.append((i, envs, rows))
        self.state0_host = self.state0.cpu().numpy()
        self.sample = None
        del self.state0
        self.env.close()
        self.env = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32):
        """The reference's answers for the checked rows, in ``self.checked``'s
        order, concatenated."""
        keys, envs, s0 = [], [], []
        for i, e, _ in self.checked:
            keys += [self.key(i)] * len(e)
            envs += list(e)
            s0.append(self.state0_host[e])
        cfg = envcfg.CFGS[self.system](self.task, self.noise)
        n_sub, dt = envcfg.substeps(self.task)
        return ref.ROLLOUTS[self.system](
            cfg, keys, envs, np.concatenate(s0), self.n_steps, n_sub, dt,
            draw_actions=True, constrained=self.constrained, action_noise=self.noise > 0,
            randomized_reset=bool(self.task.get('randomized_init', True)),
            device=self.device, dtype=dtype)

    def program_rows(self):
        keys = ('state', 'ctrl_step', 'reward_sum', 'done_count', 'violation_count')
        return {k: np.concatenate([rows[k] for _, _, rows in self.checked]) for k in keys}

    def check(self):
        return compare(self.program_rows(), self.reference())


def row_gaps(prog, want):
    """Per checked row: whether its done count, violation count or step
    counter differs, and the relative gaps of its reward sum and its final
    state (``checks.rel_gaps``)."""
    counts = np.zeros(len(want['reward_sum']), bool)
    for k in ('done_count', 'violation_count', 'ctrl_step'):
        counts |= np.asarray(prog[k]) != np.asarray(want[k])
    return counts, rel_gaps(prog['reward_sum'], want['reward_sum']), \
        rel_gaps(prog['state'], want['state'])


def compare(prog, want):
    """The share of the checked rows whose answer parts from the
    reference's (``checks.row_mismatch``)."""
    return [row_mismatch(*row_gaps(prog, want))]


def make(cell, config, seed, device, spans):
    return OpenLoop(cell, config, seed, device, spans)
