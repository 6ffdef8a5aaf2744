"""The lower-precision controls, the float64 witness and the planted faults
that each cell's ``correct`` is held against. The benchmark's own runs never
run them.

* The control: the plain reference put in the program's place, one precision
  below the configuration's float32: bfloat16 for the rollouts (their
  arithmetic is elementwise float32), TF32 products for PPO training (its
  configuration keeps float32 products with TF32 off). It has to fail.
* The float64 witness: the same reference in float64, every rounding of the
  float32 program changed. What it reads is what a sound change of operation
  order in float32 may move, and the limits lie above it.
* The faults, planted in the program underneath a run: ``state_unchanged``
  (a step returns its state unchanged), ``half_batch`` (half of the batch
  left out, the mean taken over the rest), ``answer_altered`` (an answer
  altered where it is produced). ``--late`` plants a training fault only
  after set-up, so that only the window's checked iteration sees it.

    python -m gpubench.controls --workload quadrotor_3D_ppo.train --seeds 1 2 3 --what control float64

prints one JSON line a seed and reading with each compared number, its
limit and whether it failed. ``gpubench/tests/test_gpubench_controls.py``
runs the same at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from gpubench.harness import core  # noqa: E402
from gpubench.harness.tracing import Spans  # noqa: E402

FAULTS = ('state_unchanged', 'half_batch', 'answer_altered')
READINGS = ('control', 'float64')


def _drive(name, seed, device, params=None, config=None, seconds=1.0, window_fault=None):
    """Set-up, a short window and the release of a run of cell ``name``:
    the driver's run, ready for ``check``. ``window_fault`` is planted for
    the window alone."""
    cell = core.workload(name)
    if params:
        cell = {**cell, 'params': {**cell['params'], **params}}
    config = core.config(cell['config']) if config is None else config
    driver = core.load_module('drivers', cell['driver'])
    run = driver.make(cell, config, seed, torch.device(device), Spans(False))
    with planted(cell, window_fault) if window_fault else contextlib.nullcontext():
        run.window(seconds)
    run.layer_counts()
    run.release()
    return cell, config, run


def _other(run, cell, what):
    """The reference's answers computed as ``what`` says, to stand in the
    program's place."""
    if what == 'float64':
        return run.reference(dtype=torch.float64)
    if cell['driver'] != 'ppo_train':
        return run.reference(dtype=torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return run.reference()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _row_summary(driver, other, want):
    """For the rollouts: the largest relative gaps of the rows whose counts
    agree, and the share of rows over each tolerance, by which the per-row
    tolerances were chosen."""
    gaps = driver.row_gaps(other, want)
    agree = ~gaps[0]
    out = {'count_mismatch_share': float(gaps[0].mean())}
    for label, g in zip(('reward', 'state'), gaps[1:]):
        out[f'{label}_gap_max_where_counts_agree'] = float(g[agree].max(initial=0.0))
        out[f'{label}_share_over'] = {f'{t:g}': float((g > t).mean())
                                      for t in (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)}
    return out


def readings(name, seed, device, whats=READINGS, params=None, config=None, seconds=1.0):
    """``{what: (checks, rows)}``: for each of ``whats`` (``control``,
    ``float64``) the checks of that reference put in the program's place,
    from one run, and for the rollouts a summary of the rows' gaps."""
    cell, config, run = _drive(name, seed, device, params, config, seconds)
    driver = core.load_module('drivers', cell['driver'])
    want = run.reference()
    out = {}
    for what in whats:
        other = _other(run, cell, what)
        if cell['driver'] == 'ppo_train':
            out[what] = (driver.compare(other, want,
                                        float(config['algo_config']['entropy_coef'])), None)
        else:
            out[what] = (driver.compare(other, want), _row_summary(driver, other, want))
    return out


def control(name, seed, device, params=None, config=None, seconds=1.0):
    """The checks of the reference, one precision lower, in the program's
    place."""
    return readings(name, seed, device, ('control',), params, config, seconds)['control'][0]


@contextlib.contextmanager
def _patched(obj, attr, make_new):
    old = getattr(obj, attr)
    setattr(obj, attr, make_new(old))
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _rollout_fault(fault):
    """A wrapper of a rollout kernel's entry point with ``fault`` in it."""
    def wrap(roll):
        def faulty(state0, cfg, seed, *args, **kw):
            if fault == 'half_batch':
                half = state0.shape[0] // 2
                out = roll(state0[:half].contiguous(), cfg, seed, *args, **kw)
                return {k: torch.cat([v, torch.zeros_like(v)])[:state0.shape[0]]
                        for k, v in out.items()}
            if fault == 'state_unchanged':
                # No physics substep: every control step returns its state.
                return roll(state0, cfg, seed, *args, **{**kw, 'n_substeps': 0})
            out = roll(state0, cfg, seed, *args, **kw)
            if fault == 'answer_altered':
                # One step's reward (at most 1) counted once more in every
                # env's sum.
                out['reward_sum'] = out['reward_sum'] + 1.0
            return out
        faulty.__name__ = roll.__name__
        faulty.launches = 0
        faulty.policy_launches = 0
        return faulty
    return wrap


@contextlib.contextmanager
def planted(cell, fault):
    """The program with ``fault`` planted, for the length of the block."""
    if cell['driver'] in ('open_loop', 'closed_loop_eval'):
        from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
        with contextlib.ExitStack() as stack:
            for name in ('cartpole_rollout', 'quad3d_rollout'):
                stack.enter_context(_patched(rk, name, _rollout_fault(fault)))
            yield
        return
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import PPOAgent
    from safe_control_gym_tpu_torch.envs.quadrotor import Quadrotor
    from safe_control_gym_tpu_torch.math import optim
    if fault == 'state_unchanged':
        cm = _patched(optim, 'clip_adam_step',
                      lambda old: lambda params, grads, state, *a, **k: (list(params), state))
    elif fault == 'half_batch':
        def half(old):
            def step(self, mbatch):
                n = mbatch['obs'].shape[0] // 2
                return old(self, {k: v[:n] for k, v in mbatch.items()})
            return step
        cm = _patched(PPOAgent, '_minibatch_step', half)
    else:
        def altered(old):
            def reward(self, state, noisy_action, step):
                # Env 0's reward, one most reward (1) too high at every step.
                rew = old(self, state, noisy_action, step).clone()
                rew[0] = rew[0] + 1.0
                return rew
            return reward
        cm = _patched(Quadrotor, '_rl_reward', altered)
    with cm:
        yield


def fault(name, seed, device, which, params=None, config=None, seconds=1.0, late=False):
    """The checks of a run of cell ``name`` with ``which`` planted: from the
    start, or with ``late`` (training) for the window alone."""
    cell = core.workload(name)
    if late:
        _, _, run = _drive(name, seed, device, params, config, seconds, window_fault=which)
        return run.check()
    with planted(cell, which):
        _, _, run = _drive(name, seed, device, params, config, seconds)
        if cell['driver'] != 'ppo_train':
            prog = run.program_rows()
    if cell['driver'] == 'ppo_train':
        return run.check()
    driver = core.load_module('drivers', cell['driver'])
    return driver.compare(prog, run.reference())


def main(argv=None):
    ap = argparse.ArgumentParser(description='Readings of the control, the float64 witness '
                                 'or a planted fault.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--what', nargs='+', default=['control'], choices=READINGS + FAULTS)
    ap.add_argument('--late', action='store_true')
    ap.add_argument('--seconds', type=float, default=1.0)
    args = ap.parse_args(argv)
    torch.set_float32_matmul_precision('highest')
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = [w for w in args.what if w in READINGS]
    faults = [w for w in args.what if w in FAULTS]

    def emit(what, seed, checks, rows=None):
        line = {'workload': args.workload, 'what': what, 'late': args.late, 'seed': seed,
                'failed': any(not c.passed for c in checks),
                'readings': {c.name: [c.value, c.limit] for c in checks}}
        if rows is not None:
            line['rows'] = rows
        print(json.dumps(line), flush=True)

    for seed in args.seeds:
        if refs:
            for what, (checks, rows) in readings(args.workload, seed, 'cuda', refs,
                                                 seconds=args.seconds).items():
                emit(what, seed, checks, rows)
        for which in faults:
            emit(which, seed, fault(args.workload, seed, 'cuda', which, seconds=args.seconds,
                                    late=args.late))


if __name__ == '__main__':
    main()
