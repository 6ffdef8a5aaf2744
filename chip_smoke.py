"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time its
kernels, then drive the batched cartpole rollout through the port's entry points.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. card      the card's name and power limit (nvidia-smi);
  2. build     nvcc of every csrc/*.cu, timed;
  3. k1        K1 (cartpole_advance) against its plain version at B=4096;
  4. k4        K4 (cartpole_rollout) against its plain version at B=4096 in three
               modes: replay, tracking with quadratic cost, constrained with
               white action noise and Philox draws;
  5. main_path make('cartpole', device='cuda') -> measure_batched (per-step
               path, K1) and measure_rollout_kernel (whole-rollout path, K4)
               plain, constrained and tracking, with the launch counters set to 0
               before and read after;
  6. welch     the stochastic K4 against the per-step path in distribution;
  7. kernels   one line per kernel with its launches, error, times and bound.
The last line is {"ok": true, "device": {...}}. Any failure raises before it,
and the exit code is then not 0. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores. Integer operations are counted at the
# float32 rate, which can only make a bound smaller.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

B = 4096
N_SUB, DT = 20, 1e-3
T_CHECK = 300          # K4 against its per-step plain version
T_PER_STEP = 1024      # the per-step path of the main path
T_ROLLOUT = 131072     # the whole-rollout path of the main path
T_WELCH = 1024

# Operations per env and substep of the cartpole update (sin, cos, the
# reciprocal and 28 multiplies, adds and subtracts), and per env and control
# step of K4's other work: Philox4x32-10 (10 rounds of 2 mul-hi/lo pairs,
# 4 xors and 2 key adds) per 4 words, uniform conversion, Box-Muller, action
# pipeline, reward, done, violations and reset.
OPS_SUBSTEP = 31
OPS_PHILOX = 10 * 10
OPS_STEP_REST = {'uniform': 3 * 4, 'box_muller': 8, 'action': 6, 'reward': 20,
                 'done': 12, 'violation': 12, 'reset': 12}


def emit(phase, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def card():
    line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def time_ms(fn, reps, primed=True):
    """Time of one call of ``fn``: CUDA events around ``reps`` calls after one
    warm-up call. ``primed`` first queues a ~25 ms sleep on the card, so the
    host enqueues the calls while the card is busy and the events measure
    device time only; unprimed, the time also holds the host's launch gaps."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if primed:
        torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_k1(dev):
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    g = torch.Generator(device=dev).manual_seed(0)
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)
    states, forces, tab = u((B, 4), -0.3, 0.3), u((B,), -10.0, 10.0), u((B, 2), -0.5, 0.5)
    params = torch.tensor([0.1, 1.0, 0.5, 9.8], device=dev)
    args = (states, forces, tab, params, N_SUB, DT)
    err = float((pk.cartpole_advance(*args) - pk.cartpole_advance_plain(*args)).abs().max())
    torch.cuda.synchronize()
    if not err <= 1e-5:
        raise RuntimeError(f'K1 disagrees with its plain version: max abs err {err}')
    ms = time_ms(lambda: pk.cartpole_advance(*args), 200)
    # The plain version's ~600 launches a call are its cost: timed unprimed.
    plain_ms = time_ms(lambda: pk.cartpole_advance_plain(*args), 5, primed=False)
    launch_bound_ms = time_ms(lambda: pk.cartpole_advance(*args), 200, primed=False)
    n_bytes = B * (16 + 4 + 8 + 16) + 16
    b_ms, b_by = bound_ms(n_bytes, B * (N_SUB * OPS_SUBSTEP + 10))
    row = dict(name='cartpole_advance', route='cuda',
               source='safe_control_gym_tpu_torch/csrc/cartpole_kernels.cu',
               replaces='safe_control_gym_tpu/ops/pallas_kernels.py:86',
               max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None,
               library_note='no single PyTorch call computes n_substeps of this update',
               back_to_back_ms=launch_bound_ms, shape=f'B={B} n_substeps={N_SUB}')
    emit('k1', tol=1e-5, **row)
    return row


def _k4_cases(dev):
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _env_kwargs
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.registration import make
    g = torch.Generator(device=dev).manual_seed(1)
    replay = -10 + 20 * torch.rand((T_CHECK, B), generator=g, device=dev)
    cases = []
    for name, env_kw, mode in [
            ('replay_stabilization_rl_reward', _env_kwargs('cartpole', False),
             dict(actions=replay, draw_actions=False)),
            ('tracking_quadratic', dict(_env_kwargs('cartpole', False, tracking=True),
                                        cost='quadratic'), {}),
            ('constrained_noise_draws', _env_kwargs('cartpole', True),
             dict(constrained=True))]:
        env = make('cartpole', device=dev, **env_kw)
        cfg = rk.cartpole_rollout_cfg(env)
        if mode.get('constrained'):
            cfg[rk._C['NOISE_STD']] = float(env.disturbances['action'].disturbances[0].std[0])
        states, _ = env.func.reset_batch(g, B)
        kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                  randomized_reset=env.RANDOMIZED_INIT, **mode,
                  **rk.rollout_task_kwargs(env))
        cases.append((name, states.state.contiguous(), cfg, kw))
    return cases


def k4_ops_per_env_step(kw):
    ops = N_SUB * OPS_SUBSTEP + OPS_STEP_REST['action'] + OPS_STEP_REST['reward'] \
        + OPS_STEP_REST['done'] + OPS_STEP_REST['reset']
    if kw.get('draw_actions', True) or kw.get('constrained'):
        ops += OPS_PHILOX + OPS_STEP_REST['uniform']
    if kw.get('randomized_reset'):
        ops += OPS_PHILOX + OPS_STEP_REST['uniform']
    if kw.get('constrained'):
        ops += OPS_STEP_REST['box_muller'] + OPS_STEP_REST['violation']
    return ops


def k4_bytes(kw, T):
    n = B * (16 + 16 + 4 * 4) + 40 * 4
    if not kw.get('draw_actions', True):
        n += T * B * 4
    if 'x_goal' in kw:
        n += kw['x_goal'].numel() * 4
    return n


def check_k4(dev):
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    worst = 0.0
    row = None
    for name, s0, cfg, kw in _k4_cases(dev):
        k = rk.cartpole_rollout(s0, cfg, 7, T_CHECK, **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p = rk.cartpole_rollout_plain(s0, cfg, 7, T_CHECK, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        state_err = float((k['state'] - p['state']).abs().max())
        rew_err = float((k['reward_sum'] - p['reward_sum']).abs().max())
        rew_tol = float((1e-4 + 1e-4 * p['reward_sum'].abs()).min())
        flips = {key: int((k[key] != p[key]).sum())
                 for key in ('done_count', 'ctrl_step', 'violation_count')}
        ok = (state_err <= 1e-4 and bool(((k['reward_sum'] - p['reward_sum']).abs()
                                           <= 1e-4 + 1e-4 * p['reward_sum'].abs()).all())
              and not any(flips.values()))
        emit('k4', case=name, T=T_CHECK, B=B, state_err=state_err, reward_err=rew_err,
             reward_tol_min=rew_tol, envs_with_other_counts=flips, ok=ok,
             mean_done_count=float(k['done_count'].mean()),
             mean_violation_count=float(k['violation_count'].mean()))
        if not ok:
            raise RuntimeError(
                f'K4 disagrees with its plain version on {name}: state err {state_err} '
                f'(tol 1e-4), reward err {rew_err} (tol 1e-4 + 1e-4|r|), envs whose '
                f'counts differ {flips} (must be none: both draw the same Philox '
                'numbers and round the same float ops)')
        worst = max(worst, state_err, rew_err)
        if name == 'constrained_noise_draws':
            ms = time_ms(lambda: rk.cartpole_rollout(s0, cfg, 8, T_CHECK, **kw), 5)
            warp_s0 = s0[:32].contiguous()
            one_warp_ms = time_ms(lambda: rk.cartpole_rollout(warp_s0, cfg, 8, T_CHECK,
                                                              **kw), 5)
            b_ms, b_by = bound_ms(k4_bytes(kw, T_CHECK), B * T_CHECK * k4_ops_per_env_step(kw))
            row = dict(name='cartpole_rollout', route='cuda',
                       source='safe_control_gym_tpu_torch/csrc/cartpole_kernels.cu',
                       replaces='safe_control_gym_tpu/ops/rollout_kernels.py:427',
                       ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None,
                       library_note='no single PyTorch call computes a T-step env rollout',
                       one_warp_ms=one_warp_ms,
                       shape=f'B={B} T={T_CHECK} constrained, noise and Philox draws')
    row['max_abs_err'] = worst
    return row


def main_path(dev, smi):
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    pk.cartpole_advance.launches = 0
    rk.cartpole_rollout.launches = 0
    rows = {}
    for constrained in (False, True):
        su, sps, ex = bs.measure_batched('cartpole', constrained, batch=B,
                                         n_steps=T_PER_STEP, n_reps=2, device=dev)
        if not ex['mean_done_count'] > 0:
            raise RuntimeError(f'per-step path saw no episode end: {ex}')
        rows[f'per_step constrained={constrained}'] = dict(
            path='per-step (K1)', batch=B, T=T_PER_STEP, ctrl_steps_per_s=sps,
            speedup=su, card=smi, **ex)
    for constrained, tracking in ((False, False), (True, False), (False, True)):
        if not bs.kernel_covers('cartpole', constrained, tracking, device=dev):
            raise RuntimeError('the rollout kernel does not cover the benchmark config')
        su, sps, ex = bs.measure_rollout_kernel('cartpole', constrained, batch=B,
                                                n_steps=T_ROLLOUT, n_reps=3,
                                                tracking=tracking, device=dev)
        rows[f'rollout constrained={constrained} tracking={tracking}'] = dict(
            path='whole-rollout (K4)', batch=B, T=T_ROLLOUT, ctrl_steps_per_s=sps,
            speedup=su, card=smi, **ex)
    launches = {'cartpole_advance': pk.cartpole_advance.launches,
                'cartpole_rollout': rk.cartpole_rollout.launches}
    for row_name, row in rows.items():
        emit('main_path', row=row_name, **row)
    emit('main_path', launches=launches)
    for name, n in launches.items():
        if n <= 0:
            raise RuntimeError(f'the main path never launched {name}')
    return launches, rows


def _welch(a, b, label, z=6.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    diff = abs(a.mean() - b.mean())
    ratio = a.var() / b.var() if min(a.var(), b.var()) > 1e-12 else 1.0
    ok = bool(diff <= z * se + 1e-9 and 0.5 < ratio < 2.0)
    emit('welch', stat=label, kernel_mean=a.mean(), per_step_mean=b.mean(), se=se,
         z=diff / se if se > 0 else 0.0, var_ratio=ratio, ok=ok)
    if not ok:
        raise RuntimeError(f'Welch check failed for {label}')


def welch(dev):
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.registration import make
    for constrained in (False, True):
        env = make('cartpole', device=dev, **bs._env_kwargs('cartpole', constrained))
        gen = torch.Generator(device=dev).manual_seed(23)
        states, _ = env.func.reset_batch(gen, B)
        cfg = bs._kernel_cfg(env, constrained)
        k = rk.cartpole_rollout(states.state.contiguous(), cfg, 11, T_WELCH,
                                env.PYB_STEPS_PER_CTRL, env.PYB_TIMESTEP,
                                constrained=constrained,
                                randomized_reset=env.RANDOMIZED_INIT)
        lo = torch.as_tensor(env.action_space.low, device=dev)
        hi = torch.as_tensor(env.action_space.high, device=dev)
        actions = lo + torch.rand((T_WELCH, B, 1), generator=gen, device=dev) * (hi - lo)
        _, s = bs.per_step_rollout(env, states, actions, gen)
        keys = ('reward_sum', 'done_count') + (('violation_count',) if constrained else ())
        if not float(k['done_count'].mean()) > 0:
            raise RuntimeError('stochastic K4 saw no episode end')
        for key in keys:
            _welch((k[key] / T_WELCH).cpu().numpy(), (s[key] / T_WELCH).cpu().numpy(),
                   f'constrained={constrained} {key}/step')


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the GPU', file=sys.stderr)
        sys.exit(2)
    from safe_control_gym_tpu_torch.ops import _build
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    name = torch.cuda.get_device_name(0)
    emit('card', nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit('build', seconds=time.perf_counter() - t0, flags=_build.NVCC_FLAGS,
         libraries=sorted(libs))
    k1 = check_k1(dev)
    k4 = check_k4(dev)
    launches, rows = main_path(dev, smi)
    welch(dev)
    k1['launches'] = launches['cartpole_advance']
    k4['launches'] = launches['cartpole_rollout']
    main_row = rows['rollout constrained=True tracking=False']
    k4['main_path_ms'] = main_row['kernel_ms']
    k4['main_path_bound_ms'] = bound_ms(
        k4_bytes({'constrained': True}, T_ROLLOUT),
        B * T_ROLLOUT * k4_ops_per_env_step({'constrained': True, 'randomized_reset': True}))[0]
    k4['main_path_shape'] = f'B={B} T={T_ROLLOUT} constrained'
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    kernels = [{**{k: row[k] for k in keys}, **{k: v for k, v in row.items() if k not in keys}}
               for row in (k1, k4)]
    emit('done', wall_seconds=time.perf_counter() - t_start, card=smi)
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    main()
