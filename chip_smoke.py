"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check and time its
kernels, then drive the batched cartpole and quadrotor rollouts and the
closed-loop evaluation of the committed RL models through the port's entry
points.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. card      the card's name and power limit (nvidia-smi);
  2. build     nvcc of every csrc/*.cu, one process per source, timed;
  3. k1, k2, k3  the per-step physics kernels (cartpole_advance, quad2d_advance,
               quad3d_advance) against their plain versions, bit for bit, on
               every case of benchmark_suite.physics_cases: random inputs
               with tab or world forces at B=4096, a hover (angles exactly
               0), angles past sinf's fast range on every 97th env (the
               step's library recompute), B=4109 (a ragged last warp), four
               warps an SM (B=16896 on 132 SMs) and n_substeps 7 (the
               runtime-count instantiation); each row's time primed and back
               to back, the launch floor (an empty kernel on the same grid),
               B=65536, and ptxas's registers and spills of each
               instantiation; the kernels line adds each row's chain bound
               (20 x one substep's chain from the phase chain) and issue
               floor (20 x one substep's fast-path instructions at one a
               cycle);
  4. k4, k5    the whole-rollout kernels (cartpole_rollout; quad2d_rollout and
               quad3d_rollout) against their plain versions, bit for bit, at
               B=4096 in three modes (replay, tracking with quadratic cost,
               constrained with white action noise and Philox draws), and
               constrained at B=4109, at n_substeps 7 and 4 (the general path),
               at four warps an SM (B=16896 on 132 SMs), on a hover replay
               and with angles past sinf's fast range (the step's library
               recompute);
     chain     csrc/exact_math.cuh against the CUDA math library, the SASS of
               the substep loops, ns a substep on random and hover rows and
               at B=65536, the latencies of the chain's instructions on this
               card (csrc/latency_probe.cu), the chain cycles of a substep at
               those latencies and the SM clock (experiments/chain.py); the
               open-loop rows of the kernels line gain chain_bound_ms,
               issue_floor_ms, lanes_per_env and these times;
  5. main_path make(..., device='cuda') -> measure_batched (per-step path, K1,
               K2, K3) plain and constrained, and measure_rollout_kernel
               (whole-rollout path, K4, K5) on the reference benchmark's rows,
               with every launch counter set to 0 before and read after;
  6. welch     the stochastic K4 and K5 against the per-step path in
               distribution;
  7. k4_policy, k5_policy  K4 and K5 in policy mode (the committed actors:
               deterministic PPO with obs normalization, deterministic SAC
               256 wide with relu and squash, stochastic PPO with Philox
               exploration; a ragged batch, B=4109, whose last tile of envs
               is partly filled; a random 384 -> 1000 actor, whose H2 the
               kernel runs in chunks; then the inputs the closed loop gives the
               kernel for each committed model it admits) against their plain
               versions at B=4096; each case also reports its time a step,
               its shares of the ops bound and of the float32 ceiling
               without fused multiply-adds, one block's time (32 envs), and
               actor_library_ms, the actor alone as three torch.addmm in a
               CUDA graph (a yardstick the port never calls);
  8. closed_loop  the slice's main path: make(algo, ...) -> ctrl.load(the
               committed *_stab model) -> ctrl.evaluate_fused(batch=4096) for
               PPO and SAC on cartpole and the 2D and 3D quads, each row's path
               and launch counts asserted, then measure_closed_loop_kernel on
               bench.py's closed-loop rows and one at the SAC width, with
               every launch counter set to 0 before and read after;
  9. welch_closed_loop  stochastic PPO through the kernel path against the
               per-step path, per env, in distribution;
 10. ppo_train PPO training through make('ppo', ..., training=True): the
               committed cartpole config (64 envs x 150 steps, 300k env
               steps) to its end, then ctrl.run(n_episodes=10), gated on
               finite losses, total_steps, K1's launches (iterations x T plus
               the eval's steps) and an eval return of PPO_EVAL_BAR; the
               committed 2D and 3D configs (128 wide) for two iterations
               each, gated on finite losses and K2's or K3's launches; one
               update on a batch of the card's last cartpole rollout, card
               against CPU on the same permutations (params 1e-4); a
               torch.profiler window over one rollout and one epoch (the
               device's busy share); every launch counter set to 0 before
               each training part and read after;
 11. kernels   one entry per kernel with its launches, error, times and bound
               (K1-K3 also with train_launches and train_shape, from phase
               ppo_train).
The last line is {"ok": true, "device": {...}}. Any failure raises before it,
and the exit code is then not 0. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores. Integer operations are counted at the
# float32 rate, which can only make a bound smaller.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

B = 4096
B_RAGGED = B + 13      # the policy mode's last tile of 32 envs partly filled
B_BIG = 65536          # the per-step kernels' large-batch time
CHUNKED_WIDTHS = (384, 1000)   # an actor whose H2 the policy kernel runs in chunks
T_CHUNKED = 40
N_SUB, DT = 20, 1e-3
T_CHECK = {'cartpole': 300, 'quadrotor': 150, 'quadrotor_3D': 150}  # against the plain version
T_PER_STEP = 1024      # the per-step path of the main path
T_ROLLOUT = 131072     # the whole-rollout path of the main path
T_WELCH = 1024
T_CLOSED = 500         # the committed models' closed-loop rows (two episodes)
T_COMMITTED = 300      # the committed models against the plain version: past the
                       # 250-step episode, so every env draws a fresh state
T_WELCH_CLOSED = 1000
PPO_QUAD_ITERATIONS = 2   # training iterations of the 2D and 3D configs
# The cartpole training's eval bar: the solved mark, deterministic eval return
# 200 (PERFORMANCE.md:354-356). The JAX package's PPO, trained on the CPU with
# the same config and seed 0, evaluates to 249.28 over 10 episodes
# (tests/test_torch_ppo_train.py::test_cartpole_solves_as_jax_does), so the
# bar is the solved mark and not 0.8 of JAX's return.
PPO_EVAL_BAR = 200.0
PPO_UPDATE_ATOL = 1e-4
# bench.py's closed-loop rows (hidden 64, stochastic), and one at the SAC width.
CLOSED_BENCH = [('cartpole', 64, 'tanh', 1, 65536), ('quadrotor', 64, 'tanh', 1, 65536),
                ('quadrotor_3D', 64, 'tanh', 1, 65536), ('quadrotor_3D', 256, 'relu', 2, 2048)]
ROOT = os.path.dirname(os.path.abspath(__file__))

# Operations per env and physics substep (sin and cos count one each):
# cartpole: sin, cos, the reciprocal and 28 multiplies, adds and subtracts;
# 2D quad: one sin/cos pair and 16 others; 3D quad: three sin/cos pairs,
# three divides and 60 others. Per env and call, the hoisted invariants.
OPS_SUBSTEP = {'cartpole': 31, 'quadrotor': 18, 'quadrotor_3D': 69}
OPS_INVARIANT = {'cartpole': 10, 'quadrotor': 10, 'quadrotor_3D': 25}
# Philox4x32-10 (10 rounds of 2 mul-hi/lo pairs, 4 xors and 2 key adds) per
# four words, and the four uniform conversions.
OPS_PHILOX = 10 * 10
OPS_UNIFORM4 = 3 * 4
# K4's other work per env and control step.
OPS_STEP_REST = {'uniform': OPS_UNIFORM4, 'box_muller': 8, 'action': 6, 'reward': 20,
                 'done': 12, 'violation': 12, 'reset': 12}

SYSTEMS = ('cartpole', 'quadrotor', 'quadrotor_3D')
# The committed models' system names, and the benchmark system of each.
MODEL_SYSTEM = {'cartpole': 'cartpole', 'quadrotor_2D': 'quadrotor',
                'quadrotor_3D': 'quadrotor_3D'}
MODELS = [(algo, system) for algo in ('ppo', 'sac') for system in MODEL_SYSTEM]
NX = {'cartpole': 4, 'quadrotor': 6, 'quadrotor_3D': 12}
NU = {'cartpole': 1, 'quadrotor': 2, 'quadrotor_3D': 4}
N_OOB = {'quadrotor': 3, 'quadrotor_3D': 6}
ANGLE_DIM = {'cartpole': 2, 'quadrotor': 4, 'quadrotor_3D': 7}
QUAD_TYPE = {'quadrotor': 2, 'quadrotor_3D': 3}

SRC = 'safe_control_gym_tpu_torch/csrc/'
PHYSICS = {  # per-step physics kernel of each system
    'cartpole': dict(id='K1', name='cartpole_advance', source=SRC + 'cartpole_kernels.cu',
                     replaces='safe_control_gym_tpu/ops/pallas_kernels.py:86'),
    'quadrotor': dict(id='K2', name='quad2d_advance', source=SRC + 'quad_kernels.cu',
                      replaces='safe_control_gym_tpu/ops/pallas_kernels.py:190'),
    'quadrotor_3D': dict(id='K3', name='quad3d_advance', source=SRC + 'quad_kernels.cu',
                         replaces='safe_control_gym_tpu/ops/pallas_kernels.py:322'),
}
ROLLOUT = {  # whole-rollout kernel of each system
    'cartpole': dict(id='K4', name='cartpole_rollout', source=SRC + 'cartpole_kernels.cu',
                     replaces='safe_control_gym_tpu/ops/rollout_kernels.py:427'),
    'quadrotor': dict(id='K5', name='quad2d_rollout', source=SRC + 'quad_kernels.cu',
                      replaces='safe_control_gym_tpu/ops/rollout_kernels.py:850'),
    'quadrotor_3D': dict(id='K5', name='quad3d_rollout', source=SRC + 'quad_kernels.cu',
                         replaces='safe_control_gym_tpu/ops/rollout_kernels.py:850'),
}


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


def _registers(lib, kernel):
    """{instantiation: ptxas's registers, stack and spills} of ``kernel``'s
    instantiations in ``lib`` (from its build's ptxas report)."""
    from safe_control_gym_tpu_torch.experiments import chain, sass
    from safe_control_gym_tpu_torch.ops import _build
    with open(_build.ptxas_log(lib)) as f:
        usage = sass.ptxas_resources(f.read())
    return {f'{kernel}<{",".join(map(str, chain.template_args(fname)))}>': row
            for fname, row in usage.items() if f'{kernel}I' in fname or f'{kernel}E' in fname}


def check_physics(system, dev):
    """K1, K2 or K3 against its plain version on every per-step case, bit for
    bit (the plain version repeats the kernel's float ops, and the exact
    substeps give the library's results), timed on the random case."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.experiments import chain
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    meta = PHYSICS[system]
    kernel, plain = getattr(pk, meta['name']), getattr(pk, meta['name'] + '_plain')
    cases = {}
    for case, args in bs.physics_cases(system, dev, B, N_SUB, DT):
        err = float((kernel(*args) - plain(*args)).abs().max())
        torch.cuda.synchronize()
        cases[case] = dict(B=args[0].shape[0], n_substeps=args[-2], max_abs_err=err)
        emit(meta['id'].lower(), kernel=meta['name'], case=case, tol=0.0, **cases[case])
        if err != 0.0:
            raise RuntimeError(f'{meta["id"]} disagrees with its plain version on {case}: '
                               f'max abs err {err} (must be 0.0)')
    args = (*bs.physics_args(system, dev, B), N_SUB, DT)
    ms = time_ms(lambda: kernel(*args), 200)
    # The plain version's hundreds of launches a call are its cost: timed unprimed.
    plain_ms = time_ms(lambda: plain(*args), 5, primed=False)
    back_to_back_ms = time_ms(lambda: kernel(*args), 200, primed=False)
    launch_floor_ms = time_ms(chain.launch_floor(B, dev), 200)
    big = (*bs.physics_args(system, dev, B_BIG), N_SUB, DT)
    big_batch_ms = time_ms(lambda: kernel(*big), 200)
    del big
    n_bytes = sum(a.numel() * 4 for a in args[:-2]) + B * NX[system] * 4
    b_ms, b_by = bound_ms(n_bytes, B * (N_SUB * OPS_SUBSTEP[system] + OPS_INVARIANT[system]))
    lib = os.path.basename(meta['source'])[:-3]
    row = dict(name=meta['name'], route='cuda', source=meta['source'],
               replaces=meta['replaces'], max_abs_err=max(c['max_abs_err'] for c in
                                                          cases.values()),
               ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               library_note='no single PyTorch call computes n_substeps of this update',
               back_to_back_ms=back_to_back_ms, launch_floor_ms=launch_floor_ms,
               big_batch_ms=big_batch_ms, big_batch_shape=f'B={B_BIG} n_substeps={N_SUB}',
               registers=_registers(lib, meta['name'] + '_kernel'), cases=cases,
               shape=f'B={B} n_substeps={N_SUB}', id=meta['id'])
    emit(meta['id'].lower(), **{k: v for k, v in row.items() if k != 'cases'})
    return row


def _plain_rollout(system):
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    if system == 'cartpole':
        return rk.cartpole_rollout_plain
    return functools.partial(rk.quad_rollout_plain, QUAD_TYPE[system])


def _rollout_cases(system, dev, T):
    """(name, state0, cfg, kwargs) of the checked open-loop cases of
    ``system``: three modes at B (replay, tracking with quadratic cost,
    constrained with noise and Philox draws); constrained draws at B_RAGGED
    (a last warp of 8 envs and a last block partly filled), at n_substeps 7
    and 4 (the kernels' general path; the others run the 20 compiled in) and,
    at a batch of four warps an SM (blocks of 128 threads); a hover replay
    (the angles exactly 0: zero numerators in 3D's quotients); and envs
    started at an angle past sinf's fast range (the step recomputed with the
    library's functions)."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.registration import make
    g = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for name, constrained, tracking, over in [
            ('replay_stabilization_rl_reward', False, False, {}),
            ('tracking_quadratic', False, True, dict(cost='quadratic')),
            ('constrained_noise_draws', True, False, {})]:
        env = make(system.replace('_3D', ''), device=dev,
                   **bs._env_kwargs(system, constrained, tracking), **over)
        cfg = bs._kernel_cfg(system, env, constrained)
        states, _ = env.func.reset_batch(g, B)
        mode = dict(constrained=constrained)
        if name.startswith('replay'):
            lo = torch.as_tensor(env.action_space.low, device=dev)
            hi = torch.as_tensor(env.action_space.high, device=dev)
            actions = lo + (hi - lo) * torch.rand((T, B, NU[system]), generator=g, device=dev)
            mode = dict(actions=actions[..., 0] if system == 'cartpole' else actions,
                        draw_actions=False)
        kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                  randomized_reset=env.RANDOMIZED_INIT, **mode,
                  **rk.rollout_task_kwargs(env))
        cases.append((name, states.state.contiguous(), cfg, kw))
    s0, cfg, kw = cases[-1][1:]
    reset = lambda n: env.func.reset_batch(g, n)[0].state.contiguous()
    cases.append(('ragged_batch_constrained', reset(B_RAGGED), cfg, kw))
    for n_sub in (7, 4):
        cases.append((f'substeps_{n_sub}_constrained', s0, cfg,
                      dict(kw, n_substeps=n_sub, dt=env.CTRL_TIMESTEP / n_sub)))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cases.append(('large_batch_constrained', reset(32 * 4 * n_sm), cfg, kw))
    hover, raw, cfg_h, kw_h = bs.hover_case(system, dev)
    cases.append(('hover', hover.expand(B, -1).contiguous(), cfg_h,
                  dict(kw_h, actions=bs.hover_actions(system, raw, T, B))))
    special = s0.clone()
    special[::97, ANGLE_DIM[system]] = 2.0e5
    cases.append(('angle_past_sinf_fast_range', special, cfg, kw))
    return cases


def rollout_ops(system, kw, T, done_total=0.0, batch=B):
    """Operations of a ``batch``-env, T-step rollout in mode ``kw``;
    ``done_total`` is the run's summed done count (fresh states are drawn only
    where done)."""
    if system == 'cartpole':
        ops = N_SUB * OPS_SUBSTEP[system] + OPS_STEP_REST['action'] \
            + OPS_STEP_REST['reward'] + OPS_STEP_REST['done'] + OPS_STEP_REST['reset']
        if kw.get('draw_actions', True) or kw.get('constrained'):
            ops += OPS_PHILOX + OPS_STEP_REST['uniform']
        if kw.get('randomized_reset'):
            ops += OPS_PHILOX + OPS_STEP_REST['uniform']
        if kw.get('constrained'):
            ops += OPS_STEP_REST['box_muller'] + OPS_STEP_REST['violation']
        return batch * T * ops
    nx, nu = NX[system], NU[system]
    ops = N_SUB * OPS_SUBSTEP[system] + OPS_INVARIANT[system]
    ops += nu * (4 + 9)                  # denormalize, clip; motor model
    ops += 6 if nx == 6 else 19          # rotor forces (and yaw torque)
    ops += nx * 6 + nu * 4 + 2           # reward
    ops += N_OOB[system] * 4 + 4         # done
    ops += 3                             # accumulators
    if kw.get('draw_actions', True):
        ops += OPS_PHILOX + OPS_UNIFORM4 + 2 * nu
    if kw.get('constrained'):
        ops += OPS_PHILOX + OPS_UNIFORM4 + nu // 2 * 13 + (nx + nu) * 4
    n = batch * T * ops
    reset_words = (nx + 3) // 4 * (OPS_PHILOX + OPS_UNIFORM4) if kw.get('randomized_reset') else 0
    return n + done_total * (reset_words + 2 * nx)


def rollout_bytes(system, kw, T, batch=B):
    nx = NX[system]
    n = batch * (nx * 4 + nx * 4 + 4 * 4) + (40 if system == 'cartpole' else 105) * 4
    if not kw.get('draw_actions', True):
        n += T * batch * NU[system] * 4
    if 'x_goal' in kw:
        n += kw['x_goal'].numel() * 4
    return n


def check_rollout(system, dev, length=None):
    """K4 or K5 against its plain version on every case of ``_rollout_cases``,
    bit for bit (state and reward sums equal, no count differing), timed on
    the constrained case. ``length`` overrides T."""
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel
    meta, T = ROLLOUT[system], length or T_CHECK[system]
    kernel, plain = _kernel(system)[1], _plain_rollout(system)
    worst = 0.0
    row = None
    for name, s0, cfg, kw in _rollout_cases(system, dev, T):
        k = kernel(s0, cfg, 7, T, **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p = plain(s0, cfg, 7, T, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        state_err = float((k['state'] - p['state']).abs().max())
        rew_err = float((k['reward_sum'] - p['reward_sum']).abs().max())
        flips = {key: int((k[key] != p[key]).sum())
                 for key in ('done_count', 'ctrl_step', 'violation_count')}
        ok = state_err == 0.0 and rew_err == 0.0 and not any(flips.values())
        emit(meta['id'].lower(), kernel=meta['name'], case=name, T=T, B=s0.shape[0],
             n_substeps=kw['n_substeps'], state_err=state_err, reward_err=rew_err,
             envs_with_other_counts=flips, ok=ok,
             mean_done_count=float(k['done_count'].mean()),
             mean_violation_count=float(k['violation_count'].mean()))
        if not ok:
            raise RuntimeError(
                f'{meta["name"]} disagrees with its plain version on {name}: state err '
                f'{state_err}, reward err {rew_err} (both must be 0.0), envs whose counts '
                f'differ {flips} (must be none: both draw the same Philox numbers and '
                'round the same float ops)')
        worst = max(worst, state_err, rew_err)
        if name == 'constrained_noise_draws':
            ms = time_ms(lambda: kernel(s0, cfg, 8, T, **kw), 5)
            block_s0 = s0[:32].contiguous()
            one_block_ms = time_ms(lambda: kernel(block_s0, cfg, 8, T, **kw), 5)
            done_total = float(kernel(s0, cfg, 8, T, **kw)['done_count'].sum())
            b_ms, b_by = bound_ms(rollout_bytes(system, kw, T),
                                  rollout_ops(system, kw, T, done_total))
            row = dict(name=meta['name'], route='cuda', source=meta['source'],
                       replaces=meta['replaces'], ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       library_note='no single PyTorch call computes a T-step env rollout',
                       one_block_ms=one_block_ms,
                       shape=f'B={B} T={T} constrained, noise and Philox draws',
                       id=meta['id'])
    row['max_abs_err'] = worst
    return row


def chain(dev):
    """The open loop's serial chain (``experiments/chain.py``, as
    ``kernel_first_check --chain`` prints it): the exact-math check (every
    result of csrc/exact_math.cuh equal to the library's), ns a substep on
    random and hover rows at B, one block and B=65536, the latencies of the
    chain's instruction classes on this card (csrc/latency_probe.cu), the SASS
    of the substep loops, the chain cycles of one substep (the per-step
    kernels' runtime-count loop) at those latencies, and the SM clock under
    load."""
    from safe_control_gym_tpu_torch.experiments import chain as ch
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    exact = rk.exact_math_check(dev)
    emit('chain', exact_math=exact)
    if any(differ for _, differ in exact.values()) or not all(n for n, _ in exact.values()):
        raise RuntimeError(f'csrc/exact_math.cuh differs from the CUDA math library: {exact}')
    clock = ch.sm_clock_ghz()
    probes, sass_rows, _ = ch.measured_chain(dev)
    for row in probes:
        emit('chain', latency=row)
        if not 1.0 <= row['cycles'] <= 200.0:
            raise RuntimeError(f'implausible latency reading {row}')
    for system, kernels in sass_rows.items():
        for fname, entry in kernels.items():
            if 'substep_loop' in entry:
                emit('chain', system=system, kernel=fname, substep_loop=entry['substep_loop'])
    cycles = ch.reference_chain_cycles(sass_rows)
    if set(cycles) != set(SYSTEMS):
        raise RuntimeError(f'no reference substep loop for {set(SYSTEMS) - set(cycles)}')
    fast_path = ch.compiled_in_fast_path(sass_rows)
    emit('chain', compiled_in_fast_path_per_substep=fast_path)
    if any(set(fast_path.get(s, {})) != {'advance', 'rollout'} for s in SYSTEMS):
        raise RuntimeError(f'a substep loop compiled for {N_SUB} substeps is missing: '
                           f'{fast_path}')
    times = ch.chain_times(dev)
    for row in times:
        emit('chain', **row)
    return dict(clock_ghz=clock, cycles=cycles, fast_path=fast_path,
                table_cycles=ch.reference_chain_cycles(sass_rows, 'chain_cycles_table'),
                latency={row['probe']: row['cycles'] for row in probes},
                times={(r['system'], r['case']): r for r in times})


# The whole-rollout rows of the reference benchmark (bench.py): plain and
# constrained for each system, and the cartpole tracking row.
ROLLOUT_ROWS = [('cartpole', False, False), ('cartpole', True, False),
                ('cartpole', False, True), ('quadrotor', False, False),
                ('quadrotor', True, False), ('quadrotor_3D', False, False),
                ('quadrotor_3D', True, False)]


def _counters():
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    return [getattr(pk, m['name']) for m in PHYSICS.values()] \
        + [getattr(rk, m['name']) for m in ROLLOUT.values()]


def main_path(dev, smi):
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    for fn in _counters():
        fn.launches = 0
    rows = {}
    for system in SYSTEMS:
        for constrained in (False, True):
            su, sps, ex = bs.measure_batched(system, constrained, batch=B,
                                             n_steps=T_PER_STEP, n_reps=2, device=dev)
            if not ex['mean_done_count'] > 0:
                raise RuntimeError(f'per-step path saw no episode end: {system} {ex}')
            rows[f'per_step {system} constrained={constrained}'] = dict(
                path=f'per-step ({PHYSICS[system]["id"]})', system=system, batch=B,
                T=T_PER_STEP, ctrl_steps_per_s=sps, speedup=su, card=smi, **ex)
    for system, constrained, tracking in ROLLOUT_ROWS:
        if not bs.kernel_covers(system, constrained, tracking, device=dev):
            raise RuntimeError(f'the rollout kernel does not cover the {system} config')
        su, sps, ex = bs.measure_rollout_kernel(system, constrained, batch=B,
                                                n_steps=T_ROLLOUT, n_reps=3,
                                                tracking=tracking, device=dev)
        rows[f'rollout {system} constrained={constrained} tracking={tracking}'] = dict(
            path=f'whole-rollout ({ROLLOUT[system]["id"]})', system=system, batch=B,
            T=T_ROLLOUT, ctrl_steps_per_s=sps, speedup=su, card=smi, **ex)
    launches = {fn.__name__: fn.launches for fn in _counters()}
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
    for system, constrained in (('cartpole', False), ('cartpole', True),
                                ('quadrotor', True), ('quadrotor_3D', True)):
        env = bs._make(system, constrained, device=dev)
        gen = torch.Generator(device=dev).manual_seed(23)
        states, _ = env.func.reset_batch(gen, B)
        cfg = bs._kernel_cfg(system, env, constrained)
        k = bs._kernel(system)[1](states.state.contiguous(), cfg, 11, T_WELCH,
                                  env.PYB_STEPS_PER_CTRL, env.PYB_TIMESTEP,
                                  constrained=constrained,
                                  randomized_reset=env.RANDOMIZED_INIT)
        lo = torch.as_tensor(env.action_space.low, device=dev)
        hi = torch.as_tensor(env.action_space.high, device=dev)
        actions = lo + torch.rand((T_WELCH, B, NU[system]), generator=gen, device=dev) * (hi - lo)
        _, s = bs.per_step_rollout(env, states, actions, gen)
        keys = ('reward_sum', 'done_count') + (('violation_count',) if constrained else ())
        if not float(k['done_count'].mean()) > 0:
            raise RuntimeError(f'stochastic {ROLLOUT[system]["name"]} saw no episode end')
        for key in keys:
            _welch((k[key] / T_WELCH).cpu().numpy(), (s[key] / T_WELCH).cpu().numpy(),
                   f'{system} constrained={constrained} {key}/step')


def _model_path(algo, system):
    return os.path.join(ROOT, 'examples', 'rl', 'models', algo,
                        f'{algo}_model_{system}_stab.pt')


def _policy_cases(system, dev, T=None):
    """(name, T, state0, cfg, kwargs) of the checked policy modes of
    ``system``: three modes with the committed actors of its PPO and SAC
    models on the benchmark env, the SAC actor on a ragged batch, a random
    actor whose H2 the kernel runs in chunks, then the launch inputs the
    closed loop builds (``fused_eval.kernel_inputs``) for each committed
    model whose config the kernel admits. ``T`` overrides every case's
    length."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.experiments import fused_eval as fe
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint
    from safe_control_gym_tpu_torch.utils.registration import make
    model_system = {v: k for k, v in MODEL_SYSTEM.items()}[system]
    layout = rk._C if system == 'cartpole' else rk._Q
    nx, nu = NX[system], NU[system]
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(2)
    cases = []
    for name, algo, constrained in [('ppo_deterministic_obs_norm', 'ppo', False),
                                    ('sac_deterministic_relu_squash', 'sac', False),
                                    ('ppo_stochastic_constrained', 'ppo', True)]:
        params = load_checkpoint(_model_path(algo, model_system))['params']
        env = bs._make(system, constrained, device=dev)
        cfg = bs._kernel_cfg(system, env, constrained)
        states, _ = env.func.reset_batch(g, B)
        kw = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP, draw_actions=False,
                  constrained=constrained, randomized_reset=env.RANDOMIZED_INIT)
        if name == 'ppo_deterministic_obs_norm':
            # Frozen normalizer stats; the last dim's small variance makes
            # clip_obs bind.
            var = rng.uniform(0.5, 2.0, nx).astype(np.float32)
            var[-1] = 1e-4
            pp = rk.pack_policy_params(params['actor'], nx,
                                       obs_mean=rng.uniform(-0.1, 0.1, nx), obs_var=var,
                                       device=dev)
            kw.update(policy_activation='tanh', clip_obs=10.0)
        elif algo == 'sac':
            pp = rk.pack_policy_params(params['actor'], nx, device=dev)
            kw.update(policy_activation='relu', policy_squash=True)
        else:
            pp = rk.pack_policy_params(params['actor'], nx, device=dev)
            cfg[layout['P_STD']:layout['P_STD'] + nu] = torch.exp(
                torch.as_tensor(params['logstd'], device=dev))
            kw.update(policy_activation='tanh', policy_stochastic=True)
        kw['policy_params'] = pp
        cases.append((name, T or T_CHECK[system], states.state.contiguous(), cfg, kw))
    # A batch whose last tile of envs is partly filled: the widest actor (W2
    # streamed), with action noise and Philox draws.
    params = load_checkpoint(_model_path('sac', model_system))['params']
    env = bs._make(system, True, device=dev)
    states, _ = env.func.reset_batch(g, B_RAGGED)
    cases.append(('ragged_batch_sac_constrained', T or T_CHECK[system],
                  states.state.contiguous(), bs._kernel_cfg(system, env, True),
                  dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                       draw_actions=False, constrained=True,
                       randomized_reset=env.RANDOMIZED_INIT,
                       policy_params=rk.pack_policy_params(params['actor'], nx, device=dev),
                       policy_activation='relu', policy_squash=True)))
    # An actor too wide for the h2 of 32 envs: a random 384 -> 1000 one, W2
    # streamed and H2 run in chunks (the last one narrower), stochastic.
    widths = (nx, *CHUNKED_WIDTHS, 2 * nu)
    actor = [{'w': (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
              'b': (0.1 * rng.standard_normal(b)).astype(np.float32)}
             for a, b in zip(widths[:-1], widths[1:])]
    cfg = bs._kernel_cfg(system, env, True)
    cfg[layout['P_STD']:layout['P_STD'] + nu] = 0.3
    cases.append(('chunked_h2_stochastic', T or T_CHUNKED, states.state.contiguous(), cfg,
                  dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                       draw_actions=False, constrained=True,
                       randomized_reset=env.RANDOMIZED_INIT,
                       policy_params=rk.pack_policy_params(actor, nx, device=dev),
                       policy_activation='relu', policy_stochastic=True,
                       policy_squash=True)))
    if model_system == 'quadrotor_2D':     # the gates send it to the per-step path
        return cases
    for algo, stochastic in (('ppo', False), ('ppo', True), ('sac', False)):
        env_id, task_config, algo_config = eval_config(algo, model_system)
        ctrl = make(algo, functools.partial(make, env_id, device=dev, **task_config),
                    **algo_config)
        ctrl.load(_model_path(algo, model_system))
        spec = fe.policy_eval_spec(ctrl, ctrl.env, stochastic=stochastic)
        s0, cfg, kw = fe.kernel_inputs(spec, ctrl.env, B, 0, stochastic)
        ctrl.close()
        name = f'committed_{algo}_{model_system}_stab' + ('_stochastic' if stochastic else '')
        cases.append((name, T or T_COMMITTED, s0, cfg, kw))
    return cases


def mlp_ops(pp, nu):
    """Operations of one actor forward as the kernel runs it: 2 (nx H1 +
    H1 H2 + H2 nu) for the products and sums (of the nu_out outputs only the
    first nu are computed), the biases and activations, and the
    normalization."""
    return (2 * (pp.nx * pp.h1 + pp.h1 * pp.h2 + pp.h2 * nu)
            + 2 * (pp.h1 + pp.h2) + nu + 4 * pp.nx)


def policy_rollout_ops(system, kw, T, done_total=0.0, batch=B):
    """Operations of a ``batch``-env, T-step rollout in policy mode ``kw``."""
    nu = NU[system]
    per_step = mlp_ops(kw['policy_params'], nu)
    if kw.get('policy_stochastic'):
        if system == 'cartpole':
            per_step += OPS_STEP_REST['box_muller']
            if not kw.get('constrained'):
                per_step += OPS_PHILOX + OPS_STEP_REST['uniform']
        else:
            per_step += OPS_PHILOX + OPS_UNIFORM4 + nu // 2 * 13
    if kw.get('policy_squash'):
        per_step += nu
    return rollout_ops(system, kw, T, done_total, batch) + batch * T * per_step


def policy_rollout_bytes(system, kw, T, batch=B):
    """Bytes of a policy-mode rollout: the open-loop ones and the actor's
    weights the kernel reads (the first nu columns of W3 and b3)."""
    pp, nu = kw['policy_params'], NU[system]
    floats = (2 * pp.nx + pp.nx * pp.h1 + pp.h1 + pp.h1 * pp.h2 + pp.h2
              + pp.h2 * nu + nu)
    return rollout_bytes(system, kw, T, batch) + floats * 4


def actor_library_ms(pp, nu, activation, T, dev, batch=B):
    """A yardstick, never called by the port: the actor alone on ``batch``
    random obs as three ``torch.addmm`` and the activation (the first ``nu``
    outputs, TF32 off), captured in a CUDA graph; one replay's device time
    times T."""
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    _, _, w1, b1, w2, b2, w3, b3 = rk._policy_views(pp)
    w3, b3 = w3[:, :nu].contiguous(), b3[:nu].contiguous()
    act = torch.tanh if activation == 'tanh' else torch.relu
    obs = torch.randn((batch, pp.nx), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)

    def forward():
        h = act(torch.addmm(b1, obs, w1))
        return torch.addmm(b3, act(torch.addmm(b2, h, w2)), w3)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            forward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        forward()
    return time_ms(graph.replay, 50) * T


def check_policy(system, dev, length=None):
    """K4 or K5 in policy mode against its plain version on every case of
    ``_policy_cases``, timed; the SAC case (the widest actor) gives the
    kernels line's times. ``length`` overrides every case's T."""
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    meta = ROLLOUT[system]
    kernel, plain = _kernel(system)[1], _plain_rollout(system)
    phase = meta['id'].lower() + '_policy'
    worst = 0.0
    cases = {}
    for name, T, s0, cfg, kw in _policy_cases(system, dev, length):
        k = kernel(s0, cfg, 7, T, **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        p = plain(s0, cfg, 7, T, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        state_err = float((k['state'] - p['state']).abs().max())
        rew_err = float((k['reward_sum'] - p['reward_sum']).abs().max())
        flips = {key: int((k[key] != p[key]).sum())
                 for key in ('done_count', 'ctrl_step', 'violation_count')}
        ok = (state_err <= 1e-4 and bool(((k['reward_sum'] - p['reward_sum']).abs()
                                           <= 1e-4 + 1e-4 * p['reward_sum'].abs()).all())
              and not any(flips.values()))
        pp = kw['policy_params']
        n_envs = s0.shape[0]
        ms = time_ms(lambda: kernel(s0, cfg, 8, T, **kw), 3)
        done_total = float(k['done_count'].sum())
        n_ops = policy_rollout_ops(system, kw, T, done_total, n_envs)
        b_ms, b_by = bound_ms(policy_rollout_bytes(system, kw, T, n_envs), n_ops)
        # Without fused multiply-adds each one is two instructions: the
        # kernel can at best take twice the operations bound.
        ceiling_ms = 2 * n_ops / PEAK_OPS_PER_S * 1e3
        # One block (its 32 envs) against the full batch: the same time
        # means one block's serial chain sets the pace.
        block_s0 = s0[:rk._POLICY_ENVS].contiguous()
        one_block_ms = time_ms(lambda: kernel(block_s0, cfg, 8, T, **kw), 3)
        cases[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           us_per_step=ms * 1e3 / T, share_of_bound=b_ms / ms,
                           f32_ceiling_ms=ceiling_ms, share_of_ceiling=ceiling_ms / ms,
                           actor_library_ms=actor_library_ms(
                               pp, NU[system], kw['policy_activation'], T, dev, n_envs),
                           one_block_ms=one_block_ms, T=T, B=n_envs,
                           actor=f'{pp.nx}->{pp.h1}->{pp.h2}->{pp.nu_out}')
        min_done = float(k['done_count'].min())
        emit(phase, kernel=meta['name'], case=name, state_err=state_err,
             reward_err=rew_err, envs_with_other_counts=flips, ok=ok,
             mean_done_count=float(k['done_count'].mean()), min_done_count=min_done,
             mean_violation_count=float(k['violation_count'].mean()), **cases[name])
        if name.startswith('committed') and T >= T_COMMITTED and min_done < 1:
            raise RuntimeError(f'{meta["name"]} on {name}: an env drew no fresh state '
                               f'in {T} steps, so the check missed the reset draws')
        if not ok:
            raise RuntimeError(
                f'{meta["name"]} in policy mode disagrees with its plain version on {name}: '
                f'state err {state_err} (tol 1e-4), reward err {rew_err} (tol 1e-4 + '
                f'1e-4|r|), envs whose counts differ {flips} (must be none)')
        worst = max(worst, state_err, rew_err)
    sac = cases['sac_deterministic_relu_squash']
    return dict(name=meta['name'] + ' (policy mode)', route='cuda',
                source=meta['source'] + ' + ' + SRC + 'policy_mlp.cuh',
                replaces=meta['replaces'], max_abs_err=worst, ms=sac['ms'],
                kernel_ms=sac['ms'], plain_ms=sac['plain_ms'], bound_ms=sac['bound_ms'],
                bound_by=sac['bound_by'], library_ms=None,
                library_note='none: no single PyTorch call computes a closed-loop '
                             'T-step env rollout; actor_library_ms times the actor alone',
                actor_library_ms=sac['actor_library_ms'], f32_ceiling_ms=sac['f32_ceiling_ms'],
                one_block_ms=sac['one_block_ms'],
                shape=f'B={B} T={sac["T"]} deterministic SAC actor {sac["actor"]}',
                cases=cases, id=meta['id'])


def _policy_counts():
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    counts = {fn.__name__: fn.launches for fn in _counters()}
    counts.update({f'{m["name"]}.policy': getattr(rk, m['name']).policy_launches
                   for m in ROLLOUT.values()})
    return counts


def closed_loop(dev, smi):
    """The slice's main path: the committed PPO and SAC models through
    make -> load -> evaluate_fused at B=4096, then the closed-loop bench rows."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
    from safe_control_gym_tpu_torch.utils.registration import make
    for fn in _counters():
        fn.launches = 0
    for m in ROLLOUT.values():
        getattr(rk, m['name']).policy_launches = 0
    rows = {}
    for algo, model_system in MODELS:
        system = MODEL_SYSTEM[model_system]
        env_id, task_config, algo_config = eval_config(algo, model_system)
        before = _policy_counts()
        ctrl = make(algo, functools.partial(make, env_id, device=dev, **task_config),
                    **algo_config)
        ctrl.load(_model_path(algo, model_system))
        res = ctrl.evaluate_fused(batch=B, n_steps=T_CLOSED, seed=0)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in _policy_counts().items() if v != before[k]}
        widths = [tuple(layer['w'].shape) for layer in ctrl.agent.params['actor']]
        ctrl.close()
        # quadrotor_2D_stab's state box is not the default one: the kernel's
        # gate refuses it, and the per-step path (K2) runs it.
        kernel_row = model_system != 'quadrotor_2D'
        want = 'policy-in-kernel' if kernel_row else 'per-step-scan'
        row = dict(path=res['path'], algo=algo, system=model_system, actor=widths, batch=B,
                   T=T_CLOSED, ctrl_steps_per_s=res['steps_per_sec'],
                   episodes=res['episodes'], ep_return_mean=res['ep_return_mean'],
                   ep_length_mean=res['ep_length_mean'], launches_moved=moved, card=smi)
        rows[f'{algo} {model_system}'] = row
        emit('closed_loop', **row)
        if res['path'] != want:
            raise RuntimeError(f'{algo} {model_system} took path {res["path"]}, expected {want}')
        policy_key = f'{ROLLOUT[system]["name"]}.policy'
        if kernel_row and moved.get(policy_key, 0) < 1:
            raise RuntimeError(f'{algo} {model_system}: {policy_key} did not launch')
        if not kernel_row and (moved.get(PHYSICS[system]['name'], 0) < T_CLOSED
                               or moved.get(policy_key, 0)):
            raise RuntimeError(f'{algo} {model_system}: the per-step path did not run '
                               f'through {PHYSICS[system]["name"]} alone: {moved}')
        if not (res['episodes'] > 0 and np.isfinite(res['ep_return_mean'])
                and 0 < res['ep_length_mean'] <= T_CLOSED):
            raise RuntimeError(f'{algo} {model_system}: implausible statistics {res}')
    for system, hidden, activation, out_mult, T in CLOSED_BENCH:
        sps, ex = bs.measure_closed_loop_kernel(system, batch=B, n_steps=T,
                                                n_reps=3 if T > 4096 else 2, hidden=hidden,
                                                activation=activation,
                                                nu_out=out_mult * NU[system], device=dev)
        key = f'bench {system} hidden={hidden}'
        rows[key] = dict(path=f'policy-in-kernel ({ROLLOUT[system]["id"]})', system=system,
                         batch=B, T=T, ctrl_steps_per_s=sps, card=smi, **ex)
        emit('closed_loop', row=key, **rows[key])
    launches = _policy_counts()
    emit('closed_loop', launches=launches)
    for m in ROLLOUT.values():
        if launches[f'{m["name"]}.policy'] <= 0:
            raise RuntimeError(f'the closed-loop path never launched {m["name"]} in '
                               'policy mode')
    return launches, rows


def welch_closed_loop(dev):
    """Stochastic PPO, the committed cartpole and 3D quad models: per-env
    reward and done counts of the kernel path against the per-step path."""
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    for model_system in ('cartpole', 'quadrotor_3D'):
        env_id, task_config, algo_config = eval_config('ppo', model_system)
        ctrl = make('ppo', functools.partial(make, env_id, device=dev, **task_config),
                    **algo_config)
        ctrl.load(_model_path('ppo', model_system))
        kw = dict(batch=B, n_steps=T_WELCH_CLOSED, stochastic=True, n_reps=0,
                  return_per_env=True)
        rk = ctrl.evaluate_fused(seed=11, use_kernel=True, **kw)
        rs = ctrl.evaluate_fused(seed=23, use_kernel=False, **kw)
        ctrl.close()
        if rk['path'] != 'policy-in-kernel' or rs['path'] != 'per-step-scan':
            raise RuntimeError(f'welch_closed_loop took {rk["path"]} and {rs["path"]}')
        if not (rk['episodes'] > 0 and rs['episodes'] > 0):
            raise RuntimeError(f'welch_closed_loop: no episode ended ({model_system})')
        for key in ('reward_sum', 'done_count'):
            _welch(rk['per_env'][key] / T_WELCH_CLOSED, rs['per_env'][key] / T_WELCH_CLOSED,
                   f'closed loop stochastic PPO {model_system} {key}/step')


def _ppo(system, dev, out_dir, iterations=None):
    """The committed PPO config of ``system`` on the card, from seed 0, cut
    to ``iterations`` training iterations where given."""
    from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
    from safe_control_gym_tpu_torch.utils.registration import make
    env_id, task_config, algo_config = eval_config('ppo', system)
    if iterations is not None:
        algo_config = dict(algo_config, max_env_steps=iterations * int(
            algo_config['rollout_batch_size']) * int(algo_config['rollout_steps']))
    ctrl = make('ppo', functools.partial(make, env_id, device=dev, **task_config),
                training=True, output_dir=os.path.join(out_dir, system), seed=0,
                **algo_config)
    return ctrl, algo_config


def _train(ctrl):
    """reset + learn, timed on the host; returns the wall seconds."""
    t0 = time.perf_counter()
    ctrl.reset()
    ctrl.learn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _update_card_against_cpu(ctrl):
    """One update (opt_epochs x minibatches) on a batch of a fresh rollout of
    the card, run by the card's agent and by a copy on the CPU, on the same
    permutations; returns the largest parameter difference and both counts
    of accepted actor steps."""
    from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import PPOAgent
    from safe_control_gym_tpu_torch.math.optim import tree_leaves
    batch, _ = ctrl.rollout()
    m = batch['obs'].shape[0]
    _, _, used = ctrl.agent.minibatch_plan(m)
    cpu_gen = torch.Generator().manual_seed(0)
    perms = [torch.randperm(m, generator=cpu_gen)[:used] for _ in range(int(ctrl.opt_epochs))]
    cpu = PPOAgent(ctrl.env.observation_space, ctrl.env.action_space, device='cpu',
                   **{k: getattr(ctrl, k) for k in (
                       'hidden_dim', 'use_clipped_value', 'clip_param', 'target_kl',
                       'entropy_coef', 'actor_lr', 'critic_lr', 'opt_epochs',
                       'mini_batch_size', 'activation', 'max_grad_norm')})
    cpu.load_state_dict(ctrl.agent.state_dict())
    counts0 = int(ctrl.agent.actor_opt_state['count'])
    card_losses = ctrl.agent.update(batch, perms=perms)
    cpu_losses = cpu.update({k: v.cpu() for k, v in batch.items()}, perms=perms)
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(tree_leaves(ctrl.agent.params), tree_leaves(cpu.params)))
    return dict(max_abs_err=err, rows=m, rows_used=used,
                accepted_card=int(ctrl.agent.actor_opt_state['count']) - counts0,
                accepted_cpu=int(cpu.actor_opt_state['count']) - counts0,
                losses_card=card_losses, losses_cpu=cpu_losses)


def _profiled(fn):
    """Run ``fn`` under ``torch.profiler``: host seconds to the last
    synchronize, the device's busy seconds (its kernels' time) and the
    kernels launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return wall, sum(e.self_device_time_total for e in kernels) / 1e6, sum(
        e.count for e in kernels)


def _training_trace(ctrl):
    """One rollout and one epoch of minibatch steps of ``ctrl`` under the
    profiler (after a rollout to take the batch from): host and device-busy
    seconds of each, and kernels a rollout step and a minibatch."""
    batch, _ = ctrl.rollout()
    torch.cuda.synchronize()
    _, num_mb, _ = ctrl.agent.minibatch_plan(batch['obs'].shape[0])
    epochs, ctrl.agent.opt_epochs = ctrl.agent.opt_epochs, 1
    r_wall, r_busy, r_kernels = _profiled(ctrl.rollout)
    u_wall, u_busy, u_kernels = _profiled(lambda: ctrl.agent.update_tensors(batch, ctrl.gen))
    ctrl.agent.opt_epochs = epochs
    return dict(window=f'one rollout (T={ctrl.T}) and one epoch ({num_mb} minibatches), '
                       'each under torch.profiler',
                rollout_s=r_wall, rollout_device_busy_s=r_busy, rollout_kernels=r_kernels,
                kernels_per_step=r_kernels / ctrl.T, epoch_s=u_wall,
                epoch_device_busy_s=u_busy, epoch_kernels=u_kernels,
                kernels_per_minibatch=u_kernels / num_mb,
                device_busy_share=(r_busy + u_busy) / (r_wall + u_wall))


def ppo_train(dev, smi):
    """The slice's main path: PPO training on the card through the entry
    points, K1-K3 stepping every rollout step; see the module docstring."""
    from safe_control_gym_tpu_torch.ops import physics_kernels as pk
    losses = ('policy_loss', 'value_loss', 'entropy_loss', 'approx_kl')
    rows = {}
    with tempfile.TemporaryDirectory() as out_dir:
        ctrl, algo = _ppo('cartpole', dev, out_dir)
        for fn in _counters():
            fn.launches = 0
        wall = _train(ctrl)
        learn_launches = pk.cartpole_advance.launches
        t0 = time.perf_counter()
        res = ctrl.run(n_episodes=10)
        eval_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in _counters()}
        steps_per_iter = ctrl.N * ctrl.T
        iterations = ctrl.total_steps // steps_per_iter
        eval_steps = ctrl.eval_env.func.max_steps + 1
        want = iterations * ctrl.T + eval_steps
        eval_return = float(res['ep_returns'].mean())
        last = ctrl.last_results
        row = dict(system='cartpole', envs=ctrl.N, T=ctrl.T, hidden=int(ctrl.hidden_dim),
                   iterations=iterations, total_steps=ctrl.total_steps,
                   max_env_steps=int(algo['max_env_steps']), wall_s=wall,
                   rollout_s=ctrl.train_seconds['rollout'],
                   update_s=ctrl.train_seconds['update'],
                   seconds_per_iteration=wall / iterations,
                   env_steps_per_s=ctrl.total_steps / wall, eval_s=eval_s,
                   last_iteration={k: last[k] for k in losses + ('mean_reward',)},
                   eval_return=eval_return, eval_returns=res['ep_returns'].tolist(),
                   eval_lengths=res['ep_lengths'].tolist(), eval_bar=PPO_EVAL_BAR,
                   k1_launches=launches['cartpole_advance'],
                   k1_launches_learn=learn_launches, k1_launches_expected=want,
                   launches=launches, card=smi)
        rows['cartpole'] = row
        emit('ppo_train', **row)
        if not all(np.isfinite(last[k]) for k in losses):
            raise RuntimeError(f'ppo_train cartpole: a loss is not finite: {last}')
        if ctrl.total_steps < int(algo['max_env_steps']):
            raise RuntimeError(f'ppo_train cartpole stopped at {ctrl.total_steps} steps')
        if launches['cartpole_advance'] != want or learn_launches != iterations * ctrl.T:
            raise RuntimeError(f'ppo_train cartpole: K1 launched {launches}, expected {want}')
        if not eval_return >= PPO_EVAL_BAR:
            raise RuntimeError(f'ppo_train cartpole: eval return {eval_return} under the '
                               f'bar {PPO_EVAL_BAR}')
        upd = _update_card_against_cpu(ctrl)
        emit('ppo_train', part='update card against CPU', atol=PPO_UPDATE_ATOL, **upd)
        rows['update'] = upd
        if not upd['max_abs_err'] <= PPO_UPDATE_ATOL:
            raise RuntimeError(f'ppo_train: the card\'s update differs from the CPU\'s: {upd}')
        rows['trace'] = _training_trace(ctrl)
        emit('ppo_train', part='trace', card=smi, **rows['trace'])
        ctrl.close()
        for system, kernel in (('quadrotor_2D', 'quad2d_advance'),
                               ('quadrotor_3D', 'quad3d_advance')):
            ctrl, _ = _ppo(system, dev, out_dir, iterations=PPO_QUAD_ITERATIONS)
            for fn in _counters():
                fn.launches = 0
            wall = _train(ctrl)
            launches = {fn.__name__: fn.launches for fn in _counters()}
            iterations = ctrl.total_steps // (ctrl.N * ctrl.T)
            last = ctrl.last_results
            row = dict(system=system, envs=ctrl.N, T=ctrl.T, hidden=int(ctrl.hidden_dim),
                       iterations=iterations, total_steps=ctrl.total_steps, wall_s=wall,
                       rollout_s=ctrl.train_seconds['rollout'],
                       update_s=ctrl.train_seconds['update'],
                       seconds_per_iteration=wall / iterations,
                       env_steps_per_s=ctrl.total_steps / wall,
                       last_iteration={k: last[k] for k in losses + ('mean_reward',)},
                       launches=launches, card=smi)
            rows[system] = row
            emit('ppo_train', **row)
            ctrl.close()
            if not all(np.isfinite(last[k]) for k in losses):
                raise RuntimeError(f'ppo_train {system}: a loss is not finite: {last}')
            if iterations != PPO_QUAD_ITERATIONS or launches[kernel] != iterations * ctrl.T \
                    or sum(launches.values()) != launches[kernel]:
                raise RuntimeError(f'ppo_train {system}: launches {launches}, expected '
                                   f'{iterations * ctrl.T} of {kernel} alone')
    return rows


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the GPU', file=sys.stderr)
        sys.exit(2)
    from safe_control_gym_tpu_torch.ops import _build
    from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
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
    physics = {s: check_physics(s, dev) for s in SYSTEMS}
    rollout = {s: check_rollout(s, dev) for s in SYSTEMS}
    serial = chain(dev)
    launches, rows = main_path(dev, smi)
    welch(dev)
    policy = {s: check_policy(s, dev) for s in SYSTEMS}
    cl_launches, cl_rows = closed_loop(dev, smi)
    welch_closed_loop(dev)
    train = ppo_train(dev, smi)
    train_rows = {'cartpole': train['cartpole'], 'quadrotor': train['quadrotor_2D'],
                  'quadrotor_3D': train['quadrotor_3D']}
    for system in SYSTEMS:
        row = policy[system]
        row['launches'] = cl_launches[f'{ROLLOUT[system]["name"]}.policy']
        bench = cl_rows[f'bench {system} hidden=64']
        row['main_path_ms'] = bench['kernel_ms']
        row['main_path_shape'] = f'B={B} T={bench["T"]} stochastic, actor hidden 64'
        kw = dict(draw_actions=False, randomized_reset=False, policy_stochastic=True,
                  policy_params=rk.PolicyParams(None, NX[system], 64, 64, NU[system]))
        row['main_path_bound_ms'] = bound_ms(
            policy_rollout_bytes(system, kw, bench['T']),
            policy_rollout_ops(system, kw, bench['T'], bench['mean_done_count'] * B))[0]
    cycles_ms = lambda cycles: cycles / (serial['clock_ghz'] * 1e6)
    for system in SYSTEMS:
        # The per-step kernel's chain bound: n_substeps x one substep's
        # loop-carried chain at the latencies and SM clock of this run. Its
        # issue floor: n_substeps x one substep's fast-path instructions (the
        # instantiation for N_SUB) at one a cycle, what one warp an SM
        # (B=4096) issues at best.
        row = physics[system]
        row['launches'] = launches[PHYSICS[system]['name']]
        tr = train_rows[system]
        row['train_launches'] = tr['launches'][PHYSICS[system]['name']]
        row['train_shape'] = (f'B={tr["envs"]} T={tr["T"]} x {tr["iterations"]} PPO '
                              'iterations' + (' + 10-episode eval' if system == 'cartpole'
                                              else ''))
        row['chain_cycles_per_substep'] = serial['cycles'][system]
        row['sm_clock_ghz'] = serial['clock_ghz']
        row['chain_bound_ms'] = cycles_ms(serial['cycles'][system] * N_SUB)
        row['share_of_chain_bound'] = row['chain_bound_ms'] / row['ms']
        row['fast_path_per_substep'] = serial['fast_path'][system]['advance']
        row['issue_floor_ms'] = cycles_ms(row['fast_path_per_substep'] * N_SUB)
        row['share_of_issue_floor'] = row['issue_floor_ms'] / row['ms']
        row['floor_binds'] = 'issue' if row['issue_floor_ms'] > row['chain_bound_ms'] else 'chain'
        row = rollout[system]
        row['launches'] = launches[ROLLOUT[system]['name']]
        main_row = rows[f'rollout {system} constrained=True tracking=False']
        row['main_path_ms'] = main_row['kernel_ms']
        kw = {'constrained': True, 'randomized_reset': system == 'cartpole'}
        row['main_path_bound_ms'] = bound_ms(
            rollout_bytes(system, kw, T_ROLLOUT),
            rollout_ops(system, kw, T_ROLLOUT,
                        main_row['mean_done_count'] * B))[0]
        row['main_path_shape'] = f'B={B} T={T_ROLLOUT} constrained'
        # The chain bound: T x n_substeps x one substep's loop-carried chain
        # (the per-step kernel's loop) at the latencies and the SM clock
        # measured in this run.
        cycles = serial['cycles'][system]
        row['chain_cycles_per_substep'] = cycles
        row['chain_cycles_table_estimate'] = serial['table_cycles'][system]
        row['chain_latencies'] = serial['latency']
        row['chain_bound_by'] = 'latencies measured in this run (csrc/latency_probe.cu)'
        row['sm_clock_ghz'] = serial['clock_ghz']
        row['chain_bound_ms'] = cycles_ms(cycles * T_ROLLOUT * N_SUB)
        row['share_of_chain_bound'] = row['chain_bound_ms'] / row['main_path_ms']
        row['fast_path_per_substep'] = serial['fast_path'][system]['rollout']
        row['issue_floor_ms'] = cycles_ms(row['fast_path_per_substep'] * T_ROLLOUT * N_SUB)
        row['share_of_issue_floor'] = row['issue_floor_ms'] / row['main_path_ms']
        row['floor_binds'] = 'issue' if row['issue_floor_ms'] > row['chain_bound_ms'] else 'chain'
        row['lanes_per_env'] = 1
        times = serial['times']
        for case in ('random', 'hover', 'hover_tilted'):
            if (system, case) in times:
                row[f'{case}_ns_per_substep'] = times[system, case]['ns_per_substep']
        big = times[system, 'random_big_batch']
        row['big_batch_ms'] = big['ms']
        row['big_batch_shape'] = f'B={big["B"]} T={big["T"]} constrained (reported, not gated)'
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    ordered = [physics['cartpole'], physics['quadrotor'], physics['quadrotor_3D'],
               rollout['cartpole'], rollout['quadrotor'], rollout['quadrotor_3D'],
               policy['cartpole'], policy['quadrotor'], policy['quadrotor_3D']]
    kernels = [{**{k: row[k] for k in keys}, **{k: v for k, v in row.items() if k not in keys}}
               for row in ordered]
    emit('done', wall_seconds=time.perf_counter() - t_start, card=smi)
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    main()
