"""The short first call for new kernels on the card, before ``chip_smoke.py``.

    python -m safe_control_gym_tpu_torch.experiments.kernel_first_check

Builds every library as the port does and prints ``ptxas``'s registers,
stack and spills of each kernel of ``csrc/cartpole_kernels.cu`` and
``csrc/quad_kernels.cu``; holds K1-K3 to their plain versions on every
per-step case of ``chip_smoke.py`` (``benchmark_suite.physics_cases``);
holds ``csrc/exact_math.cuh`` to the CUDA math library
(``rollout_kernels.exact_math_check``); and runs ``chip_smoke.py``'s
open-loop phases (``check_rollout``: every K4 and K5 case, bit for bit) at
T=60 and its policy-mode phases (``check_policy``: K4 and K5 with the
committed actors) at T=40 against their plain versions. Run it from the
root of a checkout. It raises where the card, the build or a check fails.

``--floor`` times, per system at B=4096, T=2048, the policy kernel with an
8-wide zero actor (stochastic, so the exploration draws run) beside the
open-loop kernel replaying actions: the first is the policy kernel's step
without the actor's products, the second the open loop's serial chain.

``--physics [--root OTHER_CHECKOUT]`` holds K1-K3 to their plain versions on
every per-step case and times them at B=4096 and B=65536 (primed: device
time; unprimed: back to back), beside the launch floor (an empty kernel on
the same grid, ``chain.launch_floor``). ``--root`` runs another checkout's
``csrc/cartpole_kernels.cu`` and ``csrc/quad_kernels.cu`` (built here with
this checkout's flags, called through this checkout's wrappers, so their C
entries must match) on the same cases in the same call, timed other, this,
this, other: the parent's errors and times beside this tree's.

``--chain`` measures the open loop's serial chain, per system, and skips the
checks above:

    python -m safe_control_gym_tpu_torch.experiments.kernel_first_check --chain \
        [--root OTHER_CHECKOUT]

* times (``chain.chain_times``): ns a substep of the open-loop kernels on
  random and hover rows, one block and B=65536. ``--root`` times another
  checkout's kernels with its own copy of this script (one with
  ``--chain-times``) in a subprocess, before and after this one's (other,
  this, this, other): the same card, the same call; and reads the SASS of
  its substep loops beside this tree's (its sources built here). To
  compare another substep chunk, edit ``kSubstepChunk``
  (``csrc/rollout_modes.cuh``) and ``SUBSTEP_CHUNK`` in a copy and pass it
  as ``--root``;
* the batch (``batch_sweep``): the random rows at B = 4096 to 65536, ns a
  substep, to show where the card fills;
* latencies (``chain.latency_probe``): FADD, FMUL, FFMA, MUFU.RCP, F2I and
  I2F on this card;
* the SASS (``chain.chain_sass``): the substep loop of every open-loop
  rollout kernel and per-step kernel, its instructions, slow-path branches
  and chain cycles;
* the chain bound (``chain_bound_ms``): T x n_substeps x the loop-carried
  chain of one substep of the per-step kernels' runtime-count loop
  (``chain.reference_chain_cycles``) at the measured latencies and SM clock;
  beside it the issue floor, the same with the fast-path instructions of one
  substep of the loops compiled for 20 (``chain.compiled_in_fast_path``) at
  one a cycle.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
from safe_control_gym_tpu_torch.experiments import chain
from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel_cfg, _make
from safe_control_gym_tpu_torch.experiments.chain import (CHAIN_SYSTEMS, CHAIN_T,
                                                          chain_bound_ms,
                                                          reference_chain_cycles)
from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops import physics_kernels as pk
from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
from safe_control_gym_tpu_torch.utils.device import require_cuda

MODULE = 'safe_control_gym_tpu_torch.experiments.kernel_first_check'
B = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The batches of the batch sweep.
SWEEP_B = (4096, 8192, 16384, 32768, 65536)
# The per-step kernels' wrappers.
PHYSICS = {'cartpole': 'cartpole_advance', 'quadrotor': 'quad2d_advance',
           'quadrotor_3D': 'quad3d_advance'}


def batch_sweep(dev, T=CHAIN_T):
    """[{system, B, T, ms, ns_per_substep}]: the main path's random
    constrained rows at each batch of SWEEP_B."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    rows = []
    for system in CHAIN_SYSTEMS:
        kernel = bs._kernel(system)[1]
        env = _make(system, True, device=dev)
        cfg = _kernel_cfg(system, env, True)
        n_sub = env.PYB_STEPS_PER_CTRL
        kw = dict(n_substeps=n_sub, dt=env.PYB_TIMESTEP, constrained=True,
                  randomized_reset=bool(env.RANDOMIZED_INIT))
        gen = torch.Generator(device=dev).manual_seed(0)
        for n in SWEEP_B:
            s0 = env.func.reset_batch(gen, n)[0].state.contiguous()
            ms = chain.best_time_ms(lambda: kernel(s0, cfg, 5, T, **kw))
            rows.append(dict(system=system, B=n, T=T, ms=ms,
                             ns_per_substep=ms * 1e6 / (T * n_sub)))
            print(json.dumps({'batch_sweep': system, **rows[-1]}), flush=True)
        env.close()
    return rows


def chain_report(dev, root=None):
    """Step 0 of a redesign of the open loop: times, batch sweep, latencies,
    SASS and chain bound, one JSON line each; with ``root``, the other
    checkout's times and SASS too."""
    others = []
    if root:
        others.append(_times_of(root))
    clock = chain.sm_clock_ghz()
    times = chain.chain_times(dev)
    times_again = chain.chain_times(dev)
    if root:
        others.append(_times_of(root))
    sweep = batch_sweep(dev)
    print(json.dumps({'exact_math': rk.exact_math_check(dev)}), flush=True)
    probes, rows, table = chain.measured_chain(dev)
    for row in probes:
        print(json.dumps({'latency': row['probe'], **row}), flush=True)
    for system, kernels in rows.items():
        for fname, entry in kernels.items():
            print(json.dumps({'sass': system, 'kernel': fname, **entry}), flush=True)
    if root:
        with tempfile.TemporaryDirectory() as tmp:
            other_rows = chain.chain_sass(other_libraries(root, tmp), table)
        this_rows = {system: {_kernel_key(f): e for f, e in kernels.items()}
                     for system, kernels in rows.items()}
        for system, kernels in other_rows.items():
            for fname, entry in kernels.items():
                print(json.dumps({'sass_other': system, 'kernel': fname, **entry}), flush=True)
                key = _kernel_key(fname)
                this = this_rows[system].get(key, {}).get('substep_loop')
                that = entry.get('substep_loop')
                if this and that:
                    print(f'summary sass {system:>12} {key[:40]:>40} fast path a substep '
                          f'{that["fast_path_per_substep"]:7.2f} -> '
                          f'{this["fast_path_per_substep"]:7.2f}, chain cycles '
                          f'{that["chain_cycles_per_substep"]:7.2f} -> '
                          f'{this["chain_cycles_per_substep"]:7.2f}')
        other_cycles = reference_chain_cycles(other_rows)
    timed = []
    for label, runs in (('this', (times, times_again)), (root, others)):
        for rep, rows_t in enumerate(runs):
            for row in rows_t:
                timed.append({'chain_time': label, 'rep': rep, **row})
                print(json.dumps(timed[-1]), flush=True)
    n_sub = rk.SPECIALISED_SUBSTEPS
    table = reference_chain_cycles(rows, 'chain_cycles_table')
    issued = chain.compiled_in_fast_path(rows)
    for system, cycles in reference_chain_cycles(rows).items():
        print(json.dumps({'chain_bound': system, 'cycles_per_substep': cycles,
                          'cycles_per_substep_table': table[system], 'sm_clock_ghz': clock,
                          'ms_T131072': chain_bound_ms(cycles, 131072, n_sub, clock),
                          'ms_T4096': chain_bound_ms(cycles, CHAIN_T, n_sub, clock),
                          'fast_path_per_substep': issued[system],
                          'issue_floor_ms_per_step': {
                              kind: chain_bound_ms(n, 1, n_sub, clock)
                              for kind, n in issued[system].items()}}),
              flush=True)
        other = f' (other {other_cycles[system]:.2f})' if root else ''
        print(f'summary chain {system:>12} {cycles:7.2f} cycles a substep{other}; issued a '
              'substep ' + ', '.join(f'{k} {n:.2f}' for k, n in issued[system].items()))
    for row in probes:
        print(f'summary latency {row["probe"]:>8} {row["opcode"]:>16} {row["cycles"]:7.2f} '
              f'cycles (table {row["table_cycles"]})')
    for r in sweep:
        print(f'summary batch {r["system"]:>12} B={r["B"]:<6} {r["ns_per_substep"]:9.2f} '
              'ns/substep')
    return timed


def _kernel_key(fname):
    """A mangled kernel name from its kernel's name on: the anonymous
    namespace before it names the source file's build, which differs between
    checkouts."""
    bases = [b for names in chain.CHAIN_KERNELS.values() for b in names[1:]]
    starts = [fname.find(b.split('I')[0]) for b in bases if b.split('I')[0] in fname]
    return fname[min(starts):] if starts else fname


def other_libraries(root, out_dir):
    """{name: path} of another checkout's ``csrc/cartpole_kernels.cu`` and
    ``csrc/quad_kernels.cu`` built into ``out_dir`` with this checkout's
    flags, one ``nvcc`` each, both at once."""
    csrc = os.path.join(os.path.abspath(root), 'safe_control_gym_tpu_torch', 'csrc')
    names = sorted({lib for lib, _, _ in chain.CHAIN_KERNELS.values()})
    procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, '-o',
                                  os.path.join(out_dir, f'lib{n}.so'),
                                  os.path.join(csrc, f'{n}.cu')],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in names}
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {root}: {n}.cu\n{log}')
    return {n: os.path.join(out_dir, f'lib{n}.so') for n in names}


@contextlib.contextmanager
def wrappers_on(libs):
    """Within the block the kernel wrappers launch the libraries ``libs``
    ({name: path}) in place of this checkout's."""
    saved = dict(_build._loaded)
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.scg_error_string.argtypes = [ctypes.c_int]
        lib.scg_error_string.restype = ctypes.c_char_p
        _build._loaded[name] = lib
    try:
        yield
    finally:
        _build._loaded.clear()
        _build._loaded.update(saved)


def physics_errors(dev, label):
    """K1-K3 against their plain versions on every per-step case: one JSON
    line each, the worst error a system returned."""
    worst = {}
    for system, name in PHYSICS.items():
        kernel, plain = getattr(pk, name), getattr(pk, name + '_plain')
        for case, args in bs.physics_cases(system, dev):
            err = float((kernel(*args) - plain(*args)).abs().max())
            print(json.dumps({'physics_err': label, 'kernel': name, 'case': case,
                              'B': args[0].shape[0], 'n_substeps': args[-2],
                              'max_abs_err': err}), flush=True)
            worst[system] = max(worst.get(system, 0.0), err)
    return worst


def physics_times(dev, label):
    """{(system, shape): ms} of K1-K3 on the random inputs at B=4096 (primed
    and back to back) and B=65536 (primed), and of the launch floor."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    out = {}
    for system, name in PHYSICS.items():
        kernel = getattr(pk, name)
        for batch in (B, chain.CHAIN_BIG_B):
            args = (*bs.physics_args(system, dev, batch), rk.SPECIALISED_SUBSTEPS, 1e-3)
            out[system, f'B={batch}'] = chip_smoke.time_ms(lambda: kernel(*args), 200)
        args = (*bs.physics_args(system, dev, B), rk.SPECIALISED_SUBSTEPS, 1e-3)
        out[system, 'back_to_back'] = chip_smoke.time_ms(lambda: kernel(*args), 200,
                                                         primed=False)
    for batch in (B, chain.CHAIN_BIG_B):
        out['launch_floor', f'B={batch}'] = chip_smoke.time_ms(chain.launch_floor(batch, dev),
                                                               200)
    for (system, shape), ms in out.items():
        print(json.dumps({'physics_time': label, 'system': system, 'shape': shape, 'ms': ms}),
              flush=True)
    return out


def physics_report(dev, root=None):
    """``--physics``: errors and times of this checkout's K1-K3 and, with
    ``root``, of another's, in the order other, this, this, other."""
    _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        other = other_libraries(root, tmp) if root else {}
        runs, checked = [], set()
        for label in (('other', 'this', 'this', 'other') if root else ('this', 'this')):
            with wrappers_on(other if label == 'other' else {}):
                if label not in checked:
                    errs = physics_errors(dev, label)
                    print(json.dumps({'physics_worst_err': label, **errs}), flush=True)
                    checked.add(label)
                runs.append((label, physics_times(dev, label)))
    best = {}
    for label, times in runs:
        for key, ms in times.items():
            best[label, *key] = min(best.get((label, *key), float('inf')), ms)
    for (label, system, shape), ms in sorted(best.items()):
        print(f'summary physics {label:>5} {system:>12} {shape:>12} {ms * 1e3:9.3f} us')


def _times_of(root):
    """``chain_times`` of the checkout at ``root`` (one that has
    ``--chain-times``), run by that checkout's own copy of this script."""
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, '-m', MODULE, '--chain-times'],
                          cwd=root, env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'chain times of {root} failed:\n{proc.stderr[-4000:]}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def print_summary(rows):
    """One line per (checkout, system, case) of the main cases: the fewest
    ns a substep over the repeats."""
    best = {}
    for r in rows:
        if r['case'] in ('random', 'hover', 'hover_tilted', 'random_big_batch'):
            key = (r['chain_time'], r['system'], r['case'])
            best[key] = min(best.get(key, float('inf')), r['ns_per_substep'])
    for (label, system, case), ns in best.items():
        print(f'summary {label[-14:]:>14} {system:>12} {case:>16} {ns:9.2f} ns/substep')


def ptxas_report(name: str = 'quad_kernels') -> str:
    """``ptxas -v``'s report from the last build of ``csrc/<name>.cu``:
    registers, stack, spills of every kernel."""
    with open(_build.ptxas_log(name)) as f:
        return f.read()


def policy_smem_report():
    """Dynamic shared memory and W2 tile of each committed and bench actor."""
    for nx, nu, hidden, nu_out in ((4, 1, 64, 1), (6, 2, 64, 2), (12, 4, 64, 4),
                                   (6, 2, 128, 2), (12, 4, 128, 4), (4, 1, 256, 2),
                                   (6, 2, 256, 4), (12, 4, 256, 8)):
        rows, cols = rk._policy_w2_tile(nx, nu, hidden, hidden)
        print(f'actor {nx}->{hidden}->{hidden}->{nu_out}: W2 tile {rows} x {cols}, dynamic '
              'smem', rk._policy_smem_bytes(nx, nu, hidden, hidden, rows, cols), 'bytes')


def policy_floor(dev, T=2048):
    """The policy kernel's time a step with an 8-wide actor against the open
    loop's, per system (see the module docstring)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel
    for system in chip_smoke.SYSTEMS:
        env = _make(system, False, device=dev)
        cfg = _kernel_cfg(system, env, False)
        nx, nu = chip_smoke.NX[system], chip_smoke.NU[system]
        s0 = env.func.reset_batch(torch.Generator(device=dev).manual_seed(0), B)[0].state
        s0 = s0.contiguous()
        kernel = _kernel(system)[1]
        zero = [{'w': torch.zeros(shape), 'b': torch.zeros(shape[1])}
                for shape in ((nx, 8), (8, 8), (8, nu))]
        common = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                      randomized_reset=env.RANDOMIZED_INIT)
        policy = dict(draw_actions=False, policy_stochastic=True,
                      policy_params=rk.pack_policy_params(zero, nx, device=dev), **common)
        actions = torch.zeros((T, B) if nu == 1 else (T, B, nu), device=dev)
        replay = dict(draw_actions=False, actions=actions, **common)
        ms_policy = chip_smoke.time_ms(lambda: kernel(s0, cfg, 3, T, **policy), 3)
        ms_open = chip_smoke.time_ms(lambda: kernel(s0, cfg, 3, T, **replay), 3)
        print('floor', system, 'policy kernel, 8-wide actor:', ms_policy * 1e3 / T,
              'us a step; open loop, replay:', ms_open * 1e3 / T, 'us a step')


def open_loop_checks(dev, T=60):
    """``chip_smoke.py``'s k4 and k5 phases (every open-loop case, bit for
    bit against the plain version) at a short ``T``."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    for system in chip_smoke.SYSTEMS:
        chip_smoke.check_rollout(system, dev, length=T)


def policy_checks(dev, T=40):
    """``chip_smoke.py``'s k4_policy and k5_policy phases at a short ``T``."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    for system in chip_smoke.SYSTEMS:
        chip_smoke.check_policy(system, dev, length=T)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--floor', action='store_true',
                        help='also time the policy kernel without the actor\'s products')
    parser.add_argument('--chain', action='store_true',
                        help='only measure the open loop\'s serial chain (see above)')
    parser.add_argument('--physics', action='store_true',
                        help='only check and time the per-step kernels (see above)')
    parser.add_argument('--root', default=None,
                        help='with --chain or --physics: also run the kernels of this '
                             'checkout')
    parser.add_argument('--chain-times', action='store_true', help=argparse.SUPPRESS)
    args = parser.parse_args()
    dev = require_cuda('cuda')
    smi = ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader']
    if args.chain_times:
        print(json.dumps(chain.chain_times(dev)))
        return
    if args.chain or args.physics:
        if args.chain:
            print_summary(chain_report(dev, args.root))
        else:
            physics_report(dev, args.root)
        print(subprocess.run(smi, capture_output=True, text=True).stdout)
        return
    t0 = time.perf_counter()
    _build.build_all()
    print('build', time.perf_counter() - t0, 's')
    print(ptxas_report('cartpole_kernels'))
    print(ptxas_report())
    policy_smem_report()
    physics_errors(dev, 'this')
    print('exact_math', rk.exact_math_check(dev))
    open_loop_checks(dev)
    policy_checks(dev)
    if args.floor:
        policy_floor(dev)
    print(subprocess.run(smi, capture_output=True, text=True).stdout)


if __name__ == '__main__':
    main()
