"""The short first call for new kernels on the card, before ``chip_smoke.py``.

    python -m safe_control_gym_tpu_torch.experiments.kernel_first_check

Builds ``csrc/cartpole_kernels.cu`` and ``csrc/quad_kernels.cu`` once with
``-Xptxas -v`` and prints each kernel's registers, stack and spills; builds
every library as the port does; runs K2 and K3 once at B=4096 against their
plain versions; holds ``csrc/exact_math.cuh`` to the CUDA math library
(``rollout_kernels.exact_math_check``); and runs ``chip_smoke.py``'s open-loop
phases (``check_rollout``: every K4 and K5 case, bit for bit) at T=60 and its
policy-mode phases (``check_policy``: K4 and K5 with the committed actors) at
T=40 against their plain versions. Run it from the root of a checkout. It
raises where the card, the build or a check fails.

``--floor`` times, per system at B=4096, T=2048, the policy kernel with an
8-wide zero actor (stochastic, so the exploration draws run) beside the
open-loop kernel replaying actions: the first is the policy kernel's step
without the actor's products, the second the open loop's serial chain.

``--chain`` measures the open loop's serial chain, per system, and skips the
checks above:

    python -m safe_control_gym_tpu_torch.experiments.kernel_first_check --chain \
        [--root OTHER_CHECKOUT]

* times (``chain_times``): ns a substep at B=4096, T=4096 on the main path's
  constrained rows (random actions, noise and Philox draws) and on a hover
  replay (the nominal state, every motor at the hover command, no goal, so
  the angles stay exactly 0; the quads also tilted by 0.01 rad, where they
  stay at 0.01), each for the full batch and for one block of 32 envs; and
  the random rows at B=65536, T=4096. ``--root`` times another checkout's
  kernels with its own copy of this script (PR 5 or later) in a subprocess,
  before and after this one's (other, this, this, other): the same card, the
  same call. To compare another substep chunk, edit ``kSubstepChunk``
  (``csrc/rollout_modes.cuh``) and ``SUBSTEP_CHUNK`` in a copy and pass it
  as ``--root``;
* the batch (``batch_sweep``): the random rows at B = 4096 to 65536, ns a
  substep, to show where the card fills;
* latencies (``latency_probe``, ``csrc/latency_probe.cu``): cycles from
  issue to a dependent issue of FADD, FMUL, FFMA, MUFU.RCP, F2I and I2F on
  this card, each probe's chain checked in its SASS;
* the SASS (``chain_sass``, ``experiments/sass.py``): for every open-loop
  rollout kernel and per-step physics kernel, the loop that holds the
  substeps, its instructions (all and on the fast path), its branches to the
  slow paths of divide, reciprocal, ``sinf``/``cosf`` and ``sqrtf``, and its
  dependent chain in cycles, counted with the latencies measured here
  (``chain_cycles_per_substep``) and with sass.py's table of estimates
  (``chain_cycles_table``);
* the chain bound (``chain_bound_ms``): T x n_substeps x the loop-carried
  chain of one substep of the per-step kernel (K1, K2, K3: one thread, one
  substep an iteration) at the measured latencies and the SM clock measured
  here: the time the per-step kernel's loop-carried chain takes for one
  env's rollout, a floor for a kernel that runs those instructions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from safe_control_gym_tpu_torch.experiments.benchmark_suite import (_kernel_cfg, _make,
                                                                    hover_actions, hover_case)
from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops import physics_kernels as pk
from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
from safe_control_gym_tpu_torch.utils.device import require_cuda

MODULE = 'safe_control_gym_tpu_torch.experiments.kernel_first_check'
B = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHAIN_SYSTEMS = ('cartpole', 'quadrotor', 'quadrotor_3D')
CHAIN_T = 4096
CHAIN_BIG_B = 65536
CHAIN_BLOCK_ENVS = 32
# The batches of the batch sweep.
SWEEP_B = (4096, 8192, 16384, 32768, 65536)
# csrc/latency_probe.cu's probes, in the order of its enum Probe: the opcode
# each chain link issues (checked in the SASS), and for a link of two
# instructions the probe whose reading is taken off.
LATENCY_PROBES = ('FADD', 'FMUL', 'FFMA', 'MUFU.RCP', 'F2I', 'I2F')
PROBE_LESS = {'MUFU.RCP': 'FMUL'}
# The library and kernels of each system: the open-loop rollout kernel (all
# its instantiations) and the per-step kernel, whose loop is one substep.
CHAIN_KERNELS = {
    'cartpole': ('cartpole_kernels', 'cartpole_rollout_kernel', 'cartpole_advance_kernel'),
    'quadrotor': ('quad_kernels', 'quad_rollout_kernelILi2E', 'quad2d_advance_kernel'),
    'quadrotor_3D': ('quad_kernels', 'quad_rollout_kernelILi3E', 'quad3d_advance_kernel'),
}


def _time_ms(fn, reps=3):
    """Best device time of ``reps`` calls after a warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def sm_clock_ghz():
    """The SM clock while busy: ``torch.cuda._sleep`` spins a given number
    of cycles; cycles over its event time."""
    cycles = 200_000_000
    return cycles / (_time_ms(lambda: torch.cuda._sleep(cycles), 2) * 1e6)


def chain_times(dev, B=B, T=CHAIN_T, big_B=CHAIN_BIG_B):
    """[{system, case, B, T, ms, ns_per_substep}] of the open-loop kernels
    (see the module docstring). Uses only the wrappers' public arguments, so
    it times another checkout's kernels as well."""
    from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
    rows = []
    for system in CHAIN_SYSTEMS:
        kernel = bs._kernel(system)[1]
        env = _make(system, True, device=dev)
        cfg = _kernel_cfg(system, env, True)
        n_sub = env.PYB_STEPS_PER_CTRL
        random = dict(n_substeps=n_sub, dt=env.PYB_TIMESTEP, constrained=True,
                      randomized_reset=bool(env.RANDOMIZED_INIT))
        gen = torch.Generator(device=dev).manual_seed(0)
        cases = []
        s0 = env.func.reset_batch(gen, B)[0].state.contiguous()
        cases.append(('random', s0, cfg, random))
        cases.append(('random_one_block', s0[:CHAIN_BLOCK_ENVS].contiguous(), cfg, random))
        for name, tilt in (('hover', 0.0), ('hover_tilted', 0.01)):
            if system == 'cartpole' and tilt:
                continue
            hover, raw, cfg_h, kw = hover_case(system, dev, tilt)
            for suffix, n in (('', B), ('_one_block', CHAIN_BLOCK_ENVS)):
                cases.append((name + suffix, hover.expand(n, -1).contiguous(), cfg_h,
                              dict(kw, actions=hover_actions(system, raw, T, n))))
        big = env.func.reset_batch(gen, big_B)[0].state.contiguous()
        cases.append(('random_big_batch', big, cfg, random))
        for name, state0, c, kw in cases:
            ms = _time_ms(lambda: kernel(state0, c, 5, T, **kw))
            rows.append(dict(system=system, case=name, B=state0.shape[0], T=T,
                             n_substeps=n_sub, ms=ms, ns_per_substep=ms * 1e6 / (T * n_sub)))
        del cases, big
        torch.cuda.empty_cache()
    return rows


def _substeps_per_iteration(kernel_name: str) -> int:
    """Substeps one iteration of a rollout kernel's substep loop runs: a
    chunk (SUBSTEP_CHUNK) where the kernel is specialised to the compile-time
    count (a template argument of 20 in the mangled name), else 1 (a loop
    over a runtime count)."""
    m = re.search(r'rollout_kernelI((?:Li\d+E)+)', kernel_name)
    args = [int(a) for a in re.findall(r'Li(\d+)E', m.group(1))] if m else []
    n = rk.SPECIALISED_SUBSTEPS
    return min(rk.SUBSTEP_CHUNK, n) if n in args else 1


def chain_sass(libs, table=None):
    """{system: {kernel: [loops]}} of the open-loop rollout kernels and the
    per-step kernels (``sass.loops``), with the loop that runs the substeps
    marked ``substep_loop`` and its figures per substep (an iteration runs a
    chunk of them where the count is compiled in, else one): its chain in
    cycles with the latency ``table`` (``calibrated_latency``;
    ``chain_cycles_per_substep``) and with sass.py's estimates
    (``chain_cycles_table``)."""
    from safe_control_gym_tpu_torch.experiments import sass
    text = {name: sass.disassemble(path) for name, path in libs.items()}
    funcs = {lib: sass.parse(t) for lib, t in text.items()}
    out = {}
    for system, (lib, rollout, advance) in CHAIN_KERNELS.items():
        rows = {}
        for fname, code in funcs[lib].items():
            if not (rollout in fname or advance in fname) or 'policy' in fname:
                continue
            found = sass.loops(code)
            measured = sass.loops(code, table)
            per_iter = _substeps_per_iteration(fname) if rollout in fname else 1
            # The substep loop: the innermost loop whose fast path reduces
            # angles (F2I) with no sinf/cosf slow path in or below it
            # (exact_math.cuh's copies); in a kernel without one, the
            # innermost loop with such a slow path.
            library = [lp for lp in found if lp.contains_sincos]
            exact = [lp for lp in found if lp.converts and not lp.contains_sincos
                     and not any(lp.start <= lib.start and lib.end <= lp.end
                                 for lib in library)]
            inner = min(exact or library, key=lambda lp: lp.instructions, default=None)
            entry = dict(loops=[lp.summary() for lp in found], substeps_per_iteration=per_iter)
            if inner is not None:
                same = measured[found.index(inner)]
                entry['substep_loop'] = dict(
                    inner.summary(),
                    fast_path_per_substep=inner.fast_path / per_iter,
                    chain_cycles_per_substep=same.recurrence / per_iter,
                    chain_cycles_table=inner.recurrence / per_iter,
                    slow_paths_per_substep={k: v / per_iter
                                            for k, v in inner.slow_paths.items()})
            rows[fname] = entry
        out[system] = rows
    return out


def latency_probe(dev):
    """({probe: cycles a chain link takes}, the long chain's links) on this
    card (``csrc/latency_probe.cu``): the long chain's cycles less the short
    one's, over the extra links."""
    lib = _build.load_library('latency_probe')
    p, i = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.scg_latency_probe.argtypes = [p, p, p, i, i, i, p]
    lib.scg_latency_probe.restype = ctypes.c_int
    values = torch.ones(34, device=dev)
    values[32], values[33] = 1.0000001, 1e-7      # the multiplier and the addend
    cycles = torch.zeros(2 * len(LATENCY_PROBES), dtype=torch.int64, device=dev)
    out = torch.empty(32, device=dev)
    n, short, long_ = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.scg_latency_probe(values.data_ptr(), cycles.data_ptr(), out.data_ptr(),
                                ctypes.byref(n), ctypes.byref(short), ctypes.byref(long_),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, 'latency_probe')
    if n.value != len(LATENCY_PROBES):
        raise RuntimeError(f'csrc/latency_probe.cu runs {n.value} probes, expected '
                           f'{len(LATENCY_PROBES)}')
    c = cycles.cpu().tolist()
    extra = long_.value - short.value
    return ({name: (c[2 * k + 1] - c[2 * k]) / extra for k, name in enumerate(LATENCY_PROBES)},
            long_.value)


def probe_opcodes(lib_path, links):
    """{probe: the opcode its chain is made of} from the SASS of
    ``csrc/latency_probe.cu``'s long chains; raises where a chain does not
    hold ``links`` instructions of its opcode (the compiler folded it)."""
    from safe_control_gym_tpu_torch.experiments import sass
    funcs = sass.parse(sass.disassemble(lib_path))
    out = {}
    for k, name in enumerate(LATENCY_PROBES):
        code = max((c for f, c in funcs.items() if f'latency_probe_kernelILi{k}E' in f), key=len)
        ops = [ins.op for ins in code if ins.op.startswith(name)]
        if len(ops) < links:
            raise RuntimeError(f'latency probe {name}: {len(ops)} of {links} links in its '
                               'SASS; the chain was folded')
        out[name] = max(set(ops), key=ops.count)
    return out


def calibrated_latency(cycles, opcodes):
    """sass.LATENCY with each class that a probe measured replaced by the
    largest reading of its probes (a probe in PROBE_LESS less the reading of
    the other instruction in its link): the table the chain bound is
    counted with."""
    from safe_control_gym_tpu_torch.experiments import sass
    table = dict(sass.LATENCY)
    measured = {}
    for name, cyc in cycles.items():
        cls = sass.op_class(opcodes[name])
        cyc -= cycles[PROBE_LESS[name]] if name in PROBE_LESS else 0.0
        measured[cls] = max(measured.get(cls, 0.0), cyc)
    table.update(measured)
    return table


def chain_bound_ms(cycles_per_substep, T, n_substeps, clock_ghz):
    """T x n_substeps x the chain's cycles at the clock, in ms."""
    return T * n_substeps * cycles_per_substep / (clock_ghz * 1e6)


def reference_chain_cycles(sass_rows, key='chain_cycles_per_substep'):
    """{system: loop-carried cycles of one substep} from the per-step kernel
    (one thread, one substep an iteration)."""
    out = {}
    for system, (_, _, advance) in CHAIN_KERNELS.items():
        for fname, entry in sass_rows[system].items():
            if advance in fname and 'substep_loop' in entry:
                out[system] = entry['substep_loop'][key]
    return out


def measured_chain(dev):
    """The latency probe, its opcodes, the calibrated table and the SASS of
    the substep loops counted with it: (probe rows, sass rows)."""
    from safe_control_gym_tpu_torch.experiments import sass
    libs = _build.build_all()
    links, n_links = latency_probe(dev)
    opcodes = probe_opcodes(libs['latency_probe'], n_links)
    table = calibrated_latency(links, opcodes)
    probes = [dict(probe=name, opcode=opcodes[name], link_cycles=links[name],
                   cycles=table[sass.op_class(opcodes[name])],
                   table_cycles=sass.latency(opcodes[name])) for name in LATENCY_PROBES]
    return probes, chain_sass(libs, table)


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
            ms = _time_ms(lambda: kernel(s0, cfg, 5, T, **kw))
            rows.append(dict(system=system, B=n, T=T, ms=ms,
                             ns_per_substep=ms * 1e6 / (T * n_sub)))
            print(json.dumps({'batch_sweep': system, **rows[-1]}), flush=True)
        env.close()
    return rows


def chain_report(dev, root=None):
    """Step 0 of a redesign of the open loop: times, batch sweep, latencies,
    SASS and chain bound, one JSON line each."""
    others = []
    if root:
        others.append(_times_of(root))
    clock = sm_clock_ghz()
    times = chain_times(dev)
    times_again = chain_times(dev)
    if root:
        others.append(_times_of(root))
    sweep = batch_sweep(dev)
    print(json.dumps({'exact_math': rk.exact_math_check(dev)}), flush=True)
    probes, rows = measured_chain(dev)
    for row in probes:
        print(json.dumps({'latency': row['probe'], **row}), flush=True)
    for system, kernels in rows.items():
        for fname, entry in kernels.items():
            print(json.dumps({'sass': system, 'kernel': fname, **entry}), flush=True)
    timed = []
    for label, runs in (('this', (times, times_again)), (root, others)):
        for rep, rows_t in enumerate(runs):
            for row in rows_t:
                timed.append({'chain_time': label, 'rep': rep, **row})
                print(json.dumps(timed[-1]), flush=True)
    n_sub = rk.SPECIALISED_SUBSTEPS
    table = reference_chain_cycles(rows, 'chain_cycles_table')
    for system, cycles in reference_chain_cycles(rows).items():
        print(json.dumps({'chain_bound': system, 'cycles_per_substep': cycles,
                          'cycles_per_substep_table': table[system], 'sm_clock_ghz': clock,
                          'ms_T131072': chain_bound_ms(cycles, 131072, n_sub, clock),
                          'ms_T4096': chain_bound_ms(cycles, CHAIN_T, n_sub, clock)}),
              flush=True)
    for row in probes:
        print(f'summary latency {row["probe"]:>8} {row["opcode"]:>16} {row["cycles"]:7.2f} '
              f'cycles (table {row["table_cycles"]})')
    for r in sweep:
        print(f'summary batch {r["system"]:>12} B={r["B"]:<6} {r["ns_per_substep"]:9.2f} '
              'ns/substep')
    return timed


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
    """``nvcc -Xptxas -v`` of ``csrc/<name>.cu``: registers, stack, spills."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v',
                               '-o', os.path.join(tmp, 'lib.so'),
                               _build.sources(name)[0]],
                              capture_output=True, text=True, check=True)
    return proc.stdout + proc.stderr


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
    parser.add_argument('--root', default=None,
                        help='with --chain: also time the kernels of this checkout')
    parser.add_argument('--chain-times', action='store_true', help=argparse.SUPPRESS)
    args = parser.parse_args()
    dev = require_cuda('cuda')
    if args.chain_times:
        print(json.dumps(chain_times(dev)))
        return
    if args.chain:
        print_summary(chain_report(dev, args.root))
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout)
        return
    print(ptxas_report('cartpole_kernels'))
    print(ptxas_report())
    policy_smem_report()
    t0 = time.perf_counter()
    _build.build_all()
    print('build', time.perf_counter() - t0, 's')
    g = torch.Generator(device=dev).manual_seed(0)
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)
    states = torch.stack([u((B,), -1, 1), u((B,), -0.5, 0.5), u((B,), 0.5, 1.5),
                          u((B,), -0.5, 0.5), u((B,), -1, 1), u((B,), -3, 3)], 1)
    a2 = (states.contiguous(), u((B,), 0.05, 0.2), u((B,), 0.05, 0.2),
          u((B, 2), -0.01, 0.01), torch.tensor([0.027, 1.4e-5, 0.0397, 9.8], device=dev))
    print('k2 err', float((pk.quad2d_advance(*a2, 20, 1e-3)
                           - pk.quad2d_advance_plain(*a2, 20, 1e-3)).abs().max()))
    s3 = u((B, 12), -0.5, 0.5)
    s3[:, 4] += 1
    a3 = (s3.contiguous(), u((B, 4), 0.03, 0.1), u((B,), -1e-6, 1e-6), u((B, 3), -0.01, 0.01),
          torch.tensor([0.027, 1.4e-5, 1.4e-5, 2.17e-5, 0.0397, 9.8], device=dev))
    print('k3 err', float((pk.quad3d_advance(*a3, 20, 1e-3)
                           - pk.quad3d_advance_plain(*a3, 20, 1e-3)).abs().max()))
    print('exact_math', rk.exact_math_check(dev))
    open_loop_checks(dev)
    policy_checks(dev)
    if args.floor:
        policy_floor(dev)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True).stdout)


if __name__ == '__main__':
    main()
