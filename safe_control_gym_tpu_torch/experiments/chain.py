"""What the physics kernels are up against on the card: the serial chain of
one env's substeps, the latencies of its instructions, and a launch.

    from safe_control_gym_tpu_torch.experiments import chain
    probes, rows, table = chain.measured_chain(dev)   # latencies, SASS, latency table
    cycles = chain.reference_chain_cycles(rows)   # {system: cycles of one substep}
    ms = chain.chain_bound_ms(cycles['cartpole'], T, 20, chain.sm_clock_ghz())
    issued = chain.compiled_in_fast_path(rows)    # {system: {kind: instructions}}

* ``chain_times``: ns a substep of the open-loop kernels (K4, K5) at B=4096,
  T=4096 on the main path's constrained rows and on hover replays (the
  angles exactly 0, or tilted by 0.01 rad), for the full batch and for one
  block of 32 envs, and the random rows at B=65536;
* ``latency_probe`` (``csrc/latency_probe.cu``): cycles from issue to a
  dependent issue of FADD, FMUL, FFMA, MUFU.RCP, F2I and I2F on this card,
  each probe's chain checked in its SASS (``probe_opcodes``), and
  ``calibrated_latency``, sass.py's table with the measured classes;
* ``chain_sass`` (``experiments/sass.py``): for every open-loop rollout
  kernel and per-step physics kernel, the loop that holds the substeps, its
  instructions (all and on the fast path), its branches to the slow paths
  of divide, reciprocal, ``sinf``/``cosf`` and ``sqrtf``, and its dependent
  chain a substep, counted with a latency table;
* ``reference_chain_cycles``: the chain of one substep of the per-step
  kernels' runtime-count loop (K1-K3 at N = 0), which sets the chain bound
  (``chain_bound_ms``) of every kernel that runs those substeps one env a
  thread;
* ``compiled_in_fast_path``: the fast-path instructions of one substep in
  the per-step and open-loop kernels instantiated for the 20 substeps
  compiled in. At B=4096 each SM holds one warp, which issues at most one
  instruction a cycle, so n_substeps x that count over the SM clock is the
  issue floor of those kernels' substeps, beside the chain bound (where a
  substep's chain is short, as in 2D, the issue floor is the larger);
* ``sm_clock_ghz``: the SM clock under load; ``launch_floor``: an empty
  kernel on the per-step kernels' grid.

``kernel_first_check --chain`` prints all of it; ``chip_smoke.py``'s phase
``chain`` gates on it and fills the kernels line's chain bounds with it.
"""

from __future__ import annotations

import ctypes
import re

import torch

from safe_control_gym_tpu_torch.experiments.benchmark_suite import (_kernel_cfg, _make,
                                                                    hover_actions, hover_case)
from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
from safe_control_gym_tpu_torch.ops._launch import block_size

__all__ = ['CHAIN_SYSTEMS', 'CHAIN_KERNELS', 'REDUCTIONS_PER_SUBSTEP', 'LATENCY_PROBES',
           'PROBE_LESS', 'best_time_ms', 'sm_clock_ghz', 'chain_times', 'template_args',
           'substeps_per_iteration', 'substep_loops', 'chain_sass', 'latency_probe',
           'probe_opcodes', 'calibrated_latency', 'chain_bound_ms', 'reference_chain_cycles',
           'compiled_in_fast_path', 'measured_chain', 'launch_floor']

B = 4096
CHAIN_SYSTEMS = ('cartpole', 'quadrotor', 'quadrotor_3D')
CHAIN_T = 4096
CHAIN_BIG_B = 65536
CHAIN_BLOCK_ENVS = 32
# csrc/latency_probe.cu's probes, in the order of its enum Probe: the opcode
# each chain link issues (checked in the SASS), and for a link of two
# instructions the probe whose reading is taken off.
LATENCY_PROBES = ('FADD', 'FMUL', 'FFMA', 'MUFU.RCP', 'F2I', 'I2F')
PROBE_LESS = {'MUFU.RCP': 'FMUL'}
# The library and kernels of each system: the open-loop rollout kernel (all
# its instantiations) and the per-step kernel (all its instantiations; the
# runtime-count one is the chain's reference).
CHAIN_KERNELS = {
    'cartpole': ('cartpole_kernels', 'cartpole_rollout_kernel', 'cartpole_advance_kernel'),
    'quadrotor': ('quad_kernels', 'quad_rollout_kernelILi2E', 'quad2d_advance_kernel'),
    'quadrotor_3D': ('quad_kernels', 'quad_rollout_kernelILi3E', 'quad3d_advance_kernel'),
}
# Angles a substep reduces for sin and cos (one F2I each on the fast path:
# sinf and cosf of one angle share it), which counts the substeps in a loop
# iteration however the compiler unrolled it.
REDUCTIONS_PER_SUBSTEP = {'cartpole': 1, 'quadrotor': 1, 'quadrotor_3D': 3}


def best_time_ms(fn, reps=3):
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
    return cycles / (best_time_ms(lambda: torch.cuda._sleep(cycles), 2) * 1e6)


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
            ms = best_time_ms(lambda: kernel(state0, c, 5, T, **kw))
            rows.append(dict(system=system, case=name, B=state0.shape[0], T=T,
                             n_substeps=n_sub, ms=ms, ns_per_substep=ms * 1e6 / (T * n_sub)))
        del cases, big
        torch.cuda.empty_cache()
    return rows


def template_args(kernel_name: str) -> list:
    """The integer template arguments of a mangled kernel name
    (``…quad_rollout_kernelILi3ELi20EE…`` gives [3, 20]); [] for a kernel
    that is no template."""
    m = re.search(r'_kernelI((?:Li\d+E)+)', kernel_name)
    return [int(a) for a in re.findall(r'Li(\d+)E', m.group(1))] if m else []


def substeps_per_iteration(kernel_name: str) -> int:
    """Substeps one iteration of a kernel's substep loop runs in the source: a
    chunk (SUBSTEP_CHUNK) where the kernel is specialised to the compile-time
    count (a template argument of 20 in the mangled name), else 1 (a loop
    over a runtime count, which the compiler may unroll further)."""
    n = rk.SPECIALISED_SUBSTEPS
    return min(rk.SUBSTEP_CHUNK, n) if n in template_args(kernel_name) else 1


def substep_loops(funcs, table=None):
    """{system: {kernel: entry}} of the open-loop rollout kernels and the
    per-step kernels of CHAIN_KERNELS, from ``funcs``, {library: {function:
    [Instr]}} (``sass.parse`` of each library). Each entry lists the
    kernel's loops (``sass.loops``) and marks the loop that runs the
    substeps, ``substep_loop``, with its figures per substep: its chain in
    cycles with the latency ``table`` (``calibrated_latency``;
    ``chain_cycles_per_substep``) and with sass.py's estimates
    (``chain_cycles_table``). The substeps an iteration holds are counted
    from its angle reductions (REDUCTIONS_PER_SUBSTEP), beside what the
    source puts in one (``substeps_per_iteration``): ``compiler_unroll`` is
    their ratio, 2 where ptxas unrolled a runtime-count loop by two."""
    from safe_control_gym_tpu_torch.experiments import sass
    out = {}
    for system, (lib, rollout, advance) in CHAIN_KERNELS.items():
        rows = {}
        for fname, code in funcs[lib].items():
            if not (rollout in fname or advance in fname) or 'policy' in fname:
                continue
            found = sass.loops(code)
            measured = sass.loops(code, table)
            source = substeps_per_iteration(fname)
            # The substep loop: the innermost loop whose fast path reduces
            # angles (F2I) with no sinf/cosf slow path in or below it
            # (exact_math.cuh's copies); in a kernel without one, the
            # innermost loop with such a slow path.
            library = [lp for lp in found if lp.contains_sincos]
            exact = [lp for lp in found if lp.converts and not lp.contains_sincos
                     and not any(lp.start <= lib.start and lib.end <= lp.end
                                 for lib in library)]
            inner = min(exact or library, key=lambda lp: lp.instructions, default=None)
            entry = dict(loops=[lp.summary() for lp in found],
                         source_substeps_per_iteration=source)
            if inner is not None:
                same = measured[found.index(inner)]
                per_iter = max(1, inner.converts // REDUCTIONS_PER_SUBSTEP[system])
                entry['substep_loop'] = dict(
                    inner.summary(), substeps_per_iteration=per_iter,
                    compiler_unroll=per_iter / source,
                    fast_path_per_substep=inner.fast_path / per_iter,
                    chain_cycles_per_substep=same.recurrence / per_iter,
                    chain_cycles_table=inner.recurrence / per_iter,
                    slow_paths_per_substep={k: v / per_iter
                                            for k, v in inner.slow_paths.items()})
            rows[fname] = entry
        out[system] = rows
    return out


def chain_sass(libs, table=None):
    """``substep_loops`` of the built libraries ``libs``, {name: path}."""
    from safe_control_gym_tpu_torch.experiments import sass
    return substep_loops({name: sass.parse(sass.disassemble(path))
                          for name, path in libs.items()}, table)


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
    """{system: loop-carried cycles of one substep} from the substep loop of
    the per-step kernel instantiated for a runtime count (template argument
    0, or none), one thread an env."""
    out = {}
    for system, (_, _, advance) in CHAIN_KERNELS.items():
        for fname, entry in sass_rows[system].items():
            if advance in fname and template_args(fname) in ([], [0]) \
                    and 'substep_loop' in entry:
                out[system] = entry['substep_loop'][key]
    return out


def compiled_in_fast_path(sass_rows):
    """{system: {'advance' or 'rollout': fast-path instructions of one
    substep}} from the substep loop of the per-step kernel and of the
    open-loop kernel instantiated for the substep count compiled in (a last
    template argument of SPECIALISED_SUBSTEPS): what one thread issues a
    substep on the main path."""
    out = {}
    for system, (_, _, advance) in CHAIN_KERNELS.items():
        for fname, entry in sass_rows[system].items():
            if template_args(fname)[-1:] == [rk.SPECIALISED_SUBSTEPS] \
                    and 'substep_loop' in entry:
                kind = 'advance' if advance in fname else 'rollout'
                out.setdefault(system, {})[kind] = entry['substep_loop']['fast_path_per_substep']
    return out


def measured_chain(dev):
    """The latency probe, its opcodes, the calibrated table and the SASS of
    the substep loops counted with it: (probe rows, sass rows, table)."""
    from safe_control_gym_tpu_torch.experiments import sass
    libs = _build.build_all()
    links, n_links = latency_probe(dev)
    opcodes = probe_opcodes(libs['latency_probe'], n_links)
    table = calibrated_latency(links, opcodes)
    probes = [dict(probe=name, opcode=opcodes[name], link_cycles=links[name],
                   cycles=table[sass.op_class(opcodes[name])],
                   table_cycles=sass.latency(opcodes[name])) for name in LATENCY_PROBES]
    return probes, chain_sass(libs, table), table


def launch_floor(n, dev):
    """A callable that launches an empty kernel (``csrc/latency_probe.cu``) on
    the grid the per-step kernels take for ``n`` envs (``block_size``)."""
    lib = _build.load_library('latency_probe')
    lib.scg_noop.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.scg_noop.restype = ctypes.c_int
    threads = block_size(n, dev)
    blocks = (n + threads - 1) // threads
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        _build.check(lib, lib.scg_noop(blocks, threads, stream), 'noop')

    return launch
