"""Run one cell of the benchmark once and print its result as one JSON line.

    python gpubench/run.py --workload quadrotor_3D_ppo.train --seed 7 --seconds 10 --trace 0

The cell's name is looked up in ``BENCHMARK.json``; its file
``gpubench/workloads/<cell>.json`` names the configuration
(``gpubench/configs/<config>.json``), the traffic driver
(``gpubench/drivers/<driver>.py``) and the traffic's parameters. The driver
builds the program (``safe_control_gym_tpu_torch``) on the card from the
seed and warms up every shape the cell uses: that is set-up. Then it drives
the program for ``--seconds`` of wall time, and afterwards the plain
reference under ``gpubench/reference/`` judges a sample, drawn from the
seed, of what the window produced.

With ``--trace 0`` the result holds the cell's end-to-end metrics: its
``metric``, the window's work over its wall time, or, where
``gpubench/metrics/<metric>.py`` exists, what that reader makes of the
window (a reader with ``WINDOW_TRACE = 'device'`` has the whole window's
device activity traced, in pieces, for it); and ``setup_s``. With
``--trace 1`` the window runs under ``torch.profiler`` and the result holds
its per-layer metrics (each read by ``gpubench/metrics/<metric>.py``), the
device's busy seconds and a breakdown of the trace. Each number the check
compared is printed beside its limit, last on standard error and last in the
result's line. A run without a CUDA card, or that finds JAX or the JAX
package loaded, exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_BENCH_DIR)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# Build and kernel caches at fixed paths inside the checkout, so that the
# second run of a cell there finds every kernel built. The port's nvcc
# libraries already live in safe_control_gym_tpu_torch/csrc/build/.
_CACHE = os.path.join(_ROOT, '.gpubench_cache')
os.environ['TRITON_CACHE_DIR'] = os.path.join(_CACHE, 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(_CACHE, 'torch_extensions')
os.environ['USE_FLAX'] = '0'

from gpubench.harness import core  # noqa: E402
from gpubench.harness.checks import report  # noqa: E402
from gpubench.harness.device import NoDevice, describe, require_cuda  # noqa: E402
from gpubench.harness.tracing import WINDOW, DeviceBusy, Spans, summarize  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             params=None, config=None, t_start: float = None):
    """Run the cell ``name`` once. ``device`` None finds the card (raising
    ``NoDevice`` without one); the tests pass the CPU, smaller ``params``
    (merged over the cell's traffic parameters) and a smaller ``config``.
    Returns ``(result, checks)``: ``result`` the dict the result's line
    holds."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = core.benchmark()
    entry = core.cell_entry(bench, name)
    cell = core.workload(name)
    if params:
        cell = {**cell, 'params': {**cell['params'], **params}}
    config = core.config(cell['config']) if config is None else config
    driver = core.load_module('drivers', cell['driver'])
    e2e = core.end_to_end_metrics(bench, name)
    layer = core.per_layer_metrics(bench, name)
    readers = {m['name']: core.load_module('metrics', m['name']) for m in layer}
    rate = cell['metric']
    if rate not in {m['name'] for m in e2e}:
        raise core.UnknownName(f'{name}: its metric {rate!r} is not among its '
                               'end-to-end metrics in BENCHMARK.json')
    rate_reader = core.load_module('metrics', rate) if core.has_module('metrics', rate) \
        else None
    device = torch.device(require_cuda(int(entry['chips'])) if device is None else device)
    cuda = device.type == 'cuda'
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')

    spans = Spans(trace)
    run = driver.make(cell, config, int(seed), device, spans)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    summary = busy = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with spans(WINDOW):
                stats = run.window(min(seconds, cell['params'].get('trace_seconds') or seconds))
        summary = summarize(prof, spans.names)
        del prof
    elif cuda and getattr(rate_reader, 'WINDOW_TRACE', None) == 'device':
        with DeviceBusy() as busy:
            spans.after = busy.span_closed
            with spans(WINDOW):
                stats = run.window(seconds)
        spans.after = None
        print(f'gpubench: device busy {busy.busy_s:.6f} s, kernels {busy.kernel_s:.6f} s, in '
              f'{busy.pieces} traced pieces, {busy.activity_count} device activities',
              file=sys.stderr, flush=True)
    else:
        with spans(WINDOW):
            stats = run.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counts = run.layer_counts()
    t_check = time.perf_counter()
    run.release()
    checks = run.check()
    print(f'gpubench: {name} setup {setup_s:.3f} s, window {stats["wall_s"]:.3f} s, '
          f'{stats["attempted"]} attempted, check {time.perf_counter() - t_check:.3f} s',
          file=sys.stderr, flush=True)

    units = {m['name']: m['unit'] for m in bench['end_to_end'] + bench['per_layer']}
    metrics = {}
    ctx = {'trace': summary, 'counts': counts, 'cell': cell, 'config': config,
           'stats': stats, 'device_busy_s': busy.busy_s if busy is not None else None}
    if trace:
        for metric, reader in readers.items():
            value = reader.read(ctx)
            if value is not None:
                metrics[metric] = {'value': float(value), 'unit': units[metric]}
    else:
        value = stats['work'] / stats['wall_s'] if rate_reader is None else \
            rate_reader.read(ctx)
        if value is not None:
            metrics[rate] = {'value': float(value), 'unit': units[rate]}
        metrics['setup_s'] = {'value': setup_s, 'unit': units['setup_s']}
    dev = describe(device, int(entry['chips']), peak, summary) if cuda else {
        'platform': 'cpu', 'kind': 'cpu', 'count': 0, 'memory_peak_bytes': 0}
    failed = sum(1 for c in checks if not c.passed)
    result = {'correct': failed == 0, 'attempted': int(stats['attempted']),
              'failed': int(stats['attempted']) if failed else 0, 'metrics': metrics,
              'device': dev}
    if summary is not None:
        result['breakdown'] = {'device_ops': summary.device_ops,
                               'idle_gaps': summary.idle_gaps}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One process with one PyTorch thread. It is not pinned to a core: pinned,
    # the host-paced train cell ran some runs a third slower than the rest
    # (the card's runtime threads share the core).
    import torch
    torch.set_num_threads(1)
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START)
    except (NoDevice, core.UnknownName) as exc:
        print(f'gpubench: {exc}', file=sys.stderr, flush=True)
        return 2
    loaded = core.forbidden_modules()
    if loaded:
        print('gpubench: the run loaded JAX or the JAX package: ' + ', '.join(loaded),
              file=sys.stderr, flush=True)
        return 4
    report(checks)
    print(core.result_line(result, checks), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
