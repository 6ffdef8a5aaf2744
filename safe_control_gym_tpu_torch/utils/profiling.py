"""Profiling and tracing: accumulating phase timers, a device trace, the
program's named spans and counters.

Port of ``safe_control_gym_tpu/utils/profiling.py``:

* ``Timer`` / ``timed``: accumulating wall-clock timers by phase with a
  summary table; ``block=True`` synchronizes the CUDA device before the
  clock stops, so that the work the phase launched is counted;
* ``trace(log_dir)``: ``torch.profiler.profile`` over the block (the CPU and,
  where there is one, the CUDA device), written as a Chrome trace
  ``trace.json`` under ``log_dir``;
* ``annotate(name)``: the program's span. The loops open one around each of
  their phases (``ppo.iteration``, ``ppo.rollout``, ``env.step_autoreset``,
  ``ppo.returns``, ``ppo.update``, ``ppo.update.grad``, ``ppo.update.optim``,
  ``ppo.read``; ``fused_eval`` around an eval call, with
  ``fused_eval.prep``, ``fused_eval.launch``, ``fused_eval.read``), so
  ``trace(log_dir)`` shows them in Perfetto nested under the loop, above the
  kernels they launched;
* ``count(name, n)``: the program's counter. ``host_reads`` counts, where
  they happen, the copies between host and card that the host waits on: the
  reads inside ``ppo.read`` and ``fused_eval.read``, the synchronizations
  around the eval's timed launch, and the reset draw's copies of its config
  bounds to a CUDA card (``envs/benchmark_env.py``). The eval prep's copies
  of the packed actor and of its cfg vector are not counted.

Spans and counts cost one check of the profiler's state and, for a span, a
shared null context when no profiler runs: they record nothing and launch
nothing. While a ``torch.profiler`` runs (``trace``, or any other), a span is
also a ``record_function`` range, and both append a stamped entry to
``events``, a bounded ring that a reader lines up with the trace's device
activity: ``Span(name, t0_ns, t1_ns)`` as the span closes, ``Count(name,
t_ns, n)``, each on ``time.time_ns()``, the clock the profiler's events
report. ``dropped`` counts the entries the ring let go, oldest first.
Neither records a CUDA event, synchronizes or launches a kernel.

    with timed('rollout', block=True):
        ...
    print(timed.summary())
    with trace('temp/trace'):
        ctrl.learn()            # trace.json: learn's phases over its kernels
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Dict, NamedTuple

import torch

__all__ = ['Timer', 'timed', 'trace', 'annotate', 'count', 'Span', 'Count']


class Timer:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, block: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f'{"phase":<28}{"total_s":>10}{"calls":>8}{"mean_ms":>10}']
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            tot, n = self.totals[name], self.counts[name]
            lines.append(f'{name:<28}{tot:>10.3f}{n:>8}{tot / n * 1e3:>10.2f}')
        return '\n'.join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


#: process-global default timer
timed = Timer()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write ``log_dir/trace.json``
    (open it in Perfetto or ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class Span(NamedTuple):
    """A closed span: its name and its interval on ``time.time_ns()``."""
    name: str
    t0_ns: int
    t1_ns: int


class Count(NamedTuple):
    """``n`` of the counter ``name`` at ``t_ns`` on ``time.time_ns()``."""
    name: str
    t_ns: int
    n: int


#: Entries the ring holds: about 300 PPO iterations at 24 steps and 20
#: minibatches (about 75 spans and 145 counts each).
RING_SIZE = 1 << 16
#: The ring of spans and counts recorded while a profiler ran, oldest first.
events: deque = deque(maxlen=RING_SIZE)
#: Entries the ring let go since the process started.
dropped = 0

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _push(entry):
    global dropped
    if len(events) == events.maxlen:
        dropped += 1
    events.append(entry)


class _Span:
    __slots__ = ('name', 't0', 'range')

    def __init__(self, name):
        self.name = name

    # The interval starts once the range is open and ends once it is
    # closed: a kernel launched just before the span starts on the card
    # after it opened, and one launched at its end after it closed.
    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        _push(Span(self.name, self.t0, time.time_ns()))
        return False


def annotate(name: str):
    """The program's span ``name``: while a profiler runs, a
    ``record_function`` range and a ``Span`` in ``events``; else a shared
    null context."""
    return _Span(name) if _profiler_enabled() else _OFF


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``: a ``Count`` in ``events`` while a
    profiler runs, else nothing."""
    if _profiler_enabled():
        _push(Count(name, time.time_ns(), n))
