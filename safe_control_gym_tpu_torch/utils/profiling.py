"""Profiling and tracing: accumulating phase timers, a device trace, named spans.

Port of ``safe_control_gym_tpu/utils/profiling.py``:

* ``Timer`` / ``timed``: accumulating wall-clock timers by phase with a
  summary table; ``block=True`` synchronizes the CUDA device before the
  clock stops, so that the work the phase launched is counted;
* ``trace(log_dir)``: ``torch.profiler.profile`` over the block (the CPU and,
  where there is one, the CUDA device), written as a Chrome trace
  ``trace.json`` under ``log_dir``;
* ``annotate(name)``: ``torch.profiler.record_function``, a named span in
  such a trace.

    with timed('rollout', block=True):
        ...
    print(timed.summary())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ['Timer', 'timed', 'trace', 'annotate']


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


def annotate(name: str):
    """A named span that shows up inside profiler traces."""
    return torch.profiler.record_function(name)
