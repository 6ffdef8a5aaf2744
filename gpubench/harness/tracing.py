"""The benchmark's own spans and the reduction of a profiler trace.

Spans are ``torch.profiler.record_function`` ranges that the harness and the
drivers open around their calls into the program (``learn iteration``,
``evaluate_policy_fused``, ``rollout launch``, ``throttle wait``); the whole
measured window is the span ``window``. With tracing off they cost nothing.

``summarize`` reduces a ``torch.profiler`` trace (CPU and CUDA activities) to
what the per-layer metrics read: the window's length, the device's busy time
(the union of every device activity's interval inside the window), each
kernel's interval and name, each span's intervals, the top kernels by time
and the longest idle gaps, each named by the innermost span the host was in
when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field

WINDOW = 'window'
# A kernel's name in the breakdown is cut to this many characters (C++
# template arguments make some names thousands long).
NAME_CHARS = 160


class Spans:
    """``spans(name)`` is a context manager: a profiler range when
    ``enabled``, else nothing. ``names`` collects the names used, so the
    trace's reduction knows which CPU events are the benchmark's spans.
    ``after``, when set, is called with the name of every span but the
    window as it closes."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.names = {WINDOW}
        self.after = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.names.add(name)
        if not self.enabled:
            yield
        else:
            from torch.profiler import record_function
            with record_function(name):
                yield
        if self.after is not None and name != WINDOW:
            self.after(name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)    # (name, start_ns, end_ns)
    spans: dict = field(default_factory=dict)      # name -> [(start_ns, end_ns)]
    device_ops: list = field(default_factory=list)  # [[name, seconds]], longest first
    idle_gaps: list = field(default_factory=list)   # [[span, seconds]], longest first

    def kernel_seconds(self, predicate) -> float:
        """Device seconds of the kernels whose name ``predicate`` accepts."""
        return sum(e - s for n, s, e in self.kernels if predicate(n)) / 1e9

    def kernels_in(self, span: str) -> tuple:
        """(kernels that started inside a whole ``span`` interval, number of
        such intervals)."""
        starts = sorted(s for _, s, _ in self.kernels)
        ivs = self.spans.get(span, [])
        n = sum(bisect.bisect_left(starts, e0) - bisect.bisect_left(starts, s0)
                for s0, e0 in ivs)
        return n, len(ivs)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith('memcpy') or low.startswith('memset'))


def device_busy(prof) -> tuple:
    """(seconds in which any device activity ran, seconds in which a kernel
    ran, number of device activities) over the whole of a finished profile;
    user annotations on the device's timeline are no work."""
    intervals, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).split('.')[-1] == 'CUDA' and not ev.is_user_annotation():
            start = ev.start_ns()
            intervals.append([start, start + ev.duration_ns()])
            if _is_kernel(ev.name()):
                kernels.append(intervals[-1])
    busy = lambda ivs: sum(e - s for s, e in _merge(ivs)) / 1e9
    return busy(intervals), busy(kernels), len(intervals)


class DeviceBusy:
    """The device's busy seconds over a window too long for one trace.

    The device's activities (no CPU events) are traced in pieces: whenever a
    span other than the window closes (``span_closed``, hooked to
    ``Spans.after``) and the piece has lasted ``piece_s`` seconds, the
    profiler stops, its piece is reduced to busy seconds, and a new piece
    starts. Each piece stays far below the profiler's buffer for device
    records, so none is dropped. Stopping waits for the device, so no work
    falls between two pieces. ``activities`` is for the tests."""

    def __init__(self, piece_s: float = 5.0, activities=None):
        self.piece_s = piece_s
        self.activities = activities
        self.busy_s = 0.0
        self.kernel_s = 0.0
        self.activity_count = 0
        self.pieces = 0
        self._prof = None
        self._t0 = 0.0

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=self.activities or [ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def _stop(self):
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        busy, kernel, n = device_busy(prof)
        self.busy_s += busy
        self.kernel_s += kernel
        self.activity_count += n
        self.pieces += 1

    def span_closed(self, name: str):
        if self._prof is not None and time.perf_counter() - self._t0 >= self.piece_s:
            self._stop()
            self._start()

    def __enter__(self):
        self._start()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._stop()
        return False


def summarize(prof, span_names, top: int = 10) -> TraceSummary:
    """The :class:`TraceSummary` of a finished ``torch.profiler.profile``
    whose window was a ``window`` span."""
    events = prof.profiler.kineto_results.events()
    spans = {}
    device = []
    for ev in events:
        kind = str(ev.device_type()).split('.')[-1]
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if kind == 'CUDA':
            # The spans' own ranges on the device's timeline are no work.
            if ev.name() not in span_names and not ev.is_user_annotation():
                device.append((ev.name(), start, end))
        elif kind == 'CPU' and ev.name() in span_names:
            spans.setdefault(ev.name(), []).append((start, end))
    if WINDOW not in spans:
        raise RuntimeError('trace: the window span is missing')
    w0, w1 = spans[WINDOW][0]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    merged = _merge([[s, e] for _, s, e in inside])
    busy = sum(e - s for s, e in merged)
    kernels = [k for k in inside if _is_kernel(k[0])]
    by_name = {}
    for n, s, e in kernels:
        by_name[n] = by_name.get(n, 0) + (e - s)
    device_ops = sorted(([n[:NAME_CHARS], t / 1e9] for n, t in by_name.items()),
                        key=lambda x: -x[1])
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        named.append([_span_at(spans, g0), (g1 - g0) / 1e9])
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, kernels=kernels,
                        spans=spans, device_ops=device_ops[:top], idle_gaps=named)


def _span_at(spans, t):
    """The innermost span (the shortest interval) that holds time ``t``."""
    best, best_len = WINDOW, None
    for name, ivs in spans.items():
        for s, e in ivs:
            if s <= t < e and (best_len is None or e - s < best_len):
                best, best_len = name, e - s
    return best
