"""The traced window's card time and idle time, put down to the program's own
spans.

While a profiler runs, the program (``safe_control_gym_tpu_torch.utils.
profiling``) keeps a bounded ring of its closed spans, ``(name, t0_ns,
t1_ns)``, and counts, ``(name, t_ns, n)``, stamped on ``time.time_ns()``, the
clock of the trace's host events. ``split`` takes the ring's entries inside
the trace's ``window`` span and keeps whole units of work: a training
iteration (the span ``ppo.iteration``) or an eval call (the span
``fused_eval``). It puts each moment of a unit down to the innermost span
open then (the unit itself where none is), and gives, a unit:

* each span's card time: the kernels (``TraceSummary.kernels``) launched in
  its own time, each whole;
* each span's idle time: the part of its own time in which no kernel ran;
* each counter's sum.

The trace keeps no kernel's launch, only its interval on the device's clock,
and that clock can drift from the host's inside a window (on the H100, by up
to milliseconds in a 4 s window, steadily or in jumps), which moves kernels
between neighbouring phases. So the kernels are put on the host's clock from
what every unit of the program does:

* it launches the same kernels in the same order, so the window's kernels
  fall into one block of ``k`` kernels a unit, whose names repeat from block
  to block;
* it ends in a read that waits for the card, so its block's last kernel ends
  a short tail before its last ``*.read`` span closes. Taking the offset of
  the two clocks as linear from one unit's end to the next puts each block on
  the host's clock, up to that tail, which is common to all units but
  unknown;
* the kernel at a given place in its block was launched in the same phase in
  every unit. The tail taken is the one under which the units agree most on
  each place's phase (``TAILS_NS``), and each place's phase is the one most
  units give it.

Card time is counted by place, so a unit whose clock jumped inside it moves
no kernel. Idle time is counted on the host's clock as the blocks were put
on it. A program without the ring (one older than its spans) reads None, as
do a trace without a kernel or with fewer than ``MIN_UNITS`` whole units, a
ring that let go of entries inside the window, a window whose kernels do not
fall into blocks that repeat, and one whose units agree on fewer than
``AGREE`` of the places.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from gpubench.harness.tracing import WINDOW, _merge

TRAIN, EVAL = 'train', 'eval'
# Each kind's unit of work: the span around a training iteration or an eval
# call.
UNIT = {TRAIN: 'ppo.iteration', EVAL: 'fused_eval'}
# The tails tried, coarse and then fine: from a block's last kernel's end to
# its unit's last read span's close, on the host's clock (120-490 us on the
# H100's host).
TAIL_STEP_NS, FINE_STEP_NS = 50_000, 10_000
TAILS_NS = range(0, 2_000_001, TAIL_STEP_NS)
# The fewest whole units whose places vote.
MIN_UNITS = 3
# The least share of the blocks' kernels whose phase agrees with their
# place's, and of the kernels named as the kernel one block on.
AGREE = 0.9


@dataclass
class Split:
    units: int
    device_ms: dict = field(default_factory=dict)   # span -> card ms a unit
    idle_ms: dict = field(default_factory=dict)     # span -> idle ms a unit
    counts: dict = field(default_factory=dict)      # counter -> its sum a unit


def program_ring():
    """``(entries, dropped)`` of the program's ring, or None where the
    program keeps none."""
    try:
        from safe_control_gym_tpu_torch.utils import profiling
    except ImportError:
        return None
    events = getattr(profiling, 'events', None)
    if events is None:
        return None
    return list(events), int(getattr(profiling, 'dropped', 0))


def _is_span(entry) -> bool:
    return hasattr(entry, 't1_ns')


def _closed_at(entry) -> int:
    return entry.t1_ns if _is_span(entry) else entry.t_ns


def _segments(spans, outer):
    """``[(start, end, name)]`` over the ``outer`` interval ``(start, end,
    name)``: each moment put down to the innermost of ``spans`` (nested, as
    the spans of one thread are) open then, else to ``outer``'s name."""
    out = []
    stack = [outer]
    t = outer[0]
    for s in sorted(spans, key=lambda s: (s[0], -s[1])) + [(outer[1], outer[1], None)]:
        while len(stack) > 1 and stack[-1][1] <= s[0]:
            top = stack.pop()
            if t < top[1]:
                out.append((t, top[1], top[2]))
                t = top[1]
        if t < s[0]:
            out.append((t, s[0], stack[-1][2]))
            t = s[0]
        if s[2] is not None:
            stack.append(s)
    return out


@dataclass
class _Unit:
    start: int       # the unit span's open, on the host's clock
    end: int         # its close
    read: int        # its last read span's close (else its close)
    segments: list   # [(start, end, name)], each moment's innermost span


def _units(spans, outer, w0, w1):
    """The ``outer`` spans inside the window, in order."""
    out = []
    for u0, u1 in sorted((s[0], s[1]) for s in spans
                         if s[2] == outer and w0 <= s[0] and s[1] <= w1):
        inner = [s for s in spans if u0 <= s[0] and s[1] <= u1 and s[2] != outer]
        reads = [s[1] for s in inner if s[2].endswith('.read')]
        out.append(_Unit(u0, u1, max(reads, default=u1), _segments(inner, (u0, u1, outer))))
    return out


def _period(names, k0):
    """The period of the kernels' ``names`` nearest ``k0`` that holds for
    ``AGREE`` of them, or None."""
    n = len(names)
    for k in sorted(range(max(1, k0 * 3 // 4), min(n // 2, k0 * 5 // 4) + 1),
                    key=lambda k: abs(k - k0)):
        if np.count_nonzero(names[:-k] == names[k:]) >= AGREE * (n - k):
            return k
    return None


def _alignments(kernels, units):
    """``[(first kernel, k, units)]``: the ways the window's kernels fall
    into blocks of ``k``, one a unit of ``units``. Where the trace cut the
    first or the last unit's kernels at the window's edge, its block is left
    out, and both edges are tried."""
    n, u = len(kernels), len(units)
    if not u or n < u:
        return []
    ids = {}
    names = np.asarray([ids.setdefault(name, len(ids)) for name, _, _ in kernels])
    if n % u == 0 and (u == 1 or np.count_nonzero(names[:-(n // u)] == names[n // u:])
                       >= AGREE * (n - n // u)):
        return [(0, n // u, units)]
    k = _period(names, max(1, round(n / u)))
    if k is None:
        return []
    m = min(n // k, u)
    return [(0, k, units[:m]), (n - m * k, k, units[u - m:])]


def _on_host(starts, ends, reads, tail):
    """The blocks' ``(starts, ends)`` on the host's clock, with ``tail``
    from each block's last kernel's end to its unit's last read's close
    (``reads``): the clocks' offset is linear from one unit's end to the
    next, and constant over the first unit. All times count from one base,
    in float64."""
    d = ends.max(axis=1) + tail - reads         # device minus host, at each end
    t0 = np.concatenate([[reads[0] - 1.0], reads[:-1]])
    d0 = np.concatenate([[d[0]], d[:-1]])
    rate = ((d - d0) / (reads - t0))[:, None]
    # host + d0 + rate (host - t0) = device
    back = lambda x: (x - d0[:, None] + rate * t0[:, None]) / (1.0 + rate)
    return back(starts), back(ends)


def _phases(host_starts, segments):
    """Each kernel's phase (-1 outside its unit), by its start on the host's
    clock; ``segments`` a unit's ``(starts, ends, phases)``."""
    out = np.full(host_starts.shape, -1, dtype=np.int64)
    for i, (seg0, seg1, ids) in enumerate(segments):
        j = np.searchsorted(seg0, host_starts[i], side='right') - 1
        ok = (j >= 0) & (host_starts[i] < seg1[np.clip(j, 0, None)])
        out[i, ok] = ids[j[ok]]
    return out


def _vote(phases, n_names):
    """``(each place's phase, the share of kernels that agree with it)``."""
    tally = np.stack([(phases == p).sum(axis=0) for p in range(-1, n_names)])
    return tally.argmax(axis=0) - 1, tally.max(axis=0).sum() / phases.size


def _fit(kernels, first, k, units, names):
    """``(agreement, each place's phase, host starts, host ends)`` of the
    blocks of ``k`` kernels from ``first``, one a unit of ``units``, under
    the tail on which their phases agree most."""
    base = units[0].start
    rows = kernels[first:first + k * len(units)]
    shape = (len(units), k)
    starts = np.asarray([s - base for _, s, _ in rows], dtype=np.float64).reshape(shape)
    ends = np.asarray([e - base for _, _, e in rows], dtype=np.float64).reshape(shape)
    reads = np.asarray([u.read - base for u in units], dtype=np.float64)
    segments = [(np.asarray([s[0] - base for s in u.segments], dtype=np.float64),
                 np.asarray([s[1] - base for s in u.segments], dtype=np.float64),
                 np.asarray([names[s[2]] for s in u.segments])) for u in units]

    def agreement(tail):
        return _vote(_phases(_on_host(starts, ends, reads, tail)[0], segments), len(names))

    def middle(tails):
        """The middle of the run of ``tails`` under which they agree most."""
        score = [agreement(t)[1] for t in tails]
        i = j = score.index(max(score))
        while j + 1 < len(tails) and score[j + 1] == score[i]:
            j += 1
        return tails[(i + j) // 2]

    coarse = middle(list(TAILS_NS))
    tail = middle([t for t in range(coarse - TAIL_STEP_NS, coarse + TAIL_STEP_NS + 1,
                                    FINE_STEP_NS) if t >= 0])
    place, agree = agreement(tail)
    host_starts, host_ends = _on_host(starts, ends, reads, tail)
    return agree, place, host_starts + base, host_ends + base


def split(trace, entries, dropped, kind) -> Split | None:
    """The :class:`Split` of a trace's window by the ring's ``entries`` (and
    its count of ``dropped`` entries), for ``kind`` ``TRAIN`` or ``EVAL``."""
    if trace is None or WINDOW not in trace.spans or not trace.kernels or not entries:
        return None
    w0, w1 = trace.spans[WINDOW][0]
    # The ring lets go of its oldest entries first: where it let any go, the
    # window is whole only if its oldest kept entry closed before the window.
    if dropped and _closed_at(entries[0]) >= w0:
        return None
    outer = UNIT[kind]
    spans = [(e.t0_ns, e.t1_ns, e.name) for e in entries if _is_span(e)]
    kernels = sorted(trace.kernels, key=lambda x: x[1])
    best = None
    for first, k, units in _alignments(kernels, _units(spans, outer, w0, w1)):
        if len(units) < MIN_UNITS:
            continue
        names = {}
        for u in units:
            for s in u.segments:
                names.setdefault(s[2], len(names))
        fit = _fit(kernels, first, k, units, names)
        if best is None or fit[0] > best[0][0]:
            best = (fit, first, k, units, names)
    if best is None:
        return None
    (agree, place, host_starts, host_ends), first, k, units, names = best
    if agree < AGREE or (place < 0).any():
        return None
    n = len(units)
    # Card time by place: each place's kernels, in every unit, to its phase.
    by_place = np.asarray([e - s for _, s, e in kernels[first:first + k * n]],
                          dtype=np.float64).reshape(n, k).sum(axis=0)
    device = {name: float(by_place[place == i].sum()) for name, i in names.items()}
    # Idle: the segments' time outside the merged kernels' intervals.
    busy = _merge([[s, e] for s, e in zip(host_starts.ravel(), host_ends.ravel())])
    idle = {}
    j = 0
    for a, b, name in (s for u in units for s in u.segments):
        free = b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        q = j
        while q < len(busy) and busy[q][0] < b:
            free -= min(b, busy[q][1]) - max(a, busy[q][0])
            q += 1
        idle[name] = idle.get(name, 0) + free
    counts = {}
    bounds = [u.start for u in units]
    for e in entries:
        if not _is_span(e):
            i = bisect.bisect_right(bounds, e.t_ns) - 1
            if i >= 0 and e.t_ns <= units[i].end:
                counts[e.name] = counts.get(e.name, 0) + e.n
    return Split(units=n, device_ms={k: v / 1e6 / n for k, v in device.items()},
                 idle_ms={k: v / 1e6 / n for k, v in idle.items()},
                 counts={k: v / n for k, v in counts.items()})


def window_split(ctx, kind) -> Split | None:
    """``split`` of the run's trace by the program's ring, computed once a
    run: kept in ``ctx``, which the run's readers share."""
    key = f'_program_spans.{kind}'
    if key not in ctx:
        ring = program_ring()
        ctx[key] = None if ring is None else split(ctx.get('trace'), *ring, kind)
    return ctx[key]


def device_ms(ctx, kind, span):
    s = window_split(ctx, kind)
    return None if s is None else s.device_ms.get(span)


def idle_ms(ctx, kind, span):
    s = window_split(ctx, kind)
    return None if s is None else s.idle_ms.get(span)


def count(ctx, kind, name):
    s = window_split(ctx, kind)
    return None if s is None else s.counts.get(name)
