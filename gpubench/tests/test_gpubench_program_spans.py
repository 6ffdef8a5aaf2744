"""The card's time and idle time put down to the program's spans
(``harness/program_spans.py``), on made-up traces and rings: innermost-span
attribution, whole units only, kernels outside the window left out, a device
clock that drifts from the host's, and None where there is nothing to
read."""

import time
from collections import deque

import pytest

from gpubench.harness import core, program_spans
from gpubench.harness.program_spans import EVAL, TRAIN, split
from gpubench.harness.tracing import TraceSummary
from safe_control_gym_tpu_torch.utils.profiling import Count, Span

MS = 1_000_000
SPAN_LAYER = [m['name'] for m in core.benchmark()['per_layer'] if m['source'] == 'program_span']

# One iteration's spans, in ms from its start at the host's usual pace.
ITERATION = [(2, 4, 'env.step_autoreset'), (6, 8, 'env.step_autoreset'),
             (9, 10, 'ppo.returns'), (1, 10, 'ppo.rollout'),
             (13, 14, 'ppo.update.optim'), (11, 15, 'ppo.update.grad'),
             (11, 18, 'ppo.update'), (19, 20, 'ppo.read'), (0, 20, 'ppo.iteration')]
# Its kernels as launched, (name, start, end) in ms from its start, each well
# inside the span that launched it; the last ends before the read's close.
KERNELS = [('norm', 0.4, 0.6),                          # the iteration's own time
           ('norm', 1.4, 1.6), ('norm', 4.9, 5.1),      # the rollout's own time
           ('step', 2.9, 3.1), ('step', 6.9, 7.1),      # the steps
           ('gae', 9.4, 9.6),                           # the returns
           ('mm', 11.4, 11.6), ('mm', 14.4, 14.6),      # grad, on each side of optim
           ('adam', 13.4, 13.6),                        # optim
           ('mean', 16.4, 16.6),                        # the update's own time
           ('read', 19.3, 19.5)]                        # the read
# The host's pace of each iteration: no two alike.
PACES = (1.0, 1.1, 0.95, 1.05, 0.9, 1.15)


def _train(n, t0=1.0, drift=lambda t: 0.0, paces=PACES, window=None, kernels=KERNELS):
    """``(trace, ring)`` of ``n`` iterations from ``t0`` ms, 1 ms apart, each
    at its pace; a kernel's times on the device's clock are the host's plus
    ``drift(t)`` ms."""
    ring, rows, t = [], [], t0
    for i in range(n):
        s = paces[i % len(paces)]
        ring += [Span(name, round((t + a * s) * MS), round((t + b * s) * MS))
                 for a, b, name in ITERATION]
        ring.insert(len(ring) - 2, Count('host_reads', round((t + 19.6 * s) * MS), 1))
        for name, a, b in kernels:
            h0, h1 = t + a * s, t + b * s
            rows.append((name, round((h0 + drift(h0)) * MS), round((h1 + drift(h0)) * MS)))
        t += 20 * s + 1.0
    window = window or (0, round((t + 1.0) * MS))
    return TraceSummary(window_s=(window[1] - window[0]) / 1e9, busy_s=0.0, kernels=rows,
                        spans={'window': [window]}), ring


def _own_time(n, paces=PACES):
    """Each phase's own time and card time over ``n`` iterations at
    ``paces``, from ``ITERATION`` and ``KERNELS``, in ms a unit."""
    own = {'ppo.iteration': 20 - 9 - 7 - 1, 'ppo.rollout': 9 - 2 * 2 - 1,
           'env.step_autoreset': 4, 'ppo.returns': 1, 'ppo.update': 7 - 4,
           'ppo.update.grad': 4 - 1, 'ppo.update.optim': 1, 'ppo.read': 1}
    card = {'ppo.iteration': 1, 'ppo.rollout': 2, 'env.step_autoreset': 2, 'ppo.returns': 1,
            'ppo.update.grad': 2, 'ppo.update.optim': 1, 'ppo.update': 1, 'ppo.read': 1}
    pace = sum(paces[i % len(paces)] for i in range(n)) / n
    device = {k: 0.2 * v * pace for k, v in card.items()}
    idle = {k: v * pace - device[k] for k, v in own.items()}
    return device, idle


def test_innermost_span_takes_each_moment():
    s = split(*_train(6), 0, TRAIN)
    assert s.units == 6
    device, idle = _own_time(6)
    assert s.device_ms == pytest.approx(device, rel=1e-9)
    # Idle time is counted on the host's clock, where the units' kernels were
    # put with their tails' spread: within a thousandth.
    assert s.idle_ms == pytest.approx(idle, rel=1e-3)
    # Card time and idle time together are the units' wall time.
    total = sum(s.device_ms.values()) + sum(s.idle_ms.values())
    assert total == pytest.approx(20 * sum(PACES) / 6, rel=1e-3)
    assert s.counts == {'host_reads': 1}


def test_whole_units_only():
    """Iterations that began before the window or end past it are left
    out; the card ran none of their kernels inside it."""
    trace, ring = _train(8)
    its = sorted((sp.t0_ns, sp.t1_ns) for sp in ring if sp.name == 'ppo.iteration')
    window = (its[0][1] - MS // 4, its[-1][0] + MS // 4)
    w0, w1 = window
    kernels = [(n, max(a, w0), min(b, w1)) for n, a, b in trace.kernels if b > w0 and a < w1]
    cut = TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=0.0, kernels=kernels,
                       spans={'window': [window]})
    s = split(cut, ring, 0, TRAIN)
    assert s.units == 6
    device, _ = _own_time(6, PACES[1:] + PACES[:1])
    assert s.device_ms == pytest.approx(device, rel=1e-9)
    assert s.counts == {'host_reads': 1}


@pytest.mark.parametrize('edge', ['first', 'last'])
def test_kernels_outside_the_window_are_left_out(edge):
    """Where the device's clock puts some of the first or the last unit's
    kernels outside the window, or the window holds the end of a kernel
    launched before it, the blocks still fall into place and the cut unit is
    left out."""
    trace, ring = _train(6)
    w0, w1 = trace.spans['window'][0]
    kernels = list(trace.kernels)
    if edge == 'first':
        kernels = [('set-up', w0, kernels[0][1] - MS)] + kernels[3:]
    else:
        kernels = kernels[:-3]
    s = split(TraceSummary(trace.window_s, 0.0, kernels=kernels, spans=trace.spans), ring, 0,
              TRAIN)
    assert s.units == 5
    paces = PACES[1:6] if edge == 'first' else PACES[:5]
    assert s.device_ms == pytest.approx(_own_time(5, paces)[0], rel=1e-9)


@pytest.mark.parametrize('drift', ['steady', 'jump', 'steady and jump'])
def test_a_window_whose_clocks_parted_splits_as_one_whose_clocks_held(drift):
    """The trace's device clock drifts from the host's (on the H100, by up to
    milliseconds in a window, steadily or in jumps). Card time is counted by
    each kernel's place in its unit, so the split is the held clock's; where
    the clock jumps inside a unit, only idle time moves, a little."""
    jump = lambda t: -1.0 if t > 75.0 else 0.0      # inside the fourth iteration
    steady = lambda t: -5e-3 * t                    # 0.5%, faster than seen
    f = {'steady': steady, 'jump': jump, 'steady and jump': lambda t: steady(t) + jump(t)}
    held = split(*_train(10), 0, TRAIN)
    parted = split(*_train(10, drift=f[drift]), 0, TRAIN)
    assert parted.units == held.units
    assert parted.device_ms == pytest.approx(held.device_ms, rel=1e-9)
    assert parted.idle_ms == pytest.approx(held.idle_ms, rel=0.05)
    assert parted.counts == held.counts


def test_an_eval_unit_is_a_fused_eval_span():
    at = lambda a, b, name: Span(name, round(a * MS), round(b * MS))

    def call(t, s):
        return [at(t, t + 1 * s, 'fused_eval.prep'), at(t + 1 * s, t + 2 * s, 'fused_eval.prep'),
                at(t + 2 * s, t + 3 * s, 'fused_eval.launch'),
                Count('host_reads', round((t + 12.2 * s) * MS), 2),
                at(t + 3 * s, t + 12.3 * s, 'fused_eval.read'),
                at(t + 12.3 * s, t + 13 * s, 'fused_eval.read'),
                at(t + 13 * s, t + 14 * s, 'fused_eval.launch'),
                at(t + 14 * s, t + 23.3 * s, 'fused_eval.read'),
                at(t, t + 23.3 * s, 'fused_eval')]
    ring, kernels, t = [], [], 5.0
    for i in range(5):
        s = PACES[i]
        ring += call(t, s)
        kernels += [('draw', t + 1.4 * s, t + 1.6 * s), ('rollout', t + 2.5 * s, t + 12 * s),
                    ('rollout', t + 13.5 * s, t + 23 * s)]
        t += 23.3 * s + 2.0
    trace = TraceSummary(window_s=0.2, busy_s=0.0,
                         kernels=[(n, round(a * MS), round(b * MS)) for n, a, b in kernels],
                         spans={'window': [(0, round((t + 5) * MS))]})
    s = split(trace, ring, 0, EVAL)
    assert s.units == 5
    pace = sum(PACES[:5]) / 5
    assert s.device_ms['fused_eval.prep'] == pytest.approx(0.2 * pace)
    assert s.device_ms['fused_eval.launch'] == pytest.approx(19.0 * pace)
    assert s.idle_ms['fused_eval.prep'] == pytest.approx(1.8 * pace, rel=0.05)
    # Idle time follows the tail taken (the reads end 0.3 ms after their
    # kernels here): within a tenth.
    assert s.idle_ms['fused_eval.read'] == pytest.approx(0.3 * pace + 0.7 * pace + 0.3 * pace,
                                                         rel=0.1)
    assert s.counts == {'host_reads': 2}


def test_nothing_to_read():
    trace, ring = _train(4)
    assert split(trace, [], 0, TRAIN) is None
    assert split(TraceSummary(0.1, 0.0, kernels=[], spans=trace.spans), ring, 0, TRAIN) is None
    assert split(trace, ring, 0, EVAL) is None
    # Fewer whole units than vote.
    assert split(*_train(program_spans.MIN_UNITS - 1), 0, TRAIN) is None
    # Entries let go inside the window: the ring's oldest kept entry closed
    # inside it.
    assert split(trace, ring[3:], 3, TRAIN) is None
    # Entries let go before the window: what is left is whole.
    before = [Span('ppo.iteration', -30 * MS, -10 * MS)]
    assert split(trace, before + ring, 12, TRAIN).units == 4


def test_blocks_that_do_not_repeat_read_none():
    """A unit that launched other kernels than the rest: the window's
    kernels have no unit's period, so no place has a phase."""
    trace, ring = _train(4)
    kernels = list(trace.kernels)
    for i in range(len(KERNELS), 2 * len(KERNELS)):
        kernels[i] = (f'other {i}', *kernels[i][1:])
    odd = TraceSummary(trace.window_s, 0.0, kernels=kernels, spans=trace.spans)
    assert split(odd, ring, 0, TRAIN) is None


def test_readers_read_the_programs_ring(monkeypatch):
    from safe_control_gym_tpu_torch.utils import profiling
    trace, ring = _train(4)
    monkeypatch.setattr(profiling, 'events', deque(ring, maxlen=1024))
    monkeypatch.setattr(profiling, 'dropped', 0)
    ctx = {'trace': trace, 'counts': {}}
    read = lambda name, ctx=ctx: core.load_module('metrics', name).read(ctx)
    device, idle = _own_time(4)
    assert read('device_ms.env.step_autoreset') == pytest.approx(device['env.step_autoreset'])
    assert read('device_ms.ppo.update.grad') == pytest.approx(device['ppo.update.grad'])
    assert read('idle_ms.ppo.update.optim') == pytest.approx(idle['ppo.update.optim'], rel=1e-3)
    assert read('host_reads.ppo.iteration') == 1
    assert read('idle_ms.fused_eval.prep') is None
    # A program that keeps no ring, as one older than its spans.
    monkeypatch.delattr(profiling, 'events')
    assert read('device_ms.env.step_autoreset', {'trace': trace}) is None


def test_a_large_window_splits_fast():
    """A traced window of the train cell holds about 70,000 kernels, 9,206
    an iteration."""
    many = [('k%d' % (j % 40), 1.0 + j * 2e-3, 1.0 + j * 2e-3 + 1e-3) for j in range(9_000)]
    t0 = time.perf_counter()
    s = split(*_train(8, kernels=many, paces=(1.0,)), 0, TRAIN)
    assert s.units == 8 and time.perf_counter() - t0 < 10.0


@pytest.mark.parametrize('metric', SPAN_LAYER)
def test_program_span_reader_without_the_programs_spans(metric, monkeypatch):
    """A program older than its spans keeps no ring: the reader of a traced
    window with kernels in it reads None, not 0."""
    monkeypatch.setattr(program_spans, 'program_ring', lambda: None)
    tr = _train(4)[0]
    assert core.load_module('metrics', metric).read({'trace': tr, 'counts': {}}) is None
