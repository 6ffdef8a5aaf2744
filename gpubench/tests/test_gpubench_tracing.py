"""The reduction of a profiler trace to busy time, kernels, spans, the top
kernels and the idle gaps, on a made-up trace; and the readers' arithmetic."""

import types

import pytest

from gpubench.harness import core, layer
from gpubench.harness.tracing import DeviceBusy, Spans, TraceSummary, device_busy, summarize


def _ev(name, kind, start, dur, annotation=False):
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: f'DeviceType.{kind}',
                                 start_ns=lambda: start, duration_ns=lambda: dur,
                                 is_user_annotation=lambda: annotation)


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_summarize():
    events = [_ev('window', 'CPU', 1000, 10000),
              _ev('learn iteration', 'CPU', 1000, 4000),
              _ev('learn iteration', 'CPU', 5000, 5000),
              _ev('window', 'CUDA', 1000, 10000, annotation=True),
              _ev('gemm', 'CUDA', 1500, 1000),
              _ev('gemm', 'CUDA', 2000, 1000),      # overlaps the first
              _ev('Memcpy HtoD', 'CUDA', 6000, 500),
              _ev('tanh', 'CUDA', 7000, 2500),
              _ev('aten::mm', 'CPU', 1200, 100),
              _ev('late', 'CUDA', 10500, 1000)]      # runs past the window
    s = summarize(_prof(events), {'window', 'learn iteration'})
    assert s.window_s == pytest.approx(10000e-9)
    # gemm 1500-3000, memcpy 6000-6500, tanh 7000-9500, late 10500-11000.
    assert s.busy_s == pytest.approx((1500 + 500 + 2500 + 500) * 1e-9)
    assert [k[0] for k in s.kernels] == ['gemm', 'gemm', 'tanh', 'late']
    assert s.device_ops[0] == ['tanh', pytest.approx(2500e-9)]
    assert s.idle_gaps[0] == ['learn iteration', pytest.approx(3000e-9)]
    assert [round(g[1] * 1e9) for g in s.idle_gaps] == [3000, 1000, 500, 500]
    assert s.kernels_in('learn iteration') == (3, 2)
    assert s.kernel_seconds(lambda n: n == 'gemm') == pytest.approx(2000e-9)


def test_spans_off_cost_nothing():
    spans = Spans(False)
    with spans('rollout launch'):
        pass
    assert 'rollout launch' in spans.names


def test_readers_arithmetic():
    tr = TraceSummary(window_s=2.0, busy_s=1.5, kernels=[('k', 0, 10 ** 9)])
    ctx = {'trace': tr, 'counts': {'kernel': 'k', 'kernel_ops': 67e12 * 0.25,
                                   'kernel_bytes': 0, 'flops': 67e12}}
    assert layer.idle_pct(ctx) == pytest.approx(25.0)
    assert layer.roofline_pct(ctx) == pytest.approx(25.0)
    assert layer.mfu_pct(ctx) == pytest.approx(50.0)
    assert layer.roofline_pct({'trace': tr, 'counts': {'kernel': 'other', 'kernel_ops': 1}}) \
        is None


def test_device_busy():
    events = [_ev('learn iteration', 'CPU', 1000, 4000),
              _ev('window', 'CUDA', 1000, 10000, annotation=True),
              _ev('gemm', 'CUDA', 1500, 1000),
              _ev('gemm', 'CUDA', 2000, 1000),      # overlaps the first
              _ev('Memcpy HtoD', 'CUDA', 6000, 500)]
    busy, kernel, n = device_busy(_prof(events))
    assert busy == pytest.approx((1500 + 500) * 1e-9) and n == 3
    assert kernel == pytest.approx(1500e-9)


def test_device_busy_traces_the_window_in_pieces():
    """A piece ends at the first span's close after ``piece_s``; the window's
    own close ends none, and the last piece ends with the window."""
    from torch.profiler import ProfilerActivity
    spans = Spans(False)
    with DeviceBusy(piece_s=0.0, activities=[ProfilerActivity.CPU]) as busy:
        spans.after = busy.span_closed
        with spans('window'):
            for _ in range(3):
                with spans('learn iteration'):
                    pass
    assert busy.pieces == 4 and busy.busy_s == 0.0
    with DeviceBusy(piece_s=1e9, activities=[ProfilerActivity.CPU]) as busy:
        spans.after = busy.span_closed
        for _ in range(3):
            with spans('learn iteration'):
                pass
    assert busy.pieces == 1


def test_train_readers():
    device_ms = core.load_module('metrics', 'train_device_ms_per_iter')
    assert device_ms.WINDOW_TRACE == 'device'
    assert device_ms.read({'device_busy_s': 0.5, 'counts': {'iterations': 20}}) == \
        pytest.approx(25.0)
    assert device_ms.read({'device_busy_s': None, 'counts': {'iterations': 20}}) is None
    assert device_ms.read({'device_busy_s': 0.5, 'counts': {'iterations': 0}}) is None
    rate = core.load_module('metrics', 'train_env_steps_per_s.traced')
    tr = TraceSummary(window_s=2.0, busy_s=0.1)
    assert rate.read({'trace': tr, 'stats': {'work': 98304 * 4, 'wall_s': 2.0}}) == \
        pytest.approx(196608.0)
    assert rate.read({'trace': None, 'stats': {'work': 1, 'wall_s': 1.0}}) is None
