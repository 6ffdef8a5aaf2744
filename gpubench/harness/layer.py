"""Arithmetic the per-layer readers share: the published peaks of one H100
SXM (NVIDIA's data sheet, dense, at its 700 W limit) and the shares taken
against them. A reader that finds nothing to read returns None, never 0."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def idle_pct(ctx):
    """The share of the traced window in which no device activity ran."""
    tr = ctx.get('trace')
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(ctx, kernel_key='kernel', ops_key='kernel_ops', bytes_key='kernel_bytes'):
    """max(operations / peak FLOP/s, bytes / peak bytes/s) over the named
    kernel's device time in the trace, in percent."""
    tr, counts = ctx.get('trace'), ctx.get('counts') or {}
    name = counts.get(kernel_key)
    if tr is None or not name or not counts.get(ops_key):
        return None
    seconds = tr.kernel_seconds(lambda n: name in n)
    if seconds <= 0:
        return None
    least = max(counts[ops_key] / PEAK_F32_FLOPS, counts.get(bytes_key, 0) / PEAK_BYTES_PER_S)
    return 100.0 * least / seconds


def mfu_pct(ctx, flops_key='flops', peak=PEAK_F32_FLOPS):
    """Counted FLOPs of the window's whole work over the window's length,
    over the peak, in percent."""
    tr, counts = ctx.get('trace'), ctx.get('counts') or {}
    if tr is None or tr.window_s <= 0 or not counts.get(flops_key):
        return None
    return 100.0 * counts[flops_key] / tr.window_s / peak
