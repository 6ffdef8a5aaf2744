"""The card a run measures: found, or the run fails. There is no CPU fallback."""

from __future__ import annotations


class NoDevice(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def require_cuda(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice('no CUDA device: the benchmark measures the card and has no CPU path')
    n = torch.cuda.device_count()
    if n < chips:
        raise NoDevice(f'the cell asks for {chips} CUDA devices, this machine has {n}')
    return torch.device('cuda:0')


def describe(device, chips: int, peak_bytes: int, trace=None) -> dict:
    import torch
    out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': chips,
           'memory_peak_bytes': int(peak_bytes)}
    if trace is not None:
        out['busy_s'] = trace.busy_s
        out['window_s'] = trace.window_s
    return out
