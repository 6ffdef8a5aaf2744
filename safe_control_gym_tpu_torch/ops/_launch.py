"""Argument checks and launch shapes shared by the kernel wrappers."""

from __future__ import annotations

import torch

__all__ = ['check_tensor', 'block_size']


def check_tensor(t, name: str, shape, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f'{name}: expected a torch.Tensor, got {type(t).__name__}')
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != torch.float32:
        raise TypeError(f'{name}: dtype {t.dtype}, expected torch.float32')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')


def block_size(n: int, device: torch.device) -> int:
    """Threads a block for one-thread-per-element kernels: the largest power of
    two in [32, 256] that still gives every SM a block, else 32."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    threads = 256
    while threads > 32 and (n + threads - 1) // threads < n_sm:
        threads //= 2
    return threads
