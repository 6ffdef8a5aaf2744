"""Device selection shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: the default
device is ``'cuda'``, and a missing CUDA device is an error, not a silent
fall back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ['resolve_device', 'require_cuda']


def resolve_device(device='cuda') -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU by "
            "default; pass device='cpu' to run it on the CPU")
    return dev


def require_cuda(device) -> torch.device:
    """Resolve ``device`` and raise unless it is a CUDA device (for
    measurement paths, which never report CPU numbers)."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        raise RuntimeError(f'measurement needs a CUDA device, got {dev}')
    return dev
