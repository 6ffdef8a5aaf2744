"""The replay ring of the off-policy learners, on the device.

Port of ``safe_control_gym_tpu/controllers/off_policy_utils.py``: a dict of
preallocated (max_size, dim) float32 tensors with a write pointer and a
count of rows pushed, so that pushing and sampling stay on the device. CBF-NN
trains from it now; SAC and DDPG training (ROADMAP item 9) reuse it.

    state = replay_init({'obs': 4, 'act': 1}, max_size=1000, device='cuda')
    state = replay_push(state, {'obs': obs, 'act': act})   # N rows each
    batch = replay_sample(state, torch.Generator('cuda').manual_seed(0), 64)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from safe_control_gym_tpu_torch.utils.device import resolve_device

__all__ = ['ReplayState', 'replay_init', 'replay_push', 'replay_sample']


@dataclass
class ReplayState:
    data: Dict[str, torch.Tensor]   # each (max_size, dim)
    ptr: torch.Tensor               # int64, the next row to write
    count: torch.Tensor             # int64, rows pushed (may exceed max_size)


def replay_init(specs: Dict[str, int], max_size: int, device='cuda') -> ReplayState:
    """An empty ring of ``max_size`` rows; ``specs`` maps a name to its width."""
    dev = resolve_device(device)
    data = {k: torch.zeros((int(max_size), d), device=dev) for k, d in specs.items()}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return ReplayState(data=data, ptr=zero, count=zero.clone())


def replay_push(state: ReplayState, batch: Dict[str, torch.Tensor]) -> ReplayState:
    """A new state with the N rows of ``batch`` written at the pointer (ring
    order); the input state is left as it was."""
    n = next(iter(batch.values())).shape[0]
    max_size = next(iter(state.data.values())).shape[0]
    idx = (state.ptr + torch.arange(n, device=state.ptr.device)) % max_size
    data = {k: v.index_copy(0, idx, batch[k].reshape(n, -1).to(v))
            for k, v in state.data.items()}
    return ReplayState(data=data, ptr=(state.ptr + n) % max_size, count=state.count + n)


def replay_sample(state: ReplayState, gen: torch.Generator, batch_size: int
                  ) -> Dict[str, torch.Tensor]:
    """``batch_size`` rows drawn uniformly, with replacement, from the filled
    part, from ``gen`` (on the ring's device), with no read to the host."""
    max_size = next(iter(state.data.values())).shape[0]
    filled = torch.clamp(state.count, min=1, max=max_size)
    u = torch.rand((batch_size,), generator=gen, device=state.ptr.device)
    idx = torch.minimum((u * filled).long(), filled - 1)
    return {k: v[idx] for k, v in state.data.items()}
