"""Every random choice of a run, drawn from its ``--seed``.

``derive(seed, purpose)`` gives a 32-bit integer for one purpose (the
weights, the start states, a launch's Philox key, the sample the check
takes), the same for the same seed on every machine."""

from __future__ import annotations

import random


def derive(seed: int, purpose: str) -> int:
    return random.Random(f'{int(seed)}:{purpose}').getrandbits(32)


def rng(seed: int, purpose: str) -> random.Random:
    return random.Random(f'{int(seed)}:{purpose}')
