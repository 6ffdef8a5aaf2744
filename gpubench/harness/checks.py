"""The numbers that decide ``correct``, and the seeded sample of answers they
are taken from.

Every check is a gap between what the program produced and what the plain
reference under ``gpubench/reference/`` computes from the same inputs; a run
is correct when every gap is at or under its limit. Each number is printed
beside its limit (``report``)."""

from __future__ import annotations

import random
import sys
from dataclasses import dataclass

import numpy as np


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return self.value <= self.limit


def report(checks, stream=None) -> None:
    """One line a number, last on standard error."""
    stream = sys.stderr if stream is None else stream
    for c in checks:
        print(f'check {c.name} {c.value!r} limit {c.limit!r} '
              f'{"ok" if c.passed else "FAILED"}', file=stream, flush=True)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (reservoir sampling): the answers of a window whose length is not known
    in advance, kept without holding all of them."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item

    def sample(self) -> list:
        return list(self.items)


def rel_gaps(prog, want):
    """Per row, the largest gap between ``prog`` and ``want`` over the row's
    columns, each against the larger of the reference's magnitude and 1; a
    value that is not finite reads infinite."""
    p = np.asarray(prog, np.float64)
    w = np.asarray(want, np.float64)
    gap = np.abs(p - w) / np.maximum(np.abs(w), 1.0)
    gap = np.where(np.isfinite(gap), gap, np.inf)
    return gap.reshape(gap.shape[0], -1).max(axis=1) if gap.ndim > 1 else gap


def share(mask) -> float:
    """The share of rows where ``mask`` holds (0 for no rows)."""
    mask = np.asarray(mask, bool)
    return float(mask.mean()) if mask.size else 0.0


# A rollout's row (one env's answers) is mismatched when a count differs from
# the reference's, or its reward sum or final state parts from it by more
# than these (``rel_gaps``). They lie ten times above what the float64 witness
# moves all but a few rows in a thousand, and the reward's at about a fifth of
# one step's reward (at most 1) over a row's largest sum (one reward a step,
# 4,096 steps). The limit on the share of such rows lies between the float64
# witness's readings and the bfloat16 control's; the readings are in PERF.md.
REWARD_TOL = 5e-5
STATE_TOL = 1e-3
ROW_MISMATCH_LIMIT = 0.1


def row_mismatch(counts, reward_gap, state_gap=None) -> Check:
    """The rollouts' check: the share of rows whose counts differ, or whose
    reward sum or final state parts from the reference's by more than the
    tolerances."""
    bad = np.asarray(counts, bool) | (np.asarray(reward_gap) > REWARD_TOL)
    if state_gap is not None:
        bad = bad | (np.asarray(state_gap) > STATE_TOL)
    return Check('row_mismatch_share', share(bad), ROW_MISMATCH_LIMIT)
