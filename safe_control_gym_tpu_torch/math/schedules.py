"""Parameter schedules: a constant, and a linear ramp advanced by step counts.

Port of ``safe_control_gym_tpu/math/schedules.py``. A schedule is called with
the number of steps taken since the last call and returns the value it held
before them; ``LinearSchedule`` then moves by ``inc * steps`` and stops at
``end``. DDPG's exploration std advances this way once an iteration.

    std = LinearSchedule(0.2, 0.05, 10000)
    std(100)   # 0.2; the next call returns 0.2 - 100 * 1.5e-5
"""

from __future__ import annotations

__all__ = ['ConstantSchedule', 'LinearSchedule']


class ConstantSchedule:
    def __init__(self, val):
        self.val = val

    def __call__(self, steps=1):
        return self.val


class LinearSchedule:
    """Linear interpolation from ``start`` to ``end`` over ``steps`` steps
    (a constant ``start`` without ``end``)."""

    def __init__(self, start, end=None, steps=None):
        if end is None:
            end = start
            steps = 1
        self.inc = (end - start) / float(steps)
        self.current = start
        self.end = end
        self.bound = min if end > start else max

    def __call__(self, steps=1):
        val = self.current
        self.current = self.bound(self.current + self.inc * steps, self.end)
        return val
