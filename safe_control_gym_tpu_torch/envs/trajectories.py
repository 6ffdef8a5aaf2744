"""Reference-trajectory generation (figure8 / circle / square), numpy only.

A copy of ``safe_control_gym_tpu/envs/trajectories.py``: the port keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ['generate_trajectory']

_DIRECTIONS = ['x', 'y', 'z']


def _figure8(t, period, scaling):
    w = 2.0 * np.pi / period
    a = scaling * np.sin(w * t)
    b = scaling * np.sin(w * t) * np.cos(w * t)
    a_dot = scaling * w * np.cos(w * t)
    b_dot = scaling * w * (np.cos(w * t) ** 2 - np.sin(w * t) ** 2)
    return a, b, a_dot, b_dot


def _circle(t, period, scaling):
    w = 2.0 * np.pi / period
    return (scaling * np.cos(w * t), scaling * np.sin(w * t),
            -scaling * w * np.sin(w * t), scaling * w * np.cos(w * t))


def _square(t, period, scaling):
    # Four segments per cycle traversed at constant speed
    # (benchmark_env.py:661-713).
    segment_period = period / 4.0
    speed = scaling / segment_period
    cycle_time = np.mod(t, period)
    segment_time = np.mod(cycle_time, segment_period)
    segment_index = np.floor(cycle_time / segment_period).astype(int)
    s = speed * segment_time
    a = np.select(
        [segment_index == 0, segment_index == 1, segment_index == 2, segment_index == 3],
        [np.zeros_like(s), -s, -scaling * np.ones_like(s), -scaling + s])
    b = np.select(
        [segment_index == 0, segment_index == 1, segment_index == 2, segment_index == 3],
        [s, scaling * np.ones_like(s), scaling - s, np.zeros_like(s)])
    a_dot = np.select(
        [segment_index == 0, segment_index == 1, segment_index == 2, segment_index == 3],
        [np.zeros_like(s), -speed * np.ones_like(s), np.zeros_like(s), speed * np.ones_like(s)])
    b_dot = np.select(
        [segment_index == 0, segment_index == 1, segment_index == 2, segment_index == 3],
        [speed * np.ones_like(s), np.zeros_like(s), -speed * np.ones_like(s), np.zeros_like(s)])
    return a, b, a_dot, b_dot


_SHAPES = {'figure8': _figure8, 'circle': _circle, 'square': _square}


def generate_trajectory(traj_type='figure8',
                        traj_length=10.0,
                        num_cycles=1,
                        traj_plane='xy',
                        position_offset=(0, 0),
                        scaling=1.0,
                        sample_time=0.01):
    """Sample a planar trajectory embedded in 3-D.

    Returns (pos_ref, vel_ref, speed) with shapes (T, 3), (T, 3), (T, 1),
    where T = traj_length/sample_time + 1 — one extra sample so the
    reference is one step longer than the episode (benchmark_env.py:543).
    """
    if traj_type not in _SHAPES:
        raise ValueError('Trajectory type should be one of [circle, square, figure8].')
    period = traj_length / num_cycles
    if (len(traj_plane) != 2 or traj_plane[0] not in _DIRECTIONS
            or traj_plane[1] not in _DIRECTIONS or traj_plane[0] == traj_plane[1]):
        raise ValueError('Trajectory plane should be in form of ab, with a, b in {x, y, z}.')
    ia = _DIRECTIONS.index(traj_plane[0])
    ib = _DIRECTIONS.index(traj_plane[1])
    times = np.arange(0, traj_length + sample_time, sample_time)
    a, b, a_dot, b_dot = _SHAPES[traj_type](times, period, scaling)
    T = len(times)
    pos = np.zeros((T, 3))
    vel = np.zeros((T, 3))
    pos[:, ia] = a + position_offset[0]
    pos[:, ib] = b + position_offset[1]
    vel[:, ia] = a_dot
    vel[:, ib] = b_dot
    speed = np.linalg.norm(vel, axis=1, keepdims=True)
    return pos, vel, speed
