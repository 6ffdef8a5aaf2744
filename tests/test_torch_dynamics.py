"""The port's math and dynamics against the JAX package, on random batches made
with numpy: atol 1e-6 (float32 on both sides, the same formulas), plus rtol
1e-6 for the accelerations, whose magnitudes reach ~30 where a float32 ulp is
~2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.envs import dynamics as jdyn
from safe_control_gym_tpu.envs import trajectories as jtraj
from safe_control_gym_tpu.math import linalg as jlinalg
from safe_control_gym_tpu.math import rotations as jrot
from safe_control_gym_tpu_torch.envs import dynamics as tdyn
from safe_control_gym_tpu_torch.envs import trajectories as ttraj
from safe_control_gym_tpu_torch.math import linalg as tlinalg
from safe_control_gym_tpu_torch.math import rotations as trot

ATOL = 1e-6


def _np(x):
    return np.asarray(x)


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def test_normalize_angle_floor_semantics_for_negative_angles():
    rng = np.random.default_rng(0)
    th = np.concatenate([rng.uniform(-20, 20, 256),
                         [-np.pi, np.pi, -3 * np.pi, -7.0, -0.1, 0.0]]).astype(np.float32)
    got = trot.normalize_angle(torch.as_tensor(th))
    _close(got, jrot.normalize_angle(jnp.asarray(th)))
    assert float(got.min()) >= -np.pi - 1e-6 and float(got.max()) < np.pi + 1e-6


@pytest.mark.parametrize('name', ['rot_x', 'rot_y', 'rot_z'])
def test_single_axis_rotations(name):
    a = np.random.default_rng(1).uniform(-4, 4, 64).astype(np.float32)
    _close(getattr(trot, name)(torch.as_tensor(a)),
           jax.vmap(getattr(jrot, name))(jnp.asarray(a)))


def test_rotations_quaternions_projection():
    rng = np.random.default_rng(2)
    rpy = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    t, j = torch.as_tensor(rpy), jnp.asarray(rpy)
    _close(trot.rot_xyz(t[:, 0], t[:, 1], t[:, 2]),
           jax.vmap(jrot.rot_xyz)(j[:, 0], j[:, 1], j[:, 2]))
    q = trot.euler_to_quat(t)
    _close(q, jax.vmap(jrot.euler_to_quat)(j))
    _close(trot.quat_to_rot(q), jax.vmap(jrot.quat_to_rot)(jnp.asarray(q.numpy())))
    _close(trot.quat_to_euler(q), jax.vmap(jrot.quat_to_euler)(jnp.asarray(q.numpy())))
    _close(trot.skew(t), jax.vmap(jrot.skew)(j))
    for normal in ([0, 1, 1], [1, 0, 0], [0.2, -0.3, 0.9]):
        _close(trot.projection_matrix(torch.tensor(normal, dtype=torch.float32)),
               jrot.projection_matrix(jnp.asarray(normal, jnp.float32)))
    pos = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    vel = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    info = {'point': [0, 0, 0.5], 'normal': [0, 1, 1]}
    for a, b in zip(trot.transform_trajectory(torch.as_tensor(pos), torch.as_tensor(vel), info),
                    jrot.transform_trajectory(jnp.asarray(pos), jnp.asarray(vel), info)):
        _close(a, b)


def test_cost_weight_matrix_and_trajectories():
    for w, dim in ([1.0], 4), ([1, 2, 3, 4], 4), (None, 2), ([0.1], 1):
        np.testing.assert_array_equal(tlinalg.get_cost_weight_matrix(w, dim),
                                      jlinalg.get_cost_weight_matrix(w, dim))
    with pytest.raises(ValueError):
        tlinalg.get_cost_weight_matrix([1, 2], 3)
    for kind in ('figure8', 'circle', 'square'):
        kw = dict(traj_type=kind, traj_length=5.0, num_cycles=2, traj_plane='zx',
                  position_offset=(0.5, 0), scaling=0.7, sample_time=0.02)
        for a, b in zip(ttraj.generate_trajectory(**kw), jtraj.generate_trajectory(**kw)):
            np.testing.assert_array_equal(a, b)


def _batch(seed, n=128):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    x[:, 2] = rng.uniform(-4, 4, n)
    u = rng.uniform(-10, 10, (n, 1)).astype(np.float32)
    tab = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    return x, u, tab


def test_cartpole_dynamics_match_jax():
    x, u, tab = _batch(3)
    tp, jp = tdyn.CartPoleParams(), jdyn.CartPoleParams()
    _close(tdyn.cartpole_dynamics(torch.as_tensor(x), torch.as_tensor(u), tp),
           jax.vmap(lambda a, b: jdyn.cartpole_dynamics(a, b, jp))(x, u), rtol=1e-6)
    forced_t = tdyn.cartpole_dynamics_forced(torch.as_tensor(x), torch.as_tensor(u),
                                             torch.as_tensor(tab), tp)
    forced_j = jax.vmap(lambda a, b, c: jdyn.cartpole_dynamics_forced(a, b, c, jp))(x, u, tab)
    _close(forced_t, forced_j, rtol=1e-6)
    # The tab force at zero reduces the forced form to the plain one.
    zero = torch.zeros((x.shape[0], 2))
    _close(tdyn.cartpole_dynamics_forced(torch.as_tensor(x), torch.as_tensor(u), zero, tp),
           tdyn.cartpole_dynamics(torch.as_tensor(x), torch.as_tensor(u), tp), rtol=1e-6)


def test_integrators_match_jax():
    x, u, _ = _batch(4)
    tp, jp = tdyn.CartPoleParams(), jdyn.CartPoleParams()
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    dt = 0.02
    jf = jdyn.cartpole_dynamics
    _close(tdyn.rk4_step(tdyn.cartpole_dynamics, xt, ut, dt, tp),
           jax.vmap(lambda a, b: jdyn.rk4_step(jf, a, b, dt, jp))(x, u))
    _close(tdyn.euler_step(tdyn.cartpole_dynamics, xt, ut, dt, tp),
           jax.vmap(lambda a, b: jdyn.euler_step(jf, a, b, dt, jp))(x, u))
    vel, pos = [1, 3], [0, 2]
    sym_t = lambda a, b: tdyn.symplectic_euler_step(tdyn.cartpole_dynamics, a, b, 1e-3,
                                                    tp, vel, pos)
    sym_j = lambda a, b: jdyn.symplectic_euler_step(jf, a, b, 1e-3, jp,
                                                    jnp.array(vel), jnp.array(pos))
    _close(sym_t(xt, ut), jax.vmap(sym_j)(x, u))
    _close(tdyn.integrate_substeps(sym_t, xt, ut, 20),
           jax.vmap(lambda a, b: jdyn.integrate_substeps(sym_j, a, b, 20))(x, u))


def test_params_vector_layout():
    p = tdyn.CartPoleParams()
    np.testing.assert_allclose(p.vector().numpy(), [0.1, 1.0, 0.5, 9.8], rtol=1e-7)
