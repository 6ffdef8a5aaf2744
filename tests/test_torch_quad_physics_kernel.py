"""K2 and K3 (``ops/physics_kernels.py``) and the quadrotor motor model.

The plain versions against the JAX package, < 1e-5: K2 against its Pallas
kernel in interpret mode (as tests/test_pallas.py runs it) and against
``quad2d_substeps``; K3 against ``quad3d_substeps`` called directly. The motor
model against JAX's ``cmd2pwm`` / ``pwm2rpm`` / ``rpm2forces`` for one, two and
four commands, saturating on both sides. Both plain versions, driven through
the port's ``Quadrotor`` step, against the independent C++ oracle
(native/dynamics_oracle.cpp) to an RMSE of 1e-3, as tests/test_native_oracle.py
holds the JAX env. The CUDA kernels against the plain versions on the card."""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from safe_control_gym_tpu.envs import dynamics as jdyn
from safe_control_gym_tpu_torch.envs import dynamics as tdyn
from safe_control_gym_tpu_torch.ops import physics_kernels as tk
from safe_control_gym_tpu_torch.utils.registration import make as tmake


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


N_SUB, DT = 20, 1e-3
P2D = [0.027, 1.4e-5, 0.0397, 9.8]
P3D = [0.027, 1.4e-5, 1.4e-5, 2.17e-5, 0.0397, 9.8]
HOVER = 0.027 * 9.8 / 4


def _inputs_2d(seed, B=128):
    rng = np.random.default_rng(seed)
    states = np.stack([rng.uniform(-1, 1, B), rng.uniform(-0.5, 0.5, B),
                       rng.uniform(0.5, 1.5, B), rng.uniform(-0.5, 0.5, B),
                       rng.uniform(-1.0, 1.0, B), rng.uniform(-3, 3, B)], axis=1)
    return (states.astype(np.float32),
            rng.uniform(0.05, 0.2, B).astype(np.float32),
            rng.uniform(0.05, 0.2, B).astype(np.float32),
            rng.uniform(-0.01, 0.01, (B, 2)).astype(np.float32),
            np.asarray(P2D, np.float32))


def _inputs_3d(seed, B=128):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-0.5, 0.5, (B, 12))
    states[:, 4] += 1.0
    states[:, 6:9] = rng.uniform(-0.8, 0.8, (B, 3))
    states[:, 9:12] = rng.uniform(-3, 3, (B, 3))
    forces = rng.uniform(0.5, 1.5, (B, 4)) * HOVER
    z_torque = rng.uniform(-1e-6, 1e-6, B)
    dist = rng.uniform(-0.01, 0.01, (B, 3))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(states), f32(forces), f32(z_torque), f32(dist), f32(P3D)


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def test_k2_plain_matches_pallas_kernel_interpreted(monkeypatch):
    import safe_control_gym_tpu.ops.pallas_kernels as pk
    monkeypatch.setattr(pk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    args = _inputs_2d(0)
    ref = pk.quad2d_advance_pallas(*(jnp.asarray(a) for a in args),
                                   n_substeps=N_SUB, dt=DT)
    got = tk.quad2d_advance(*_torch(*args), N_SUB, DT).numpy()
    assert np.abs(got - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize('seed', [1, 2])
def test_k2_plain_matches_jax_substeps(seed):
    from safe_control_gym_tpu.ops.pallas_kernels import quad2d_substeps
    states, t1, t2, dist, params = _inputs_2d(seed)
    ref = quad2d_substeps(*(jnp.asarray(states[:, k]) for k in range(6)),
                          jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(dist[:, 0]),
                          jnp.asarray(dist[:, 1]), *(jnp.float32(p) for p in params),
                          N_SUB, DT)
    got = tk.quad2d_advance(*_torch(states, t1, t2, dist, params), N_SUB, DT).numpy()
    assert np.abs(got - np.stack(ref, 1)).max() < 1e-5


@pytest.mark.parametrize('seed', [3, 4])
def test_k3_plain_matches_jax_substeps(seed):
    """The JAX suite only sanity-checks K3 (tests/test_pallas.py); here the
    plain version is held to ``quad3d_substeps`` itself, on tilted, spinning
    bodies with asymmetric forces, a yaw torque and a world force."""
    from safe_control_gym_tpu.ops.pallas_kernels import quad3d_substeps
    states, forces, zt, dist, params = _inputs_3d(seed)
    col = lambda a, k: jnp.asarray(a[:, k])
    ref = quad3d_substeps(tuple(col(states, k) for k in range(12)),
                          tuple(col(forces, k) for k in range(4)), jnp.asarray(zt),
                          tuple(col(dist, k) for k in range(3)),
                          *(jnp.float32(p) for p in params), N_SUB, DT)
    got = tk.quad3d_advance(*_torch(states, forces, zt, dist, params), N_SUB, DT).numpy()
    assert np.abs(got - np.stack(ref, 1)).max() < 1e-5


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (tk.quad2d_advance.launches, tk.quad3d_advance.launches)
    a2 = _torch(*_inputs_2d(5, B=16))
    a3 = _torch(*_inputs_3d(6, B=16))
    assert torch.equal(tk.quad2d_advance(*a2, N_SUB, DT),
                       tk.quad2d_advance_plain(*a2, N_SUB, DT))
    assert torch.equal(tk.quad3d_advance(*a3, N_SUB, DT),
                       tk.quad3d_advance_plain(*a3, N_SUB, DT))
    assert (tk.quad2d_advance.launches, tk.quad3d_advance.launches) == before


@pytest.mark.parametrize('n', [1, 2, 4])
def test_motor_model_matches_jax(n):
    """Commands from below 0 to beyond the PWM cap, so both clips act."""
    rng = np.random.default_rng(n)
    cap = 4 / n * 3.16e-10 * (0.2685 * 65535 + 4070.3) ** 2
    thrust = rng.uniform(-0.2 * cap, 1.3 * cap, (64, n)).astype(np.float32)
    jp, tp = jdyn.QuadParams(), tdyn.QuadParams()
    jpwm = jax.vmap(lambda u: jdyn.cmd2pwm(u, jp))(jnp.asarray(thrust))
    assert float(jpwm.min()) == 20000.0 and float(jpwm.max()) == 65535.0
    jrpm = jdyn.pwm2rpm(jpwm, jp)
    jf, jz = jax.vmap(lambda r: jdyn.rpm2forces(r, jp))(jrpm)
    tpwm = tdyn.cmd2pwm(torch.as_tensor(thrust), tp)
    trpm = tdyn.pwm2rpm(tpwm, tp)
    tf, tz = tdyn.rpm2forces(trpm, tp)
    np.testing.assert_allclose(tpwm.numpy(), np.asarray(jpwm), rtol=1e-6)
    np.testing.assert_allclose(trpm.numpy(), np.asarray(jrpm), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-12)


def test_quad_params_match_jax():
    jp, tp = jdyn.QuadParams(), tdyn.QuadParams()
    for f in dataclasses.fields(jp):
        assert float(getattr(tp, f.name)) == float(getattr(jp, f.name)), f.name
    assert tp.vector2d().tolist() == np.asarray(P2D, np.float32).tolist()
    assert tp.vector3d().tolist() == np.asarray(P3D, np.float32).tolist()


def _oracle(monkeypatch, tmp_path):
    """The C++ oracle, built into this test's own directory."""
    if shutil.which('g++') is None:
        pytest.skip('g++ not available')
    from safe_control_gym_tpu.utils import native
    monkeypatch.setattr(native, '_LIB', str(tmp_path / 'libdynamics_oracle.so'))
    monkeypatch.setattr(native, '_lib', None)
    return native


def _realized_forces(env, u):
    """Per-motor forces the port's motor model makes of the command ``u``."""
    p = env._nominal_dyn_params()
    rpm = tdyn.pwm2rpm(tdyn.cmd2pwm(torch.as_tensor(u, dtype=torch.float32)[None], p), p)
    return (rpm[0].double() ** 2 * env.KF).numpy()


def test_k2_through_the_env_matches_cpp_oracle(monkeypatch, tmp_path):
    native = _oracle(monkeypatch, tmp_path)
    ti = {'stabilization_goal': [1, 1.5], 'stabilization_goal_tolerance': 0.001}
    env = tmake('quadrotor', device='cpu', seed=0, quad_type=2, randomized_init=False,
                init_state={'init_z': 1.0}, task_info=ti, ctrl_freq=50, pyb_freq=1000)
    env.reset()
    params = np.array([env.MASS, env.J[1, 1], env.L, env.GRAVITY_ACC])
    state_cpp = np.array([0, 0, 1.0, 0, 0, 0], dtype=float)
    errs = []
    for i in range(30):
        u = env.U_GOAL * (1 + 0.05 * np.sin(i / 3) * np.array([1, -1]))
        env.step(u)
        f = _realized_forces(env, u)
        state_cpp = native.quad2d_advance_oracle(
            state_cpp, np.array([f[0] + f[3], f[1] + f[2]]), params,
            env.PYB_TIMESTEP, env.PYB_STEPS_PER_CTRL)
        errs.append(np.abs(env.state - state_cpp).max())
    assert np.abs(state_cpp[4]) > 1e-3  # the body really pitched
    assert float(np.sqrt(np.mean(np.square(errs)))) <= 1e-3


def test_k3_through_the_env_matches_cpp_oracle(monkeypatch, tmp_path):
    native = _oracle(monkeypatch, tmp_path)
    ti = {'stabilization_goal': [1, 1, 1.5], 'stabilization_goal_tolerance': 0.001}
    env = tmake('quadrotor', device='cpu', seed=0, quad_type=3, randomized_init=False,
                init_state={'init_z': 1.0}, task_info=ti, ctrl_freq=50, pyb_freq=1000)
    env.reset()
    params = np.array([env.MASS, env.J[0, 0], env.J[1, 1], env.J[2, 2],
                       env.L, env.KF, env.KM, env.GRAVITY_ACC])
    state_cpp = np.zeros(12)
    state_cpp[4] = 1.0
    errs = []
    for i in range(20):
        u = env.U_GOAL * (1 + 0.03 * np.sin(i / 2) * np.array([1, -1, 1, -1]))
        env.step(u)
        state_cpp = native.quad3d_advance_oracle(
            state_cpp, _realized_forces(env, u), params, env.PYB_TIMESTEP,
            env.PYB_STEPS_PER_CTRL)
        errs.append(np.abs(env.state - state_cpp).max())
    assert np.abs(state_cpp[8]) > 1e-4  # the yaw torque turned the body
    assert float(np.sqrt(np.mean(np.square(errs)))) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize('quad_type', [2, 3])
def test_cuda_kernel_matches_plain_version(quad_type):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    inputs = _inputs_2d(7, B=4096) if quad_type == 2 else _inputs_3d(8, B=4096)
    args = [torch.as_tensor(a, device=dev) for a in inputs]
    wrapper, plain = ((tk.quad2d_advance, tk.quad2d_advance_plain) if quad_type == 2
                      else (tk.quad3d_advance, tk.quad3d_advance_plain))
    before = wrapper.launches
    out = wrapper(*args, N_SUB, DT)
    ref = plain(*args, N_SUB, DT)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-5
