"""K1-K3 (``ops/physics_kernels.py``) on the cases their exact substeps
and the library recompute must both get right: nonzero tab and world
forces, exact hover (every angle 0, so 3D's quotients see zero numerators),
angles of 2e5 on some envs (past ``sinf``'s fast range, where the kernels
recompute the step with the library's functions), and 20 substeps (compiled
in) and 7 (the runtime-count instantiation).

The plain versions against the JAX package, < 1e-5 absolute: K1 against its
Pallas kernel in interpret mode (as tests/test_pallas.py runs it); K2 and K3
against ``quad2d_substeps`` and ``quad3d_substeps``, the bodies of their
Pallas kernels, called directly at 64 envs a case, and against the kernels in
interpret mode on four envs that hold the three cases (interpreted on the
CPU, a call takes seconds for four envs and minutes for 64). At an angle of
2e5 the float32 spacing is 1/64, so agreement to 1e-5 there means both sides
round the angle's update the same way. The CUDA kernels against their plain
versions on every case of ``chip_smoke.py``'s phases k1-k3
(``benchmark_suite.physics_cases``), on the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
from safe_control_gym_tpu_torch.ops import physics_kernels as tk


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


CTRL_DT = 0.02
TOL = 1e-5
CASES = ('forces', 'hover', 'angle_2e5')
SUBSTEPS = (20, 7)


def _cartpole_inputs(case, seed, B=64):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-0.3, 0.3, (B, 4))
    force = rng.uniform(-10, 10, B)
    tab = rng.uniform(-0.5, 0.5, (B, 2))
    if case == 'hover':
        states[:, 2:] = 0.0
        force[:] = 0.0
        tab[:] = 0.0
    elif case == 'angle_2e5':
        states[::7, 2] = 2.0e5
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(states), f32(force), f32(tab), f32(bs.PHYSICS_PARAMS['cartpole'])


def _quad2d_inputs(case, seed, B=64):
    rng = np.random.default_rng(seed)
    states = np.stack([rng.uniform(-1, 1, B), rng.uniform(-0.5, 0.5, B),
                       rng.uniform(0.5, 1.5, B), rng.uniform(-0.5, 0.5, B),
                       rng.uniform(-1, 1, B), rng.uniform(-3, 3, B)], axis=1)
    t1, t2 = rng.uniform(0.05, 0.2, B), rng.uniform(0.05, 0.2, B)
    dist = rng.uniform(-0.01, 0.01, (B, 2))
    if case == 'hover':
        states[:, 4:] = 0.0
        t1[:] = t2[:] = 0.027 * 9.8 / 2
        dist[:] = 0.0
    elif case == 'angle_2e5':
        states[::7, 4] = 2.0e5
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(states), f32(t1), f32(t2), f32(dist), f32(bs.PHYSICS_PARAMS['quadrotor'])


def _quad3d_inputs(case, seed, B=64):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-0.5, 0.5, (B, 12))
    states[:, 4] += 1.0
    states[:, 6:9] = rng.uniform(-0.8, 0.8, (B, 3))
    states[:, 9:12] = rng.uniform(-3, 3, (B, 3))
    hover = 0.027 * 9.8 / 4
    forces = rng.uniform(0.5, 1.5, (B, 4)) * hover
    z_torque = rng.uniform(-1e-6, 1e-6, B)
    dist = rng.uniform(-0.01, 0.01, (B, 3))
    if case == 'hover':
        states[:, 6:] = 0.0
        forces[:] = hover
        z_torque[:] = 0.0
        dist[:] = 0.0
    elif case == 'angle_2e5':
        states[::7, 7] = 2.0e5
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(states), f32(forces), f32(z_torque), f32(dist),
            f32(bs.PHYSICS_PARAMS['quadrotor_3D']))


@pytest.mark.parametrize('n_sub', SUBSTEPS)
@pytest.mark.parametrize('case', CASES)
def test_k1_plain_matches_pallas_kernel_interpreted(monkeypatch, case, n_sub):
    import safe_control_gym_tpu.ops.pallas_kernels as pk
    monkeypatch.setattr(pk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    args = _cartpole_inputs(case, seed=n_sub)
    dt = CTRL_DT / n_sub
    ref = np.asarray(pk.cartpole_advance_pallas(*(jnp.asarray(a) for a in args),
                                                n_substeps=n_sub, dt=dt, block_b=64))
    got = tk.cartpole_advance(*(torch.as_tensor(a) for a in args), n_sub, dt).numpy()
    assert np.abs(got - ref).max() < TOL
    if case == 'hover':
        assert not got[:, 2:].any()
    if case == 'angle_2e5':
        assert (np.abs(got[::7, 2]) > 105615).all() and np.isfinite(got).all()


@pytest.mark.parametrize('n_sub', SUBSTEPS)
@pytest.mark.parametrize('case', CASES)
def test_k2_plain_matches_jax_substeps(case, n_sub):
    from safe_control_gym_tpu.ops.pallas_kernels import quad2d_substeps
    states, t1, t2, dist, params = _quad2d_inputs(case, seed=30 + n_sub)
    dt = CTRL_DT / n_sub
    ref = quad2d_substeps(*(jnp.asarray(states[:, k]) for k in range(6)), jnp.asarray(t1),
                          jnp.asarray(t2), jnp.asarray(dist[:, 0]), jnp.asarray(dist[:, 1]),
                          *(jnp.float32(p) for p in params), n_sub, dt)
    got = tk.quad2d_advance(*(torch.as_tensor(a) for a in (states, t1, t2, dist, params)),
                            n_sub, dt).numpy()
    assert np.abs(got - np.stack(ref, 1)).max() < TOL
    if case == 'hover':
        assert not got[:, 4:].any()
    if case == 'angle_2e5':
        assert (np.abs(got[::7, 4]) > 105615).all() and np.isfinite(got).all()


@pytest.mark.parametrize('n_sub', SUBSTEPS)
def test_k2_plain_matches_pallas_kernel_interpreted(monkeypatch, n_sub):
    """Env 0 with forces, env 1 at hover, env 2 at an angle of 2e5, env 3
    with forces."""
    import safe_control_gym_tpu.ops.pallas_kernels as pk
    monkeypatch.setattr(pk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    rows = [_quad2d_inputs(case, seed=40 + n_sub, B=1)
            for case in ('forces', 'hover', 'angle_2e5', 'forces')]
    args = [np.concatenate(parts) for parts in zip(*(r[:4] for r in rows))] + [rows[0][4]]
    dt = CTRL_DT / n_sub
    ref = np.asarray(pk.quad2d_advance_pallas(*(jnp.asarray(a) for a in args),
                                              n_substeps=n_sub, dt=dt))
    got = tk.quad2d_advance(*(torch.as_tensor(a) for a in args), n_sub, dt).numpy()
    assert np.abs(got - ref).max() < TOL
    assert not got[1, 4:].any() and abs(got[2, 4]) > 105615


@pytest.mark.parametrize('n_sub', SUBSTEPS)
@pytest.mark.parametrize('case', CASES)
def test_k3_plain_matches_jax_substeps(case, n_sub):
    from safe_control_gym_tpu.ops.pallas_kernels import quad3d_substeps
    states, forces, zt, dist, params = _quad3d_inputs(case, seed=10 + n_sub)
    dt = CTRL_DT / n_sub
    col = lambda a, k: jnp.asarray(a[:, k])
    ref = quad3d_substeps(tuple(col(states, k) for k in range(12)),
                          tuple(col(forces, k) for k in range(4)), jnp.asarray(zt),
                          tuple(col(dist, k) for k in range(3)),
                          *(jnp.float32(p) for p in params), n_sub, dt)
    got = tk.quad3d_advance(*(torch.as_tensor(a) for a in (states, forces, zt, dist, params)),
                            n_sub, dt).numpy()
    assert np.abs(got - np.stack(ref, 1)).max() < TOL
    if case == 'hover':
        assert not got[:, 6:].any()
    if case == 'angle_2e5':
        assert (np.abs(got[::7, 7]) > 105615).all() and np.isfinite(got).all()


@pytest.mark.parametrize('n_sub', SUBSTEPS)
def test_k3_plain_matches_pallas_kernel_interpreted(monkeypatch, n_sub):
    """Env 0 with forces, env 1 at hover, env 2 at an angle of 2e5, env 3
    with forces."""
    import safe_control_gym_tpu.ops.pallas_kernels as pk
    monkeypatch.setattr(pk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    rows = [_quad3d_inputs(case, seed=20 + n_sub, B=1)
            for case in ('forces', 'hover', 'angle_2e5', 'forces')]
    args = [np.concatenate(parts) for parts in zip(*(r[:4] for r in rows))] + [rows[0][4]]
    dt = CTRL_DT / n_sub
    ref = np.asarray(pk.quad3d_advance_pallas(*(jnp.asarray(a) for a in args),
                                              n_substeps=n_sub, dt=dt))
    got = tk.quad3d_advance(*(torch.as_tensor(a) for a in args), n_sub, dt).numpy()
    assert np.abs(got - ref).max() < TOL
    assert not got[1, 6:].any() and abs(got[2, 7]) > 105615


@pytest.mark.gpu
@pytest.mark.parametrize('system', ['cartpole', 'quadrotor', 'quadrotor_3D'])
def test_cuda_kernel_matches_plain_version_on_every_case(system):
    """Every chip_smoke k1-k3 case, bit for bit (as chip_smoke gates them);
    each launch counted once, 20 substeps and 7 alike."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    name = {'cartpole': 'cartpole_advance', 'quadrotor': 'quad2d_advance',
            'quadrotor_3D': 'quad3d_advance'}[system]
    wrapper, plain = getattr(tk, name), getattr(tk, name + '_plain')
    for case, args in bs.physics_cases(system, dev):
        before = wrapper.launches
        out = wrapper(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, case
        assert torch.equal(out, ref), case
