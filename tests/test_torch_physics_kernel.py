"""K1 (``ops/physics_kernels.py``): the plain version against the JAX package's
Pallas kernel in interpret mode and against its ``cartpole_substeps``, < 1e-5
(tests/test_pallas.py holds the Pallas kernel to the same bound); the CUDA
kernel against the plain version on the card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from safe_control_gym_tpu_torch.ops import physics_kernels as tk


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


N_SUB, DT = 20, 1e-3
PARAMS = [0.1, 1.0, 0.5, 9.8]


def _inputs(seed, B=128):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 0.3, (B, 4)).astype(np.float32),
            rng.uniform(-5, 5, B).astype(np.float32),
            rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32),
            np.asarray(PARAMS, np.float32))


def _plain(states, forces, tab, params):
    return tk.cartpole_advance(*(torch.as_tensor(a) for a in (states, forces, tab, params)),
                               N_SUB, DT).numpy()


def test_plain_matches_pallas_kernel_interpreted(monkeypatch):
    import safe_control_gym_tpu.ops.pallas_kernels as pk
    monkeypatch.setattr(pk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    states, forces, tab, params = _inputs(0)
    ref = pk.cartpole_advance_pallas(jnp.asarray(states), jnp.asarray(forces),
                                     jnp.asarray(tab), jnp.asarray(params),
                                     n_substeps=N_SUB, dt=DT)
    assert np.abs(_plain(states, forces, tab, params) - np.asarray(ref)).max() < 1e-5


@pytest.mark.parametrize('seed', [1, 2])
def test_plain_matches_jax_substeps(seed):
    from safe_control_gym_tpu.ops.pallas_kernels import cartpole_substeps
    states, forces, tab, params = _inputs(seed)
    states[:, 2] = np.random.default_rng(seed).uniform(-3, 3, states.shape[0])
    cols = [jnp.asarray(states[:, k]) for k in range(4)]
    ref = cartpole_substeps(*cols, jnp.asarray(forces), jnp.asarray(tab[:, 0]),
                            jnp.asarray(tab[:, 1]), *[jnp.float32(p) for p in params],
                            N_SUB, DT)
    assert np.abs(_plain(states, forces, tab, params) - np.stack(ref, 1)).max() < 1e-5


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = tk.cartpole_advance.launches
    states, forces, tab, params = _inputs(3, B=16)
    out = _plain(states, forces, tab, params)
    plain = tk.cartpole_advance_plain(*(torch.as_tensor(a) for a in (states, forces, tab, params)),
                                      N_SUB, DT).numpy()
    np.testing.assert_array_equal(out, plain)
    assert tk.cartpole_advance.launches == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    args = [torch.as_tensor(a, device=dev) for a in _inputs(4, B=4096)]
    before = tk.cartpole_advance.launches
    out = tk.cartpole_advance(*args, N_SUB, DT)
    ref = tk.cartpole_advance_plain(*args, N_SUB, DT)
    torch.cuda.synchronize()
    assert tk.cartpole_advance.launches == before + 1
    assert float((out - ref).abs().max()) <= 1e-5
