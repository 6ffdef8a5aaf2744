"""Domain randomization of the inertial properties in the port, against the
JAX package's.

* JAX's randomized ``reset_batch`` state, per-env parameters included,
  carried across by ``utils/convert.py`` and stepped in both packages over
  fixed actions: states and reward sums within 1e-4, dones exactly.
* The parameter sampler's draws against JAX's, moment by moment for each
  distribution (uniform, and the cartpole pole length's choice). The random
  streams differ, so the match is in distribution: Welch z <= 6.
* ``step_autoreset`` redraws the parameters of the done envs only.
* The stateful ``reset`` draws one set an episode, reported in
  ``info['physical_parameters']``.
* A two-lane randomized population keeps each lane's parameters.
* K4's and K5's gates still refuse randomized parameters (as JAX's,
  tests/test_rollout_kernel.py:380-384), and so do the fused evaluation's.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments import fused_eval
from safe_control_gym_tpu_torch.hyperparameters.population import PopulationPPO
from safe_control_gym_tpu_torch.ops import physics_kernels
from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy, env_state_to_numpy
from safe_control_gym_tpu_torch.utils.registration import make as tmake


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


SYSTEMS = {
    'cartpole': ('cartpole', dict(init_state={'init_theta': 0.1})),
    'quadrotor_2D': ('quadrotor', dict(quad_type=2, init_state={'init_z': 1.0},
                                       task_info={'stabilization_goal': [0, 1],
                                                  'stabilization_goal_tolerance': 0.0})),
    'quadrotor_3D': ('quadrotor', dict(quad_type=3, init_state={'init_z': 1.0},
                                       task_info={'stabilization_goal': [0, 0, 1],
                                                  'stabilization_goal_tolerance': 0.0})),
}
# Per system: the fields drawn, and the spec's names for them.
DRAWN = {'cartpole': {'pole_length': 'pole_length', 'cart_mass': 'cart_mass',
                      'pole_mass': 'pole_mass'},
         'quadrotor_2D': {'mass': 'M', 'Iyy': 'Iyy'},
         'quadrotor_3D': {'mass': 'M', 'Ixx': 'Ixx', 'Iyy': 'Iyy', 'Izz': 'Izz'}}


def _kw(system, **over):
    env_id, kw = SYSTEMS[system]
    return env_id, dict(dict(kw, seed=0, ctrl_freq=50, pyb_freq=500, episode_len_sec=1,
                             randomized_init=False, randomized_inertial_prop=True), **over)


def _envs(system, **over):
    env_id, kw = _kw(system, **over)
    return jmake(env_id, **kw), tmake(env_id, device='cpu', **kw)


def _state_dict(est):
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_jax_randomized_state_steps_alike(system):
    je, te = _envs(system)
    B, T = 64, 40
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(3), B)
    d = _state_dict(jst)
    tst = env_state_from_numpy(d, 'cpu')
    for field, name in DRAWN[system].items():
        got = getattr(tst.dyn_params, field)
        assert got.shape == (B,), field
        np.testing.assert_array_equal(got.numpy(), d['dyn_params'][field])
    # The converter gives the per-env arrays back.
    back = env_state_to_numpy(tst)
    for field in DRAWN[system]:
        np.testing.assert_array_equal(back['dyn_params'][field], d['dyn_params'][field])
    lo, hi = te.action_space.low, te.action_space.high
    if te.NAME == 'quadrotor':
        lo, hi = 0.8 * te.U_GOAL, 1.2 * te.U_GOAL
    actions = np.random.default_rng(1).uniform(lo, hi, (T, B, te.action_dim)).astype(np.float32)

    def body(carry, a):
        st, rew, dn = carry
        st, out = jax.vmap(je.func.step)(st, a)
        return (st, rew + out.reward, dn + out.done.astype(jnp.float32)), None

    z = jnp.zeros((B,), jnp.float32)
    (jst, jrew, jdone), _ = jax.jit(lambda s, a: jax.lax.scan(body, (s, z, z), a))(
        jst, jnp.asarray(actions))
    rew, dn = torch.zeros(B), torch.zeros(B)
    for t in range(T):
        tst, out = te.func.step(tst, torch.as_tensor(actions[t]))
        rew += out.reward
        dn += out.done
    np.testing.assert_allclose(tst.state.numpy(), np.asarray(jst.state), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(dn.numpy(), np.asarray(jdone))
    # The parameters moved the envs apart: a shared set would not match.
    shared = env_state_from_numpy(dict(d, dyn_params={
        k: np.full(B, v.ravel()[0], np.float32) for k, v in d['dyn_params'].items()}), 'cpu')
    for t in range(T):
        shared, _ = te.func.step(shared, torch.as_tensor(actions[t]))
    assert float((shared.state - tst.state).abs().max()) > 1e-3


def _welch_z(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return abs(a.mean() - b.mean()) / np.sqrt(a.var() / a.size + b.var() / b.size)


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_sampler_moments_match_jax(system):
    je, te = _envs(system)
    n = 20000
    jp = jax.vmap(je._sample_dyn_params, in_axes=(0, None))(
        jax.random.split(jax.random.PRNGKey(5), n), je._nominal_dyn_params())
    tp = te._sample_dyn_params(torch.Generator().manual_seed(5), te._nominal_dyn_params(), n)
    for field, name in DRAWN[system].items():
        a, b = getattr(tp, field).numpy(), np.asarray(getattr(jp, field))
        assert a.shape == b.shape == (n,)
        assert _welch_z(a, b) <= 6, field
        assert 0.9 < a.var() / b.var() < 1.1, field
        spec = te.INERTIAL_PROP_RAND_INFO[name]
        nominal = float(getattr(te._nominal_dyn_params(), field))
        if spec['distrib'] == 'uniform':
            assert a.min() >= nominal + spec['low'] - 1e-6 * abs(nominal)
            assert a.max() <= nominal + spec['high'] + 1e-6 * abs(nominal)
        else:
            np.testing.assert_allclose(np.unique(a), np.unique(b), rtol=1e-6)
            np.testing.assert_allclose(np.unique(a), nominal + np.asarray(spec['args'][0]),
                                       rtol=1e-6)
    # The fields the spec does not name stay shared.
    for f in dataclasses.fields(tp):
        if f.name not in DRAWN[system]:
            assert getattr(tp, f.name).ndim == 0, f.name


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_autoreset_redraws_only_done_rows(system):
    env_id, kw = _kw(system, episode_len_sec=0.2)
    env = tmake(env_id, device='cpu', **kw)
    gen = torch.Generator().manual_seed(0)
    B = 32
    est, _ = env.func.reset_batch(gen, B)
    hover = np.asarray(env.U_GOAL if env.NAME == 'quadrotor' else [0.0], np.float32)
    act = torch.as_tensor(np.tile(hover, (B, 1)))
    # Stagger the counters so that episodes end on different steps.
    est = est.replace(ctrl_step=torch.arange(B, dtype=torch.int32) % env.CTRL_STEPS)
    done_rows = 0
    for _ in range(env.CTRL_STEPS):
        fresh = env.func.reset_batch(gen, B)
        new, out, _ = env.func.step_autoreset(est, act, gen, fresh=fresh)
        for field in DRAWN[system]:
            old_v, new_v = getattr(est.dyn_params, field), getattr(new.dyn_params, field)
            fresh_v = getattr(fresh[0].dyn_params, field)
            assert torch.equal(new_v[~out.done], old_v[~out.done]), field
            assert torch.equal(new_v[out.done], fresh_v[out.done]), field
        done_rows += int(out.done.sum())
        est = new
    assert 0 < done_rows


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_physical_parameters_in_reset_info(system):
    env_id, kw = _kw(system)
    env = tmake(env_id, device='cpu', **kw)
    jenv = jmake(env_id, **kw)
    _, info = env.reset()
    _, jinfo = jenv.reset()
    first = info['physical_parameters']
    assert set(first) == set(jinfo['physical_parameters'])
    for field, value in first.items():
        assert np.ndim(value) == 0, field
        assert float(value) == float(getattr(env._est.dyn_params, field).reshape(-1)[0])
    env.step(env.U_GOAL if env.NAME == 'quadrotor' else np.zeros(1))
    _, info = env.reset()
    assert any(float(info['physical_parameters'][f]) != float(first[f])
               for f in DRAWN[system])


def test_randomized_cartpole_takes_k1s_plain_twin_with_per_env_rows():
    env_id, kw = _kw('cartpole')
    env = tmake(env_id, device='cpu', **kw)
    assert env.physics_route == 'K1 plain twin'
    assert tmake(env_id, device='cpu', **dict(kw, randomized_inertial_prop=False)) \
        .physics_route == 'K1'
    est, _ = env.func.reset_batch(torch.Generator().manual_seed(0), 16)
    params = est.dyn_params.vector()
    assert params.shape == (16, 4)
    x = torch.randn(16, 4) * 0.1
    f, tab = torch.randn(16), torch.randn(16, 2) * 0.1
    rows = physics_kernels.cartpole_advance_plain(x, f, tab, params, 5, 0.002)
    for i in range(16):
        one = physics_kernels.cartpole_advance_plain(x[i:i + 1], f[i:i + 1], tab[i:i + 1],
                                                     params[i], 5, 0.002)
        assert torch.equal(rows[i:i + 1], one)


def test_population_lanes_keep_their_parameters():
    env_func = partial(tmake, 'cartpole', normalized_rl_action_space=True, episode_len_sec=1,
                       randomized_inertial_prop=True)
    pop = PopulationPPO(env_func, rollout_batch_size=4, rollout_steps=8, iterations=1,
                        opt_epochs=1, mini_batch_size=16, hidden_dim=8, n_eval=2,
                        device='cpu')
    seeds = [21, 22]
    draws = pop.lane_draws(seeds)
    est, _ = draws['init']
    assert est.dyn_params.pole_length.shape == (8,)
    lane1 = pop.select_lanes(draws, [1])
    assert torch.equal(lane1['init'][0].dyn_params.cart_mass, est.dyn_params.cart_mass[4:])
    fresh_est = draws['iterations'][0]['fresh'][0]
    assert fresh_est.dyn_params.pole_mass.shape == (8, 8)      # (T, P×N)
    assert torch.equal(lane1['iterations'][0]['fresh'][0].dyn_params.pole_mass,
                       fresh_est.dyn_params.pole_mass[:, 4:])
    hp = {'actor_lr': np.array([3e-4, 3e-3])}
    together = pop(hp, seeds, draws=draws)
    for p in range(2):
        alone = pop({k: v[p:p + 1] for k, v in hp.items()}, seeds[p:p + 1],
                    draws=pop.select_lanes(draws, [p]))
        np.testing.assert_allclose(alone[0], together[p], rtol=1e-6, atol=0)


@pytest.mark.parametrize('system', list(SYSTEMS))
def test_rollout_kernel_gates_refuse_randomized(system):
    env_id, kw = _kw(system)
    env = tmake(env_id, device='cpu', **kw)
    cfg = rk.cartpole_rollout_cfg if env.NAME == 'cartpole' else rk.quad_rollout_cfg
    with pytest.raises(ValueError):
        cfg(env)
    spec = {'std': None}
    with pytest.raises(ValueError):
        fused_eval._kernel_gates(spec, env, stochastic=False)


@pytest.mark.parametrize('over', [dict(quad_type=1, task_info={'stabilization_goal': [0, 1]}),
                                  dict(quad_type=2, physics='pyb_gnd'),
                                  dict(quad_type=3, physics='dyn',
                                       task_info={'stabilization_goal': [0, 0, 1]})])
def test_rollout_kernel_gates_refuse_other_physics(over):
    env = tmake('quadrotor', device='cpu', seed=0, **over)
    if env.QUAD_TYPE != 1:
        with pytest.raises(ValueError):
            rk.quad_rollout_cfg(env)
    with pytest.raises(ValueError):
        fused_eval._kernel_gates({'std': None}, env, stochastic=False)
