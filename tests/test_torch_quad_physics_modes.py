"""The port's 1D quadrotor and its physics modes against the JAX package's.

Every quad type (1, 2, 3) under every ``physics`` value runs
``step_autoreset`` over fixed actions from one state in both packages, the
JAX env under ``lax.scan`` on its CPU scan path, the port's in its Python
loop: states and reward sums within rtol/atol 1e-4, done counts and step
counters exactly (the protocol of tests/test_rollout_kernel.py:57-83). The
first states sit near the ground with non-zero velocities, so the ground
effect and the drag act. Also: the JAX package's own cases of the modes and
the shapes (tests/test_env_extras.py, tests/test_envs.py), the 1D quad's
spaces, references and symbolic model, and the routing predicate against
the one JAX's ``_install_pallas_advance`` applies."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments.benchmark_suite import per_step_rollout
from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy
from safe_control_gym_tpu_torch.utils.registration import make as tmake


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


PHYSICS = ('pyb', 'dyn', 'pyb_gnd', 'pyb_drag', 'pyb_dw', 'pyb_gnd_drag_dw')
NX = {1: 2, 2: 6, 3: 12}
NU = {1: 1, 2: 2, 3: 4}
Z = {1: 0, 2: 2, 3: 4}


def _kw(quad_type, **over):
    goal = {1: [0, 1], 2: [0, 1], 3: [0, 0, 1]}[quad_type]
    init = {'init_x': 0.5} if quad_type == 1 else {'init_z': 0.5}
    return dict(dict(quad_type=quad_type, seed=0, ctrl_freq=50, pyb_freq=500,
                     episode_len_sec=0.6, randomized_init=False, init_state=init,
                     task_info={'stabilization_goal': goal,
                                'stabilization_goal_tolerance': 0.0}), **over)


def _state_dict(est):
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def _low_fast_states(quad_type, B, rng):
    """Starts near the ground (z in [0.02, 0.3], some below the ground
    effect's height clip) with velocities up to 2 m/s and angles and rates
    off zero."""
    x = np.zeros((B, NX[quad_type]), np.float32)
    x[:, Z[quad_type]] = rng.uniform(0.02, 0.3, B)
    x[:, Z[quad_type] + 1] = rng.uniform(-2, 2, B)
    if quad_type == 2:
        x[:, [0, 1, 4, 5]] = rng.uniform([-1, -2, -0.4, -1], [1, 2, 0.4, 1], (B, 4))
    if quad_type == 3:
        x[:, [0, 1, 2, 3]] = rng.uniform(-1, 1, (B, 4)) * [1, 2, 1, 2]
        x[:, 6:9] = rng.uniform(-0.4, 0.4, (B, 3))
        x[:, 9:12] = rng.uniform(-1, 1, (B, 3))
    return x


def _replay(je, te, x0, actions):
    """``step_autoreset`` over the (T, B, nu) actions from the states ``x0``:
    JAX's under ``lax.scan``, the port's in its Python loop."""
    B = x0.shape[0]
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(0), B)
    jst = jst.replace(state=jnp.asarray(x0))
    tst = env_state_from_numpy(_state_dict(jst), 'cpu')

    def body(carry, a):
        st, rew, dones = carry
        st, out, _ = je.func.step_autoreset(st, a, jax.random.PRNGKey(0))
        return (st, rew + out.reward, dones + out.done.astype(jnp.float32)), None

    z = jnp.zeros((B,), jnp.float32)
    (jst, rew, dones), _ = jax.jit(lambda s, a: jax.lax.scan(body, (s, z, z), a))(
        jst, jnp.asarray(actions))
    tst, stats = per_step_rollout(te, tst, torch.as_tensor(actions),
                                  torch.Generator().manual_seed(0))
    ref = dict(state=np.asarray(jst.state), ctrl_step=np.asarray(jst.ctrl_step),
               reward_sum=np.asarray(rew), done_count=np.asarray(dones))
    got = dict(state=tst.state.numpy(), ctrl_step=tst.ctrl_step.numpy(),
               reward_sum=stats['reward_sum'].numpy(), done_count=stats['done_count'].numpy())
    return ref, got


@pytest.mark.parametrize('physics', PHYSICS)
@pytest.mark.parametrize('quad_type', [1, 2, 3])
def test_replay_matches_jax(quad_type, physics):
    kw = _kw(quad_type, physics=physics)
    je, te = jmake('quadrotor', **kw), tmake('quadrotor', device='cpu', **kw)
    assert te.physics_route == ('general' if quad_type == 1 or physics != 'pyb'
                                else f'K{quad_type}')
    B, T = 48, 40
    rng = np.random.default_rng(10 * quad_type + PHYSICS.index(physics))
    lo, hi = te.physical_action_bounds[0][0], te.physical_action_bounds[1][0]
    # Thrusts about hover: the quads rise and fall, some leave the box.
    hover = te.U_GOAL[0]
    actions = rng.uniform(max(lo, 0.5 * hover), min(hi, 1.6 * hover),
                          (T, B, NU[quad_type])).astype(np.float32)
    ref, got = _replay(je, te, _low_fast_states(quad_type, B, rng), actions)
    np.testing.assert_allclose(got['state'], ref['state'], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got['reward_sum'], ref['reward_sum'], rtol=1e-4, atol=1e-4)
    for key in ('done_count', 'ctrl_step'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert ref['done_count'].sum() > 0


@pytest.mark.parametrize('physics', ['pyb_gnd', 'pyb_drag', 'pyb_gnd_drag_dw', 'pyb_dw'])
@pytest.mark.parametrize('quad_type', [1, 2, 3])
def test_modes_act_where_they_should(quad_type, physics):
    """From the near-ground, moving starts, the ground effect and the drag
    move the states off 'pyb' (drag not in 1D, which has none); downwash of
    a single drone is no term at all."""
    rng = np.random.default_rng(quad_type)
    x0 = torch.as_tensor(_low_fast_states(quad_type, 32, rng))
    states = {}
    for ph in ('pyb', physics):
        env = tmake('quadrotor', device='cpu', **_kw(quad_type, physics=ph))
        est, _ = env.func.reset_batch(torch.Generator().manual_seed(0), 32)
        est = est.replace(state=x0)
        u = torch.as_tensor(np.tile(env.U_GOAL, (32, 1)), dtype=torch.float32)
        for _ in range(5):
            est, _ = env.func.step(est, u)
        states[ph] = est.state
    diff = float((states[physics] - states['pyb']).abs().max())
    if physics == 'pyb_dw' or (quad_type == 1 and physics == 'pyb_drag'):
        assert diff <= 1e-4
    else:
        assert diff > 1e-6


@pytest.mark.parametrize('physics', ['pyb', 'dyn', 'pyb_gnd', 'pyb_drag'])
def test_quadrotor_physics_modes(physics):
    """tests/test_env_extras.py's case: hover keeps the 2D quad's altitude
    within a few cm in every mode, in both packages alike."""
    kw = dict(seed=0, quad_type=2, physics=physics, randomized_init=False,
              init_state={'init_z': 1.0},
              task_info={'stabilization_goal': [1, 1.5], 'stabilization_goal_tolerance': 0.01})
    je, te = jmake('quadrotor', **kw), tmake('quadrotor', device='cpu', **kw)
    je.reset()
    te.reset()
    for _ in range(10):
        jobs, jrew, *_ = je.step(je.U_GOAL)
        obs, rew, done, info = te.step(te.U_GOAL)
    assert np.isfinite(obs).all()
    assert abs(float(obs[2]) - 1.0) < 0.1
    np.testing.assert_allclose(obs, jobs, rtol=1e-4, atol=1e-4)
    assert abs(rew - jrew) <= 1e-4 * (1 + abs(jrew))


@pytest.mark.parametrize('quad_type', [1, 2, 3])
def test_quadrotor_shapes(quad_type):
    """tests/test_envs.py's case, the 1D quad included."""
    ti = {'stabilization_goal': [0, 0, 1] if quad_type == 3 else [1, 1.5],
          'stabilization_goal_tolerance': 0.01}
    env = tmake('quadrotor', device='cpu', seed=0, quad_type=quad_type, task_info=ti,
                randomized_init=False)
    obs, _ = env.reset()
    assert obs.shape == (NX[quad_type],)
    assert env.action_space.shape == (NU[quad_type],)
    obs, rew, done, info = env.step(env.U_GOAL)
    assert obs.shape == (NX[quad_type],)


@pytest.mark.parametrize('over', [
    {}, dict(task='traj_tracking', episode_len_sec=2), dict(normalized_rl_action_space=True),
    dict(cost='quadratic', inertial_prop=[0.03], obs_goal_horizon=1),
    dict(inertial_prop={'M': 0.025})], ids=['stab', 'track', 'normalized', 'quadratic', 'dict'])
def test_quad1d_config_matches_jax(over):
    kw = _kw(1, **over)
    je, te = jmake('quadrotor', **kw), tmake('quadrotor', device='cpu', **kw)
    for name in ('action_space', 'observation_space', 'state_space'):
        a, b = getattr(te, name), getattr(je, name)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    np.testing.assert_allclose(te.X_GOAL, je.X_GOAL, rtol=0, atol=1e-6)
    for name in ('U_GOAL', 'Q', 'R', 'physical_action_bounds', 'info_mse_metric_state_weight'):
        np.testing.assert_array_equal(np.asarray(getattr(te, name)),
                                      np.asarray(getattr(je, name)), err_msg=name)
    for name in ('MASS', 'hover_thrust', 'STATE_LABELS', 'ACTION_LABELS',
                 'INIT_STATE_RAND_INFO', 'INERTIAL_PROP_RAND_INFO', 'DISTURBANCE_MODES',
                 'obs_dim', 'state_dim', 'action_dim'):
        assert getattr(te, name) == getattr(je, name), name
    # The symbolic model: the continuous and discrete dynamics and their
    # Jacobians at a few points.
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.uniform(-1, 1, 2).astype(np.float32)
        u = rng.uniform(0.1, 0.4, 1).astype(np.float32)
        for fn in ('fc_func', 'fd_func'):
            np.testing.assert_allclose(
                getattr(te.symbolic, fn)(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                np.asarray(getattr(je.symbolic, fn)(jnp.asarray(x), jnp.asarray(u))),
                rtol=1e-6, atol=1e-6, err_msg=fn)
        tdf = te.symbolic.df_func(torch.as_tensor(x), torch.as_tensor(u))
        jdf = je.symbolic.df_func(jnp.asarray(x), jnp.asarray(u))
        for k in ('dfdx', 'dfdu'):
            np.testing.assert_allclose(tdf[k].numpy(), np.asarray(jdf[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert te.symbolic.nx == 2 and te.symbolic.nu == 1


CASES = [dict(quad_type=q, physics=p) for q in (1, 2, 3) for p in PHYSICS] + [
    dict(quad_type=2, randomized_inertial_prop=True),
    dict(quad_type=3, randomized_inertial_prop=True),
    dict(quad_type=2, pallas_physics=False), dict(quad_type=3, pallas_physics=False)]


@pytest.mark.parametrize('case', CASES, ids=lambda c: '-'.join(f'{k}={v}' for k, v in c.items()))
def test_routing_predicate_matches_jax(case):
    """The port takes K2/K3 exactly where JAX's ``_install_pallas_advance``
    installs its kernel (on a TPU backend: ``jax.default_backend`` is made to
    say so while the JAX env is built); the plain twins run where only
    ``pallas_physics=False`` keeps the kernel out, the general advance
    everywhere else."""
    kw = _kw(case['quad_type'], **{k: v for k, v in case.items() if k != 'quad_type'})
    with mock.patch.object(jax, 'default_backend', lambda: 'tpu'):
        je = jmake('quadrotor', **kw)
    jax_kernel = type(je._advance_pure).__name__ == 'custom_vmap'
    te = tmake('quadrotor', device='cpu', **kw)
    assert (te.physics_route in ('K2', 'K3')) == jax_kernel
    jax_scan_rule = (case.get('randomized_inertial_prop') or case['quad_type'] == 1
                     or case.get('physics', 'pyb') != 'pyb')
    assert (te.physics_route == 'general') == bool(jax_scan_rule)
