"""K5 (``ops/rollout_kernels.py``): the plain version of the whole quadrotor
rollout against the JAX package's Pallas kernel in interpret mode and against
the port's own per-step path, in replay mode (fixed actions, deterministic
resets), for the 2D and 3D quads in stabilization, constrained and tracking
modes: states and reward sums rtol/atol 1e-4, done counts, step counters and
violation counts exact. Also the cfg vector and its gates against JAX's, the
kernel source's cfg offsets, the Philox word layout, and the stochastic mode
against the per-step path in distribution. The CUDA kernel is held to the
plain version on the card."""

import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments.benchmark_suite import (_env_kwargs,
                                                                    per_step_rollout)
from safe_control_gym_tpu_torch.ops import rollout_kernels as trk
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


BENCH_CONSTRAINTS = [
    {'constraint_form': 'default_constraint', 'constrained_variable': 'state'},
    {'constraint_form': 'default_constraint', 'constrained_variable': 'input'},
]
TRACK_2D = {'trajectory_type': 'circle', 'num_cycles': 1, 'trajectory_plane': 'zx',
            'trajectory_position_offset': [0.5, 0], 'trajectory_scale': -0.5}
TRACK_3D = {'trajectory_type': 'figure8', 'num_cycles': 1, 'trajectory_plane': 'xy',
            'trajectory_position_offset': [0, 0], 'trajectory_scale': 0.75,
            'proj_point': [0, 0, 0.5], 'proj_normal': [0, 1, 1]}


def _base(quad_type):
    goal = [0, 1] if quad_type == 2 else [0, 0, 1]
    return dict(quad_type=quad_type, seed=0, ctrl_freq=50, pyb_freq=1000,
                episode_len_sec=0.4, randomized_init=False, init_state={'init_z': 1.0},
                task_info={'stabilization_goal': goal, 'stabilization_goal_tolerance': 0.0})


def _track(quad_type, cost):
    return dict(episode_len_sec=1.0, init_state={'init_z': 0.5}, task='traj_tracking',
                task_info=TRACK_2D if quad_type == 2 else TRACK_3D, cost=cost)


def _state_dict(est):
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def _replay_three_ways(monkeypatch, quad_type, over, B, T, overshoot, seed, key,
                       constrained=False):
    """One replay through the JAX Pallas K5 (interpreted), the port's plain K5
    and the port's per-step path, from one state; three dicts of numpy."""
    import safe_control_gym_tpu.ops.rollout_kernels as jrk
    monkeypatch.setattr(jrk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    kw = dict(_base(quad_type), **over)
    je, te = jmake('quadrotor', **kw), tmake('quadrotor', device='cpu', **kw)
    lo, hi = te.physical_action_bounds[0][0], te.physical_action_bounds[1][0]
    lo, hi = (1 + overshoot) * lo - overshoot * hi, (1 + overshoot) * hi
    actions = np.random.default_rng(seed).uniform(
        lo, hi, (T, B, te.action_dim)).astype(np.float32)
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(key), B)
    tst = env_state_from_numpy(_state_dict(jst), 'cpu')
    mode = dict(draw_actions=False, constrained=constrained, action_noise=False,
                randomized_reset=False)

    jroll = jrk.quad2d_rollout_pallas if quad_type == 2 else jrk.quad3d_rollout_pallas
    jout = jroll(jst.state, jrk._quad_rollout_cfg(je), 0, T, je.PYB_STEPS_PER_CTRL,
                 je.PYB_TIMESTEP, actions=jnp.swapaxes(jnp.asarray(actions), 1, 2),
                 **mode, **jrk.rollout_task_kwargs(je))
    troll = trk.quad2d_rollout if quad_type == 2 else trk.quad3d_rollout
    tout = troll(tst.state, trk.quad_rollout_cfg(te), 0, T, te.PYB_STEPS_PER_CTRL,
                 te.PYB_TIMESTEP, actions=torch.as_tensor(actions), **mode,
                 **trk.rollout_task_kwargs(te))
    st, stats = per_step_rollout(te, tst, torch.as_tensor(actions),
                                 torch.Generator().manual_seed(0))
    step = dict(stats, state=st.state, ctrl_step=st.ctrl_step.to(torch.float32))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return as_np(jout), as_np(tout), as_np(step)


def _assert_same(got, ref, counts_violations=False):
    np.testing.assert_allclose(got['state'], ref['state'], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got['done_count'], ref['done_count'])
    np.testing.assert_array_equal(got['ctrl_step'], ref['ctrl_step'])
    np.testing.assert_allclose(got['reward_sum'], ref['reward_sum'], rtol=1e-4, atol=1e-4)
    if counts_violations:
        np.testing.assert_array_equal(got['violation_count'], ref['violation_count'])


@pytest.mark.parametrize('quad_type', [2, 3])
def test_replay_matches_pallas_and_per_step_path(monkeypatch, quad_type):
    jout, tout, step = _replay_three_ways(monkeypatch, quad_type, {}, B=64, T=48,
                                          overshoot=0.0, seed=5, key=1)
    _assert_same(tout, jout)
    _assert_same(tout, step)
    assert step['done_count'].sum() > 0


@pytest.mark.parametrize('quad_type', [2, 3])
def test_constrained_replay_counts_violations(monkeypatch, quad_type):
    jout, tout, step = _replay_three_ways(
        monkeypatch, quad_type, dict(constraints=BENCH_CONSTRAINTS), B=64, T=48,
        overshoot=0.2, seed=7, key=4, constrained=True)
    assert step['violation_count'].sum() > 0
    _assert_same(tout, jout, counts_violations=True)
    _assert_same(tout, step, counts_violations=True)


@pytest.mark.parametrize('quad_type,cost', [(2, 'rl_reward'), (2, 'quadratic'),
                                            (3, 'rl_reward')])
def test_tracking_replay(monkeypatch, quad_type, cost):
    """Each env reads its own waypoint X_GOAL[step + 1] under both costs, also
    after resets have desynchronized the batch."""
    jout, tout, step = _replay_three_ways(monkeypatch, quad_type, _track(quad_type, cost),
                                          B=64, T=70, overshoot=0.0, seed=10, key=7)
    assert step['ctrl_step'].max() > step['ctrl_step'].min()
    _assert_same(tout, jout)
    _assert_same(tout, step)


@pytest.mark.parametrize('quad_type', [2, 3])
@pytest.mark.parametrize('over', [
    {}, dict(cost='quadratic', rew_state_weight=2.0, rew_act_weight=0.5),
    'track', dict(normalized_rl_action_space=True, randomized_init=True),
    dict(constraints=BENCH_CONSTRAINTS, rew_exponential=False),
], ids=['default', 'quadratic', 'tracking', 'normalized-randomized', 'constrained'])
def test_cfg_vector_matches_jax(quad_type, over):
    import safe_control_gym_tpu.ops.rollout_kernels as jrk
    if over == 'track':
        over = _track(quad_type, 'quadratic')
    kw = dict(_base(quad_type), **over)
    je, te = jmake('quadrotor', **kw), tmake('quadrotor', device='cpu', **kw)
    assert trk.QUAD_CFG_LEN == jrk.QUAD_CFG_LEN and trk._Q == jrk._Q
    np.testing.assert_array_equal(trk.quad_rollout_cfg(te).numpy(),
                                  np.asarray(jrk._quad_rollout_cfg(je)))
    jkw, tkw = jrk.rollout_task_kwargs(je), trk.rollout_task_kwargs(te)
    assert set(jkw) == set(tkw)
    if 'x_goal' in tkw:
        np.testing.assert_allclose(tkw['x_goal'].numpy(), np.asarray(jkw['x_goal']),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize('over', [
    dict(constraints=BENCH_CONSTRAINTS, done_on_violation=True),
    dict(constraints=BENCH_CONSTRAINTS, use_constraint_penalty=True),
    dict(constraints=BENCH_CONSTRAINTS[:1]),
    dict(constraints=[BENCH_CONSTRAINTS[0], dict(BENCH_CONSTRAINTS[1], strict=True)]),
    dict(init_state_randomization_info={
        k: {'distrib': 'normal', 'loc': 0.0, 'scale': 0.1}
        for k in ('init_x', 'init_x_dot', 'init_z', 'init_z_dot', 'init_theta',
                  'init_theta_dot')}),
], ids=['done-on-violation', 'penalty', 'state-box-only', 'strict-input', 'normal-init'])
def test_cfg_gates_unsupported_like_jax(over):
    import safe_control_gym_tpu.ops.rollout_kernels as jrk
    kw = dict(_base(2), randomized_init=True, **over)
    with pytest.raises(ValueError):
        jrk._quad_rollout_cfg(jmake('quadrotor', **kw))
    with pytest.raises(ValueError):
        trk.quad_rollout_cfg(tmake('quadrotor', device='cpu', **kw))


@pytest.mark.parametrize('attr,value', [('PHYSICS', 'pyb_drag'), ('QUAD_TYPE', 1),
                                        ('Q', np.ones((6, 6)))])
def test_cfg_gates_the_physics_quad_type_and_dense_costs(attr, value):
    """Modes the env itself refuses today are still outside the kernel's
    coverage: the gate holds even for an env that carries them."""
    te = tmake('quadrotor', device='cpu', **dict(_base(2), cost='quadratic'))
    setattr(te, attr, value)
    with pytest.raises(ValueError):
        trk.quad_rollout_cfg(te)


def test_kernel_source_keeps_the_cfg_layout_and_flags():
    """csrc/quad_kernels.cu states the offsets of ``_Q`` and the mode bits of
    ``_FLAGS`` by hand (the mode bits in csrc/rollout_modes.cuh, which K4 and
    K5 share); they must agree."""
    csrc = os.path.join(os.path.dirname(trk.__file__), '..', 'csrc')
    source = ''.join(open(os.path.join(csrc, f)).read()
                     for f in ('quad_kernels.cu', 'rollout_modes.cuh'))
    enums = dict((k, int(v)) for k, v in re.findall(r'\b([A-Z][A-Z0-9_]*) = (\d+)', source))
    for name, off in trk._Q.items():
        assert enums[name] == off, name
    assert enums['QUAD_CFG_LEN'] == trk.QUAD_CFG_LEN
    for name, bit in trk._FLAGS.items():
        assert enums['F_' + name.upper()] == bit, name


def _probe_cfg(te, **entries):
    """The env's cfg with the reward reduced to what a test reads off."""
    cfg = trk.quad_rollout_cfg(te)
    cfg[trk._Q['W_STATE']:trk._Q['W_STATE'] + 12] = 0.0
    cfg[trk._Q['U_GOAL']:trk._Q['U_GOAL'] + 4] = 0.0
    for name, v in entries.items():
        cfg[trk._Q[name]:trk._Q[name] + np.size(v)] = torch.as_tensor(v)
    return cfg


@pytest.mark.parametrize('quad_type', [2, 3])
def test_philox_word_layout(quad_type):
    """Counter (env, step, j, 0): j = 0 the action draws, j = 1 the noise
    uniforms in (cos, sin) Box-Muller pairs, j = 3.. the reset state words."""
    te = tmake('quadrotor', device='cpu', **_base(quad_type))
    nx, nu = te.state_dim, te.action_dim
    B, seed = 256, 1234
    env = torch.arange(B, dtype=torch.int64)
    s0 = torch.zeros((B, nx))
    common = dict(n_substeps=2, dt=1e-3, rew_exponential=False, done_on_oob=False)
    roll = trk.quad2d_rollout if quad_type == 2 else trk.quad3d_rollout
    # j = 0: reward = -sum_d (ACT_LO + u_d (ACT_HI - ACT_LO))^2.
    cfg = _probe_cfg(te, W_ACT=[1.0] * nu)
    u = trk.philox_uniform4(seed, env, 0, 0)
    lo, hi = float(cfg[trk._Q['ACT_LO']]), float(cfg[trk._Q['ACT_HI']])
    want = -sum((lo + u[d] * float(np.float32(hi) - np.float32(lo))) ** 2 for d in range(nu))
    out = roll(s0, cfg, seed, 1, randomized_reset=False, **common)
    torch.testing.assert_close(out['reward_sum'], want, rtol=1e-5, atol=0)
    # j = 1: replayed zero actions plus unit noise: reward = -sum_d n_d^2.
    cfg = _probe_cfg(te, W_ACT=[1.0] * nu, NOISE_STD=1.0)
    u = trk.philox_uniform4(seed, env, 0, 1)
    normals = [n for d in range(0, nu, 2) for n in trk.standard_normal_pair(u[d], u[d + 1])]
    out = roll(s0, cfg, seed, 1, actions=torch.zeros((1, B, nu)), draw_actions=False,
               action_noise=True, randomized_reset=False, **common)
    torch.testing.assert_close(out['reward_sum'], -sum(n * n for n in normals),
                               rtol=1e-5, atol=0)
    # j = 3..5: every env is done at its first step and starts afresh.
    cfg = _probe_cfg(te, MAX_STEPS=1.0, INIT_LO=[-1.0] * nx, INIT_HI=[3.0] * nx)
    u = [w for j in range(3, 3 + (nx + 3) // 4) for w in trk.philox_uniform4(seed, env, 0, j)]
    out = roll(s0, cfg, seed, 1, randomized_reset=True, **common)
    torch.testing.assert_close(out['state'], torch.stack([-1.0 + 4.0 * w for w in u[:nx]], 1),
                               rtol=0, atol=0)
    assert out['done_count'].eq(1).all()


def _welch(a, b, z=6.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= z * se + 1e-9, (a.mean(), b.mean(), se)
    if min(a.var(), b.var()) > 1e-12:
        assert 0.5 < a.var() / b.var() < 2.0


@pytest.mark.parametrize('system', ['quadrotor', 'quadrotor_3D'])
def test_stochastic_mode_matches_per_step_path_in_distribution(system):
    """Under the constrained benchmark config, the per-env reward, done and
    violation rates of the stochastic plain K5 (Philox actions and noise) and
    of the per-step path (torch's generator) agree: Welch z-test, z = 6."""
    B, T = 128, 100
    te = tmake('quadrotor', device='cpu', **_env_kwargs(system, True))
    gen = torch.Generator().manual_seed(5)
    states, _ = te.func.reset_batch(gen, B)
    cfg = trk.quad_rollout_cfg(te)
    cfg[trk._Q['NOISE_STD']] = float(te.disturbances['action'].disturbances[0].std[0])
    roll = trk.quad2d_rollout if system == 'quadrotor' else trk.quad3d_rollout
    k = roll(states.state, cfg, 11, T, te.PYB_STEPS_PER_CTRL, te.PYB_TIMESTEP,
             constrained=True, randomized_reset=te.RANDOMIZED_INIT)
    lo = torch.as_tensor(te.action_space.low)
    hi = torch.as_tensor(te.action_space.high)
    actions = lo + torch.rand((T, B, te.action_dim), generator=gen) * (hi - lo)
    _, s = per_step_rollout(te, states, actions, gen)
    assert float(k['done_count'].mean()) > 0 and float(k['violation_count'].mean()) > 0
    for key in ('reward_sum', 'done_count', 'violation_count'):
        _welch(k[key].numpy() / T, s[key].numpy() / T)


def test_policy_mode_and_replay_without_actions_raise():
    te = tmake('quadrotor', device='cpu', **_base(2))
    cfg = trk.quad_rollout_cfg(te)
    s0 = torch.zeros((4, 6))
    zero = [{'w': np.zeros(s, np.float32), 'b': np.zeros(s[1], np.float32)}
            for s in ((6, 8), (8, 8), (8, 2))]
    pp = trk.pack_policy_params(zero, 6, device='cpu')
    with pytest.raises(ValueError, match='replaces'):   # the policy is the action source
        trk.quad2d_rollout(s0, cfg, 0, 4, 20, 1e-3, policy_params=pp)
    with pytest.raises(ValueError, match='replaces'):
        trk.quad2d_rollout(s0, cfg, 0, 4, 20, 1e-3, draw_actions=False,
                           actions=torch.zeros((4, 4, 2)), policy_params=pp)
    with pytest.raises(ValueError):
        trk.quad3d_rollout(torch.zeros((4, 12)), cfg, 0, 4, 20, 1e-3, draw_actions=False)


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['benchmark', 'ragged_4109', 'substeps_7', 'hover',
                                  'large_batch_65536'])
@pytest.mark.parametrize('system', ['quadrotor', 'quadrotor_3D'])
def test_cuda_kernel_matches_plain_version(system, case):
    """The CUDA kernel equals its plain version bit for bit: the constrained
    benchmark config at B=4096, a batch that is no multiple of a warp, the
    general path over a runtime substep count, a hover start (3D: zero
    numerators in the quotients), and a batch in blocks of 256 threads."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import (hover_actions,
                                                                        hover_case)
    dev = torch.device('cuda')
    te = tmake('quadrotor', device=dev, **_env_kwargs(system, True))
    cfg = trk.quad_rollout_cfg(te)
    cfg[trk._Q['NOISE_STD']] = 0.1
    B, T = {'ragged_4109': 4109, 'large_batch_65536': 65536}.get(case, 4096), 64
    states, _ = te.func.reset_batch(torch.Generator(device=dev).manual_seed(0), B)
    s0 = states.state.contiguous()
    kw = dict(n_substeps=7 if case == 'substeps_7' else 20, dt=1e-3, constrained=True)
    if case == 'hover':
        hover, raw, cfg, kw = hover_case(system, dev)
        s0 = hover.expand(B, -1).contiguous()
        kw = dict(kw, actions=hover_actions(system, raw, T, B))
    roll = trk.quad2d_rollout if system == 'quadrotor' else trk.quad3d_rollout
    before = roll.launches
    k = roll(s0, cfg, 3, T, **kw)
    p = trk.quad_rollout_plain(2 if system == 'quadrotor' else 3, s0, cfg, 3, T, **kw)
    torch.cuda.synchronize()
    assert roll.launches == before + 1
    for key in ('state', 'reward_sum', 'done_count', 'ctrl_step', 'violation_count'):
        assert torch.equal(k[key], p[key]), key
