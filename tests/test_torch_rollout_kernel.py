"""K4 (``ops/rollout_kernels.py``): the plain version of the whole-rollout
kernel against the JAX package's Pallas kernel in interpret mode and against
the port's own per-step path, in replay mode (fixed actions, deterministic
resets): states atol 1e-4, reward sums rtol/atol 1e-4, done counts, step
counters and violation counts exact. Also the cfg vector against JAX's, the
coverage gates, the Philox generator and its uniform / Box-Muller moments, and
the stochastic mode against the per-step path in distribution. The CUDA kernel
is held to the plain version on the card."""

import dataclasses
import functools

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

BASE = dict(seed=0, ctrl_freq=50, pyb_freq=1000, episode_len_sec=0.4,
            randomized_init=False, init_state={'init_x': 0.1},
            task_info={'stabilization_goal': [0],
                       'stabilization_goal_tolerance': 0.0})
TRACK = dict(episode_len_sec=1.0, init_state={'init_x': 0.0}, task='traj_tracking',
             task_info={'trajectory_type': 'circle', 'num_cycles': 1,
                        'trajectory_plane': 'zx', 'trajectory_position_offset': [0, 0],
                        'trajectory_scale': 0.2})
BENCH_CONSTRAINTS = [
    {'constraint_form': 'default_constraint', 'constrained_variable': 'state'},
    {'constraint_form': 'default_constraint', 'constrained_variable': 'input'},
]


def _state_dict(est):
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name != 'dyn_params'}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def _replay_three_ways(monkeypatch, over, B, T, act_range, seed, key, constrained=False):
    """Run one replay through the JAX Pallas kernel (interpreted), the port's
    plain K4 and the port's per-step path, from one state. Returns the three
    results as dicts of numpy arrays."""
    import safe_control_gym_tpu.ops.rollout_kernels as jrk
    monkeypatch.setattr(jrk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    kw = dict(BASE, **over)
    je, te = jmake('cartpole', **kw), tmake('cartpole', device='cpu', **kw)
    actions = np.random.default_rng(seed).uniform(*act_range, (T, B)).astype(np.float32)
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(key), B)
    tst = env_state_from_numpy(_state_dict(jst), 'cpu')
    mode = dict(draw_actions=False, constrained=constrained, action_noise=False,
                randomized_reset=False)

    jkw = jrk.rollout_task_kwargs(je)
    jout = jrk.cartpole_rollout_pallas(
        jst.state, jrk.cartpole_rollout_cfg(je), 0, n_steps=T,
        n_substeps=je.PYB_STEPS_PER_CTRL, dt=je.PYB_TIMESTEP,
        actions=jnp.asarray(actions), **mode, **jkw)
    tout = trk.cartpole_rollout(
        tst.state, trk.cartpole_rollout_cfg(te), 0, n_steps=T,
        n_substeps=te.PYB_STEPS_PER_CTRL, dt=te.PYB_TIMESTEP,
        actions=torch.as_tensor(actions), **mode, **trk.rollout_task_kwargs(te))
    st, stats = per_step_rollout(te, tst, torch.as_tensor(actions)[:, :, None],
                                 torch.Generator().manual_seed(0))
    step = dict(stats, state=st.state, ctrl_step=st.ctrl_step.to(torch.float32))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return as_np(jout), as_np(tout), as_np(step)


def _assert_same(got, ref, counts_violations=False):
    np.testing.assert_allclose(got['state'], ref['state'], atol=1e-4)
    np.testing.assert_array_equal(got['done_count'], ref['done_count'])
    np.testing.assert_array_equal(got['ctrl_step'], ref['ctrl_step'])
    np.testing.assert_allclose(got['reward_sum'], ref['reward_sum'], rtol=1e-4, atol=1e-4)
    if counts_violations:
        np.testing.assert_array_equal(got['violation_count'], ref['violation_count'])


def test_replay_matches_pallas_and_per_step_path(monkeypatch):
    jout, tout, step = _replay_three_ways(monkeypatch, {}, B=128, T=60,
                                          act_range=(-2, 2), seed=3, key=1)
    _assert_same(tout, jout)
    _assert_same(tout, step)
    assert tout['done_count'].sum() > 0


def test_replay_oob_dones(monkeypatch):
    jout, tout, step = _replay_three_ways(
        monkeypatch, dict(init_state={'init_theta': 1.5}, episode_len_sec=2.0),
        B=64, T=40, act_range=(-8, 8), seed=4, key=2)
    assert step['done_count'].max() > 0  # theta 1.5 rad tips over fast
    _assert_same(tout, jout)
    _assert_same(tout, step)


def test_constrained_replay_counts_violations(monkeypatch):
    jout, tout, step = _replay_three_ways(
        monkeypatch, dict(episode_len_sec=2.0, constraints=BENCH_CONSTRAINTS),
        B=64, T=40, act_range=(-12, 12), seed=6, key=3, constrained=True)
    assert step['violation_count'].sum() > 0
    _assert_same(tout, jout, counts_violations=True)
    _assert_same(tout, step, counts_violations=True)


@pytest.mark.parametrize('cost', ['rl_reward', 'quadratic'])
def test_tracking_replay(monkeypatch, cost):
    """Each env reads its own waypoint, X_GOAL[step + 1] under the RL reward
    and X_GOAL[step] under the quadratic cost, also after resets have
    desynchronized the batch."""
    jout, tout, step = _replay_three_ways(monkeypatch, dict(TRACK, cost=cost),
                                          B=64, T=70, act_range=(-5, 5), seed=8, key=5)
    assert step['ctrl_step'].max() > step['ctrl_step'].min()
    _assert_same(tout, jout)
    _assert_same(tout, step)


def test_quadratic_cost_stabilization_replay(monkeypatch):
    jout, tout, step = _replay_three_ways(
        monkeypatch, dict(cost='quadratic', episode_len_sec=2.0),
        B=64, T=40, act_range=(-12, 12), seed=9, key=6)
    _assert_same(tout, jout)
    _assert_same(tout, step)


@pytest.mark.parametrize('over', [
    {}, dict(cost='quadratic', rew_state_weight=[1, 2, 3, 4], rew_act_weight=0.5),
    TRACK, dict(normalized_rl_action_space=True, randomized_init=True),
    dict(constraints=BENCH_CONSTRAINTS, init_state={'init_theta': 0.3}),
], ids=['default', 'quadratic', 'tracking', 'normalized-randomized', 'constrained'])
def test_cfg_vector_matches_jax(over):
    import safe_control_gym_tpu.ops.rollout_kernels as jrk
    kw = dict(BASE, **over)
    je, te = jmake('cartpole', **kw), tmake('cartpole', device='cpu', **kw)
    np.testing.assert_array_equal(trk.cartpole_rollout_cfg(te).numpy(),
                                  np.asarray(jrk.cartpole_rollout_cfg(je)))
    jkw, tkw = jrk.rollout_task_kwargs(je), trk.rollout_task_kwargs(te)
    assert set(jkw) == set(tkw)
    if 'x_goal' in tkw:
        np.testing.assert_array_equal(tkw['x_goal'].numpy(), np.asarray(jkw['x_goal']))


@pytest.mark.parametrize('over', [
    dict(constraints=BENCH_CONSTRAINTS, done_on_violation=True),
    dict(constraints=BENCH_CONSTRAINTS[:1]),
    dict(constraints=[BENCH_CONSTRAINTS[0], dict(BENCH_CONSTRAINTS[1], strict=True)]),
    dict(obs_wrap_angle=True),
    dict(init_state_randomization_info={
        k: {'distrib': 'normal', 'loc': 0.0, 'scale': 0.1}
        for k in ('init_x', 'init_x_dot', 'init_theta', 'init_theta_dot')}),
], ids=['done-on-violation', 'state-box-only', 'strict-input', 'wrapped-obs',
        'normal-init'])
def test_cfg_gates_unsupported(over):
    te = tmake('cartpole', device='cpu', **dict(BASE, randomized_init=True, **over))
    with pytest.raises(ValueError):
        trk.cartpole_rollout_cfg(te)


def test_policy_mode_and_replay_without_actions_raise():
    te = tmake('cartpole', device='cpu', **BASE)
    cfg = trk.cartpole_rollout_cfg(te)
    s0 = torch.zeros((4, 4))
    zero = [{'w': np.zeros(s, np.float32), 'b': np.zeros(s[1], np.float32)}
            for s in ((4, 8), (8, 8), (8, 1))]
    pp = trk.pack_policy_params(zero, 4, device='cpu')
    with pytest.raises(ValueError, match='replaces'):   # the policy is the action source
        trk.cartpole_rollout(s0, cfg, 0, 4, 20, 1e-3, policy_params=pp)
    with pytest.raises(ValueError, match='replaces'):
        trk.cartpole_rollout(s0, cfg, 0, 4, 20, 1e-3, draw_actions=False,
                             actions=torch.zeros((4, 4)), policy_params=pp)
    with pytest.raises(ValueError):
        trk.cartpole_rollout(s0, cfg, 0, 4, 20, 1e-3, draw_actions=False)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ([0, 0, 0, 0], [0, 0],
         [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]),
        ([0xffffffff] * 4, [0xffffffff] * 2,
         [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]),
        ([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344], [0xa4093822, 0x299f31d0],
         [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]),
    ]
    for ctr, key, want in cases:
        got = trk.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
        assert [int(g) for g in got] == want


def _draws(n_env=4096, n_steps=32):
    env = torch.arange(n_env, dtype=torch.int64)
    u = [trk.philox_uniform4(17, env, t, j) for t in range(n_steps) for j in (0, 1)]
    return torch.stack([w for four in u for w in four]).numpy().astype(np.float64)


def test_uniform_moments():
    """The protocol of tests/test_kernel_stochastic_tpu.py at CPU size: mean,
    variance and quartiles within 6 standard errors, against U[0, 1)."""
    s = _draws().ravel()
    n = s.size
    assert s.min() >= 0.0 and s.max() < 1.0
    assert abs(s.mean() - 0.5) < 6 * np.sqrt(1 / 12 / n)
    assert abs(s.var() - 1 / 12) < 6 * np.sqrt(1 / 180 / n)
    for q in (0.25, 0.5, 0.75):
        assert abs((s < q).mean() - q) < 6 * np.sqrt(q * (1 - q) / n)
    # Distinct streams: envs, steps and the two counter halves do not repeat.
    # Values lie on a 2^-24 grid, so ~n / 2^25 of them collide by chance (3%).
    assert np.unique(s).size > (1 - 2 * n / 2 ** 25) * n


def test_box_muller_moments():
    u = torch.as_tensor(_draws())
    s = trk.standard_normal(u[0::2].float(), u[1::2].float()).numpy().astype(np.float64).ravel()
    n = s.size
    assert abs(s.mean()) < 6 / np.sqrt(n)
    assert abs(s.var() - 1.0) < 6 * np.sqrt(2 / n)
    sk = ((s - s.mean()) ** 3).mean() / s.std() ** 3
    ku = ((s - s.mean()) ** 4).mean() / s.std() ** 4 - 3.0
    assert abs(sk) < 6 * np.sqrt(6 / n)
    assert abs(ku) < 6 * np.sqrt(24 / n)
    tail = (np.abs(s) > 1.959964).mean()
    assert abs(tail - 0.05) < 6 * np.sqrt(0.05 * 0.95 / n)


def _welch(a, b, z=6.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= z * se + 1e-9, (a.mean(), b.mean(), se)
    if min(a.var(), b.var()) > 1e-12:
        assert 0.5 < a.var() / b.var() < 2.0


@pytest.mark.parametrize('constrained', [False, True])
def test_stochastic_mode_matches_per_step_path_in_distribution(constrained):
    """Under the benchmark config, the per-env reward, done and violation
    rates of the stochastic plain K4 and of the per-step path agree (Welch
    z-test, z = 6), at CPU size."""
    B, T = 128, 100
    te = tmake('cartpole', device='cpu', **_env_kwargs('cartpole', constrained))
    gen = torch.Generator().manual_seed(5)
    states, _ = te.func.reset_batch(gen, B)
    cfg = trk.cartpole_rollout_cfg(te)
    if constrained:
        cfg[trk._C['NOISE_STD']] = float(te.disturbances['action'].disturbances[0].std[0])
    k = trk.cartpole_rollout(states.state, cfg, 11, T, te.PYB_STEPS_PER_CTRL,
                             te.PYB_TIMESTEP, constrained=constrained)
    lo, hi = float(te.action_space.low[0]), float(te.action_space.high[0])
    actions = lo + torch.rand((T, B, 1), generator=gen) * (hi - lo)
    _, s = per_step_rollout(te, states, actions, gen)
    assert float(k['done_count'].mean()) > 0
    for key in ('reward_sum', 'done_count') + (('violation_count',) if constrained else ()):
        _welch(k[key].numpy() / T, s[key].numpy() / T)
    if constrained:
        assert float(k['violation_count'].mean()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['benchmark', 'ragged_4109', 'substeps_7', 'hover'])
def test_cuda_kernel_matches_plain_version(case):
    """The CUDA kernel equals its plain version bit for bit: the constrained
    benchmark config at B=4096, a batch that is no multiple of a warp, the
    general path over a runtime substep count, and a hover start."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import (hover_actions,
                                                                        hover_case)
    dev = torch.device('cuda')
    te = tmake('cartpole', device=dev, **_env_kwargs('cartpole', True))
    cfg = trk.cartpole_rollout_cfg(te)
    cfg[trk._C['NOISE_STD']] = 0.1
    B, T = (4109 if case == 'ragged_4109' else 4096), 64
    states, _ = te.func.reset_batch(torch.Generator(device=dev).manual_seed(0), B)
    s0 = states.state.contiguous()
    kw = dict(n_substeps=7 if case == 'substeps_7' else 20, dt=1e-3, constrained=True)
    if case == 'hover':
        hover, raw, cfg, kw = hover_case('cartpole', dev)
        s0 = hover.expand(B, -1).contiguous()
        kw = dict(kw, actions=hover_actions('cartpole', raw, T, B))
    before = trk.cartpole_rollout.launches
    k = trk.cartpole_rollout(s0, cfg, 3, T, **kw)
    p = trk.cartpole_rollout_plain(s0, cfg, 3, T, **kw)
    torch.cuda.synchronize()
    assert trk.cartpole_rollout.launches == before + 1
    for key in ('state', 'reward_sum', 'done_count', 'ctrl_step', 'violation_count'):
        assert torch.equal(k[key], p[key]), key
