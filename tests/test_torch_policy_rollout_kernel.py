"""K4 and K5 in policy mode (``ops/rollout_kernels.py``): the plain versions of
the closed-loop rollout against the JAX package's Pallas kernels in interpret
mode, from one state and one actor (states and reward sums rtol/atol 1e-4,
done counts exact): cartpole with tanh and folded obs normalization whose clip
binds, the 2D and 3D quads with relu and squash, one actor 256 wide. Also the
Philox word layout of the stochastic policy mode, the packing, the argument
checks, the cfg builders' partial init randomization (and the JAX cfg
builder's KeyError on it), and the CUDA kernels against the plain versions on
the card."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from safe_control_gym_tpu.controllers.ppo.ppo_utils import init_actor_critic
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.experiments.rl_configs import eval_config
from safe_control_gym_tpu_torch.ops import rollout_kernels as trk
from safe_control_gym_tpu_torch.utils.registration import make as tmake

CARTPOLE = dict(seed=0, ctrl_freq=50, pyb_freq=1000, episode_len_sec=0.4,
                randomized_init=False, init_state={'init_x': 0.1},
                task_info={'stabilization_goal': [0], 'stabilization_goal_tolerance': 0.0})


def _quad(quad_type):
    goal = [0, 1] if quad_type == 2 else [0, 0, 1]
    return dict(quad_type=quad_type, seed=0, ctrl_freq=50, pyb_freq=1000,
                episode_len_sec=0.4, randomized_init=False, init_state={'init_z': 1.0},
                task_info={'stabilization_goal': goal, 'stabilization_goal_tolerance': 0.0})


def _interpret(monkeypatch):
    import safe_control_gym_tpu.ops.rollout_kernels as jrk
    monkeypatch.setattr(jrk.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    return jrk


def _actor(key, nx, nu_out, hidden, out_scale):
    """A PPO-initialized actor as numpy, its last layer scaled up so that the
    actions move the state."""
    actor = init_actor_critic(jax.random.PRNGKey(key), nx, nu_out, [hidden] * 2)['actor']
    actor = [{k: np.asarray(v, np.float32) for k, v in layer.items()} for layer in actor]
    actor[-1]['w'] = actor[-1]['w'] * np.float32(out_scale)
    return actor


def _compare(jout, tout, nx):
    np.testing.assert_allclose(tout['state'].numpy(), np.asarray(jout['state'])[:, :nx],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout['reward_sum'].numpy(), np.asarray(jout['reward_sum']),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tout['done_count'].numpy(),
                                  np.asarray(jout['done_count']))
    np.testing.assert_array_equal(tout['ctrl_step'].numpy(), np.asarray(jout['ctrl_step']))


def test_cartpole_policy_with_obs_normalization_matches_jax(monkeypatch):
    jrk = _interpret(monkeypatch)
    je, te = jmake('cartpole', **CARTPOLE), tmake('cartpole', device='cpu', **CARTPOLE)
    B, T = 64, 40
    actor = _actor(9, 4, 1, 64, 100.0)
    rng = np.random.default_rng(4)
    mean = rng.uniform(-0.1, 0.1, 4).astype(np.float32)
    var = np.array([0.5, 2.0, 0.1, 1e-4], np.float32)   # dim 3 makes clip_obs bind
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(2), B)
    common = dict(n_steps=T, n_substeps=je.PYB_STEPS_PER_CTRL, dt=je.PYB_TIMESTEP,
                  draw_actions=False, randomized_reset=False, clip_obs=2.0)
    jout = jrk.cartpole_rollout_pallas(
        jst.state, jrk.cartpole_rollout_cfg(je), 0,
        policy_params=jrk.pack_policy_params(actor, nx=4, rows=8, obs_mean=mean,
                                             obs_var=var), **common)
    pp = trk.pack_policy_params(actor, 4, obs_mean=mean, obs_var=var, device='cpu')
    tout = trk.cartpole_rollout(torch.tensor(np.asarray(jst.state)),
                                trk.cartpole_rollout_cfg(te), 0, policy_params=pp, **common)
    assert float(tout['done_count'].sum()) > 0
    _compare(jout, tout, 4)


@pytest.mark.parametrize('quad_type,hidden,B,T', [(2, 64, 32, 30), (3, 64, 32, 30),
                                                  (3, 256, 8, 12)])
def test_quad_policy_relu_squash_matches_jax(monkeypatch, quad_type, hidden, B, T):
    jrk = _interpret(monkeypatch)
    kw = _quad(quad_type)
    je, te = jmake('quadrotor', **kw), tmake('quadrotor', device='cpu', **kw)
    nx, nu = te.state_dim, te.action_dim
    # A SAC-shaped output layer (mean and log-std) of which the first nu rows
    # act.
    actor = _actor(11, nx, 2 * nu, hidden, 50.0)
    jst, _ = je.func.reset_batch(jax.random.PRNGKey(3), B)
    common = dict(n_substeps=je.PYB_STEPS_PER_CTRL, dt=je.PYB_TIMESTEP, draw_actions=False,
                  randomized_reset=False, policy_squash=True, policy_activation='relu')
    jroll = jrk.quad2d_rollout_pallas if quad_type == 2 else jrk.quad3d_rollout_pallas
    jout = jroll(jst.state, jrk._quad_rollout_cfg(je), 0, T,
                 policy_params=jrk.pack_policy_params(actor, nx=nx, rows=16), **common)
    troll = trk.quad2d_rollout if quad_type == 2 else trk.quad3d_rollout
    tout = troll(torch.tensor(np.asarray(jst.state)), trk.quad_rollout_cfg(te), 0, T,
                 policy_params=trk.pack_policy_params(actor, nx, device='cpu'), **common)
    _compare(jout, tout, nx)


@pytest.mark.parametrize('system', ['cartpole', 'quadrotor', 'quadrotor_3D'])
def test_stochastic_policy_draws_its_pinned_philox_words(system):
    """A zero actor with P_STD = 1 makes the policy's action its exploration
    noise: the rollout must equal a replay of the Box-Muller normals of the
    pinned words (K4: counter j = 0, words 0 and 3, cos half; K5: j = 2, in
    pairs, cos then sin)."""
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import _env_kwargs
    env = tmake(system.replace('_3D', ''), device='cpu', **_env_kwargs(system, False))
    nx, nu, B, T, seed = env.state_dim, env.action_dim, 16, 5, 1234
    cartpole = system == 'cartpole'
    layout = trk._C if cartpole else trk._Q
    cfg = trk.cartpole_rollout_cfg(env) if cartpole else trk.quad_rollout_cfg(env)
    cfg[layout['P_STD']:layout['P_STD'] + nu] = 1.0
    zero = [{'w': np.zeros(shape, np.float32), 'b': np.zeros(shape[1], np.float32)}
            for shape in ((nx, 16), (16, 16), (16, nu))]
    state0 = env.func.reset_batch(torch.Generator().manual_seed(0), B)[0].state
    env_idx = torch.arange(B, dtype=torch.int64)
    normals = []
    for t in range(T):
        if cartpole:
            u = trk.philox_uniform4(seed, env_idx, t, 0)
            normals.append(trk.standard_normal(u[0], u[3])[:, None])
        else:
            u = trk.philox_uniform4(seed, env_idx, t, 2)
            pairs = [trk.standard_normal_pair(u[d], u[d + 1]) for d in range(0, nu, 2)]
            normals.append(torch.stack([n for pair in pairs for n in pair], dim=1))
    actions = torch.stack(normals)                           # (T, B, nu)
    roll = (trk.cartpole_rollout if cartpole
            else trk.quad2d_rollout if system == 'quadrotor' else trk.quad3d_rollout)
    common = dict(n_substeps=env.PYB_STEPS_PER_CTRL, dt=env.PYB_TIMESTEP,
                  randomized_reset=False)
    policy = roll(state0, cfg, seed, T, draw_actions=False, policy_stochastic=True,
                  policy_params=trk.pack_policy_params(zero, nx, device='cpu'), **common)
    replay = roll(state0, cfg, seed, T, draw_actions=False,
                  actions=actions[..., 0] if cartpole else actions, **common)
    for key in ('state', 'reward_sum', 'done_count', 'ctrl_step'):
        assert torch.equal(policy[key], replay[key]), key


def test_pack_policy_params_layout_and_checks():
    rng = np.random.default_rng(0)
    actor = [{'w': rng.normal(size=s).astype(np.float32),
              'b': rng.normal(size=s[1]).astype(np.float32)}
             for s in ((6, 8), (8, 16), (16, 4))]
    var = rng.uniform(0.1, 2.0, 6).astype(np.float32)
    pp = trk.pack_policy_params(actor, 6, obs_mean=np.ones(6), obs_var=var, device='cpu')
    assert (pp.nx, pp.h1, pp.h2, pp.nu_out) == (6, 8, 16, 4)
    buf = pp.buffer.numpy()
    np.testing.assert_array_equal(buf[6:12], 1.0 / np.sqrt(var + 1e-8))   # ninv as JAX
    w1_at = 12
    np.testing.assert_array_equal(buf[w1_at:w1_at + 48].reshape(6, 8), actor[0]['w'])
    assert buf.size == 12 + 48 + 8 + 128 + 16 + 64 + 4
    with pytest.raises(ValueError):
        trk.pack_policy_params(actor[:2], 6, device='cpu')
    with pytest.raises(ValueError):
        trk.pack_policy_params(actor, 4, device='cpu')
    env = tmake('cartpole', device='cpu', **CARTPOLE)
    cfg = trk.cartpole_rollout_cfg(env)
    s0 = torch.zeros((4, 4))
    small = trk.pack_policy_params([{'w': np.zeros(s, np.float32), 'b': np.zeros(s[1], np.float32)}
                                    for s in ((4, 8), (8, 8), (8, 1))], 4, device='cpu')
    with pytest.raises(ValueError, match='replaces'):   # policy mode draws no actions
        trk.cartpole_rollout(s0, cfg, 0, 2, 20, 1e-3, policy_params=small)
    with pytest.raises(ValueError, match='tanh or relu'):
        trk.cartpole_rollout(s0, cfg, 0, 2, 20, 1e-3, draw_actions=False,
                             policy_params=small, policy_activation='elu')


@pytest.mark.parametrize('h1,h2,ok', [(64, 64, True), (256, 256, True), (384, 8, True),
                                      (60, 64, False), (64, 12, False), (392, 64, False)])
def test_policy_launch_takes_one_warp_and_widths_in_eighths(h1, h2, ok):
    """A policy-mode launch runs one warp a block; the kernel computes hidden
    units eight at a time, and one warp's first hidden layer must fit in the
    48 KB of shared memory a launch gets without opting in."""
    pp = trk.pack_policy_params([{'w': np.zeros(s, np.float32), 'b': np.zeros(s[1], np.float32)}
                                 for s in ((4, h1), (h1, h2), (h2, 2))], 4, device='cpu')
    launch = functools.partial(trk._policy_launch, pp, 4, 1, 4096, torch.device('cpu'), 'k')
    if ok:
        _ptr, got_h1, got_h2, nu_out, threads = launch()
        assert (got_h1, got_h2, nu_out, threads) == (h1, h2, 2, 32)
        assert h1 * threads * 4 <= 48 * 1024
    else:
        with pytest.raises(ValueError, match='multiples of 8'):
            launch()


def test_partial_init_randomization_is_nominal_elsewhere():
    """quadrotor_3D_stab.yaml randomizes init_x, init_y and init_z only: the
    port's cfg widens those three dims and leaves the other nine at their
    nominal values, where the plain K5's fresh states then sit exactly; the
    JAX cfg builder raises KeyError on the same config."""
    env_id, task_config, _ = eval_config('sac', 'quadrotor_3D')
    te = tmake(env_id, device='cpu', **task_config)
    cfg = trk.quad_rollout_cfg(te).numpy()
    lo = cfg[trk._Q['INIT_LO']:trk._Q['INIT_LO'] + 12]
    hi = cfg[trk._Q['INIT_HI']:trk._Q['INIT_HI'] + 12]
    nominal = np.asarray(te._nominal_init_state(), np.float32)
    widened = lo != hi
    assert sorted(np.flatnonzero(widened)) == [0, 2, 4]        # x, y, z
    np.testing.assert_array_equal(lo[~widened], nominal[~widened])
    np.testing.assert_allclose(hi[widened] - lo[widened], 0.6, rtol=1e-6)
    # Every env is done after one step, so the final states are fresh ones.
    cfg_t = torch.tensor(cfg)
    cfg_t[trk._Q['MAX_STEPS']] = 1.0
    B = 64
    out = trk.quad3d_rollout(torch.zeros((B, 12)), cfg_t, 5, 1, te.PYB_STEPS_PER_CTRL,
                             te.PYB_TIMESTEP, randomized_reset=True)
    fresh = out['state'].numpy()
    np.testing.assert_array_equal(fresh[:, ~widened], np.broadcast_to(nominal[~widened],
                                                                      (B, 9)))
    assert np.all((fresh[:, widened] >= lo[widened]) & (fresh[:, widened] <= hi[widened]))
    assert np.unique(fresh[:, 0]).size > 1
    # The reference package's builder indexes every label.
    import safe_control_gym_tpu.ops.rollout_kernels as jrk
    with pytest.raises(KeyError):
        jrk._quad_rollout_cfg(jmake(env_id, **task_config))


def test_cartpole_partial_init_randomization():
    kw = dict(CARTPOLE, randomized_init=True, init_state_randomization_info={
        'init_theta': {'distrib': 'uniform', 'low': -0.05, 'high': 0.05}})
    cfg = trk.cartpole_rollout_cfg(tmake('cartpole', device='cpu', **kw)).numpy()
    lo = cfg[trk._C['INIT_LO']:trk._C['INIT_LO'] + 4]
    hi = cfg[trk._C['INIT_HI']:trk._C['INIT_HI'] + 4]
    np.testing.assert_array_equal(lo, np.float32([0.1, 0.0, -0.05, 0.0]))
    np.testing.assert_array_equal(hi, np.float32([0.1, 0.0, 0.05, 0.0]))
    kw['init_state_randomization_info'] = {'init_x': {'distrib': 'normal', 'scale': 0.1}}
    with pytest.raises(ValueError, match='uniform'):
        trk.cartpole_rollout_cfg(tmake('cartpole', device='cpu', **kw))


@pytest.mark.gpu
def test_cuda_policy_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from safe_control_gym_tpu_torch.experiments.benchmark_suite import (_env_kwargs,
                                                                        _kernel_cfg)
    dev = torch.device('cuda')
    for system, roll in (('cartpole', trk.cartpole_rollout), ('quadrotor', trk.quad2d_rollout),
                         ('quadrotor_3D', trk.quad3d_rollout)):
        env = tmake(system.replace('_3D', ''), device=dev, **_env_kwargs(system, True))
        nx, nu = env.state_dim, env.action_dim
        cfg = _kernel_cfg(system, env, True)
        layout = trk._C if system == 'cartpole' else trk._Q
        cfg[layout['P_STD']:layout['P_STD'] + nu] = 0.5
        s0 = env.func.reset_batch(torch.Generator(device=dev).manual_seed(0), 4096)[0].state
        for hidden, act, stoch, squash in ((64, 'tanh', True, False),
                                           (256, 'relu', False, True)):
            pp = trk.pack_policy_params(_actor(3, nx, 2 * nu, hidden, 30.0), nx, device=dev)
            kw = dict(draw_actions=False, constrained=True, randomized_reset=True,
                      policy_params=pp, policy_stochastic=stoch, policy_squash=squash,
                      policy_activation=act)
            before = roll.policy_launches
            k = roll(s0.contiguous(), cfg, 3, 32, 20, 1e-3, **kw)
            plain = (trk.cartpole_rollout_plain if system == 'cartpole' else
                     functools.partial(trk.quad_rollout_plain, 2 if system == 'quadrotor' else 3))
            p = plain(s0.contiguous(), cfg, 3, 32, 20, 1e-3, **kw)
            torch.cuda.synchronize()
            assert roll.policy_launches == before + 1
            torch.testing.assert_close(k['state'], p['state'], rtol=0, atol=1e-4)
            for key in ('done_count', 'ctrl_step', 'violation_count'):
                assert torch.equal(k[key], p[key]), key
            torch.testing.assert_close(k['reward_sum'], p['reward_sum'], rtol=1e-4, atol=1e-4)
