"""The modules of the port's PPO training against the JAX package, on the same
inputs from a numpy seed and the same parameters carried across as numpy:
the running normalizers (atol 1e-6), the Categorical (atol 1e-6), returns and
advantages with and without GAE and with truncation (atol 1e-5), the policy
and value losses and their gradients on one minibatch (atol 1e-5), one clip +
Adam step against ``optax.chain(clip_by_global_norm, adam)`` (atol 1e-7),
and a whole KL-gated update against ``PPOAgent._update_jit`` on the
permutations JAX drew (params atol 1e-4, the same count of accepted actor
steps)."""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from safe_control_gym_tpu.controllers.ppo import ppo_utils as jppo
from safe_control_gym_tpu.math import distributions as jdist
from safe_control_gym_tpu.math import normalization as jnorm
from safe_control_gym_tpu_torch.controllers.ppo import ppo_utils as tppo
from safe_control_gym_tpu_torch.math import normalization as tnorm
from safe_control_gym_tpu_torch.math import optim
from safe_control_gym_tpu_torch.math.distributions import Categorical
from safe_control_gym_tpu_torch.math.optim import tree_leaves


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _assert_tree_close(got_leaves, want_tree, atol):
    want = [np.asarray(a) for a in jax.tree.leaves(want_tree)]
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        np.testing.assert_allclose(g.detach().cpu().numpy(), w, rtol=0, atol=atol)


def test_rms_and_ret_updates_match_jax():
    rng = _rng(0)
    js, ts = jnorm.rms_init((4,)), tnorm.rms_init((4,))
    jr, tr = jnorm.ret_init(6), tnorm.ret_init(6)
    assert ts.count.dtype == torch.float32 and ts.count.dim() == 0
    for step in range(5):
        batch = rng.normal(1.0, 2.0, (3, 6, 4)).astype(np.float32)
        js, ts = jnorm.rms_update(js, batch), tnorm.rms_update(ts, torch.tensor(batch))
        rew = rng.normal(0.5, 1.0, 6).astype(np.float32)
        done = rng.random(6) < 0.3
        jr = jnorm.ret_update(jr, rew, done, 0.99)
        tr = tnorm.ret_update(tr, torch.tensor(rew), torch.tensor(done), 0.99)
        for k in ('mean', 'var', 'count'):
            np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                       rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(getattr(tr.rms, k).numpy(),
                                       np.asarray(getattr(jr.rms, k)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr.ret.numpy(), np.asarray(jr.ret), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tnorm.ret_normalize(tr, torch.tensor(rew), 2.0).numpy(),
                                   np.asarray(jnorm.ret_normalize(jr, rew, 2.0)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tnorm.rms_normalize(ts, torch.tensor(batch[0]), 3.0).numpy(),
                                   np.asarray(jnorm.rms_normalize(js, batch[0], 3.0)),
                                   rtol=0, atol=1e-6)


def test_categorical_matches_jax():
    rng = _rng(1)
    logits = rng.normal(0, 2, (16, 5)).astype(np.float32)
    idx = rng.integers(0, 5, 16)
    jd, td = jdist.Categorical(logits), Categorical(torch.tensor(logits))
    for value in (idx, idx[:, None]):
        got = td.log_prob(torch.tensor(value)).numpy()
        assert got.shape == (16, 1)
        np.testing.assert_allclose(got, np.asarray(jd.log_prob(value)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    # Draws: the logits' leading shape, int64, and the softmax's frequencies.
    draws = Categorical(torch.tensor([[0.0, np.log(3.0)]]).expand(20000, 2)).sample(
        torch.Generator().manual_seed(0))
    assert draws.shape == (20000,) and draws.dtype == torch.int64
    assert abs(float(draws.float().mean()) - 0.75) < 0.01


@pytest.mark.parametrize('use_gae', [False, True])
@pytest.mark.parametrize('truncation', [False, True])
def test_returns_and_advantages_match_jax(use_gae, truncation):
    rng = _rng(2)
    T, N = 30, 6
    rews = rng.normal(0, 1, (T, N, 1)).astype(np.float32)
    vals = rng.normal(0, 1, (T, N, 1)).astype(np.float32)
    masks = (rng.random((T, N, 1)) > 0.1).astype(np.float32)
    term = (np.where(rng.random((T, N, 1)) < 0.1, rng.normal(0, 1, (T, N, 1)), 0.0)
            .astype(np.float32) if truncation else None)
    last = rng.normal(0, 1, (N, 1)).astype(np.float32)
    want = jppo.compute_returns_and_advantages(rews, vals, masks, term, last, 0.97, use_gae,
                                               0.9)
    t = lambda a: None if a is None else torch.tensor(a)
    got = tppo.compute_returns_and_advantages(t(rews), t(vals), t(masks), t(term), t(last),
                                              0.97, use_gae, 0.9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def _agents(discrete=False, **kw):
    """A JAX agent and the port's, with the JAX agent's parameters and
    optimizer states carried across."""
    obs_space = gym.spaces.Box(-1.0, 1.0, shape=(4,))
    act_space = gym.spaces.Discrete(3) if discrete else gym.spaces.Box(-1.0, 1.0, shape=(2,))
    cfg = dict(hidden_dim=16, opt_epochs=2, mini_batch_size=16, seed=3, **kw)
    ja = jppo.PPOAgent(obs_space, act_space, **cfg)
    ta = tppo.PPOAgent(obs_space, act_space, device='cpu', **cfg)
    ta.load_state_dict(_np({'params': ja.params, 'actor_opt_state': ja.actor_opt_state,
                            'critic_opt_state': ja.critic_opt_state}))
    return ja, ta


def _batch(m, discrete=False, seed=4, act_dim=2):
    """A minibatch; a discrete one's old log-probs sit near the fresh actor's
    (log 1/3), so that its approximate KL grows with the steps."""
    rng = _rng(seed)
    act = (rng.integers(0, 3, (m, 1)) if discrete
           else rng.normal(0, 0.7, (m, act_dim)).astype(np.float32))
    logp = (rng.normal(np.log(1 / 3), 0.01, (m, 1)) if discrete
            else rng.normal(-1.5, 0.3, (m, 1)))
    return {'obs': rng.normal(0, 1, (m, 4)).astype(np.float32), 'act': act,
            'logp': logp.astype(np.float32),
            'adv': rng.normal(0, 1, (m, 1)).astype(np.float32),
            'ret': rng.normal(0, 1, (m, 1)).astype(np.float32),
            'v': rng.normal(0, 1, (m, 1)).astype(np.float32)}


@pytest.mark.parametrize('clipped_value', [False, True])
def test_losses_and_grads_match_jax(clipped_value):
    ja, ta = _agents(use_clipped_value=clipped_value)
    b = _batch(64)
    jactor = {k: ja.params[k] for k in ('actor', 'logstd')}
    (jtot, jaux), jgrads = jax.value_and_grad(ja.policy_loss_fn, has_aux=True)(
        jactor, b['obs'], b['act'], b['logp'], b['adv'])
    tb = {k: torch.tensor(v) for k, v in b.items()}
    tactor = {k: ta.params[k] for k in ('actor', 'logstd')}
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tactor)]
    ttot, taux = ta.policy_loss_fn(optim.tree_unflatten(tactor, leaves), tb['obs'], tb['act'],
                                   tb['logp'], tb['adv'])
    tgrads = torch.autograd.grad(ttot, leaves)
    np.testing.assert_allclose(float(ttot.detach()), float(jtot), rtol=0, atol=1e-5)
    for g, w in zip(taux, jaux):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=0, atol=1e-5)
    _assert_tree_close(tgrads, jgrads, 1e-5)

    jv, jvg = jax.value_and_grad(ja.value_loss_fn)(ja.params['critic'], b['obs'], b['ret'],
                                                   b['v'])
    cleaves = [p.clone().requires_grad_(True) for p in tree_leaves(ta.params['critic'])]
    tv = ta.value_loss_fn(optim.tree_unflatten(ta.params['critic'], cleaves), tb['obs'],
                          tb['ret'], tb['v'])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=0, atol=1e-5)
    _assert_tree_close(torch.autograd.grad(tv, cleaves), jvg, 1e-5)


@pytest.mark.parametrize('scale', [0.01, 10.0], ids=['below_max_norm', 'above_max_norm'])
def test_clip_adam_step_matches_optax(scale):
    rng = _rng(5)
    shapes = [(4, 16), (16,), (16, 2), (2,)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jparams, jstate = list(params), opt.init(list(params))
    tparams = [torch.tensor(p) for p in params]
    tstate = optim.adam_init(tparams)
    for _ in range(3):
        grads = [(scale * rng.normal(0, 1, s) / np.sqrt(sum(np.prod(s) for s in shapes)))
                 .astype(np.float32) for s in shapes]
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
        assert (norm < 0.5) == (scale < 1)
        updates, jstate = opt.update(list(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tparams, tstate = optim.clip_adam_step(tparams, [torch.tensor(g) for g in grads],
                                               tstate, 3e-4, 0.5)
        for g, w in zip(tparams, jparams):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)
        adam = jstate[1][0]
        assert int(tstate['count']) == int(adam.count)
        for name in ('mu', 'nu'):
            for g, w in zip(tstate[name], getattr(adam, name)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)


def _jax_perms(key, opt_epochs, m, used):
    return [np.asarray(jax.random.permutation(k, m)[:used])
            for k in jax.random.split(key, opt_epochs)]


@pytest.mark.parametrize('discrete,actor_lr', [(False, 3e-3), (True, 1e-2)],
                         ids=['gaussian', 'categorical'])
def test_update_matches_jax_update_jit(discrete, actor_lr):
    """2 epochs x 4 minibatches of 16 (M = 70: the tail of 6 dropped), with a
    target KL and learning rates that make the gate reject some steps."""
    ja, ta = _agents(discrete=discrete, target_kl=0.004, actor_lr=actor_lr, critic_lr=3e-3)
    b = _batch(70, discrete=discrete)
    key = jax.random.PRNGKey(7)
    jparams, ja_state, jc_state, jres = ja._update_jit(
        ja.params, ja.actor_opt_state, ja.critic_opt_state,
        {k: jnp.asarray(v) for k, v in b.items()}, key)
    mb, num_mb, used = ta.minibatch_plan(70)
    assert (mb, num_mb, used) == (16, 4, 64)
    res = ta.update({k: torch.tensor(v) for k, v in b.items()},
                    perms=_jax_perms(key, 2, 70, used))
    _assert_tree_close(tree_leaves(ta.params), jparams, 1e-4)
    accepted = int(ja_state[1][0].count)
    assert int(ta.actor_opt_state['count']) == accepted
    assert 0 < accepted < 2 * num_mb, 'the gate should accept some steps and reject others'
    assert int(ta.critic_opt_state['count']) == int(jc_state[1][0].count) == 2 * num_mb
    for k, v in jres.items():
        np.testing.assert_allclose(res[k], float(v), rtol=0, atol=1e-5, err_msg=k)


def test_discrete_agent_step_update_act():
    """The Categorical actor end to end, as tests/test_discrete_ppo.py runs
    the JAX package's."""
    obs_space = gym.spaces.Box(-1.0, 1.0, shape=(4,))
    agent = tppo.PPOAgent(obs_space, gym.spaces.Discrete(3), hidden_dim=16, opt_epochs=2,
                          mini_batch_size=8, seed=0, device='cpu')
    assert agent.discrete and agent.act_dim == 3 and 'logstd' not in agent.params
    gen = torch.Generator().manual_seed(1)
    obs = torch.tensor(_rng(0).normal(0, 1, (6, 4)).astype(np.float32))
    a, v, lp = agent.step(obs, gen)
    assert a.shape == (6,) and a.dtype == torch.int64 and set(a.tolist()) <= {0, 1, 2}
    assert v.shape == (6, 1) and lp.shape == (6, 1)
    losses = agent.update({k: torch.tensor(v) for k, v in _batch(32, discrete=True).items()},
                          gen)
    assert all(np.isfinite(v) for v in losses.values())
    mode = agent.act(obs)
    assert mode.shape == (6,) and set(mode.tolist()) <= {0, 1, 2}
