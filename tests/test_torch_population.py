"""The port's population PPO against the JAX package's evaluator, on the CPU.

* ``split_suggestion`` and the per-lane clipped Adam step against
  ``population.py``'s, to 1e-6.
* One lane of a two-iteration population (N=4, T=8, hidden 16, two epochs,
  n_eval 2) against ``make_population_ppo_evaluator`` on the same key. The
  port is fed JAX's draws, regenerated here in ``population.py``'s split
  order: the initial parameters (through ``utils/convert.py``), initial
  states, action normals, reset states, permutations and evaluation states.
  The returns agree to 1e-4 of their size: both run the same float32 math,
  and only the rounding of XLA's and torch's matmul and reduction orders
  differs; over two iterations of Adam steps it grew to 1.6e-7-2.1e-7 of
  the returns in this configuration (seeds 7, 8 and 9).
* A P-lane population against P one-lane runs (each lane's draws come
  from its own generator), and against its own draws fed back.
* K1's plain version called once a step for all P×N envs.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.controllers.ppo.ppo_utils import init_actor_critic as jax_init
from safe_control_gym_tpu.hyperparameters import population as jax_population
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.hyperparameters import population
from safe_control_gym_tpu_torch.ops import physics_kernels
from safe_control_gym_tpu_torch.utils.convert import env_state_from_numpy, tree_from_numpy
from safe_control_gym_tpu_torch.utils.registration import make as tmake

TASK = dict(normalized_rl_action_space=True, episode_len_sec=1)
CFG = dict(rollout_batch_size=4, rollout_steps=8, iterations=2, opt_epochs=2,
           mini_batch_size=16, hidden_dim=16, n_eval=2, use_gae=True)
N, T, ITERS, EPOCHS, N_EVAL = 4, 8, 2, 2, 2
HP = {'actor_lr': np.array([3e-3]), 'entropy_coef': np.array([0.02]),
      'gamma': np.array([0.97])}
SEED = 7


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _state_dict(est):
    d = {f.name: np.asarray(getattr(est, f.name)) for f in dataclasses.fields(est)
         if f.name not in ('dyn_params', 'key')}
    d['dyn_params'] = {f.name: np.asarray(getattr(est.dyn_params, f.name))
                       for f in dataclasses.fields(est.dyn_params)}
    return d


def _port_state(dicts):
    """One port ``EnvState`` of the rows of several JAX states' dicts."""
    cat = {k: np.concatenate([d[k] for d in dicts]) for k in dicts[0] if k != 'dyn_params'}
    cat['dyn_params'] = {k: np.concatenate([d['dyn_params'][k] for d in dicts])
                         for k in dicts[0]['dyn_params']}
    return env_state_from_numpy(cat, 'cpu')


def _jax_draws(seed):
    """Every draw of one lane of the JAX evaluator keyed by ``PRNGKey(seed)``,
    in the port's ``draws`` form (population.py's split order)."""
    jf = jmake('cartpole', seed=0, **TASK).func
    M = N * T
    used = (M // CFG['mini_batch_size']) * CFG['mini_batch_size']
    k_init, k_env, k_train, k_eval = jax.random.split(jax.random.PRNGKey(seed), 4)
    params = jax.tree.map(lambda a: np.asarray(a)[None],
                          jax_init(k_init, 4, 1, [CFG['hidden_dim']] * 2))

    @jax.jit
    def fresh(k):
        # The reset states step_autoreset draws from key k: step every env
        # past its time limit, so that all of them start afresh.
        st, _ = jax.vmap(jf.reset)(jax.random.split(jax.random.PRNGKey(0), N))
        st = st.replace(ctrl_step=jnp.full((N,), jf.max_steps - 1, jnp.int32))
        st, out, obs = jf.step_autoreset(st, jnp.zeros((N, 1)), k)
        return st, obs, out.done

    iterations = []
    for k in jax.random.split(k_train, ITERS):
        kr, ku = jax.random.split(k)
        noise, states, obs = [], [], []
        for _ in range(T):
            kr, k_act, k_reset = jax.random.split(kr, 3)
            noise.append(np.asarray(jax.random.normal(k_act, (N, 1))))
            st, ob, done = fresh(k_reset)
            assert bool(done.all())
            states.append(_state_dict(st))
            obs.append(np.asarray(ob))
        perms = np.stack([np.asarray(jax.random.permutation(ek, M))[:used]
                          for ek in jax.random.split(ku, EPOCHS)])
        iterations.append({
            'act_noise': torch.tensor(np.stack(noise))[:, None],
            'fresh': population.per_step(_port_state(states),
                                         torch.tensor(np.concatenate(obs)), T),
            'perms': torch.tensor(perms, dtype=torch.int64)[:, None]})
    est0, obs0 = jax.vmap(jf.reset)(jax.random.split(k_env, N))
    est_e, obs_e = jax.vmap(jf.reset)(jax.random.split(k_eval, N_EVAL))
    return {'params': tree_from_numpy(params, 'cpu'),
            'init': (_port_state([_state_dict(est0)]), torch.tensor(np.asarray(obs0))),
            'iterations': iterations,
            'eval': (_port_state([_state_dict(est_e)]), torch.tensor(np.asarray(obs_e)))}


@pytest.fixture(scope='module')
def jax_lane():
    ev = jax_population.make_population_ppo_evaluator(
        partial(jmake, 'cartpole', seed=0, **TASK), **CFG)
    returns = np.asarray(ev(HP, np.asarray(jax.random.PRNGKey(SEED))[None]))
    return returns, _jax_draws(SEED)


def _port(**over):
    return population.make_population_ppo_evaluator(
        partial(tmake, 'cartpole', seed=0, **TASK), device='cpu', **{**CFG, **over})


def test_constants_and_split_suggestion_match_jax():
    assert population.VECTOR_HPS == jax_population.VECTOR_HPS
    assert population.STRUCTURAL_HPS == jax_population.STRUCTURAL_HPS
    sug = {'actor_lr': 1e-3, 'hidden_dim': 64, 'gamma': 0.99, 'activation': 'tanh',
           'rollout_steps': 100, 'max_grad_norm': 1}
    assert population.split_suggestion(sug) == jax_population.split_suggestion(sug)


def test_adam_step_matches_jax():
    rng = np.random.default_rng(0)
    P = 3
    shapes = [(P, 5, 4), (P, 4), (P, 1)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lr = np.array([1e-2, 3e-4, 0.5], np.float32)
    max_norm = np.array([0.5, 10.0, 0.05], np.float32)
    t_params = [torch.tensor(p) for p in params]
    t_state = population.adam_init(t_params)
    j_params = [[jnp.asarray(p[i]) for p in params] for i in range(P)]
    j_states = [jax_population._adam_init(jp) for jp in j_params]
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        t_params, t_state = population.adam_step([torch.tensor(g) for g in grads], t_state,
                                                 t_params, torch.tensor(lr),
                                                 torch.tensor(max_norm))
        for i in range(P):
            j_params[i], j_states[i] = jax_population._adam_step(
                [jnp.asarray(g[i]) for g in grads], j_states[i], j_params[i], lr[i],
                max_norm[i])
        for k, tp in enumerate(t_params):
            want = np.stack([np.asarray(j_params[i][k]) for i in range(P)])
            np.testing.assert_allclose(tp.numpy(), want, rtol=0, atol=1e-6)
            want_v = np.stack([np.asarray(j_states[i]['v'][k]) for i in range(P)])
            np.testing.assert_allclose(t_state['v'][k].numpy(), want_v, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t_state['t'].numpy(),
                                      [float(j_states[i]['t']) for i in range(P)])


def test_lane_matches_jax_evaluator_on_its_draws(jax_lane):
    want, draws = jax_lane
    got = _port()(HP, [SEED], draws=draws)
    assert got.shape == want.shape == (1, N_EVAL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_population_lanes_equal_single_lanes_and_one_physics_call_a_step(monkeypatch):
    calls = []
    plain = physics_kernels.cartpole_advance_plain

    def counting(states, *args, **kwargs):
        calls.append(states.shape[0])
        return plain(states, *args, **kwargs)

    monkeypatch.setattr(physics_kernels, 'cartpole_advance_plain', counting)
    ev = _port()
    hp = {'actor_lr': np.array([3e-4, 3e-3, 1e-3]), 'clip_param': np.array([0.1, 0.2, 0.3]),
          'target_kl': np.array([0.0, 0.01, 0.5]), 'max_grad_norm': np.array([0.5, 5.0, 0.1])}
    seeds = [11, 12, 13]
    together = ev(hp, seeds)
    P = len(seeds)
    eval_steps = ev.func.max_steps + 1
    assert calls == [P * N] * (ITERS * T) + [P * N_EVAL] * eval_steps
    assert ev.env_steps_per_lane == N * T * ITERS
    for p in range(P):
        alone = ev({k: v[p:p + 1] for k, v in hp.items()}, seeds[p:p + 1])
        np.testing.assert_allclose(alone[0], together[p], rtol=1e-6, atol=0)
    # Its own draws fed back give the same run, and a lane's share of them
    # that lane's.
    draws = ev.lane_draws(seeds)
    np.testing.assert_array_equal(ev(hp, seeds, draws=draws), together)
    alone = ev({k: v[2:] for k, v in hp.items()}, seeds[2:], draws=ev.select_lanes(draws, [2]))
    np.testing.assert_allclose(alone[0], together[2], rtol=1e-6, atol=0)
    # A lane's hyperparameters reach only that lane.
    changed = ev(dict(hp, actor_lr=np.array([3e-4, 3e-1, 1e-3])), seeds)
    assert not np.allclose(changed[1], together[1])
    np.testing.assert_array_equal(changed[[0, 2]], together[[0, 2]])


def test_update_runs_on_stacked_lanes_without_host_reads():
    ev = _port()
    draws = ev.lane_draws([1, 2])
    hp = ev.hp_tensors({}, 2)
    params = draws['params']
    est, obs = draws['init']
    est, obs, batch = ev.rollout(params, hp, est, obs, draws['iterations'][0])
    assert batch['obs'].shape == (2, T * N, 4) and batch['adv'].shape == (2, T * N, 1)
    a_opt = population.adam_init(population.tree_leaves(
        {k: params[k] for k in ('actor', 'logstd')}))
    c_opt = population.adam_init(population.tree_leaves(params['critic']))
    new, a_opt, c_opt = ev.update(params, a_opt, c_opt, hp, batch,
                                  draws['iterations'][0]['perms'])
    assert c_opt['t'].tolist() == [EPOCHS * (T * N // 16)] * 2
    assert all(torch.isfinite(x).all() for x in population.tree_leaves(new))
    assert not torch.equal(new['critic'][0]['w'], params['critic'][0]['w'])


def test_disturbance_noise_comes_from_each_lanes_generator():
    noise = {'observation': [{'disturbance_func': 'white_noise', 'std': 0.01}],
             'action': [{'disturbance_func': 'white_noise', 'std': 0.1}]}
    ev = population.make_population_ppo_evaluator(
        partial(tmake, 'cartpole', disturbances=noise, **TASK), device='cpu',
        **dict(CFG, iterations=1))
    together = ev({}, [4, 5])
    np.testing.assert_allclose(ev({}, [5])[0], together[1], rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match='stochastic disturbances'):
        ev({}, [4], draws=ev.lane_draws([4]))
