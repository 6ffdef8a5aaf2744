"""The port's multi-GPU paths (``parallel/sharding.py``) on two gloo ranks on
the CPU, against the one-process port and against the JAX package's
``shard_over`` / ``mesh=`` on a 2-device virtual CPU mesh.

Two ranks are spawned once for the module (``parallel/launch.spawn_local``,
``tests/torch_sharding_ranks.two_ranks``), and beside them one process
running the same cases unsharded (``one_process``), each from a thread,
while the JAX package makes its results here (``expected``); each case is
held here:

* PPO data parallel (4 iterations of tests/test_multichip_training.py's
  config), RARL and RAP (two cycles) and SAC (512 env steps, JAX's
  equivalence horizon, tests/test_multichip_training.py:197-243): the
  parameters within JAX's bar of the one-process port, atol 5e-5
  (tests/test_multichip_training.py:192), and parameter replicas and Adam
  states bit-identical on both ranks. Each rank stepped K1 (its plain
  version here) once a step, on its own N/2 envs.
* One PPO update from a fixed batch on JAX's permutations, each rank
  holding half the rows: against JAX's ``_update_jit`` on a batch sharded
  over two devices, params atol 1e-4 and the same accepted actor steps (the
  bar of tests/test_torch_ppo_modules.py), and against the one-process
  port, atol 5e-5.
* The linear MPSC certification batch and the NMPC sweep of
  tests/test_sharded_solvers.py: feasibility flags equal and actions within
  that file's atol 1e-3, against the one-process port and against JAX's
  sharded solve; a batch that does not divide over the ranks raises. The
  committed CBF-NN's certification (its batch split inherited from CBF),
  against the one-process port, to the same bar.
* ``evaluate_fused(mesh=...)`` of the committed cartpole PPO: per-env reward
  sums within 1e-5 and done counts equal to the one-process port
  (tests/test_fused_eval.py:136), and within 1e-4 (done counts equal) of
  JAX's sharded scan from the same fixed start; ``use_kernel=True`` with a
  mesh raises ValueError.
* A population of four lanes split two a rank: identical lanes on different
  ranks agree within 1e-5 (__graft_entry__.py's case), and both ranks return
  the same gathered returns.
"""

import functools
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from safe_control_gym_tpu.controllers.ppo import ppo_utils as jppo
from safe_control_gym_tpu.parallel.sharding import make_env_mesh as jax_env_mesh
from safe_control_gym_tpu.utils.registration import get_config as jget
from safe_control_gym_tpu.utils.registration import make as jmake
from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import PPOAgent
from safe_control_gym_tpu_torch.envs.spaces import Box
from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.parallel.launch import spawn_local
from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, plain
from tests import torch_sharding_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_PATH = os.path.join(ROOT, 'examples', 'mpsc', 'models', 'linear_mpsc_cartpole.pkl')
MODEL = os.path.join(ROOT, 'examples', 'rl', 'models', 'ppo', 'ppo_model_cartpole_stab.pt')
CBF_NN = os.path.join(ROOT, 'examples', 'cbf', 'models', 'cbf_nn_cartpole.pt')
DP_ATOL = 5e-5
SOLVER_ATOL = 1e-3


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


UPDATE_CFG = dict(hidden_dim=16, opt_epochs=2, mini_batch_size=16, seed=3, target_kl=0.004,
                  actor_lr=3e-3, critic_lr=3e-3)


@pytest.fixture(scope='module')
def inputs():
    """A fresh PPO agent's state (tests/test_torch_ppo_modules.py's
    config), a batch of 64 rows (they split in two) and JAX's key and
    permutations for one update."""
    box = lambda n: Box(-np.ones(n, np.float32), np.ones(n, np.float32))
    state = PPOAgent(box(4), box(2), device='cpu', **UPDATE_CFG).state_dict()
    rng = np.random.default_rng(4)
    m = 64
    batch = {'obs': rng.normal(0, 1, (m, 4)), 'act': rng.normal(0, 0.7, (m, 2)),
             'logp': rng.normal(-1.5, 0.3, (m, 1)), 'adv': rng.normal(0, 1, (m, 1)),
             'ret': rng.normal(0, 1, (m, 1)), 'v': rng.normal(0, 1, (m, 1))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    perms = [np.asarray(jax.random.permutation(k, m)) for k in jax.random.split(key, 2)]
    return dict(state=state, batch=batch, key=key, perms=perms)


def _failing_run():
    """A run whose rank 1 raises: the launcher's error and its seconds."""
    t0 = time.perf_counter()
    try:
        spawn_local(ranks.fail_on_rank, 2, args=(1,), timeout=60)
    except RuntimeError as exc:
        return str(exc), time.perf_counter() - t0
    return None, time.perf_counter() - t0


@pytest.fixture(scope='module')
def runs(inputs, tmp_path_factory):
    """``(sharded, one_process, failing)``: calls that wait for both ranks'
    results of ``two_ranks``, for the one-process results and for
    ``_failing_run``, each run started in a thread when the fixture is
    made."""
    args = (inputs['state'], inputs['batch'], inputs['perms'], P_PATH, MODEL, CBF_NN)
    with ThreadPoolExecutor(3) as pool:
        two = pool.submit(spawn_local, ranks.two_ranks, 2, backend='gloo',
                          args=(str(tmp_path_factory.mktemp('two_ranks')),) + args)
        one = pool.submit(spawn_local, ranks.one_process, 1, backend='gloo',
                          args=(str(tmp_path_factory.mktemp('one_process')),) + args)
        failing = pool.submit(_failing_run)
        yield two.result, lambda: one.result()[0], failing.result


@pytest.fixture(scope='module')
def sharded(runs):
    return runs[0]


def _jax_results(inputs):
    """JAX's sharded solves, eval and PPO update, on 2-device meshes."""
    put = lambda tree, sh: jax.device_put(tree, jax.tree.map(lambda _: sh, tree))
    cartpole = functools.partial(jmake, 'cartpole', **ranks.CONSTRAINED_CARTPOLE)
    sf = jmake('linear_mpsc', cartpole, **ranks.MPSC_CFG)
    sf.load(P_PATH)
    sf.shard_over(jax_env_mesh(2, axis_name='data'))
    cert = sf.certify_action_batch(ranks.CERT_STATES, ranks.CERT_ACTIONS)
    mpc = jmake('mpc', cartpole, **ranks.NMPC_CFG)
    mpc.reset()
    mpc.shard_over(jax_env_mesh(2, axis_name='data'))
    nmpc = mpc.select_action_batch(ranks.NMPC_X0)
    mpc.close()
    env_id, task, algo_cfg = ranks.eval_task()
    ctrl = jmake('ppo', functools.partial(jmake, env_id, **task), **{**jget('ppo'), **algo_cfg})
    ctrl.load(MODEL)
    ev = ctrl.evaluate_fused(mesh=jax_env_mesh(2), **{k: v for k, v in ranks.EVAL_KW.items()
                                                      if k != 'n_reps'})
    ctrl.close()
    import gymnasium as gym
    ja = jppo.PPOAgent(gym.spaces.Box(-1.0, 1.0, shape=(4,)), gym.spaces.Box(-1.0, 1.0, shape=(2,)),
                       **UPDATE_CFG)
    # The port agent's parameters; both start from fresh (zero) Adam states.
    ja.params = jax.tree.map(jnp.asarray, inputs['state']['params'])
    mesh = jax_env_mesh(2)
    repl = NamedSharding(mesh, P())
    jb = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P('env')))
          for k, v in inputs['batch'].items()}
    assert not jb['obs'].sharding.is_fully_replicated
    params, a_state, _, _ = ja._update_jit(put(ja.params, repl), put(ja.actor_opt_state, repl),
                                           put(ja.critic_opt_state, repl), jb, inputs['key'])
    return dict(cert=[np.asarray(a) for a in cert], nmpc=[np.asarray(a) for a in nmpc], eval=ev,
                update=dict(params=[np.asarray(a) for a in jax.tree.leaves(params)],
                            accepted=int(a_state[1][0].count)))


@pytest.fixture(scope='module')
def expected(runs, inputs):
    """JAX's results, made here while the ranks run, and the one-process
    port's."""
    return dict(jax=_jax_results(inputs), **runs[1]())


def _close(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_sharding_helpers(expected, sharded):
    """The env step draws at the global width, so each rank's envs are rows
    of the one-process batch, auto-reset included; ``replicate`` gives rank
    0's values; ``make_dp_train_step`` runs the update on the whole batch."""
    ref = expected['helpers']
    for rank, r in enumerate(sharded()):
        got, rows = r['helpers'], slice(4 * rank, 4 * rank + 4)
        for key in ('reset_obs', 'obs0', 'obs1', 'done0', 'done1'):
            np.testing.assert_array_equal(got[key], ref[key][rows], err_msg=key)
        np.testing.assert_array_equal(got['replicated'], np.zeros(3, np.float32))
        np.testing.assert_array_equal(got['dp_batch'], np.arange(8.0, dtype=np.float32))
        np.testing.assert_array_equal(got['dp_step'], np.full(2, 28.0, np.float32))


def test_sharded_certification_matches_one_process_and_jax(expected, sharded):
    ref, (ju, jok) = expected['certify'], expected['jax']['cert']
    assert ref['local_rows'] == 8
    for r in sharded():
        got = r['certify']
        assert got['local_rows'] == 4
        np.testing.assert_array_equal(got['ok'], ref['ok'])
        np.testing.assert_allclose(got['u'], ref['u'], rtol=0, atol=SOLVER_ATOL)
        assert 'does not divide' in got['indivisible']
        np.testing.assert_array_equal(got['ok'], jok)
        np.testing.assert_allclose(got['u'], ju, rtol=0, atol=SOLVER_ATOL)


def test_sharded_cbf_nn_certification_matches_one_process(expected, sharded):
    """CBF-NN's batch goes through CBF's split: two rows a rank."""
    ref = expected['cbf_nn']
    for r in sharded():
        np.testing.assert_array_equal(r['cbf_nn']['ok'], ref['ok'])
        np.testing.assert_allclose(r['cbf_nn']['u'], ref['u'], rtol=0, atol=SOLVER_ATOL)


def test_sharded_nmpc_sweep_matches_one_process_and_jax(expected, sharded):
    ref, (ju, jfeas) = expected['nmpc'], expected['jax']['nmpc']
    assert ref['feas'].all()
    for r in sharded():
        got = r['nmpc']
        assert got['local_rows'] == 8
        np.testing.assert_array_equal(got['feas'], ref['feas'])
        np.testing.assert_allclose(got['u'], ref['u'], rtol=0, atol=SOLVER_ATOL)
        np.testing.assert_array_equal(got['feas'], jfeas)
        np.testing.assert_allclose(got['u'], ju, rtol=0, atol=SOLVER_ATOL)


def test_sharded_eval_matches_one_process_and_jax(expected, sharded):
    ref, jres = expected['eval'], expected['jax']['eval']
    assert ref['path'] == 'per-step-scan' and jres['path'] == 'per-step-scan-sharded'
    for r in sharded():
        got = r['eval']
        assert got['path'] == 'per-step-scan-sharded'
        np.testing.assert_allclose(got['per_env']['reward_sum'], ref['per_env']['reward_sum'],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got['per_env']['done_count'], ref['per_env']['done_count'])
        assert got['episodes'] == ref['episodes']
        # K1 (its plain version here) once a step, for the rank's 16 envs.
        assert got['k1_calls'] == [16] * ranks.EVAL_KW['n_steps']
        assert 'per-step path' in got['kernel_refusal']
        np.testing.assert_allclose(got['per_env']['reward_sum'], jres['per_env']['reward_sum'],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got['per_env']['done_count'],
                                      jres['per_env']['done_count'])


def test_ppo_update_matches_jax_sharded_and_one_process(expected, sharded):
    ref, jax_ref = expected['ppo_update'], expected['jax']['update']
    r0, r1 = (r['ppo_update'] for r in sharded())
    _close(r0['params'], jax_ref['params'], 1e-4)
    assert r0['accepted'] == r1['accepted'] == jax_ref['accepted'] == ref['accepted']
    _close(r0['params'], ref['params'], DP_ATOL)
    _identical(r0['params'], r1['params'])
    np.testing.assert_allclose(r0['losses'], ref['losses'], rtol=0, atol=1e-6)


def test_ppo_data_parallel_matches_one_process(expected, sharded):
    ref = expected['ppo']
    r0, r1 = (r['ppo'] for r in sharded())
    _close(r0['params'], ref['params'], DP_ATOL)
    for key in ('params', 'shards', 'actor_opt', 'critic_opt'):
        _identical(r0[key], r1[key])
    for key in ('policy_loss', 'value_loss', 'approx_kl', 'mean_reward', 'dones'):
        np.testing.assert_allclose(r0['results'][key], ref['results'][key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    # The evaluation ran on every rank: the results agree everywhere.
    assert r0['results']['eval_return'] == r1['results']['eval_return']
    assert {k: v for k, v in r0['results'].items() if k != 'elapsed_time'} == {
        k: v for k, v in r1['results'].items() if k != 'elapsed_time'}
    np.testing.assert_allclose(r0['results']['eval_return'], ref['results']['eval_return'],
                               rtol=1e-4)
    # Each rank holds 8 of the 16 envs and stepped them once a step, one
    # call of K1 (its plain version) each: two fused passes of 2 x 32 steps,
    # each followed by an evaluation of 46 steps of the 4 eval envs.
    assert r0['obs_rows'] == r1['obs_rows'] == 8
    one_pass = lambda n: [n] * (2 * 32) + [4] * 46
    assert r0['k1_calls'] == r1['k1_calls'] == one_pass(8) * 2
    assert ref['k1_calls'] == one_pass(16) * 2
    # Rank 0 alone wrote the checkpoint, whole, in the one-process layout.
    assert r0['checkpoint'] is not None and r1['checkpoint'] is None
    got, want = (plain(load_checkpoint(p)['raw']) for p in (r0['checkpoint'], ref['checkpoint']))
    assert got['obs'].shape == want['obs'].shape == (16, 4)
    np.testing.assert_allclose(got['obs'], want['obs'], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got['env_states']['ctrl_step'], want['env_states']['ctrl_step'])
    _close(tree_leaves(got['agent']['params']), tree_leaves(want['agent']['params']), DP_ATOL)


@pytest.mark.parametrize('algo', ['rarl', 'rap'])
def test_adversarial_data_parallel_matches_one_process(expected, sharded, algo):
    ref = expected[algo]
    r0, r1 = (r[algo] for r in sharded())
    assert len(r0['params']) == (2 if algo == 'rarl' else 3)
    for got, want, other in zip(r0['params'], ref['params'], r1['params']):
        _close(got, want, DP_ATOL)
        _identical(got, other)
    for a, b in zip(r0['opt'], r1['opt']):
        _identical(a, b)
    np.testing.assert_allclose(r0['results']['mean_reward'], ref['results']['mean_reward'],
                               rtol=1e-5)


def test_sac_data_parallel_matches_one_process(expected, sharded):
    ref = expected['sac']
    r0, r1 = (r['sac'] for r in sharded())
    _close(r0['params'], ref['params'], DP_ATOL)
    _identical(r0['train_state'], r1['train_state'])
    # Each rank's ring holds its 4 envs' rows of the 512 transitions.
    assert r0['buffer_rows'] == r1['buffer_rows'] == 256
    assert ref['buffer_rows'] == 512


def test_launcher_stops_every_rank_when_one_raises(runs):
    """A rank that raises fails the run at once, with its traceback, and the
    rank left waiting in a collective is stopped (well inside the group's
    timeout)."""
    message, seconds = runs[2]()
    assert message is not None and re.search(
        'rank 1 of 2 failed:\n(.|\n)*fails on purpose', message), message
    assert seconds < 45


def test_sharded_population_lanes(sharded):
    r0, r1 = (r['population']['returns'] for r in sharded())
    assert r0.shape == (4, ranks.POP_CFG['n_eval'])
    np.testing.assert_array_equal(r0, r1)
    # Lanes 0 and 1 trained on rank 0, lanes 2 and 3 (their repeats) on rank 1.
    np.testing.assert_allclose(r0[0], r0[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(r0[1], r0[3], rtol=0, atol=1e-5)
    assert not np.allclose(r0[0], r0[1])
