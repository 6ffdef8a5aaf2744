"""The port's dp x tp training (``parallel/sharding.py``'s Megatron split) on
four gloo ranks on the CPU, a (2, 2) mesh of 'env' by 'model', against the
one-process port.

Four ranks are spawned once for the module (``parallel/launch.spawn_local``,
``tests/torch_sharding_ranks.dp_tp``), in a thread, while the one-process
runs go on here (``expected``):

* PPO (tests/test_multichip_training.py:146-195's config, 4 iterations):
  the whole parameters within JAX's bar of the one-process port, atol 5e-5
  (tests/test_multichip_training.py:192); the hidden layers really split
  (each rank holds half the columns of the first layer and half the rows
  of the second); the env-axis replicas of each model shard and their Adam
  states bit-identical; the whole parameters equal on all four ranks.
* ``actor_critic_tp_shardings`` gives the JAX package's partition specs.
* SAC (tests/test_multichip_training.py:197-243's config), split as PPO
  is, held to the one-process run within 5e-5 after 320 env steps (64
  updates past the warm-up; 1.4e-6 measured). JAX's test takes 512 steps;
  there the port's one-process run sits on a float32 knife edge: scaling
  its actor's weights by 1 + 2e-7 moves its parameters by 1.44e-3 (one Adam
  step of lr 1e-3 on an actor weight whose gradient is near zero), so a
  split of the sums can land on either side, as the JAX package's test
  notes for its own runs past ~512 steps. Data-parallel SAC is held at 512
  steps in tests/test_torch_sharding.py (it equals the one-process run).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from safe_control_gym_tpu.controllers.ppo.ppo_utils import init_actor_critic as jax_init_ppo
from safe_control_gym_tpu.controllers.sac.sac_utils import init_sac_params as jax_init_sac
from safe_control_gym_tpu.parallel.sharding import actor_critic_tp_shardings as jax_shardings
from safe_control_gym_tpu.parallel.sharding import make_dp_tp_mesh as jax_dp_tp_mesh

from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.parallel.launch import spawn_local
from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, plain
from tests import torch_sharding_ranks as ranks

DP_ATOL = 5e-5


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


@pytest.fixture(scope='module')
def dp_tp(tmp_path_factory):
    """A call that waits for the four ranks' results of ``dp_tp``."""
    out = tmp_path_factory.mktemp('dp_tp')
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(spawn_local, ranks.dp_tp, 4, backend='gloo', args=(str(out),))
        yield run.result


@pytest.fixture(scope='module')
def expected(dp_tp, tmp_path_factory):
    """The one-process runs of PPO and SAC."""
    out = tmp_path_factory.mktemp('one_process')
    return dict(ppo=ranks.ppo(str(out / 'ppo')),
                sac=ranks.sac(str(out / 'sac'), steps=ranks.SAC_TP_STEPS))


def _identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def _max_err(got, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def _check_split(results, algo, first, second):
    """Ranks (i, 0) and (i, 1) hold the two halves of the split layers; the
    env axis's replicas of a shard, and the whole parameters, are equal."""
    by_model = {}
    for r in results:
        by_model.setdefault(r['coords']['model'], []).append(r[algo])
    assert sorted(by_model) == [0, 1]
    for reps in by_model.values():
        assert len(reps) == 2
        _identical(reps[0]['shards'], reps[1]['shards'])
    half, other = by_model[0][0]['shards'], by_model[1][0]['shards']
    for idx, shape in (first, second):
        assert half[idx].shape == shape and other[idx].shape == shape
        assert not np.array_equal(half[idx], other[idx])
    for r in results[1:]:
        _identical(r[algo]['params'], results[0][algo]['params'])


def test_sac_dp_tp_matches_one_process(expected, dp_tp):
    ref = expected['sac']
    results = dp_tp()
    # The 256-wide first layers split their columns, the second their rows.
    _check_split(results, 'sac', (1, (4, 128)), (3, (128, 256)))
    assert _max_err(results[0]['sac']['params'], ref['params']) <= DP_ATOL
    assert results[0]['sac']['buffer_rows'] == ranks.SAC_TP_STEPS // 2


def test_ppo_dp_tp_matches_one_process(expected, dp_tp):
    ref = expected['ppo']
    results = dp_tp()
    # tree_leaves order: actor layers (b, w), ..., critic layers, logstd. The
    # 64-wide first layer splits its columns, the second its rows.
    _check_split(results, 'ppo', (1, (4, 32)), (3, (32, 64)))
    by_model = {}
    for r in results:
        by_model.setdefault(r['coords']['model'], []).append(r['ppo'])
    for reps in by_model.values():
        _identical(reps[0]['actor_opt'], reps[1]['actor_opt'])
        _identical(reps[0]['critic_opt'], reps[1]['critic_opt'])
    # Adam's moments are split as their parameters are: the shards are the
    # actor's 6 leaves, the critic's 6 and logstd; each state is [count,
    # mu..., nu...].
    for r in results:
        shards = [t.shape for t in r['ppo']['shards']]
        assert [m.shape for m in r['ppo']['actor_opt'][1:8]] == shards[:6] + shards[12:]
        assert [m.shape for m in r['ppo']['critic_opt'][1:7]] == shards[6:12]
    got = results[0]['ppo']['params']
    assert _max_err(got, ref['params']) <= DP_ATOL
    assert results[0]['ppo']['obs_rows'] == 8
    one_pass = [8] * (2 * 32) + [4] * 46
    assert results[0]['ppo']['k1_calls'] == one_pass * 2
    # The checkpoint rank 0 wrote holds the whole parameters.
    sd = plain(load_checkpoint(results[0]['ppo']['checkpoint'])['raw'])['agent']
    assert [np.shape(a) for a in tree_leaves(sd['params'])] == [a.shape for a in got]
    assert all(r['ppo']['checkpoint'] is None for r in results[1:])


def test_tp_shardings_match_jax(dp_tp):
    """``actor_critic_tp_shardings`` of PPO's (64 wide, one action) and
    SAC's (256 wide) parameters: JAX's partition specs, leaf by leaf."""
    mesh = jax_dp_tp_mesh(n_model=2, n_devices=4)
    key = jax.random.PRNGKey(0)
    want = {'ppo': jax_shardings(mesh, jax_init_ppo(key, 4, 1, [64, 64])),
            'sac': jax_shardings(mesh, jax_init_sac(key, 4, 1, [256, 256])[0])}
    for r in dp_tp():
        for algo in ('ppo', 'sac'):
            got = r['specs'][algo]
            assert sorted(got) == sorted(want[algo])
            for k in got:
                if isinstance(got[k], list):
                    assert [{n: layer[n] for n in layer} for layer in got[k]] == [
                        {n: tuple(sh.spec) for n, sh in layer.items()} for layer in want[algo][k]]
                else:
                    assert tuple(want[algo][k].spec) == got[k] == ()
