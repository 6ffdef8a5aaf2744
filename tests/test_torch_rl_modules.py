"""The port's RL inference modules against the JAX package, on the same
parameters carried across as numpy and the same obs from a numpy seed: the MLP
(``math/networks.py``), the PPO actor's Gaussian, the SAC and DDPG actors, the
frozen obs normalizer (atol 1e-5: the matrix products sum in another order);
the restricted checkpoint unpickler against ``pickle.load`` under the JAX
stack; and the port's JSON configs against the YAML files they copy."""

import glob
import io
import os
import pickle

import jax
import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_tpu.controllers.ddpg import ddpg_utils as jddpg
from safe_control_gym_tpu.controllers.ppo import ppo_utils as jppo
from safe_control_gym_tpu.controllers.sac import sac_utils as jsac
from safe_control_gym_tpu.math import networks as jnet
from safe_control_gym_tpu.math import normalization as jnorm
from safe_control_gym_tpu_torch.controllers.ddpg.ddpg_utils import ddpg_actor_forward
from safe_control_gym_tpu_torch.controllers.ppo.ppo_utils import actor_dist, init_actor_critic
from safe_control_gym_tpu_torch.controllers.sac.sac_utils import sac_actor_forward
from safe_control_gym_tpu_torch.math.distributions import Normal
from safe_control_gym_tpu_torch.math.networks import MLP, mlp_apply, mlp_init
from safe_control_gym_tpu_torch.math.normalization import NormalizerState, rms_normalize
from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint
from safe_control_gym_tpu_torch.utils.convert import (mlp_params_from_numpy,
                                                      normalizer_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = sorted(glob.glob(os.path.join(ROOT, 'examples', 'rl', 'models', '*', '*.pt')))
PPO_SAC_MODELS = [m for m in MODELS if os.sep + 'safe_explorer_ppo' + os.sep not in m]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _obs(n, dim, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, dim)).astype(np.float32)


@pytest.mark.parametrize('activation,dims', [('tanh', (4, 1, [64, 64])),
                                             ('relu', (12, 8, [256, 256]))])
def test_mlp_apply_matches_jax(activation, dims):
    in_dim, out_dim, hidden = dims
    jp = jnet.mlp_init(jax.random.PRNGKey(0), in_dim, out_dim, hidden, orthogonal=False)
    obs = _obs(64, in_dim)
    want = np.asarray(jnet.mlp_apply(jp, obs, activation))
    tp = mlp_params_from_numpy(_np_tree(jp), 'cpu')
    got = mlp_apply(tp, torch.tensor(obs), activation).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(MLP(tp, activation)(torch.tensor(obs)).numpy(), want,
                                   rtol=0, atol=1e-5)


def test_mlp_init_orthogonal_gains():
    params = mlp_init(torch.Generator().manual_seed(0), 12, 4, [64, 32])
    assert [tuple(p['w'].shape) for p in params] == [(12, 64), (64, 32), (32, 4)]
    w0, w2 = params[0]['w'], params[2]['w']
    # Orthogonal rows (in < out) scaled by sqrt(2); the last layer by 0.01.
    torch.testing.assert_close(w0 @ w0.T, 2.0 * torch.eye(12), rtol=0, atol=1e-5)
    torch.testing.assert_close(w2.T @ w2, 1e-4 * torch.eye(4), rtol=0, atol=1e-8)
    assert all(float(p['b'].abs().sum()) == 0.0 for p in params)


def test_ppo_actor_mode_and_normal_match_jax():
    jp = jppo.init_actor_critic(jax.random.PRNGKey(3), 6, 2, [128, 128])
    jp['logstd'] = jp['logstd'] + 0.3
    obs = _obs(32, 6, 1)
    jd = jppo.actor_dist(jp, obs, 'tanh')
    tp = {'actor': mlp_params_from_numpy(_np_tree(jp['actor']), 'cpu'),
          'logstd': torch.tensor(np.asarray(jp['logstd']))}
    td = actor_dist(tp, torch.tensor(obs), 'tanh')
    np.testing.assert_allclose(td.mode().numpy(), np.asarray(jd.mode()), rtol=0, atol=1e-5)
    act = _obs(32, 2, 2)
    np.testing.assert_allclose(td.log_prob(torch.tensor(act)).numpy(),
                               np.asarray(jd.log_prob(act)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), rtol=1e-6)
    draws = Normal(torch.zeros(20000, 2), torch.full((2,), 0.5)).sample(
        torch.Generator().manual_seed(0))
    assert abs(float(draws.std()) - 0.5) < 0.01 and abs(float(draws.mean())) < 0.01
    # The port's own init has the JAX layout.
    own = init_actor_critic(torch.Generator().manual_seed(0), 6, 2, [128, 128])
    assert sorted(own) == sorted(jp) and own['logstd'].tolist() == [-0.5, -0.5]


def test_sac_and_ddpg_actors_match_jax():
    lo, hi = np.float32([-1, -2, 0, -1]), np.float32([1, 2, 3, 1])
    obs = _obs(32, 12, 3)
    jp, _, _ = jsac.init_sac_params(jax.random.PRNGKey(5), 12, 4, [256, 256])
    want, _ = jsac.sac_actor_forward(jp['actor'], obs, jax.random.PRNGKey(0), lo, hi,
                                     'relu', deterministic=True, with_logprob=False)
    tp = mlp_params_from_numpy(_np_tree(jp['actor']), 'cpu')
    got, logp = sac_actor_forward(tp, torch.tensor(obs), torch.Generator(), torch.tensor(lo),
                                  torch.tensor(hi), 'relu', deterministic=True,
                                  with_logprob=False)
    assert logp is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _, jlogp = jsac.sac_actor_forward(jp['actor'], obs, None, lo, hi, 'relu',
                                      deterministic=True)
    _, tlogp = sac_actor_forward(tp, torch.tensor(obs), None, torch.tensor(lo),
                                 torch.tensor(hi), 'relu', deterministic=True)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5, atol=1e-4)

    jd, _ = jddpg.init_ddpg_params(jax.random.PRNGKey(6), 12, 4, [256, 256])
    want = jddpg.ddpg_actor_forward(jd['actor'], obs, lo, hi, 'relu')
    got = ddpg_actor_forward(mlp_params_from_numpy(_np_tree(jd['actor']), 'cpu'),
                             torch.tensor(obs), torch.tensor(lo), torch.tensor(hi), 'relu')
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_rms_normalize_matches_jax():
    rng = np.random.default_rng(7)
    mean, var = rng.normal(size=4).astype(np.float32), np.float32([0.5, 2.0, 1e-4, 1.0])
    obs = _obs(64, 4, 8)
    want = jnorm.rms_normalize(jnorm.NormalizerState(mean=mean, var=var, count=np.float32(9)),
                               obs, 3.0)
    state = normalizer_from_numpy({'mean': mean, 'var': var, 'count': 9.0}, 'cpu')
    assert isinstance(state, NormalizerState)
    np.testing.assert_allclose(rms_normalize(state, torch.tensor(obs), 3.0).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    assert normalizer_from_numpy(None, 'cpu') is None


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{prefix}/{i}')
    else:
        yield prefix, tree


@pytest.mark.parametrize('path', PPO_SAC_MODELS, ids=os.path.basename)
def test_checkpoint_unpickler_matches_pickle_load(path):
    assert len(PPO_SAC_MODELS) == 12
    with open(path, 'rb') as f:
        ref = pickle.load(f)       # the JAX stack resolves the pickle's classes
    ckpt = load_checkpoint(path)
    want = dict(_leaves(ref['agent']['params']))
    got = dict(_leaves(ckpt['params']))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert isinstance(got[name], np.ndarray) and got[name].dtype == np.asarray(arr).dtype
        np.testing.assert_array_equal(got[name], np.asarray(arr), err_msg=name)
    assert ckpt['obs_norm_state'] is None and ref.get('obs_norm_state') is None
    assert ckpt['raw']['total_steps'] == ref['total_steps']


def test_checkpoint_unpickler_refuses_other_globals(tmp_path):
    evil = tmp_path / 'evil.pt'
    with open(evil, 'wb') as f:
        pickle.dump({'agent': {'params': os.system}}, f)
    with pytest.raises(pickle.UnpicklingError, match='posix.system|os.system|nt.system'):
        load_checkpoint(evil)
    buf = io.BytesIO()
    pickle.dump({'agent': {'params': {'a': np.float32(1.5)}}, 'obs_norm_state': None}, buf)
    path = tmp_path / 'scalar.pt'
    path.write_bytes(buf.getvalue())
    assert load_checkpoint(path)['params']['a'] == np.float32(1.5)


@pytest.mark.parametrize('name', ['cartpole/cartpole_stab', 'cartpole/ppo_cartpole',
                                  'cartpole/sac_cartpole',
                                  'quadrotor_2D/quadrotor_2D_stab',
                                  'quadrotor_2D/ppo_quadrotor_2D',
                                  'quadrotor_2D/sac_quadrotor_2D',
                                  'quadrotor_3D/quadrotor_3D_stab',
                                  'quadrotor_3D/ppo_quadrotor_3D',
                                  'quadrotor_3D/sac_quadrotor_3D'])
def test_eval_configs_equal_their_yaml(name):
    import json
    with open(os.path.join(ROOT, 'examples', 'rl', 'config_overrides', f'{name}.yaml')) as f:
        want = yaml.safe_load(f)
    port = os.path.join(ROOT, 'safe_control_gym_tpu_torch', 'experiments', 'rl_configs',
                        f'{os.path.basename(name)}.json')
    with open(port) as f:
        assert json.load(f) == want


@pytest.mark.parametrize('algo', ['ppo', 'sac', 'ddpg'])
def test_default_algo_configs_equal_their_yaml(algo):
    from safe_control_gym_tpu.utils.registration import get_config as jget
    from safe_control_gym_tpu_torch.utils.registration import get_config as tget
    assert tget(algo) == jget(algo)
