"""The port's training and evaluation entry points against the JAX package's,
on the CPU: the fused fleet evaluation, the differentiable simulation, HPO,
``train_rl`` with ``rl_experiment``, and ``generate_pretrained``.

The differentiable simulation's first cost is held within 1e-4 of JAX's and
its last within 1e-3 (20 Adam steps on float32 gradients). Where the numbers
come from each package's own random stream (initial states, PPO's training
draws), the port's figures are held to the JAX package's own tests' bars
and to the JAX script's structure (the same keys, paths, counts and HPO
suggestions). ``generate_pretrained`` writes into a temporary directory and
leaves every committed file under ``examples/*/models/`` as it was.
"""

import glob
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_examples import EXAMPLES, load_jax_example, overrides


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module, the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def test_fused_eval_demo_matches_jax_structure():
    """The committed model's fleet evaluation: JAX's keys, path and counts, and
    the JAX test's bars (the initial states are each package's own draws)."""
    from safe_control_gym_tpu_torch.examples.rl import fused_eval_demo
    want = load_jax_example('rl/fused_eval_demo.py').run(batch=64, n_steps=400)
    got = fused_eval_demo.run(batch=64, n_steps=400, device='cpu')
    assert set(got) >= set(want) and got['path'] == want['path']
    assert (got['total_steps'], got['episodes']) == (want['total_steps'], want['episodes'])
    assert got['ep_length_mean'] > 150 and got['ep_return_mean'] > 0.7 * got['ep_length_mean']
    np.testing.assert_allclose(got['ep_return_mean'], want['ep_return_mean'], rtol=0.1)


def test_differentiable_sim_demo_matches_jax():
    from safe_control_gym_tpu_torch.examples import differentiable_sim_demo
    j0, j1 = load_jax_example('differentiable_sim_demo.py').main(T=20, iters=20)
    c0, c1 = differentiable_sim_demo.main(T=20, iters=20, device='cpu')
    np.testing.assert_allclose(c0, j0, rtol=1e-4)
    np.testing.assert_allclose(c1, j1, rtol=1e-3)
    assert c1 < 0.9 * c0


def test_hpo_experiment_suggests_jax_trials(monkeypatch, tmp_path):
    """Two sequential trials of 2 PPO iterations: the sampler's suggestions
    equal JAX's, each trial's value finite."""
    from safe_control_gym_tpu_torch.examples.hpo import hpo_experiment
    argv = ['--algo', 'ppo', '--task', 'cartpole', '--overrides',
            os.path.join(EXAMPLES, 'hpo', 'config_overrides', 'ppo_cartpole_hpo.yaml'),
            '--kv_overrides', 'algo_config.max_env_steps=3200', 'hpo_config.trials=2',
            'hpo_config.n_episodes=1',
            "hpo_config.hps_config={'actor_lr': 1, 'critic_lr': 1, 'entropy_coef': 1}"]
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv + ['--output_dir', str(tmp_path / 'jax')])
    want = load_jax_example('hpo/hpo_experiment.py').run()
    monkeypatch.setattr(sys, 'argv', ['x.py'] + argv + ['--output_dir', str(tmp_path / 'port'),
                                      '--device', 'cpu'])
    got = hpo_experiment.run()
    assert len(got.trials) == len(want.trials) == 2
    assert [t['params'] for t in got.trials] == [t['params'] for t in want.trials]
    assert all(np.isfinite(t['value']) for t in got.trials)
    assert got.best_params in [t['params'] for t in got.trials]


def test_train_rl_then_rl_experiment(monkeypatch, tmp_path):
    """``train_rl`` writes the port's checkpoint where ``rl_experiment`` finds
    it (the JAX test's cell: PPO on the cartpole, 2000 env steps)."""
    from safe_control_gym_tpu_torch.examples.rl import rl_experiment, train_rl
    args = ['x.py', '--algo', 'ppo', '--task', 'cartpole', '--overrides',
            *overrides('rl', 'cartpole', 'cartpole_stab.yaml', 'ppo_cartpole.yaml'),
            '--kv_overrides', 'algo_config.max_env_steps=2000', 'algo_config.rollout_batch_size=8',
            '--output_dir', str(tmp_path), '--device', 'cpu']
    monkeypatch.setattr(sys, 'argv', args)
    path = train_rl.run(curr_path=str(tmp_path))
    assert path == str(tmp_path / 'models' / 'ppo' / 'ppo_model_cartpole_stab.pt')
    trajs, metrics = rl_experiment.run(n_episodes=None, n_steps=10, curr_path=str(tmp_path))
    assert 'average_rmse' in metrics and len(trajs['action'][0]) > 0


def _models_digest():
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(EXAMPLES, '*', 'models', '**', '*'),
                                 recursive=True)):
        if os.path.isfile(path):
            h.update(path.encode())
            with open(path, 'rb') as f:
                h.update(f.read())
    return h.hexdigest()


def test_generate_pretrained_writes_a_loadable_model_and_leaves_the_committed_ones(
        tmp_path, monkeypatch):
    from functools import partial

    from safe_control_gym_tpu_torch.examples import generate_pretrained
    from safe_control_gym_tpu_torch.examples.rl import rl_experiment
    from safe_control_gym_tpu_torch.utils.registration import get_config, make
    before = _models_digest()
    with pytest.raises(ValueError, match='examples/'):
        generate_pretrained.main(['--out_dir', os.path.join(EXAMPLES, 'rl'), '--only'])
    paths = generate_pretrained.main(['--only', 'ppo_cartpole_stab', '--steps', '1',
                                      '--out_dir', str(tmp_path), '--device', 'cpu'])
    path = paths['ppo_cartpole_stab']
    assert path == str(tmp_path / 'rl' / 'models' / 'ppo' / 'ppo_model_cartpole_stab.pt')
    ctrl = make('ppo', partial(make, 'cartpole', device='cpu'),
                **dict(get_config('ppo'), training=False))
    ctrl.load(path)
    assert ctrl.total_steps == 64 * 150       # one iteration of the example's config
    monkeypatch.setattr(sys, 'argv', [
        'x.py', '--algo', 'ppo', '--task', 'cartpole', '--overrides',
        *overrides('rl', 'cartpole', 'cartpole_stab.yaml', 'ppo_cartpole.yaml'),
        '--kv_overrides', 'algo_config.training=False', '--device', 'cpu'])
    _, metrics = rl_experiment.run(n_episodes=None, n_steps=10,
                                   curr_path=str(tmp_path / 'rl'))
    assert 'average_return' in metrics
    assert _models_digest() == before


def test_a_checkpoint_of_the_cards_generator_loads_on_the_cpu(tmp_path):
    """A model saved on the card carries the card's generator state (16
    bytes, Philox); a CPU controller loading it re-seeds its own generator
    from its seed, as for a JAX checkpoint, and takes the model
    (``rl_experiment`` on the CPU of a model trained on the card)."""
    from functools import partial

    from safe_control_gym_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from safe_control_gym_tpu_torch.utils.registration import get_config, make
    cfg = dict(get_config('ppo'), training=False)
    ctrl = make('ppo', partial(make, 'cartpole', device='cpu'), **dict(cfg, seed=7))
    ctrl.save(str(tmp_path / 'cpu.pt'))
    raw = load_checkpoint(str(tmp_path / 'cpu.pt'))['raw']
    raw['key'] = np.arange(16, dtype=np.uint8)      # the card's generator state
    save_checkpoint(str(tmp_path / 'card.pt'), raw)
    other = make('ppo', partial(make, 'cartpole', device='cpu'), **dict(cfg, seed=3))
    other.gen.manual_seed(99)
    other.load(str(tmp_path / 'card.pt'))
    assert torch.equal(other.gen.get_state(), torch.Generator().manual_seed(3).get_state())
    obs = np.array([0.1, 0.0, 0.05, 0.0], np.float32)
    np.testing.assert_allclose(other.select_action(obs), ctrl.select_action(obs), rtol=1e-6)
