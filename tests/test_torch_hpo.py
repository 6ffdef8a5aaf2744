"""The port's hyperparameter study and HPO against the JAX package's, on the CPU.

* The study: with the same seed and the same reported values, the port's
  TPE and Random samplers suggest exactly what the JAX package's suggest
  (both draw from numpy), single- and multi-objective.
* The port's copies of the JAX package's cases in
  tests/test_hpo/{test_database,test_pruning,test_multi_objective,
  test_shared_storage}.py: the SQLite store, the pruner, adaptive
  repetitions, Pareto studies and their artifacts, processes sharing a study.
* HPO end to end: a two-trial sequential study of
  examples/hpo/config_overrides/ppo_cartpole_hpo.yaml (cut to one short
  iteration) and a two-round vectorized one write ``trials.csv`` and
  ``hyperparameters_0.yaml``; the SAC and GP-MPC example configs score a
  trial each.
"""

import glob
import json
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from safe_control_gym_tpu.hyperparameters import hpo_sampler as jax_sampler
from safe_control_gym_tpu.hyperparameters.study import create_study as jax_create_study
from safe_control_gym_tpu_torch.hyperparameters import database, hpo_sampler
from safe_control_gym_tpu_torch.hyperparameters.database import SqliteTrialStore
from safe_control_gym_tpu_torch.hyperparameters.hpo import HPO
from safe_control_gym_tpu_torch.hyperparameters.hpo_sampler import HYPERPARAMS_SAMPLER
from safe_control_gym_tpu_torch.hyperparameters.study import (MedianPruner, TrialPruned,
                                                              create_study)
from safe_control_gym_tpu_torch.utils import yaml_io
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _objective(trial):
    x = trial.suggest_float('x', -2.0, 2.0)
    return -(x - 0.7) ** 2


def _worker(storage_path, seed, n_trials):
    study = create_study(direction='maximize', sampler='random', seed=seed,
                         storage_path=storage_path)
    study.optimize(_objective, n_trials=n_trials)


def _ppo_objective(trial, sampler):
    """A deterministic score of the PPO space's suggestion."""
    s = sampler({}, trial)
    return (np.log(s['actor_lr']) + s['hidden_dim'] / 64 - 10 * abs(s['gamma'] - 0.99)
            + (s['activation'] == 'tanh') - s['opt_epochs'] / 10)


# -- the study against the JAX package's ----------------------------------

@pytest.mark.parametrize('sampler', ['tpe', 'random'])
@pytest.mark.parametrize('direction', ['maximize', 'minimize'])
def test_study_suggests_as_jax(sampler, direction):
    port = create_study(direction=direction, sampler=sampler, seed=3)
    ref = jax_create_study(direction=direction, sampler=sampler, seed=3)
    port.optimize(lambda t: _ppo_objective(t, HYPERPARAMS_SAMPLER['ppo']), n_trials=16)
    ref.optimize(lambda t: _ppo_objective(t, jax_sampler.HYPERPARAMS_SAMPLER['ppo']),
                 n_trials=16)
    assert [t['params'] for t in port.trials] == [t['params'] for t in ref.trials]
    assert [t['value'] for t in port.trials] == [t['value'] for t in ref.trials]
    assert port.best_params == ref.best_params


def test_pareto_study_suggests_as_jax():
    port = create_study(direction=['maximize', 'minimize'], sampler='tpe', seed=1)
    ref = jax_create_study(direction=['maximize', 'minimize'], sampler='tpe', seed=1)

    def objective(trial):
        x = trial.suggest_float('x', 1e-3, 1.0, log=True)
        c = trial.suggest_categorical('c', [1, 2, 3])
        return [x * c, (x - 0.5) ** 2]

    port.optimize(objective, n_trials=14)
    ref.optimize(objective, n_trials=14)
    assert [t['params'] for t in port.trials] == [t['params'] for t in ref.trials]
    assert ([t['number'] for t in port.best_trials]
            == [t['number'] for t in ref.best_trials])


def test_search_spaces_match_jax():
    for name in ('PPO_dict', 'SAC_dict', 'GPMPC_dict'):
        assert getattr(hpo_sampler, name) == getattr(jax_sampler, name)


# -- tests/test_hpo/test_database.py ------------------------------------------

def test_sqlite_study_optimize_and_resume(tmp_path):
    path = str(tmp_path / 'study.db')
    s1 = create_study(sampler='tpe', seed=0, storage_path=path)
    s1.optimize(_objective, n_trials=5)
    assert os.path.exists(path)
    s2 = create_study(sampler='tpe', seed=1, storage_path=path)
    assert len(s2.trials) == 5
    s2.optimize(_objective, n_trials=3)
    assert len(s2.trials) == 8 and s2.best_value is not None
    s1.close()
    s2.close()


@pytest.mark.parametrize('storage', ['study.db', 'study.json'])
def test_two_processes_share_one_study(tmp_path, storage):
    storage = str(tmp_path / storage)
    ctx = mp.get_context('spawn')
    ps = [ctx.Process(target=_worker, args=(storage, seed, 6)) for seed in (1, 2)]
    for p in ps:
        p.start()
    for p in ps:
        p.join(timeout=180)
        assert not p.is_alive() and p.exitcode == 0
    if storage.endswith('.db'):
        trials = SqliteTrialStore(storage).load()
    else:
        with open(storage) as f:
            trials = json.load(f)
    assert len(trials) == 12, len(trials)
    assert len({t['uid'] for t in trials}) == 12
    assert sorted(t['number'] for t in trials) == list(range(12))
    assert all(np.isfinite(t['value']) for t in trials)


def test_trial_record_round_trip(tmp_path):
    store = SqliteTrialStore(str(tmp_path / 's.db'))
    t = {'uid': 'abc123', 'number': 0, 'params': {'lr': 3e-4, 'act': 'tanh'},
         'value': 1.5, 'values': [1.5, -0.25], 'state': 'COMPLETE',
         'intermediate': {'0': 1.0, '1': 1.5}}
    assert store.merge_write([t]) == [t]
    out = store.merge_write([dict(t, value=2.0, values=[2.0, -0.1])])
    assert len(out) == 1 and out[0]['value'] == 2.0
    store.close()


def test_backup_restore_create_drop(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = database.create('mystudy')
    assert os.path.isdir(path) and SqliteTrialStore(database.study_db_path('mystudy')).load() == []
    s = create_study(sampler='random', seed=0, storage_path=database.study_db_path('mystudy'))
    s.optimize(_objective, n_trials=4)
    s.close()
    dump = database.backup('mystudy')
    assert open(dump).read().startswith('BEGIN')
    before = SqliteTrialStore(database.study_db_path('mystudy')).load()
    database.drop('mystudy')
    assert not os.path.isdir(path)
    database.restore(dump, 'mystudy')
    after = SqliteTrialStore(database.study_db_path('mystudy')).load()
    assert after == before and len(after) == 4


def test_database_command_line_creates_and_drops(tmp_path):
    run = lambda func: subprocess.run(
        [sys.executable, '-m', 'safe_control_gym_tpu_torch.hyperparameters.database',
         '--func', func, '--tag', 'cli'], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    proc = run('create')
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(tmp_path / 'hpo_storage' / 'cli_hpo' / 'study.db')
    proc = run('drop')
    assert proc.returncode == 0, proc.stderr
    assert not os.path.exists(tmp_path / 'hpo_storage' / 'cli_hpo')


def test_refresh_sees_other_studies_trials(tmp_path):
    storage = str(tmp_path / 'study.json')
    s1 = create_study(direction='maximize', sampler='random', seed=1, storage_path=storage)
    s2 = create_study(direction='maximize', sampler='random', seed=2, storage_path=storage)
    s1.optimize(_objective, n_trials=3)
    s2.refresh()
    assert len(s2.trials) == 3
    s2.optimize(_objective, n_trials=2)
    s1.refresh()
    assert len(s1.trials) == 5 and s1.best_value == s2.best_value


# -- tests/test_hpo/test_pruning.py -------------------------------------------

def test_median_pruner_prunes_bad_trials_and_keeps_good_ones():
    study = create_study(direction='maximize', sampler='random',
                         pruner=MedianPruner(n_startup_trials=3))
    pruned_at = []

    def objective(trial):
        trial.suggest_float('x', 0.0, 1.0)
        quality = 10.0 if trial.number < 3 else 0.0
        for step in range(3):
            trial.report(quality, step)
            if step < 2 and trial.should_prune():
                pruned_at.append((trial.number, step))
                raise TrialPruned()
        return quality

    study.optimize(objective, n_trials=5)
    assert [t['state'] for t in study.trials] == ['COMPLETE'] * 3 + ['PRUNED'] * 2
    assert all(step == 0 for _, step in pruned_at) and study.best_value == 10.0
    good = create_study(direction='maximize', sampler='random',
                        pruner=MedianPruner(n_startup_trials=3))

    def improving(trial):
        trial.suggest_float('x', 0.0, 1.0)
        for step in range(3):
            trial.report(10.0 + trial.number, step)
            if trial.should_prune():
                raise TrialPruned()
        return 10.0 + trial.number

    good.optimize(improving, n_trials=6)
    assert all(t['state'] == 'COMPLETE' for t in good.trials)


def test_hpo_adaptive_repetitions(monkeypatch, tmp_path):
    monkeypatch.setitem(HYPERPARAMS_SAMPLER, 'fake', lambda cfg, trial: {})
    hpo = HPO('fake', 'cartpole', sampler='random', output_dir=str(tmp_path), device='cpu',
              hpo_config=dict(trials=3, repetitions=2, n_episodes=1, alpha=0.5, prune=False,
                              dynamical_runs=True, warm_trials=1,
                              approximation_threshold=0.5, max_extra_repetitions=3))
    script = {0: [10.0] * 6, 1: [5.0] * 6, 2: [50.0, 50.0, 30.0, 30.2, 30.2, 30.2]}
    calls = {0: 0, 1: 0, 2: 0}

    def fake_rep(trial, rep):
        calls[trial.number] += 1
        return [script[trial.number][rep]]

    monkeypatch.setattr(hpo, '_one_repetition', fake_rep)
    hpo.study.optimize(hpo.objective, n_trials=3, catch=(Exception,))
    assert calls[0] == 2 and calls[1] == 2 and calls[2] > 2, calls
    assert hpo.study.trials[2]['state'] == 'COMPLETE'
    assert len(hpo.study.trials[2]['intermediate']) == calls[2]
    hpo.close()


def test_pruned_trials_excluded_from_best():
    study = create_study(direction='minimize', sampler='random',
                         pruner=MedianPruner(n_startup_trials=1))

    def objective(trial):
        trial.suggest_float('x', 0.0, 1.0)
        if trial.number == 1:
            trial.report(1e9, 0)
            if trial.should_prune():
                raise TrialPruned()
        trial.report(1.0, 0)
        return 1.0

    study.optimize(objective, n_trials=3)
    assert study.trials[1]['state'] == 'PRUNED' and study.trials[1]['value'] is None
    assert study.best_value == 1.0


# -- tests/test_hpo/test_multi_objective.py -----------------------------------

def test_pareto_front_and_is_better(tmp_path):
    study = create_study(direction=['maximize', 'minimize'], sampler='random', seed=0,
                         storage_path=str(tmp_path / 's.json'))
    study.optimize(lambda t: [t.suggest_float('x', 0.0, 1.0)] * 2, n_trials=12)
    assert len(study.best_trials) == 12
    assert study._dominates([0.9, 0.1], [0.5, 0.5])
    assert not study._dominates([0.5, 0.5], [0.9, 0.1])
    other = create_study(direction=['maximize', 'minimize'], sampler='random', seed=0,
                         storage_path=str(tmp_path / 'o.json'))
    other.optimize(lambda t: [0.5, 0.5], n_trials=1)
    assert other.is_better([0.6, 0.4]) and other.is_better([0.6, 0.6])
    assert not other.is_better([0.4, 0.6])


@pytest.mark.parametrize('multi', [False, True])
def test_hpo_study_artifacts(tmp_path, monkeypatch, multi):
    monkeypatch.setitem(HYPERPARAMS_SAMPLER, 'fake', lambda cfg, trial: {
        'lr': trial.suggest_float('lr', 1e-4, 1e-1, log=True)})
    cfg = dict(trials=6, repetitions=2, n_episodes=1, alpha=0.5, prune=False)
    if multi:
        cfg.update(objective=['average_return', 'average_constraint_violation'],
                   direction=['maximize', 'minimize'])
    hpo = HPO('fake', 'cartpole', sampler='random', output_dir=str(tmp_path), device='cpu',
              hpo_config=cfg)
    rng = np.random.default_rng(0)
    monkeypatch.setattr(hpo, '_one_repetition_metrics', lambda trial, rep: {
        'average_return': 100 * trial.params['lr'] + rng.normal(0, 0.1),
        'average_constraint_violation': 50 * trial.params['lr'] + rng.normal(0, 0.05)})
    monkeypatch.setattr(hpo, '_one_repetition',
                        lambda trial, rep: [1000 * trial.params['lr']])
    hpo.hyperparameter_optimization()
    with open(tmp_path / 'trials.csv') as f:
        header = f.readline()
    if multi:
        front = hpo.study.best_trials
        found = glob.glob(str(tmp_path / 'best_hyperparameters_[[]*.yaml'))
        assert len(found) == len(front) >= 1
        assert 'value_0' in header and 'value_1' in header
        names = ['_average_return', '_average_constraint_violation']
    else:
        best = yaml_io.load_file(str(tmp_path / 'hyperparameters_0.yaml'))
        assert best == {'lr': hpo.study.best_params['lr']}
        hist = [t for t in hpo.study.trials if t['value'] is not None]
        assert hpo._param_importances(hist, [t['value'] for t in hist])['lr'] > 0.99
        names = ['']
    for name in names:
        assert os.path.exists(tmp_path / f'optimization_history{name}.png')
        assert os.path.exists(tmp_path / f'param_importances{name}.png')
    hpo.close()


# -- HPO end to end -------------------------------------------------------------

def _hpo_config(tmp_path, *kv):
    argv = ['--algo', 'ppo', '--task', 'cartpole', '--device', 'cpu', '--output_dir',
            str(tmp_path), '--overrides',
            os.path.join(ROOT, 'examples/hpo/config_overrides/ppo_cartpole_hpo.yaml'),
            '--kv_overrides', 'algo_config.max_env_steps=32', 'algo_config.rollout_batch_size=4',
            'algo_config.rollout_steps=8', 'hpo_config.trials=2', 'hpo_config.n_episodes=2',
            *kv]
    return ConfigFactory().merge(argv=argv)


def _run_hpo(config):
    hpo = HPO(config.algo, config.task, output_dir=config.output_dir,
              task_config=config.task_config, algo_config=config.algo_config,
              hpo_config=config.hpo_config, device=config.device)
    study = hpo.hyperparameter_optimization()
    hpo.close()
    return hpo, study


def test_sequential_hpo_of_the_example_config(tmp_path):
    config = _hpo_config(tmp_path)
    assert config.hpo_config.hps_config['hidden_dim'] == 1
    hpo, study = _run_hpo(config)
    assert len(study.trials) == 2 and all(t['state'] == 'COMPLETE' for t in study.trials)
    assert set(study.trials[0]['params']) == set(config.hpo_config.hps_config)
    for name in ('trials.csv', 'hyperparameters_0.yaml', 'study.db'):
        assert os.path.exists(tmp_path / name)
    assert len(glob.glob(str(tmp_path / 'trial_*'))) == 2


def test_vectorized_hpo_rounds(tmp_path):
    config = _hpo_config(tmp_path, 'hpo_config.trials=4', 'hpo_config.vectorized_trials=2',
                         'hpo_config.repetitions=2',
                         "hpo_config.hps_config={'actor_lr': 1, 'critic_lr': 1, "
                         "'entropy_coef': 1, 'gamma': 1, 'target_kl': 1}")
    hpo, study = _run_hpo(config)
    done = [t for t in study.trials if t['state'] == 'COMPLETE']
    assert len(done) == 4
    assert set(done[0]['params']) == {'actor_lr', 'critic_lr', 'entropy_coef', 'gamma',
                                      'target_kl'}
    assert [r['lanes'] for r in hpo.vectorized_rounds] == [4, 4]
    for name in ('trials.csv', 'hyperparameters_0.yaml'):
        assert os.path.exists(tmp_path / name)


def test_sac_and_gp_mpc_example_configs_score_a_trial(tmp_path):
    root = os.path.join(ROOT, 'examples', 'hpo', 'config_overrides')
    spec = yaml_io.load_file(os.path.join(root, 'sac_cartpole_hpo.yaml'))
    hpo_cfg = dict(spec['hpo_config'], trials=1, n_episodes=1,
                   hps_config={'gamma': 1, 'tau': 1, 'actor_lr': 1, 'critic_lr': 1})
    hpo = HPO('sac', 'cartpole', output_dir=str(tmp_path / 'sac'), device='cpu',
              task_config=spec['task_config'],
              algo_config=dict(spec['algo_config'], max_env_steps=600, warm_up_steps=300),
              hpo_config=hpo_cfg)
    study = hpo.hyperparameter_optimization()
    hpo.close()
    assert len(study.trials) == 1 and np.isfinite(study.best_value)
    # GP-MPC's run() has no n_episodes: the trial is scored through
    # BaseExperiment's per-episode returns.
    spec = yaml_io.load_file(os.path.join(root, 'gp_mpc_cartpole_hpo.yaml'))
    hpo = HPO('gp_mpc', 'cartpole', output_dir=str(tmp_path / 'gp_mpc'), device='cpu',
              task_config=dict(spec['task_config'], episode_len_sec=1),
              algo_config=dict(spec['algo_config'], horizon=5, num_epochs=1, num_samples=10,
                               optimization_iterations=10),
              hpo_config=dict(spec['hpo_config'], trials=1, repetitions=1, n_episodes=1,
                              prune=False, hps_config={'learning_rate': 1}))
    study = hpo.hyperparameter_optimization()
    hpo.close()
    assert len(study.trials) == 1
    # A crashed trial would score -inf; a quadratic-cost episode is negative.
    assert np.isfinite(study.best_value) and study.best_value < 0

