"""The port's experiment config and training entry point against the JAX package's, on the CPU.

* ``utils/yaml_io.py``: the reader against ``yaml.safe_load`` on every YAML
  file of ``examples/`` and ``safe_control_gym_tpu/`` and on edge-case
  scalars; the writer read back by both; every construct outside the subset
  raises naming its line.
* ``ConfigFactory.merge`` against the JAX package's on the command lines of
  ``examples/rl/train_rl.py``, ``examples/hpo/hpo_experiment.py``, an MPC
  and a CBF experiment, ``--kv_overrides`` and ``--restore``. The one key
  that differs is the port's ``device``, its explicit device (the registry
  defaults of the two packages are equal, JSON against YAML).
* ``train(argv)`` at one iteration against ``make('ppo', ...)`` +
  ``learn()`` with the same seed, bit for bit.
"""

import glob
import os
import sys
from functools import partial

import numpy as np
import pytest
import torch
import yaml

from safe_control_gym_tpu.utils.configuration import ConfigFactory as JaxConfigFactory
from safe_control_gym_tpu_torch.experiments.train_rl_controller import train
from safe_control_gym_tpu_torch.math.optim import tree_leaves
from safe_control_gym_tpu_torch.utils import yaml_io
from safe_control_gym_tpu_torch.utils.configuration import ConfigFactory
from safe_control_gym_tpu_torch.utils.registration import make
from safe_control_gym_tpu_torch.utils.utils import unmunchify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT) for pattern in ('examples/**/*.yaml',
                                                        'safe_control_gym_tpu/**/*.yaml')
               for p in glob.glob(os.path.join(ROOT, pattern), recursive=True))


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def _same(a, b):
    """Equal values and equal types (key order aside), NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    return type(a) is type(b) and a == b


def test_the_repository_has_its_116_yaml_files():
    assert len(YAMLS) == 116


@pytest.mark.parametrize('path', YAMLS)
def test_reader_matches_safe_load(path):
    with open(os.path.join(ROOT, path)) as f:
        want = yaml.safe_load(f)
    assert _same(yaml_io.load_file(os.path.join(ROOT, path)), want)


@pytest.mark.parametrize('path', YAMLS)
def test_writer_reads_back(path):
    with open(os.path.join(ROOT, path)) as f:
        value = yaml.safe_load(f)
    text = yaml_io.dumps(value)
    assert _same(yaml.safe_load(text), value)
    assert _same(yaml_io.load(text), value)


SCALARS = ['a: 1e-3', 'a: 1.0e-3', 'a: 1.e+3', 'a: .5', 'a: -.inf', 'a: .NaN', 'a: 0x1F',
           'a: 017', 'a: 0o17', 'a: 1_000', 'a: 1:30', 'a: 1:30.5', 'a: yes', 'a: Off',
           'a: ON', 'a: ~', 'a:', 'a: ""', "a: 'it''s'", 'a: "x\\ty\\u00e9"', 'a: b c d',
           'a: [1, [2, 3], {x: 1, y: [a, b]}, "q,r", \'s\']', 'a: {}', 'a: []',
           'a: {b: , c: null}', '- 1\n- - 2\n  - 3\n- a: 1\n  b: 2\n- []',
           'x:\n- 1\n- 2\ny: 3', 'a: b#c # comment', 'a: http://x.y/z', '"k: 1": v',
           '1: one\n2.5: two\ntrue: t\n~: n', 'a:\n  b:\n    c: [1,2]\n  d: x',
           'a: -1', 'a: +2', 'a: 3.', 'a: 0.0001', 'a: 2001-12-14x', '# only a comment', '',
           'a:\n  - x: 1\n    y:\n      - 2\n  - z']


@pytest.mark.parametrize('text', SCALARS)
def test_reader_resolves_scalars_as_safe_load(text):
    assert _same(yaml_io.load(text), yaml.safe_load(text))


REFUSED = [('a: 1\nb: &x 1', 2, 'anchor'), ('a: *x', 1, 'alias'), ('a: !!str 1', 1, 'tag'),
           ('a: 1\nb: |\n  x', 2, 'block scalar'), ('a: >\n  x', 1, 'block scalar'),
           ('? a\n: b', 1, 'complex key'), ('a: b\n  c', 2, 'multi-line'),
           ('a: [1,\n 2]', 1, 'must end on its line'), ('---\na: 1', 1, 'document'),
           ('a: 1\nd: 2001-12-14', 2, 'timestamp'), ('<<: {a: 1}', 1, 'merge'),
           ('a: "x', 1, 'must end on its line'), ('a: 1\n\tb: 2', 2, 'tabs'),
           ('a: 1\n b: 2', 2, 'multi-line'), ('a:\n  - 1\n   - 2', 3, 'indentation')]


@pytest.mark.parametrize('text,line,what', REFUSED)
def test_reader_refuses_outside_the_subset_naming_the_line(text, line, what):
    with pytest.raises(yaml_io.YAMLSubsetError, match=rf'^cfg\.yaml:{line}: .*{what}'):
        yaml_io.load(text, 'cfg.yaml')


def test_writer_round_trips_values_that_need_quotes():
    value = {'a': '1e-3', 'b': 'yes', 'c': '', 'd': 'x: y', 'e': "it's", 'f': 'a\nb',
             'g': 1e-5, 'h': float('inf'), 'i': [{'x': [1, 2]}, [3, [4]], {}], 'j': None,
             'k': ' lead', 'l': '#h', 'm': '- x', 'n': 'null', 'o': '3.0', 'p': 'é', 5: 'five',
             'q': [[]], 'r': 'a:', 's': '~', 't': '017', 'u': np.float32(0.5), 'v': (1, 2)}
    text = yaml_io.dumps(value)
    want = dict(value, u=0.5, v=[1, 2])
    assert _same(yaml.safe_load(text), want) and _same(yaml_io.load(text), want)


# -- ConfigFactory ---------------------------------------------------------

RL = ['--algo', 'ppo', '--task', 'cartpole', '--overrides',
      'examples/rl/config_overrides/cartpole/cartpole_stab.yaml',
      'examples/rl/config_overrides/cartpole/ppo_cartpole.yaml']
COMMAND_LINES = {
    'train_rl': RL,
    'hpo_experiment': ['--algo', 'ppo', '--task', 'cartpole', '--overrides',
                       'examples/hpo/config_overrides/ppo_cartpole_hpo.yaml'],
    'mpc_experiment': ['--algo', 'mpc', '--task', 'quadrotor', '--overrides',
                       'examples/mpc/config_overrides/quadrotor_2D/quadrotor_2D_track.yaml',
                       'examples/mpc/config_overrides/quadrotor_2D/mpc_quadrotor_2D_track.yaml'],
    'cbf_experiment': ['--algo', 'lqr', '--task', 'cartpole', '--safety_filter', 'cbf',
                       '--overrides', 'examples/cbf/config_overrides/cartpole/cartpole_stab.yaml',
                       'examples/cbf/config_overrides/cartpole/lqr_cartpole_stab.yaml',
                       'examples/cbf/config_overrides/cartpole/cbf_cartpole_stab.yaml'],
    'kv_overrides': RL + ['--seed', '3', '--tag', 'run', '--kv_overrides',
                          'algo_config.max_env_steps=19200', 'task_config.task_info.x=[1, 2]',
                          'algo_config.activation=relu', 'new.key={"a": None}'],
}


def _merges(monkeypatch, argv):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, 'argv', ['prog'] + argv)
    return unmunchify(JaxConfigFactory().merge()), unmunchify(ConfigFactory().merge())


@pytest.mark.parametrize('name', sorted(COMMAND_LINES))
def test_merge_matches_jax(monkeypatch, name):
    want, got = _merges(monkeypatch, COMMAND_LINES[name])
    # The port's explicit device, 'cuda' unless the command line says otherwise.
    assert got.pop('device') == 'cuda'
    assert _same(got, want)


def test_restore_matches_jax(monkeypatch, tmp_path):
    saved, _ = _merges(monkeypatch, COMMAND_LINES['kv_overrides'])
    saved['output_dir'] = str(tmp_path)
    with open(tmp_path / 'config.yaml', 'w') as f:
        yaml.dump(saved, f, default_flow_style=False)
    want, got = _merges(monkeypatch, ['--restore', str(tmp_path), '--seed', '5'])
    assert got.pop('device') == 'cuda'
    assert _same(got, want) and got['seed'] == 5 and got['restore'] == str(tmp_path)


def test_device_comes_from_the_command_line(monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['prog', '--device', 'cpu'])
    assert ConfigFactory().merge().device == 'cpu'
    assert ConfigFactory().merge(argv=[]).device == 'cuda'


# -- train_rl_controller ----------------------------------------------------

ONE_ITERATION = ['algo_config.max_env_steps=32', 'algo_config.rollout_batch_size=4',
                 'algo_config.rollout_steps=8', 'algo_config.mini_batch_size=16',
                 'algo_config.opt_epochs=2', 'algo_config.hidden_dim=16']


def test_train_matches_make_and_learn(monkeypatch, tmp_path):
    monkeypatch.chdir(ROOT)
    out = train(RL + ['--kv_overrides'] + ONE_ITERATION +
                ['--seed', '2', '--device', 'cpu', '--output_dir', str(tmp_path)])
    assert os.path.dirname(os.path.dirname(out)) == str(tmp_path)
    assert os.path.exists(os.path.join(out, 'model_latest.pt'))
    saved = yaml_io.load_file(os.path.join(out, 'config.yaml'))
    assert saved['algo_config']['max_env_steps'] == 32 and saved['device'] == 'cpu'
    assert saved == yaml.safe_load(open(os.path.join(out, 'config.yaml')))
    # The same run by hand: the same seed, env factory and config.
    ref = make('ppo', partial(make, 'cartpole', device='cpu', output_dir=str(tmp_path / 'ref'),
                              **saved['task_config']),
               output_dir=str(tmp_path / 'ref'), seed=2, **saved['algo_config'])
    torch.manual_seed(2)
    ref.reset()
    ref.learn()
    trained = make('ppo', partial(make, 'cartpole', device='cpu', **saved['task_config']),
                   output_dir=str(tmp_path / 'load'), **saved['algo_config'])
    trained.load(os.path.join(out, 'model_latest.pt'))
    assert trained.total_steps == ref.total_steps == 32
    for got, want in zip(tree_leaves(trained.agent.params), tree_leaves(ref.agent.params)):
        assert torch.equal(got, want)
    obs = np.random.default_rng(0).normal(0, 0.2, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(trained.select_action(obs), ref.select_action(obs))
    # --restore gives back the run's config.
    restored = unmunchify(ConfigFactory().merge(argv=['--restore', out]))
    assert restored.pop('restore') == out and saved.pop('restore') is None
    assert restored == saved


def test_train_plots_or_skips_them(monkeypatch, tmp_path, capsys):
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith('matplotlib'):
            raise ImportError('No module named matplotlib')
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_matplotlib)
    monkeypatch.chdir(ROOT)
    out = train(RL + ['--kv_overrides'] + ONE_ITERATION +
                ['--device', 'cpu', '--output_dir', str(tmp_path)])
    assert 'plotting skipped' in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, 'model_latest.pt'))
