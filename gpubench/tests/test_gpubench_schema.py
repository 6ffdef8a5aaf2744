"""The result's last line, and a run without a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL, small_config
from gpubench.harness import core
from gpubench.harness.checks import Check
from gpubench.run import run_cell

TOP = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('trace', [False, True])
def test_last_line_schema(trace):
    cell = 'cartpole_ppo.sim_open'
    result, checks = run_cell(cell, 99, 0.2, trace, device='cpu', params=SMALL[cell],
                              config=small_config(cell))
    d = json.loads(core.result_line(result, checks))
    keys = list(d)
    assert keys[:5] == TOP and keys[-1] == 'checks'
    assert isinstance(d['correct'], bool) and d['failed'] == 0
    for name, m in d['metrics'].items():
        assert set(m) == {'value', 'unit'} and isinstance(m['value'], float)
    if trace:
        assert set(d['metrics']) <= {'roofline.open_loop', 'device_idle.sim'}
        assert set(d['breakdown']) == {'device_ops', 'idle_gaps'}
        assert all(len(v) <= 10 for v in d['breakdown'].values())
    else:
        assert set(d['metrics']) == {'sim_steps_per_s', 'setup_s'}
    assert set(d['device']) >= {'platform', 'kind', 'count', 'memory_peak_bytes'}
    assert d['checks'] == {c.name: {'value': c.value, 'limit': c.limit} for c in checks}


def test_failed_check_is_not_correct():
    line = json.loads(core.result_line({'correct': False, 'attempted': 4, 'failed': 4,
                                        'metrics': {}, 'device': {}}, [Check('gap', 1.0, 0.0)]))
    assert line['correct'] is False and line['checks']['gap'] == {'value': 1.0, 'limit': 0.0}


def test_no_card_exits_nonzero_without_a_result():
    env = {**os.environ, 'CUDA_VISIBLE_DEVICES': ''}
    proc = subprocess.run([sys.executable, 'gpubench/run.py', '--workload',
                           'cartpole_ppo.sim_open', '--seed', '1', '--seconds', '1',
                           '--trace', '0'], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'no CUDA device' in proc.stderr


def test_unknown_workload_exits_nonzero():
    proc = subprocess.run([sys.executable, 'gpubench/run.py', '--workload', 'no_such.cell',
                           '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ''
    assert 'no_such.cell' in proc.stderr
