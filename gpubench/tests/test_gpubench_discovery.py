"""Every name in BENCHMARK.json finds its files, and the file keeps to the
benchmark's contract."""

import json
import os
import re

import pytest

from gpubench.harness import core

BENCH = core.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]
LAYER = [m['name'] for m in BENCH['per_layer']]


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files(cell):
    entry = core.cell_entry(BENCH, cell)
    w = core.workload(cell)
    assert w['config'] == entry['config']
    assert w['chips'] == entry['chips'] == 1
    assert w['why'] == entry['why']
    assert core.config(w['config'])['name'] == w['config']
    driver = core.load_module('drivers', w['driver'])
    assert callable(driver.make)
    reported = {m['name'] for m in core.end_to_end_metrics(BENCH, cell)}
    assert {'setup_s', w['metric']} <= reported
    for m in core.per_layer_metrics(BENCH, cell):
        assert m['moves'] in reported


@pytest.mark.parametrize('metric', LAYER)
def test_metric_reader(metric):
    reader = core.load_module('metrics', metric)
    assert reader.read({'trace': None, 'counts': {}}) is None


@pytest.mark.parametrize('kind, name', [('workloads', 'no_such.cell'),
                                        ('configs', 'no_such_config'),
                                        ('drivers', 'no_such_driver'),
                                        ('metrics', 'no_such.metric')])
def test_unknown_name_fails(kind, name):
    with pytest.raises(core.UnknownName, match=name):
        if kind == 'workloads':
            core.workload(name)
        elif kind == 'configs':
            core.config(name)
        else:
            core.load_module(kind, name)
    with pytest.raises(core.UnknownName):
        core.cell_entry(BENCH, 'no_such.cell')


def test_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert os.path.getsize(os.path.join(core.ROOT, 'BENCHMARK.json')) <= 64 * 1024
    assert 1 <= BENCH['run_seconds'] <= 51
    for path in BENCH['paths']:
        assert os.path.isdir(os.path.join(core.ROOT, path))
    names = [c['name'] for c in BENCH['configs']]
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and os.path.exists(os.path.join(core.ROOT, c['file']))
        cfg = core.load_json(os.path.join(core.ROOT, c['file']))
        assert sorted(c['reduced']) == sorted(cfg['reduced'])
        for key in c['reduced']:
            assert NAME.match(key) and key in cfg['algo_config']
            assert not key.endswith(('_dim', '_rank')) and 'hidden' not in key
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in names and NAME.match(w['traffic'])
        assert 1 <= len(w['why']) <= 200 and '\n' not in w['why']
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(set(pairs)) == len(pairs)
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
    e2e = {m['name'] for m in BENCH['end_to_end']}
    layers = {}
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and 1 <= len(m['layer']) <= 200
        layers.setdefault(m['layer'].lower(), set()).add(m['layer'])
        for cell in m['workloads']:
            assert m['moves'] in {x['name'] for x in core.end_to_end_metrics(BENCH, cell)}
    assert all(len(v) == 1 for v in layers.values())
    json.dumps(BENCH)
