"""What the harness finds by name: the benchmark file, a cell's file, its
configuration, its driver and the readers of its per-layer metrics.

Everything that belongs to one cell, one configuration, one traffic driver or
one per-layer metric lives in a file of its own under ``gpubench/``, and this
module finds it from the name that ``BENCHMARK.json`` gives:

* ``workloads/<cell>.json``: the cell's configuration, driver, traffic
  parameters, ``why`` and ``chips``;
* ``configs/<config>.json``: the configuration as it is run;
* ``drivers/<driver>.py``: the traffic driver, with ``make(cell, config,
  seed, device)``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``, which
  returns a number or None; an end-to-end metric has one only where it is
  not the window's work over its wall time (``run.py``).

A name that has no file fails with a message that says which file is missing.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# The top-level module names that no process of the benchmark may load: JAX,
# its libraries, and the JAX package the port was made from. Compared whole,
# so the port (``safe_control_gym_tpu_torch``) is not among them.
FORBIDDEN_TOP_LEVEL = ('jax', 'jaxlib', 'flax', 'safe_control_gym_tpu')


class UnknownName(LookupError):
    """A cell, configuration, driver or metric that has no file."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, 'BENCHMARK.json')
    if not os.path.exists(path):
        raise UnknownName(f'no BENCHMARK.json at {root}')
    return load_json(path)


def _file(kind: str, name: str, ext: str) -> str:
    path = os.path.join(BENCH_DIR, kind, name + ext)
    if not os.path.exists(path):
        raise UnknownName(f'unknown {kind[:-1]} {name!r}: no file gpubench/{kind}/{name}{ext}')
    return path


def cell_entry(bench: dict, name: str) -> dict:
    for entry in bench['workloads']:
        if entry['name'] == name:
            return entry
    known = ', '.join(e['name'] for e in bench['workloads'])
    raise UnknownName(f'unknown workload {name!r}; BENCHMARK.json has: {known}')


def workload(name: str) -> dict:
    return load_json(_file('workloads', name, '.json'))


def config(name: str) -> dict:
    return load_json(_file('configs', name, '.json'))


def has_module(kind: str, name: str) -> bool:
    return os.path.exists(os.path.join(BENCH_DIR, kind, name + '.py'))


def load_module(kind: str, name: str):
    """``gpubench/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = _file(kind, name, '.py')
    mod_name = f'gpubench.{kind}.{name.replace(".", "_")}'
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def end_to_end_metrics(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports: those without ``workloads``
    and those that list it."""
    return [m for m in bench['end_to_end'] if cell in m.get('workloads', [cell])]


def per_layer_metrics(bench: dict, cell: str) -> list:
    """The per-layer metrics of the cell: those that list it, and those
    without ``workloads`` whose end-to-end metric the cell reports."""
    reported = {m['name'] for m in end_to_end_metrics(bench, cell)}
    out = []
    for m in bench['per_layer']:
        if 'workloads' in m:
            if cell in m['workloads']:
                out.append(m)
        elif m['moves'] in reported:
            out.append(m)
    return out


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN_TOP_LEVEL``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split('.', 1)[0] in FORBIDDEN_TOP_LEVEL)


def result_line(result: dict, checks: list) -> str:
    """The result's one JSON line: ``result``'s keys, then ``checks`` last,
    each compared number with its limit."""
    out = dict(result)
    out['checks'] = {c.name: {'value': c.value, 'limit': c.limit} for c in checks}
    return json.dumps(out)
