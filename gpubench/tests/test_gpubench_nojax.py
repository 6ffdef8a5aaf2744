"""No module the benchmark loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``safe_control_gym_tpu`` (whole names: the port,
``safe_control_gym_tpu_torch``, is allowed)."""

import json
import subprocess
import sys

from conftest import ROOT
from gpubench.harness import core


def test_whole_name_compare():
    mods = ['safe_control_gym_tpu_torch', 'safe_control_gym_tpu_torch.ops', 'jaxtyping',
            'flax_like', 'numpy']
    assert core.forbidden_modules(mods) == []
    bad = ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen', 'safe_control_gym_tpu',
           'safe_control_gym_tpu.envs']
    assert core.forbidden_modules(mods + bad) == sorted(bad)


SCRIPT = r'''
import json, sys
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(2)
sys.path.insert(0, ROOT + '/gpubench/tests')
from conftest import SMALL, small_config
from gpubench.run import run_cell
from gpubench.harness import core
import gpubench.controls
bench = core.benchmark()
for m in bench['per_layer']:
    core.load_module('metrics', m['name'])
for cell in sorted(SMALL):
    run_cell(cell, 5, 0.1, cell.endswith('sim_open'), device='cpu', params=SMALL[cell],
             config=small_config(cell))
print(json.dumps(core.forbidden_modules()))
'''


def test_a_run_of_every_cell_loads_no_jax():
    proc = subprocess.run([sys.executable, '-c', f'ROOT = {ROOT!r}\n' + SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
