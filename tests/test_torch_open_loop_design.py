"""The open loop's design constants and launch geometry (``ops/_launch.py``,
``ops/rollout_kernels.py``, ``csrc/*.cu``): the threads a block as a
function of the batch and the SM count, the launch shape the wrappers pass,
the constants the CUDA sources state by hand against the Python ones, what
``experiments/chain.py`` reads from kernel names and latency probes,
and the hover replay it times (its angles must stay exactly where they
start, so that 3D's quotients see zero numerators throughout)."""

import os
import re

import pytest
import torch

from safe_control_gym_tpu_torch.experiments import benchmark_suite as bs
from safe_control_gym_tpu_torch.experiments import chain
from safe_control_gym_tpu_torch.experiments import sass
from safe_control_gym_tpu_torch.experiments.benchmark_suite import hover_actions, hover_case
from safe_control_gym_tpu_torch.ops import _launch
from safe_control_gym_tpu_torch.ops import rollout_kernels as trk


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs several workers on
    few cores), the prior count restored after."""
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


CSRC = os.path.join(os.path.dirname(trk.__file__), '..', 'csrc')


def _sms(monkeypatch, n_sm):
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda dev: type('P', (), {'multi_processor_count': n_sm})())


@pytest.mark.parametrize('B,n_sm,threads', [
    (1, 132, 32), (32, 132, 32), (4096, 132, 32), (4109, 132, 32),
    # The largest block that still gives each of the 132 SMs one.
    (16768, 132, 64), (16896, 132, 128), (33791, 132, 256), (65536, 132, 256),
    # H100 PCIe, 114 SMs.
    (14465, 114, 128), (14464, 114, 64),
    (97, 1, 256),
])
def test_block_size_from_batch_and_sm_count(monkeypatch, B, n_sm, threads):
    _sms(monkeypatch, n_sm)
    assert _launch.block_size(B, torch.device('cuda')) == threads


@pytest.mark.parametrize('B,threads', [
    (4096, 32), (4109, 32), (16896, 128), (65536, 256), (32, 32), (33536, 128),
])
def test_open_loop_launch_shape(monkeypatch, B, threads):
    """The open loop runs one thread an env in block_size's blocks (132
    SMs), for every system."""
    _sms(monkeypatch, 132)
    for nx, nu in ((4, 1), (6, 2), (12, 4)):
        pl = trk._policy_launch(None, nx, nu, B, torch.device('cuda'), 'k')
        assert pl.threads == threads and pl.ptr is None and pl.envs == 0


def _constants(name):
    return {k: int(v) for k, v in re.findall(r'constexpr int (k\w+) = (\d+);',
                                             open(os.path.join(CSRC, name)).read())}


def test_open_loop_constants_match_the_kernel_sources():
    """csrc/quad_kernels.cu and csrc/cartpole_kernels.cu state the substep
    count compiled in, and csrc/rollout_modes.cuh the chunk it runs in, by
    hand; the wrappers must launch what they compile."""
    quad, cart = _constants('quad_kernels.cu'), _constants('cartpole_kernels.cu')
    assert quad['kSpecialisedSubsteps'] == cart['kSpecialisedSubsteps'] \
        == trk.SPECIALISED_SUBSTEPS == 20
    assert _constants('rollout_modes.cuh')['kSubstepChunk'] == trk.SUBSTEP_CHUNK == 5
    assert trk.SPECIALISED_SUBSTEPS % trk.SUBSTEP_CHUNK == 0


def test_latency_probe_list_matches_the_kernel_source():
    """chain.latency_probe reads csrc/latency_probe.cu's results in the order
    of its enum Probe."""
    text = open(os.path.join(CSRC, 'latency_probe.cu')).read()
    enum = re.search(r'enum Probe \{([^}]*)\}', text).group(1)
    names = [n.strip()[2:] for n in enum.split(',')][:-1]
    assert names == ['FADD', 'FMUL', 'FFMA', 'RCP', 'F2I', 'I2F']
    assert [p.split('.')[-1] for p in chain.LATENCY_PROBES] == names


@pytest.mark.parametrize('name,per_iteration', [
    ('_ZN12_GLOBAL__N_119quad_rollout_kernelILi2ELi20EEEvPKfS2_', 5),
    ('_ZN12_GLOBAL__N_119quad_rollout_kernelILi3ELi20EEEvPKfS2_', 5),
    ('_ZN12_GLOBAL__N_119quad_rollout_kernelILi3ELi0EEEvPKfS2_', 1),
    ('_ZN12_GLOBAL__N_119quad_rollout_kernelILi2ELi0EEEvPKfS2_', 1),
    ('_ZN12_GLOBAL__N_123cartpole_rollout_kernelILi20EEEvPKfS2_', 5),
    ('_ZN12_GLOBAL__N_123cartpole_rollout_kernelILi0EEEvPKfS2_', 1),
    ('_ZN12_GLOBAL__N_121quad3d_advance_kernelILi20EEEvPKfS2_S2_S2_S2_Pfiif', 5),
    ('_ZN12_GLOBAL__N_121quad3d_advance_kernelILi0EEEvPKfS2_S2_S2_S2_Pfiif', 1),
    ('_ZN12_GLOBAL__N_121quad2d_advance_kernelILi20EEEvPKfS2_S2_S2_S2_Pfiif', 5),
    ('_ZN12_GLOBAL__N_121quad2d_advance_kernelILi0EEEvPKfS2_S2_S2_S2_Pfiif', 1),
])
def test_substeps_an_iteration_of_each_open_loop_kernel(name, per_iteration):
    """A loop iteration of the compiled-in count runs a chunk; with a runtime
    count, one substep. The per-step kernels K1-K3 are templated alike."""
    assert chain.substeps_per_iteration(name) == per_iteration


def test_calibrated_latency_replaces_the_measured_classes():
    """Each class takes the largest reading of its probes; the reciprocal's
    link (FMUL, then MUFU.RCP) less the FMUL reading."""
    cycles = {'FADD': 3.5, 'FMUL': 4.0, 'FFMA': 4.5, 'MUFU.RCP': 27.0, 'F2I': 17.0,
              'I2F': 4.0}
    opcodes = {'FADD': 'FADD', 'FMUL': 'FMUL', 'FFMA': 'FFMA', 'MUFU.RCP': 'MUFU.RCP',
               'F2I': 'F2I.NTZ', 'I2F': 'I2FP.F32.S32'}
    table = chain.calibrated_latency(cycles, opcodes)
    assert table['alu'] == 4.5 and table['mufu'] == 23.0 and table['convert'] == 17.0
    # Classes no probe measured keep the estimates.
    assert table['global'] == sass.LATENCY['global'] and table['fp64'] == sass.LATENCY['fp64']


@pytest.mark.parametrize('system,tilt', [('cartpole', 0.0), ('quadrotor', 0.0),
                                         ('quadrotor', 0.01), ('quadrotor_3D', 0.0),
                                         ('quadrotor_3D', 0.01)])
def test_hover_replay_holds_the_angles(system, tilt):
    """Equal motors (no torque) from the nominal state: the angles stay
    exactly at their start (0, or the tilt), and no goal ends an episode."""
    hover, raw, cfg, kw = hover_case(system, 'cpu', tilt)
    B, T = 3, 12
    out = bs._kernel(system)[1](hover.expand(B, -1).contiguous(), cfg, 0, T,
                                actions=hover_actions(system, raw, T, B), **kw)
    angles = {'cartpole': [2, 3], 'quadrotor': [4, 5],
              'quadrotor_3D': [6, 7, 8, 9, 10, 11]}[system]
    assert torch.equal(out['state'][:, angles], hover[angles].expand(B, -1))
    assert out['done_count'].eq(0).all()
