"""The short first call for new kernels on the card, before ``chip_smoke.py``.

    python -m safe_control_gym_tpu_torch.experiments.kernel_first_check

Builds ``csrc/cartpole_kernels.cu`` and ``csrc/quad_kernels.cu`` once with
``-Xptxas -v`` and prints each kernel's registers, stack and spills; builds
every library as the port does; runs K2 and K3 once at B=4096 against their
plain versions; runs K5 (2D and 3D, plain and constrained benchmark configs)
for 60 steps against its plain version and times it at T=4096 with CUDA
events; checks that K4 still agrees with its plain version; and runs the
policy-mode phases of ``chip_smoke.py`` (``check_policy``: K4 and K5 with the
committed actors against their plain versions) at T=40. Run it from the
root of a checkout. It prints what it finds of the open-loop kernels and
raises where the card or the build fails; the policy mode is held to
``chip_smoke.py``'s tolerances, and raises there.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch

from safe_control_gym_tpu_torch.experiments.benchmark_suite import _kernel_cfg, _make
from safe_control_gym_tpu_torch.ops import _build
from safe_control_gym_tpu_torch.ops import physics_kernels as pk
from safe_control_gym_tpu_torch.ops import rollout_kernels as rk
from safe_control_gym_tpu_torch.utils.device import require_cuda

B = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ptxas_report(name: str = 'quad_kernels') -> str:
    """``nvcc -Xptxas -v`` of ``csrc/<name>.cu``: registers, stack, spills."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v',
                               '-o', os.path.join(tmp, 'lib.so'),
                               _build.sources(name)[0]],
                              capture_output=True, text=True, check=True)
    return proc.stdout + proc.stderr


def policy_checks(dev, T=40):
    """``chip_smoke.py``'s k4_policy and k5_policy phases at a short ``T``."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    for system in chip_smoke.SYSTEMS:
        chip_smoke.check_policy(system, dev, length=T)


def main():
    dev = require_cuda('cuda')
    print(ptxas_report('cartpole_kernels'))
    print(ptxas_report())
    t0 = time.perf_counter()
    _build.build_all()
    print('build', time.perf_counter() - t0, 's')
    g = torch.Generator(device=dev).manual_seed(0)
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)
    states = torch.stack([u((B,), -1, 1), u((B,), -0.5, 0.5), u((B,), 0.5, 1.5),
                          u((B,), -0.5, 0.5), u((B,), -1, 1), u((B,), -3, 3)], 1)
    a2 = (states.contiguous(), u((B,), 0.05, 0.2), u((B,), 0.05, 0.2),
          u((B, 2), -0.01, 0.01), torch.tensor([0.027, 1.4e-5, 0.0397, 9.8], device=dev))
    print('k2 err', float((pk.quad2d_advance(*a2, 20, 1e-3)
                           - pk.quad2d_advance_plain(*a2, 20, 1e-3)).abs().max()))
    s3 = u((B, 12), -0.5, 0.5)
    s3[:, 4] += 1
    a3 = (s3.contiguous(), u((B, 4), 0.03, 0.1), u((B,), -1e-6, 1e-6), u((B, 3), -0.01, 0.01),
          torch.tensor([0.027, 1.4e-5, 1.4e-5, 2.17e-5, 0.0397, 9.8], device=dev))
    print('k3 err', float((pk.quad3d_advance(*a3, 20, 1e-3)
                           - pk.quad3d_advance_plain(*a3, 20, 1e-3)).abs().max()))
    for system, roll, qt in (('quadrotor', rk.quad2d_rollout, 2),
                             ('quadrotor_3D', rk.quad3d_rollout, 3)):
        for constrained in (False, True):
            env = _make(system, constrained, device=dev)
            cfg = _kernel_cfg(system, env, constrained)
            s0 = env.func.reset_batch(g, B)[0].state.contiguous()
            kw = dict(constrained=constrained, randomized_reset=True)
            k = roll(s0, cfg, 5, 60, 20, 1e-3, **kw)
            p = rk.quad_rollout_plain(qt, s0, cfg, 5, 60, 20, 1e-3, **kw)
            torch.cuda.synchronize()
            print(system, f'constrained={constrained}',
                  'state err', float((k['state'] - p['state']).abs().max()),
                  'reward err', float((k['reward_sum'] - p['reward_sum']).abs().max()),
                  'envs with other counts',
                  {key: int((k[key] != p[key]).sum())
                   for key in ('done_count', 'ctrl_step', 'violation_count')})
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            roll(s0, cfg, 6, 4096, 20, 1e-3, **kw)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
            print(f'  T=4096: {ms} ms, {B * 4096 / ms * 1e3} ctrl steps/s')
    env = _make('cartpole', True, device=dev)
    cfg = _kernel_cfg('cartpole', env, True)
    s0 = env.func.reset_batch(g, B)[0].state.contiguous()
    k = rk.cartpole_rollout(s0, cfg, 7, 100, 20, 1e-3, constrained=True)
    p = rk.cartpole_rollout_plain(s0, cfg, 7, 100, 20, 1e-3, constrained=True)
    torch.cuda.synchronize()
    print('k4 state err', float((k['state'] - p['state']).abs().max()),
          'reward err', float((k['reward_sum'] - p['reward_sum']).abs().max()))
    policy_checks(dev)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True).stdout)


if __name__ == '__main__':
    main()
