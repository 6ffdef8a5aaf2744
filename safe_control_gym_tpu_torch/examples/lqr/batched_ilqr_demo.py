"""Batched iLQR: B whole trajectory optimizations in one fused solve.

Port of ``examples/lqr/batched_ilqr_demo.py``: ``iLQR.solve_batch`` runs B
independent solves (closed-loop rollouts through K1, backward passes, the
lambda schedule, revert to best) on the card. ``main`` returns the solve's
outputs:

    python -m safe_control_gym_tpu_torch.examples.lqr.batched_ilqr_demo [B] [--device cpu]
"""

import sys
import time
from functools import partial

import numpy as np

from safe_control_gym_tpu_torch.examples import demo_argv, synchronize
from safe_control_gym_tpu_torch.utils.registration import get_config, make


def main(B=64, device='cuda'):
    env_func = partial(
        make, 'cartpole', device=device, seed=0, cost='quadratic', task='stabilization',
        task_info={'stabilization_goal': [0.5, 0.0], 'stabilization_goal_tolerance': 0.0},
        randomized_init=False, episode_len_sec=3, ctrl_freq=15, pyb_freq=750)
    ctrl = make('ilqr', env_func, **{**get_config('ilqr'), 'max_iterations': 10,
                                     'fused_solve': True})

    rng = np.random.default_rng(0)
    nominal = np.asarray(ctrl.env._nominal_init_state(), np.float32)
    x0s = nominal + rng.uniform(-0.2, 0.2, (B, nominal.shape[0])).astype(np.float32)

    t0 = time.perf_counter()
    out = ctrl.solve_batch(x0s)          # first call: build and solve
    first_call = time.perf_counter() - t0
    synchronize(device)
    t0 = time.perf_counter()
    out = ctrl.solve_batch(x0s)
    warm = time.perf_counter() - t0

    conv = int(np.sum(out['converged']))
    print(f'B={B} iLQR solves: warm {warm:.3f}s ({B / warm:,.0f} solves/s), '
          f'first-call {first_call:.1f}s')
    print(f'converged {conv}/{B}, cost mean {out["cost"].mean():.3f} '
          f'min {out["cost"].min():.3f} max {out["cost"].max():.3f}')
    ctrl.close()
    return out


if __name__ == '__main__':
    args, dev = demo_argv(sys.argv[1:])
    main(int(args[0]) if args else 64, device=dev)
